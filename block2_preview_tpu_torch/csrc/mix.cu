// K3 — symbol-mixing GEMM of the LW/RW assembly (mix v4).
//
// Replaces block2_preview_tpu/ops/mixv4.py:136 _mix4_scan (jit
// _mix4_exec_packed :283).  One plan item is a bounded GEMM sub-block
//
//   OUT[w, d] += sum_j W[w, j] * E[j, d],   w < nw, j < nsloc, d < width
//
// with W dense at wpool[wbase + w*wstride + j], the env slab rows at
// epool[ebase + j*estride + d] and OUT at out[obase + w*ostride + d].
// Item fields `it` [n, 12]: wbase, wstride, nw, ebase, estride, obase,
// ostride, njT, ndT, tb, width, nsloc.  The reference cuts each item into
// T=128 layout tiles (wi, di) — the stage-2 tasks counted by cum2 — and
// segment-sums the j tiles per task inside bounded task groups.
//
// Design.  A 128 x 128 f64 tile is 128 KB, so a CUDA block takes one
// 64 x 64 quarter of a layout tile (four blocks per stage-2 task) and
// loops over the whole j range of the item itself (nsloc <= 8 tiles), so
// the j-reduction of one item needs no scratch and no group tables
// (tb/g1/g2/e1/e2 are not read).  Items that are j-chunks of the same
// GEMM block add into the same OUT positions, so the result goes to OUT
// with atomics.  Bound on the card: W is ~1% dense but densified, so the
// FMA work is ~100x the useful work; the reads of E dominate memory
// traffic.

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

constexpr int kLayout = 128;   // the plan's tile (_T4), a layout constant
constexpr int kSub = 64;       // rows/cols of OUT one block computes
constexpr int kR = kSub / 16;  // micro tile per thread

template <typename S>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const S* __restrict__ epool, const S* __restrict__ wpool,
           const int* __restrict__ it, const int* __restrict__ cum2,
           int n_items, S* __restrict__ out) {
  __shared__ S Ws[kSub][kChunk + 1];
  __shared__ S Es[kChunk][kSub];
  const long long b = blockIdx.x;
  const long long task = b >> 2;
  const int q = (int)(b & 3);
  const int item = b2t::find_item(cum2, n_items, task);
  const int* f = it + (long long)item * 12;
  const int o2 = (int)(task - cum2[item]);
  const int nw = f[2], ndT = f[8], width = f[10], nsloc = f[11];
  const int wi = o2 / ndT, di = o2 % ndT;
  const int w0 = wi * kLayout + (q >> 1) * kSub;
  const int d0 = di * kLayout + (q & 1) * kSub;
  if (w0 >= nw || d0 >= width) return;   // empty quarter (whole block)
  const long long wbase = f[0], ebase = f[3], obase = f[5];
  const int wstride = f[1], estride = f[4], ostride = f[6];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  S acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = S(0);
  for (int j0 = 0; j0 < nsloc; j0 += kChunk) {
    for (int e = tid; e < kSub * kChunk; e += kThreads) {
      const int w = e / kChunk, kk = e % kChunk;
      Ws[w][kk] = (w0 + w < nw && j0 + kk < nsloc)
          ? wpool[wbase + (long long)(w0 + w) * wstride + j0 + kk] : S(0);
    }
    for (int e = tid; e < kSub * kChunk; e += kThreads) {
      const int kk = e / kSub, d = e % kSub;
      Es[kk][d] = (j0 + kk < nsloc && d0 + d < width)
          ? epool[ebase + (long long)(j0 + kk) * estride + d0 + d] : S(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      S a[kR], bv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) a[i] = Ws[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < kR; ++j) bv[j] = Es[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int w = w0 + ty + 16 * i;
    if (w >= nw) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int d = d0 + tx + 16 * j;
      if (d < width)
        atomicAdd(out + obase + (long long)w * ostride + d, acc[i][j]);
    }
  }
}

template <typename S>
cudaError_t mix(const S* epool, const S* wpool, const int* it,
                const int* cum2, int n_items, long long n_tasks, S* out,
                void* stream) {
  if (n_tasks > 0)
    mix_kernel<S><<<(unsigned)(n_tasks * 4), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        epool, wpool, it, cum2, n_items, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_mix_f64(const double* epool, const double* wpool, const int* it,
                const int* cum2, int n_items, long long n_tasks, double* out,
                void* stream) {
  return (int)mix<double>(epool, wpool, it, cum2, n_items, n_tasks, out,
                          stream);
}

int b2t_mix_f32(const float* epool, const float* wpool, const int* it,
                const int* cum2, int n_items, long long n_tasks, float* out,
                void* stream) {
  return (int)mix<float>(epool, wpool, it, cum2, n_items, n_tasks, out,
                         stream);
}

}  // extern "C"
