// K2 — diagonal of the two-site effective Hamiltonian.
//
// Replaces block2_preview_tpu/ops/resident.py:331 _dl_build and :316
// _slab_diag_impl.  Only center symbols with dq = 0 contribute:
//
//   diag[(qL, qR)][a, b] = sum_m LW[m][(qL, qL)][a, a] * RW[m][(qR, qR)][b, b]
//
// Phase 1 (dl_build) gathers the strided diagonal rows of the LW/RW
// slabs into contiguous DL/DR pools: out[outoff + i] = pool[base +
// i*stride] for i < imax (g4 [4, n] rows: base, stride, imax, outoff;
// rows with base < 0 are padding).  The written ranges are disjoint, so
// plain stores keep the reference's .at[].set semantics.
// Phase 2 (diag_kernel) is one block per GEMM tile task: A = DL tile
// [m, a], B = DR tile [m, b] (a4/b4 rows: base, stride, rmax, cmax),
// prod[a, b] = sum_m A[m, a] B[m, b], added with atomics into diag tile
// sD (several m-chunks target one tile).  The flat diagonal then comes
// out of the tile pool through sig_idx (gather kernel of matvec.cu).
// Bound on the card: tiny (once per site); launch latency dominates.

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

template <typename S>
__global__ void dl_build_kernel(const S* __restrict__ pool,
                                const int* __restrict__ g4, int ng, int T,
                                S* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)ng * T) return;
  const int task = (int)(e / T), i = (int)(e % T);
  const int base = g4[task];
  if (base < 0 || i >= g4[2 * ng + task]) return;
  out[(long long)g4[3 * ng + task] + i] =
      pool[(long long)base + (long long)i * g4[ng + task]];
}

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
diag_kernel(const S* __restrict__ dl, const S* __restrict__ dr,
            const int* __restrict__ a4, const int* __restrict__ b4,
            const int* __restrict__ sD, int nB, S* __restrict__ tiles) {
  constexpr int R = T / 16;
  __shared__ S As[kChunk][T];
  __shared__ S Bs[kChunk][T];
  const int task = blockIdx.x;
  const int abase = a4[task];
  if (abase < 0) return;              // padding task (uniform per block)
  const int astr = a4[nB + task], arm = a4[2 * nB + task],
            acm = a4[3 * nB + task];
  const int bbase = b4[task], bstr = b4[nB + task], brm = b4[2 * nB + task],
            bcm = b4[3 * nB + task];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int mrm = arm < brm ? arm : brm;   // rows valid in both tiles
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  for (int m0 = 0; m0 < T && m0 < mrm; m0 += kChunk) {
    for (int e = tid; e < kChunk * T; e += kThreads) {
      const int kk = e / T, c = e % T;
      const int m = m0 + kk;
      As[kk][c] = (m < arm && c < acm)
          ? dl[(long long)abase + (long long)m * astr + c] : S(0);
      Bs[kk][c] = (m < brm && c < bcm)
          ? dr[(long long)bbase + (long long)m * bstr + c] : S(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      S a[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
  S* dst = tiles + (long long)sD[task] * T * T;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int a = ty + 16 * i;
    if (a >= acm) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int bb = tx + 16 * j;
      if (bb < bcm) atomicAdd(dst + a * T + bb, acc[i][j]);
    }
  }
}

template <typename S>
cudaError_t dl_build(const S* pool, const int* g4, int ng, int T, S* out,
                     void* stream) {
  const long long n = (long long)ng * T;
  if (n > 0)
    dl_build_kernel<S><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
        pool, g4, ng, T, out);
  return cudaGetLastError();
}

template <typename S>
cudaError_t diag(const S* dl, const S* dr, const int* a4, const int* b4,
                 const int* sD, int nB, int T, S* tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nB <= 0) return cudaGetLastError();
  switch (T) {
    case 16: diag_kernel<S, 16><<<nB, kThreads, 0, st>>>(
        dl, dr, a4, b4, sD, nB, tiles); break;
    case 32: diag_kernel<S, 32><<<nB, kThreads, 0, st>>>(
        dl, dr, a4, b4, sD, nB, tiles); break;
    case 64: diag_kernel<S, 64><<<nB, kThreads, 0, st>>>(
        dl, dr, a4, b4, sD, nB, tiles); break;
    case 128: diag_kernel<S, 128><<<nB, kThreads, 0, st>>>(
        dl, dr, a4, b4, sD, nB, tiles); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_dl_build_f64(const double* pool, const int* g4, int ng, int T,
                     double* out, void* stream) {
  return (int)dl_build<double>(pool, g4, ng, T, out, stream);
}

int b2t_dl_build_f32(const float* pool, const int* g4, int ng, int T,
                     float* out, void* stream) {
  return (int)dl_build<float>(pool, g4, ng, T, out, stream);
}

int b2t_diag_f64(const double* dl, const double* dr, const int* a4,
                 const int* b4, const int* sD, int nB, int T, double* tiles,
                 void* stream) {
  return (int)diag<double>(dl, dr, a4, b4, sD, nB, T, tiles, stream);
}

int b2t_diag_f32(const float* dl, const float* dr, const int* a4,
                 const int* b4, const int* sD, int nB, int T, float* tiles,
                 void* stream) {
  return (int)diag<float>(dl, dr, a4, b4, sD, nB, T, tiles, stream);
}

}  // extern "C"
