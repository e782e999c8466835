// K12 — v1 tiled environment blocking (B2TPU_STK_ENGINE=tiled_v1 on the
// stacked backends).
//
// Replaces block2_preview_tpu/ops/tiled_blocking.py:64 _tiled_blocking_exec.
// The reference's v1 plan (T x T tiles, T in {16, 32, 64, 128}) is three
// stages of tile tasks, cut into task groups:
//
//   stage 1  tmp[id]  += E_tile . K   (K = mk tile, or the transposed
//            (y, k) tile on the right)
//   stage 2  prod[id] += A . tmp[src] (A = mb tile transposed on the left,
//            the (x, l) tile on the right)
//   stage 3  out[obase + r ostr + c] += coef prod[src][r, c]  (r < ormax,
//            c < ocmax)
//
// A tile (base, stride, rmax, cmax) holds pool[base + r stride + c] for
// r < rmax, c < cmax and zero elsewhere.  The reference runs the three
// stages for every group inside one lax.scan.
//
// Design.  One C call runs the whole plan.  ops/tiled_blocking.py
// tblk_tables keeps only the live tasks, concatenated over groups, and
// packs consecutive groups into waves whose tmp + prod scratch stays
// within a fixed budget; tile ids are global within a wave.  Per wave, in
// order on one stream: stage 1 over every tmp tile of the wave in one grid,
// stage 2 over every prod tile, then stage 3 on the gather-by-output core
// (mix_gather.cuh).  Stages 1 and 2 keep their segment sums: a task list
// sorted by tile id, one CUDA block a tile, which reads its tasks from the
// segment starts, sums their products in registers (R x R a thread, R =
// T / 16) and writes the tile once.  Stage 3's output tiles are the core's
// blocks (window min(ormax, T) x min(ocmax, T), stride ostr; source stride
// T in the prod scratch).  No atomics anywhere: an output tile that several
// waves touch is added to by one wave after another.  Operand chunks of 16
// along the contraction are staged in shared memory with edge masks, 64-bit
// offsets.  The wrapper allocates the largest wave's scratch; the kernels
// allocate nothing.
//
// Tables: s1 [8, n1] (ebase, estr, ermax, ecmax, kbase, kstr, krmax, kcmax)
// with seg1 [tmp tiles + 1]; s2 [5, n2] (bbase, bstr, brmax, bcmax, tmp
// slot) with seg2 [prod tiles + 1]; the core's tables for stage 3; and the
// host array `waves` [n_waves, 6] int64: (first tmp tile, tmp tiles, first
// prod tile, prod tiles, first unit, units).
//
// Bound on the card: the f64/f32 FMA pipes at the plan's tile counts (a
// tile task multiplies whole T x T tiles, padding included) against the
// bytes of the pools, tables and output.  K5 (blocking.cu) computes the
// same function from the v2 tables without tmp/prod scratch; this kernel
// keeps the v1 tables' three stages.  Tensor-core MMA is later work.

#include "mix_gather.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

// acc += A . B over one T x T tile product, A(i, k) = a[abase + i ars +
// k acs] for i < aim, k < akm; B(k, j) = b[bbase + k brs + j bcs] for
// k < bkm, j < bjm; zero elsewhere.  Contraction in chunks of kChunk.
template <typename S, int T>
__device__ __forceinline__ void tile_mac(
    S (&acc)[T / 16][T / 16], const S* __restrict__ a, long long abase,
    long long ars, long long acs, int aim, int akm, const S* __restrict__ b,
    long long bbase, long long brs, long long bcs, int bkm, int bjm, S* As,
    S* Bs) {
  constexpr int R = T / 16;
  constexpr int KP = kChunk + 1;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  int kmax = akm < bkm ? akm : bkm;
  if (kmax > T) kmax = T;
  for (int k0 = 0; k0 < kmax; k0 += kChunk) {
    if (acs == 1) {          // rows of A contiguous along k
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int i = e / kChunk, kk = e % kChunk;
        const int k = k0 + kk;
        As[i * KP + kk] = (i < aim && k < kmax)
            ? a[abase + (long long)i * ars + k] : S(0);
      }
    } else {                 // columns of A contiguous along i
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int kk = e / T, i = e % T;
        const int k = k0 + kk;
        As[i * KP + kk] = (i < aim && k < kmax)
            ? a[abase + (long long)i * ars + (long long)k * acs] : S(0);
      }
    }
    if (bcs == 1) {          // rows of B contiguous along j
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int kk = e / T, j = e % T;
        const int k = k0 + kk;
        Bs[kk * T + j] = (k < kmax && j < bjm)
            ? b[bbase + (long long)k * brs + j] : S(0);
      }
    } else {                 // columns of B contiguous along k
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int j = e / kChunk, kk = e % kChunk;
        const int k = k0 + kk;
        Bs[kk * T + j] = (k < kmax && j < bjm)
            ? b[bbase + (long long)k * brs + (long long)j * bcs] : S(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      S av[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = As[(ty + 16 * i) * KP + kk];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = Bs[kk * T + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
}

template <typename S, int T>
__device__ __forceinline__ void store_tile(S (&acc)[T / 16][T / 16],
                                           S* __restrict__ dst) {
  constexpr int R = T / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
      dst[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
}


template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
tblk_tmp_kernel(const S* __restrict__ ep, const S* __restrict__ kp,
                const int* __restrict__ s1, long long n1,
                const int* __restrict__ seg, int left, S* __restrict__ tmp) {
  constexpr int R = T / 16;
  __shared__ S As[T * (kChunk + 1)];
  __shared__ S Bs[kChunk * T];
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  const int lo = seg[blockIdx.x], hi = seg[blockIdx.x + 1];
  for (int t = lo; t < hi; ++t) {
    const long long ebase = s1[t], estr = s1[n1 + t];
    const long long kbase = s1[4 * n1 + t], kstr = s1[5 * n1 + t];
    const int ermax = s1[2 * n1 + t], ecmax = s1[3 * n1 + t];
    const int krmax = s1[6 * n1 + t], kcmax = s1[7 * n1 + t];
    if (left)   // K(k, y) = kp[kbase + k kstr + y]
      tile_mac<S, T>(acc, ep, ebase, estr, 1, ermax, ecmax, kp, kbase, kstr,
                     1, krmax, kcmax, As, Bs);
    else        // K(k, y) = kp[kbase + y kstr + k]: the (y, k) tile, turned
      tile_mac<S, T>(acc, ep, ebase, estr, 1, ermax, ecmax, kp, kbase, 1,
                     kstr, kcmax, krmax, As, Bs);
  }
  store_tile<S, T>(acc, tmp + (long long)blockIdx.x * T * T);
}

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
tblk_prod_kernel(const S* __restrict__ bp, const int* __restrict__ s2,
                 long long n2, const int* __restrict__ seg, int left,
                 const S* __restrict__ tmp, S* __restrict__ prod) {
  constexpr int R = T / 16;
  __shared__ S As[T * (kChunk + 1)];
  __shared__ S Bs[kChunk * T];
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  const int lo = seg[blockIdx.x], hi = seg[blockIdx.x + 1];
  for (int t = lo; t < hi; ++t) {
    const long long bbase = s2[t], bstr = s2[n2 + t];
    const int brmax = s2[2 * n2 + t], bcmax = s2[3 * n2 + t];
    const long long src = (long long)s2[4 * n2 + t] * T * T;
    if (left)   // A(x, l) = bp[bbase + l bstr + x]: the (l, x) tile, turned
      tile_mac<S, T>(acc, bp, bbase, 1, bstr, bcmax, brmax, tmp, src, T, 1,
                     T, T, As, Bs);
    else        // A(x, l) = bp[bbase + x bstr + l]
      tile_mac<S, T>(acc, bp, bbase, bstr, 1, brmax, bcmax, tmp, src, T, 1,
                     T, T, As, Bs);
  }
  store_tile<S, T>(acc, prod + (long long)blockIdx.x * T * T);
}

constexpr int kWaveCols = 6;

template <typename S, int T>
cudaError_t run_waves(const S* ep, const S* bp, const S* kp, const int* s1,
                      long long n1, const int* seg1, const int* s2,
                      long long n2, const int* seg2, const int* units,
                      const int* blk, const int* bstart, const int* ts,
                      const S* tc, const long long* waves, int n_waves,
                      int left, S* tmp, S* prod, S* out, cudaStream_t st) {
  for (int w = 0; w < n_waves; ++w) {
    const long long* wv = waves + (long long)w * kWaveCols;
    const int ntmp = (int)wv[1], nprod = (int)wv[3], nu = (int)wv[5];
    if (ntmp > 0)
      tblk_tmp_kernel<S, T><<<ntmp, kThreads, 0, st>>>(ep, kp, s1, n1,
                                                       seg1 + wv[0], left,
                                                       tmp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (nprod > 0)
      tblk_prod_kernel<S, T><<<nprod, kThreads, 0, st>>>(bp, s2, n2,
                                                         seg2 + wv[2], left,
                                                         tmp, prod);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = b2t::mix_gather<S>(prod, T, units + 2 * wv[4], nu, blk, bstart, ts,
                           tc, out, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename S>
int tblk(const void* ep, const void* bp, const void* kp, const int* s1,
         long long n1, const int* seg1, const int* s2, long long n2,
         const int* seg2, const int* units, const int* blk,
         const int* bstart, const int* ts, const void* tc,
         const long long* waves, int n_waves, int T, int left, void* tmp,
         void* prod, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const S* e = static_cast<const S*>(ep);
  const S* b = static_cast<const S*>(bp);
  const S* k = static_cast<const S*>(kp);
  const S* c = static_cast<const S*>(tc);
  S* tp = static_cast<S*>(tmp);
  S* pp = static_cast<S*>(prod);
  S* o = static_cast<S*>(out);
  switch (T) {
#define B2T_TBLK_CASE(TT)                                                    \
    case TT: return (int)run_waves<S, TT>(e, b, k, s1, n1, seg1, s2, n2,    \
                                          seg2, units, blk, bstart, ts, c,  \
                                          waves, n_waves, left, tp, pp, o,  \
                                          st);
    B2T_TBLK_CASE(16)
    B2T_TBLK_CASE(32)
    B2T_TBLK_CASE(64)
    B2T_TBLK_CASE(128)
#undef B2T_TBLK_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int b2t_tblk_f64(const void* ep, const void* bp, const void* kp,
                 const int* s1, long long n1, const int* seg1, const int* s2,
                 long long n2, const int* seg2, const int* units,
                 const int* blk, const int* bstart, const int* ts,
                 const void* tc, const long long* waves, int n_waves, int T,
                 int left, void* tmp, void* prod, void* out, void* stream) {
  return tblk<double>(ep, bp, kp, s1, n1, seg1, s2, n2, seg2, units, blk,
                      bstart, ts, tc, waves, n_waves, T, left, tmp, prod, out,
                      stream);
}

int b2t_tblk_f32(const void* ep, const void* bp, const void* kp,
                 const int* s1, long long n1, const int* seg1, const int* s2,
                 long long n2, const int* seg2, const int* units,
                 const int* blk, const int* bstart, const int* ts,
                 const void* tc, const long long* waves, int n_waves, int T,
                 int left, void* tmp, void* prod, void* out, void* stream) {
  return tblk<float>(ep, bp, kp, s1, n1, seg1, s2, n2, seg2, units, blk,
                     bstart, ts, tc, waves, n_waves, T, left, tmp, prod, out,
                     stream);
}

}  // extern "C"
