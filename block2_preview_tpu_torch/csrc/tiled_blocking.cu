// K12 — v1 tiled environment blocking (B2TPU_STK_ENGINE=tiled_v1 on the
// stacked backends).
//
// Replaces block2_preview_tpu/ops/tiled_blocking.py:64 _tiled_blocking_exec.
// It reads the reference's v1 task tables of one task group as they are
// (T x T tiles, T in {16, 32, 64, 128}; B tasks per stage):
//
//   stage 1  s1 [9, B]: ebase, estr, ermax, ecmax, kbase, kstr, krmax,
//            kcmax, tmp id:   tmp[id]  += E_tile . K   (K = mk tile, or
//            the transposed (y, k) tile on the right)
//   stage 2  s2 [6, B]: bbase, bstr, brmax, bcmax, tmp src, prod id:
//            prod[id] += A . tmp[src]  (A = mb tile transposed on the
//            left, the (x, l) tile on the right)
//   stage 3  s3 [5, B]: prod src, obase, ostr, ormax, ocmax; coef [B]:
//            out[obase + r ostr + c] += coef prod[src][r, c]  (r < ormax,
//            c < ocmax; obase -1 marks padding)
//
// A tile (base, stride, rmax, cmax) holds pool[base + r stride + c] for
// r < rmax, c < cmax and zero elsewhere.  The reference runs the three
// stages for every group inside one lax.scan, with segment_sum over sorted
// ids for stages 1 and 2.
//
// Design.  Three kernels per group, launched in order on one stream by
// one C call; a call covers one group, and tmp / prod scratch hold one
// group's tiles (ntmp and nprod of them), reused by the next group.  Stage
// 1 and 2 tasks are sorted by their tmp / prod id, so one CUDA block owns
// one id: it finds its tasks by binary search over the id row and sums
// their products in registers (R x R per thread, R = T / 16), then writes
// the tile once — no atomics and no zeroing.  Stage 3 runs one block per
// task and adds into the output with atomics: several entries and items
// share an output block.  Operand chunks of 16 along the contraction are
// staged in shared memory with edge masks, 64-bit offsets.  Only the live
// task prefixes (n1, n2, n3, counted on the host) are launched.
//
// Bound on the card: the f64/f32 FMA pipes at the plan's tile counts (a
// tile task multiplies whole T x T tiles, padding included), then the
// stage-3 atomics.  K5 (blocking.cu) computes the same function from the
// v2 tables without tmp/prod scratch; this kernel keeps the v1 tables'
// three stages.  Tensor-core MMA is later work.

#include "common.cuh"

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

// [lo, hi) of the tasks with id `id` in the sorted row ids[0..n)
__device__ __forceinline__ void segment(const int* __restrict__ ids, int n,
                                        int id, int& lo, int& hi) {
  int a = 0, b = n;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (ids[m] < id) a = m + 1; else b = m;
  }
  lo = a;
  b = n;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (ids[m] <= id) a = m + 1; else b = m;
  }
  hi = a;
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
                const int* __restrict__ s1, int B, int n1, int left,
                S* __restrict__ tmp) {
  constexpr int R = T / 16;
  __shared__ S As[T * (kChunk + 1)];
  __shared__ S Bs[kChunk * T];
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  int lo, hi;
  segment(s1 + 8 * B, n1, blockIdx.x, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const long long ebase = s1[t], estr = s1[B + t];
    const long long kbase = s1[4 * B + t], kstr = s1[5 * B + t];
    const int ermax = s1[2 * B + t], ecmax = s1[3 * B + t];
    const int krmax = s1[6 * B + t], kcmax = s1[7 * B + t];
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
                 int B, int n2, int left, const S* __restrict__ tmp,
                 S* __restrict__ prod) {
  constexpr int R = T / 16;
  __shared__ S As[T * (kChunk + 1)];
  __shared__ S Bs[kChunk * T];
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  int lo, hi;
  segment(s2 + 5 * B, n2, blockIdx.x, lo, hi);
  for (int t = lo; t < hi; ++t) {
    const long long bbase = s2[t], bstr = s2[B + t];
    const int brmax = s2[2 * B + t], bcmax = s2[3 * B + t];
    const long long src = (long long)s2[4 * B + t] * T * T;
    if (left)   // A(x, l) = bp[bbase + l bstr + x]: the (l, x) tile, turned
      tile_mac<S, T>(acc, bp, bbase, 1, bstr, bcmax, brmax, tmp, src, T, 1,
                     T, T, As, Bs);
    else        // A(x, l) = bp[bbase + x bstr + l]
      tile_mac<S, T>(acc, bp, bbase, bstr, 1, brmax, bcmax, tmp, src, T, 1,
                     T, T, As, Bs);
  }
  store_tile<S, T>(acc, prod + (long long)blockIdx.x * T * T);
}

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
tblk_out_kernel(const int* __restrict__ s3, const S* __restrict__ coef,
                int B, const S* __restrict__ prod, S* __restrict__ out) {
  const int t = blockIdx.x;
  const long long obase = s3[B + t];
  if (obase < 0) return;
  const long long ostr = s3[2 * B + t];
  const int rmax = min(s3[3 * B + t], T), cmax = min(s3[4 * B + t], T);
  const S cf = coef[t];
  const S* p = prod + (long long)s3[t] * T * T;
  for (int e = threadIdx.x; e < T * T; e += kThreads) {
    const int r = e / T, c = e % T;
    if (r < rmax && c < cmax)
      atomicAdd(out + obase + r * ostr + c, cf * p[e]);
  }
}

template <typename S, int T>
cudaError_t launch_group(const S* ep, const S* bp, const S* kp,
                         const int* s1, const int* s2, const int* s3,
                         const S* coef, int B, int n1, int ntmp, int n2,
                         int nprod, int n3, int left, S* tmp, S* prod,
                         S* out, cudaStream_t st) {
  if (ntmp > 0)
    tblk_tmp_kernel<S, T><<<ntmp, kThreads, 0, st>>>(ep, kp, s1, B, n1,
                                                     left, tmp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (nprod > 0)
    tblk_prod_kernel<S, T><<<nprod, kThreads, 0, st>>>(bp, s2, B, n2, left,
                                                       tmp, prod);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (n3 > 0)
    tblk_out_kernel<S, T><<<n3, kThreads, 0, st>>>(s3, coef, B, prod, out);
  return cudaGetLastError();
}

template <typename S>
int tblk(const void* ep, const void* bp, const void* kp, const int* s1,
         const int* s2, const int* s3, const void* coef, int B, int n1,
         int ntmp, int n2, int nprod, int n3, int T, int left, void* tmp,
         void* prod, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const S* e = static_cast<const S*>(ep);
  const S* b = static_cast<const S*>(bp);
  const S* k = static_cast<const S*>(kp);
  const S* c = static_cast<const S*>(coef);
  S* tp = static_cast<S*>(tmp);
  S* pp = static_cast<S*>(prod);
  S* o = static_cast<S*>(out);
  switch (T) {
    case 16: return (int)launch_group<S, 16>(e, b, k, s1, s2, s3, c, B, n1,
                                             ntmp, n2, nprod, n3, left, tp,
                                             pp, o, st);
    case 32: return (int)launch_group<S, 32>(e, b, k, s1, s2, s3, c, B, n1,
                                             ntmp, n2, nprod, n3, left, tp,
                                             pp, o, st);
    case 64: return (int)launch_group<S, 64>(e, b, k, s1, s2, s3, c, B, n1,
                                             ntmp, n2, nprod, n3, left, tp,
                                             pp, o, st);
    case 128: return (int)launch_group<S, 128>(e, b, k, s1, s2, s3, c, B, n1,
                                               ntmp, n2, nprod, n3, left, tp,
                                               pp, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int b2t_tblk_f64(const void* ep, const void* bp, const void* kp,
                 const int* s1, const int* s2, const int* s3,
                 const void* coef, int B, int n1, int ntmp, int n2, int nprod,
                 int n3, int T, int left, void* tmp, void* prod, void* out,
                 void* stream) {
  return tblk<double>(ep, bp, kp, s1, s2, s3, coef, B, n1, ntmp, n2, nprod,
                      n3, T, left, tmp, prod, out, stream);
}

int b2t_tblk_f32(const void* ep, const void* bp, const void* kp,
                 const int* s1, const int* s2, const int* s3,
                 const void* coef, int B, int n1, int ntmp, int n2, int nprod,
                 int n3, int T, int left, void* tmp, void* prod, void* out,
                 void* stream) {
  return tblk<float>(ep, bp, kp, s1, s2, s3, coef, B, n1, ntmp, n2, nprod,
                     n3, T, left, tmp, prod, out, stream);
}

}  // extern "C"
