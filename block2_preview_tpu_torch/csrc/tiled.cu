// K7 — v1 tiled sigma matvec of the compile-once tiled engine.
//
// Replaces block2_preview_tpu/ops/tiled.py:86 _tiled_matvec_impl (and the
// matvec inside :391 _tiled_dav).  Over T x T tiles of tile-major LW/RW
// pools lp/rp [cap, T, T] and the flat psi xp [size_p + 1] (zero last):
//
//   stage 1:  tmp[s1] += lp[la] @ pp[pa],      pp = xp[psi_idx]
//   stage 2:  sig[s2] += tmp[ta] @ rp[ra]^T
//
// T in {16, 32, 64, 128}; float, double, complex64 and complex128 (the
// plain complex product, no conjugation, as the reference's einsums).
//
// Design.  The reference runs a lax.scan over [G, B] task groups with a
// bounded tmp pool per group — a TPU memory budget, not a dependency.
// Here one CUDA block owns one unit (group g, tmp tile s1) and a strip of
// H = min(T, 64) of its rows (so a complex128 T=128 strip fits in shared
// memory).  The wrapper derives the units from the struct
// (ops/tiled.py unit_tables): c1 gives each unit's run of stage-1 tasks
// (la1, pa1), c2 its stage-2 tasks (ra2, s2v).  The block forms its tmp
// strip in registers, stages it in shared memory, and for every stage-2
// task adds tmp @ R^T into sigma with atomics (real and imaginary parts
// separately for complex types).  Sigma goes straight to the flat output
// through psi_idx, which is sig_idx's inverse on live elements; padding
// lanes point at slot size_p and are skipped.  So there is no tmp or sig
// pool in device memory, no group loop and one launch per matvec.
// Pools are zero-padded tiles, so L/R/psi tiles are read whole without
// masks.  Atomic order varies between runs: results agree with the
// plain version to rounding, not bitwise.
// Bound on the card: the FMA pipes (T^3 work per tile product against
// T^2 loads) at T >= 32, and the sigma atomics where many units hit one
// output tile.  Tensor-core MMA (DMMA for f64) and TMA staging are left
// for a later PR.

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

template <typename R>
struct __align__(2 * sizeof(R)) cplx {
  R x, y;
  cplx() = default;
  __device__ constexpr cplx(R a, R b = R(0)) : x(a), y(b) {}
};

// acc += a * b
template <typename S>
__device__ __forceinline__ void mac(S& acc, S a, S b) { acc += a * b; }

template <typename R>
__device__ __forceinline__ void mac(cplx<R>& acc, cplx<R> a, cplx<R> b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

template <typename S>
__device__ __forceinline__ void atomic_add(S* p, S v) { atomicAdd(p, v); }

template <typename R>
__device__ __forceinline__ void atomic_add(cplx<R>* p, cplx<R> v) {
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
}

__host__ __device__ constexpr int strip_rows(int T) { return T < 64 ? T : 64; }

template <typename S, int T>
constexpr size_t smem_bytes() {
  return sizeof(S) * ((size_t)strip_rows(T) * T + (size_t)T * (kChunk + 1) +
                      (size_t)kChunk * T);
}

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const S* __restrict__ xp, const S* __restrict__ lp,
             const S* __restrict__ rp, const int* __restrict__ psi_idx,
             const int* __restrict__ c1, const int* __restrict__ la1,
             const int* __restrict__ pa1, const int* __restrict__ c2,
             const int* __restrict__ ra2, const int* __restrict__ s2v,
             int size_p, S* __restrict__ out) {
  constexpr int H = strip_rows(T);    // tmp rows of this block's strip
  constexpr int NS = T / H;           // strips per unit
  constexpr int RI = H / 16;          // micro tile per thread: RI x RJ
  constexpr int RJ = T / 16;
  constexpr int KP = kChunk + 1;      // padded row of the staged chunks
  constexpr long long TT = (long long)T * T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* Ts = reinterpret_cast<S*>(smem_raw);   // tmp strip [H][T]
  S* As = Ts + H * T;                       // L rows / R chunk [T][KP]
  S* Ps = As + T * KP;                      // psi chunk [kChunk][T]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int unit = blockIdx.x / NS;
  const int r0 = (blockIdx.x % NS) * H;     // first tmp row of the strip

  // ---- stage 1: tmp strip = sum over the unit's tasks of L @ psi -------
  S acc[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = S(0);

  for (int k = c1[unit]; k < c1[unit + 1]; ++k) {
    const S* L = lp + (long long)la1[k] * TT + (long long)r0 * T;
    const int* pidx = psi_idx + (long long)pa1[k] * TT;
    for (int kc = 0; kc < T; kc += kChunk) {
      for (int e = tid; e < H * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        As[r * KP + kk] = L[r * T + kc + kk];
      }
      for (int e = tid; e < kChunk * T; e += kThreads) {
        const int kk = e / T, c = e % T;
        Ps[kk * T + c] = xp[pidx[(kc + kk) * T + c]];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        S a[RI], bv[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = As[(ty + 16 * i) * KP + kk];
#pragma unroll
        for (int j = 0; j < RJ; ++j) bv[j] = Ps[kk * T + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) mac(acc[i][j], a[i], bv[j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) Ts[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // ---- stage 2: sigma[s2] += tmp strip @ R^T for each stage-2 task ------
  for (int k = c2[unit]; k < c2[unit + 1]; ++k) {
    const S* Rt = rp + (long long)ra2[k] * TT;   // R tile [p][n]
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) acc[i][j] = S(0);
    for (int nc = 0; nc < T; nc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int p = e / kChunk, kk = e % kChunk;
        As[p * KP + kk] = Rt[p * T + nc + kk];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        S a[RI], bv[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = Ts[(ty + 16 * i) * T + nc + kk];
#pragma unroll
        for (int j = 0; j < RJ; ++j) bv[j] = As[(tx + 16 * j) * KP + kk];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) mac(acc[i][j], a[i], bv[j]);
      }
      __syncthreads();
    }
    const int* oidx = psi_idx + (long long)s2v[k] * TT + (long long)r0 * T;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int o = oidx[(ty + 16 * i) * T + tx + 16 * j];
        if (o < size_p) atomic_add(out + o, acc[i][j]);
      }
  }
}

template <typename S, int T>
cudaError_t launch_tiled(const S* xp, const S* lp, const S* rp,
                         const int* psi_idx, const int* c1, const int* la1,
                         const int* pa1, const int* c2, const int* ra2,
                         const int* s2v, int n_units, int size_p, S* out,
                         cudaStream_t st) {
  constexpr size_t smem = smem_bytes<S, T>();
  cudaError_t e = b2t::allow_smem(tiled_kernel<S, T>, smem);
  if (e != cudaSuccess) return e;
  const long long nb = (long long)n_units * (T / strip_rows(T));
  if (nb > 0)
    tiled_kernel<S, T><<<(unsigned)nb, kThreads, smem, st>>>(
        xp, lp, rp, psi_idx, c1, la1, pa1, c2, ra2, s2v, size_p, out);
  return cudaGetLastError();
}

template <typename S>
int tiled(const void* xp, const void* lp, const void* rp, const int* psi_idx,
          const int* c1, const int* la1, const int* pa1, const int* c2,
          const int* ra2, const int* s2v, int n_units, int T, int size_p,
          void* out, void* stream) {
  const S* x = static_cast<const S*>(xp);
  const S* l = static_cast<const S*>(lp);
  const S* r = static_cast<const S*>(rp);
  S* o = static_cast<S*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 16: return (int)launch_tiled<S, 16>(x, l, r, psi_idx, c1, la1, pa1,
                                             c2, ra2, s2v, n_units, size_p,
                                             o, st);
    case 32: return (int)launch_tiled<S, 32>(x, l, r, psi_idx, c1, la1, pa1,
                                             c2, ra2, s2v, n_units, size_p,
                                             o, st);
    case 64: return (int)launch_tiled<S, 64>(x, l, r, psi_idx, c1, la1, pa1,
                                             c2, ra2, s2v, n_units, size_p,
                                             o, st);
    case 128: return (int)launch_tiled<S, 128>(x, l, r, psi_idx, c1, la1,
                                               pa1, c2, ra2, s2v, n_units,
                                               size_p, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define B2T_TILED_ENTRY(SFX, S)                                              \
  extern "C" int b2t_tiled_##SFX(                                            \
      const void* xp, const void* lp, const void* rp, const int* psi_idx,    \
      const int* c1, const int* la1, const int* pa1, const int* c2,          \
      const int* ra2, const int* s2v, int n_units, int T, int size_p,        \
      void* out, void* stream) {                                             \
    return tiled<S>(xp, lp, rp, psi_idx, c1, la1, pa1, c2, ra2, s2v,         \
                    n_units, T, size_p, out, stream);                        \
  }

B2T_TILED_ENTRY(f32, float)
B2T_TILED_ENTRY(f64, double)
B2T_TILED_ENTRY(c64, cplx<float>)
B2T_TILED_ENTRY(c128, cplx<double>)
