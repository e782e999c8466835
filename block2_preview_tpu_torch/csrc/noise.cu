// K6 — perturbative-noise density matrix of the two-site step.
//
// Replaces block2_preview_tpu/ops/resident.py:862 _noise_exec (and the W
// tile gather :1119, tilev2.py:168 _tile_gather, that fed it).  For every
// noise item (MPO symbol m, psi sector k) of the NoisePlan:
//
//   x = W_m[qb, qk] @ psi[k]          (LW side; RW side: RW_m @ psi^T)
//   rho[qb] += x x^T
//
// on T x T tiles.  Item fields `it` [n, 10]: wbase, wstride, DB, pb, na,
// nk, nn, tb, rb, DK.  W tiles are read straight from the LW (or RW) slab
// pool at wbase + r*wstride + c with 64-bit offsets and edge masks; psi
// tiles through psi_idx (the RW side's psi_idx is the transposed gather
// NoisePlan builds), whose padding points at the zero slot of xp.
//
// Design.  Two launches, because the x tiles of every ai of one (item, ni)
// do not fit in shared memory at D >= 250 (na x T x T):
//  1. noise_x_kernel: one block per x tile (item, ai, ni) forms
//     x = sum_ki W[ai, ki] psi[ki, ni] and stores it, unmasked, to a device
//     scratch pool at tile tb + ai*nn + ni (rows past DB and columns past
//     the psi sector are exact zeros).  The pool holds sum(na * nn) tiles:
//     about (MPO symbols x wavefunction size) elements.
//  2. noise_rho_kernel: one block per rho tile task (item, ar, ac) forms
//     sum_ni x[ar, ni] x[ac, ni]^T and adds it into rho tile
//     rb + ar*na + ac with atomics (items of one sector, i.e. other
//     symbols m, add into the same tiles).
// The reference bounded per-group tmp pools (tb restarting per task group)
// and pre-materialised the W tiles (an in-loop gather lowered ~200x slower
// on the TPU); neither is needed here, and one launch pair covers all
// items.  Bound on the card: the FMA pipes (both stages are small GEMMs
// over T x T tiles) and the scratch round trip of x; f64 atomics make the
// sum order vary between runs at the last bits.

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
noise_x_kernel(const S* __restrict__ xp, const S* __restrict__ wpool,
               const int* __restrict__ psi_idx, const int* __restrict__ it,
               const int* __restrict__ cumx, int n_items,
               S* __restrict__ xpool) {
  constexpr int R = T / 16;
  constexpr int KP = kChunk + 1;
  extern __shared__ unsigned char smem_raw[];
  S* As = reinterpret_cast<S*>(smem_raw);   // W chunk [T][KP]
  S* Ps = As + T * KP;                      // psi chunk [kChunk][T]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long b = blockIdx.x;
  const int item = b2t::find_item(cumx, n_items, b);
  const int* f = it + (long long)item * 10;
  const int o = (int)(b - cumx[item]);
  const int ws = f[1], DB = f[2], pb = f[3], nk = f[5], nn = f[6];
  const int ai = o / nn, ni = o % nn;
  const int wrm = DB - ai * T;        // valid W rows of this strip

  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  const long long wrow = (long long)f[0] + (long long)ai * T * ws;
  for (int ki = 0; ki < nk; ++ki) {
    const int kcm = ws - ki * T;      // valid W columns of this tile
    const long long wtile = wrow + (long long)ki * T;
    const long long ptile = (long long)(pb + ki * nn + ni) * T * T;
    for (int kc = 0; kc < T && kc < kcm; kc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        S v = S(0);
        if (r < wrm && kc + kk < kcm)
          v = wpool[wtile + (long long)r * ws + kc + kk];
        As[r * KP + kk] = v;
      }
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int kk = e / T, c = e % T;
        Ps[kk * T + c] = xp[psi_idx[ptile + (long long)(kc + kk) * T + c]];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        S a[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = As[(ty + 16 * i) * KP + kk];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = Ps[kk * T + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
  }
  S* dst = xpool + b * T * T;         // tile tb + ai*nn + ni == unit b
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
      dst[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
}

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
noise_rho_kernel(const S* __restrict__ xpool, const int* __restrict__ it,
                 const int* __restrict__ cumr, int n_items,
                 S* __restrict__ rho) {
  constexpr int R = T / 16;
  constexpr int KP = kChunk + 1;
  extern __shared__ unsigned char smem_raw[];
  S* As = reinterpret_cast<S*>(smem_raw);   // x[ar] chunk [T][KP]
  S* Bs = As + T * KP;                      // x[ac] chunk [T][KP]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long b = blockIdx.x;
  const int item = b2t::find_item(cumr, n_items, b);
  const int* f = it + (long long)item * 10;
  const int o = (int)(b - cumr[item]);
  const int na = f[4], nn = f[6], tb = f[7], rb = f[8];
  const int ar = o / na, ac = o % na;

  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  for (int ni = 0; ni < nn; ++ni) {
    const S* xa = xpool + (long long)(tb + ar * nn + ni) * T * T;
    const S* xc = xpool + (long long)(tb + ac * nn + ni) * T * T;
    for (int nc = 0; nc < T; nc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        As[r * KP + kk] = xa[r * T + nc + kk];
        Bs[r * KP + kk] = xc[r * T + nc + kk];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        S a[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = As[(ty + 16 * i) * KP + kk];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = Bs[(tx + 16 * j) * KP + kk];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
  }
  S* dst = rho + (long long)(rb + ar * na + ac) * T * T;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j)
      atomicAdd(dst + (ty + 16 * i) * T + tx + 16 * j, acc[i][j]);
}

template <typename S, int T>
cudaError_t launch_x(const S* xp, const S* wpool, const int* psi_idx,
                     const int* it, const int* cumx, int n_items,
                     long long n_x, S* xpool, cudaStream_t st) {
  const size_t smem = sizeof(S) * ((size_t)T * (kChunk + 1) + kChunk * T);
  cudaError_t e = b2t::allow_smem(noise_x_kernel<S, T>, smem);
  if (e != cudaSuccess) return e;
  if (n_x > 0)
    noise_x_kernel<S, T><<<(unsigned)n_x, kThreads, smem, st>>>(
        xp, wpool, psi_idx, it, cumx, n_items, xpool);
  return cudaGetLastError();
}

template <typename S, int T>
cudaError_t launch_rho(const S* xpool, const int* it, const int* cumr,
                       int n_items, long long n_r, S* rho, cudaStream_t st) {
  const size_t smem = sizeof(S) * 2 * (size_t)T * (kChunk + 1);
  cudaError_t e = b2t::allow_smem(noise_rho_kernel<S, T>, smem);
  if (e != cudaSuccess) return e;
  if (n_r > 0)
    noise_rho_kernel<S, T><<<(unsigned)n_r, kThreads, smem, st>>>(
        xpool, it, cumr, n_items, rho);
  return cudaGetLastError();
}

template <typename S>
cudaError_t noise_x(const S* xp, const S* wpool, const int* psi_idx,
                    const int* it, const int* cumx, int n_items,
                    long long n_x, int T, S* xpool, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 16: return launch_x<S, 16>(xp, wpool, psi_idx, it, cumx, n_items,
                                    n_x, xpool, st);
    case 32: return launch_x<S, 32>(xp, wpool, psi_idx, it, cumx, n_items,
                                    n_x, xpool, st);
    case 64: return launch_x<S, 64>(xp, wpool, psi_idx, it, cumx, n_items,
                                    n_x, xpool, st);
    case 128: return launch_x<S, 128>(xp, wpool, psi_idx, it, cumx, n_items,
                                      n_x, xpool, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename S>
cudaError_t noise_rho(const S* xpool, const int* it, const int* cumr,
                      int n_items, long long n_r, int T, S* rho,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 16: return launch_rho<S, 16>(xpool, it, cumr, n_items, n_r, rho, st);
    case 32: return launch_rho<S, 32>(xpool, it, cumr, n_items, n_r, rho, st);
    case 64: return launch_rho<S, 64>(xpool, it, cumr, n_items, n_r, rho, st);
    case 128: return launch_rho<S, 128>(xpool, it, cumr, n_items, n_r, rho,
                                        st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int b2t_noise_x_f64(const double* xp, const double* wpool, const int* psi_idx,
                    const int* it, const int* cumx, int n_items,
                    long long n_x, int T, double* xpool, void* stream) {
  return (int)noise_x<double>(xp, wpool, psi_idx, it, cumx, n_items, n_x, T,
                              xpool, stream);
}

int b2t_noise_x_f32(const float* xp, const float* wpool, const int* psi_idx,
                    const int* it, const int* cumx, int n_items,
                    long long n_x, int T, float* xpool, void* stream) {
  return (int)noise_x<float>(xp, wpool, psi_idx, it, cumx, n_items, n_x, T,
                             xpool, stream);
}

int b2t_noise_rho_f64(const double* xpool, const int* it, const int* cumr,
                      int n_items, long long n_r, int T, double* rho,
                      void* stream) {
  return (int)noise_rho<double>(xpool, it, cumr, n_items, n_r, T, rho,
                                stream);
}

int b2t_noise_rho_f32(const float* xpool, const int* it, const int* cumr,
                      int n_items, long long n_r, int T, float* rho,
                      void* stream) {
  return (int)noise_rho<float>(xpool, it, cumr, n_items, n_r, T, rho, stream);
}

}  // extern "C"
