// K1 — tiled sigma matvec of the two-site effective Hamiltonian.
//
// Replaces block2_preview_tpu/ops/tilev2.py:101 _mv_scan (jit _mv_exec
// :187) and folds in :168 _tile_gather.  For every matvec item
// (symbol m, ket sector pk, bra sector ok) of the MatvecV2 plan:
//
//   sigma[ok] += LW[m][lk] @ psi[pk] @ RW[m][rk]^T
//
// on T x T tiles, T in {16, 32, 64, 128}.  Item fields `it` [n, 13]:
// lbase, DLk, DLb, rbase, DRk, DRb, pb, ob, na, nk, np, nn, tb.
//
// Design.  One CUDA block owns one stage-1 unit (item, ai, ni): it forms
// tmp = sum_ki L[ai, ki] @ psi[ki, ni] in shared memory, then for every pi
// adds tmp @ R[pi, ni]^T into sigma tile (ob + ai*np + pi) with float
// atomics.  So:
//  * tmp never touches device memory.  The reference kept bounded tmp
//    pools per task group, with tile bases `tb` restarting at 0 in every
//    group; this kernel has no tmp pool, so `tb` and the group tables
//    (g1/g2/e1/e2) are not read and one launch covers all groups.
//  * L/R tiles are read straight from the LW/RW slab pools at
//    base + r*stride + c (64-bit), masked to the tile's valid rows and
//    columns; no per-site tile pool is materialised (the reference's
//    _tile_gather pools were what exhausted device memory at D=500).
//  * psi tiles are read through psi_idx, whose padding points at the zero
//    slot xp[size_p]; masked lanes therefore add exactly zero.
//  * stage-2 targets are unsorted across blocks; atomicAdd (native f64 on
//    sm_90) makes the summation order vary from run to run at the last
//    bits, so results match the reference to rounding, not bitwise.
// Bound on the card: the f64/f32 FMA pipes at small T, and the sigma
// atomics where many symbols hit the same output tile.  A later PR can
// move the tile products to tensor-core MMA (f64 DMMA) and stage the
// stage-2 sums in shared memory.

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
mv_kernel(const S* __restrict__ xp, const S* __restrict__ lpool,
          const S* __restrict__ rpool, const int* __restrict__ psi_idx,
          const int* __restrict__ it, const int* __restrict__ cumt,
          int n_items, S* __restrict__ sig) {
  constexpr int R = T / 16;           // micro tile per thread: R x R
  constexpr int KP = kChunk + 1;      // padded row of the staged chunks
  extern __shared__ unsigned char smem_raw[];
  S* Ts = reinterpret_cast<S*>(smem_raw);   // tmp tile [T][T]
  S* As = Ts + T * T;                       // L / R chunk [T][KP]
  S* Ps = As + T * KP;                      // psi chunk [kChunk][T]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long b = blockIdx.x;
  const int item = b2t::find_item(cumt, n_items, b);
  const int* f = it + (long long)item * 13;
  const int o = (int)(b - cumt[item]);
  const int DLk = f[1], DLb = f[2], DRk = f[4], DRb = f[5];
  const int pb = f[6], ob = f[7], nk = f[9], np_ = f[10], nn = f[11];
  const int ai = o / nn, ni = o % nn;
  const int lrm = DLb - ai * T;       // valid rows of this L row strip

  // ---- stage 1: tmp = sum_ki L[ai, ki] @ psi[ki, ni] ------------------
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);

  const long long lrow = (long long)f[0] + (long long)ai * T * DLk;
  for (int ki = 0; ki < nk; ++ki) {
    const int lcm = DLk - ki * T;     // valid columns of this L tile
    const long long ltile = lrow + (long long)ki * T;
    const long long ptile = (long long)(pb + ki * nn + ni) * T * T;
    for (int kc = 0; kc < T && kc < lcm; kc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        S v = S(0);
        if (r < lrm && kc + kk < lcm)
          v = lpool[ltile + (long long)r * DLk + kc + kk];
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
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) Ts[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // ---- stage 2: sigma[ob + ai*np + pi] += tmp @ R[pi, ni]^T ------------
  const int pcm = DRk - ni * T;       // valid n columns of the R tiles
  for (int pi = 0; pi < np_; ++pi) {
    const int prm = DRb - pi * T;     // valid p rows of this R tile
    const long long rtile =
        (long long)f[3] + (long long)pi * T * DRk + (long long)ni * T;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = S(0);
    for (int nc = 0; nc < T && nc < pcm; nc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int p = e / kChunk, kk = e % kChunk;
        S v = S(0);
        if (p < prm && nc + kk < pcm)
          v = rpool[rtile + (long long)p * DRk + nc + kk];
        As[p * KP + kk] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        S a[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = Ts[(ty + 16 * i) * T + nc + kk];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = As[(tx + 16 * j) * KP + kk];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
    S* dst = sig + (long long)(ob + ai * np_ + pi) * T * T;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      if (r >= lrm) continue;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int p = tx + 16 * j;
        if (p < prm) atomicAdd(dst + r * T + p, acc[i][j]);
      }
    }
  }
}

// out[i] = src[idx[i]]: flattens a tile pool through sig_idx.
template <typename S>
__global__ void gather_kernel(const S* __restrict__ src,
                              const int* __restrict__ idx, long long n,
                              S* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = src[idx[i]];
}

template <typename S, int T>
cudaError_t launch_mv(const S* xp, const S* lpool, const S* rpool,
                      const int* psi_idx, const int* it, const int* cumt,
                      int n_items, long long n_units, S* sig,
                      cudaStream_t st) {
  const size_t smem =
      sizeof(S) * ((size_t)T * T + (size_t)T * (kChunk + 1) + kChunk * T);
  cudaError_t e = b2t::allow_smem(mv_kernel<S, T>, smem);
  if (e != cudaSuccess) return e;
  if (n_units > 0)
    mv_kernel<S, T><<<(unsigned)n_units, kThreads, smem, st>>>(
        xp, lpool, rpool, psi_idx, it, cumt, n_items, sig);
  return cudaGetLastError();
}

template <typename S>
cudaError_t matvec(const S* xp, const S* lpool, const S* rpool,
                   const int* psi_idx, const int* it, const int* cumt,
                   int n_items, long long n_units, int T, S* sig,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 16: return launch_mv<S, 16>(xp, lpool, rpool, psi_idx, it, cumt,
                                     n_items, n_units, sig, st);
    case 32: return launch_mv<S, 32>(xp, lpool, rpool, psi_idx, it, cumt,
                                     n_items, n_units, sig, st);
    case 64: return launch_mv<S, 64>(xp, lpool, rpool, psi_idx, it, cumt,
                                     n_items, n_units, sig, st);
    case 128: return launch_mv<S, 128>(xp, lpool, rpool, psi_idx, it, cumt,
                                       n_items, n_units, sig, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename S>
cudaError_t gather(const S* src, const int* idx, long long n, S* out,
                   void* stream) {
  if (n > 0) {
    const long long nb = (n + kThreads - 1) / kThreads;
    gather_kernel<S><<<(unsigned)nb, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(src, idx, n, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* b2t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int b2t_matvec_f64(const double* xp, const double* lpool,
                   const double* rpool, const int* psi_idx, const int* it,
                   const int* cumt, int n_items, long long n_units, int T,
                   double* sig, void* stream) {
  return (int)matvec<double>(xp, lpool, rpool, psi_idx, it, cumt, n_items,
                             n_units, T, sig, stream);
}

int b2t_matvec_f32(const float* xp, const float* lpool, const float* rpool,
                   const int* psi_idx, const int* it, const int* cumt,
                   int n_items, long long n_units, int T, float* sig,
                   void* stream) {
  return (int)matvec<float>(xp, lpool, rpool, psi_idx, it, cumt, n_items,
                            n_units, T, sig, stream);
}

int b2t_gather_f64(const double* src, const int* idx, long long n,
                   double* out, void* stream) {
  return (int)gather<double>(src, idx, n, out, stream);
}

int b2t_gather_f32(const float* src, const int* idx, long long n,
                   float* out, void* stream) {
  return (int)gather<float>(src, idx, n, out, stream);
}

}  // extern "C"
