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

#include "matvec.cuh"

namespace {

using b2t::kThreads;

// out[i] = src[idx[i]]: flattens a tile pool through sig_idx.
template <typename S>
__global__ void gather_kernel(const S* __restrict__ src,
                              const int* __restrict__ idx, long long n,
                              S* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = src[idx[i]];
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
                             nullptr, n_units, T, sig, stream);
}

int b2t_matvec_f32(const float* xp, const float* lpool, const float* rpool,
                   const int* psi_idx, const int* it, const int* cumt,
                   int n_items, long long n_units, int T, float* sig,
                   void* stream) {
  return (int)matvec<float>(xp, lpool, rpool, psi_idx, it, cumt, n_items,
                            nullptr, n_units, T, sig, stream);
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
