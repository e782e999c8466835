// K8 — bucketed sigma matvec of the bucketed executor (backends "torch"
// and "torch_device").
//
// Replaces block2_preview_tpu/ops/exec_jax.py:136-150 _fused_sigma_impl /
// _fused_sigma (and the matvec inside :347 _dav_jit).  For every triple
// (m, lk, pk, rk, ok) of an effective Hamiltonian, one item:
//
//   sigma[ok] += LW[m][lk] (a x k) . psi[pk] (k x n) . RW[m][rk]^T (n x p)
//
// in float or double.  The reference pads every block into _round_dim
// buckets (1, 2, 4, 8, 16, then multiples of 16), gathers padded stacks
// A = lpool[ga], P = xp[pidx], R = rpool[gr] into device memory, runs one
// batched einsum per bucket and sums the pieces with a sorted segment-sum
// over perm / seg_ids, then masks sigma past `size`.
//
// Design.  No padded stack exists here.  The LW and RW matrices are packed
// once into flat pools (ops/exec_bucket.py); each item is 8 int32 scalars
// `it` [n, 8]: loff, a, k, poff, n, roff, p, ooff (offsets into the LW
// pool, psi, the RW pool and sigma; true dims).  `cum` [n + 1] prefix-sums
// the CUDA blocks of each item (chain_blocks(a, p)); a block finds its item
// by binary search and runs chain.cuh's chain product on the true dims,
// adding into sigma with atomics (items share output blocks).  Sigma slots
// past `size` are never written, which is the reference's mask.  Atomic
// order varies between runs: results agree with the plain version to
// rounding, not bitwise.
//
// Bound on the card: at true shapes one matvec must read the LW/RW
// matrices its triples use, psi and write sigma, and do sum 2akn + 2anp
// FLOPs (the count of K1 and K7, dmrg/sweep.py _eff_flops); at K=16 D=250
// site 7 the two bounds are within 1.5x of each other.  _round_dim's
// padding never enters the products here (chip_smoke.py prints the share
// it would add).  The products run on the FMA pipes from shared memory;
// tensor-core MMA (DMMA for f64) and grouping small items into one block
// are left for a later PR.

#include "chain.cuh"

namespace {

using b2t::kThreads;

template <typename S>
__global__ void __launch_bounds__(kThreads)
bucket_kernel(const S* __restrict__ xp, const S* __restrict__ lp,
              const S* __restrict__ rp, const int* __restrict__ it,
              const int* __restrict__ cum, int n_items, S* __restrict__ out) {
  const long long b = blockIdx.x;
  const int item = b2t::find_item(cum, n_items, b);
  const int* f = it + (long long)item * 8;
  const int a = f[1], k = f[2], n = f[4], p = f[6];
  // A = LW (a x k), B = psi (k x n), C(n, p) = RW[p, n]
  b2t::chain_block<S>(lp + f[0], k, 1, xp + f[3], n, rp + f[5], 1, n,
                      a, k, n, p, (int)(b - cum[item]), S(1), out + f[7], p);
}

template <typename S>
int bucket(const void* xp, const void* lp, const void* rp, const int* it,
           const int* cum, int n_items, long long n_blocks, void* out,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0)
    bucket_kernel<S><<<(unsigned)n_blocks, kThreads, 0, st>>>(
        static_cast<const S*>(xp), static_cast<const S*>(lp),
        static_cast<const S*>(rp), it, cum, n_items, static_cast<S*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_bucket_f64(const void* xp, const void* lp, const void* rp,
                   const int* it, const int* cum, int n_items,
                   long long n_blocks, void* out, void* stream) {
  return bucket<double>(xp, lp, rp, it, cum, n_items, n_blocks, out, stream);
}

int b2t_bucket_f32(const void* xp, const void* lp, const void* rp,
                   const int* it, const int* cum, int n_items,
                   long long n_blocks, void* out, void* stream) {
  return bucket<float>(xp, lp, rp, it, cum, n_items, n_blocks, out, stream);
}

}  // extern "C"
