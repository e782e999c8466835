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
// loff, a, k, poff, n, roff, p, ooff (offsets into the LW pool, psi, the
// RW pool and sigma; true dims).  ops/exec_bucket.py kernel_tables sorts
// the items by their sigma block ooff and cuts them, with ops/chain_mv.py,
// into FLOP-bounded chunks of entries that write one piece of one sigma
// block; the chain core (csrc/chain_mv.cuh) runs one chunk a CUDA block:
// tmp = A . B stays in shared memory, the chunk's sum over its items (the
// symbols m and ket sectors of one bra block) in registers, and sigma gets
// one atomic an element a chunk.  Only the true dims are multiplied, in 8 x
// 8 fragments (f64 on DMMA m8n8k4, f32 on the FMA pipes).  Sigma slots
// past `size` are never written, which is the reference's mask.  Atomic
// order varies between runs: results agree with the plain version to
// rounding, not bitwise.  K8 had its own body in chain.cuh before (a
// 256-thread block an item strip, 2 x 2 FMA micro tiles, one atomic an
// element an item); chain.cuh stays as it is for K22.
//
// Bound on the card: at true shapes one matvec must read the LW/RW
// matrices its triples use, psi and write sigma, and do sum 2akn + 2anp
// FLOPs (the count of K1 and K7, dmrg/sweep.py _eff_flops); at K=16 D=250
// site 7 the two bounds are within 1.5x of each other.  _round_dim's
// padding never enters the products here (chip_smoke.py prints the share
// it would add).

#include "chain_mv.cuh"

extern "C" {

int b2t_bucket_f64(const void* xp, const void* lp, const void* rp,
                   const int* items, const int* ent, const int* ck,
                   long long n_chunks, int T, void* out,
                   void* stream) {
  return (int)chain_mv<double>(xp, lp, rp, items, ent, ck, n_chunks, T,
                               out, stream);
}

int b2t_bucket_f32(const void* xp, const void* lp, const void* rp,
                   const int* items, const int* ent, const int* ck,
                   long long n_chunks, int T, void* out,
                   void* stream) {
  return (int)chain_mv<float>(xp, lp, rp, items, ent, ck, n_chunks, T,
                              out, stream);
}

}  // extern "C"
