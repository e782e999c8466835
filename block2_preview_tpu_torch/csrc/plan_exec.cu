// K18 — the padded-bucket sigma matvec of PlanExecutor.
//
// Replaces block2_preview_tpu/ops/exec_jax.py:36 _execute_impl (jit :48
// _execute), :55 _bucket_exec and :64 _pad_one: for every bucket (A, R,
// pidx, oidx) of a PlanExecutor — A [B, a, k], R [B, p, n] the LW/RW
// blocks zero-padded to _round_dim shapes, pidx [B, k, n] and oidx
// [B, a, p] int32 flat indices into the padded psi / sigma (sentinel
// size_p, whose psi slot is zero) — and every item b of it:
//
//   sigma[oidx[b]] += A[b] . xp[pidx[b]] . R[b]^T
//
// in float or double; an output index past the end of sigma is dropped
// (the reference's scatter mode="drop").  The stacks run as they are: the
// padded dims and the padded batch items (zero blocks, sentinel indices)
// are computed like the true ones, so the work is the padded work (about
// twice the true work at the K=16 sites).
//
// Design.  The buckets' stacks live in two flat pools (ops/exec_bucket.py
// PlanExecutor: one for A and R, one for pidx and oidx; each bucket's
// fields are views into them).  A table `desc` [nb, 9] (int64) holds per
// bucket a, k, n, p, the CUDA blocks of one item, and the offsets of its
// A, R, pidx and oidx; `cum` [nb + 1] prefix-sums the buckets' blocks.
// One launch covers every item of every bucket: a block finds its bucket
// by binary search, its item and its strip by division, and runs
// chain.cuh's chain product (32-row strips x 128-column groups of the
// a x p output, K8's tiling) with psi gathered through pidx as it is
// staged and each result added into sigma through oidx with atomics
// (items share output rows).  A zero result is not added: every padded
// element points at the one sentinel slot, and adding its zeros there
// serialized the atomics (43.0 ms at the K=16 site 7, D=250, on an H100
// 80GB HBM3 at 700 W; 5.6 ms without them, K8 2.1 ms).  Atomic order varies between runs: results agree with the
// plain version to rounding.
//
// Bound on the card: the true-shape bytes and FLOPs of the items (K8's
// convention: the LW/RW blocks, psi and sigma once, 2akn + 2anp FLOPs per
// item); the padding is work this kernel does on top of that bound.

#include "plan_exec.cuh"

extern "C" {

int b2t_plan_exec_f64(const void* xp, long long x_len, const void* vals,
                      const int* ints, const long long* desc,
                      const long long* cum, int nb, long long n_blocks,
                      long long sig_len, void* sigma, void* stream) {
  return plan_exec<double>(xp, x_len, vals, ints, desc, cum, nullptr, nb,
                           n_blocks, sig_len, sigma, stream);
}

int b2t_plan_exec_f32(const void* xp, long long x_len, const void* vals,
                      const int* ints, const long long* desc,
                      const long long* cum, int nb, long long n_blocks,
                      long long sig_len, void* sigma, void* stream) {
  return plan_exec<float>(xp, x_len, vals, ints, desc, cum, nullptr, nb,
                          n_blocks, sig_len, sigma, stream);
}

}  // extern "C"
