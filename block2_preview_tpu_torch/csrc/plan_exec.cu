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
// (the reference's scatter mode="drop").
//
// Design.  Only the true items are multiplied, at their true shapes.  A
// true item b of a bucket is one triple (LW block a0 x k0, RW block
// p0 x n0): pidx[b] is the range poff + arange(k0 n0) on its first k0 rows
// and n0 columns and the sentinel elsewhere, oidx[b] likewise the range
// ooff + arange(a0 p0), and the rest of A[b] and R[b] is zero, so the
// padded rows, columns and batch items add nothing.  The host
// (ops/exec_bucket.py PlanExecutor) records each true item as it builds
// the stacks, as ten int32 fields: the offset of A[b] in the value pool
// `vals`, a0, k0, poff, n0, the offset of R[b], p0, ooff, and the padded
// row lengths k and n; it sorts them by sigma block and cuts them, with
// ops/chain_mv.py, into chunks of entries that write one 64 x 64 piece of
// one sigma block, once per executor.  The chain core (csrc/chain_mv.cuh,
// K8's, in its strided instance) runs one chunk a CUDA block: A and R are
// read in place from the padded stacks at their bucket's row lengths, psi
// and sigma at their true flat offsets (no pidx / oidx gather), f64 on
// DMMA m8n8k4 and f32 on the FMA pipes in 8 x 8 fragments of the true
// shapes, and sigma gets one atomic an element a chunk.  The stacks stay
// on the card as the one copy of the operators: K22 and the plain version
// read them as the reference's buckets.  Sigma slots past the true blocks
// (the sentinel size_p among them) are never written.  Atomic order varies
// between runs: results agree with the plain version to rounding.
//
// K18 ran before on csrc/chain.cuh's block body (plan_exec.cuh, which K22
// keeps): a CUDA block a 32-row strip x 128-column group of one padded
// item's output, 2 x 2 FMA micro tiles, psi gathered through pidx as it
// was staged and one atomic an element an item through oidx, zero products
// skipped (adding them to the one sentinel slot serialized the atomics:
// 43.0 ms against 5.6 ms at the K=16 site 7, D=250, on an H100 80GB HBM3
// at 700 W).  It multiplied the padded work (10.40 GFLOP against 4.79
// true at that site).
//
// Bound on the card: the true-shape bytes and FLOPs of the items (K8's
// convention: the LW/RW blocks, psi and sigma once, 2akn + 2anp FLOPs per
// item).

#include "chain_mv.cuh"

extern "C" {

int b2t_plan_exec_f64(const void* xp, const void* vals, const int* items,
                      const int* ent, const int* ck, long long n_chunks,
                      int T, void* out, void* stream) {
  return (int)chain_mv<double, true>(xp, vals, vals, items, ent, ck,
                                     n_chunks, T, out, stream);
}

int b2t_plan_exec_f32(const void* xp, const void* vals, const int* items,
                      const int* ent, const int* ck, long long n_chunks,
                      int T, void* out, void* stream) {
  return (int)chain_mv<float, true>(xp, vals, vals, items, ent, ck,
                                    n_chunks, T, out, stream);
}

}  // extern "C"
