// K22 — one rank's partial sigma of the sharded padded-bucket matvec.
//
// Replaces the rank-local body of block2_preview_tpu/parallel/shard.py:30
// _partial_sigma (jit :78, ShardedPlanExecutor :41): each device's P(axis)
// slice of every padded bucket's batch (the batch padded to a multiple of
// the mesh size, :53-71), sigma[oidx] += A . xp[pidx] . R^T, before the
// psum.
//
// Design.  K18's kernel (csrc/plan_exec.cuh) over this rank's contiguous
// slice of each bucket's batch: `cum` [nb + 1] prefix-sums the blocks of
// the rank's items only and `first` [nb] holds each bucket's first item
// of the slice, so one launch covers the rank's share of every bucket and
// nothing else; the bucket table `desc` and the two flat pools are the
// whole plan's, shared with K18.  The reference's extra padding items (zero
// blocks, sentinel indices) add nothing, so a slice that would reach past a
// bucket's batch is cut at its end.  Zero products still skip their
// atomics.  The caller (parallel/shard.py ShardedPlanExecutor) sums the
// ranks' sigmas with torch.distributed.all_reduce, the psum's counterpart.
// Bound on the card: as K18, over this rank's share of the items.

#include "plan_exec.cuh"

extern "C" {

int b2t_plan_exec_part_f64(const void* xp, long long x_len, const void* vals,
                           const int* ints, const long long* desc,
                           const long long* cum, const long long* first,
                           int nb, long long n_blocks, long long sig_len,
                           void* sigma, void* stream) {
  return plan_exec<double>(xp, x_len, vals, ints, desc, cum, first, nb,
                           n_blocks, sig_len, sigma, stream);
}

int b2t_plan_exec_part_f32(const void* xp, long long x_len, const void* vals,
                           const int* ints, const long long* desc,
                           const long long* cum, const long long* first,
                           int nb, long long n_blocks, long long sig_len,
                           void* sigma, void* stream) {
  return plan_exec<float>(xp, x_len, vals, ints, desc, cum, first, nb,
                          n_blocks, sig_len, sigma, stream);
}

}  // extern "C"
