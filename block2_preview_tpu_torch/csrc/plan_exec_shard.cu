// K22 — one rank's partial sigma of the sharded padded-bucket matvec.
//
// Replaces the rank-local body of block2_preview_tpu/parallel/shard.py:30
// _partial_sigma (jit :78, ShardedPlanExecutor :41): each device's P(axis)
// slice of every padded bucket's batch (the batch padded to a multiple of
// the mesh size, :53-71), sigma[oidx] += A . xp[pidx] . R^T, before the
// psum.
//
// Design.  K18's kernel (csrc/plan_exec.cu: the chain core's strided
// instance, csrc/chain_mv.cuh) over this rank's share of K18's true items.
// The host (ops/exec_bucket.py PlanExecutor.rank_part) records the bucket
// and batch index of each true item, keeps the items whose batch index lies
// in the rank's contiguous slice [i0, i1) of their bucket, sorts them by
// sigma block with the ket blocks of one taken in turn (as K16's) and cuts
// them into chunks at K18's FLOP band (a share's chunks hold as much work
// as K18's), once per (rank, world).
// The reference's padding items (zero blocks, sentinel indices) add
// nothing, and no chunk holds one; each true item lies in exactly one
// rank's share.  A and R are read in place from the whole plan's padded
// stacks, shared with K18; psi and sigma at their true flat offsets, one
// atomic a sigma element a chunk (atomic order varies between runs:
// results agree with the plain version to rounding).  The caller
// (parallel/shard.py ShardedPlanExecutor) sums the ranks' sigmas with
// torch.distributed.all_reduce, the psum's counterpart.
// Bound on the card: as K18, over this rank's share of the items.

#include "chain_mv.cuh"

extern "C" {

int b2t_plan_exec_part_f64(const void* xp, const void* vals, const int* items,
                           const int* ent, const int* ck, long long n_chunks,
                           int T, void* out, void* stream) {
  return (int)chain_mv<double, true>(xp, vals, vals, items, ent, ck,
                                     n_chunks, T, out, stream);
}

int b2t_plan_exec_part_f32(const void* xp, const void* vals, const int* items,
                           const int* ent, const int* ck, long long n_chunks,
                           int T, void* out, void* stream) {
  return (int)chain_mv<float, true>(xp, vals, vals, items, ent, ck,
                                    n_chunks, T, out, stream);
}

}  // extern "C"
