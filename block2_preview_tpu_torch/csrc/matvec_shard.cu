// K20 — one rank's partial sigma of the operator-sharded matvec.
//
// Replaces the rank-local body of block2_preview_tpu/ops/tilev2.py:197
// _mv_exec_sharded: device d's _mv_scan (:101) over the global task groups
// d, d + nd, ... (tilev2.shard_groups :232), before the psum (:221).
//
// Design.  K1's kernel (the chain core, csrc/chain_mv.cuh) over chunk
// tables built from this rank's items only (ops/tilev2.py
// MatvecV2.rank_part).  A reference task group is a run of whole items
// (the plan builder starts a group at an item boundary, in both stages),
// so the chunks of a rank's groups give exactly that device's partial
// sigma, in the flat layout the reference reaches through sig_idx.  The
// caller sums the compact sigmas of all ranks with
// torch.distributed.all_reduce, the counterpart of the psum: the gather is
// linear, so reducing the compact vector equals reducing the tile pool.
// Bound on the card: as K1, over this rank's share of the items (the
// LW/RW blocks its items read).

#include "chain_mv.cuh"

extern "C" {

int b2t_matvec_units_f64(const void* xp, const void* lpool,
                         const void* rpool, const int* items,
                         const int* ent, const int* ck, long long n_chunks,
                         int T, void* sig, void* stream) {
  return (int)chain_mv<double>(xp, lpool, rpool, items, ent, ck, n_chunks, T,
                               sig, stream);
}

int b2t_matvec_units_f32(const void* xp, const void* lpool,
                         const void* rpool, const int* items,
                         const int* ent, const int* ck, long long n_chunks,
                         int T, void* sig, void* stream) {
  return (int)chain_mv<float>(xp, lpool, rpool, items, ent, ck, n_chunks, T,
                              sig, stream);
}

}  // extern "C"
