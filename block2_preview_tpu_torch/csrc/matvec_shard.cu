// K20 — one rank's partial sigma of the operator-sharded matvec.
//
// Replaces the rank-local body of block2_preview_tpu/ops/tilev2.py:197
// _mv_exec_sharded: device d's _mv_scan (:101) over the global task groups
// d, d + nd, ... (tilev2.shard_groups :232), before the psum (:221).
//
// Design.  K1's kernel (csrc/matvec.cuh) over an index list of this
// rank's stage-1 units: block b runs unit units[b], so only the blocks of
// this rank's units launch.  A reference task group is a run of whole
// items (the plan builder starts a group at an item boundary, in both
// stages), and K1's unit (item, ai, ni) adds all of its own stage-2
// products, so the units of a rank's groups give exactly that device's
// partial sigma tile pool.  The wrapper (ops/tilev2.py mv_exec_part)
// flattens it through sig_idx and the caller sums the compact sigmas of
// all ranks with torch.distributed.all_reduce, the counterpart of the
// psum: the gather is linear, so reducing the compact vector equals
// reducing the tile pool.
// Bound on the card: as K1, over this rank's share of the units (the
// LW/RW pools and psi are read where this rank's items touch them).

#include "matvec.cuh"

extern "C" {

int b2t_matvec_units_f64(const double* xp, const double* lpool,
                         const double* rpool, const int* psi_idx,
                         const int* it, const int* cumt, int n_items,
                         const int* units, long long n_units, int T,
                         double* sig, void* stream) {
  return (int)matvec<double>(xp, lpool, rpool, psi_idx, it, cumt, n_items,
                             units, n_units, T, sig, stream);
}

int b2t_matvec_units_f32(const float* xp, const float* lpool,
                         const float* rpool, const int* psi_idx,
                         const int* it, const int* cumt, int n_items,
                         const int* units, long long n_units, int T,
                         float* sig, void* stream) {
  return (int)matvec<float>(xp, lpool, rpool, psi_idx, it, cumt, n_items,
                            units, n_units, T, sig, stream);
}

}  // extern "C"
