// K21 — one rank's partial output pool of the operator-sharded blocking.
//
// Replaces the rank-local body of block2_preview_tpu/ops/blockv2.py:193
// _blk_exec_sharded: device d's _blk_scan (:60) over the round-robin task
// groups d, d + nd, ... (the interleave of execute_blocking_v2, :921-946),
// before the psum (:211).
//
// Design.  K5's two paths (csrc/blocking.cuh) over this rank's items:
// the host (ops/blockv2.blk_rank_part) builds K5's slab runs from the
// items of the rank's task groups only (no run crosses a rank's share)
// and lists the stage-1 units of its items that take the tile path.  A
// reference task group is a run of whole items (build_blocking_v2 starts
// a group at an item boundary in all three stages), and each item adds
// its product for every entry of its own, so the rank's items give exactly
// that device's partial output pool.  On the v3 rotate plans each element
// of the ROT pool is stored by one item, so the ranks' partial pools
// summed are bitwise one K5 launch.  The caller (ops/blockv2.py
// execute_blocking_v2) sums the ranks' pools with
// torch.distributed.all_reduce, the counterpart of the psum.
// Bound on the card: as K5, over this rank's share of the items.

#include "blocking.cuh"

extern "C" {

int b2t_block_units_f64(const double* epool, const double* bpool,
                        const double* kpool, const int* it, const int* cumu,
                        int n_items, const int* ef, const double* coef,
                        const int* efs, const int* wt, const int* rh,
                        int n_runs, const int* units, long long n_units,
                        int T, int left, int excl, double* out,
                        void* stream) {
  return (int)block<double>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                            efs, wt, rh, n_runs, units, n_units, T, left,
                            excl, out, stream);
}

int b2t_block_units_f32(const float* epool, const float* bpool,
                        const float* kpool, const int* it, const int* cumu,
                        int n_items, const int* ef, const float* coef,
                        const int* efs, const int* wt, const int* rh,
                        int n_runs, const int* units, long long n_units,
                        int T, int left, int excl, float* out,
                        void* stream) {
  return (int)block<float>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                           efs, wt, rh, n_runs, units, n_units, T, left,
                           excl, out, stream);
}

}  // extern "C"
