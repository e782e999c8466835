// K21 — one rank's partial output pool of the operator-sharded blocking.
//
// Replaces the rank-local body of block2_preview_tpu/ops/blockv2.py:193
// _blk_exec_sharded: device d's _blk_scan (:60) over the round-robin task
// groups d, d + nd, ... (the interleave of execute_blocking_v2, :921-946),
// before the psum (:211).
//
// Design.  K5's kernel (csrc/blocking.cuh) over an index list of this
// rank's stage-1 units: block b runs unit units[b], so only the blocks of
// this rank's units launch.  A reference task group is a run of whole
// items (build_blocking_v2 starts a group at an item boundary in all three
// stages), and K5's unit (item, li, yi) adds its stages 2 and 3 for every
// entry of its own item, so the units of a rank's groups give exactly that
// device's partial output pool.  The caller (ops/blockv2.py
// execute_blocking_v2) sums the ranks' pools with
// torch.distributed.all_reduce, the counterpart of the psum.
// Bound on the card: as K5, over this rank's share of the units.

#include "blocking.cuh"

extern "C" {

int b2t_block_units_f64(const double* epool, const double* bpool,
                        const double* kpool, const int* it, const int* cumu,
                        int n_items, const int* ef, const double* coef,
                        const int* efs, const int* units, long long n_units,
                        int T, int left, double* out, void* stream) {
  return (int)block<double>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                            efs, units, n_units, T, left, out, stream);
}

int b2t_block_units_f32(const float* epool, const float* bpool,
                        const float* kpool, const int* it, const int* cumu,
                        int n_items, const int* ef, const float* coef,
                        const int* efs, const int* units, long long n_units,
                        int T, int left, float* out, void* stream) {
  return (int)block<float>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                           efs, units, n_units, T, left, out, stream);
}

}  // extern "C"
