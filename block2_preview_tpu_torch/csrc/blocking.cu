// K5 — environment blocking (one left or right blocking step).
//
// Replaces block2_preview_tpu/ops/blockv2.py:60 _blk_scan (jits
// _blk_exec_chunkp :177 and _blk_exec_chunk :157).  For every plan item
// (env group sector x MPO combo) and every entry e of the item:
//
//   left:  out[e] += coef_e * mb^T E mk
//   right: out[e] += coef_e * mb   E mk^T
//
// on T x T tiles, T in {16, 32, 64, 128}.  Item fields `it` [n, 13]:
// ebase, dk, db, kbase, dy, bbase, dx, nl, nk, nx, ny, tb, pb; entry rows
// `ef` [ne, 4]: item, obase, odx, ody; `coef` [ne].  The reference runs
// three stages per task group: tmp(l, y) = E mk, prod(x, y) = sum_l mb tmp,
// then a scatter of coef * prod per entry.
//
// Design.  Two paths in one call (csrc/blocking.cuh), split on the host
// (ops/blockv2.k5_host_tables):
//  * the slab path, for items whose operands (MB, MK, E and, on v2 plans,
//    the product) fit 32 x 32 elements of shared memory — every item at
//    the K=16 QC site, where the dims are a median of 10 and at most ~30.
//    Items that share one bra and one ket block (the same bbase, kbase
//    and dims: the symbols of one combo's sector) form runs of at most 8,
//    heaviest first (`rh` [n_runs, 9], `wt` [n, 3] = env offset, first
//    and end entry), and one CUDA block a run runs the slab core of K10
//    (csrc/slab_core.cuh): MB and MK staged once, each warp an item with
//    its E staged, a lane a column of the product, tmp = E MK in
//    registers, the rows of E summed in a fixed order.  On the v3 rotate
//    plans (one identity entry an item, the entry blocks disjoint — the
//    host checks it, `excl`) each output element is stored by the one lane
//    that owns it: no atomics, two launches bitwise equal, and the slots
//    above the ROT pool's total are never written.  On v2 plans
//    (fan-out, entries of different items share output blocks) the
//    product is formed once an item in the warp's shared memory, then
//    coef * r is added atomically into each entry's block;
//  * the tile path, for the others (the Hubbard-L16 D=1000 site at
//    T=128): one 256-thread block a stage-1 unit (item, li, yi) of those
//    items (`units`), tmp = sum_ki E[li, ki] mk[ki, yi] in shared memory,
//    then for every xi the partial product mb[li, xi]^T tmp added
//    atomically, times coef, at each entry of the item (the partial sums
//    over li add up to the reference's result).  On the v3 rotate plans
//    (`excl`) a block takes a column strip (item, yi) and runs li = 0, 1,
//    ... itself, storing then adding each element of the item's block
//    from one thread: no atomics on either path, whatever the dims.
// Neither path reads the reference's task groups (g1/g2/g3, tb/pb, the
// stage budgets) or a tmp/prod pool: one call covers the whole plan.
// Pool offsets are 64-bit; only positions inside an entry's (odx, ody)
// block are written, so slots above meta_out.total stay exactly zero (the
// sentinel K1/K2 read).  `cumu` [n + 1] (prefix sums of the units nl * ny
// of the live items) and `efs` [n + 1] (each item's first entry) are the
// tile path's.  Bound on the card: the pools' bytes at the K=16 site; the
// slab path runs true dims on the FMA pipes.  Earlier design: the tile
// path for every item, a 16 x 16 or 32 x 32 tile mostly padding at the
// K=16 site, MB and MK re-read by every item, atomics on every plan.

#include "blocking.cuh"

extern "C" {

int b2t_block_f64(const double* epool, const double* bpool,
                  const double* kpool, const int* it, const int* cumu,
                  int n_items, const int* ef, const double* coef,
                  const int* efs, const int* wt, const int* rh, int n_runs,
                  const int* units, long long n_units, int T, int left,
                  int excl, double* out, void* stream) {
  return (int)block<double>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                            efs, wt, rh, n_runs, units, n_units, T, left,
                            excl, out, stream);
}

int b2t_block_f32(const float* epool, const float* bpool, const float* kpool,
                  const int* it, const int* cumu, int n_items, const int* ef,
                  const float* coef, const int* efs, const int* wt,
                  const int* rh, int n_runs, const int* units,
                  long long n_units, int T, int left, int excl, float* out,
                  void* stream) {
  return (int)block<float>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                           efs, wt, rh, n_runs, units, n_units, T, left,
                           excl, out, stream);
}

}  // extern "C"
