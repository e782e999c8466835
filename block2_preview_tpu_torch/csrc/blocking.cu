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
// Design.  One CUDA block owns one stage-1 unit (item, li, yi): it forms
// tmp = sum_ki E[li, ki] mk[ki, yi] in shared memory; then for every xi it
// forms the partial product mb[li, xi]^T tmp (the sum over the li strip
// only) and, for each entry of the item, atomically adds coef * partial at
// the entry's output position.  Stages 2 and 3 are linear, so the partial
// sums over li add up to the reference's result:
//  * no tmp or prod pool in device memory, and no task-group budgets: the
//    reference's tb/pb bases and g1/g2/g3 group tables are not read, and
//    one launch covers the whole plan;
//  * E, mk and mb tiles are read straight from the pools at
//    base + r*stride + c with 64-bit offsets and edge masks;
//  * the output positions of different units overlap (the same out block
//    gets every li strip and every combo of an entry's symbol), so the
//    adds are atomic; f64 atomicAdd (native on sm_90) sums in no fixed
//    order, so results match the reference to rounding, not bitwise.
//    Only positions inside an entry's (odx, ody) block are written: slots
//    above meta_out.total stay exactly zero (the sentinel K1/K2 read).
// Per-item tables derived on the host (ops/blockv2.blk_tables): `cumu`
// [n + 1], prefix sums of the units nl * ny of the live items, and `efs`
// [n + 1], each item's first entry row (entries are sorted by item).
// Bound on the card: the f64/f32 FMA pipes at small T (each unit re-reads
// its E strip once per unit and mb once per xi), and the output atomics
// where many entries share a block (v2 plans fan out up to ~40 entries per
// item; v3 plans have one identity entry each).  Tensor-core MMA (DMMA)
// and a shared-memory reduction of the stage-3 adds are later work.

#include "blocking.cuh"

extern "C" {

int b2t_block_f64(const double* epool, const double* bpool,
                  const double* kpool, const int* it, const int* cumu,
                  int n_items, const int* ef, const double* coef,
                  const int* efs, long long n_units, int T, int left,
                  double* out, void* stream) {
  return (int)block<double>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                            efs, nullptr, n_units, T, left, out, stream);
}

int b2t_block_f32(const float* epool, const float* bpool, const float* kpool,
                  const int* it, const int* cumu, int n_items, const int* ef,
                  const float* coef, const int* efs, long long n_units, int T,
                  int left, float* out, void* stream) {
  return (int)block<float>(epool, bpool, kpool, it, cumu, n_items, ef, coef,
                           efs, nullptr, n_units, T, left, out, stream);
}

}  // extern "C"
