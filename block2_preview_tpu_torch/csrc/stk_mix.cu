// K11 — symbol mix of the stacked "bucket" blocking engine (backend
// "torch_stacked").
//
// Replaces block2_preview_tpu/ops/stacked.py:205 _mix_scatter.  For every
// mix row m (one entry (i, o) of the MPO site tensor applied to one sector
// item) and every element e < dx dy of its block:
//
//   out[ooff_m + e] += coef_m * res[soff_m + e]
//
// where res is K10's compact pool (slab.cu) and out the output bond's slab
// pool; the source and target blocks share the (dx x dy) row-major layout,
// so one flat offset e addresses both.  The reference gathers a padded
// [M, Xp, Yp] stack per pow2 chunk of rows and scatter-adds it with masks.
//
// Design.  The gather-by-output core (mix_gather.cuh): the rows are
// grouped by output block (a row's ooff; rows that share it share dx dy,
// and the blocks are disjoint), each block a window of one row of dx dy
// elements, so every output element is summed by one lane in registers and
// written once — no atomics, bitwise repeatable.  Tables from
// ops/stacked.py mix_tables.  At the K=16 site the right side's ~8.3M rows
// fall on ~40k output blocks (~270 adds an output element): the design it
// replaces, one thread and one f64 atomicAdd an element, paid those as
// contended atomics.
//
// Bound on the card: bytes — res read (each element once, though the rows
// read it ~37 times, mostly from L2), the output read and written once, the
// rows' (offset, coefficient) once.

#include "mix_gather.cuh"

namespace {

template <typename S>
int stk_mix(const void* res, const int* units, int n_units, const int* blk,
            const int* bstart, const int* ts, const void* tc, void* out,
            void* stream) {
  // sstr is unused: every block is one row
  return (int)b2t::mix_gather<S>(
      static_cast<const S*>(res), 0, units, n_units, blk, bstart, ts,
      static_cast<const S*>(tc), static_cast<S*>(out),
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int b2t_stk_mix_f64(const void* res, const int* units, int n_units,
                    const int* blk, const int* bstart, const int* ts,
                    const void* tc, void* out, void* stream) {
  return stk_mix<double>(res, units, n_units, blk, bstart, ts, tc, out,
                         stream);
}

int b2t_stk_mix_f32(const void* res, const int* units, int n_units,
                    const int* blk, const int* bstart, const int* ts,
                    const void* tc, void* out, void* stream) {
  return stk_mix<float>(res, units, n_units, blk, bstart, ts, tc, out,
                        stream);
}

}  // extern "C"
