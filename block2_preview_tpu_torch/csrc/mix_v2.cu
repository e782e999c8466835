// K15 — scatter tile mix of the v2 LW/RW assembly.
//
// Replaces block2_preview_tpu/ops/resident.py:71 _mix_exec.  For every
// T x T task k with obase >= 0:
//
//   out[obase + r*orstr + c*ocstr] += coef[k] * epool[ebase + r*estr + c]
//
// for r < min(ermax, T), c < min(ecmax, T).  The reference scans the
// plan's [n_launch, _MIX_SCAN, 7, B] task table in launches of _MIX_SCAN x
// B tasks (a TPU watchdog bound), padded tasks (obase < 0) masked.
//
// Design.  The gather-by-output core (mix_gather.cuh), its strided
// instance: one output block a distinct output window (a task's obase;
// the tasks that share it share the window, its strides and the source
// row stride estr), the window's terms the tasks' (ebase, coef).  Every
// output element is summed by one owner lane in registers, in the plan's
// task order, and written once — no atomics, bitwise repeatable; the
// output's sentinel slot (ncap) and its padding are never touched.  The
// tables come from the plan's own obase order (ops/resident.py
// k15_tables, cached on the plan): no sort, padded tasks dropped, the
// windows checked element-disjoint.  The design it replaces ran one
// 256-thread block a task, padded tasks included, and one f64 atomicAdd an
// element: the tasks that add into one window contended for it.
//
// Bound on the card: bytes — each live task element reads one env value
// (the pool read once), each output element is read and written once, the
// terms' (offset, coefficient) once.

#include "mix_gather.cuh"

namespace {

template <typename S>
int mix_v2(const void* epool, const int* units, int n_units, const int* blk,
           const int* bstart, const int* ts, const void* tc, void* out,
           void* stream) {
  return (int)b2t::mix_gather<S, true>(
      static_cast<const S*>(epool), 0, units, n_units, blk, bstart, ts,
      static_cast<const S*>(tc), static_cast<S*>(out),
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int b2t_mix_v2_f64(const void* epool, const int* units, int n_units,
                   const int* blk, const int* bstart, const int* ts,
                   const void* tc, void* out, void* stream) {
  return mix_v2<double>(epool, units, n_units, blk, bstart, ts, tc, out,
                        stream);
}

int b2t_mix_v2_f32(const void* epool, const int* units, int n_units,
                   const int* blk, const int* bstart, const int* ts,
                   const void* tc, void* out, void* stream) {
  return mix_v2<float>(epool, units, n_units, blk, bstart, ts, tc, out,
                       stream);
}

}  // extern "C"
