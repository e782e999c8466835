// K15 — scatter tile mix of the v2 LW/RW assembly.
//
// Replaces block2_preview_tpu/ops/resident.py:71 _mix_exec.  For every
// T x T task k with obase >= 0:
//
//   out[obase + r*orstr + c*ocstr] += coef[k] * epool[ebase + r*estr + c]
//
// for r < ermax, c < ecmax.  Task rows come from the plan's table as it
// is, s [n_tasks / B, 7, B] int32 (ebase, estr, ermax, ecmax, obase,
// orstr, ocstr), coef [n_tasks]; the reference scans it in launches of
// _MIX_SCAN x B tasks (a TPU watchdog bound) — here one launch covers
// every task, padded tasks (obase < 0) exit at once.
//
// Design.  One block of 256 threads per task, threads over the tile's
// elements.  Tasks of different (symbol, entry) pairs add into the same
// output elements, so the add is atomic (native f64 on sm_90; the order
// varies between runs, so results agree with the plain version to
// rounding).  Masked lanes add nothing: the output's sentinel slot
// (ncap) stays zero even where the env pool's own sentinel is not.
// Bound on the card: bytes — each live task element reads one env value
// and updates one output value; the atomics' read-modify-write on shared
// output elements is what it pays beyond that.

#include "common.cuh"

namespace {

using b2t::kThreads;

template <typename S>
__global__ void __launch_bounds__(kThreads)
mix_v2_kernel(const S* __restrict__ epool, const int* __restrict__ s,
              const S* __restrict__ coef, int B, int T,
              S* __restrict__ out) {
  const long long k = blockIdx.x;
  const int* row = s + (k / B) * 7LL * B + (k % B);
  const int obase = row[4 * (long long)B];
  if (obase < 0) return;
  const int ebase = row[0], estr = row[B], ermax = row[2 * (long long)B],
            ecmax = row[3 * (long long)B], orstr = row[5 * (long long)B],
            ocstr = row[6 * (long long)B];
  const int nr = min(ermax, T), nc = min(ecmax, T);
  if (nr <= 0 || nc <= 0) return;
  const S cf = coef[k];
  for (int e = threadIdx.x; e < nr * nc; e += kThreads) {
    const int r = e / nc, c = e % nc;
    atomicAdd(out + (long long)obase + (long long)r * orstr +
                  (long long)c * ocstr,
              cf * epool[(long long)ebase + (long long)r * estr + c]);
  }
}

template <typename S>
int mix_v2(const void* epool, const int* s, const void* coef,
           long long n_tasks, int B, int T, void* out, void* stream) {
  if (n_tasks > 0)
    mix_v2_kernel<S><<<(unsigned)n_tasks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const S*>(epool), s, static_cast<const S*>(coef), B, T,
        static_cast<S*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_mix_v2_f64(const void* epool, const int* s, const void* coef,
                   long long n_tasks, int B, int T, void* out,
                   void* stream) {
  return mix_v2<double>(epool, s, coef, n_tasks, B, T, out, stream);
}

int b2t_mix_v2_f32(const void* epool, const int* s, const void* coef,
                   long long n_tasks, int B, int T, void* out,
                   void* stream) {
  return mix_v2<float>(epool, s, coef, n_tasks, B, T, out, stream);
}

}  // extern "C"
