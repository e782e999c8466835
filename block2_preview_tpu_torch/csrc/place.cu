// K4 — window place of the LW/RW assembly (mix v4).
//
// Replaces block2_preview_tpu/ops/mixv4.py:65 _place4_exec_packed.
// Every window copies one OUT block into the StackedMeta slab pool:
//
//   slab[dst + r*rs + c*cs] += OUT[src + r*sst + c],  r < nb, c < nk
//
// Window fields `pit` [n, 8]: src, sst, dst, rs, cs, nb, nk, nkT; pcum
// [n + 1] prefix sums of the 16 x 16 tile tasks per window.  One block of
// 256 threads per tile task, one thread per element.  The reference adds
// with .at[].add(mode="drop"); the windows are disjoint by construction
// of the plan, but the add is kept as an atomic add so the kernel never
// depends on that proof.  The sentinel slot (last) is never a target.
// Bound on the card: memory traffic, one read and one atomic add per
// element of the output pool.

#include "common.cuh"

namespace {

using b2t::kThreads;

constexpr int kTile = 16;   // the plan's place tile (_TP)

template <typename S>
__global__ void __launch_bounds__(kThreads)
place_kernel(const S* __restrict__ outflat, const int* __restrict__ pit,
             const int* __restrict__ pcum, int n_win, S* __restrict__ res) {
  const long long b = blockIdx.x;
  const int w = b2t::find_item(pcum, n_win, b);
  const int* f = pit + (long long)w * 8;
  const int o = (int)(b - pcum[w]);
  const int nkT = f[7];
  const int ri = o / nkT, ci = o % nkT;
  const int r = ri * kTile + (threadIdx.x >> 4);
  const int c = ci * kTile + (threadIdx.x & 15);
  if (r >= f[5] || c >= f[6]) return;
  const S v = outflat[(long long)f[0] + (long long)r * f[1] + c];
  atomicAdd(res + (long long)f[2] + (long long)r * f[3] + (long long)c * f[4],
            v);
}

template <typename S>
cudaError_t place(const S* outflat, const int* pit, const int* pcum,
                  int n_win, long long n_tasks, S* res, void* stream) {
  if (n_tasks > 0)
    place_kernel<S><<<(unsigned)n_tasks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        outflat, pit, pcum, n_win, res);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_place_f64(const double* outflat, const int* pit, const int* pcum,
                  int n_win, long long n_tasks, double* res, void* stream) {
  return (int)place<double>(outflat, pit, pcum, n_win, n_tasks, res, stream);
}

int b2t_place_f32(const float* outflat, const int* pit, const int* pcum,
                  int n_win, long long n_tasks, float* res, void* stream) {
  return (int)place<float>(outflat, pit, pcum, n_win, n_tasks, res, stream);
}

}  // extern "C"
