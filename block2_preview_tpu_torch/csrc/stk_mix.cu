// K11 — symbol mix scatter of the stacked "bucket" blocking engine
// (backend "torch_stacked").
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
// Design.  One launch over all rows of the plan, one thread per element:
// rows `rows` [M, 3] int32 (soff, ooff, dx dy), coefficients `coef` [M]
// and `ecum` [M + 1] int64, the prefix sums of the rows' elements.  A
// thread finds its row by binary search over ecum, so small and large
// rows alike keep every thread busy, and adds into the output with an
// atomic: many rows (the entries of one output symbol, over items) share
// an output block.  f64 atomicAdd is native on sm_90; the order of the
// adds varies, so results agree with the plain version to rounding.
//
// Bound on the card: bytes — res read and the output updated per element
// (two FLOPs each); the atomics' read-modify-write on shared output
// blocks is what this kernel pays beyond that.

#include "common.cuh"

namespace {

constexpr int kMixThreads = 256;

__device__ __forceinline__ int find_row(const long long* __restrict__ ecum,
                                        int n, long long e) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (ecum[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

template <typename S>
__global__ void __launch_bounds__(kMixThreads)
stk_mix_kernel(const S* __restrict__ res, const int* __restrict__ rows,
               const long long* __restrict__ ecum,
               const S* __restrict__ coef, int n_rows, long long n_elems,
               S* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kMixThreads + threadIdx.x;
  if (e >= n_elems) return;
  const int m = find_row(ecum, n_rows, e);
  const int* r = rows + (long long)m * 3;
  const long long o = e - ecum[m];
  atomicAdd(out + r[1] + o, coef[m] * res[r[0] + o]);
}

template <typename S>
int stk_mix(const void* res, const int* rows, const long long* ecum,
            const void* coef, int n_rows, long long n_elems, void* out,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_blocks = (n_elems + kMixThreads - 1) / kMixThreads;
  if (n_blocks > 0)
    stk_mix_kernel<S><<<(unsigned)n_blocks, kMixThreads, 0, st>>>(
        static_cast<const S*>(res), rows, ecum, static_cast<const S*>(coef),
        n_rows, n_elems, static_cast<S*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_stk_mix_f64(const void* res, const int* rows, const long long* ecum,
                    const void* coef, int n_rows, long long n_elems,
                    void* out, void* stream) {
  return stk_mix<double>(res, rows, ecum, coef, n_rows, n_elems, out, stream);
}

int b2t_stk_mix_f32(const void* res, const int* rows, const long long* ecum,
                    const void* coef, int n_rows, long long n_elems,
                    void* out, void* stream) {
  return stk_mix<float>(res, rows, ecum, coef, n_rows, n_elems, out, stream);
}

}  // extern "C"
