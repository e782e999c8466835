// K13 — symbol-mixing GEMM of the mix v3 LW/RW assembly.
//
// Replaces block2_preview_tpu/ops/mixv3.py:62 _env_gemm and :88
// _env_gemm_chunk.  For one env delta-quantum group and the output
// columns d in [c0, c0 + n):
//
//   OUT[w, d] = sum_j W[w, j] * ENV[j, d],
//   ENV[j, d] = epool[eoff[s] + j * dbdk[s] + d - secoff[s]],
//
// s the env sector of column d (the last s with secoff[s] <= d), and
// OUT[w, d] = 0 for d >= secoff[nsec] (the padded columns).  W is sparse
// (1-10% dense); the plan holds it as COO triplets sorted by row, so the
// wrapper passes it as CSR: rowptr [nw_p + 1], wc, wv.
//
// Design.  One thread per output column, kRows output rows per block:
// the thread resolves its column's sector once (binary search over
// secoff), then for each row walks the row's non-zeros and gathers
// ENV[j, d] straight from the env pool, so the product is formed here
// and the dense W or the gathered ENV never reach device memory.  The
// row's triplets are the same for every thread of the block (broadcast
// loads); the 32 threads of a warp read neighbouring env elements of one
// sector row (coalesced).  Every output element of the window is
// written, zeros included.  The sum runs over the row's non-zeros in
// column order: the reference densifies W with .at[].add and multiplies
// at HIGHEST, so results agree to rounding, not bitwise.
// Bound on the card: the FMA count is 2 nnz per column; each env element
// is read once per non-zero of its symbol column, mostly from L1/L2, so
// device memory sees about one read of the group's env rows and one
// write of OUT.

#include "common.cuh"

namespace {

constexpr int kCols = 128;   // output columns per block (one per thread)
constexpr int kRows = 16;    // output rows per block

template <typename S>
__global__ void __launch_bounds__(kCols)
env_gemm_kernel(const S* __restrict__ epool, const int* __restrict__ rowptr,
                const int* __restrict__ wc, const S* __restrict__ wv,
                const int* __restrict__ eoff, const int* __restrict__ dbdk,
                const int* __restrict__ secoff, int nsec_p, int nw_p, int c0,
                int n, S* __restrict__ out) {
  const int dl = blockIdx.x * kCols + threadIdx.x;   // column in the window
  if (dl >= n) return;
  const int d = c0 + dl;
  const int w0 = blockIdx.y * kRows;
  const int w1 = min(w0 + kRows, nw_p);
  if (d >= secoff[nsec_p]) {
    for (int w = w0; w < w1; ++w) out[(long long)w * n + dl] = S(0);
    return;
  }
  // searchsorted(secoff, d, "right") - 1, clipped to [0, nsec_p - 1]
  int lo = 0, hi = nsec_p + 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (secoff[mid] <= d) lo = mid; else hi = mid;
  }
  const int s = min(lo, nsec_p - 1);
  const long long base = (long long)eoff[s] + (d - secoff[s]);
  const long long stride = dbdk[s];
  for (int w = w0; w < w1; ++w) {
    S acc = S(0);
    for (int k = rowptr[w]; k < rowptr[w + 1]; ++k)
      acc += wv[k] * epool[base + (long long)wc[k] * stride];
    out[(long long)w * n + dl] = acc;
  }
}

template <typename S>
int env_gemm(const void* epool, const int* rowptr, const int* wc,
             const void* wv, const int* eoff, const int* dbdk,
             const int* secoff, int nsec_p, int nw_p, int c0, int n,
             void* out, void* stream) {
  if (n > 0 && nw_p > 0) {
    const dim3 grid((n + kCols - 1) / kCols, (nw_p + kRows - 1) / kRows);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    env_gemm_kernel<S><<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const S*>(epool), rowptr, wc, static_cast<const S*>(wv),
        eoff, dbdk, secoff, nsec_p, nw_p, c0, n, static_cast<S*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_env_gemm_f64(const void* epool, const int* rowptr, const int* wc,
                     const void* wv, const int* eoff, const int* dbdk,
                     const int* secoff, int nsec_p, int nw_p, int c0, int n,
                     void* out, void* stream) {
  return env_gemm<double>(epool, rowptr, wc, wv, eoff, dbdk, secoff, nsec_p,
                          nw_p, c0, n, out, stream);
}

int b2t_env_gemm_f32(const void* epool, const int* rowptr, const int* wc,
                     const void* wv, const int* eoff, const int* dbdk,
                     const int* secoff, int nsec_p, int nw_p, int c0, int n,
                     void* out, void* stream) {
  return env_gemm<float>(epool, rowptr, wc, wv, eoff, dbdk, secoff, nsec_p,
                         nw_p, c0, n, out, stream);
}

}  // extern "C"
