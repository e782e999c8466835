// K17 — the pooled N-PDM engine's middle class close, out = M @ V.
//
// Replaces block2_preview_tpu/dmrg/npdm_scheme.py:376 _mm (the jit
// jnp.matmul at Precision.HIGHEST inside :357 _device_gemm): at every
// middle site of pooled_gram, each (need, n_cre) class closes its flat
// right-pool matrix M [n, X] (one row per right suffix, X the flattened
// bond sectors) against the batch V [X, m] of flattened (left x site)
// environments, in float64 or complex128.
//
// Bound on the card.  The closes are skinny: n is 8-200 rows while V is
// long and wide (X up to ~2e4, m up to ~9e3; at K=16, D=250, order 2 the
// largest is [8 x 19545] @ [19545 x 1542], 241 MB of V).  The least
// traffic is one read of M and V and one write of out; the FLOPs (2 n X m)
// are below the byte time except for the tallest M.  A design that read V
// once per row of M would miss the byte bound n times.
//
// Design.  One CUDA block of 256 threads owns a tile of kBM = 64 rows of M
// and kBN = 64 columns of V, so V is read ceil(n / 64) times in all (once
// for n <= 64).  It walks its slice of X in chunks of kBK = 16, staging the
// M chunk (transposed) and the V chunk in shared memory; each thread keeps
// a 4 x 4 micro tile of out in registers (rows ty + 16 i, columns tx + 16
// j), FMA on the CUDA cores.  With few tiles (n <= 64 and a narrow V) that
// would leave most of the 132 SMs idle, so X is also split over gridDim.z
// slices of `kchunk` (a multiple of kBK), chosen by the wrapper
// (ops/npdm_gemm.py) to give about four blocks per SM; the slices add into
// a zeroed out with atomics, and with one slice the block stores its tile.
// Atomic order varies between runs: results agree with the plain version
// to rounding.  DMMA (f64 tensor-core MMA) and TMA staging are left for a
// later PR.

#include "common.cuh"

namespace {

using b2t::kThreads;

constexpr int kBM = 64;   // rows of M per block
constexpr int kBN = 64;   // columns of V per block
constexpr int kBK = 16;   // depth of one staged chunk of X

template <typename R>
struct __align__(2 * sizeof(R)) cplx {
  R x, y;
  cplx() = default;
  __device__ constexpr cplx(R a, R b = R(0)) : x(a), y(b) {}
};

// acc += a * b
template <typename S>
__device__ __forceinline__ void mac(S& acc, S a, S b) { acc += a * b; }

template <typename R>
__device__ __forceinline__ void mac(cplx<R>& acc, cplx<R> a, cplx<R> b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

template <typename S>
__device__ __forceinline__ void atomic_add(S* p, S v) { atomicAdd(p, v); }

template <typename R>
__device__ __forceinline__ void atomic_add(cplx<R>* p, cplx<R> v) {
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
npdm_gemm_kernel(const S* __restrict__ M, const S* __restrict__ V,
                 S* __restrict__ out, int n, int X, int m, int kchunk) {
  __shared__ S Ms[kBK][kBM + 1];   // M chunk, transposed: Ms[x][row]
  __shared__ S Vs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * kBN;
  const int r0 = blockIdx.y * kBM;
  const int xa = blockIdx.z * kchunk;
  const int xb = min(X, xa + kchunk);

  S acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = S(0);

  for (int x0 = xa; x0 < xb; x0 += kBK) {
    // M rows r0.., X columns x0..: consecutive threads read consecutive x
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int row = r0 + r, x = x0 + c;
      Ms[c][r] = (row < n && x < xb) ? M[(long long)row * X + x] : S(0);
    }
    // V rows x0.., columns c0..: consecutive threads read consecutive
    // columns
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int x = x0 + r, col = c0 + c;
      Vs[r][c] = (x < xb && col < m) ? V[(long long)x * m + col] : S(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      S a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ms[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Vs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col >= m) continue;
      S* o = out + (long long)row * m + col;
      if (split) atomic_add(o, acc[i][j]);
      else *o = acc[i][j];
    }
  }
}

template <typename S>
int npdm_gemm(const void* M, const void* V, void* out, int n, int X, int m,
              int ksplit, int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || m <= 0 || ksplit <= 0) return (int)cudaGetLastError();
  dim3 grid((m + kBN - 1) / kBN, (n + kBM - 1) / kBM, ksplit);
  npdm_gemm_kernel<S><<<grid, kThreads, 0, st>>>(
      static_cast<const S*>(M), static_cast<const S*>(V),
      static_cast<S*>(out), n, X, m, kchunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_npdm_gemm_f64(const void* M, const void* V, void* out, int n, int X,
                      int m, int ksplit, int kchunk, void* stream) {
  return npdm_gemm<double>(M, V, out, n, X, m, ksplit, kchunk, stream);
}

int b2t_npdm_gemm_c128(const void* M, const void* V, void* out, int n,
                       int X, int m, int ksplit, int kchunk, void* stream) {
  return npdm_gemm<cplx<double>>(M, V, out, n, X, m, ksplit, kchunk,
                                 stream);
}

}  // extern "C"
