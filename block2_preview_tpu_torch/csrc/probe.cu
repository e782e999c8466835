// K19 — the chip probes of utils/gpu_smoke.py.
//
// Replaces block2_preview_tpu/utils/tpu_smoke.py:33 dot (the f32
// precision probe's einsum) and :50 fill (the large-pool probe's one-launch
// pool write and sum).
//
// probe_dot: sum_i a[i] b[i] in float32 with float32 accumulation, one
// block of 256 threads (strided partial sums, then a tree in shared
// memory).  It runs on the FMA pipes, never on the tensor cores, so no
// reduced-precision mode can touch it; the probe also runs the same
// product through the port's float32 matmul (torch.matmul), which TF32
// would round.
//
// probe_fill: one launch writes a float32 pool of n elements, 2 x[i] at
// its head (i < nx) and zeros after, and adds the pool into out[0] (block
// partial sums, one atomic per block) — the footprint class of a large
// single-launch output (2^27 elements, 512 MiB).  Bound by the write of
// the pool.

#include "common.cuh"

namespace {

using b2t::kThreads;

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

// float only: templated so that ptxas reports carry a readable name
template <typename S>
__global__ void __launch_bounds__(kThreads)
probe_dot_kernel(const S* __restrict__ a, const S* __restrict__ b, int n,
                 S* __restrict__ out) {
  __shared__ float red[kThreads];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc = fmaf(a[i], b[i], acc);
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
probe_fill_kernel(const S* __restrict__ x, int nx, S* __restrict__ pool,
                  long long n, S* __restrict__ out) {
  __shared__ float red[kThreads];
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float v = i < nx ? 2.0f * x[i] : 0.0f;
    pool[i] = v;
    acc += v;
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) atomicAdd(out, s);
}

}  // namespace

extern "C" {

int b2t_probe_dot_f32(const void* a, const void* b, int n, void* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  probe_dot_kernel<float><<<1, kThreads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

int b2t_probe_fill_f32(const void* x, int nx, void* pool, long long n,
                       int n_blocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0)
    probe_fill_kernel<float><<<n_blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), nx, static_cast<float*>(pool), n,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
