// K19 — the chip probes of utils/gpu_smoke.py.
//
// Replaces block2_preview_tpu/utils/tpu_smoke.py:33 dot (the f32
// precision probe's einsum) and :50 fill (the large-pool probe's one-launch
// pool write and sum).
//
// probe_dot: sum_i a[i] b[i] in float32 with float32 accumulation.  At the
// probe's 2048 values (16 KB) no bound of the card matters: the time is
// the launch and one pass of dependent steps, and at the call's rate the
// host's launch path (ops/_kernels.py) is what the card waits on.  So the
// design is one launch of one block of kDotThreads threads: each thread
// does a strided FMA over the input (two values a thread at 2048), a warp
// sums its partials with shuffles, one partial a warp goes through shared
// memory, and one warp sums those; the result is one plain store into the
// 0-d output, which the wrapper allocates without a fill.  The products
// run on the FMA pipes, never on the tensor cores, so no reduced-precision
// mode can touch them; the probe also runs the same product through the
// port's float32 matmul (torch.matmul), which TF32 would round.
//
// probe_fill: one launch writes a float32 pool of n elements, 2 x[i] at
// its head (i < nx) and zeros after, and adds the pool into out[0] (block
// partial sums, one atomic per block) — the footprint class of a large
// single-launch output (2^27 elements, 512 MiB).  Bound by the write of
// the pool.

#include "common.cuh"

namespace {

using b2t::kThreads;

constexpr int kDotThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// the block's sum in lane 0 of warp 0 (blockDim.x a multiple of 32, at
// most 1024); `part` holds one float a warp
__device__ __forceinline__ float block_sum(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = part[lane];
    v = warp_sum(v);
  }
  return v;
}

// float only: templated so that ptxas reports carry a readable name
template <typename S>
__global__ void __launch_bounds__(kDotThreads)
probe_dot_kernel(const S* __restrict__ a, const S* __restrict__ b, int n,
                 S* __restrict__ out) {
  __shared__ float part[kDotThreads / 32];
  float acc = 0.0f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kDotThreads)
    acc = fmaf(a[i], b[i], acc);
  const float s = block_sum(acc, part);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
probe_fill_kernel(const S* __restrict__ x, int nx, S* __restrict__ pool,
                  long long n, S* __restrict__ out) {
  __shared__ float part[kThreads / 32];
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float v = i < nx ? 2.0f * x[i] : 0.0f;
    pool[i] = v;
    acc += v;
  }
  const float s = block_sum(acc, part);
  if (threadIdx.x == 0) atomicAdd(out, s);
}

}  // namespace

extern "C" {

int b2t_probe_dot_f32(const void* a, const void* b, int n, void* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  probe_dot_kernel<float><<<1, kDotThreads, 0, st>>>(
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
