// Shared helpers of the port's kernels (plain C interface, bound with
// ctypes from block2_preview_tpu_torch/ops/_kernels.py).
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launches (0 = success) so the Python wrapper can raise on a refused
// launch.  Pool offsets are computed in 64-bit: at quantum-chemistry
// scale a slab pool reaches 1e8-1e9 elements.
#pragma once

#include <cuda_runtime.h>

namespace b2t {

constexpr int kThreads = 256;   // 16 x 16 threads per block
constexpr int kChunk = 16;      // contraction depth staged per step

// Item owning task `b` in a nondecreasing prefix-sum table cum[0..n]
// (cum[0] = 0, cum[n] = total > b): the largest i < n with cum[i] <= b.
// Same as the reference's _locate, searchsorted(cum, b, "right") - 1
// (block2_preview_tpu/ops/tilev2.py:81): padded items own no tasks, so
// a repeated prefix value resolves to the last, non-empty item.
__device__ __forceinline__ int find_item(const int* __restrict__ cum, int n,
                                         long long b) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if ((long long)cum[mid] <= b) lo = mid; else hi = mid;
  }
  return lo;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace b2t
