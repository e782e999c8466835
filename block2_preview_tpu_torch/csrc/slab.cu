// K10 — slab product of the stacked "bucket" blocking engine
// (backend "torch_stacked").
//
// Replaces block2_preview_tpu/ops/stacked.py:163 _slab_exec.  For every
// sector item c of a StackedPlan (an env group sector, an MPO site pair)
// and every symbol j of the group that a mix row reads (a "work" w):
//
//   left:  res[w] (dx x dy) = MB(dl x dx)^T . E_j(dl x dk) . MK(dk x dy)
//   right: res[w] (dx x dy) = MB(dx x dl)   . E_j(dl x dk) . MK(dy x dk)^T
//
// with E_j the j-th block of the item's slab (at eoff + j dl dk), in float
// or double.  The reference gathers [C, S, Lp, Kp] stacks padded to powers
// of two (at least 8) for each shape bucket of up to 256 items and every
// symbol of the group, and runs one einsum per bucket; the buckets and
// their 2^24-element chunks exist to bound XLA's compiles.
//
// Design.  The works of one item share MB, MK and every dim (at the K=16
// site a median of 21 works an item, dims a median of 10 and at most 30),
// and their res blocks are consecutive.  One CUDA block of the slab core
// (csrc/slab_core.cuh, shared with K5 and K21) takes a chunk of at most 8
// works of one item (ops/stacked.py slab_host_tables: `ch` [n, 9] =
// (first work, end, boff, koff, dl, dx, dk, dy, res offset of the first),
// heaviest first, `ce` [works] each work's env offset): MB and MK staged
// once, E per warp, a lane a column of the product, stored into res
// (added for the later runs of rows) — each output element by one lane,
// in a fixed order, so no atomics, bitwise repeatable, and the stores of
// a row coalesced.  Every res element of a work is written (res needs no
// zero fill).  Earlier designs: chain.cuh's product, a 256-thread block a
// 32-row strip of a work with four block barriers a 16-deep step and
// atomics into res; K9's warp chain (a warp a 32 x 32 piece of a work, MB
// and MK re-read for every work), only 5% faster in f64.
//
// Bound on the card: the env slabs, site pools and res written once
// against sum 2 (dl dk dy + dx dl dy) FLOPs per work.

#include "slab_core.cuh"

namespace {

using slab_core::kStage;
using slab_core::kWarps;

// K10's works: an env offset each (`ce`), products stored into res, the
// works of a run consecutive from the run's res offset
template <typename S>
struct SlabWork {
  const int* ce;
  S* R0;           // res + the run's res offset
  int w0, dxdy, dy;
  __device__ __forceinline__ int eoff(int w) const { return ce[w]; }
  __device__ __forceinline__ slab_core::RowOut<S> out(int w, int) const {
    return {R0 + (long long)(w - w0) * dxdy, dy};
  }
  __device__ __forceinline__ void done(int, int, int, int, int) const {}
};

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
slab_kernel(const S* __restrict__ ep, const S* __restrict__ bp,
            const S* __restrict__ kp, const int* __restrict__ ce,
            const int* __restrict__ ch, int left, S* __restrict__ res) {
  __shared__ S MBs[kStage];
  __shared__ S MKs[kStage];
  __shared__ S Es[kWarps][kStage];
  const int* q = ch + 9 * (long long)blockIdx.x;
  const SlabWork<S> wk{ce, res + q[8], q[0], q[5] * q[7], q[7]};
  slab_core::run_block<S>(ep, bp, kp, q, left, wk, MBs, MKs, Es);
}

template <typename S>
int slab(const void* ep, const void* bp, const void* kp, const int* ce,
         const int* ch, int n_chunks, int left, void* res, void* stream) {
  if (n_chunks > 0)
    slab_kernel<S><<<n_chunks, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const S*>(ep), static_cast<const S*>(bp),
        static_cast<const S*>(kp), ce, ch, left, static_cast<S*>(res));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_slab_f64(const void* ep, const void* bp, const void* kp,
                 const int* ce, const int* ch, int n_chunks, int left,
                 void* res, void* stream) {
  return slab<double>(ep, bp, kp, ce, ch, n_chunks, left, res, stream);
}

int b2t_slab_f32(const void* ep, const void* bp, const void* kp,
                 const int* ce, const int* ch, int n_chunks, int left,
                 void* res, void* stream) {
  return slab<float>(ep, bp, kp, ce, ch, n_chunks, left, res, stream);
}

}  // extern "C"
