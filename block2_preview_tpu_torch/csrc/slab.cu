// K10 — slab product of the stacked "bucket" blocking engine
// (backend "torch_stacked").
//
// Replaces block2_preview_tpu/ops/stacked.py:163 _slab_exec.  For every
// sector item c of a StackedPlan (an env group sector, an MPO site pair)
// and every symbol j of the group that a mix row reads (a "work"):
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
// Design.  One launch covers the whole plan.  Items `it` [C, 7] int32:
// eoff, boff, koff, dl, dx, dk, dy; works `wk` [n, 3] int32: item, symbol,
// offset of its (dx x dy) result in the compact `res` pool (a prefix sum
// on the host).  Only the (c, j) pairs some mix row reads are formed, at
// true dims: nothing is padded in memory.  `cum` [n + 1] prefix-sums the
// CUDA blocks of each work (chain_blocks(dx, dy)); a block finds its work
// by binary search and runs chain.cuh's chain product straight from the
// pools with the operands' strides (MB transposed on the left, MK on the
// right: no copy).  `res` must be zero: chain.cuh adds with atomics (the
// blocks of one work write disjoint strips, so the sums are exact).
//
// Bound on the card: the env slabs, site pools and res written once
// against sum 2 (dl dk dy + dx dl dy) FLOPs per work.  Like K9, most works
// are small, so one 256-thread block per 32-row strip idles most of its
// threads; grouping small works and tensor-core MMA are later work, as is
// fusing K10 with K11 (stk_mix.cu) so that res never reaches memory.

#include "chain.cuh"

namespace {

using b2t::kThreads;

template <typename S>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const S* __restrict__ ep, const S* __restrict__ bp,
            const S* __restrict__ kp, const int* __restrict__ it,
            const int* __restrict__ wk, const int* __restrict__ cum,
            int n_works, int left, S* __restrict__ res) {
  const long long b = blockIdx.x;
  const int w = b2t::find_item(cum, n_works, b);
  const int* v = wk + (long long)w * 3;
  const int* f = it + (long long)v[0] * 7;
  const int dl = f[3], dx = f[4], dk = f[5], dy = f[6];
  const S* E = ep + (long long)f[0] + (long long)v[1] * dl * dk;
  const int blk = (int)(b - cum[w]);
  if (left)   // A(x, l) = MB[l, x]; C(k, y) = MK[k, y]
    b2t::chain_block<S>(bp + f[1], 1, dx, E, dk, kp + f[2], dy, 1, dx, dl,
                        dk, dy, blk, S(1), res + v[2], dy);
  else        // A(x, l) = MB[x, l]; C(k, y) = MK[y, k]
    b2t::chain_block<S>(bp + f[1], dl, 1, E, dk, kp + f[2], 1, dk, dx, dl,
                        dk, dy, blk, S(1), res + v[2], dy);
}

template <typename S>
int slab(const void* ep, const void* bp, const void* kp, const int* it,
         const int* wk, const int* cum, int n_works, long long n_blocks,
         int left, void* res, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0)
    slab_kernel<S><<<(unsigned)n_blocks, kThreads, 0, st>>>(
        static_cast<const S*>(ep), static_cast<const S*>(bp),
        static_cast<const S*>(kp), it, wk, cum, n_works, left,
        static_cast<S*>(res));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_slab_f64(const void* ep, const void* bp, const void* kp,
                 const int* it, const int* wk, const int* cum, int n_works,
                 long long n_blocks, int left, void* res, void* stream) {
  return slab<double>(ep, bp, kp, it, wk, cum, n_works, n_blocks, left, res,
                      stream);
}

int b2t_slab_f32(const void* ep, const void* bp, const void* kp,
                 const int* it, const int* wk, const int* cum, int n_works,
                 long long n_blocks, int left, void* res, void* stream) {
  return slab<float>(ep, bp, kp, it, wk, cum, n_works, n_blocks, left, res,
                     stream);
}

}  // extern "C"
