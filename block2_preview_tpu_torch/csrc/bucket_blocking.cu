// K9 — bucketed environment blocking of the "torch_device" backend.
//
// Replaces block2_preview_tpu/ops/blocking_jax.py:87 _blk_exec.  For every
// contribution c of a BlockingPlan (ops/blocking_plan.py), with the env
// block E (l x k), the bra block MB and the ket block MK:
//
//   left:  out[c] (x x y) += coef_c . MB(l x x)^T . E . MK(k x y)
//   right: out[c] (x x y) += coef_c . MB(x x l)   . E . MK(y x k)^T
//
// in float or double.  The reference regroups the contributions into
// power-of-two shape classes with a floor of 8 and chunks of 1024, gathers
// padded stacks from the flat pools by indices it derives in-kernel from
// (offset, true dims) scalars, runs one einsum per class and scatter-adds
// the masked result into the flat output.  The classes and chunks exist to
// bound XLA's compiles (blocking_jax.py:43-84, 198-210); none is kept.
//
// Design.  One launch covers the whole plan.  Each contribution is 8 int32
// scalars `it` [n, 8]: eoff, boff, koff, dl, dx, dk, dy, ooff (pool and
// output offsets; true dims) and a coefficient `coef` [n].  `cum` [n + 1]
// prefix-sums the CUDA blocks of each contribution (chain_blocks(dx, dy));
// a block finds its contribution by binary search and runs chain.cuh's
// chain product straight from the pools with the operands' strides (MB
// transposed on the left, MK on the right: no copy), adding
// coef * MB.E.MK into the flat output with atomics (contributions share
// output blocks).  Atomic order varies between runs: results agree with
// the plain version to rounding, not bitwise.
//
// Bound on the card: the pools read once and the output written once
// against sum 2 (dl dk dy + dx dl dy) FLOPs; blocking plans fan out to
// many small contributions, so gathers and atomics, not the FMA pipes,
// set the pace here.  Tensor-core MMA and per-output-block reduction are
// left for a later PR.

#include "chain.cuh"

namespace {

using b2t::kThreads;

template <typename S>
__global__ void __launch_bounds__(kThreads)
bucket_blk_kernel(const S* __restrict__ ep, const S* __restrict__ bp,
                  const S* __restrict__ kp, const int* __restrict__ it,
                  const S* __restrict__ coef, const int* __restrict__ cum,
                  int n_items, int left, S* __restrict__ out) {
  const long long b = blockIdx.x;
  const int c = b2t::find_item(cum, n_items, b);
  const int* f = it + (long long)c * 8;
  const int dl = f[3], dx = f[4], dk = f[5], dy = f[6];
  const int blk = (int)(b - cum[c]);
  if (left)   // A(x, l) = MB[l, x]; C(k, y) = MK[k, y]
    b2t::chain_block<S>(bp + f[1], 1, dx, ep + f[0], dk, kp + f[2], dy, 1,
                        dx, dl, dk, dy, blk, coef[c], out + f[7], dy);
  else        // A(x, l) = MB[x, l]; C(k, y) = MK[y, k]
    b2t::chain_block<S>(bp + f[1], dl, 1, ep + f[0], dk, kp + f[2], 1, dk,
                        dx, dl, dk, dy, blk, coef[c], out + f[7], dy);
}

template <typename S>
int bucket_blk(const void* ep, const void* bp, const void* kp, const int* it,
               const void* coef, const int* cum, int n_items,
               long long n_blocks, int left, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0)
    bucket_blk_kernel<S><<<(unsigned)n_blocks, kThreads, 0, st>>>(
        static_cast<const S*>(ep), static_cast<const S*>(bp),
        static_cast<const S*>(kp), it, static_cast<const S*>(coef), cum,
        n_items, left, static_cast<S*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_bucket_blk_f64(const void* ep, const void* bp, const void* kp,
                       const int* it, const void* coef, const int* cum,
                       int n_items, long long n_blocks, int left, void* out,
                       void* stream) {
  return bucket_blk<double>(ep, bp, kp, it, coef, cum, n_items, n_blocks,
                            left, out, stream);
}

int b2t_bucket_blk_f32(const void* ep, const void* bp, const void* kp,
                       const int* it, const void* coef, const int* cum,
                       int n_items, long long n_blocks, int left, void* out,
                       void* stream) {
  return bucket_blk<float>(ep, bp, kp, it, coef, cum, n_items, n_blocks,
                           left, out, stream);
}

}  // extern "C"
