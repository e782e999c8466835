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
// and their res blocks are consecutive.  One CUDA block of kWarps warps
// takes a chunk of at most 8 works of one item (ops/stacked.py
// slab_host_tables: `ch` [n, 9] = (first work, end, boff, koff, dl, dx,
// dk, dy, res offset of the first), heaviest first, `ce` [works] each
// work's env offset):
//  * the block stages MB and MK in shared memory once, in (l, x) and
//    (k, y) order whatever the side (the right side's transposes cost no
//    copy in memory), then each warp takes the chunk's works in turn and
//    stages its E_j (contiguous) with coalesced loads;
//  * lane y owns column y of the work's block (a pass per 32 columns):
//    for each run of at most kLMax rows of E it forms tmp(l) = sum_k E(l,
//    k) MK(k, y) in registers (E read as a shared-memory broadcast, MK
//    conflict-free), then for each row x of the block r = sum_l MB(l, x)
//    tmp(l) (MB a broadcast), stored into res (added for the later runs of
//    rows) — each output element by one lane, in a fixed order, so no
//    atomics, bitwise repeatable, and the stores of a row coalesced;
//  * a run of rows is unrolled at 8 or 16 (the smallest that holds it),
//    so the small works of the K=16 site waste few predicated slots.
// Operands too large for shared memory (more than 32 x 32 elements) are
// read from the pools through their strides instead, so any dims run.
// Only true dims are multiplied, on the FMA pipes: the dims are far below
// an MMA fragment's worth of reuse.  Every res element of a work is
// written (res needs no zero fill).  Earlier designs: chain.cuh's
// product, a 256-thread block a 32-row strip of a work with four block
// barriers a 16-deep step and atomics into res (PRs 5-13); K9's warp
// chain (a warp a 32 x 32 piece of a work, MB and MK re-read for every
// work), only 5% faster in f64.
//
// Bound on the card: the env slabs, site pools and res written once
// against sum 2 (dl dk dy + dx dl dy) FLOPs per work.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;       // warps a block
constexpr int kStage = 1024;    // shared elements of MB, MK and each E
constexpr int kLMax = 16;       // rows of E in registers at a time

// res(x, y) (+)= sum_{l < tl} MB(l0 + l, x) tmp(l), tmp(l) = sum_k E(l0 +
// l, k) MK(k, y), for this lane's column y and every row x < dx.
template <typename S, int kL>
__device__ __forceinline__ void rows_run(const S* E, int dk, const S* MB,
                                         int mbl, int mbx, const S* MK,
                                         int mkk, int mky, int l0, int tl,
                                         int y, int dx, int dy, S* R,
                                         bool first) {
  S tmp[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) tmp[l] = S(0);
  for (int k = 0; k < dk; ++k) {
    const S m = MK[k * mkk + y * mky];
#pragma unroll
    for (int l = 0; l < kL; ++l)
      if (l < tl) tmp[l] += E[(l0 + l) * dk + k] * m;
  }
#pragma unroll 4
  for (int x = 0; x < dx; ++x) {
    S r = S(0);
#pragma unroll
    for (int l = 0; l < kL; ++l)
      if (l < tl) r += MB[(l0 + l) * mbl + x * mbx] * tmp[l];
    S* o = R + (long long)x * dy + y;
    *o = first ? r : *o + r;
  }
}

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
slab_kernel(const S* __restrict__ ep, const S* __restrict__ bp,
            const S* __restrict__ kp, const int* __restrict__ ce,
            const int* __restrict__ ch, int left, S* __restrict__ res) {
  __shared__ S MBs[kStage];
  __shared__ S MKs[kStage];
  __shared__ S Es[kWarps][kStage];
  const int* q = ch + 9 * (long long)blockIdx.x;
  const int w0 = q[0], w1 = q[1], dl = q[4], dx = q[5], dk = q[6],
            dy = q[7];
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const S* mb = bp + q[2];
  const S* mk = kp + q[3];
  // MB(l, x) = MB[l * mbl + x * mbx], MK(k, y) = MK[k * mkk + y * mky]
  const int pbl = left ? dx : 1, pbx = left ? 1 : dl;
  const int pkk = left ? dy : 1, pky = left ? 1 : dk;
  const S* MB = mb;
  int mbl = pbl, mbx = pbx;
  const S* MK = mk;
  int mkk = pkk, mky = pky;
  if (dl * dx <= kStage) {
    for (int e = tid; e < dl * dx; e += kWarps * 32) {
      const int l = e / dx, x = e - l * dx;
      MBs[e] = mb[l * pbl + x * pbx];
    }
    MB = MBs;
    mbl = dx;
    mbx = 1;
  }
  if (dk * dy <= kStage) {
    for (int e = tid; e < dk * dy; e += kWarps * 32) {
      const int k = e / dy, y = e - k * dy;
      MKs[e] = mk[k * pkk + y * pky];
    }
    MK = MKs;
    mkk = dy;
    mky = 1;
  }
  __syncthreads();
  const bool stage = dl * dk <= kStage;
  for (int w = w0 + wp; w < w1; w += kWarps) {
    const S* E = ep + ce[w];
    if (stage) {
      for (int e = lane; e < dl * dk; e += 32) Es[wp][e] = E[e];
      __syncwarp();
      E = Es[wp];
    }
    S* R = res + q[8] + (long long)(w - w0) * dx * dy;
    for (int y = lane; y < ((dy + 31) & ~31); y += 32) {
      if (y < dy) {
        for (int l0 = 0; l0 < dl; l0 += kLMax) {
          const int tl = min(kLMax, dl - l0);
          if (tl <= 8)
            rows_run<S, 8>(E, dk, MB, mbl, mbx, MK, mkk, mky, l0, tl, y,
                           dx, dy, R, l0 == 0);
          else
            rows_run<S, kLMax>(E, dk, MB, mbl, mbx, MK, mkk, mky, l0, tl,
                               y, dx, dy, R, l0 == 0);
        }
      }
    }
    if (stage) __syncwarp();   // E is read before the next work replaces it
  }
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
