// The slab core of K10 (csrc/slab.cu) and K5 / K21 (csrc/blocking.cuh):
// one CUDA block of kWarps warps runs a run of "works" that share one bra
// block MB and one ket block MK (and so every dim), each work
//
//   left:  r (dx x dy) = MB(dl x dx)^T . E(dl x dk) . MK(dk x dy)
//   right: r (dx x dy) = MB(dx x dl)   . E(dl x dk) . MK(dy x dk)^T
//
// with its own env block E (dl x dk, contiguous) and its own destination.
// A run is nine int32 (`q`): first work, end, bra offset, ket offset, dl,
// dx, dk, dy, and one the caller reads (K10: the res offset of the first
// work).  The caller's Work policy gives a work's env offset (`eoff`), its
// sink (`out`: put(x, y, r, first) stores or adds one element of r) and
// what follows its product (`done`, after a __syncwarp, K5's fan-out).
//
//  * the block stages MB and MK in shared memory once, in (l, x) and
//    (k, y) order whatever the side (the right side's transposes cost no
//    copy in memory), then each warp takes the run's works in turn and
//    stages its E with coalesced loads;
//  * lane y owns column y of the work's product (a pass per 32 columns):
//    for each run of at most kLMax rows of E it forms tmp(l) = sum_k E(l,
//    k) MK(k, y) in registers (E read as a shared-memory broadcast, MK
//    conflict-free), then for each row x r = sum_l MB(l, x) tmp(l) (MB a
//    broadcast), handed to the sink (first for the first run of rows) —
//    each element by one lane, in a fixed order, so no atomics;
//  * a run of rows is unrolled at 8 or 16 (the smallest that holds it).
// Operands too large for shared memory (more than kStage elements) are
// read from the pools through their strides instead.  Only true dims are
// multiplied, on the FMA pipes: the dims are far below an MMA fragment's
// worth of reuse.
#pragma once

#include "common.cuh"

namespace slab_core {

constexpr int kWarps = 4;       // warps a block
constexpr int kStage = 1024;    // shared elements of MB, MK and each E
constexpr int kLMax = 16;       // rows of E in registers at a time

// r(x, y) = sum_{l < tl} MB(l0 + l, x) tmp(l), tmp(l) = sum_k E(l0 + l,
// k) MK(k, y), for this lane's column y and every row x < dx, each handed
// to the sink.
template <typename S, int kL, class Out>
__device__ __forceinline__ void rows_run(const S* E, int dk, const S* MB,
                                         int mbl, int mbx, const S* MK,
                                         int mkk, int mky, int l0, int tl,
                                         int y, int dx, const Out& out,
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
    out.put(x, y, r, first);
  }
}

// One run `q` of works on this block; MBs, MKs [kStage] and Es [kWarps]
// [kStage] are the block's shared memory.
template <typename S, class Work>
__device__ __forceinline__ void run_block(const S* __restrict__ ep,
                                          const S* __restrict__ bp,
                                          const S* __restrict__ kp,
                                          const int* q, int left,
                                          const Work& wk, S* MBs, S* MKs,
                                          S (*Es)[kStage]) {
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
    const S* E = ep + wk.eoff(w);
    if (stage) {
      for (int e = lane; e < dl * dk; e += 32) Es[wp][e] = E[e];
      __syncwarp();
      E = Es[wp];
    }
    const auto out = wk.out(w, wp);
    for (int y = lane; y < ((dy + 31) & ~31); y += 32) {
      if (y < dy) {
        for (int l0 = 0; l0 < dl; l0 += kLMax) {
          const int tl = min(kLMax, dl - l0);
          if (tl <= 8)
            rows_run<S, 8>(E, dk, MB, mbl, mbx, MK, mkk, mky, l0, tl, y,
                           dx, out, l0 == 0);
          else
            rows_run<S, kLMax>(E, dk, MB, mbl, mbx, MK, mkk, mky, l0, tl,
                               y, dx, out, l0 == 0);
        }
      }
    }
    wk.done(w, wp, lane, dx, dy);
    if (stage) __syncwarp();   // E is read before the next work replaces it
  }
}

// The sink of a work whose product is stored into a row-major block of
// row stride ld at R (the first run of rows stores, later ones add).
template <typename S>
struct RowOut {
  S* R;
  int ld;
  __device__ __forceinline__ void put(int x, int y, S r, bool first) const {
    S* o = R + (long long)x * ld + y;
    *o = first ? r : *o + r;
  }
};

}  // namespace slab_core
