// The gather-by-output mix core of K11 (stk_mix.cu) and of K12's stage 3
// (tiled_blocking.cu).  For every output block b, a window of rows x cols
// elements at ob with row stride ostr, and its terms m (a source offset
// s_m and a coefficient coef_m):
//
//   out[ob + r ostr + c] += sum_m coef_m src[s_m + r sstr + c]
//
// for r < rows, c < cols.  Output blocks are disjoint, so every output
// element has one owner lane: it sums the block's terms in registers in a
// fixed order and adds the sum with one plain read-add-write.  No atomics:
// results are bitwise equal from launch to launch.
//
// Tables (built on the host by ops/stacked.py gather_tables, all int32 but
// the coefficients):
//   blk    [nb, 4]   (ob, ostr, rows, cols) of each output block
//   bstart [nb + 1]  block b's terms are [bstart[b], bstart[b + 1])
//   ts, tc [M]       s_m and coef_m, sorted by block (a stable sort, so a
//                    block's terms keep the plan's order)
//   units  [U, 2]    (block, first element): one warp each
//
// Work split.  Blocks are mostly tiny (a median of 3 elements at the K=16
// site) but carry many terms (a median of ~200 on the right side), while a
// few are wide.  A block of at most kSplitMax elements is one unit: its
// warp's lanes take (term group, element) pairs — EP = the elements
// rounded up to a power of two, 32 / EP groups, group g sums terms g,
// g + 32 / EP, ... — and a shuffle tree sums the groups.  A wider block is
// cut into units of kGatherChunk consecutive elements (row-major over the
// window), one lane an element, each looping over all the block's terms,
// four loads in flight.  ops/stacked.py mirrors both constants
// (GATHER_SPLIT, GATHER_CHUNK).
//
// Bound on the card: bytes.  Each term element reads one source element
// (mostly from L2: at the K=16 site a res element feeds ~37 terms) and each
// output element is read and written once; the terms' (s, coef) are read
// once a unit, as broadcasts.
#pragma once

#include "common.cuh"

namespace b2t {

constexpr int kGatherWarps = 8;      // warps (units) a CUDA block
constexpr int kSplitMax = 16;        // blocks this small: one split warp
constexpr int kGatherChunk = 32;     // elements a unit of a wider block

template <typename S>
__global__ void __launch_bounds__(kGatherWarps * 32)
mix_gather_kernel(const S* __restrict__ src, int sstr,
                  const int* __restrict__ units, int n_units,
                  const int* __restrict__ blk,
                  const int* __restrict__ bstart,
                  const int* __restrict__ ts, const S* __restrict__ tc,
                  S* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (u >= n_units) return;          // the whole warp leaves together
  const int b = units[2 * u], e0 = units[2 * u + 1];
  const long long ob = blk[4 * b];
  const int ostr = blk[4 * b + 1], rows = blk[4 * b + 2];
  const int cols = blk[4 * b + 3];
  const int n_el = rows * cols;
  const int m0 = bstart[b], m1 = bstart[b + 1];
  if (n_el <= kSplitMax) {
    int lg = 0;                      // EP = 1 << lg >= n_el
    while ((1 << lg) < n_el) ++lg;
    const int e = lane & ((1 << lg) - 1);
    const int step = 32 >> lg;       // term groups
    S acc = S(0);
    if (e < n_el) {
      const int r = e / cols, c = e - r * cols;
      const long long off = (long long)r * sstr + c;
#pragma unroll 4
      for (int m = m0 + (lane >> lg); m < m1; m += step)
        acc += tc[m] * src[ts[m] + off];
    }
    for (int d = 16; d >= (1 << lg); d >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if ((lane >> lg) == 0 && e < n_el) {
      const int r = e / cols, c = e - r * cols;
      S* o = out + ob + (long long)r * ostr + c;
      *o = *o + acc;
    }
    return;
  }
  const int e = e0 + lane;
  if (e >= n_el) return;
  const int r = e / cols, c = e - r * cols;
  const long long off = (long long)r * sstr + c;
  S acc = S(0);
  int m = m0;
  for (; m + 4 <= m1; m += 4) {
    const S v0 = src[ts[m] + off], v1 = src[ts[m + 1] + off];
    const S v2 = src[ts[m + 2] + off], v3 = src[ts[m + 3] + off];
    acc += tc[m] * v0;
    acc += tc[m + 1] * v1;
    acc += tc[m + 2] * v2;
    acc += tc[m + 3] * v3;
  }
  for (; m < m1; ++m) acc += tc[m] * src[ts[m] + off];
  S* o = out + ob + (long long)r * ostr + c;
  *o = *o + acc;
}

// One launch of the core over units [0, n_units) of the tables (the
// caller offsets `units` to a wave's first unit).
template <typename S>
inline cudaError_t mix_gather(const S* src, int sstr, const int* units,
                              int n_units, const int* blk, const int* bstart,
                              const int* ts, const S* tc, S* out,
                              cudaStream_t st) {
  if (n_units > 0) {
    const int grid = (n_units + kGatherWarps - 1) / kGatherWarps;
    mix_gather_kernel<S><<<grid, kGatherWarps * 32, 0, st>>>(
        src, sstr, units, n_units, blk, bstart, ts, tc, out);
  }
  return cudaGetLastError();
}

}  // namespace b2t
