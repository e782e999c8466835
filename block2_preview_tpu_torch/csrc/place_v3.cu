// K14 — disjoint placement gather of the mix v3 LW/RW assembly.
//
// Replaces block2_preview_tpu/ops/mixv3.py:143 _place and :109
// _place_chunk.  For slab elements i in [c0, c0 + n):
//
//   out[i - c0] = outflat[winsrc[wpos] + ri * windk[wpos] + ci]
//
// where a window covers i, else 0.  The superblock sb of i is the last one
// whose start is at or below i (searchsorted "right" minus one over
// sb_starts); its block size and row length split the offset into (symbol
// jo, row rr, column cc); the row/column cell tables give the (cell, index
// within cell) pairs (cr, ri) and (cl, ci); wpos = celloff + jo * cells +
// cr * ncc + cl picks the window.  The table reads are clipped to the
// tables exactly as the reference clips them.
//
// Bound on the card: bytes.  Every slab element is written once (the
// capacity class ncap_out + 1 the plan layout gives, 33.5M elements at the
// K=16 site, of which 20-22M are live) and each live one reads one OUT
// value; the tables are small and stay in cache.  At that site one side
// moves ~161 MB read + 268 MB written, ~0.128 ms at 3.35 TB/s.
//
// Design.  A block owns kPlaceTile consecutive slab elements.  A tile at
// or past the live end (sb_starts' last entry, the total) only stores
// zeros, 16 bytes a thread.  Otherwise one thread finds the tile's first
// and last superblock by binary search, once for the block, and the block
// stages those superblocks' rows (start, next start, sizes, offsets) in
// shared memory; each thread then walks its elements in increasing order,
// advancing its superblock by a scan over the staged starts, so an element
// costs two divisions, four cached cell-table reads, two window reads and
// one gather.  Threads take 16 bytes of consecutive elements each, so the
// OUT reads of a column run are coalesced and the stores are 16 bytes
// wide.  A tile spanning more than kPlaceSb superblocks (or starting below
// the first) takes the per-element search of the first design.  Every
// element is written, zeros included, so the output needs no zero fill;
// the sentinel slot (index ncap_out, past the live end) gets 0.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kPlaceThreads = 256;
constexpr int kPlaceTile = 4096;   // slab elements per block
constexpr int kPlaceSb = 64;       // superblocks a block stages

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Tables {
  const int* __restrict__ sb_starts;
  const int* __restrict__ sb_blksz;
  const int* __restrict__ sb_dlk;
  const int* __restrict__ sb_rowoff;
  const int* __restrict__ sb_coloff;
  const int* __restrict__ sb_celloff;
  const int* __restrict__ sb_ncc;
  const int* __restrict__ sb_cells;
  const int* __restrict__ rowcell;
  const int* __restrict__ rowin;
  const int* __restrict__ colcell;
  const int* __restrict__ colin;
  const int* __restrict__ winsrc;
  const int* __restrict__ windk;
  int nsb, nrow, ncol, nwin;
};

// one superblock's row, as the element walk reads it
struct __align__(16) SbRow {
  int start, next, bs, dlk;          // next = start of sb + 1 (clipped)
  int rowoff, coloff, celloff, ncc;
  int cells, pad0, pad1, pad2;
};

__device__ __forceinline__ SbRow sb_row(const Tables& T, int sb) {
  SbRow s;
  s.start = T.sb_starts[sb];
  s.next = T.sb_starts[min(sb + 1, T.nsb - 1)];
  s.bs = max(T.sb_blksz[sb], 1);
  s.dlk = max(T.sb_dlk[sb], 1);
  s.rowoff = T.sb_rowoff[sb];
  s.coloff = T.sb_coloff[sb];
  s.celloff = T.sb_celloff[sb];
  s.ncc = T.sb_ncc[sb];
  s.cells = T.sb_cells[sb];
  s.pad0 = s.pad1 = s.pad2 = 0;
  return s;
}

// last sb in [0, nsb) with sb_starts[sb] <= i (0 when none)
__device__ __forceinline__ int find_sb(const int* __restrict__ starts,
                                       int nsb, int i) {
  int lo = 0, hi = nsb;
  if (starts[0] > i) return 0;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (starts[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// element i of superblock row s; the offset i - start is negative only
// below the first superblock (clipped to sb 0), where the division floors
// as the reference's does
template <typename S>
__device__ __forceinline__ S place_elem(const S* __restrict__ outflat,
                                        const Tables& T, const SbRow& s,
                                        int i) {
  if (i >= s.next) return S(0);     // past the superblock: not live
  const int off = i - s.start;
  const int jo = off >= 0 ? (int)((unsigned)off / (unsigned)s.bs)
                          : -(int)((unsigned)(-off - 1) / (unsigned)s.bs) - 1;
  const unsigned rem = (unsigned)(off - jo * s.bs);
  const unsigned rr = rem / (unsigned)s.dlk;
  const unsigned cc = rem - rr * (unsigned)s.dlk;
  const int rpos = clip(s.rowoff + (int)rr, 0, T.nrow - 1);
  const int cpos = clip(s.coloff + (int)cc, 0, T.ncol - 1);
  const int cr = T.rowcell[rpos], cl = T.colcell[cpos];
  if (cr < 0 || cl < 0) return S(0);
  const int wpos =
      clip(s.celloff + jo * s.cells + cr * s.ncc + cl, 0, T.nwin - 1);
  const int ws = T.winsrc[wpos];
  if (ws < 0) return S(0);
  return outflat[(long long)ws + (long long)T.rowin[rpos] * T.windk[wpos] +
                 T.colin[cpos]];
}

template <typename S>
struct __align__(16) Vec16 {
  S v[16 / sizeof(S)];
};

template <typename S>
__global__ void __launch_bounds__(kPlaceThreads)
place_v3_kernel(const S* __restrict__ outflat, Tables T, int c0, long long n,
                S* __restrict__ out) {
  constexpr int VW = 16 / sizeof(S);     // elements of one 16-byte store
  __shared__ SbRow rows[kPlaceSb];
  __shared__ int s_lo, s_cnt;
  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * kPlaceTile;
  const int len = (int)min((long long)kPlaceTile, n - e0);
  const int i0 = c0 + (int)e0;
  const int live_end = T.sb_starts[T.nsb - 1];
  S* o = out + e0;
  const bool vec = (reinterpret_cast<uintptr_t>(o) & 15) == 0;

  if (i0 >= live_end) {              // the tail past the live total
    if (vec) {
      Vec16<S> z;
#pragma unroll
      for (int u = 0; u < VW; ++u) z.v[u] = S(0);
      for (int v = tid; (v + 1) * VW <= len; v += kPlaceThreads)
        reinterpret_cast<Vec16<S>*>(o)[v] = z;
      for (int e = len / VW * VW + tid; e < len; e += kPlaceThreads)
        o[e] = S(0);
    } else {
      for (int e = tid; e < len; e += kPlaceThreads) o[e] = S(0);
    }
    return;
  }
  if (tid == 0) {
    const int last = min(i0 + len, live_end) - 1;
    const int lo = find_sb(T.sb_starts, T.nsb, i0);
    const int hi = find_sb(T.sb_starts, T.nsb, last);
    s_lo = lo;
    s_cnt = i0 < T.sb_starts[0] ? kPlaceSb + 1 : hi - lo + 1;
  }
  __syncthreads();
  const int lo = s_lo, cnt = s_cnt;
  if (cnt > kPlaceSb) {              // too many superblocks: search each
    for (int e = tid; e < len; e += kPlaceThreads)
      o[e] = place_elem(outflat, T,
                        sb_row(T, find_sb(T.sb_starts, T.nsb, i0 + e)),
                        i0 + e);
    return;
  }
  for (int k = tid; k < cnt; k += kPlaceThreads) rows[k] = sb_row(T, lo + k);
  __syncthreads();

  int k = 0;                         // staged superblock of the element
  auto elem = [&](int e) -> S {
    const int i = i0 + e;
    if (i >= live_end) return S(0);
    while (k + 1 < cnt && rows[k + 1].start <= i) ++k;
    return place_elem(outflat, T, rows[k], i);
  };
  if (vec) {
    for (int v = tid; v * VW < len; v += kPlaceThreads) {
      Vec16<S> p;
#pragma unroll
      for (int u = 0; u < VW; ++u)
        p.v[u] = v * VW + u < len ? elem(v * VW + u) : S(0);
      if ((v + 1) * VW <= len) {
        reinterpret_cast<Vec16<S>*>(o)[v] = p;
      } else {
        for (int u = 0; v * VW + u < len; ++u) o[v * VW + u] = p.v[u];
      }
    }
  } else {
    for (int e = tid; e < len; e += kPlaceThreads) o[e] = elem(e);
  }
}

template <typename S>
int place_v3(const void* outflat, const Tables& T, int c0, long long n,
             void* out, void* stream) {
  const long long nb = (n + kPlaceTile - 1) / kPlaceTile;
  if (nb > 0)
    place_v3_kernel<S><<<(unsigned)nb, kPlaceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const S*>(outflat), T, c0, n, static_cast<S*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

#define B2T_PLACE_V3_ENTRY(SFX, S)                                            \
  extern "C" int b2t_place_v3_##SFX(                                          \
      const void* outflat, const int* sb_starts, const int* sb_blksz,         \
      const int* sb_dlk, const int* sb_rowoff, const int* sb_coloff,          \
      const int* sb_celloff, const int* sb_ncc, const int* sb_cells,          \
      const int* rowcell, const int* rowin, const int* colcell,               \
      const int* colin, const int* winsrc, const int* windk, int nsb,         \
      int nrow, int ncol, int nwin, int c0, long long n, void* out,           \
      void* stream) {                                                         \
    const Tables T{sb_starts, sb_blksz, sb_dlk,   sb_rowoff, sb_coloff,       \
                   sb_celloff, sb_ncc,  sb_cells, rowcell,   rowin,           \
                   colcell,   colin,    winsrc,   windk,     nsb,             \
                   nrow,      ncol,     nwin};                                \
    return place_v3<S>(outflat, T, c0, n, out, stream);                       \
  }

B2T_PLACE_V3_ENTRY(f32, float)
B2T_PLACE_V3_ENTRY(f64, double)
