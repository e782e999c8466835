// K14 — disjoint placement gather of the mix v3 LW/RW assembly.
//
// Replaces block2_preview_tpu/ops/mixv3.py:143 _place and :109
// _place_chunk.  For slab elements i in [c0, c0 + n):
//
//   out[i - c0] = outflat[winsrc[wpos] + ri * windk[wpos] + ci]
//
// where a window covers i, else 0.  The superblock sb of i comes from a
// binary search over sb_starts (searchsorted "right" minus one); its
// block size and row length split the offset into (symbol jo, row rr,
// column cc); the row/column cell tables give the (cell, index within
// cell) pairs (cr, ri) and (cl, ci); wpos = celloff + jo * cells + cr *
// ncc + cl picks the window.  The table reads are clipped to the tables
// exactly as the reference clips them.
//
// Design.  A pure gather: one thread per slab element, no atomics.  Every
// element of the window is written, zeros included, so the output needs
// no zero fill; the sentinel slot (index ncap_out, past the last
// superblock) is not live and gets 0.
// Bound on the card: bytes — one read of OUT and one write per slab
// element, plus the table reads (small, cached).

#include "common.cuh"

namespace {

constexpr int kPlaceThreads = 256;

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename S>
__global__ void __launch_bounds__(kPlaceThreads)
place_v3_kernel(const S* __restrict__ outflat,
                const int* __restrict__ sb_starts,
                const int* __restrict__ sb_blksz, const int* __restrict__ sb_dlk,
                const int* __restrict__ sb_rowoff,
                const int* __restrict__ sb_coloff,
                const int* __restrict__ sb_celloff,
                const int* __restrict__ sb_ncc, const int* __restrict__ sb_cells,
                const int* __restrict__ rowcell, const int* __restrict__ rowin,
                const int* __restrict__ colcell, const int* __restrict__ colin,
                const int* __restrict__ winsrc, const int* __restrict__ windk,
                int nsb, int nrow, int ncol, int nwin, int c0, long long n,
                S* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kPlaceThreads + threadIdx.x;
  if (e >= n) return;
  const int i = c0 + (int)e;
  int lo = 0, hi = nsb;            // last sb with sb_starts[sb] <= i
  if (sb_starts[0] > i) {
    lo = 0;
  } else {
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (sb_starts[mid] <= i) lo = mid; else hi = mid;
    }
  }
  const int sb = lo;
  const int off = i - sb_starts[sb];
  const int bs = max(sb_blksz[sb], 1);
  const int jo = off / bs;
  const int rem = off - jo * bs;
  const int dlk = max(sb_dlk[sb], 1);
  const int rr = rem / dlk;
  const int cc = rem - rr * dlk;
  const bool live = i < sb_starts[min(sb + 1, nsb - 1)];
  const int rpos = clip(sb_rowoff[sb] + rr, 0, nrow - 1);
  const int cpos = clip(sb_coloff[sb] + cc, 0, ncol - 1);
  const int cr = rowcell[rpos], ri = rowin[rpos];
  const int cl = colcell[cpos], ci = colin[cpos];
  const int wpos = clip(sb_celloff[sb] + jo * sb_cells[sb] + cr * sb_ncc[sb] +
                            cl, 0, nwin - 1);
  const int ws = winsrc[wpos];
  S v = S(0);
  if (ws >= 0 && cr >= 0 && cl >= 0 && live)
    v = outflat[(long long)ws + (long long)ri * windk[wpos] + ci];
  out[e] = v;
}

template <typename S>
int place_v3(const void* outflat, const int* const* t, int nsb, int nrow,
             int ncol, int nwin, int c0, long long n, void* out,
             void* stream) {
  const long long nb = (n + kPlaceThreads - 1) / kPlaceThreads;
  if (nb > 0)
    place_v3_kernel<S><<<(unsigned)nb, kPlaceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const S*>(outflat), t[0], t[1], t[2], t[3], t[4], t[5],
        t[6], t[7], t[8], t[9], t[10], t[11], t[12], t[13], nsb, nrow, ncol,
        nwin, c0, n, static_cast<S*>(out));
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
    const int* t[14] = {sb_starts, sb_blksz, sb_dlk,   sb_rowoff, sb_coloff,  \
                        sb_celloff, sb_ncc,  sb_cells, rowcell,   rowin,      \
                        colcell,   colin,    winsrc,   windk};                \
    return place_v3<S>(outflat, t, nsb, nrow, ncol, nwin, c0, n, out,         \
                       stream);                                               \
  }

B2T_PLACE_V3_ENTRY(f32, float)
B2T_PLACE_V3_ENTRY(f64, double)
