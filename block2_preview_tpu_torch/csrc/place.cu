// K4 — window place of the LW/RW assembly (mix v4).
//
// Replaces block2_preview_tpu/ops/mixv4.py:67 _place4_exec_packed (and
// :101 _place4_exec, the same place on unpacked tables).  Every window
// copies one OUT block into the StackedMeta slab pool, and every other slab
// element (the sentinel, last, included) is 0:
//
//   slab[dst + r*rs + c*cs] = OUT[src + r*sst + c],  r < nb, c < nk
//
// Window fields `pit` [n, 8]: src, sst, dst, rs, cs, nb, nk, nkT (nkT, the
// reference's 16-column tile count, is not read).  `wend` [n] is the
// prefix maximum of the windows' last slab position + 1, `wbeg` [n] the
// suffix minimum of their first (ops/mixv4.py plan_tables, on the device;
// pad rows own no position).  The plan builder makes one window per
// (symbol, cell row, cell column) (ops/mixv3.py), so the windows are
// disjoint (the CPU tests check it) and each slab element has one value.
//
// Bound on the card: bytes.  The kernel writes the whole slab (its capacity
// class ncap_out + 1: 33.5M elements, 268 MB in f64, at the K=16 site) and
// reads each live element once; the tables are a few percent of that.  The
// output needs no zero fill (torch.empty).
//
// Design.  A block owns a chunk of kChunkBytes of the slab and assembles it
// in shared memory: zeros, then the values of every window that reaches
// into the chunk, then one coalesced 16-byte-wide write of the whole
// chunk, so every 32-byte sector is written once and whole.  Copying the
// windows into a slab the caller has zero-filled would write rows of 2-19
// elements at arbitrary offsets into sectors the fill wrote already; in
// probes on the H100 (PERF.md) that ran no faster than a plain index-list
// copy and slower than this design.  The windows
// that reach into the chunk [a, b) lie among rows i0..i1, i0 the first
// whose wend exceeds a and i1 the last whose wbeg is below b: two warps
// find them with a 32-way search each (4 rounds of loads for 2^19
// windows).  The builder emits the windows in slab order, so that range is
// tight; any order stays correct.  Then each thread loads one candidate,
// works out the rows that meet the chunk, and a block scan lays their
// elements out flat, so consecutive threads copy consecutive elements of a
// window row (cs == 1, sst == nk in every plan: contiguous OUT reads,
// consecutive shared-memory banks) however short the rows are; a thread
// finds its element's candidate by a binary search over the scanned
// offsets from its previous one and has kUnroll loads in flight.  Chunks
// past the last window's end only write zeros.  Offsets into OUT are
// unsigned 32-bit: the plan's fields are int32 and every address lies
// inside OUT.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kPlaceThreads = 256;
constexpr int kChunkBytes = 32768;   // a block's slab chunk in shared memory
constexpr int kUnroll = 8;           // elements a thread has in flight

// #{i < n : arr[i] <= x} for a nondecreasing arr, found by one warp in
// rounds of 32 probes.  Every lane returns it.
__device__ __forceinline__ int warp_count(const int* __restrict__ arr, int n,
                                          int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;                // arr[< lo] <= x < arr[>= hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const int m = __popc(__ballot_sync(0xffffffffu, p < hi && arr[p] <= x));
    if (m == 0) return lo;           // arr[lo] > x
    const int last = lo + (m - 1) * step;
    lo = last + 1;
    hi = min(hi, last + step);
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, p < hi && arr[p] <= x));
}

// Exclusive prefix sums of v over the block's threads into off[0..256],
// off[256] the total (blockDim.x == kPlaceThreads); wsum holds a warp's
// sum.  Every thread calls it.
__device__ __forceinline__ void block_scan(int v, int* off, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kPlaceThreads / 32 ? wsum[lane] : 0;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, s);
      if (lane >= s) t += y;
    }
    if (lane < kPlaceThreads / 32) wsum[lane] = t;   // inclusive
  }
  __syncthreads();
  const int before = warp > 0 ? wsum[warp - 1] : 0;
  off[threadIdx.x + 1] = before + x;
  if (threadIdx.x == 0) off[0] = 0;
}

template <typename S>
struct __align__(16) Vec16 {
  S v[16 / sizeof(S)];
};

template <typename S>
__global__ void __launch_bounds__(kPlaceThreads)
place_kernel(const S* __restrict__ outflat, const int* __restrict__ pit,
                const int* __restrict__ wend, const int* __restrict__ wbeg,
                int n_win, long long n_res, S* __restrict__ res) {
  constexpr int VW = 16 / sizeof(S);
  constexpr int kChunk = kChunkBytes / sizeof(S);
  __shared__ Vec16<S> buf16[kChunk / VW];
  __shared__ int s_off[kPlaceThreads + 1];
  __shared__ int s_src[kPlaceThreads], s_sst[kPlaceThreads],
      s_pos[kPlaceThreads], s_rs[kPlaceThreads], s_cs[kPlaceThreads],
      s_nk[kPlaceThreads];
  __shared__ int s_wsum[kPlaceThreads / 32];
  __shared__ int s_w[2];
  S* buf = reinterpret_cast<S*>(buf16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long a = (long long)blockIdx.x * kChunk;
  const int len = (int)min((long long)kChunk, n_res - a);
  Vec16<S> z;
#pragma unroll
  for (int u = 0; u < VW; ++u) z.v[u] = S(0);
  for (int v = tid; v < kChunk / VW; v += kPlaceThreads) buf16[v] = z;
  // uniform over the block: does any window reach this far?
  const bool live = n_win > 0 && a < wend[n_win - 1];
  if (live && warp < 2) {
    const int c = warp == 0 ? warp_count(wend, n_win, (int)a)
                            : warp_count(wbeg, n_win, (int)a + len - 1) - 1;
    if (lane == 0) s_w[warp] = c;
  }
  __syncthreads();
  if (live) {
    const int i0 = s_w[0], i1 = s_w[1];
    for (int base = i0; base <= i1; base += kPlaceThreads) {
      // one candidate a thread: its rows that meet the chunk
      const int w = base + tid;
      int cnt = 0;
      if (w <= i1) {
        const int* f = pit + (long long)w * 8;
        const int src = f[0], sst = f[1], dst = f[2], rs = f[3], cs = f[4],
                  nb = f[5], nk = f[6];
        if (nb > 0 && nk > 0) {
          int r0 = 0, r1 = nb - 1;
          if (rs > 0 && cs >= 0) {
            const long long lo = a - dst - (long long)(nk - 1) * cs;
            const long long hi = a + len - 1 - dst;
            if (lo > 0) r0 = (int)min((long long)nb, (lo + rs - 1) / rs);
            r1 = hi < 0 ? -1 : (int)min((long long)(nb - 1), hi / rs);
          }
          if (r1 >= r0) {
            cnt = (r1 - r0 + 1) * nk;
            // element j of the flattened rows: row r0 + j / nk, column
            // j % nk; pos/src of row r0 kept, relative to the chunk
            s_src[tid] = src + r0 * sst;
            s_sst[tid] = sst;
            s_pos[tid] = (int)(dst + (long long)r0 * rs - a);
            s_rs[tid] = rs;
            s_cs[tid] = cs;
            s_nk[tid] = nk;
          }
        }
      }
      block_scan(cnt, s_off, s_wsum);
      __syncthreads();
      const int total = s_off[kPlaceThreads];
      int k = 0;
      for (int e = tid; e < total; e += kUnroll * kPlaceThreads) {
        S v[kUnroll];
        int q[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int ee = e + u * kPlaceThreads;
          q[u] = -1;
          if (ee < total) {
            int h = kPlaceThreads;   // s_off[k] <= ee < s_off[h]; an empty
            while (h - k > 1) {      // candidate is never the last <= ee
              const int m = (k + h) >> 1;
              if (s_off[m] <= ee) k = m; else h = m;
            }
            const int j = ee - s_off[k], nk = s_nk[k];
            const int r = j / nk, c = j - r * nk;
            const int p = s_pos[k] + r * s_rs[k] + c * s_cs[k];
            if (p >= 0 && p < len) {
              q[u] = p;
              v[u] = outflat[(unsigned)s_src[k] +
                             (unsigned)(r * s_sst[k] + c)];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (q[u] >= 0) buf[q[u]] = v[u];
      }
      __syncthreads();
    }
  }
  __syncthreads();
  S* o = res + a;
  if (len == kChunk && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    for (int v = tid; v < kChunk / VW; v += kPlaceThreads)
      reinterpret_cast<Vec16<S>*>(o)[v] = buf16[v];
  } else {
    for (int e = tid; e < len; e += kPlaceThreads) o[e] = buf[e];
  }
}

template <typename S>
int place(const S* outflat, const int* pit, const int* wend,
             const int* wbeg, int n_win, long long n_res, S* res,
             void* stream) {
  constexpr int kChunk = kChunkBytes / sizeof(S);
  const long long blocks = (n_res + kChunk - 1) / kChunk;
  if (blocks > 0)
    place_kernel<S><<<(unsigned)blocks, kPlaceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        outflat, pit, wend, wbeg, n_win, n_res, res);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_place_f64(const double* outflat, const int* pit, const int* wend,
                  const int* wbeg, int n_win, long long n_res, double* res,
                  void* stream) {
  return place<double>(outflat, pit, wend, wbeg, n_win, n_res, res, stream);
}

int b2t_place_f32(const float* outflat, const int* pit, const int* wend,
                  const int* wbeg, int n_win, long long n_res, float* res,
                  void* stream) {
  return place<float>(outflat, pit, wend, wbeg, n_win, n_res, res, stream);
}

}  // extern "C"
