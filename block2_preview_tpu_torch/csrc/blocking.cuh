// The blocking kernels shared by K5 (csrc/blocking.cu: the whole plan)
// and K21 (csrc/blocking_shard.cu: the items of one rank's task groups).
// The design notes are K5's, in csrc/blocking.cu.  Two paths, launched one
// after the other by one call of block():
//  * blk_slab_kernel, the slab core (csrc/slab_core.cuh) over runs of
//    items that share one bra and one ket block, for items whose operands
//    fit its shared-memory staging;
//  * blk_kernel, a 256-thread block a T x T stage-1 unit, for the others
//    (on the v3 rotate plans a unit owns a column strip of its item's
//    block and sums the strips of l itself, so it stores, no atomics).
#pragma once

#include "common.cuh"
#include "slab_core.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

// ---- the slab path ------------------------------------------------------
// A work is an item: `wt` [n, 3] = (env offset, first entry, end entry),
// in run order; `ef` [ne, 4] (item, obase, odx, ody) and `coef` [ne] are
// the plan's entry rows.  Element (x, y) of an entry's block lies at obase
// + x ody + y, for x < odx and y < ody.

// excl: every item has one entry and no two entry blocks overlap (the v3
// rotate plans), so each element has one writer — the lane that owns its
// column — and is stored, with no atomics
template <typename S>
struct StoreOut {
  S* R;
  int ld, xm;
  S cf;
  __device__ __forceinline__ void put(int x, int y, S r, bool first) const {
    if (x < xm && y < ld) {
      S* o = R + (long long)x * ld + y;
      *o = first ? cf * r : *o + cf * r;
    }
  }
};

template <typename S>
struct StoreWork {
  const int* wt;
  const int* ef;
  const S* coef;
  S* dst;
  __device__ __forceinline__ int eoff(int w) const { return wt[3 * w]; }
  __device__ __forceinline__ StoreOut<S> out(int w, int) const {
    const int en = wt[3 * w + 1];
    const int* g = ef + 4 * (long long)en;
    return {dst + g[1], g[3], g[2], coef[en]};
  }
  __device__ __forceinline__ void done(int, int, int, int, int) const {}
};

// fan-out (the v2 plans): the product goes to the warp's shared block Rs
// once an item, then coef * r is added atomically into each entry's block
// (entries of different items share output blocks)
template <typename S>
struct FanWork {
  const int* wt;
  const int* ef;
  const S* coef;
  S* dst;
  S (*Rs)[slab_core::kStage];
  int dy;
  __device__ __forceinline__ int eoff(int w) const { return wt[3 * w]; }
  __device__ __forceinline__ slab_core::RowOut<S> out(int, int wp) const {
    return {Rs[wp], dy};
  }
  __device__ __forceinline__ void done(int w, int wp, int lane, int dx,
                                       int ddy) const {
    __syncwarp();
    const S* r = Rs[wp];
    for (int en = wt[3 * w + 1]; en < wt[3 * w + 2]; ++en) {
      const int* g = ef + 4 * (long long)en;
      S* o = dst + g[1];
      const int odx = g[2], ody = g[3];
      const S cf = coef[en];
      for (int e = lane; e < dx * ddy; e += 32) {
        const int x = e / ddy, y = e - x * ddy;
        if (x < odx && y < ody)
          atomicAdd(o + (long long)x * ody + y, cf * r[e]);
      }
    }
    __syncwarp();   // Rs is read before the next item replaces it
  }
};

// one run `rh` [9] = (first work, end, bbase, kbase, dl, dx, dk, dy, 0)
// a CUDA block; shared memory: MB, MK, E a warp (and Rs a warp, fan-out)
template <typename S, bool kExcl>
__global__ void __launch_bounds__(slab_core::kWarps * 32)
blk_slab_kernel(const S* __restrict__ ep, const S* __restrict__ bp,
                const S* __restrict__ kp, const int* __restrict__ wt,
                const int* __restrict__ rh, const int* __restrict__ ef,
                const S* __restrict__ coef, int left, S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* MBs = reinterpret_cast<S*>(smem_raw);
  S* MKs = MBs + slab_core::kStage;
  using Row = S[slab_core::kStage];
  Row* Es = reinterpret_cast<Row*>(MKs + slab_core::kStage);
  const int* q = rh + 9 * (long long)blockIdx.x;
  if constexpr (kExcl) {
    const StoreWork<S> wk{wt, ef, coef, out};
    slab_core::run_block<S>(ep, bp, kp, q, left, wk, MBs, MKs, Es);
  } else {
    const FanWork<S> wk{wt, ef, coef, out, Es + slab_core::kWarps,
                        q[7]};
    slab_core::run_block<S>(ep, bp, kp, q, left, wk, MBs, MKs, Es);
  }
}

template <typename S, bool kExcl>
cudaError_t launch_slab(const S* ep, const S* bp, const S* kp,
                        const int* wt, const int* rh, int n_runs,
                        const int* ef, const S* coef, int left, S* out,
                        cudaStream_t st) {
  const size_t smem = sizeof(S) * slab_core::kStage *
                      (2 + slab_core::kWarps * (kExcl ? 1 : 2));
  cudaError_t e = b2t::allow_smem(blk_slab_kernel<S, kExcl>, smem);
  if (e != cudaSuccess) return e;
  constexpr int threads = slab_core::kWarps * 32;
  blk_slab_kernel<S, kExcl><<<n_runs, threads, smem, st>>>(
      ep, bp, kp, wt, rh, ef, coef, left, out);
  return cudaGetLastError();
}

// ---- the tile path ------------------------------------------------------
// One block a stage-1 unit units[b] (item, li, yi) of the items that do
// not fit the slab path: tmp = E[li, :] mk[:, yi] in shared memory, then
// for every xi the partial product mb[li, xi]^T tmp, added atomically,
// times coef, at each entry of the item (the partial sums over li add up).
// kOwn (the exclusive v3 plans): the units are (item, 0, yi) only and the
// block runs li = 0, 1, ... itself, each element of the strip yi of the
// item's one entry block stored and then added by one thread in that
// order — no other block writes it, so no atomics and the same bits on
// every launch.
template <typename S, int T, bool kOwn>
__global__ void __launch_bounds__(kThreads)
blk_kernel(const S* __restrict__ epool, const S* __restrict__ bpool,
           const S* __restrict__ kpool, const int* __restrict__ it,
           const int* __restrict__ cumu, int n_items,
           const int* __restrict__ ef, const S* __restrict__ coef,
           const int* __restrict__ efs, int left,
           const int* __restrict__ units, S* __restrict__ out) {
  constexpr int R = T / 16;           // micro tile per thread: R x R
  constexpr int KP = kChunk + 1;      // padded row of the staged chunks
  extern __shared__ unsigned char smem_raw[];
  S* Ts = reinterpret_cast<S*>(smem_raw);   // tmp tile [T][T] (l, y)
  S* As = Ts + T * T;                       // E / mb chunk [T][KP]
  S* Ps = As + T * KP;                      // mk chunk [kChunk][T]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long b = units[blockIdx.x];
  const int item = b2t::find_item(cumu, n_items, b);
  const int* f = it + (long long)item * 13;
  const int o = (int)(b - cumu[item]);
  const int dk = f[1], db = f[2], dy = f[4], dx = f[6];
  const int nk = f[8], nx = f[9], ny = f[10];
  const int yi = o % ny;
  const int ycm = dy - yi * T;        // valid y columns of this strip
  const int l0 = o / ny, l1 = kOwn ? f[7] : l0 + 1;
  const int e0 = efs[item], e1 = efs[item + 1];
  S acc[R][R];
  for (int li = l0; li < l1; ++li) {
    const int lrm = db - li * T;      // valid l rows of this strip

    // ---- stage 1: tmp(l, y) = sum_ki E[li, ki] mk'[ki, yi] -------------
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = S(0);

    const long long erow = (long long)f[0] + (long long)li * T * dk;
    for (int ki = 0; ki < nk; ++ki) {
      const int kcm = dk - ki * T;      // valid k of this tile
      const long long etile = erow + (long long)ki * T;
      // left: mk[k, y] at kbase + k*dy + y; right: mk[y, k] at
      // kbase + y*dk + k
      const long long ktile = left
          ? (long long)f[3] + (long long)ki * T * dy + (long long)yi * T
          : (long long)f[3] + (long long)yi * T * dk + (long long)ki * T;
      for (int kc = 0; kc < T && kc < kcm; kc += kChunk) {
        for (int e = tid; e < T * kChunk; e += kThreads) {
          const int r = e / kChunk, kk = e % kChunk;
          S v = S(0);
          if (r < lrm && kc + kk < kcm)
            v = epool[etile + (long long)r * dk + kc + kk];
          As[r * KP + kk] = v;
        }
        if (left) {
          for (int e = tid; e < T * kChunk; e += kThreads) {
            const int kk = e / T, y = e % T;
            S v = S(0);
            if (kc + kk < kcm && y < ycm)
              v = kpool[ktile + (long long)(kc + kk) * dy + y];
            Ps[kk * T + y] = v;
          }
        } else {
          for (int e = tid; e < T * kChunk; e += kThreads) {
            const int y = e / kChunk, kk = e % kChunk;
            S v = S(0);
            if (kc + kk < kcm && y < ycm)
              v = kpool[ktile + (long long)y * dk + kc + kk];
            Ps[kk * T + y] = v;
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kChunk; ++kk) {
          S a[R], bv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) a[i] = As[(ty + 16 * i) * KP + kk];
#pragma unroll
          for (int j = 0; j < R; ++j) bv[j] = Ps[kk * T + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) acc[i][j] += a[i] * bv[j];
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        Ts[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
    __syncthreads();

    // ---- stages 2 + 3: for every xi, partial(x, y) = sum_l mb'(x, l)
    // tmp(l, y) (left: mb[l, x] at bbase + l*dx + x; right: mb[x, l] at
    // bbase + x*db + l)
    const int lmax = lrm < T ? lrm : T;
    for (int xi = 0; xi < nx; ++xi) {
      const int xcm = dx - xi * T;      // valid x rows of this tile
      const long long btile = left
          ? (long long)f[5] + (long long)li * T * dx + (long long)xi * T
          : (long long)f[5] + (long long)xi * T * db + (long long)li * T;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = S(0);
      for (int lc = 0; lc < lmax; lc += kChunk) {
        if (left) {
          for (int e = tid; e < T * kChunk; e += kThreads) {
            const int kk = e / T, x = e % T;
            S v = S(0);
            if (x < xcm && lc + kk < lmax)
              v = bpool[btile + (long long)(lc + kk) * dx + x];
            As[x * KP + kk] = v;
          }
        } else {
          for (int e = tid; e < T * kChunk; e += kThreads) {
            const int x = e / kChunk, kk = e % kChunk;
            S v = S(0);
            if (x < xcm && lc + kk < lmax)
              v = bpool[btile + (long long)x * db + lc + kk];
            As[x * KP + kk] = v;
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kChunk; ++kk) {
          S a[R], bv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) a[i] = As[(ty + 16 * i) * KP + kk];
#pragma unroll
          for (int j = 0; j < R; ++j) bv[j] = Ts[(lc + kk) * T + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) acc[i][j] += a[i] * bv[j];
        }
        __syncthreads();
      }
      for (int en = e0; en < e1; ++en) {
        const int* g = ef + (long long)en * 4;
        const long long obase = g[1];
        const int odx = g[2], ody = g[3];
        const S cf = coef[en];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int x = xi * T + ty + 16 * i;
          if (x >= odx) continue;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int y = yi * T + tx + 16 * j;
            if (y >= ody) continue;
            S* p = out + obase + (long long)x * ody + y;
            if constexpr (kOwn)
              *p = li == 0 ? cf * acc[i][j] : *p + cf * acc[i][j];
            else
              atomicAdd(p, cf * acc[i][j]);
          }
        }
      }
    }
  }
}

template <typename S, int T, bool kOwn>
cudaError_t launch_blk_as(const S* epool, const S* bpool, const S* kpool,
                          const int* it, const int* cumu, int n_items,
                          const int* ef, const S* coef, const int* efs,
                          const int* units, long long n_blocks, int left,
                          S* out, cudaStream_t st) {
  const size_t smem =
      sizeof(S) * ((size_t)T * T + (size_t)T * (kChunk + 1) + kChunk * T);
  cudaError_t e = b2t::allow_smem(blk_kernel<S, T, kOwn>, smem);
  if (e != cudaSuccess) return e;
  if (n_blocks > 0)
    blk_kernel<S, T, kOwn><<<(unsigned)n_blocks, kThreads, smem, st>>>(
        epool, bpool, kpool, it, cumu, n_items, ef, coef, efs, left, units,
        out);
  return cudaGetLastError();
}

template <typename S, int T>
cudaError_t launch_blk(const S* epool, const S* bpool, const S* kpool,
                       const int* it, const int* cumu, int n_items,
                       const int* ef, const S* coef, const int* efs,
                       const int* units, long long n_blocks, int left,
                       int excl, S* out, cudaStream_t st) {
  return excl ? launch_blk_as<S, T, true>(epool, bpool, kpool, it, cumu,
                                          n_items, ef, coef, efs, units,
                                          n_blocks, left, out, st)
              : launch_blk_as<S, T, false>(epool, bpool, kpool, it, cumu,
                                           n_items, ef, coef, efs, units,
                                           n_blocks, left, out, st);
}

template <typename S>
cudaError_t block(const S* epool, const S* bpool, const S* kpool,
                  const int* it, const int* cumu, int n_items, const int* ef,
                  const S* coef, const int* efs, const int* wt,
                  const int* rh, int n_runs, const int* units,
                  long long n_units, int T, int left, int excl, S* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (n_runs > 0)
    e = excl ? launch_slab<S, true>(epool, bpool, kpool, wt, rh, n_runs, ef,
                                    coef, left, out, st)
             : launch_slab<S, false>(epool, bpool, kpool, wt, rh, n_runs,
                                     ef, coef, left, out, st);
  if (e != cudaSuccess || n_units == 0) return e;
  switch (T) {
    case 16: return launch_blk<S, 16>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_units, left, excl, out, st);
    case 32: return launch_blk<S, 32>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_units, left, excl, out, st);
    case 64: return launch_blk<S, 64>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_units, left, excl, out, st);
    case 128: return launch_blk<S, 128>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_units, left, excl, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
