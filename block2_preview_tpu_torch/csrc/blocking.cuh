// The blocking kernel body shared by K5 (csrc/blocking.cu: every stage-1
// unit of the plan) and K21 (csrc/blocking_shard.cu: the units of one
// rank's task groups).  The design notes are K5's, in csrc/blocking.cu.
#pragma once

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

template <typename S, int T>
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
  // K5: block b is unit b; K21: unit units[b] of this rank's list
  const long long b =
      units ? (long long)units[blockIdx.x] : (long long)blockIdx.x;
  const int item = b2t::find_item(cumu, n_items, b);
  const int* f = it + (long long)item * 13;
  const int o = (int)(b - cumu[item]);
  const int dk = f[1], db = f[2], dy = f[4], dx = f[6];
  const int nk = f[8], nx = f[9], ny = f[10];
  const int li = o / ny, yi = o % ny;
  const int lrm = db - li * T;        // valid l rows of this strip
  const int ycm = dy - yi * T;        // valid y columns of this strip

  // ---- stage 1: tmp(l, y) = sum_ki E[li, ki] mk'[ki, yi] ---------------
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);

  const long long erow = (long long)f[0] + (long long)li * T * dk;
  for (int ki = 0; ki < nk; ++ki) {
    const int kcm = dk - ki * T;      // valid k of this tile
    const long long etile = erow + (long long)ki * T;
    // left: mk[k, y] at kbase + k*dy + y; right: mk[y, k] at kbase + y*dk + k
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
    for (int j = 0; j < R; ++j) Ts[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // ---- stages 2 + 3: for every xi, partial(x, y) = sum_l mb'(x, l) tmp(l, y)
  // (left: mb[l, x] at bbase + l*dx + x; right: mb[x, l] at bbase + x*db + l)
  const int e0 = efs[item], e1 = efs[item + 1];
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
          if (y < ody)
            atomicAdd(out + obase + (long long)x * ody + y, cf * acc[i][j]);
        }
      }
    }
  }
}

template <typename S, int T>
cudaError_t launch_blk(const S* epool, const S* bpool, const S* kpool,
                       const int* it, const int* cumu, int n_items,
                       const int* ef, const S* coef, const int* efs,
                       const int* units, long long n_blocks, int left,
                       S* out, cudaStream_t st) {
  const size_t smem =
      sizeof(S) * ((size_t)T * T + (size_t)T * (kChunk + 1) + kChunk * T);
  cudaError_t e = b2t::allow_smem(blk_kernel<S, T>, smem);
  if (e != cudaSuccess) return e;
  if (n_blocks > 0)
    blk_kernel<S, T><<<(unsigned)n_blocks, kThreads, smem, st>>>(
        epool, bpool, kpool, it, cumu, n_items, ef, coef, efs, left, units,
        out);
  return cudaGetLastError();
}

template <typename S>
cudaError_t block(const S* epool, const S* bpool, const S* kpool,
                  const int* it, const int* cumu, int n_items, const int* ef,
                  const S* coef, const int* efs, const int* units,
                  long long n_blocks, int T, int left, S* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 16: return launch_blk<S, 16>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_blocks, left, out, st);
    case 32: return launch_blk<S, 32>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_blocks, left, out, st);
    case 64: return launch_blk<S, 64>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_blocks, left, out, st);
    case 128: return launch_blk<S, 128>(epool, bpool, kpool, it, cumu,
                                  n_items, ef, coef, efs, units,
                                  n_blocks, left, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
