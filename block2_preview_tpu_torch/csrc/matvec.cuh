// The sigma-matvec kernel body shared by K1 (csrc/matvec.cu: every
// stage-1 unit of the plan) and K20 (csrc/matvec_shard.cu: the units of one
// rank's task groups).  The design notes are K1's, in csrc/matvec.cu.
#pragma once

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
mv_kernel(const S* __restrict__ xp, const S* __restrict__ lpool,
          const S* __restrict__ rpool, const int* __restrict__ psi_idx,
          const int* __restrict__ it, const int* __restrict__ cumt,
          int n_items, const int* __restrict__ units,
          S* __restrict__ sig) {
  constexpr int R = T / 16;           // micro tile per thread: R x R
  constexpr int KP = kChunk + 1;      // padded row of the staged chunks
  extern __shared__ unsigned char smem_raw[];
  S* Ts = reinterpret_cast<S*>(smem_raw);   // tmp tile [T][T]
  S* As = Ts + T * T;                       // L / R chunk [T][KP]
  S* Ps = As + T * KP;                      // psi chunk [kChunk][T]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // K1: block b is unit b; K20: unit units[b] of this rank's list
  const long long b =
      units ? (long long)units[blockIdx.x] : (long long)blockIdx.x;
  const int item = b2t::find_item(cumt, n_items, b);
  const int* f = it + (long long)item * 13;
  const int o = (int)(b - cumt[item]);
  const int DLk = f[1], DLb = f[2], DRk = f[4], DRb = f[5];
  const int pb = f[6], ob = f[7], nk = f[9], np_ = f[10], nn = f[11];
  const int ai = o / nn, ni = o % nn;
  const int lrm = DLb - ai * T;       // valid rows of this L row strip

  // ---- stage 1: tmp = sum_ki L[ai, ki] @ psi[ki, ni] ------------------
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);

  const long long lrow = (long long)f[0] + (long long)ai * T * DLk;
  for (int ki = 0; ki < nk; ++ki) {
    const int lcm = DLk - ki * T;     // valid columns of this L tile
    const long long ltile = lrow + (long long)ki * T;
    const long long ptile = (long long)(pb + ki * nn + ni) * T * T;
    for (int kc = 0; kc < T && kc < lcm; kc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        S v = S(0);
        if (r < lrm && kc + kk < lcm)
          v = lpool[ltile + (long long)r * DLk + kc + kk];
        As[r * KP + kk] = v;
      }
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int kk = e / T, c = e % T;
        Ps[kk * T + c] = xp[psi_idx[ptile + (long long)(kc + kk) * T + c]];
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

  // ---- stage 2: sigma[ob + ai*np + pi] += tmp @ R[pi, ni]^T ------------
  const int pcm = DRk - ni * T;       // valid n columns of the R tiles
  for (int pi = 0; pi < np_; ++pi) {
    const int prm = DRb - pi * T;     // valid p rows of this R tile
    const long long rtile =
        (long long)f[3] + (long long)pi * T * DRk + (long long)ni * T;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = S(0);
    for (int nc = 0; nc < T && nc < pcm; nc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int p = e / kChunk, kk = e % kChunk;
        S v = S(0);
        if (p < prm && nc + kk < pcm)
          v = rpool[rtile + (long long)p * DRk + nc + kk];
        As[p * KP + kk] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        S a[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = Ts[(ty + 16 * i) * T + nc + kk];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = As[(tx + 16 * j) * KP + kk];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
    S* dst = sig + (long long)(ob + ai * np_ + pi) * T * T;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      if (r >= lrm) continue;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int p = tx + 16 * j;
        if (p < prm) atomicAdd(dst + r * T + p, acc[i][j]);
      }
    }
  }
}

template <typename S, int T>
cudaError_t launch_mv(const S* xp, const S* lpool, const S* rpool,
                      const int* psi_idx, const int* it, const int* cumt,
                      int n_items, const int* units, long long n_blocks,
                      S* sig, cudaStream_t st) {
  const size_t smem =
      sizeof(S) * ((size_t)T * T + (size_t)T * (kChunk + 1) + kChunk * T);
  cudaError_t e = b2t::allow_smem(mv_kernel<S, T>, smem);
  if (e != cudaSuccess) return e;
  if (n_blocks > 0)
    mv_kernel<S, T><<<(unsigned)n_blocks, kThreads, smem, st>>>(
        xp, lpool, rpool, psi_idx, it, cumt, n_items, units, sig);
  return cudaGetLastError();
}

template <typename S>
cudaError_t matvec(const S* xp, const S* lpool, const S* rpool,
                   const int* psi_idx, const int* it, const int* cumt,
                   int n_items, const int* units, long long n_blocks,
                   int T, S* sig, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 16: return launch_mv<S, 16>(xp, lpool, rpool, psi_idx, it, cumt,
                                     n_items, units, n_blocks, sig, st);
    case 32: return launch_mv<S, 32>(xp, lpool, rpool, psi_idx, it, cumt,
                                     n_items, units, n_blocks, sig, st);
    case 64: return launch_mv<S, 64>(xp, lpool, rpool, psi_idx, it, cumt,
                                     n_items, units, n_blocks, sig, st);
    case 128: return launch_mv<S, 128>(xp, lpool, rpool, psi_idx, it, cumt,
                                       n_items, units, n_blocks, sig, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
