// The output-stationary mix GEMM body shared by K3 (mix.cu) and K13
// (env_gemm.cu): OUT[w, d] = sum_j W[w, j] E[j, d] over the 64 x 64 OUT
// tiles `kt`, their list entries `kl` and the zero ranges `kz` of
// ops/mixv4.py k3_host_tables, one CUDA block a tile, each OUT element
// stored once.  The design notes are K3's, in mix.cu.
#pragma once

#include "chain_mv.cuh"

namespace {

constexpr int kMT = 64;                  // tile rows (W rows) and columns
constexpr int kKS = 16;                  // depth of a j slice (a mask bit)
constexpr int kLDW = kKS + 4;            // W slice row length in smem
constexpr int kLDE = kMT + 4;            // E slice row length in smem
constexpr int kMixThreads = 256;         // 8 warps: one an 8-row block
constexpr int kMixFrag = kMT / 8;        // 8 x 8 column fragments a warp
constexpr int kLDO = kMT + 1;            // OUT piece row length in smem

// acc[j] += W rows [r, r + 8) x depth [0, kc4) . E depth x columns
// [8j, 8j + 8), for j < nf.  Lane (g, t) holds D[g][2t], D[g][2t + 1].
// f64: one DMMA a fragment and depth 4, skipped where the warp's W
// fragment is all zero.
__device__ __forceinline__ void mix_slice(double (&acc)[kMixFrag][2], int r,
                                          int nf, const double* Ws,
                                          const double* Es, int kc4, int g,
                                          int t) {
#pragma unroll
  for (int kk = 0; kk < kKS; kk += 4) {
    if (kk >= kc4) break;
    const double a = Ws[(r + g) * kLDW + kk + t];
    if (!__any_sync(0xffffffffu, a != 0.0)) continue;
    const double* b = Es + (kk + t) * kLDE + g;
#pragma unroll
    for (int j = 0; j < kMixFrag; ++j) {
      if (j >= nf) break;
      dmma(acc[j][0], acc[j][1], a, b[8 * j]);
    }
  }
}

// f32: the same fragments on the FMA pipes; lane (g, t) forms its own
// D[g][2t], D[g][2t + 1] from W[g][kk:kk + 4] (one 16-byte load) and
// E[kk:kk + 4][2t:2t + 2] (four 8-byte loads).
__device__ __forceinline__ void mix_slice(float (&acc)[kMixFrag][2], int r,
                                          int nf, const float* Ws,
                                          const float* Es, int kc4, int g,
                                          int t) {
#pragma unroll
  for (int kk = 0; kk < kKS; kk += 4) {
    if (kk >= kc4) break;
    const float4 a =
        *reinterpret_cast<const float4*>(Ws + (r + g) * kLDW + kk);
    if (!__any_sync(0xffffffffu, a.x != 0.f || a.y != 0.f || a.z != 0.f ||
                                     a.w != 0.f))
      continue;
#pragma unroll
    for (int j = 0; j < kMixFrag; ++j) {
      if (j >= nf) break;
      const float* b = Es + kk * kLDE + 8 * j + 2 * t;
      const float2 b0 = *reinterpret_cast<const float2*>(b);
      const float2 b1 = *reinterpret_cast<const float2*>(b + kLDE);
      const float2 b2 = *reinterpret_cast<const float2*>(b + 2 * kLDE);
      const float2 b3 = *reinterpret_cast<const float2*>(b + 3 * kLDE);
      acc[j][0] = fmaf(a.x, b0.x, fmaf(a.y, b1.x, fmaf(a.z, b2.x,
                  fmaf(a.w, b3.x, acc[j][0]))));
      acc[j][1] = fmaf(a.x, b0.y, fmaf(a.y, b1.y, fmaf(a.z, b2.y,
                  fmaf(a.w, b3.y, acc[j][1]))));
    }
  }
}

__device__ __forceinline__ unsigned long long entry_mask(const int* ent) {
  return ((unsigned long long)(unsigned)ent[6] << 32) | (unsigned)ent[5];
}

// the next step (entry e, slice k) after the cursor (e, m: the entry's
// slices not yet issued); false past the last entry
__device__ __forceinline__ bool next_step(const int* kl, int cnt, int& e,
                                          unsigned long long& m, int& k) {
  while (m == 0) {
    if (++e >= cnt) return false;
    m = entry_mask(kl + 8 * (long long)e);
  }
  k = __ffsll((long long)m) - 1;
  m &= m - 1;
  return true;
}

template <typename S>
__global__ void __launch_bounds__(kMixThreads, 4)
mix_kernel(const S* __restrict__ epool, const S* __restrict__ wpool,
           const int* __restrict__ kt, const int* __restrict__ kl,
           const int* __restrict__ kz, const int* __restrict__ zlim,
           S* __restrict__ out) {
  // the ring (2 slots of a W and an E slice), then the tile's OUT piece
  __shared__ __align__(16) S smem[2 * (kMT * kLDW + kKS * kLDE)];
  S(*Ws)[kMT * kLDW] = reinterpret_cast<S(*)[kMT * kLDW]>(smem);
  S(*Es)[kKS * kLDE] =
      reinterpret_cast<S(*)[kKS * kLDE]>(smem + 2 * kMT * kLDW);
  static_assert(kMT * kLDO <= 2 * (kMT * kLDW + kKS * kLDE),
                "the OUT piece must fit in the ring");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4* tile = reinterpret_cast<const int4*>(kt) + 2 * blockIdx.x;
  const int4 t0 = tile[0];
  if (t0.x < 0) {   // zero tile (-1, gaps, first gap): a warp a gap,
                    // below the first element no reader reads
    const int lim = *zlim;
    for (int q = warp; q < t0.y; q += kMixThreads / 32) {
      const int* z = kz + 2 * (long long)(t0.z + q);
      S* o = out + z[0];
      const int n = min(z[1], lim - z[0]);
      for (int i = lane; i < n; i += 32) o[i] = S(0);
    }
    return;
  }
  const int4 t1 = tile[1];
  const int cnt = t0.y, nrow = t0.z, ncol = t0.w, ostride = t1.y, d0 = t1.z;
  const int* ents = kl + 8 * (long long)t0.x;
  const int nrow8 = (nrow + 7) & ~7, ncol8 = (ncol + 7) & ~7;
  const int nf = ncol8 >> 3;
  const int g = lane >> 2, t = lane & 3;
  const int r = 8 * warp;
  const bool rows = r < nrow8;

  // W rows [0, nrow) x slice k of entry e -> Ws[slot], E slice k x columns
  // [d0, d0 + ncol) -> Es[slot]; returns the slice's depth rounded to 4
  auto issue = [&](int e, int k, int slot) {
    const int* ent = ents + 8 * (long long)e;
    const long long wb = ent[0] + (long long)k * kKS;
    const long long eb = ent[2] + (long long)k * kKS * ent[3] + d0;
    const int wstr = ent[1], estr = ent[3];
    const int kd = min(kKS, ent[4] - k * kKS);
    S* wd = Ws[slot];
    for (int i = tid; i < nrow8 * kKS; i += kMixThreads) {
      const int rr = i / kKS, kk = i % kKS;
      const bool ok = rr < nrow && kk < kd;
      cp_elem(wd + rr * kLDW + kk,
              ok ? wpool + wb + (long long)rr * wstr + kk : wpool, ok);
    }
    S* ed = Es[slot];
    for (int i = tid; i < kKS * ncol8; i += kMixThreads) {
      const int kk = i / ncol8, c = i % ncol8;
      const bool ok = kk < kd && c < ncol;
      cp_elem(ed + kk * kLDE + c,
              ok ? epool + eb + (long long)kk * estr + c : epool, ok);
    }
    return (kd + 3) & ~3;
  };

  S acc[kMixFrag][2];
#pragma unroll
  for (int j = 0; j < kMixFrag; ++j) acc[j][0] = acc[j][1] = S(0);

  int pe = 0, k = 0, kc4 = 0;
  unsigned long long pm = entry_mask(ents);
  bool cur = next_step(ents, cnt, pe, pm, k);
  if (cur) kc4 = issue(pe, k, 0);
  cp_commit();
  for (int slot = 0; cur; slot ^= 1) {
    const bool nxt = next_step(ents, cnt, pe, pm, k);
    const int nc4 = nxt ? issue(pe, k, slot ^ 1) : 0;
    cp_commit();
    cp_wait<1>();      // this step's copies (this thread's) have landed
    __syncthreads();   // ... and everyone's
    if (rows) mix_slice(acc, r, nf, Ws[slot], Es[slot], kc4, g, t);
    __syncthreads();   // the slot is free for the step after next
    cur = nxt;
    kc4 = nc4;
  }

  // the piece through shared memory (the ring is free: the last step
  // ended on a barrier), then a warp a row, lanes along the columns
  if (rows) {
    S* os = smem + (r + g) * kLDO + 2 * t;
#pragma unroll
    for (int j = 0; j < kMixFrag; ++j) {
      if (j >= nf) break;
      os[8 * j] = acc[j][0];
      os[8 * j + 1] = acc[j][1];
    }
  }
  __syncthreads();
  for (int rr = warp; rr < nrow; rr += kMixThreads / 32) {
    S* o = out + t1.x + (long long)rr * ostride;
    for (int c = lane; c < ncol; c += 32) o[c] = smem[rr * kLDO + c];
  }
}

template <typename S>
cudaError_t mix(const S* epool, const S* wpool, const int* kt, const int* kl,
                const int* kz, const int* zlim, int n_tiles, S* out,
                void* stream) {
  if (n_tiles > 0)
    mix_kernel<S><<<(unsigned)n_tiles, kMixThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(epool, wpool, kt,
                                                         kl, kz, zlim, out);
  return cudaGetLastError();
}

}  // namespace
