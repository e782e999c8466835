// K16 — v1 resident sigma matvec over LW/RW slab pools (SlabMatvec).
//
// Replaces block2_preview_tpu/ops/resident.py:288 _slab_matvec_impl.  On
// T x T tiles, T in {16, 32, 64, 128}, with the struct's [G, 4, B] and
// [G, B] tables read as they are:
//
//   stage 1:  tmp[g, s1] += L(l4[g, :, b]) @ psi(pa[g, b])
//   stage 2:  sig[s2]    += tmp[g, ta] @ R(r4[g, :, b])^T
//
// L and R tiles are read from the slab pools at base + r*stride + c,
// zero outside (rmax, cmax) or where base < 0; psi tiles through psi_idx
// (padding points at the zero slot xp[size_p]).  Padded tasks carry
// s1 = nt1 (stage 1) and s2 = nt2 (stage 2) and are skipped.
//
// Design.  The reference scans the G task groups one after another with
// a tmp pool of nt1 tiles per group.  Here each stage is one launch over
// all groups: ONE tmp scratch pool holds every group's tiles at its
// offset toff[g] (the wrapper derives toff from s1).  s1 and s2 are
// sorted within a group, so a block owns a run of equal ids (it starts at
// the run's first task, the other blocks exit): stage-1 blocks sum their
// run in registers and write the tmp tile without atomics; stage-2 blocks
// sum their run and add it to the sigma tile with atomics (other groups
// hit the same tile).  A final gather flattens the sigma tiles through
// sig_idx.  Atomic order varies between runs: results agree with the
// plain version to rounding, not bitwise.
// Bound on the card: the FMA pipes (T^3 work per tile product against
// T^2 loads), as K1.  Tensor-core MMA and TMA staging are left for later.

#include "common.cuh"

namespace {

using b2t::kChunk;
using b2t::kThreads;

template <typename S, int T>
constexpr size_t slab_smem() {
  return sizeof(S) * ((size_t)T * T + (size_t)T * (kChunk + 1) +
                      (size_t)kChunk * T);
}

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
slab_stage1(const S* __restrict__ xp, const S* __restrict__ lpool,
            const int* __restrict__ psi_idx, const int* __restrict__ l4,
            const int* __restrict__ pa, const int* __restrict__ s1,
            const int* __restrict__ toff, int B, int nt1,
            S* __restrict__ tmp) {
  constexpr int R = T / 16;
  constexpr int KP = kChunk + 1;
  extern __shared__ unsigned char smem_raw[];
  S* As = reinterpret_cast<S*>(smem_raw) + T * T;   // L chunk [T][KP]
  S* Ps = As + T * KP;                              // psi chunk [kChunk][T]
  const long long gb = blockIdx.x;
  const int g = (int)(gb / B), b0 = (int)(gb % B);
  const int* s1g = s1 + (long long)g * B;
  const int seg = s1g[b0];
  if (seg >= nt1 || (b0 > 0 && s1g[b0 - 1] == seg)) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* l4g = l4 + (long long)g * 4 * B;

  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  for (int b = b0; b < B && s1g[b] == seg; ++b) {
    const int base = l4g[b], stride = l4g[B + b];
    const int rmax = l4g[2 * B + b], cmax = l4g[3 * B + b];
    const long long ptile = (long long)pa[(long long)g * B + b] * T * T;
    for (int kc = 0; kc < T && kc < cmax; kc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        S v = S(0);
        if (base >= 0 && r < rmax && kc + kk < cmax)
          v = lpool[(long long)base + (long long)r * stride + kc + kk];
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
  S* dst = tmp + ((long long)toff[g] + seg) * T * T;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) dst[(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
}

template <typename S, int T>
__global__ void __launch_bounds__(kThreads)
slab_stage2(const S* __restrict__ rpool, const int* __restrict__ ta,
            const int* __restrict__ r4, const int* __restrict__ s2,
            const int* __restrict__ toff, const S* __restrict__ tmp, int B,
            int nt2, S* __restrict__ sig) {
  constexpr int R = T / 16;
  constexpr int KP = kChunk + 1;
  extern __shared__ unsigned char smem_raw[];
  S* Ts = reinterpret_cast<S*>(smem_raw);   // tmp tile [T][T]
  S* As = Ts + T * T;                       // R chunk [T][KP]
  const long long gb = blockIdx.x;
  const int g = (int)(gb / B), b0 = (int)(gb % B);
  const int* s2g = s2 + (long long)g * B;
  const int seg = s2g[b0];
  if (seg >= nt2 || (b0 > 0 && s2g[b0 - 1] == seg)) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* r4g = r4 + (long long)g * 4 * B;

  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  for (int b = b0; b < B && s2g[b] == seg; ++b) {
    const int base = r4g[b], stride = r4g[B + b];
    const int rmax = r4g[2 * B + b], cmax = r4g[3 * B + b];
    const S* src =
        tmp + ((long long)toff[g] + ta[(long long)g * B + b]) * T * T;
    for (int e = tid; e < T * T; e += kThreads) Ts[e] = src[e];
    for (int nc = 0; nc < T && nc < cmax; nc += kChunk) {
      for (int e = tid; e < T * kChunk; e += kThreads) {
        const int p = e / kChunk, kk = e % kChunk;
        S v = S(0);
        if (base >= 0 && p < rmax && nc + kk < cmax)
          v = rpool[(long long)base + (long long)p * stride + nc + kk];
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
  }
  S* dst = sig + (long long)seg * T * T;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const S v = acc[i][j];
      if (v != S(0)) atomicAdd(dst + (ty + 16 * i) * T + tx + 16 * j, v);
    }
}

template <typename S, int T>
cudaError_t launch_slab(const S* xp, const S* lpool, const S* rpool,
                        const int* psi_idx, const int* l4, const int* pa,
                        const int* s1, const int* ta, const int* r4,
                        const int* s2, const int* toff, int G, int B,
                        int nt1, int nt2, S* tmp, S* sig, cudaStream_t st) {
  constexpr size_t smem = slab_smem<S, T>();
  cudaError_t e = b2t::allow_smem(slab_stage1<S, T>, smem);
  if (e == cudaSuccess) e = b2t::allow_smem(slab_stage2<S, T>, smem);
  if (e != cudaSuccess) return e;
  const long long nb = (long long)G * B;
  if (nb <= 0) return cudaSuccess;
  slab_stage1<S, T><<<(unsigned)nb, kThreads, smem, st>>>(
      xp, lpool, psi_idx, l4, pa, s1, toff, B, nt1, tmp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  slab_stage2<S, T><<<(unsigned)nb, kThreads, smem, st>>>(
      rpool, ta, r4, s2, toff, tmp, B, nt2, sig);
  return cudaGetLastError();
}

template <typename S>
int slab_mv(const void* xp, const void* lpool, const void* rpool,
            const int* psi_idx, const int* l4, const int* pa, const int* s1,
            const int* ta, const int* r4, const int* s2, const int* toff,
            int G, int B, int T, int nt1, int nt2, void* tmp, void* sig,
            void* stream) {
  const S* x = static_cast<const S*>(xp);
  const S* l = static_cast<const S*>(lpool);
  const S* r = static_cast<const S*>(rpool);
  S* tp = static_cast<S*>(tmp);
  S* sg = static_cast<S*>(sig);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 16: return (int)launch_slab<S, 16>(x, l, r, psi_idx, l4, pa, s1, ta,
                                            r4, s2, toff, G, B, nt1, nt2, tp,
                                            sg, st);
    case 32: return (int)launch_slab<S, 32>(x, l, r, psi_idx, l4, pa, s1, ta,
                                            r4, s2, toff, G, B, nt1, nt2, tp,
                                            sg, st);
    case 64: return (int)launch_slab<S, 64>(x, l, r, psi_idx, l4, pa, s1, ta,
                                            r4, s2, toff, G, B, nt1, nt2, tp,
                                            sg, st);
    case 128: return (int)launch_slab<S, 128>(x, l, r, psi_idx, l4, pa, s1,
                                              ta, r4, s2, toff, G, B, nt1,
                                              nt2, tp, sg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int b2t_slab_mv_f64(const void* xp, const void* lpool, const void* rpool,
                    const int* psi_idx, const int* l4, const int* pa,
                    const int* s1, const int* ta, const int* r4,
                    const int* s2, const int* toff, int G, int B, int T,
                    int nt1, int nt2, void* tmp, void* sig, void* stream) {
  return slab_mv<double>(xp, lpool, rpool, psi_idx, l4, pa, s1, ta, r4, s2,
                         toff, G, B, T, nt1, nt2, tmp, sig, stream);
}

int b2t_slab_mv_f32(const void* xp, const void* lpool, const void* rpool,
                    const int* psi_idx, const int* l4, const int* pa,
                    const int* s1, const int* ta, const int* r4,
                    const int* s2, const int* toff, int G, int B, int T,
                    int nt1, int nt2, void* tmp, void* sig, void* stream) {
  return slab_mv<float>(xp, lpool, rpool, psi_idx, l4, pa, s1, ta, r4, s2,
                        toff, G, B, T, nt1, nt2, tmp, sig, stream);
}

}  // extern "C"
