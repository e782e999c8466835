// K17 — the pooled N-PDM engine's middle class close, out = M @ V.
//
// Replaces block2_preview_tpu/dmrg/npdm_scheme.py:376 _mm (the jit
// jnp.matmul at Precision.HIGHEST inside :357 _device_gemm): at every
// middle site of pooled_gram, each (need, n_cre) class closes its flat
// right-pool matrix M [n, X] (one row per right suffix, X the flattened
// bond sectors) against the batch V [X, m] of flattened (left x site)
// environments, in float64 or complex128.
//
// Bound on the card.  n is 1-200 rows while V is long and wide (X up to
// ~2e4, m up to ~9e3).  For n up to a few tens the least time is one read
// of V at the memory rate ([8 x 19332] @ [19332 x 1542] f64: 238 MB of V,
// 0.0716 ms); the tallest closes are bound by the f64 operations
// ([100 x 7704] @ [7704 x 3925]: 6.05 GFLOP, 0.0903 ms at the 67 TFLOP/s
// of the f64 tensor cores).  A design that read V once per row of M, or
// padded a skinny M to a tall tile, misses both bounds many times.
//
// Design: two regimes behind one C entry per type, picked from n (the
// wrapper, ops/npdm_gemm.py:plan, mirrors the choice, the tiles and the
// split).
//
// * Skinny (n <= kSkinnyRows = 16), bound by bytes.  A block of 128
//   threads owns a stripe of V in which every thread owns 16 bytes of each
//   row (2 f64 or 1 c128 columns); it streams its slice of X through a
//   ring of kSkStages stages in shared memory fed by cp.async 16-byte
//   copies (8-byte copies when m is odd or V is not 16-byte aligned), and
//   M's [NR x depth] chunk rides in the same stages, broadcast to every
//   thread.  Each thread keeps NR x (its columns) sums in registers, NR the
//   power of two at or above n, FMA on the CUDA cores (at n = 8 the f64
//   operations take ~14 us of the 72 us byte time).  On an H100 80GB HBM3
//   it reads V at ~2.6 TB/s, within a few percent of one torch.matmul
//   (chip_smoke.py phase 3).
// * Tall (n > 16), bound by operations.  The f64 tensor cores through
//   mma.sync m16n8k4 (one of sm_90's f64 MMA shapes; wgmma has no f64
//   form): warps of 32 x 32 (c128:
//   32 x 16) tiles, 4 along m and 1, 2 or (f64) 4 along n, so a block tile
//   is 32, 64 or 128 rows (n <= 32, <= 64, above) by 128 f64 (64 c128)
//   columns; A and B are staged by a cp.async ring, rows padded so the
//   fragment loads hit distinct banks.  c128 runs four real DMMAs a step
//   on the real and imaginary parts of the staged complex tiles (Cr += Ar
//   Br - Ai Bi, Ci += Ar Bi + Ai Br).  What limits it: at 128 registers a
//   thread (153 in c128) an SM holds two blocks of 8 warps, or one of 16
//   (the f64 128-row tile, and the c128 64-row one), and a block alone on
//   its SM waits out its own barriers, so it stages 32 rows of X in two
//   stages rather than 16 in three.  At [100 x 7704] @ [7704 x 3925] on an
//   H100 80GB HBM3 it does ~27 TFLOP/s of useful work, ~1.2x the time of
//   one torch.matmul (chip_smoke.py phase 3); its 128-row tile carries 28
//   padded rows.  Larger warp tiles (64 x 32, m16n8k8 with 16-byte
//   fragment loads) were slower: they need far more registers and leave
//   one block of 8 warps an SM.
// Both regimes split X over gridDim (y skinny, z tall) when the (n x m)
// tiles alone would leave SMs idle.  Slice s writes its partial to slice s
// of the buffer `out` [ksplit, n, m] the wrapper allocates; a second
// kernel of the same C entry then sums the slices in a fixed order into
// slice 0.  No atomics: two launches on the same inputs give the same
// bits.

#include <stdint.h>

#include "common.cuh"

namespace {

template <typename R>
struct __align__(2 * sizeof(R)) cplx {
  R x, y;
  cplx() = default;
  __device__ constexpr cplx(R a, R b = R(0)) : x(a), y(b) {}
  __device__ cplx& operator+=(cplx o) {
    x += o.x;
    y += o.y;
    return *this;
  }
};
using c128 = cplx<double>;

// acc += a * b
__device__ __forceinline__ void mac(double& acc, double a, double b) {
  acc = fma(a, b, acc);
}
__device__ __forceinline__ void mac(c128& acc, c128 a, c128 b) {
  acc.x = fma(a.x, b.x, fma(-a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(a.y, b.x, acc.y));
}

// ---- cp.async: `bytes` (0 = none) of one 16- or 8-byte copy, the rest
// of the destination zero-filled
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one element of S (8 or 16 bytes); src must be a valid address when !ok
template <typename S>
__device__ __forceinline__ void cp_elem(S* dst, const S* src, bool ok) {
  if constexpr (sizeof(S) == 16)
    cp16(dst, src, ok ? 16 : 0);
  else
    cp8(dst, src, ok ? 8 : 0);
}

// ---------------------------------------------------------------------------
// skinny regime: CUDA-core FMA on a cp.async stream of V
// ---------------------------------------------------------------------------

constexpr int kSkinnyRows = 16;  // largest n of the skinny regime
constexpr int kSkThreads = 128;
constexpr int kSkBK = 4;         // rows of V per stage
constexpr int kSkStages = 4;

template <typename S>
struct __align__(16) Pack16 {
  S v[16 / sizeof(S)];
};

template <typename S, int NR, bool VEC>
__global__ void __launch_bounds__(kSkThreads)
skinny_kernel(const S* __restrict__ M, const S* __restrict__ V,
              S* __restrict__ part, int n, int X, int m, int kchunk) {
  constexpr int CW = 16 / sizeof(S);      // columns a thread owns
  constexpr int BN = kSkThreads * CW;     // columns of the stripe
  __shared__ __align__(16) S Vs[kSkStages][kSkBK][BN];
  __shared__ __align__(16) S Ms[kSkStages][kSkBK][NR];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * BN + tid * CW;
  const int xa = blockIdx.y * kchunk;
  const int xb = min(X, xa + kchunk);
  const int nk = (xb - xa + kSkBK - 1) / kSkBK;

  auto load = [&](int kt) {
    const int slot = kt % kSkStages;
    const int x0 = xa + kt * kSkBK;
#pragma unroll
    for (int r = 0; r < kSkBK; ++r) {
      const int x = x0 + r;
      S* dst = &Vs[slot][r][tid * CW];
      const S* src = V + (long long)x * m + col;
      if constexpr (VEC) {
        const int ok = x < xb ? max(0, min(CW, m - col)) : 0;
        cp16(dst, ok ? src : V, ok * (int)sizeof(S));
      } else {
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const bool ok = x < xb && col + c < m;
          cp_elem(dst + c, ok ? src + c : V, ok);
        }
      }
    }
    // M [row, x0 + k] -> Ms[slot][k][row]; consecutive threads along X
    for (int e = tid; e < NR * kSkBK; e += kSkThreads) {
      const int row = e / kSkBK, k = e % kSkBK;
      const bool ok = row < n && x0 + k < xb;
      cp_elem(&Ms[slot][k][row], ok ? M + (long long)row * X + x0 + k : M,
              ok);
    }
  };

  S acc[NR][CW];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = S(0);

#pragma unroll
  for (int s = 0; s < kSkStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kSkStages - 2>();  // stage kt has landed (this thread's part)
    __syncthreads();           // ... everyone's, and slot kt - 1 is free
    if (kt + kSkStages - 1 < nk) load(kt + kSkStages - 1);
    cp_commit();
    const int slot = kt % kSkStages;
#pragma unroll
    for (int k = 0; k < kSkBK; ++k) {
      const Pack16<S> v =
          *reinterpret_cast<const Pack16<S>*>(&Vs[slot][k][tid * CW]);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const S a = Ms[slot][k][r];
#pragma unroll
        for (int c = 0; c < CW; ++c) mac(acc[r][c], a, v.v[c]);
      }
    }
  }

  S* o = part + (long long)blockIdx.y * n * m;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= n) break;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (col + c < m) o[(long long)r * m + col + c] = acc[r][c];
  }
}

// ---------------------------------------------------------------------------
// tall regime: DMMA m16n8k4 on a cp.async ring
// ---------------------------------------------------------------------------

// d += a (16 x 4, row) * b (4 x 8, col), f64 tensor cores.  Fragments of
// lane (g, t) = (lane / 4, lane % 4): a = {A[g][t], A[g + 8][t]}, b =
// B[t][g], d = {D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]}.
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// per type and WM (warps along M): n8 tiles per warp; the depth BK of X a
// stage holds and the stages ST of the ring (a block alone on its SM, the
// f64 128-row tile or the c128 64-row tile at 150+ registers a thread,
// stages 32 deep in two stages, halving its barriers; blocks that share
// an SM stage 16 deep in three); the padded row lengths of the staged
// tiles (A [BM][LDA] along X, B [BK][LDB] along m), chosen so that the
// fragment loads of a half warp (f64) or quarter warp (c128) fall on
// distinct banks
template <typename S, int WM>
struct TallCfg {
  static constexpr bool CPX = sizeof(S) == 16;
  static constexpr bool ALONE = WM == (CPX ? 2 : 4);
  static constexpr int WN = CPX ? 2 : 4;
  static constexpr int BK = ALONE ? 32 : 16, ST = ALONE ? 2 : 3;
  static constexpr int LDA = BK + 4, LDB = 4 * 8 * WN + (CPX ? 2 : 4);
  static constexpr size_t smem =
      sizeof(S) * ST * (size_t(32 * WM) * LDA + size_t(BK) * LDB);
};

// warp tile 32 rows x 8 WN columns; WM x 4 warps; BM = 32 WM
template <typename S, int WM, bool VEC>
__global__ void __launch_bounds__(128 * WM)
tall_kernel(const S* __restrict__ M, const S* __restrict__ V,
            S* __restrict__ part, int n, int X, int m, int kchunk) {
  using C = TallCfg<S, WM>;
  constexpr int T = 128 * WM;
  constexpr int BM = 32 * WM;
  constexpr int WN = C::WN, LDA = C::LDA, LDB = C::LDB;
  constexpr int BK = C::BK, ST = C::ST;
  constexpr int BN = 4 * 8 * WN;
  constexpr int EPU = 16 / sizeof(S);     // elements of one 16-byte copy
  constexpr bool CPX = C::CPX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* As = reinterpret_cast<S*>(smem_raw);             // [stage][BM][LDA]
  S* Bs = As + ST * BM * LDA;                         // [stage][BK][LDB]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int xa = blockIdx.z * kchunk;
  const int xb = min(X, xa + kchunk);
  const int nk = (xb - xa + BK - 1) / BK;

  auto load = [&](int kt) {
    const int slot = kt % ST;
    const int x0 = xa + kt * BK;
    S* A = As + slot * BM * LDA;
    S* B = Bs + slot * BK * LDB;
    if constexpr (VEC) {
      constexpr int UA = BK / EPU, UB = BN / EPU;   // copies per row
      for (int e = tid; e < BM * UA; e += T) {
        const int r = e / UA, k = (e % UA) * EPU;
        const int row = r0 + r, x = x0 + k;
        const int ok = row < n ? max(0, min(EPU, xb - x)) : 0;
        cp16(A + r * LDA + k, ok ? M + (long long)row * X + x : M,
             ok * (int)sizeof(S));
      }
      for (int e = tid; e < BK * UB; e += T) {
        const int k = e / UB, c = (e % UB) * EPU;
        const int x = x0 + k, col = c0 + c;
        const int ok = x < xb ? max(0, min(EPU, m - col)) : 0;
        cp16(B + k * LDB + c, ok ? V + (long long)x * m + col : V,
             ok * (int)sizeof(S));
      }
    } else {
      for (int e = tid; e < BM * BK; e += T) {
        const int r = e / BK, k = e % BK;
        const int row = r0 + r, x = x0 + k;
        const bool ok = row < n && x < xb;
        cp_elem(A + r * LDA + k, ok ? M + (long long)row * X + x : M, ok);
      }
      for (int e = tid; e < BK * BN; e += T) {
        const int k = e / BN, c = e % BN;
        const int x = x0 + k, col = c0 + c;
        const bool ok = x < xb && col < m;
        cp_elem(B + k * LDB + c, ok ? V + (long long)x * m + col : V, ok);
      }
    }
  };

  double acc[2][WN][4];            // f64 sums, or the real parts (c128)
  double acci[2][CPX ? WN : 1][4]; // imaginary parts (c128)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0.0;
        if constexpr (CPX) acci[i][j][q] = 0.0;
      }

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<ST - 2>();
    __syncthreads();
    if (kt + ST - 1 < nk) load(kt + ST - 1);
    cp_commit();
    const int slot = kt % ST;
    const S* A = As + slot * BM * LDA + (wm * 32 + g) * LDA + t;
    const S* B = Bs + slot * BK * LDB + t * LDB + wn * 8 * WN + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      S a[2][2], b[WN];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = A[(i * 16) * LDA + kk];
        a[i][1] = A[(i * 16 + 8) * LDA + kk];
      }
#pragma unroll
      for (int j = 0; j < WN; ++j) b[j] = B[kk * LDB + j * 8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          if constexpr (CPX) {
            dmma(acc[i][j], a[i][0].x, a[i][1].x, b[j].x);
            dmma(acc[i][j], -a[i][0].y, -a[i][1].y, b[j].y);
            dmma(acci[i][j], a[i][0].x, a[i][1].x, b[j].y);
            dmma(acci[i][j], a[i][0].y, a[i][1].y, b[j].x);
          } else {
            dmma(acc[i][j], a[i][0], a[i][1], b[j]);
          }
        }
    }
  }

  S* o = part + (long long)blockIdx.z * n * m;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r0 + wm * 32 + i * 16 + g + (q >= 2 ? 8 : 0);
        const int col = c0 + wn * 8 * WN + j * 8 + 2 * t + (q & 1);
        if (row >= n || col >= m) continue;
        if constexpr (CPX)
          o[(long long)row * m + col] = S(acc[i][j][q], acci[i][j][q]);
        else
          o[(long long)row * m + col] = acc[i][j][q];
      }
}

// ---------------------------------------------------------------------------
// second pass: part[0] = part[0] + part[1] + ... + part[ks - 1]
// ---------------------------------------------------------------------------

template <typename S>
__global__ void __launch_bounds__(b2t::kThreads)
reduce_kernel(S* __restrict__ part, long long nm, int ks) {
  for (long long i = (long long)blockIdx.x * b2t::kThreads + threadIdx.x;
       i < nm; i += (long long)gridDim.x * b2t::kThreads) {
    S s = part[i];
    for (int k = 1; k < ks; ++k) s += part[k * nm + i];
    part[i] = s;
  }
}

template <typename S, int NR, bool VEC>
cudaError_t launch_skinny(const S* M, const S* V, S* out, int n, int X,
                          int m, int ks, int kchunk, cudaStream_t st) {
  constexpr int BN = kSkThreads * (16 / sizeof(S));
  dim3 grid((m + BN - 1) / BN, ks);
  skinny_kernel<S, NR, VEC><<<grid, kSkThreads, 0, st>>>(M, V, out, n, X, m,
                                                         kchunk);
  return cudaGetLastError();
}

template <typename S, bool VEC>
cudaError_t skinny(const S* M, const S* V, S* out, int n, int X, int m,
                   int ks, int kchunk, cudaStream_t st) {
  if (n <= 1) return launch_skinny<S, 1, VEC>(M, V, out, n, X, m, ks, kchunk, st);
  if (n <= 2) return launch_skinny<S, 2, VEC>(M, V, out, n, X, m, ks, kchunk, st);
  if (n <= 4) return launch_skinny<S, 4, VEC>(M, V, out, n, X, m, ks, kchunk, st);
  if (n <= 8) return launch_skinny<S, 8, VEC>(M, V, out, n, X, m, ks, kchunk, st);
  return launch_skinny<S, 16, VEC>(M, V, out, n, X, m, ks, kchunk, st);
}

template <typename S, int WM, bool VEC>
cudaError_t launch_tall(const S* M, const S* V, S* out, int n, int X, int m,
                        int ks, int kchunk, cudaStream_t st) {
  constexpr int BM = 32 * WM, BN = 4 * 8 * TallCfg<S, WM>::WN;
  constexpr size_t smem = TallCfg<S, WM>::smem;
  cudaError_t err = b2t::allow_smem(tall_kernel<S, WM, VEC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN, ks);
  tall_kernel<S, WM, VEC><<<grid, 128 * WM, smem, st>>>(M, V, out, n, X, m,
                                                        kchunk);
  return cudaGetLastError();
}

// block tiles of 32, 64 or (f64) 128 rows
template <typename S, bool VEC>
cudaError_t tall(const S* M, const S* V, S* out, int n, int X, int m, int ks,
                 int kchunk, cudaStream_t st) {
  if (n <= 32)
    return launch_tall<S, 1, VEC>(M, V, out, n, X, m, ks, kchunk, st);
  if (sizeof(S) == 16 || n <= 64)
    return launch_tall<S, 2, VEC>(M, V, out, n, X, m, ks, kchunk, st);
  if constexpr (sizeof(S) == 8)
    return launch_tall<S, 4, VEC>(M, V, out, n, X, m, ks, kchunk, st);
  return cudaErrorInvalidValue;   // not reached
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// out is [ks, n, m]: the sum lands in its slice 0
template <typename S>
int npdm_gemm(const void* Mp, const void* Vp, void* outp, int n, int X,
              int m, int ks, int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || m <= 0 || X <= 0) return (int)cudaGetLastError();
  // the slices must cover X exactly, each a multiple of 16 deep
  if (ks <= 0 || kchunk <= 0 || kchunk % 16 != 0 ||
      (long long)(ks - 1) * kchunk >= X || (long long)ks * kchunk < X)
    return (int)cudaErrorInvalidValue;
  const S* M = static_cast<const S*>(Mp);
  const S* V = static_cast<const S*>(Vp);
  S* out = static_cast<S*>(outp);
  constexpr bool CPX = sizeof(S) == 16;
  // 16-byte copies: aligned rows of V (and of M in the tall regime)
  const bool vec_v = aligned16(V) && (CPX || m % 2 == 0);
  const bool vec_m = aligned16(M) && (CPX || X % 2 == 0);
  cudaError_t err;
  if (n <= kSkinnyRows)
    err = vec_v ? skinny<S, true>(M, V, out, n, X, m, ks, kchunk, st)
                : skinny<S, CPX>(M, V, out, n, X, m, ks, kchunk, st);
  else
    err = vec_v && vec_m ? tall<S, true>(M, V, out, n, X, m, ks, kchunk, st)
                         : tall<S, CPX>(M, V, out, n, X, m, ks, kchunk, st);
  if (err != cudaSuccess || ks == 1) return (int)err;
  const long long nm = (long long)n * m;
  const long long nb0 = (nm + b2t::kThreads - 1) / b2t::kThreads;
  const long long nb = nb0 < 4096 ? nb0 : 4096;
  reduce_kernel<S><<<(unsigned)nb, b2t::kThreads, 0, st>>>(out, nm, ks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_npdm_gemm_f64(const void* M, const void* V, void* out, int n, int X,
                      int m, int ksplit, int kchunk, void* stream) {
  return npdm_gemm<double>(M, V, out, n, X, m, ksplit, kchunk, stream);
}

int b2t_npdm_gemm_c128(const void* M, const void* V, void* out, int n,
                       int X, int m, int ksplit, int kchunk, void* stream) {
  return npdm_gemm<c128>(M, V, out, n, X, m, ksplit, kchunk, stream);
}

}  // extern "C"
