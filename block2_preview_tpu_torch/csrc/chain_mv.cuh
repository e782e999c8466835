// The chain-matvec core of K1 (matvec.cu), K20 (matvec_shard.cu), K16
// (slab_matvec.cu), K8 (bucket.cu), K7 (tiled.cu), K18 (plan_exec.cu) and
// K22 (plan_exec_shard.cu): for every item of a plan,
//
//   sigma[ooff] (a x p) += L[loff] (a x k) . psi[poff] (k x n) . R[roff]^T
//
// with L, psi, R (p x n) and sigma row-major in flat pools at the item's
// offsets.  An item is eight int32 fields: loff, a, k, poff, n, roff, p,
// ooff.  The strided instance (LD, K18's and K22's) reads ten: two more
// give the row strides of L and R in their pools (K18 reads its items'
// blocks in place from zero-padded stacks, rows k_pad and n_pad long); the
// instances of K1, K20, K16, K8 and K7 keep eight fields and their code.
// The host (ops/chain_mv.py) cuts the items into entries (item, ar, pi,
// ni) — output rows [64 ar, +64), output columns [64 pi, +64), psi
// columns [64 ni, +64) — and groups the entries that write one output
// piece (ooff, ar, pi) into FLOP-bounded chunks: `ent` [n_ent, 2] = (item,
// ni), `ck` [n_chunks, 4] = (first entry, end entry, ar, pi).
//
// Design.  One CUDA block of 8 warps runs one chunk; warp w owns rows [8w,
// 8w + 8) of the piece, all of its 8 x 8 column fragments.  The chunk's
// entries are staged in shared memory, then the block walks a sequence of
// steps, each a kKC-deep slice of one product: stage 1 of an entry, tmp
// (lr x nc) = L[rows, :] psi[:, cols] over k, then stage 2, acc (lr x pc)
// += tmp R[cols, :]^T over nc.  Each step's operands (an L and a psi
// slice, or an R slice) are copied by cp.async into a kST-slot ring in
// shared memory, kST - 1 steps ahead of the step being multiplied,
// zero-filled outside the true shapes.  tmp goes through shared memory
// (Ts) between the stages; acc stays in registers for the whole chunk and
// is added into sigma once, one atomic an element.  So:
//  * only true shapes are multiplied: fragments cover the live rows and
//    columns rounded up to 8, the depth rounded up to 4, and a warp whose
//    rows lie past the piece skips the products;
//  * f64 runs on the tensor cores, mma.sync.aligned.m8n8k4 (DMMA) from
//    each lane's registers; f32 runs the same fragments on the FMA pipes
//    (the port keeps true f32: no TF32);
//  * complex128 (K7 only) runs four real DMMAs a fragment and depth 4
//    (re.re, -im.im, re.im, im.re; the plain product, no conjugation, as
//    the reference's einsums), complex64 the same fragments on the FMA
//    pipes; the complex atomic into sigma is two real atomics (sm_90 has
//    no 128-bit float atomic).  Complex elements stay interleaved in shared
//    memory (one 16-byte cp.async and one 16-byte load a c128 element);
//    the psi slice's row is kT + 2 long there and tmp's kT + 4, so a
//    quarter warp's 16-byte fragment loads fall on distinct banks.  A c128
//    block takes 211 KB of shared memory (one block an SM), a c64 block
//    106 KB (two, as f64);
//  * entries that write one output piece sum in registers: one atomic an
//    output element a chunk, where K1's earlier design made one a unit
//    (atomic order varies between runs, so results agree with the plain
//    versions to rounding, not bitwise; one atomic a chunk was chosen over
//    a fixed-order two-pass sum because plain stores in their place timed
//    the same, chip_smoke.py's K=16 site);
//  * psi and sigma are read and written in their flat layouts: no tile
//    pool is zeroed or gathered.
// The tile is 64 whatever the plan's tile (a layout the kernel does not
// read).  Timed slower on an H100 at the K=16 QC site (PERF.md §6):
// 32- and 128-wide pieces, 16- or 32-row pieces, a three-stage ring,
// 16-deep steps, tmp kept in registers (moved to the A operand by warp
// shuffles, a small entry's two stages in one step), pieces of at most 8
// rows run a warp each with operands read straight into registers, and
// 128-wide pieces on 16-warp blocks for wide items (which halve stage 1's
// repeats but leave one block an SM).
// Bound on the card: at true shapes a matvec reads the LW/RW blocks its
// items use and does sum 2akn + 2anp FLOPs; at the K=16 QC site of
// chip_smoke.py phase 3 the LW/RW blocks (~300 MB) and psi (~0.4 MB, in
// L2) give a bound of ~0.1 ms, and the operations one within 1.5x of it.
// What limits this design there: the bytes it moves and the bytes in
// flight.  An entry re-reads its L rows for every 64 output columns and
// every 64 psi columns of its item, and its psi and R slices for every 64
// rows (a converged state's 128-wide blocks move ~4x the bound's bytes),
// while a step moves a few KB and two blocks an SM (106 KB of shared
// memory each) keep few steps in flight: the loads alone took ~70% of the
// kernel's time at ~0.8 TB/s on a random state, the products alone ~50%.
// f32 issues eight FMAs for four shared-memory loads a fragment and depth
// 4 and is bound by instructions there.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kT = 64;        // tile: rows and columns of a piece
                              // (chain_mv.py TILE)
constexpr int kKC = 32;       // depth of one step
constexpr int kST = 2;        // slots of the cp.async ring
constexpr int kMaxEnt = 64;   // entries of one chunk (chain_mv.py MAX_ENT)
constexpr int kW = kT / 8;    // warps: one an 8-row block of the piece
constexpr int kFPW = kT / 8;  // 8 x 8 column fragments of a warp
// row lengths of the L and R slices (kLDA), of the psi slice (ldp) and of
// Ts (kLDT): with kKC + 4 and kT + 4 a half warp's f64 fragment loads fall
// on distinct banks; a complex psi slice takes kT + 2 (see above)
constexpr int kLDA = kKC + 4;
constexpr int kLDT = kT + 4;
template <typename S>
__host__ __device__ constexpr int ldp() {
  return kT + (sizeof(S) == 16 ? 2 : 4);
}
// a ring slot (an L and a psi slice, or an R slice) and the dynamic
// shared memory, in elements
template <typename S>
__host__ __device__ constexpr int slot_elems() {
  return kT * kLDA + kKC * ldp<S>();
}
template <typename S>
__host__ __device__ constexpr int smem_elems() {
  return kST * slot_elems<S>() + kT * kLDT;
}

template <typename R>
struct __align__(2 * sizeof(R)) cplx {
  R x, y;
  cplx() = default;
  __device__ constexpr cplx(R a, R b = R(0)) : x(a), y(b) {}
};

struct Ent {
  int loff, k, poff, n, roff, ni, nc;
};
// an entry of the strided instance: the row strides of its L and R
struct EntLd : Ent {
  int ldl, ldr;
};
__device__ __forceinline__ int l_stride(const Ent& x) { return x.k; }
__device__ __forceinline__ int r_stride(const Ent& x) { return x.n; }
__device__ __forceinline__ int l_stride(const EntLd& x) { return x.ldl; }
__device__ __forceinline__ int r_stride(const EntLd& x) { return x.ldr; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// one element, zero-filled when !ok (src must then still be a valid
// address; nothing is read from it)
__device__ __forceinline__ void cp_elem(double* dst, const double* src,
                                        bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_elem(float* dst, const float* src,
                                        bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_elem(cplx<float>* dst,
                                        const cplx<float>* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_elem(cplx<double>* dst,
                                        const cplx<double>* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a (8 x 4, row) * b (4 x 8, col) on the f64 tensor cores.  Lane (g,
// t) = (lane / 4, lane % 4) holds a = A[g][t], b = B[t][g] and d = {D[g][2t],
// D[g][2t + 1]}.
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// acc[j] += A[r:r + 8, 0:kc4] B[0:kc4, 8j:8j + 8] for the warp's nf
// fragments j (row block r); A(x, kk) = As[x * lda + kk], B(kk, y) =
// Bs[kk * ldb + y] (KMAJ, a psi slice) or Bs[y * ldb + kk] (an R slice).
// f64: one DMMA a fragment and depth 4, the A fragment loaded once a depth.
template <bool KMAJ, int N>
__device__ __forceinline__ void mma_steps(double (&acc)[N][2], int r,
                                          int nf, const double* As, int lda,
                                          const double* Bs, int ldb, int kc4,
                                          int g, int t) {
  const int bks = KMAJ ? ldb : 1, bcs = KMAJ ? 1 : ldb;
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 4) {
    if (kk >= kc4) break;
    const double a = As[(r + g) * lda + kk + t];
    const double* b = Bs + (kk + t) * bks + g * bcs;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j >= nf) break;
      dmma(acc[j][0], acc[j][1], a, b[8 * j * bcs]);
    }
  }
}

// f32: the same fragments on the FMA pipes; lane (g, t) forms its own
// D[g][2t], D[g][2t + 1] from A[g][kk:kk + 4] (one 16-byte load) and
// B[kk:kk + 4][2t:2t + 2] (four 8-byte loads from a psi slice, or two
// 16-byte loads from an R slice).  The row lengths (kLDA, kLDP) and the
// slots keep every such load aligned.
template <bool KMAJ, int N>
__device__ __forceinline__ void mma_steps(float (&acc)[N][2], int r, int nf,
                                          const float* As, int lda,
                                          const float* Bs, int ldb, int kc4,
                                          int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 4) {
    if (kk >= kc4) break;
    const float4 a = *reinterpret_cast<const float4*>(As + (r + g) * lda +
                                                      kk);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j >= nf) break;
      const int y = 8 * j + 2 * t;
      if constexpr (KMAJ) {
        const float* b = Bs + kk * ldb + y;
        const float2 b0 = *reinterpret_cast<const float2*>(b);
        const float2 b1 = *reinterpret_cast<const float2*>(b + ldb);
        const float2 b2 = *reinterpret_cast<const float2*>(b + 2 * ldb);
        const float2 b3 = *reinterpret_cast<const float2*>(b + 3 * ldb);
        acc[j][0] = fmaf(a.x, b0.x, fmaf(a.y, b1.x, fmaf(a.z, b2.x,
                    fmaf(a.w, b3.x, acc[j][0]))));
        acc[j][1] = fmaf(a.x, b0.y, fmaf(a.y, b1.y, fmaf(a.z, b2.y,
                    fmaf(a.w, b3.y, acc[j][1]))));
      } else {
        const float4 u = *reinterpret_cast<const float4*>(Bs + y * ldb + kk);
        const float4 v =
            *reinterpret_cast<const float4*>(Bs + (y + 1) * ldb + kk);
        acc[j][0] = fmaf(a.x, u.x, fmaf(a.y, u.y, fmaf(a.z, u.z,
                    fmaf(a.w, u.w, acc[j][0]))));
        acc[j][1] = fmaf(a.x, v.x, fmaf(a.y, v.y, fmaf(a.z, v.z,
                    fmaf(a.w, v.w, acc[j][1]))));
      }
    }
  }
}

// complex128: per fragment and depth 4 the four real DMMAs of the plain
// complex product, d.re += a.re b.re - a.im b.im, d.im += a.re b.im +
// a.im b.re, on each lane's interleaved elements (one 16-byte load each)
template <bool KMAJ, int N>
__device__ __forceinline__ void mma_steps(cplx<double> (&acc)[N][2], int r,
                                          int nf, const cplx<double>* As,
                                          int lda, const cplx<double>* Bs,
                                          int ldb, int kc4, int g, int t) {
  const int bks = KMAJ ? ldb : 1, bcs = KMAJ ? 1 : ldb;
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 4) {
    if (kk >= kc4) break;
    const cplx<double> a = As[(r + g) * lda + kk + t];
    const cplx<double>* b = Bs + (kk + t) * bks + g * bcs;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j >= nf) break;
      const cplx<double> bv = b[8 * j * bcs];
      dmma(acc[j][0].x, acc[j][1].x, a.x, bv.x);
      dmma(acc[j][0].x, acc[j][1].x, -a.y, bv.y);
      dmma(acc[j][0].y, acc[j][1].y, a.x, bv.y);
      dmma(acc[j][0].y, acc[j][1].y, a.y, bv.x);
    }
  }
}

__device__ __forceinline__ void cmac(cplx<float>& d, cplx<float> a,
                                     cplx<float> b) {
  d.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, d.x));
  d.y = fmaf(a.x, b.y, fmaf(a.y, b.x, d.y));
}

// complex64: the fragments of f32 on the FMA pipes; lane (g, t) forms
// D[g][2t], D[g][2t + 1] from A[g][kk:kk + 4] (two 16-byte loads) and
// B[kk:kk + 4][2t:2t + 2] (four 16-byte loads from a psi slice, or four
// from an R slice)
template <bool KMAJ, int N>
__device__ __forceinline__ void mma_steps(cplx<float> (&acc)[N][2], int r,
                                          int nf, const cplx<float>* As,
                                          int lda, const cplx<float>* Bs,
                                          int ldb, int kc4, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 4) {
    if (kk >= kc4) break;
    const float4* ar = reinterpret_cast<const float4*>(As + (r + g) * lda +
                                                       kk);
    const float4 a01 = ar[0], a23 = ar[1];
    const cplx<float> a[4] = {{a01.x, a01.y}, {a01.z, a01.w},
                              {a23.x, a23.y}, {a23.z, a23.w}};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j >= nf) break;
      const int y = 8 * j + 2 * t;
      if constexpr (KMAJ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 b = *reinterpret_cast<const float4*>(
              Bs + (kk + i) * ldb + y);
          cmac(acc[j][0], a[i], {b.x, b.y});
          cmac(acc[j][1], a[i], {b.z, b.w});
        }
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4* br = reinterpret_cast<const float4*>(
              Bs + (y + q) * ldb + kk);
          const float4 u = br[0], v = br[1];
          cmac(acc[j][q], a[0], {u.x, u.y});
          cmac(acc[j][q], a[1], {u.z, u.w});
          cmac(acc[j][q], a[2], {v.x, v.y});
          cmac(acc[j][q], a[3], {v.z, v.w});
        }
      }
    }
  }
}

__device__ __forceinline__ void atomic_add(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}
template <typename R>
__device__ __forceinline__ void atomic_add(cplx<R>* p, cplx<R> v) {
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
}

template <typename S, bool LD = false>
__global__ void __launch_bounds__(kW * 32)
chain_kernel(const S* __restrict__ xp, const S* __restrict__ lp,
             const S* __restrict__ rp, const int* __restrict__ items,
             const int* __restrict__ ent, const int* __restrict__ ck,
             S* __restrict__ out) {
  constexpr int NT = kW * 32;
  constexpr int NF = LD ? 10 : 8;   // int32 fields of an item
  using EntT = std::conditional_t<LD, EntLd, Ent>;
  constexpr int kLDP = ldp<S>(), kSlot = slot_elems<S>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ring = reinterpret_cast<S*>(smem_raw);   // [kST][kSlot]
  S* Ts = ring + kST * kSlot;                 // tmp [kT][kLDT]
  __shared__ EntT E[kMaxEnt];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 8;   // this warp's row block
  const int* c4 = ck + 4 * (long long)blockIdx.x;
  const int e0 = c4[0], ne = c4[1] - c4[0];
  const int row0 = c4[2] * kT, col0 = c4[3] * kT;
  for (int i = tid; i < ne; i += NT) {
    const int item = ent[2 * (long long)(e0 + i)];
    const int ni = ent[2 * (long long)(e0 + i) + 1];
    const int* f = items + NF * (long long)item;
    if constexpr (LD)
      E[i] = EntLd{{f[0], f[2], f[3], f[4], f[5], ni,
                    min(kT, f[4] - ni * kT)}, f[8], f[9]};
    else
      E[i] = Ent{f[0], f[2], f[3], f[4], f[5], ni, min(kT, f[4] - ni * kT)};
  }
  // every entry of a chunk writes the same output piece
  const int* f0 = items + NF * (long long)ent[2 * (long long)e0];
  const int P = f0[6];
  const long long ooff = f0[7];
  const int lr = min(kT, f0[1] - row0), pc = min(kT, P - col0);
  const int lr8 = (lr + 7) & ~7, pc8 = (pc + 7) & ~7;
  const bool rows = wr < lr8;   // this warp's row block is live
  const int nf2 = pc8 >> 3;
  __syncthreads();

  S acc[kFPW][2], tacc[kFPW][2];
#pragma unroll
  for (int j = 0; j < kFPW; ++j)
    acc[j][0] = acc[j][1] = tacc[j][0] = tacc[j][1] = S(0);

  // step cursor: entry, stage (0: L . psi, 1: . R^T), depth offset
  struct Cur {
    int e, s, off;
  };
  auto adv = [&](Cur& c) {
    c.off += kKC;
    if (c.s == 0) {
      if (c.off >= E[c.e].k) c.s = 1, c.off = 0;
    } else if (c.off >= E[c.e].nc) {
      ++c.e, c.s = 0, c.off = 0;
    }
  };
  auto issue = [&](const Cur& c, int slot) {
    if (c.e >= ne) return;
    const EntT x = E[c.e];
    S* buf = ring + slot * kSlot;
    const int pcol = x.ni * kT;
    if (c.s == 0) {
      const int kc = min(kKC, x.k - c.off), kc4 = (kc + 3) & ~3;
      // L rows [row0, row0 + lr8) x depth [off, off + kc4) -> [r][kLDA]
      const S* lsrc = lp + x.loff + (long long)row0 * l_stride(x) + c.off;
      for (int i = tid; i < lr8 * kKC; i += NT) {
        const int r = i / kKC, kk = i % kKC;
        if (kk >= kc4) continue;
        const bool ok = r < lr && kk < kc;
        cp_elem(buf + r * kLDA + kk,
                ok ? lsrc + (long long)r * l_stride(x) + kk : lp, ok);
      }
      // psi rows [off, off + kc4) x columns [pcol, pcol + nc8) -> [kk][kLDP]
      S* Ps = buf + kT * kLDA;
      const int nc8 = (x.nc + 7) & ~7;
      const S* psrc = xp + x.poff + (long long)c.off * x.n + pcol;
      for (int i = tid; i < kc4 * kT; i += NT) {
        const int kk = i / kT, cc = i % kT;
        if (cc >= nc8) continue;
        const bool ok = kk < kc && cc < x.nc;
        cp_elem(Ps + kk * kLDP + cc,
                ok ? psrc + (long long)kk * x.n + cc : xp, ok);
      }
    } else {
      const int kc = min(kKC, x.nc - c.off), kc4 = (kc + 3) & ~3;
      // R rows [col0, col0 + pc8) x columns [pcol + off, + kc4) -> [p][kLDA]
      const S* rsrc =
          rp + x.roff + (long long)col0 * r_stride(x) + pcol + c.off;
      for (int i = tid; i < pc8 * kKC; i += NT) {
        const int pp = i / kKC, kk = i % kKC;
        if (kk >= kc4) continue;
        const bool ok = pp < pc && kk < kc;
        cp_elem(buf + pp * kLDA + kk,
                ok ? rsrc + (long long)pp * r_stride(x) + kk : rp, ok);
      }
    }
  };

  Cur ld{0, 0, 0}, cu{0, 0, 0};
#pragma unroll
  for (int s = 0; s < kST - 1; ++s) {
    issue(ld, s);
    cp_commit();
    if (ld.e < ne) adv(ld);
  }
  for (int j = 0; cu.e < ne; ++j) {
    cp_wait<kST - 2>();   // step j has landed (this thread's copies)
    __syncthreads();      // ... everyone's, and step j - 1's slot is free
    issue(ld, (j + kST - 1) % kST);
    cp_commit();
    if (ld.e < ne) adv(ld);
    const S* buf = ring + (j % kST) * kSlot;
    const Ent& x = E[cu.e];
    if (cu.s == 0) {
      const int kc4 = (min(kKC, x.k - cu.off) + 3) & ~3;
      const int nf1 = (x.nc + 7) >> 3;
      if (rows)
        mma_steps<true>(tacc, wr, nf1, buf, kLDA, buf + kT * kLDA, kLDP, kc4,
                        g, t);
      if (cu.off + kKC >= x.k) {   // the last slice of k: tmp to Ts
#pragma unroll
        for (int q = 0; q < kFPW; ++q) {
          if (rows && q < nf1) {
            S* d = Ts + (wr + g) * kLDT + 8 * q + 2 * t;
            d[0] = tacc[q][0];
            d[1] = tacc[q][1];
          }
          tacc[q][0] = tacc[q][1] = S(0);
        }
      }
    } else if (rows) {
      const int kc4 = (min(kKC, x.nc - cu.off) + 3) & ~3;
      mma_steps<false>(acc, wr, nf2, Ts + cu.off, kLDT, buf, kLDA, kc4, g, t);
    }
    adv(cu);
  }

  if (!rows) return;
  const int r = wr + g;
  if (r >= lr) return;
  S* o = out + ooff + (long long)(row0 + r) * P + col0 + 2 * t;
#pragma unroll
  for (int j = 0; j < kFPW; ++j) {
    if (j >= nf2) break;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (8 * j + 2 * t + q < pc) atomic_add(o + 8 * j + q, acc[j][q]);
  }
}

// out += the chain products of every chunk of (items, ent, ck); T is the
// tile the tables were cut for, which must be kT; LD: the strided
// instance (ten-field items)
template <typename S, bool LD = false>
cudaError_t chain_mv(const void* xp, const void* lp, const void* rp,
                     const int* items, const int* ent, const int* ck,
                     long long n_chunks, int T, void* out, void* stream) {
  if (T != kT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(S) * (size_t)smem_elems<S>();
  cudaError_t e = b2t::allow_smem(chain_kernel<S, LD>, smem);
  if (e != cudaSuccess) return e;
  if (n_chunks > 0)
    chain_kernel<S, LD><<<(unsigned)n_chunks, kW * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const S*>(xp), static_cast<const S*>(lp),
        static_cast<const S*>(rp), items, ent, ck, static_cast<S*>(out));
  return cudaGetLastError();
}

}  // namespace
