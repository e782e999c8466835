// K2 — diagonal of the two-site effective Hamiltonian.
//
// Replaces block2_preview_tpu/ops/resident.py:331 _dl_build and :316
// _slab_diag_impl.  Only center symbols with dq = 0 contribute:
//
//   diag[(qL, qR)][a, b] = sum_m LW[m][(qL, qL)][a, a] * RW[m][(qR, qR)][b, b]
//
// flattened to the bra space (sector (qL, qR) row-major at its offset).
//
// Design: one launch from the LW/RW slab pools straight to the flat
// diagonal.  The host (ops/resident.py build_diag_struct, once a struct)
// lists `sym` [M0, 2] = (jl, jr), each common symbol's slab position on
// the two sides, and `rows` [n, 9] = (flat offset, DL, DR, a0, na, b0, nb,
// LW sector offset, RW sector offset): a piece of at most 32 x 32 of one
// sector.  One CUDA block of 16 x 16 threads takes one row: it keeps `sym`
// in shared memory and stages the piece's diagonals, LW[m][loff + jl DL^2
// + a (DL + 1)] and RW[m][roff + jr DR^2 + b (DR + 1)], 32 symbols a step
// through a 2-slot cp.async ring (the next step's loads in flight while
// this one is summed); thread (ty, tx) owns rows ty + 16 i and columns tx
// + 16 j of the piece in registers, adds each symbol's outer product in
// order (a rank-M0 product on the FMA pipes), then stores its elements
// once.  Every diagonal element is a scattered 8-byte read (a sector of
// its own), and a block's reads wait on the memory system's outstanding
// requests, so the pieces are small: on an H100 at the K=16 QC site 7,
// whole sectors (up to 76 x 76, 152 x 130 reads a block) took longer than
// 32 x 32 pieces, and 16 x 16 pieces, which read each diagonal more
// often, longer again.  Rows
// with DL = 0 are zero ranges (nb elements from the flat offset): the
// sectors without a dq = 0 contribution and the padded tail, as the
// earlier design's zero tiles gave them.  No pools, fills, gathers or
// atomics: two launches are bitwise equal.
// Bound on the card: tiny (once a Davidson solve; 39,468 outputs and 130
// symbols at the K=16 QC site 7): one launch's latency; in practice the
// scattered diagonal reads.

#include "chain_mv.cuh"   // cp.async helpers

namespace {

constexpr int kDiagThreads = 256;   // 16 x 16: thread (ty, tx)
constexpr int kDP = 32;             // rows and columns of a piece at most
                                    // (host: K2_PIECE)
constexpr int kDR = kDP / 16;       // rows (columns) a thread: ty + 16 i
constexpr int kDM = 32;             // symbols staged a step
constexpr int kDS = 2 * kDP;        // staged diagonal elements a symbol

template <typename S>
__host__ __device__ constexpr size_t diag_smem(int M0) {
  return 2 * kDM * kDS * sizeof(S) + 2 * sizeof(int) * (size_t)M0;
}

template <typename S>
__global__ void __launch_bounds__(kDiagThreads)
diag_kernel(const S* __restrict__ lpool, const S* __restrict__ rpool,
            const int* __restrict__ rows, const int* __restrict__ sym,
            int M0, S* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* stage = reinterpret_cast<S*>(smem_raw);   // [2][kDM][kDS]
  int* js = reinterpret_cast<int*>(stage + 2 * kDM * kDS);   // [M0][2]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* rw = rows + 9 * (long long)blockIdx.x;
  S* o = out + rw[0];
  const int DL = rw[1];
  if (DL == 0) {   // a zero range of nb elements
    for (int i = tid; i < rw[6]; i += kDiagThreads) o[i] = S(0);
    return;
  }
  const int DR = rw[2], a0 = rw[3], na = rw[4], b0 = rw[5], nb = rw[6];
  const long long lb = rw[7] + (long long)a0 * (DL + 1);
  const long long rb = rw[8] + (long long)b0 * (DR + 1);
  const long long l2 = (long long)DL * DL, r2 = (long long)DR * DR;
  const int w = na + nb;
  for (int i = tid; i < 2 * M0; i += kDiagThreads) js[i] = sym[i];
  __syncthreads();

  // the piece's diagonals of symbols [m0, m0 + kDM) -> stage[slot]: LW's
  // na elements at [0, na), RW's nb at [kDP, kDP + nb), a symbol
  auto issue = [&](int m0, int slot) {
    const int mc = min(kDM, M0 - m0);
    S* st = stage + slot * kDM * kDS;
    for (int i = tid; i < mc * w; i += kDiagThreads) {
      const int mm = i / w, x = i % w, m = m0 + mm;
      if (x < na)
        cp_elem(st + mm * kDS + x,
                lpool + lb + js[2 * m] * l2 + (long long)x * (DL + 1), true);
      else
        cp_elem(st + mm * kDS + kDP + x - na,
                rpool + rb + js[2 * m + 1] * r2 +
                    (long long)(x - na) * (DR + 1), true);
    }
  };

  // this thread's rows a = ty + 16 i (i < ia) and columns b = tx + 16 j
  // (j < jb) of the piece
  const int ia = (na - ty + 15) >> 4, jb = (nb - tx + 15) >> 4;
  S acc[kDR][kDR];
#pragma unroll
  for (int i = 0; i < kDR; ++i)
#pragma unroll
    for (int j = 0; j < kDR; ++j) acc[i][j] = S(0);
  issue(0, 0);
  cp_commit();
  for (int m0 = 0, slot = 0; m0 < M0; m0 += kDM, slot ^= 1) {
    if (m0 + kDM < M0) issue(m0 + kDM, slot ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const S* st = stage + slot * kDM * kDS;
    const int mc = min(kDM, M0 - m0);
    for (int mm = 0; mm < mc; ++mm) {
      S lv[kDR], rv[kDR];
#pragma unroll
      for (int i = 0; i < kDR; ++i) lv[i] = st[mm * kDS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kDR; ++j) rv[j] = st[mm * kDS + kDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kDR; ++i) {
        if (i >= ia) break;
#pragma unroll
        for (int j = 0; j < kDR; ++j) {
          if (j >= jb) break;
          acc[i][j] += lv[i] * rv[j];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kDR; ++i) {
    if (i >= ia) break;
    S* orow = o + (long long)(a0 + ty + 16 * i) * DR + b0 + tx;
#pragma unroll
    for (int j = 0; j < kDR; ++j) {
      if (j >= jb) break;
      orow[16 * j] = acc[i][j];
    }
  }
}

template <typename S>
cudaError_t diag(const S* lpool, const S* rpool, const int* rows,
                 const int* sym, int M0, int n_rows, S* out, void* stream) {
  const size_t smem = diag_smem<S>(M0);
  cudaError_t e = b2t::allow_smem(diag_kernel<S>, smem);
  if (e != cudaSuccess) return e;
  if (n_rows > 0)
    diag_kernel<S><<<(unsigned)n_rows, kDiagThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(lpool, rpool, rows,
                                                          sym, M0, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_diag_f64(const double* lpool, const double* rpool, const int* rows,
                 const int* sym, int M0, int n_rows, double* out,
                 void* stream) {
  return (int)diag<double>(lpool, rpool, rows, sym, M0, n_rows, out, stream);
}

int b2t_diag_f32(const float* lpool, const float* rpool, const int* rows,
                 const int* sym, int M0, int n_rows, float* out,
                 void* stream) {
  return (int)diag<float>(lpool, rpool, rows, sym, M0, n_rows, out, stream);
}

}  // extern "C"
