// Chain product of one item of the kernels K10 (slab.cu), K18 (plan_exec.cu)
// and K22 (plan_exec_shard.cu), and of K8 and K9 before their redesigns:
//
//   out[x, y] += coef * sum_{l, k} A(x, l) B(l, k) C(k, y)
//
// with A (X x K1), B (K1 x K2) and C (K2 x Y) read from flat pools at an
// offset and with strides (so a transposed operand costs no copy), and the
// (X x Y) result added atomically into a flat output of row stride `ors`.
// Only the true dims are read and written: nothing is padded in memory.
//
// One CUDA block of kThreads (16 x 16) threads owns a strip of kCT = 32
// rows of X and up to kCY = 4 tiles of 32 columns of Y.  For every chunk
// of 32 of K2 it forms tmp = A[strip, :] B[:, chunk] (K1 staged 16 at a
// time through shared memory, a 2 x 2 micro tile per thread), stages tmp
// in shared memory, and for each of its Y tiles adds tmp C[chunk, tile]
// into registers.  At the end it adds coef * acc into the output with
// atomics: items of one bucket plan share output blocks.  A block
// recomputes tmp once per group of kCY Y tiles, so stage 1 is repeated
// ceil(Y / 128) times; at the dims of the port's plans that is once or
// twice.  An item takes ceil(X / 32) * ceil(Y / 128) CUDA blocks, `blk`
// numbering them strip-major (the wrappers' prefix sums count them with
// ops/exec_bucket.py chain_blocks).
//
// chain_block_f is the product itself, with B read through a functor
// load_b(l, k) and each result element handed to a functor store(x, y,
// v): K18 (plan_exec.cu) gathers B from psi through an index table and
// scatters into sigma through another.  chain_block is its strided form.
#pragma once

#include "common.cuh"

namespace b2t {

constexpr int kCT = 32;          // strip rows and contraction chunk of K2
constexpr int kCK = 16;          // contraction chunk of K1
constexpr int kCY = 4;           // Y tiles of 32 columns per block
constexpr int kCYW = kCT * kCY;  // Y columns per block

template <typename S, typename LoadB, typename Store>
__device__ __forceinline__ void chain_block_f(
    const S* __restrict__ A, long long ars, long long acs, LoadB load_b,
    const S* __restrict__ C, long long crs, long long ccs,
    int X, int K1, int K2, int Y, int blk, Store store) {
  __shared__ S As[kCT][kCK + 1];
  __shared__ S Bs[kCK][kCT + 1];
  __shared__ S Ts[kCT][kCT + 1];
  __shared__ S Cs[kCT][kCT + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nyg = (Y + kCYW - 1) / kCYW;
  const int x0 = (blk / nyg) * kCT;
  const int y0 = (blk % nyg) * kCYW;
  const int ny = min(kCY, (Y - y0 + kCT - 1) / kCT);

  S acc[kCY][2][2];
#pragma unroll
  for (int j = 0; j < kCY; ++j)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) acc[j][a][b] = S(0);

  for (int k0 = 0; k0 < K2; k0 += kCT) {
    // ---- tmp = A[x0:x0+32, :] B[:, k0:k0+32] -----------------------------
    S t[2][2] = {{S(0), S(0)}, {S(0), S(0)}};
    for (int l0 = 0; l0 < K1; l0 += kCK) {
      for (int e = tid; e < kCT * kCK; e += kThreads) {
        const int r = e / kCK, c = e % kCK;
        const int x = x0 + r, l = l0 + c;
        As[r][c] = (x < X && l < K1) ? A[x * ars + l * acs] : S(0);
      }
      for (int e = tid; e < kCK * kCT; e += kThreads) {
        const int r = e / kCT, c = e % kCT;
        const int l = l0 + r, k = k0 + c;
        Bs[r][c] = (l < K1 && k < K2) ? load_b(l, k) : S(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kCK; ++kk) {
        const S a0 = As[ty][kk], a1 = As[ty + 16][kk];
        const S b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
        t[0][0] += a0 * b0;
        t[0][1] += a0 * b1;
        t[1][0] += a1 * b0;
        t[1][1] += a1 * b1;
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) Ts[ty + 16 * a][tx + 16 * b] = t[a][b];

    // ---- acc[j] += tmp C[k0:k0+32, y tile j] -----------------------------
#pragma unroll
    for (int j = 0; j < kCY; ++j) {
      if (j >= ny) continue;          // ny is uniform over the block
      const int yb = y0 + j * kCT;
      for (int e = tid; e < kCT * kCT; e += kThreads) {
        const int r = e / kCT, c = e % kCT;
        const int k = k0 + r, y = yb + c;
        Cs[r][c] = (k < K2 && y < Y) ? C[k * crs + y * ccs] : S(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kCT; ++kk) {
        const S a0 = Ts[ty][kk], a1 = Ts[ty + 16][kk];
        const S b0 = Cs[kk][tx], b1 = Cs[kk][tx + 16];
        acc[j][0][0] += a0 * b0;
        acc[j][0][1] += a0 * b1;
        acc[j][1][0] += a1 * b0;
        acc[j][1][1] += a1 * b1;
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < kCY; ++j) {
    if (j >= ny) continue;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int x = x0 + ty + 16 * a;
      if (x >= X) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int y = y0 + j * kCT + tx + 16 * b;
        if (y < Y) store(x, y, acc[j][a][b]);
      }
    }
  }
}

// out[x, y] += coef * (A B C)[x, y] with B strided (row stride brs) and
// out of row stride ors, added atomically.
template <typename S>
__device__ __forceinline__ void chain_block(
    const S* __restrict__ A, long long ars, long long acs,
    const S* __restrict__ B, long long brs,
    const S* __restrict__ C, long long crs, long long ccs,
    int X, int K1, int K2, int Y, int blk, S coef, S* __restrict__ out,
    long long ors) {
  const S* b = B;
  S* o = out;
  chain_block_f<S>(
      A, ars, acs, [=](int l, int k) { return b[l * brs + k]; }, C,
      crs, ccs, X, K1, K2, Y, blk,
      [=](int x, int y, S v) { atomicAdd(o + x * ors + y, coef * v); });
}

}  // namespace b2t
