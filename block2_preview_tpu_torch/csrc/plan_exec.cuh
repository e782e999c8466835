// The padded-bucket kernel body shared by K18 (csrc/plan_exec.cu: every
// item of every bucket) and K22 (csrc/plan_exec_shard.cu: one rank's slice
// of each bucket's batch).  The design notes are K18's, in
// csrc/plan_exec.cu.
#pragma once

#include "chain.cuh"

namespace {

using b2t::kThreads;

template <typename S>
__global__ void __launch_bounds__(kThreads)
plan_exec_kernel(const S* __restrict__ xp, long long x_len,
                 const S* __restrict__ vals, const int* __restrict__ ints,
                 const long long* __restrict__ desc,
                 const long long* __restrict__ cum,
                 const long long* __restrict__ first, int nb,
                 long long sig_len, S* __restrict__ sigma) {
  const long long blk = blockIdx.x;
  int lo = 0, hi = nb;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= blk) lo = mid; else hi = mid;
  }
  const long long* d = desc + (long long)lo * 9;
  const int a = (int)d[0], k = (int)d[1], n = (int)d[2], p = (int)d[3];
  const long long bpi = d[4];
  const long long local = blk - cum[lo];
  // K18: cum counts every item of a bucket; K22: this rank's slice of
  // it, which starts at item first[lo]
  const long long item = (first ? first[lo] : 0) + local / bpi;
  const S* A = vals + d[5] + item * a * k;
  const S* R = vals + d[6] + item * p * n;
  const int* pidx = ints + d[7] + item * k * n;
  const int* oidx = ints + d[8] + item * a * p;
  const S* x = xp;
  S* sig = sigma;
  b2t::chain_block_f<S>(
      A, k, 1,
      [=](int l, int c) {
        const long long i = pidx[l * n + c];
        return (i >= 0 && i < x_len) ? x[i] : S(0);
      },
      R, 1, n, a, k, n, p, (int)(local % bpi),
      [=](int r, int c, S v) {
        // zero products (the padding: zero rows and columns of A and R,
        // zero batch items) add nothing; skipping them keeps thousands
        // of atomics off the one sentinel slot they all point at
        if (v == S(0)) return;
        const long long o = oidx[r * p + c];
        if (o >= 0 && o < sig_len) atomicAdd(sig + o, v);
      });
}

template <typename S>
int plan_exec(const void* xp, long long x_len, const void* vals,
              const int* ints, const long long* desc, const long long* cum,
              const long long* first, int nb, long long n_blocks,
              long long sig_len, void* sigma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0)
    plan_exec_kernel<S><<<(unsigned)n_blocks, kThreads, 0, st>>>(
        static_cast<const S*>(xp), x_len, static_cast<const S*>(vals), ints,
        desc, cum, first, nb, sig_len, static_cast<S*>(sigma));
  return (int)cudaGetLastError();
}

}  // namespace
