// K9 — bucketed environment blocking of the "torch_device" backend.
//
// Replaces block2_preview_tpu/ops/blocking_jax.py:87 _blk_exec.  For every
// contribution c of a BlockingPlan (ops/blocking_plan.py), with the env
// block E (l x k), the bra block MB and the ket block MK:
//
//   left:  out[o] (x x y) += coef_c . MB(l x x)^T . E . MK(k x y)
//   right: out[o] (x x y) += coef_c . MB(x x l)   . E . MK(y x k)^T
//
// in float or double.  The reference regroups the contributions into
// power-of-two shape classes with a floor of 8 and chunks of 1024, gathers
// padded stacks from the flat pools by indices it derives in-kernel from
// (offset, true dims) scalars, runs one einsum per class and scatter-adds
// the masked result into the flat output.  The classes and chunks exist to
// bound XLA's compiles (blocking_jax.py:43-84, 198-210); none is kept.
//
// Design.  Contributions that share their output block o, bra block and
// ket block (boff, koff) differ only in E and coef, so their sum is
// MB^T (sum_c coef_c E_c) MK: the host (ops/blocking_device.py k9_tables)
// orders the contributions by output block (the plan's own groups), then
// by (boff, koff) inside a group, and calls each run of one (o, boff,
// koff) a sub-group.  It cuts every output block into pieces of at most
// kP x kP elements and the sub-groups of one piece into FLOP-capped
// chunks: `ce` [C] / `cc` [C] the contributions' env offsets and
// coefficients in that order, `sg` [n_sg, 6] = (first contribution, end,
// boff, koff, dl, dk), `ck` [n_chunks, 8] = (first sub-group, end, ooff,
// dx, dy, x0, y0, atomic).  One warp runs one chunk (kWarps warps a block,
// each on its own chunk; no block-wide barrier):
//  * for each sub-group and each (kTL x kTK) tile of E, the warp sums
//    coef_c E_c into Ebar in its shared memory — the lanes split a small
//    tile's elements and several contributions at once, then add across
//    lanes by shuffles;
//  * lane j owns column y0 + j of the piece: it holds that column of MK's
//    tile in registers, forms tmp(l) = sum_k Ebar(l, k) MK(k, y) for each
//    row l of the tile (Ebar read as a broadcast), and adds MB(l, x) tmp(l)
//    into its column of the piece, acc (kP rows in registers; MB read as a
//    broadcast through the read-only cache);
//  * the piece goes into the output once a chunk: a plain read-add-write
//    where the piece is one chunk, an atomic an element only where its
//    sub-groups span chunks (atomic order varies between runs there, so
//    results agree with the plain version to rounding, not bitwise).
// Only true shapes are multiplied, on the FMA pipes in both types: the
// plans' dims are small (median 2-3, 90th percentile 11-15 on a random K=16
// QC state), far below a DMMA fragment.  The earlier design ran one
// 256-thread block of a chain product per contribution (and per 32-row
// strip), padded to 32 x 32 tiles with four block barriers a 16-deep step
// and one atomic an output element a contribution.
//
// Bound on the card: the pools read once and the output written once
// against the FLOPs of the grouped form, 2 (dl dk dy + dx dl dy) a
// sub-group plus 2 dl dk a contribution (chip_smoke.py k9_bytes_flops).

#include "common.cuh"

namespace {

constexpr int kP = 32;       // rows and columns of a piece
                             // (ops/blocking_device.py PIECE)
constexpr int kTL = 16;      // rows of an Ebar tile
constexpr int kTK = 16;      // columns of an Ebar tile
constexpr int kWarps = 4;    // warps of a block, one chunk each
constexpr unsigned kFull = 0xffffffffu;

// Ebar[l][k] (l < tl, k < tk, row length kTK) = sum over contributions
// [c0, c1) of cc[c] E_c[l0 + l][k0 + k], E_c at ep + ce[c] with row length
// dk.  A tile of ne <= 16 elements takes p = pow2(ne) lanes a
// contribution and 32 / p contributions at once, summed across lanes by
// shuffles; a larger tile runs one contribution at a time, a lane on
// elements lane, lane + 32, ...
template <typename S>
__device__ __forceinline__ void form_ebar(S* Eb, const S* __restrict__ ep,
                                          const int* __restrict__ ce,
                                          const S* __restrict__ cc, int c0,
                                          int c1, int dk, int l0, int k0,
                                          int tl, int tk, int lane) {
  const int ne = tl * tk;
  if (ne <= 16) {
    int p = 1;
    while (p < ne) p <<= 1;
    const int j = lane & (p - 1), ns = 32 / p;
    const bool live = j < ne;
    const int l = j / tk, k = j - l * tk;
    const long long eo = (long long)(l0 + l) * dk + k0 + k;
    S part = S(0);
#pragma unroll 4
    for (int c = c0 + lane / p; c < c1; c += ns)
      if (live) part += __ldg(cc + c) * __ldg(ep + __ldg(ce + c) + eo);
    for (int off = p; off < 32; off <<= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (lane < p && live) Eb[l * kTK + k] = part;
    return;
  }
  constexpr int kE = kTL * kTK / 32;   // elements a lane
  int eo[kE];
  S part[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int e = lane + 32 * i, l = e / tk, k = e - l * tk;
    eo[i] = (l0 + l) * dk + k0 + k;
    part[i] = S(0);
  }
  for (int c = c0; c < c1; ++c) {
    const S co = __ldg(cc + c);
    const S* e = ep + __ldg(ce + c);
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if (lane + 32 * i < ne) part[i] += co * __ldg(e + eo[i]);
  }
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int e = lane + 32 * i, l = e / tk, k = e - l * tk;
    if (e < ne) Eb[l * kTK + k] = part[i];
  }
}

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
bucket_blk_kernel(const S* __restrict__ ep, const S* __restrict__ bp,
          const S* __restrict__ kp, const int* __restrict__ ce,
          const S* __restrict__ cc, const int* __restrict__ sg,
          const int* __restrict__ ck, long long n_chunks, int left,
          S* __restrict__ out) {
  __shared__ S Ebs[kWarps][kTL * kTK];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long ci = (long long)blockIdx.x * kWarps + w;
  if (ci >= n_chunks) return;   // a whole warp: no barrier below spans it
  S* Eb = Ebs[w];
  const int* q = ck + 8 * ci;
  const int s0 = q[0], s1 = q[1], dx = q[3], dy = q[4], x0 = q[5],
            y0 = q[6];
  const long long ooff = q[2];
  const int px = min(kP, dx - x0), py = min(kP, dy - y0);
  const int y = y0 + lane;
  const bool col = lane < py;   // this lane's column lies in the piece

  S acc[kP];
#pragma unroll
  for (int x = 0; x < kP; ++x) acc[x] = S(0);

  for (int s = s0; s < s1; ++s) {
    const int* f = sg + 6 * (long long)s;
    const int c0 = f[0], c1 = f[1], dl = f[4], dk = f[5];
    const S* mb = bp + f[2];
    const S* mk = kp + f[3];
    // MB(l, x) = mb[l * mbl + x * mbx]; MK(k, y) = mk[k * mkk + y * mky]
    const int mbl = left ? dx : 1, mbx = left ? 1 : dl;
    const int mkk = left ? dy : 1, mky = left ? 1 : dk;
    for (int l0 = 0; l0 < dl; l0 += kTL) {
      const int tl = min(kTL, dl - l0);
      for (int k0 = 0; k0 < dk; k0 += kTK) {
        const int tk = min(kTK, dk - k0);
        form_ebar(Eb, ep, ce, cc, c0, c1, dk, l0, k0, tl, tk, lane);
        __syncwarp();
        if (col) {
          S mkc[kTK];
#pragma unroll
          for (int k = 0; k < kTK; ++k)
            mkc[k] = k < tk ? __ldg(mk + (long long)(k0 + k) * mkk +
                                    (long long)y * mky)
                            : S(0);
          for (int l = 0; l < tl; ++l) {
            S t = S(0);
#pragma unroll
            for (int k = 0; k < kTK; ++k)
              if (k < tk) t += Eb[l * kTK + k] * mkc[k];
            const S* b = mb + (long long)(l0 + l) * mbl + (long long)x0 * mbx;
#pragma unroll
            for (int x = 0; x < kP; ++x)
              if (x < px) acc[x] += __ldg(b + (long long)x * mbx) * t;
          }
        }
        __syncwarp();   // Ebar is read before the next tile overwrites it
      }
    }
  }

  if (!col) return;
  S* o = out + ooff + (long long)x0 * dy + y;
  if (q[7]) {
#pragma unroll
    for (int x = 0; x < kP; ++x)
      if (x < px) atomicAdd(o + (long long)x * dy, acc[x]);
  } else {
#pragma unroll
    for (int x = 0; x < kP; ++x)
      if (x < px) o[(long long)x * dy] += acc[x];
  }
}

template <typename S>
int bucket_blk(const void* ep, const void* bp, const void* kp,
               const int* ce, const void* cc, const int* sg, const int* ck,
               long long n_chunks, int left, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nb = (n_chunks + kWarps - 1) / kWarps;
  if (nb > 0)
    bucket_blk_kernel<S><<<(unsigned)nb, kWarps * 32, 0, st>>>(
        static_cast<const S*>(ep), static_cast<const S*>(bp),
        static_cast<const S*>(kp), ce, static_cast<const S*>(cc), sg, ck,
        n_chunks, left, static_cast<S*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_bucket_blk_f64(const void* ep, const void* bp, const void* kp,
                       const int* ce, const void* cc, const int* sg,
                       const int* ck, long long n_chunks, int left,
                       void* out, void* stream) {
  return bucket_blk<double>(ep, bp, kp, ce, cc, sg, ck, n_chunks, left, out,
                            stream);
}

int b2t_bucket_blk_f32(const void* ep, const void* bp, const void* kp,
                       const int* ce, const void* cc, const int* sg,
                       const int* ck, long long n_chunks, int left,
                       void* out, void* stream) {
  return bucket_blk<float>(ep, bp, kp, ce, cc, sg, ck, n_chunks, left, out,
                           stream);
}

}  // extern "C"
