// K6 — perturbative-noise density matrix of the two-site step.
//
// Replaces block2_preview_tpu/ops/resident.py:862 _noise_exec (and the W
// tile gather :1119, tilev2.py:168 _tile_gather, that fed it).  For every
// noise item (MPO symbol m, psi sector k) of the NoisePlan:
//
//   x = W_m[qb, qk] @ psi[k]          (LW side; RW side: RW_m @ psi^T)
//   rho[qb] += x x^T
//
// into the tiled rho pool [nrho + 1, T, T] (sector qb at tile rb, its
// (ar, ac) tile at rb + ar na + ac).
//
// Design.  Two launches, no x scratch and no atomics (host tables
// ops/resident.py NoisePlan.host_tables):
//  1. noise_run_kernel: the items are sorted by rho sector and cut into
//     runs of at most 16 (fewer where their FLOPs pass a cap); one CUDA
//     block of 256 threads takes one run and one 64 x 64 strip pair a <= c
//     of the sector's rho (`nb` [n, 6] = first item, end, DB, a, c,
//     partial offset of the run; heaviest first): rho is symmetric, so the
//     pairs a > c are not formed.  For each item (`nw` [n, 5] = W offset,
//     psi offset, DK, DN, DB) and each chunk of 32 psi columns it forms the
//     x rows of strip c (if it is not strip a), then of strip a, in shared
//     memory, x = W[rows, :] psi[:, chunk], from W and psi chunks 32 deep
//     staged with coalesced loads (the item's W strip once, where it is one
//     chunk deep) — psi straight from its sector's offset and shape,
//     transposed in the staging on the RW side — then adds x_a x_c^T into
//     the strip's accumulators in registers.  x never reaches global
//     memory.  f64 runs both products on the tensor cores (DMMA m8n8k4:
//     warp w owns rows [8w, 8w + 8) of the tile, fragments at true dims
//     rounded up to 8, depths to 4); f32 on the FMA pipes (a thread holds R
//     x R elements of the tile, R = 1..4 from the strip's rows, the depth
//     and psi's columns summed to their live ends).  The block writes its
//     strip of the run's partial DB x DB matrix once, every element by one
//     thread.
//  2. noise_sum_kernel: each rho element of each sector (`ns` [n_sec, 5]
//     = partial offset of the sector's first run, runs, DB, rb, na) is the
//     sum of its runs' partials in run order (read transposed for a > c),
//     stored into its tile.
// So two launches are bitwise equal, and the partial pool holds runs x
// DB^2 elements where the x scratch held (items x na x nn) T x T tiles.
// A sector wider than one strip forms each item's x rows of a strip once
// for every strip pair that holds it (na + 1 times for na strips): the
// price of keeping x out of global memory.  Earlier design: one block a T
// x T x tile written to a scratch pool (715 MiB at the K=16 site), re-read
// 2 na times by a second kernel that added each item's tile products into
// the rho tiles with atomics.  Bound on the card: the operations (sum 2
// DB DN (DK + DB) FLOPs).

#include "common.cuh"

namespace {

constexpr int kStrip = 64;      // rows (and columns) of a rho strip
constexpr int kNC = 32;         // psi columns of one x chunk
constexpr int kKC = 32;         // depth of a staged W / psi chunk
constexpr int kNThreads = 256;  // 16 x 16 threads

// shared memory of a block: f64 (the tensor-core path) a W chunk, a psi
// chunk and two x chunks in rows of kKC + 4; f32 (R = 4) a W chunk of 64 x
// 33, a psi chunk of 32 x 32 and two x chunks of 64 x 33
template <typename S>
constexpr size_t noise_smem() {
  return sizeof(S) == 8
             ? sizeof(S) * (3 * kStrip + kKC) * (kKC + 4)
             : sizeof(S) * (3 * kStrip * (kKC + 1) + kKC * kNC);
}

// Ws [16R][kKC + 1] = W(r, k0 + k) for the strip's rows r < `rows` (zero
// for the rows past them, up to 16R) and k < kl; W rows of stride dk at w
template <typename S, int R>
__device__ __forceinline__ void stage_w(const S* __restrict__ w, int rows,
                                        int dk, int k0, int kl, S* Ws) {
  constexpr int N = 16 * R;
  for (int e = threadIdx.x; e < N * kl; e += kNThreads) {
    const int r = e / kl, kk = e - r * kl;
    Ws[r * (kKC + 1) + kk] = r < rows ? w[(long long)r * dk + k0 + kk]
                                      : S(0);
  }
}

// Ps [kKC][kNC] = P(k0 + k, n0 + n) for k < kl, n < nl (the rest is never
// read into a live x element); P(k, n) at p + k pk + n pn (psi or psi^T)
template <typename S>
__device__ __forceinline__ void stage_p(const S* __restrict__ p, int pk,
                                        int pn, int k0, int kl, int n0,
                                        int nl, S* Ps) {
  if (pn == 1) {
    for (int e = threadIdx.x; e < kl * nl; e += kNThreads) {
      const int kk = e / nl, n = e - kk * nl;
      Ps[kk * kNC + n] = p[(long long)(k0 + kk) * pk + n0 + n];
    }
  } else {
    for (int e = threadIdx.x; e < kl * nl; e += kNThreads) {
      const int n = e / kl, kk = e - n * kl;
      Ps[kk * kNC + n] = p[k0 + kk + (long long)(n0 + n) * pn];
    }
  }
}

// acc(i, j) += sum_{k < kl} Ws(ty + 16 i, k) Ps(k, tx + 16 j) over the
// columns j whose 16-column group is live (16 j < nl)
template <typename S, int R>
__device__ __forceinline__ void x_fma(const S* Ws, const S* Ps, int kl,
                                      int nl, S (&acc)[R][2]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int kk = 0; kk < kl; ++kk) {
    S a[R], b[2];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = Ws[(ty + 16 * i) * (kKC + 1) + kk];
#pragma unroll
    for (int j = 0; j < 2; ++j) b[j] = Ps[kk * kNC + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (16 * j < nl) acc[i][j] += a[i] * b[j];
  }
}

template <typename S, int R>
__device__ __forceinline__ void x_store(const S (&acc)[R][2], S* X) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      X[(ty + 16 * i) * (kNC + 1) + tx + 16 * j] = acc[i][j];
}

// one block: run q = (first item, end, DB, a, c, partial offset)
template <typename S, int R>
__device__ __forceinline__ void run_strip(const S* __restrict__ xp,
                                          const S* __restrict__ wpool,
                                          const int* __restrict__ nw,
                                          const int* q, int rw,
                                          S* __restrict__ part, S* sm) {
  constexpr int N = 16 * R;
  const int DB = q[2], a = q[3], c = q[4];
  const int ra = min(kStrip, DB - a * kStrip);
  const int rc = min(kStrip, DB - c * kStrip);
  const bool diag = a == c;
  S* Ws = sm;                      // [N][kKC + 1]
  S* Ps = Ws + N * (kKC + 1);      // [kKC][kNC]
  S* Xa = Ps + kKC * kNC;          // [N][kNC + 1]
  S* Xc = diag ? Xa : Xa + N * (kNC + 1);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  S acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = S(0);
  for (int it = q[0]; it < q[1]; ++it) {
    const int* f = nw + 5 * (long long)it;
    const S* w = wpool + f[0];
    const S* p = xp + f[1];
    const int dk = f[2], dn = f[3];
    const int pk = rw ? 1 : dn, pn = rw ? dk : 1;
    // the item's W rows in each strip (its DB is the sector's)
    const int wa = min(ra, f[4] - a * kStrip);
    const int wc = min(rc, f[4] - c * kStrip);
    const S* w_a = w + (long long)a * kStrip * dk;
    const S* w_c = w + (long long)c * kStrip * dk;
    // one depth chunk and one strip: W is staged once for the item
    const bool once = diag && dk <= kKC;
    if (once) stage_w<S, R>(w_a, wa, dk, 0, dk, Ws);
    for (int n0 = 0; n0 < dn; n0 += kNC) {
      const int nl = min(kNC, dn - n0);
      for (int s = diag ? 1 : 0; s < 2; ++s) {
        // s = 0: the x rows of strip c, s = 1: of strip a
        S xa[R][2];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) xa[i][j] = S(0);
        for (int k0 = 0; k0 < dk; k0 += kKC) {
          const int kl = min(kKC, dk - k0);
          if (!once)
            stage_w<S, R>(s ? w_a : w_c, s ? wa : wc, dk, k0, kl, Ws);
          stage_p(p, pk, pn, k0, kl, n0, nl, Ps);
          __syncthreads();
          x_fma<S, R>(Ws, Ps, kl, nl, xa);
          __syncthreads();
        }
        x_store<S, R>(xa, s ? Xa : Xc);
      }
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < nl; ++n) {
        S u[R], v[R];
#pragma unroll
        for (int i = 0; i < R; ++i) u[i] = Xa[(ty + 16 * i) * (kNC + 1) + n];
#pragma unroll
        for (int j = 0; j < R; ++j) v[j] = Xc[(tx + 16 * j) * (kNC + 1) + n];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) acc[i][j] += u[i] * v[j];
      }
      __syncthreads();
    }
  }
  S* dst = part + q[5] + (long long)(a * kStrip) * DB + c * kStrip;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= ra) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + 16 * j;
      if (col < rc) dst[(long long)r * DB + col] = acc[i][j];
    }
  }
}

// ---- f64: the same blocks on the tensor cores (DMMA m8n8k4) ---------------
// Warp w owns rows [8w, 8w + 8) of the strip pair's 64 x 64 tile: its x
// rows of a chunk (four 8 x 8 column fragments) and its rho rows (eight
// fragments).  Lane (g, t) = (lane / 4, lane % 4) holds A[g][t], B[t][g]
// and D[g][2t], D[g][2t + 1] of a fragment.  Rows of 36 doubles keep a
// half warp's fragment loads on distinct banks.
constexpr int kLD = kKC + 4;

// d += a (8 x 4, row) * b (4 x 8, col) on the f64 tensor cores
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Ws [64][kLD] = W(r, k0 + k) for r < ceil8(rows8) and k < ceil4(kl), zero
// past the item's `rows` live rows and past kl
__device__ __forceinline__ void stage_w8(const double* __restrict__ w,
                                         int rows, int rows8, int dk, int k0,
                                         int kl, double* Ws) {
  const int k4 = (kl + 3) & ~3;
  for (int e = threadIdx.x; e < rows8 * k4; e += kNThreads) {
    const int r = e / k4, kk = e - r * k4;
    Ws[r * kLD + kk] = (r < rows && kk < kl)
                           ? w[(long long)r * dk + k0 + kk] : 0.0;
  }
}

// Ps [kKC][kLD] = P(k0 + k, n0 + n) for k < ceil4(kl), n < ceil8(nl),
// zero past kl and nl
__device__ __forceinline__ void stage_p8(const double* __restrict__ p,
                                         int pk, int pn, int k0, int kl,
                                         int n0, int nl, double* Ps) {
  const int k4 = (kl + 3) & ~3, n8 = (nl + 7) & ~7;
  if (pn == 1) {
    for (int e = threadIdx.x; e < k4 * n8; e += kNThreads) {
      const int kk = e / n8, n = e - kk * n8;
      Ps[kk * kLD + n] = (kk < kl && n < nl)
          ? p[(long long)(k0 + kk) * pk + n0 + n] : 0.0;
    }
  } else {
    for (int e = threadIdx.x; e < k4 * n8; e += kNThreads) {
      const int n = e / k4, kk = e - n * k4;
      Ps[kk * kLD + n] = (kk < kl && n < nl)
          ? p[k0 + kk + (long long)(n0 + n) * pn] : 0.0;
    }
  }
}

// one block on the tensor cores: run q = (first item, end, DB, a, c,
// partial offset)
__device__ __forceinline__ void run_strip_mma(const double* __restrict__ xp,
                                              const double* __restrict__ wp,
                                              const int* __restrict__ nw,
                                              const int* q, int rw,
                                              double* __restrict__ part,
                                              double* sm) {
  const int DB = q[2], a = q[3], c = q[4];
  const int ra = min(kStrip, DB - a * kStrip);
  const int rc = min(kStrip, DB - c * kStrip);
  const int ra8 = (ra + 7) & ~7, rc8 = (rc + 7) & ~7;
  const bool diag = a == c;
  double* Ws = sm;                   // [64][kLD]
  double* Ps = Ws + kStrip * kLD;    // [kKC][kLD]
  double* Xa = Ps + kKC * kLD;       // [64][kLD]
  double* Xc = diag ? Xa : Xa + kStrip * kLD;
  const int lane = threadIdx.x & 31, wr = 8 * (threadIdx.x >> 5);
  const int g = lane >> 2, t = lane & 3;
  const int nfc = rc8 >> 3;          // live rho column fragments
  double acc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.0;
  for (int it = q[0]; it < q[1]; ++it) {
    const int* f = nw + 5 * (long long)it;
    const double* w = wp + f[0];
    const double* p = xp + f[1];
    const int dk = f[2], dn = f[3];
    const int pk = rw ? 1 : dn, pn = rw ? dk : 1;
    const int wa = min(ra, f[4] - a * kStrip);
    const int wc = min(rc, f[4] - c * kStrip);
    const double* w_a = w + (long long)a * kStrip * dk;
    const double* w_c = w + (long long)c * kStrip * dk;
    const bool once = diag && dk <= kKC;
    if (once) stage_w8(w_a, wa, ra8, dk, 0, dk, Ws);
    for (int n0 = 0; n0 < dn; n0 += kNC) {
      const int nl = min(kNC, dn - n0);
      const int nfx = (nl + 7) >> 3;   // live x column fragments
      for (int s = diag ? 1 : 0; s < 2; ++s) {
        // s = 0: the x rows of strip c, s = 1: of strip a
        const int r8 = s ? ra8 : rc8;
        double xa[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) xa[j][0] = xa[j][1] = 0.0;
        for (int k0 = 0; k0 < dk; k0 += kKC) {
          const int kl = min(kKC, dk - k0);
          if (!once)
            stage_w8(s ? w_a : w_c, s ? wa : wc, r8, dk, k0, kl, Ws);
          stage_p8(p, pk, pn, k0, kl, n0, nl, Ps);
          __syncthreads();
          if (wr < r8) {
            const int k4 = (kl + 3) & ~3;
            for (int kk = 0; kk < k4; kk += 4) {
              const double av = Ws[(wr + g) * kLD + kk + t];
              const double* b = Ps + (kk + t) * kLD + g;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (j < nfx) dmma(xa[j][0], xa[j][1], av, b[8 * j]);
            }
          }
          __syncthreads();
        }
        double* X = s ? Xa : Xc;
        if (wr < r8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            X[(wr + g) * kLD + 8 * j + 2 * t] = xa[j][0];
            X[(wr + g) * kLD + 8 * j + 2 * t + 1] = xa[j][1];
          }
        }
      }
      __syncthreads();
      if (wr < ra8) {
        const int n4 = (nl + 3) & ~3;
        for (int n = 0; n < n4; n += 4) {
          const double av = Xa[(wr + g) * kLD + n + t];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < nfc)
              dmma(acc[j][0], acc[j][1], av, Xc[(8 * j + g) * kLD + n + t]);
        }
      }
      __syncthreads();
    }
  }
  const int r = wr + g;
  if (r >= ra) return;
  double* dst = part + q[5] + (long long)(a * kStrip + r) * DB + c * kStrip;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col < rc) dst[col] = acc[j][0];
    if (col + 1 < rc) dst[col + 1] = acc[j][1];
  }
}

// kMinB blocks an SM: 3 (80 registers) where every sector is at most two
// strips wide, 2 for plans with wider sectors, whose long blocks of four
// x strips and more ran 1.3x faster on an H100 with the registers of two
// (the Hubbard-L16 D=1000 site of chip_smoke.py)
template <typename S, int kMinB>
__global__ void __launch_bounds__(kNThreads, kMinB)
noise_run_kernel(const S* __restrict__ xp, const S* __restrict__ wpool,
                 const int* __restrict__ nw, const int* __restrict__ nb,
                 int rw, S* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const int* q = nb + 6 * (long long)blockIdx.x;
  if constexpr (sizeof(S) == 8) {
    run_strip_mma(xp, wpool, nw, q, rw, part, sm);
    return;
  }
  const int DB = q[2];
  const int rows = max(min(kStrip, DB - q[3] * kStrip),
                       min(kStrip, DB - q[4] * kStrip));
  switch ((rows + 15) >> 4) {
    case 1: run_strip<S, 1>(xp, wpool, nw, q, rw, part, sm); break;
    case 2: run_strip<S, 2>(xp, wpool, nw, q, rw, part, sm); break;
    case 3: run_strip<S, 3>(xp, wpool, nw, q, rw, part, sm); break;
    default: run_strip<S, 4>(xp, wpool, nw, q, rw, part, sm); break;
  }
}

// rho element e of sector blockIdx.y = the sum of its runs' partials
template <typename S>
__global__ void __launch_bounds__(kNThreads)
noise_sum_kernel(const S* __restrict__ part, const int* __restrict__ ns,
                 int T, S* __restrict__ rho) {
  const int* s = ns + 5 * (long long)blockIdx.y;
  const long long p0 = s[0];
  const int nr = s[1], DB = s[2], rb = s[3], na = s[4];
  const long long n = (long long)DB * DB;
  for (long long e = blockIdx.x * (long long)kNThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kNThreads) {
    const int row = (int)(e / DB), col = (int)(e - (long long)row * DB);
    // strip pairs a > c are the transposes of the (c, a) pairs written
    const long long src = row / kStrip <= col / kStrip
                              ? e : (long long)col * DB + row;
    S v = S(0);
    for (int r = 0; r < nr; ++r) v += part[p0 + r * n + src];
    rho[((long long)rb + (row / T) * na + col / T) * T * T +
        (row % T) * T + col % T] = v;
  }
}

template <typename S, int kMinB>
cudaError_t launch_runs(const S* xp, const S* wpool, const int* nw,
                        const int* nb, int n_blocks, int rw, S* part,
                        cudaStream_t st) {
  const size_t smem = noise_smem<S>();
  cudaError_t e = b2t::allow_smem(noise_run_kernel<S, kMinB>, smem);
  if (e != cudaSuccess) return e;
  if (n_blocks > 0)
    noise_run_kernel<S, kMinB><<<n_blocks, kNThreads, smem, st>>>(
        xp, wpool, nw, nb, rw, part);
  return cudaGetLastError();
}

template <typename S>
cudaError_t noise(const S* xp, const S* wpool, const int* nw, const int* nb,
                  int n_blocks, const int* ns, int n_sec, int sum_blocks,
                  int T, int rw, int wide, S* part, S* rho, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      wide ? launch_runs<S, 2>(xp, wpool, nw, nb, n_blocks, rw, part, st)
           : launch_runs<S, 3>(xp, wpool, nw, nb, n_blocks, rw, part, st);
  if (e != cudaSuccess || n_sec == 0) return e;
  noise_sum_kernel<S><<<dim3(sum_blocks, n_sec), kNThreads, 0, st>>>(
      part, ns, T, rho);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b2t_noise_f64(const double* xp, const double* wpool, const int* nw,
                  const int* nb, int n_blocks, const int* ns, int n_sec,
                  int sum_blocks, int T, int rw, int wide, double* part,
                  double* rho, void* stream) {
  return (int)noise<double>(xp, wpool, nw, nb, n_blocks, ns, n_sec,
                            sum_blocks, T, rw, wide, part, rho, stream);
}

int b2t_noise_f32(const float* xp, const float* wpool, const int* nw,
                  const int* nb, int n_blocks, const int* ns, int n_sec,
                  int sum_blocks, int T, int rw, int wide, float* part,
                  float* rho, void* stream) {
  return (int)noise<float>(xp, wpool, nw, nb, n_blocks, ns, n_sec,
                           sum_blocks, T, rw, wide, part, rho, stream);
}

}  // extern "C"
