// K13 — symbol-mixing GEMM of the mix v3 LW/RW assembly.
//
// Replaces block2_preview_tpu/ops/mixv3.py:62 _env_gemm and :88
// _env_gemm_chunk.  Per env delta-quantum group g of a v3 plan and its
// output columns d:
//
//   OUT_g[w, d] = sum_j W_g[w, j] * ENV_g[j, d],
//   ENV_g[j, d] = epool[eoff[s] + j * dbdk[s] + d - secoff[s]],
//
// s the env sector of column d, and OUT_g[w, d] = 0 for d >= secoff[nsec]
// (the padded columns) and for the padded rows w >= nw; OUT_g is the
// group's [nw_p, dg_p] block of OUT, which K14 then reads through winsrc.
//
// Design: K3's output-stationary body (mix_core.cuh; design notes in
// mix.cu), one launch a plan.  Restricted to one sector s, a group's
// GEMM is a plain block: W_g rows at wdense[woff + w * ns + j] (W
// densified once a plan on the host, where the reference densifies it on
// every call), ENV rows at epool[eoff[s] + j * dbdk[s] + c] with row
// stride dbdk[s], OUT at goff + w * dg_p + secoff[s] + c with row stride
// dg_p — the group-by-sector blocks the v4 plan forms from the v3 one
// (ops/mixv4.py plan_v4).  The host (ops/mixv3.py k13_host_tables, once a
// plan) gives those blocks, cut in j at 1024 (a 64-bit slice mask), to
// mixv4.k3_host_tables: 64 x 64 OUT tiles, each walking only the 16-deep
// j slices whose W rows hold a non-zero through a 2-slot cp.async ring,
// f64 on DMMA m8n8k4, f32 on the FMA pipes, each OUT element stored once
// (no atomics: two launches are bitwise equal), and zero ranges for every
// element of each group's [nw_p, dg_p] block that no block writes (the
// padded rows and columns), so OUT needs no fill below `*zlim` (the end
// of the last group).  The window form (columns [c0, c0 + n) of one
// group into out [nw_p, n], the reference's chunked jit) runs the same
// body on blocks cut to the window and re-based to out.  The reference
// densifies W and multiplies at HIGHEST, so results agree to rounding,
// not bitwise.
//
// K13 ran before as one launch a GEMM group: a thread a column walking
// each row's COO non-zeros and gathering every env element once a
// non-zero of its symbol column, on the FMA pipes (2.157 ms for the LW +
// RW plans of the K=16 site 7, 716 group launches in two sweeps of
// chip_smoke.py phase 9b).
//
// Bound on the card: each group's env rows read once, its triplets, and
// its live OUT written; 2 FLOPs a non-zero of W and a live column.

#include "mix_core.cuh"

extern "C" {

int b2t_env_gemm_f64(const double* epool, const double* wpool, const int* kt,
                     const int* kl, const int* kz, const int* zlim,
                     int n_tiles, double* out, void* stream) {
  return (int)mix<double>(epool, wpool, kt, kl, kz, zlim, n_tiles, out,
                          stream);
}

int b2t_env_gemm_f32(const float* epool, const float* wpool, const int* kt,
                     const int* kl, const int* kz, const int* zlim,
                     int n_tiles, float* out, void* stream) {
  return (int)mix<float>(epool, wpool, kt, kl, kz, zlim, n_tiles, out,
                         stream);
}

}  // extern "C"
