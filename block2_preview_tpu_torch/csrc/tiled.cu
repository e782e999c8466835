// K7 — sigma matvec of the tiled engine (time evolution and
// backend="torch_tiled"), in float, double, complex64 and complex128.
//
// Replaces block2_preview_tpu/ops/tiled.py:86 _tiled_matvec_impl (and the
// matvec inside :391 _tiled_dav).  The reference cuts every triple
// (m, lk, pk, rk, ok) of an effective Hamiltonian,
//
//   sigma[ok] += LW[m][lk] (a x k) . psi[pk] (k x n) . RW[m][rk]^T (n x p),
//
// into T x T tile tasks over zero-padded tile-major pools and runs them as
// a lax.scan over [G, B] task groups, with psi gathered into tiles and
// sigma read back through psi_idx / sig_idx.  Complex types are the plain
// product, no conjugation, as the reference's einsums.
//
// Design: the chain core of K1, K8 and K20 (csrc/chain_mv.cuh), on the
// items K8 reads — eight int32 fields an item (LW offset, a, k, psi
// offset, n, RW offset, p, sigma offset; ops/exec_bucket.py build_struct)
// over two flat LW/RW pools and the flat psi and sigma — sorted by sigma
// block and cut into chunks of entries that write one 64 x 64 sigma piece
// (ops/chain_mv.py).  Only true shapes are multiplied, in 8 x 8 fragments:
// f64 on DMMA m8n8k4, complex128 as four real DMMAs a step, f32 and
// complex64 on the FMA pipes; each chunk adds its piece into sigma with
// one atomic an element (two for complex).  No tile pool is packed and no
// psi_idx gather runs.  The earlier design ran one CUDA block per (task
// group, tmp tile) unit on whole zero-padded T x T tiles on the FMA pipes
// (83-86% of its products padding at the K=16 QC site), psi gathered
// element by element through psi_idx and one atomic per tile element per
// stage-2 task.  Atomic order varies between runs: results agree with the
// plain version to rounding, not bitwise.
// Bound on the card: the bytes of the LW/RW blocks the items read in the
// real types; the operations (four real products a complex one) in the
// complex types at the K=16 QC site (chip_smoke.py phase 3).

#include "chain_mv.cuh"

#define B2T_TILED_ENTRY(SFX, S)                                              \
  extern "C" int b2t_tiled_##SFX(const void* xp, const void* lp,             \
                                 const void* rp, const int* items,           \
                                 const int* ent, const int* ck,              \
                                 long long n_chunks, int T, void* out,       \
                                 void* stream) {                             \
    return (int)chain_mv<S>(xp, lp, rp, items, ent, ck, n_chunks, T, out,    \
                            stream);                                         \
  }

B2T_TILED_ENTRY(f32, float)
B2T_TILED_ENTRY(f64, double)
B2T_TILED_ENTRY(c64, cplx<float>)
B2T_TILED_ENTRY(c128, cplx<double>)
