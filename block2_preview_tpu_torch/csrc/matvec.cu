// K1 — tiled sigma matvec of the two-site effective Hamiltonian.
//
// Replaces block2_preview_tpu/ops/tilev2.py:101 _mv_scan (jit _mv_exec
// :187) and folds in :168 _tile_gather.  For every matvec item
// (symbol m, ket sector pk, bra sector ok) of the MatvecV2 plan:
//
//   sigma[ok] += LW[m][lk] @ psi[pk] @ RW[m][rk]^T
//
// The reference runs it on T x T tiles (T in {16, 32, 64, 128}) of tile
// pools; the plan (`it` [n, 13], psi_idx, sig_idx) keeps that layout, and
// T stays the plan's.  This kernel reads the LW/RW slab pools, psi and
// sigma in their flat layouts: ops/tilev2.py k1_items turns each live
// item into the eight fields of the chain core (LW offset, DLb, DLk, the
// flat psi offset of the ket sector, DRk, RW offset, DRb, the flat sigma
// offset of the bra sector), and ops/chain_mv.py cuts them into chunks of
// entries that write one sigma piece (rows [ar RT, +RT), columns [pi T,
// +T)).
//
// Design: the chain core (csrc/chain_mv.cuh).  One CUDA block a chunk
// multiplies only the live 8 x 8 fragments (f64 on DMMA m8n8k4, f32 on the
// FMA pipes), stages 32-deep L/psi/R slices by cp.async in a two-slot ring,
// keeps tmp in shared memory and the chunk's sum in registers, and adds
// it into the flat sigma once (float atomics; order varies between runs).
// The earlier design multiplied whole T x T tiles on the FMA pipes (83.5%
// of its products padding at the K=16 QC site), added each unit's tile
// with one atomic an element into a zeroed tile pool and flattened it with
// a second launch; both the pool and that launch are gone.  The reference
// kept bounded tmp pools per task group, with tile bases `tb` restarting
// in every group; this kernel has no tmp pool, so `tb` and the group
// tables are not read and one launch covers all groups.
// Bound on the card: the bytes of the LW/RW blocks the items read (the
// operations are within 1.5x, chain_mv.cuh).

#include "chain_mv.cuh"

extern "C" {

const char* b2t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int b2t_matvec_f64(const void* xp, const void* lpool, const void* rpool,
                   const int* items, const int* ent, const int* ck,
                   long long n_chunks, int T, void* sig,
                   void* stream) {
  return (int)chain_mv<double>(xp, lpool, rpool, items, ent, ck, n_chunks, T,
                               sig, stream);
}

int b2t_matvec_f32(const void* xp, const void* lpool, const void* rpool,
                   const int* items, const int* ent, const int* ck,
                   long long n_chunks, int T, void* sig,
                   void* stream) {
  return (int)chain_mv<float>(xp, lpool, rpool, items, ent, ck, n_chunks, T,
                              sig, stream);
}

}  // extern "C"
