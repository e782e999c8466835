// K16 — v1 resident sigma matvec over LW/RW slab pools (SlabMatvec).
//
// Replaces block2_preview_tpu/ops/resident.py:288 _slab_matvec_impl: for
// every triple (symbol m, ket sector pk, bra sector ok) of the struct,
//
//   sigma[ok] += LW[m][lk] @ psi[pk] @ RW[m][rk]^T
//
// The reference runs it on T x T tiles of its [G, 4, B] and [G, B] task
// tables: stage 1 sums L tiles @ psi tiles into a tmp tile pool per task
// group, stage 2 sums tmp tiles @ R tiles^T into a sigma tile pool, and
// sig_idx flattens it.
//
// Design: K1's kernel (csrc/matvec.cu), the chain core's eight-field
// instance (csrc/chain_mv.cuh), over one item a triple.  The host
// (ops/resident.py k16_items) reads each triple back from the task tables
// (its L and R blocks' origins and dims, the flat offsets of its ket and
// bra sectors through psi_idx and sig_idx), orders them by bra sector with
// the ket sectors of one taken in turn (an output piece's entries then
// alternate between psi blocks, which timed faster than runs of one symbol
// group) and cuts them into chunks of entries that write one 64 x 64 sigma
// piece (ops/chain_mv.py), once per executor.  One CUDA block a chunk
// multiplies the true 8 x 8 fragments (f64 on DMMA m8n8k4, f32 on the FMA
// pipes) through a 2-slot cp.async ring, reading the slab pools, psi and
// sigma in their flat layouts, and adds its piece into the flat sigma once
// (float atomics; order varies between runs: results agree with the plain
// version to rounding).  No tmp tile pool, no sigma tile pool and no
// gather; sigma slots past the bra space are never written.  The earlier
// design ran the reference's two tile stages as two launches over every
// group (one tmp pool, T x T FMA tiles, atomics into the sigma tiles) and
// a gather.
// Bound on the card: the bytes of the LW/RW blocks the triples read, as
// K1 (the operations are within 1.5x, chain_mv.cuh).

#include "chain_mv.cuh"

extern "C" {

int b2t_slab_mv_f64(const void* xp, const void* lpool, const void* rpool,
                    const int* items, const int* ent, const int* ck,
                    long long n_chunks, int T, void* sig, void* stream) {
  return (int)chain_mv<double>(xp, lpool, rpool, items, ent, ck, n_chunks, T,
                               sig, stream);
}

int b2t_slab_mv_f32(const void* xp, const void* lpool, const void* rpool,
                    const int* items, const int* ent, const int* ck,
                    long long n_chunks, int T, void* sig, void* stream) {
  return (int)chain_mv<float>(xp, lpool, rpool, items, ent, ck, n_chunks, T,
                              sig, stream);
}

}  // extern "C"
