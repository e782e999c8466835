// K3 — symbol-mixing GEMM of the LW/RW assembly (mix v4) and of the v3
// environment blocking.
//
// Replaces block2_preview_tpu/ops/mixv4.py:136 _mix4_scan (jits :277
// _mix4_exec, :283 _mix4_exec_packed; the v3 blocking's at
// ops/blockv2.py:806-811).  One plan item is a bounded GEMM sub-block
//
//   OUT[w, d] = sum_j W[w, j] * E[j, d],   w < nw, j < nsloc, d < width
//
// with W dense at wpool[wbase + w*wstride + j], the env slab rows at
// epool[ebase + j*estride + d] and OUT at out[obase + w*ostride + d].
// Items (the plan's `it` [n, 12], as the reference's) that are j-chunks of
// one GEMM block (a block with ns > 1024) share their OUT rows.
//
// Design: output-stationary, one writer an element (the body is in
// mix_core.cuh, which K13 runs on the v3 plans too).  The host
// (ops/mixv4.py k3_host_tables, once a plan) cuts each GEMM block's OUT
// into 64 x 64 tiles, `kt` [n_tiles, 8] = (first list entry, entries, rows,
// columns, OUT offset, OUT row stride, d0, 0), each pointing at a list
// `kl` [n, 8] = (W offset, W row stride, E offset, E row stride, depth,
// mask lo, mask hi, item): the block's j-chunk items in j order (one at
// every width the repository runs), each with the bitmap of the 16-deep j
// slices in which its W rows of the tile hold a non-zero; the kernel reads
// no item table.  One CUDA block of 8 warps owns one tile.
// It walks the set bits of its entries' masks in order: each step's W
// slice (64 x 16) and E slice (16 x 64), live rows and columns only,
// zero-filled to the fragment, come through a 2-slot cp.async ring; warp w
// accumulates rows [8w, 8w + 8) of the tile, all of its 8 x 8 column
// fragments, in registers (f64 on the tensor cores, DMMA m8n8k4; f32 on the
// FMA pipes, the port keeps true f32) and skips a 4-deep step whose W
// fragment is all zero (a warp vote).  The block then stores each OUT
// element once, the piece staged in shared memory so that a warp writes a
// row (coalesced: a fragment's lanes hold 8-byte pieces of 8 rows): no
// atomics, so two launches are bitwise equal, and OUT
// needs no zero fill: the host also lists every range of OUT that no
// GEMM block writes (`kz` [n, 2] = start, length: the mix's padding
// columns and rows, the v3 blocking's sectors without a spec and its tail
// past meta_out.total, which K1 and the next mix read as zeros), and
// zero tiles (-1, gaps, first gap) store zeros there, a warp a gap, below
// `*zlim`: the end of the last element OUT's reader reads (for the mix,
// formed on the device from K4's windows once a plan, so the size-class
// tail of its OUT buffer is left alone; for the v3 blocking, the pool).
// W is partly sparse where it is used: at site 7 of the K=16 QC state
// that chip_smoke.py phase 5 leaves, 0.101 of the LW mix's 0.654 dense
// GFLOP and 0.934 of the RW mix's 1.329 fall on W's non-zeros (phase 3).
// The mask skips the all-zero slices' loads and products, the vote the
// all-zero fragments' products.
// Bound on the card: the bytes written (21.7M covered OUT elements of
// the mix at that site, lw + rw) with the E slab read once; the products
// on W's non-zeros take a quarter of that time at the f64 tensor-core rate.

#include "mix_core.cuh"

extern "C" {

int b2t_mix_f64(const double* epool, const double* wpool, const int* kt,
                const int* kl, const int* kz, const int* zlim, int n_tiles,
                double* out, void* stream) {
  return (int)mix<double>(epool, wpool, kt, kl, kz, zlim, n_tiles, out,
                          stream);
}

int b2t_mix_f32(const float* epool, const float* wpool, const int* kt,
                const int* kl, const int* kz, const int* zlim, int n_tiles,
                float* out, void* stream) {
  return (int)mix<float>(epool, wpool, kt, kl, kz, zlim, n_tiles, out,
                         stream);
}

}  // extern "C"
