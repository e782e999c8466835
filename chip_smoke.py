"""Chip smoke test of the PyTorch + CUDA port (block2_preview_tpu_torch).

Drives the port's main path on one CUDA card and checks it against the
port's own host reference (backend="numpy", held equal to the JAX
package's host path by the CPU tests):

  1. device    card name and power limit (nvidia-smi), torch / CUDA /
               scipy (the Krylov solvers call scipy with rtol=)
  2. build     nvcc builds kernels K1-K22 from block2_preview_tpu_torch/csrc
               (one nvcc per source, all at once)
  4. parity    Hubbard-L8, D=80, 6 sweeps with noise, f64: |dE| < 1e-8 Ha
  5. full      seeded K=16 quantum-chemistry Hamiltonian (16 electrons,
               full QC MPO), D=[250, 250], noise [1e-4, 0], Davidson
               |r|^2 < 1e-14, f64: |dE| < 1e-6 Ha, every kernel K1-K6
               launched, no host redo, no environment or LW/RW download;
               prints the peak device memory and the most one noise call
               (K6) allocated above what it found
  6a. tiled    Hubbard-L8: backend="torch_tiled" ground state (D=80, 6
               sweeps with noise) against the host reference to 1e-8 Ha;
               from it, real-time (complex128, dt 0.05) and imaginary-time
               (f64, dt 0.1) TDVP, 2 steps each, on the card against the
               host backend: every step's energy to 1e-8 Ha, norms to
               1e-10, no host matvec
  6b. tdvp     DMRGDriver.td_dmrg: one real-time TDVP step (complex128,
               dt 0.02, bond dimension 250) of the K=16 MPS phase 5
               leaves, every Krylov matvec on K7; per-sweep wall split,
               K7 launches, energies, |psi| and the discarded weight;
               fails unless K7 launched, all finite, no host matvec and
               |1 - |psi|| within the discarded weight + 1e-10
  7a. excited  Hubbard-L8, D=80, 6 sweeps with noise, Davidson
               |r|^2 < 1e-14, against the host backend: three
               state-averaged roots on backend="torch" and on
               "torch_device" (f64), the first excited state on "torch"
               with the ground state projected out, one f32 root on
               "torch_device", two roots on "torch_tiled"; every root to
               1e-8 Ha (f32 to 1e-5); fails unless K8 launched on each
               bucketed run, K9 on each "torch_device" run, K7 on the
               tiled one
  7b. roots    the K=16 system of phase 5 on backend="torch_device", f64,
               three roots, D=250, noise 1e-4, Davidson |r|^2 < 1e-10, one
               sweep from get_random_mps(250, seed=11) (two until the
               density-matrix phases came; the depth was cut to keep the
               script inside its time):
               per sweep the wall split, every root's energy, K8 and K9
               launches, matvecs, the blocking uploads and downloads, and
               the peak device memory; fails unless K8 and K9 launched,
               K8's launches equal the matvecs, the energies are finite
               and ascending and no site was redone on the host
  8a. stacked  Hubbard-L8, D=80, 6 sweeps with noise, Davidson |r|^2 <
               1e-14, against phase 7a's host energies: torch_stacked
               (stacked pools, bucket engine K10 + K11, host Davidson
               around K8) with one and three roots, torch_resident and
               torch_tiled under B2TPU_STK_ENGINE=tiled_v1 (K12); every
               root to 1e-8 Ha; fails unless K10 and K11 launched on each
               torch_stacked run, K12 and no K5 on each tiled_v1 run
  8b. stacked  phase 5's start and schedule on torch_stacked, one root:
               per sweep the wall split, Tblk's host plan building and
               device time, K10 / K11 / K8 launches, matvecs (K8 must equal
               them), environment unpacks; the largest res pool and the
               peak device memory; within 1e-6 Ha of phase 5's host
               reference
  8c. tiled_v1 phase 5's start and schedule on torch_resident under
               tiled_v1: within 1e-8 Ha of phase 5's port energy (the same
               Davidson) and 1e-6 Ha of its host reference; fails unless
               K12 launched and K5 did not
  9a. mix      Hubbard-L8 with phase 4's schedule and start on
               torch_resident under B2TPU_MIX=3 (mix v3: K13 + K14) and
               =2 (mix v2: K15), each against phase 4's host energy to
               1e-8 Ha; fails unless the engine's kernels launched, no
               other mix kernel did (K4 never), and K3's launches equal the
               environment's v3 blockings (K3 only blocks, it never mixes)
  9b. mix v3   phase 5's start and schedule under B2TPU_MIX=3: per sweep
               the wall split with the mix-plan build time inside Teff and
               the K13 / K14 launches (K13 one a mix plan) and K13's
               host tables' seconds (inside Teff); the launch rules of
               9a, every host counter 0; within 1e-8 Ha of phase 5's port
               energy and 1e-6 Ha of its host reference
  9c. mix v2   the same start under B2TPU_MIX=2, one sweep (D=250, noise
               1e-4): the split, the v2 plan-build time, the K15
               launches and its host tables' seconds (inside Teff); within
               1e-8 Ha of phase 5's sweep-0 energy
  10a. npdm    Hubbard-L8, a port ground state (D=80, 6 sweeps, phase 4's
               schedule) and a second state (D=30, 2 sweeps): orders 1-4
               through DMRGDriver.get_npdm (1 and 2 on the host engine,
               order 2 also through get_trans_2pdm(ket, ket), which takes
               no singlet shortcut; 3 and 4 with algo="poly", closes on
               the card at the default threshold) and pooled_gram orders
               1-4 with device_min_flop=0 (every class close on K17),
               each against the determinant path (npdm_spatial) and
               order 3 also against pdm3_spatial, to 1e-10; the
               transition 1PDM and 3PDM of the two states to 1e-10; the
               energy from the 1PDM and 2PDM against drv.expectation to
               1e-8 Ha; fails unless K17's launches equal the closes of
               the threshold-0 runs
  10b. npdm    the K=16 MPS phase 5 leaves (D=250): the 1PDM and 2PDM by
               the pooled engine (npdm_spatial_poly's pooled_gram +
               gram_to_spatial) at the default threshold on the card,
               each Gram against the same Gram with host BLAS closes (in a
               worker) to 1e-12, and the energy from them against
               drv.expectation (in a worker) to 1e-8 Ha; then the 3PDM of
               a 12-orbital space (seeded K=12 QC, 12 electrons, the port
               at D=100, 2 sweeps from get_random_mps(100, seed=11)) the
               same way against its host Gram; the wall split (host pools
               / closes / scatter), the closes, K17's launches and the
               peak device memory; fails unless K17 launched
  10c. probes  utils/gpu_smoke.run_smoke("cuda"): the float32 precision
               probe (K19's dot and the float32 matmul, inputs that TF32
               rounds visibly), one K19 launch filling a 2^27-element
               pool, and a float32 torch_tiled Hubbard-L8 solve (D=120, 6
               sweeps) against exact diagonalization to 5e-4 Ha; all must
               pass, and the precision probe must fail with TF32 switched
               on (the negative control; the policy is restored after)
  10d. plan    PlanExecutor (the padded-bucket matvec, K18) at the
               Hubbard-L8 center 3 (D=60, 2 host sweeps), f64 and f32,
               against its twin and against K8's sigma on the same center
               (f64: 1e-12 relative); phase 3 does the same at the K=16
               site 7
  11a. shard   the operator-sharded path (torch.distributed) in a
               spawned process that runs 11a and 11b beside phase 12
               (``shard_proc``): a mesh of world size 1 under NCCL (file
               rendezvous), phase 4's start and schedule on torch_resident
               with the mesh, against phase 4's host energy to 1e-8 Ha;
               fails unless K20 and K21 launched and K1 and K5 did not;
               the group is destroyed after
  11b. shard   two ranks on the one card under gloo (spawned, file
               rendezvous, a group timeout and a join deadline), each
               running phase 5's start and schedule at full width with the
               mesh: per sweep the wall split, K20/K21 launches and units,
               matvecs and the time in all_reduce (gloo stages it through
               the host: a one-card number, not an NVLink one); fails
               unless both ranks' energies and final states are bitwise
               equal, the energy is within 1e-8 Ha of phase 5's port
               energy, K20's launches equal the rank's matvecs at the sites
               where it owns units, K21 launched and K1 and K5 did not;
               then ShardedPlanExecutor at 10d's center against K18's
               sigma to 1e-12 relative (K22 launched) and
               pooled_gram(state, 2, device=mesh, device_min_flop=0) on
               10a's ground state against one device's Gram to 1e-12 (K17
               launched on each rank)
  12a. gf      Hubbard-L8, phase 4's ground state: one Green's-function
               point, d_0 at E0 - 0.4 + 0.05i, through
               DMRGDriver.greens_function (Linear fit of d_0|gs>, D=80, 4
               sweeps) on K7 c128, the same |b> on the host backend, and
               the squared form on K7 f64 with and without two harmonic
               projections; each against exact diagonalization (the N-1
               sector, 3920 states, in a worker) to 5e-5, the complex one
               against the host to 1e-8; fails unless K7 launched once a
               matvec with no host matvec; then compress_mps (D=60),
               multiply and addition (D=160) on the state with
               tests/test_linear.py's bars
  12b. gf      the K=16 state phase 5 leaves: greens_function(mpo, ket5,
               e5, "d", 0, -0.4, 0.05, 250, n_sweeps=1) on K7 c128 (one
               sweep since phase 13 came: two passed the time limit's
               1140 s mark on slower hosts); per sweep the wall split (blocking, LW/RW assembly, struct,
               pack, tables, solve, decimation), K7 launches, matvecs and
               GMRES matvecs a site (largest, median), and G; fails unless
               G is finite with Im G < 0, K7 launched once a matvec and
               no host matvec ran; then K7's c128 sigma at center 7 of
               the solve's own Hamiltonian environments (complex |x>)
               against matvec_np to 1e-12 relative
  12c. rotation Hubbard-L8, phase 4's state: orbital_rotation by a seeded
               antisymmetric kappa (scale 0.12; D=200, 6 steps) on K7 c128
               under the complex MPO i*G, against the host backend (in a
               worker): the energies under the rotated integrals to 1e-8
               Ha, within 3e-4 Ha of E0, and more than 1e-3 Ha off E0
               under the unrotated ones; fails unless K7 launched once a
               matvec on the complex operator pools
  12d. onedot  Hubbard-L8, 6a's start and schedule with
               twodot_to_onedot=4 on torch_tiled (K7) and torch (K8), and
               one last_site_1site solve on torch_tiled, each within 1e-8
               Ha of the host backend's run (in workers); fails unless the
               kernel launched in both one-site sweeps
               (EffectiveHamiltonian1 forward, 1R backward)
  13a. su2     spin-adapted DMRG through DMRGDriver(SymmetryTypes.SU2) on
               the card (environment blocking on K5's v2 path, every sigma
               product on K7): Hubbard-L8 (U=2, N=8, 2S=0) at D=120
               multiplets (exact), 6 sweeps, noise [1e-4, 1e-5, 0], within
               1e-8 Ha of ED and of the port's host engine (backend=
               "numpy", in a worker); per sweep the wall split; fails
               unless K7 launched once a matvec with no host matvec, K5
               once a blocking step, and no other kernel
  13b. su2     the seeded K=10 QC system with 14 electrons (full SU(2) QC
               MPO; N2/STO-3G's widths) at D=500 multiplets, at most 6
               sweeps, tol 1e-10, for 2S=2 and 2S=0, each spin in a
               spawned process started before 13a (their host LW/RW
               assembly runs side by side): each within 1e-8 Ha of the
               host engine on the same schedule (in workers), E(2S=2) <
               E(2S=0), the launch rules of 13a; then at the middle
               centre of 2S=0 K7's sigma on the SU(2) adapter against the
               host matvec and one K5 v2 output pool against its twin,
               both to 1e-12 relative, printed as phase-3 rows
  3. kernels   each kernel against its plain PyTorch twin on the card, at
               a mid-chain site of the MPS that phase 5 leaves — the
               shapes the main path gives the kernels (it runs last for
               that reason; its launches are not counted): K1-K6 in f64
               and f32 (K4 on a slab of NaNs, bitwise against its twin
               and one index_add_; a zero fill of the slab also timed
               alone; K5 on the left and right v3 rotate plans (l3, r3)
               and v2 plans (l2, r2), its rows printing its slab-core
               runs and tile-path units, the v3 ones also bitwise against
               a second launch; K6 lw and rw, bitwise against a second
               launch, its rows printing its runs, blocks and partial
               pool beside the x scratch of the earlier design), K7 in
               f64, f32, complex128 and complex64 (the
               same operators cast to complex) and in complex128 on the
               complex environments of the state phase 6b leaves, and the
               tiled Davidson (K7) against the host Davidson; K8 in f64
               and f32, K9 on the site's left and right blocking plans in
               f64 and f32, and a three-root host Davidson around K8
               against the host Davidson on the host matvec; K10, K11
               (library: one index_add_) and K12 on the site's left and
               right bucket-engine and v1 plans, f64 and f32 (K10, a
               CUDA block a run of one item's works, and K11 and K12,
               which share the gather-by-output mix core, also bitwise
               against a second launch; K10's rows print its works' dims
               and its tables' host seconds, K11's and K12's the core's
               output blocks, terms a block and work split, K12's waves,
               scratch and device tables); then again
               at the mid-chain site of a Hubbard-L16 MPS of bond
               dimension 1000, whose plans pick K1's T=128 tiles
               (K5's and K12's blocking plans are built with T=128 there;
               K8 meets its widest buckets there; K10 alone, f64, whose
               operands there pass 32 x 32 and are read from the pools;
               K5 alone on v3 plans built at T=16, whose wide items take
               its tile path with up to 8 strips of l, bitwise over two
               launches and K21's two shares summed bitwise one launch);
               K13 (the K=16 site's LW and RW v3 plans, one launch a plan
               from a buffer of NaNs on K3's output-stationary body,
               bitwise against a second launch, with its tiles, slices,
               gap zeros and host-table seconds; and one window at
               c0 > 0), K14 (library: one torch.take; bitwise against its
               twin on the slab and on two windows at c0 > 0 of odd
               length, one across the live end; tail and sentinel 0), K15
               on the same sides' v2 plans (library: one index_add_; on
               the mix core, bitwise against a second launch, held
               against the v3 pool, padding and sentinel 0; its rows print
               the tasks, output windows, tasks a window and the tables'
               host seconds) and
               K16 (the v1 slab matvec on the site's LW/RW pools, K1's
               chain core over one item a triple, its row printing the
               items, entries, chunks and table seconds; also held
               against K1 to 1e-12 relative), f64 and f32; K17 at
               the shapes of the largest class closes of 10b (K=16 order
               2, K=12 order 3; library: one torch.matmul, cuBLAS DGEMM), f64 and
               complex128, each bitwise against a second launch, then at
               63 edge shapes and on an unaligned V (phase_k17_edges); K18
               at the K=16 site 7 (also against K8; the true against the
               padded GFLOP, its items, chunks and table seconds), f64
               and f32; K19's
               dot (2048 values; library torch.dot; also the host
               microseconds a call of it, of torch.dot and of the launch
               path, and its launch on a side stream) and fill (2^27
               values); the sharded kernels at the K=16 site 7, each
               rank's share of a world of two launched here: K20
               (the matvec), K21 (the left and right v3 rotate plans), K22
               (PlanExecutor's buckets, f64 and f32, each share's row
               printing its items, chunks and true GFLOP) and B22e (K17 on
               the row slices of 10b's largest close), each share against
               its twin and their sum against K1 / K5 / K18 / one K17
               launch (K21's v3 shares summed bitwise equal to one K5
               launch).  K1, K20, K16, K8, K7, K18 and K22 run on one
               chain core (csrc/chain_mv.cuh, K18 and K22 on its strided
               instance; atomics, so they agree with their twins to
               rounding): K1's row
               prints its order tables' build time and the live 8 x 8
               fragments of its entries and chunks, K8's the histogram of
               its item dims (a, k, n, p), K7's its items, entries,
               chunks and true GFLOP.  K9's rows print the plan's output
               groups, (bra, ket) sub-groups and chunks, its GFLOP
               contribution by contribution and grouped (E summed first),
               and the histograms of the sub-groups' dims.  Each row
               carries the kernel's time (and the launches one timed call
               makes, with the time a launch), its twin's, one PyTorch
               call's where one computes the same function, and the bound
               (the least time the card could take: the live bytes the
               kernel must move — no pool or table padding — over
               3.35 TB/s or FLOPs over 67 TFLOP/s, whichever is larger)

Run from the repository root:  python3 chip_smoke.py
It needs one CUDA card and exits non-zero (printing no result) without
one.  ``python3 chip_smoke.py --beside PARENT_TREE`` instead times phase
3's K1-K8, K10-K16, K18 and K20-K22 rows at the K=16 site and the sweeps of
phases 5 and 8b of this tree and of an unpacked earlier commit in turns
(parent, this, this, parent; ``beside_parent``), and holds the change's
K10 outputs (bitwise) and K5's v3 rotate outputs (1e-14) against the
parent's, and reports K6's.  The
host references of phase 5 and of phase 3's three-root Davidson run in
two spawned worker processes beside the device phases
(their numerical libraries held to 3 threads each); the script
terminates them before it exits.  The last line is {"ok": true,
"device": {...}}; the line before it is the per-kernel JSON summary:
K1-K6 and K8-K12 from their f64 rows at the K=16 site, K7 from its
complex128 row on phase 6b's state, with the launches of phases 5
(K1-K6) and 13 (K5), 6b, 12 and 13 (K7), 7b (K8, K9), 8b (K10, K11), 8c (K12), 9b (K13,
K14) and 9c (K15), 10b (K17), 10d (K18), 10c (K19) and 11b (K20-K22, both
ranks summed; the rows' times are the two shares' summed).  No path runs the v1
slab matvec (K16), as in the JAX package: its launches are those counted
in the runs of phases 5, 7b, 8b, 8c, 9b and 9c, each from a reset, and
the script fails unless they are 0.  The host references of phases 10a,
10b, 12 and 13 run in the same workers.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

F64_TOL = 1e-11     # kernel vs twin, relative to max |twin|
F32_TOL = 1e-5
# K7-K9 vs twin: atomic sums change order between runs, so the f64 /
# c128 results agree to rounding (~1e-15 relative), not bitwise
ATOMIC_TOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-5,
              np.complex64: 1e-5}
HUB_TOL = 1e-8      # Ha, phases 4, 6a and 7a
F32_E_TOL = 1e-5    # Ha, phase 7a's f32 root (f32 keeps ~7 digits of -6 Ha)
QC_TOL = 1e-6       # Ha, phase 5
NORM_TOL = 1e-10    # phase 6a norms; phase 6b |psi| slack
PDM_TOL = 1e-10     # phase 10a, PDM elements against the determinant path
GRAM_TOL = 1e-12    # phase 10b, device Gram against the host Gram (max abs)
RDM_E_TOL = 1e-8    # Ha, phases 10a/10b energy from the 1PDM and 2PDM
HBM_BPS = 3.35e12   # H100 SXM memory rate, bytes/s
PEAK_FLOPS = 67e12  # H100 SXM f64 tensor-core / f32 CUDA-core peak, FLOP/s
# launches timed for the K4, K14, K17 and K19 rows: at 0.1-0.2 ms a
# launch, the host's start after the timer's first event is a few percent
# of five; K19's dot is host-bound, and twenty calls average the host's
# jitter
ROW_REPS = 20
HOST_CALLS = 1000   # calls timed on the host clock for K19's launch cost


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def seeded_qc_integrals(n_orb: int, n_aux: int = 32, seed: int = 1234):
    """8-fold symmetric PSD two-electron integrals g2e = sum_P L_P (x) L_P
    (symmetric L_P, scale 0.15) and h1e = sym(0.1 N) + diag(linspace(-2,
    1)) — a dense QC Hamiltonian whose MPO has the full QC structure."""
    rng = np.random.default_rng(seed)
    n = 0.1 * rng.standard_normal((n_orb, n_orb))
    h1e = 0.5 * (n + n.T) + np.diag(np.linspace(-2.0, 1.0, n_orb))
    g2e = np.zeros((n_orb,) * 4)
    for _ in range(n_aux):
        a = 0.15 * rng.standard_normal((n_orb, n_orb))
        lp = 0.5 * (a + a.T)
        g2e += np.einsum("ij,kl->ijkl", lp, lp)
    return h1e, g2e


def qc_system(n_orb: int, n_elec: int):
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    h1e, g2e = seeded_qc_integrals(n_orb)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=n_orb, n_elec=n_elec, spin=0)
    t0 = time.time()
    mpo = drv.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=0.0)
    return drv, mpo, time.time() - t0


class DeviceMs(float):
    """A mean time in ms (:func:`time_ms`) that also carries the kernel
    launches one call of the timed function made (``launches``, counted
    by the port's launch path), so a row that times a call of several
    launches shows its time a launch."""
    launches = 0


def time_ms(fn, device, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches (CUDA events), after
    one warm-up call; on the CPU the host clock.  Returns a
    :class:`DeviceMs` carrying the kernel launches a call."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    fn()
    n0 = sum(_kernels.launch_counts().values())
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = DeviceMs((time.perf_counter() - t0) * 1e3 / reps)
    else:
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        ms = DeviceMs(s.elapsed_time(e) / reps)
    ms.launches = (sum(_kernels.launch_counts().values()) - n0) // reps
    return ms


def histogram(values, edges=(8, 16, 32, 64, 128)) -> str:
    """Counts of integer ``values`` in the bins <= edges[0], ...,
    > edges[-1], as text."""
    v = np.asarray(values, np.int64)
    lo, parts = None, []
    for e in edges:
        n = int(np.count_nonzero((v <= e) if lo is None else
                                 (v > lo) & (v <= e)))
        parts.append(f"<={e} {n}")
        lo = e
    parts.append(f">{edges[-1]} {int(np.count_nonzero(v > edges[-1]))}")
    return ", ".join(parts)


def chain_shapes(items, ck) -> str:
    """The shapes the chain core (K1, K8, K20) meets on a plan's items and
    chunks (ops/chain_mv.py, the core's tile): live 8 x 8 fragments of
    stage 1 (tmp) and of stage 2 (the sigma piece) an entry, entries a
    chunk."""
    from block2_preview_tpu_torch.ops import chain_mv
    e = chain_mv.entries(items)
    ck = np.asarray(ck, np.int64)
    rb = -(-e["lr"] // 8)
    f1 = rb * -(-e["nc"] // 8)
    f2 = rb * -(-e["pc"] // 8)
    fr = (1, 2, 4, 8, 16, 32, 64)
    n_ent = ck[:, 1] - ck[:, 0]
    return (f"stage-1 fragments an entry: {histogram(f1, fr)}; stage-2 "
            f"fragments an entry: {histogram(f2, fr)}; entries a chunk: "
            f"{histogram(n_ent, (1, 2, 4, 8, 16, 32))}")


def host_us(fn, device, n: int = HOST_CALLS) -> float:
    """Host microseconds a call of fn() over n back-to-back calls
    (time.perf_counter, after one warm-up call and a synchronise): what the
    host spends to launch a call, not what the card spends on it."""
    import torch
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dt * 1e6 / n


def launch_path_us(kernels, a, b, device, n: int = HOST_CALLS) -> float:
    """Host microseconds a call of ``kernels.call`` (a module with the
    interface of the port's ops/_kernels.py) launching K19's dot of the
    float32 vectors a and b into one preallocated output: the launch path
    alone, without the wrapper around it."""
    import torch
    out = a.new_empty(1)
    return host_us(lambda: kernels.call("b2t_probe_dot", torch.float32, a,
                                        b, a.numel(), out), device, n)


def k19_stream_check(device, a, b):
    """The launch path launches on the caller's current stream: its raw
    handle is torch.cuda.current_stream()'s on the default stream and
    inside a side stream, and K19's dot launched inside the side stream
    gives the right sum there."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    from block2_preview_tpu_torch.utils import gpu_smoke
    want = float(gpu_smoke.dot_plain(a, b))
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    for st in (torch.cuda.current_stream(device), side):
        with torch.cuda.stream(st):
            if _kernels.current_stream_handle() != st.cuda_stream:
                fail(f"the launch path's stream is not the current one "
                     f"({st})")
            got = gpu_smoke.dot(a, b)
        st.synchronize()
        if not abs(float(got) - want) <= F32_TOL * abs(want):
            fail(f"K19 dot on {st}: {float(got)} against {want}")


def rel_err(a, b):
    scale = max(float(b.abs().max()), 1e-300)
    return float((a - b).abs().max()) / scale, float((a - b).abs().max())


def live_bytes(esize: int, values: int, ints: int = 0) -> int:
    """Bytes a kernel must move: ``values`` live pool elements of
    ``esize`` bytes and ``ints`` int32 table entries, each counted once.
    The callers count live data only: the padding of the pools (their
    size classes) and of the item tables (powers of two) is never read."""
    return esize * int(values) + 4 * int(ints)


def live_items(cum) -> int:
    """Rows of an item table that own tasks (the pad rows own none)."""
    return int(np.count_nonzero(np.diff(np.asarray(cum, np.int64)) > 0))


def item_ints(cum, ncol: int) -> int:
    """int32 entries of an item table's live rows and their prefix sums."""
    n = live_items(cum)
    return n * ncol + n + 1


def bound_ms(n_bytes: float, flops: float):
    """(least time in ms, what bounds it) on an H100 SXM at 700 W."""
    tb, tf = n_bytes / HBM_BPS, flops / PEAK_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    import scipy
    print(f"[1 device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  python {sys.version.split()[0]}  "
          f"scipy {scipy.__version__}", flush=True)


def _kernel_source_name(mangled: str):
    """(kernel name, the mangled text after it) of a mangled entry name:
    the source name ending in _kernel or _stageN that its template
    arguments follow, found through its Itanium length prefix (so the
    digits of a hashed anonymous namespace or of the name itself, as in
    place_v3_kernel, do not mislead it); None when there is none."""
    for m in re.finditer(r"(?:_kernel|_stage\d)(?=I)", mangled):
        e = m.end()
        for n in range(len(m.group()) + 1, e):
            ident = mangled[e - n:e]
            if mangled[:e - n].endswith(str(n)) and \
                    re.fullmatch(r"[a-z][a-z0-9_]*", ident):
                return ident, mangled[e:]
    return None


def ptxas_usage(log: str):
    """(kernel<type,T>, registers, spill line) per entry function of a
    ptxas -v log."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            src = _kernel_source_name(name)
            # value type: d / f, or cplx<d / f> of the same anonymous
            # namespace (mangled NS_4cplxI.EE)
            # and an int or bool second argument (Li128E, Lb1E)
            k = src and re.match(r"I(?:NS_4cplxI([df])EE|([df]))"
                                 r"(?:L(?:i(\d+)|b([01]))E)?", src[1])
            if k:
                real = "double" if (k.group(1) or k.group(2)) == "d" \
                    else "float"
                vt = f"complex<{real}>" if k.group(1) else real
                arg = k.group(3) or {"0": "false", "1": "true",
                                     None: ""}[k.group(4)]
                name = f"{src[0]}<{vt}{',' + arg if arg else ''}>"
            spill = ""
        elif "spill stores" in ln:
            spill = ln.strip()
        else:
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                out.append((name, int(m.group(1)), spill))
                name = None
    return out


def phase_build():
    from block2_preview_tpu_torch.ops import _kernels
    t0 = time.time()
    dt = _kernels.build()
    _kernels.lib()
    print(f"[2 build] nvcc sm_90a {dt:.1f} s (load {time.time() - t0:.1f} s)"
          f" -> {_kernels.library_path().name}", flush=True)
    log = _kernels.build_log or (_kernels.BUILD_DIR / "build.log").read_text()
    usage = ptxas_usage(log)
    if not usage:
        fail("no ptxas register report in the build log")
    for name, regs, spill in usage:
        if name.startswith(("chain_", "blk_kernel", "noise_",
                            "tiled_kernel", "bucket_", "slab_", "mix_gather",
                            "tblk_", "place_", "mix_v2",
                            "skinny_", "tall_", "reduce_", "plan_exec",
                            "probe_", "mix_kernel", "diag_kernel")) or \
                not spill.startswith("0 bytes stack"):
            print(f"    ptxas {name}: {regs} registers; {spill}", flush=True)


def mid_site(mpo, mps, t):
    """Host environments (backend="numpy" blocking) around the two-site
    center t of a given MPS, and its effective-Hamiltonian spaces."""
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu_torch.dmrg.environment import MovingEnvironment
    me = MovingEnvironment(mpo, mps)
    for s in range(mpo.n_sites - 1, t + 1, -1):
        me.update_right(s)
    for s in range(t):
        me.update_left(s)
    return me, EffectiveHamiltonian2(me, t, assemble=False)


def wide_system(L: int = 16, D: int = 1000):
    """Hubbard-L (U=2, t=1, half filling) MPO and a random MPS of bond
    dimension D.  At L=16, D=1000 the mid-chain center's p90 block
    dimension is 192, so K1 runs with T=128 tiles there (the D>=500 QC
    regime); the Hubbard MPO keeps the host environments cheap."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    return mpo, drv.get_random_mps(D, seed=13)


def _index_add_call(plan, tdt, device):
    """K4's function as one PyTorch call, res.index_add_(0, dst, out[src]),
    on element index lists built from the plan's windows (the yardstick
    only; the port never calls it)."""
    import torch
    w = plan.pit[plan.pit[:, 5] > 0].astype(np.int64)
    n = w[:, 5] * w[:, 6]
    wi = np.repeat(np.arange(len(w)), n)
    o = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    r, c = o // w[wi, 6], o % w[wi, 6]
    src = torch.as_tensor(w[wi, 0] + r * w[wi, 1] + c, device=device)
    dst = torch.as_tensor(w[wi, 2] + r * w[wi, 3] + c * w[wi, 4],
                          device=device)

    def call(o):
        res = torch.zeros(plan.ncap_out + 1, dtype=tdt, device=device)
        return res.index_add_(0, dst, o[src])
    return call


def site_mix_inputs(mpo, me, eff, t):
    """Per side ("lw", "rw") of center t of the host environments ``me``:
    (env meta, host env pool (f64), the mix-plan builders' positional
    arguments, their keyword arguments) — the inputs ResidentSite gives
    the mix."""
    from block2_preview_tpu_torch.ops.stacked import env_pool
    tk = eff.target
    kw = {"lw": dict(bond_is_first=True, join_on_input=True,
                     active={q for (q, _) in eff.bra_space.keys},
                     fused_ket=eff.ket_space.fl,
                     active_ket={q for (q, _) in eff.ket_space.keys}),
          "rw": dict(bond_is_first=False, join_on_input=False,
                     comp_target=tk, comp_target_ket=tk,
                     active={q for (_, q) in eff.bra_space.keys},
                     fused_ket=eff.ket_space.fr,
                     active_ket={q for (_, q) in eff.ket_space.keys})}
    envs = {"lw": (me.left_envs[t], mpo.bond_dqs[t], mpo.tensors[t],
                   mpo.site_quanta[t], eff.bra_space.fl),
            "rw": (me.right_envs[t + 2], mpo.bond_dqs[t + 2],
                   mpo.tensors[t + 1], mpo.site_quanta[t + 1],
                   eff.bra_space.fr)}
    out = {}
    for side, (env, dqs, ent, quanta, fused) in envs.items():
        meta, pool = env_pool(env, dqs, np.float64)
        out[side] = (meta, pool, (meta, ent, quanta, fused),
                     dict(group=mpo.group, out_bond_dqs=mpo.bond_dqs[t + 1],
                          **kw[side]))
    return out


def phase_kernels(device, mpo, mps, t, tile=None, blk_tile=None, site=None):
    """K1-K6 against their twins at site t; returns the summary rows.
    With ``tile`` set, the matvec plan must pick that K1 tile size;
    ``blk_tile`` sets the blocking plans' tile size (K5's instance);
    ``site`` is mid_site(mpo, mps, t) when the caller has built it."""
    import torch
    from block2_preview_tpu_torch.ops import blockv2, mixv4, resident, tilev2
    from block2_preview_tpu_torch.ops.stacked import env_pool, site_pools
    me, eff = site or mid_site(mpo, mps, t)
    tk = eff.target
    g = mpo.group
    plans, host_pools, metas = {}, {}, {}
    for side, (meta, pool, args, kws) in site_mix_inputs(mpo, me, eff,
                                                         t).items():
        metas[side], host_pools[side] = meta, pool
        plans[side] = resident.build_mix_plan_v4(*args, **kws)
    pl, pr = plans["lw"], plans["rw"]
    ex = tilev2.MatvecV2(eff.ket_space, pl.meta_out, pr.meta_out, g, tk,
                         dtype=np.float64, bra_space=eff.bra_space)
    s = ex.struct
    if tile is not None and s["T"] != tile:
        fail(f"site {t}: K1 plan picked T={s['T']}, expected {tile}")
    dv = ex.to_device(device)
    xh = ex.pad(np.random.default_rng(5).standard_normal(eff.size))
    ds = resident.build_diag_struct(eff.ket_space, pl.meta_out, pr.meta_out,
                                    s["T"], s["nt2"], s["sig_idx"])
    dd = resident.diag_tables(ds, device)
    dp = resident.diag_plain_tables(ds, device)
    # blocking steps next to the center: left t -> t+1 (from the bond-t
    # pool) and right t+1 -> t+1 (from the bond-(t+2) pool), each as the
    # v3 plan the sweep runs and as the v2 (entry fan-out) form
    blk = {}
    for direction, bond, st in (("left", t, t), ("right", t + 2, t + 1)):
        env = me.left_envs[bond] if direction == "left" \
            else me.right_envs[bond]
        meta, pool = env_pool(env, mpo.bond_dqs[bond], np.float64)
        for mix in (True, False):
            blk[(direction, mix)] = (blockv2.build_blocking_v2(
                meta, mpo.tensors[st], mpo.site_quanta[st], mps.tensors[st],
                mps.tensors[st], g, direction,
                mpo.bond_dqs[bond], mpo.bond_dqs[t + 1], T=blk_tile,
                gemm_mix=mix), pool, meta.total)
    noise = {"lw": resident.NoisePlan(eff.ket_space, pl.meta_out, g, "lw",
                                      s["T"], s["psi_idx"]),
             "rw": resident.NoisePlan(eff.ket_space, pr.meta_out, g, "rw",
                                      s["T"], None)}
    rows = {}
    for dtype, tol in ((np.float64, F64_TOL), (np.float32, F32_TOL)):
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        acc = rows if dtype == np.float64 else None   # the JSON row: f64
        pools = {}
        for side, plan in plans.items():
            ep = torch.as_tensor(host_pools[side], dtype=tdt, device=device)
            d = mixv4.plan_tables(plan, device, tdt)
            otp = mixv4._cap_class(plan.out_total + 1)
            o_t = k3_row(acc, dtype, side, tol, device, ep, d,
                         mixv4.plan_host(plan), plan.it, otp + 1,
                         metas[side].total + 1)

            def slab(fill=None, plan=plan):
                n = plan.ncap_out + 1
                if fill is None:
                    return torch.empty(n, dtype=tdt, device=device)
                return torch.full((n,), fill, dtype=tdt, device=device)

            def k4(fn, d=d, o=o_t[:otp]):
                # K4 writes the whole slab; its twin adds into zeros
                return fn(o, d, slab() if fn is mixv4.place_exec
                          else slab(0.0))

            # from a slab of NaNs: K4 must write every element
            s_k = mixv4.place_exec(o_t[:otp], d, slab(float("nan")))
            s_t = k4(mixv4.place_twin)
            # K3 into an OUT of NaNs, then K4: nothing unwritten is read
            o_n = mixv4.mix_exec(ep, d["wpool"], d, torch.full(
                (otp + 1,), float("nan"), dtype=tdt, device=device))
            if not torch.equal(
                    mixv4.place_exec(o_n[:otp], d, slab(float("nan"))),
                    mixv4.place_twin(o_n[:otp], d, slab(0.0))):
                fail(f"K3 -> K4 {side}: the slab from an OUT of NaNs is "
                     f"not the plain version's")
            lib = _index_add_call(plan, tdt, device)
            s_l = lib(o_t[:otp])
            if not torch.equal(s_l, s_t) or not torch.equal(s_k, s_t):
                fail(f"K4 {side}: kernel, twin and index_add_ not bitwise "
                     f"equal")
            n_live = int(plan.pit[:, 5].astype(np.int64)
                         @ plan.pit[:, 6].astype(np.int64))
            n_win = live_items(plan.pcum)
            fill_ms = time_ms(lambda: slab(0.0), device, ROW_REPS)
            # K4 writes the slab (ncap_out + 1) and reads each live
            # element once, a pit row (7 of its 8 fields) and a wend and
            # a wbeg entry a window
            _check(acc, "K4_place", dtype, side, s_k, s_t, tol,
                   time_ms(lambda: k4(mixv4.place_exec), device, ROW_REPS),
                   time_ms(lambda: k4(mixv4.place_twin), device, ROW_REPS),
                   time_ms(lambda: lib(o_t[:otp]), device, ROW_REPS),
                   live_bytes(o_t.element_size(),
                              plan.ncap_out + 1 + n_live, 9 * n_win), 0.0,
                   f"windows {n_win} live {n_live} slab {plan.ncap_out + 1}"
                   f"; a zero fill of it alone {fill_ms:.3f} ms; bitwise "
                   f"from NaNs")
            pools[side] = s_t
        xp = torch.as_tensor(xh, dtype=tdt, device=device)

        def k1(fn):
            return fn(xp, pools["lw"], pools["rw"], dv, s["T"], s["nt2"])

        y_k = k1(tilev2.mv_exec)
        ch = dv["chain"]
        n_live, n_ent = ch["items"].shape[0], ch["ent"].shape[0]
        _check(acc, "K1_matvec", dtype, "", y_k, k1(tilev2.mv_twin), tol,
               time_ms(lambda: k1(tilev2.mv_exec), device),
               time_ms(lambda: k1(tilev2.mv_twin), device), None,
               # psi, LW, RW in; sigma out; the chain tables K1 reads: the
               # live items (8 fields), the entries (2), the chunks (4)
               live_bytes(xp.element_size(),
                          eff.size + pl.meta_out.total + pr.meta_out.total
                          + eff.bra_space.size,
                          8 * n_live + 2 * n_ent + 4 * ch["n_chunks"]),
               float(s["flops"]),
               f"T {s['T']} items {s['it'].shape[0]} live {n_live} "
               f"entries {n_ent} chunks {ch['n_chunks']} units "
               f"{dv['n_units']} size {eff.size} GFLOP "
               f"{s['flops'] / 1e9:.2f}")
        if dtype == np.float64:
            h = tilev2.k1_host(s)
            print(f"[3 kernels] K1 site {t} (plan T {s['T']}): order "
                  f"tables built in {h['seconds'] * 1e3:.1f} ms; "
                  f"{chain_shapes(h['items'], h['ck'])}",
                  flush=True)

        def k2(fn):
            return fn(pools["lw"], pools["rw"],
                      dp if fn is resident.diag_twin else dd)

        # K2 reads the diagonals it needs, each once (the M0 symbols' of
        # every LW sector (qL, qL) and RW sector (qR, qR) of a live pair),
        # its rows and symbol list; it writes the flat diagonal [sizb_p]
        rows2, m0 = ds["k2"].astype(np.int64), len(ds["k2m"])
        live2 = rows2[rows2[:, 1] > 0]
        n_diag = m0 * int(np.unique(live2[:, [7, 1]], axis=0)[:, 1].sum()
                          + np.unique(live2[:, [8, 2]], axis=0)[:, 1].sum())
        k2_flops = 2.0 * m0 * float((live2[:, 4] * live2[:, 6]).sum())
        k2_bytes = live_bytes(xp.element_size(),
                              n_diag + ds["sig_idx"].shape[0],
                              9 * len(rows2) + 2 * m0)
        d_k = k2(resident.diag_exec)
        _check(acc, "K2_diag", dtype, "", d_k, k2(resident.diag_twin), tol,
               time_ms(lambda: k2(resident.diag_exec), device),
               time_ms(lambda: k2(resident.diag_twin), device), None,
               k2_bytes, k2_flops,
               f"{k2_bytes / 1e6:.2f} MB, {k2_flops / 1e9:.4f} GFLOP; rows "
               f"{len(live2)} zero rows {len(rows2) - len(live2)} "
               f"symbols {m0} outputs {int((live2[:, 4] * live2[:, 6]).sum())}"
               f" of {ds['sig_idx'].shape[0]}")
        if device.type == "cuda":
            _bitwise("K2", "", lambda: k2(resident.diag_exec))

        for (direction, mix), (plan, pool, e_total) in blk.items():
            rp = plan.rot if mix else plan
            ep = torch.as_tensor(pool, dtype=tdt, device=device)
            bp, kp = site_pools(rp, device, tdt)
            d5 = blockv2.blk_tables(rp, device, tdt)
            # env, bra and ket values in, the live output out (the ROT
            # pool for v3); K5's tables and the live entries' ef rows with
            # their coefficients
            out_total = plan.rot_total if mix else plan.meta_out.total
            n_ent = live_items(rp.cum3)
            k5_bytes = live_bytes(
                ep.element_size(),
                e_total + 1 + bp.numel() + kp.numel() + n_ent + out_total,
                k5_ints(rp._dev["k5"], n_ent))

            def k5(fn, ep=ep, bp=bp, kp=kp, d5=d5, rp=rp):
                return fn(ep, bp, kp, d5, rp.T, rp.left,
                          torch.zeros(rp.ncap, dtype=tdt, device=device))

            o_k, o_t = k5(blockv2.blk_exec), k5(blockv2.blk_twin)
            tag = f"{direction[0]}{3 if mix else 2}"
            _check(acc, "K5_block", dtype, tag, o_k, o_t, tol,
                   time_ms(lambda: k5(blockv2.blk_exec), device),
                   time_ms(lambda: k5(blockv2.blk_twin), device), None,
                   k5_bytes, rp.flops,
                   f"T {rp.T} items {live_items(rp.cum1)} units "
                   f"{d5['n_units']} entries {n_ent} out {out_total} "
                   f"GFLOP {rp.flops / 1e9:.2f}; {k5_shape(rp)}")
            if mix and device.type == "cuda":
                _bitwise("K5", tag, lambda: k5(blockv2.blk_exec))
            if float(o_k[out_total:].abs().max()) != 0.0:
                fail(f"K5 {tag}: nonzero sentinel slots")
            if mix:
                full = blockv2.execute_blocking_v3(plan, ep)
                d3 = blockv2.mix_tables(plan, device, tdt)
                ref = k3_row(acc, dtype, tag, tol, device, o_t, d3,
                             blockv2.mix_host(plan), plan.gtab["it"],
                             plan.ncap, plan.rot_total + 1)
                rel, _ = rel_err(full, ref)
                if not rel <= tol:
                    fail(f"blocking v3 {tag}: rel err {rel:.3e} > {tol:.0e}")
        for side, npl in noise.items():
            d6, dt6 = npl.tables(device), npl.twin_tables(device)
            wp = pools[side]
            xs = xp

            def k6(fn, d6=d6, wp=wp, npl=npl):
                return fn(xs, wp, d6, npl.T)

            # psi and the LW (RW) pool in, the live rho tiles out; the
            # live item rows
            n_rho = sum(na * na for (_, na, _) in npl.sectors.values())
            k6_bytes = live_bytes(
                xs.element_size(),
                eff.size + plans[side].meta_out.total + n_rho * npl.T ** 2,
                item_ints(npl.cum1, npl.it.shape[1]))
            r_k = k6(resident.noise_exec)
            _check(acc, "K6_noise", dtype, side, r_k,
                   resident.noise_twin(xs, wp, dt6, npl.T), tol,
                   time_ms(lambda: k6(resident.noise_exec), device),
                   time_ms(lambda: resident.noise_twin(xs, wp, dt6, npl.T),
                           device), None,
                   k6_bytes, npl.flops, k6_shape(npl, xs.element_size()))
            if device.type == "cuda":
                _bitwise("K6", side, lambda: k6(resident.noise_exec))
    return summary_rows(rows)


def k3_row(acc, dtype, side, tol, device, ep, d, h, it, n_out, e_live):
    """One K3 row of phase 3: the kernel against its twin on the env (or
    ROT) pool ``ep`` with device tables ``d`` and host tables ``h``
    (mixv4.k3_host_tables) into OUT buffers of ``n_out`` elements, timed
    into an unfilled buffer (what execute_mix_v4 and execute_blocking_v3
    allocate); on the card also bitwise over two launches and, into an
    OUT of NaNs, bitwise the OUT from zeros below ``d["zlim"]`` (K3
    writes every element OUT's reader reads).  Returns the twin's OUT."""
    import torch
    from block2_preview_tpu_torch.ops import mixv4

    def k3(fn, fill=0.0):
        out = (torch.empty(n_out, dtype=ep.dtype, device=device)
               if fill is None else
               torch.full((n_out,), fill, dtype=ep.dtype, device=device))
        return fn(ep, d["wpool"], d, out)

    o_k, o_t = k3(mixv4.mix_exec), k3(mixv4.mix_twin)
    it = np.asarray(it, np.int64)
    live = it[:, 2] > 0
    # K3 reads the env pool, each item's W rows (nw x wstride from wbase)
    # and its tables; it writes the elements its GEMM blocks cover (the
    # zero ranges are not the function's output)
    w_live = int((it[:, 0] + it[:, 2] * it[:, 1])[live].max())
    kt, kl, kz = h["kt"], h["kl"], h["kz"]
    n_zt = int(np.count_nonzero(kt[:, 0] < 0))
    n_bytes = live_bytes(ep.element_size(), e_live + w_live + h["written"],
                         kt.size + kl.size + kz.size)
    _check(acc, "K3_mix", dtype, side, o_k, o_t, tol,
           time_ms(lambda: k3(mixv4.mix_exec, None), device),
           time_ms(lambda: k3(mixv4.mix_twin), device), None,
           n_bytes, h["flops_nz"],
           f"{n_bytes / 1e6:.1f} MB; items {int(live.sum())} tiles "
           f"{len(kt) - n_zt} (+{n_zt} zero "
           f"tiles, {len(kz)} gaps) slices {h['steps']} written "
           f"{h['written']} zeros {h['zeros']} GFLOP {h['flops'] / 1e9:.3f}"
           f" dense, {h['flops_nz'] / 1e9:.3f} on W's non-zeros; host "
           f"tables {h['seconds'] * 1e3:.1f} ms")
    if device.type == "cuda":
        _bitwise("K3", side, lambda: k3(mixv4.mix_exec))
        lim = int(d["zlim"])
        if not torch.equal(k3(mixv4.mix_exec, float("nan"))[:lim],
                           o_k[:lim]):
            fail(f"K3 {side}: the OUT from NaNs is not the OUT from zeros "
                 f"below {lim}")
    return o_t


def summary_rows(rows):
    """The JSON rows of the kernels in ``rows`` (f64 sums of _check), in
    kernel order; main fills in the launches of the main-path run."""
    from block2_preview_tpu_torch.ops._kernels import KERNELS
    out = []
    for name, info in KERNELS.items():
        if name not in rows:
            continue
        r = rows[name]
        b_ms = max(r["bytes_ms"], r["flops_ms"])
        out.append({"name": name, "route": info.route,
                    "source": info.source, "replaces": info.replaces,
                    "launches": 0, "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": b_ms,
                    "bound_by": ("bytes" if r["bytes_ms"] >= r["flops_ms"]
                                 else "operations"),
                    "library_ms": r["library_ms"]})
    return out


def _check(rows, name, dtype, side, got, ref, tol, ms, plain_ms, lib_ms,
           n_bytes, flops, shape):
    """Print and hold one kernel row to ``tol``; unless ``rows`` is None,
    sum the row into the kernel's JSON row there."""
    import torch
    if got.is_cuda:
        torch.cuda.synchronize()
    rel, mabs = rel_err(got, ref)
    tag = {np.float64: "f64", np.float32: "f32", np.complex128: "c128",
           np.complex64: "c64"}[dtype]
    b_ms, b_by = bound_ms(n_bytes, flops)
    lib = "" if lib_ms is None else f"  library {lib_ms:.3f} ms"
    n = getattr(ms, "launches", 0)
    per = f" ({n} launch{'es' if n != 1 else ''} a call, " \
        f"{ms / max(n, 1):.4f} ms a launch)"
    print(f"[3 kernels] {name:9s} {tag} {side:3s} rel {rel:.2e} "
          f"abs {mabs:.2e}  kernel {ms:.3f} ms{per}  twin {plain_ms:.3f} "
          f"ms{lib}  bound {b_ms:.4f} ms ({b_by})  ({shape})", flush=True)
    if not rel <= tol:
        fail(f"{name} {tag} {side}: rel err {rel:.3e} > {tol:.0e}")
    if rows is not None:
        r = rows.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                   "plain_ms": 0.0, "library_ms": None,
                                   "bytes_ms": 0.0, "flops_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], mabs)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        r["bytes_ms"] += n_bytes / HBM_BPS * 1e3
        r["flops_ms"] += flops / PEAK_FLOPS * 1e3


def copy_mps(mps):
    """A copy of a port MPS whose site blocks are new arrays."""
    from block2_preview_tpu_torch.dmrg.mps import MPS, MPSTensor
    return MPS(mps.info, [MPSTensor(t.group, {k: v.copy() for k, v in
                                              t.blocks.items()})
                          for t in mps.tensors], center=mps.center)


def sigma_bytes_flops(eff, dtype):
    """Least bytes and FLOPs of one sigma matvec on ``eff`` in ``dtype``, at
    the true block shapes (no tile padding): every LW/RW matrix that a
    triple reads, psi in and sigma out, each once; the products of the
    triples (2 a k n + 2 a n p each, x4 for complex)."""
    from block2_preview_tpu_torch.dmrg.sweep import _eff_flops
    dtype = np.dtype(dtype)
    lw = {(m, lk) for (m, lk, _, _, _) in eff.triples}
    rw = {(m, rk) for (m, _, _, rk, _) in eff.triples}
    n = (sum(eff.LW[m][k].size for m, k in lw)
         + sum(eff.RW[m][k].size for m, k in rw) + 2 * eff.size)
    flops = _eff_flops(eff) * (4 if dtype.kind == "c" else 1)
    return dtype.itemsize * n, flops


def host_davidson1(mpo, mps, t):
    """Phase 3's host reference of the tiled Davidson, for a worker: the
    host Davidson's lowest root on matvec_np at center t of ``mps`` from
    the MPS guess, |r|^2 < 1e-12: (theta, matvecs, seconds)."""
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu_torch.ops.davidson import davidson
    eff = EffectiveHamiltonian2(mid_site(mpo, mps, t)[0], t)
    x0 = eff.flatten(eff.initial_guess())
    x0 /= np.linalg.norm(x0)
    t0 = time.time()
    w, _, nmv = davidson(eff.matvec_np, eff.diagonal(), x0[:, None],
                         n_roots=1, conv_thrd=1e-12)
    return float(w[0]), nmv, time.time() - t0


def phase_tiled(device, me, t, complex_me=None, davidson=True, eff=None,
                host1=None):
    """K7 against its twin at center t of the host environments ``me``
    (``eff``: its assembled two-site operator when the caller has built
    it): f64 and f32, complex128 and complex64 on the same operators cast
    to complex (a seeded complex vector), and complex128 on the complex
    environments ``complex_me`` (the state phase 6b leaves).  With
    ``davidson``, the tiled Davidson (K7) against the host Davidson on
    matvec_np (``host1``: :func:`host_davidson1`'s worker result at the
    same center; computed here without one).  Returns the summary row:
    the complex128 row on ``complex_me`` (the inputs phase 6b gives K7)
    when given, else f64."""
    import torch
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu_torch.ops import exec_bucket
    from block2_preview_tpu_torch.ops.davidson import davidson as host_dav
    from block2_preview_tpu_torch.ops.tiled import (TiledExecutor,
                                                    tiled_matvec)
    t0 = time.time()
    eff = eff if eff is not None else EffectiveHamiltonian2(me, t)
    cases = [(np.float64, eff, ""), (np.float32, eff, ""),
             (np.complex128, eff, ""), (np.complex64, eff, "")]
    if complex_me is not None:
        ceff = EffectiveHamiltonian2(complex_me, t)
        if ceff.dtype != np.complex128:
            fail(f"phase 6b left a {ceff.dtype} state, not complex128")
        cases.append((np.complex128, ceff, "6b"))
    print(f"[3 kernels] K7 site {t}: host LW/RW in {time.time() - t0:.1f} s",
          flush=True)
    summary_case = cases[-1] if complex_me is not None else cases[0]
    rng = np.random.default_rng(5)
    rows = {}
    for case in cases:
        dtype, e, side = case
        ex = TiledExecutor(e, dtype=dtype, device=device)
        x = rng.standard_normal(e.size)
        if ex.dtype.kind == "c":
            x = x + 1j * rng.standard_normal(e.size)
        xp = torch.as_tensor(ex.pad(x), device=device)
        dp = exec_bucket.plain_tables(ex.struct, device)

        def k7(fn, d):
            return fn(xp, ex.lpool, ex.rpool, d, ex.size_p)

        n_bytes, flops = sigma_bytes_flops(e, dtype)
        tab = exec_bucket.chain_tables(ex.struct)
        _check(rows if case is summary_case else None, "K7_tiled", dtype,
               side, k7(tiled_matvec, ex._dev),
               k7(exec_bucket.bucket_sigma_plain, dp), ATOMIC_TOL[dtype],
               time_ms(lambda: k7(tiled_matvec, ex._dev), device),
               time_ms(lambda: k7(exec_bucket.bucket_sigma_plain, dp),
                       device), None,
               n_bytes, flops,
               f"size {e.size} items {len(tab['items'])} entries "
               f"{len(tab['ent'])} chunks {len(tab['ck'])} struct "
               f"{ex.t_struct:.2f} s pack+upload {ex.t_pack:.2f} s tables "
               f"{ex.t_tables:.3f} s (built in {tab['seconds']:.3f} s) "
               f"true GFLOP {flops / 1e9:.2f}")
        ex.free()
    if davidson:
        x0 = eff.flatten(eff.initial_guess())
        x0 /= np.linalg.norm(x0)
        diag = eff.diagonal()
        t0 = time.time()
        ex = TiledExecutor(eff, dtype=np.float64, device=device)
        th, _, it = ex.solve_ground_state(x0, diag, conv_thrd=1e-12,
                                          max_iter=100)
        ex.free()
        t1 = time.time()
        if host1 is not None:
            w0, nmv, t_host = host1.get()
        else:
            w, _, nmv = host_dav(eff.matvec_np, diag, x0[:, None], n_roots=1,
                                 conv_thrd=1e-12)
            w0, t_host = float(w[0]), time.time() - t1
        d_th = th - w0
        print(f"[3 kernels] K7 Davidson site {t}: tiled {th:.12f} ({it} it, "
              f"{t1 - t0:.1f} s) host {w0:.12f} ({nmv} mv, {t_host:.1f} s"
              f"{' in a worker' if host1 is not None else ''}) dtheta "
              f"{d_th:.2e}", flush=True)
        if not abs(d_th) < 1e-8:
            fail(f"tiled Davidson |dtheta| {abs(d_th):.3e} >= 1e-8")
    return summary_rows(rows)


def _blocking_plans(mpo, mps, me, t):
    """The two blocking steps next to center t as host BlockingPlans with
    their inputs: left t -> t+1 from bond t, right t+1 -> t+1 from bond
    t+2 (the plans backend="torch_device" sends to K9)."""
    from block2_preview_tpu_torch.ops.blocking_plan import build_plan
    g = mpo.group
    out = {}
    for direction, st, env in (("left", t, me.left_envs[t]),
                               ("right", t + 1, me.right_envs[t + 2])):
        dq_out = (mpo.bond_dqs[t + 1] if direction == "left" else
                  [g.sub(mpo.bond_dqs[-1][0], dq)
                   for dq in mpo.bond_dqs[st]])
        out[direction] = (build_plan(env, mpo.tensors[st],
                                     mpo.site_quanta[st], mps.tensors[st],
                                     mps.tensors[st], dq_out, g, direction),
                          env, mps.tensors[st])
    return out


def plan_host_bytes(plans):
    """Host bytes the blocking plans keep: (their native arrays, K9's
    tables cached beside them, ops/blocking_device.py k9_tables)."""
    nat = k9 = 0
    for plan in plans:
        for k, v in plan.native.items():
            if k == "k9":
                k9 += sum(a.nbytes for a in v.values()
                          if isinstance(a, np.ndarray))
            elif isinstance(v, np.ndarray):
                nat += v.nbytes
    return nat, k9


def k9_bytes_flops(plan, esize):
    """Least bytes and FLOPs of one blocking plan: the env, bra and ket
    pools in and the output out, each once, and K9's tables once (an env
    offset and a coefficient a contribution, six ints a sub-group, eight a
    chunk; ops/blocking_device.py k9_tables); the FLOPs of the product
    contribution by contribution, 2 (dl dk dy + dx dl dy) each, and of
    the grouped form (E summed first over the contributions of one output,
    bra and ket block: that count a sub-group plus 2 dl dk a
    contribution).  Returns (bytes, the smaller FLOP count, per
    contribution, grouped)."""
    from block2_preview_tpu_torch.ops.blocking_device import k9_tables
    nat = plan.native
    dl, dx, dk, dy = (nat[k].astype(np.int64) for k in ("dl", "dx", "dk",
                                                         "dy"))
    n = len(dl)
    tab = k9_tables(plan)
    values = (plan.env_sizes[1] + plan.bra_sizes[1] + plan.ket_sizes[1]
              + plan.total_out + n)
    each = 2.0 * float((dl * dk * dy + dx * dl * dy).sum())
    grouped = float(tab["flops"])
    return (live_bytes(esize, values, n + tab["sg"].size + tab["ck"].size),
            min(each, grouped), each, grouped)


def davidson3(eff, matvec):
    """The host Davidson's three lowest roots of ``eff`` around ``matvec``
    to |r|^2 < 1e-12, from the sweep's start (the MPS guess and two
    RandomState(7) columns): (roots, matvecs, seconds)."""
    from block2_preview_tpu_torch.ops.davidson import davidson
    x0 = np.concatenate([eff.flatten(eff.initial_guess())[:, None],
                         np.random.RandomState(7).standard_normal(
                             (eff.size, 2))], axis=1)
    x0 /= np.linalg.norm(x0, axis=0)
    t0 = time.time()
    w, _, nmv = davidson(matvec, eff.diagonal(), x0, n_roots=3,
                         conv_thrd=1e-12)
    return w, nmv, time.time() - t0


def host_davidson3(mpo, mps, t):
    """:func:`davidson3` on the host matvec at center t of ``mps``."""
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    eff = EffectiveHamiltonian2(mid_site(mpo, mps, t)[0], t)
    return davidson3(eff, eff.matvec_np)


def phase_bucket(device, mpo, mps, me, eff, t, summary=True, kinds="all",
                 host3=None):
    """K8 (f64, f32) unless ``kinds`` is "K9", and K9 (left and right, f64
    and f32) unless it is "K8", against their twins at center t (host
    environments ``me``, its assembled operator ``eff``), and with
    ``kinds`` "all" a three-root host Davidson around K8 against the host
    Davidson on matvec_np (``host3``: that result of
    :func:`host_davidson3` when the caller has it).  Returns the summary
    rows of the f64 cases (none unless ``summary``)."""
    import torch
    from block2_preview_tpu_torch.ops import blocking_device, exec_bucket
    from block2_preview_tpu_torch.ops.blocking_plan import _pools
    rows = {}
    rng = np.random.default_rng(5)
    it = None
    for dtype in (np.float64, np.float32):
        acc = rows if summary and dtype == np.float64 else None
        if kinds != "K9":
            ex = exec_bucket.BucketExecutor(eff, dtype=dtype, device=device)
            st = ex.struct
            it = st["items"]
            xp = torch.as_tensor(ex.pad(rng.standard_normal(eff.size)),
                                 device=device)
            dp = exec_bucket.plain_tables(st, device)

            def k8(fn, d):
                return fn(xp, ex.lpool, ex.rpool, d, ex.size_p)

            n_bytes, flops = sigma_bytes_flops(eff, dtype)
            # the products _round_dim's buckets would multiply, padding
            # included
            pad_flops = sum(
                2.0 * (hi - lo) * a * n * (k + p)
                for (a, k, n, p), lo, hi in zip(
                    st["keys"], st["bounds"][:-1], st["bounds"][1:]))
            _check(acc, "K8_bucket", dtype, "",
                   k8(exec_bucket.bucket_sigma, ex._dev),
                   k8(exec_bucket.bucket_sigma_plain, dp), ATOMIC_TOL[dtype],
                   time_ms(lambda: k8(exec_bucket.bucket_sigma, ex._dev),
                           device),
                   time_ms(lambda: k8(exec_bucket.bucket_sigma_plain, dp),
                           device), None, n_bytes, flops,
                   f"size {eff.size} items {len(it)} buckets "
                   f"{len(st['keys'])} chunks {ex._dev.get('n_chunks', 0)} "
                   f"struct "
                   f"{ex.t_struct:.2f} s "
                   f"pack+upload {ex.t_pack:.2f} s tables "
                   f"{ex._dev.get('seconds', 0.0) * 1e3:.1f} ms GFLOP "
                   f"{flops / 1e9:.2f} (bucket-padded "
                   f"{pad_flops / 1e9:.2f})")
            if dtype == np.float64:
                dk = exec_bucket.kernel_tables(st, "cpu")
                its = dk["items"].numpy()
                print(f"[3 kernels] K8 site {t}: item dims a "
                      f"{histogram(its[:, 1])}; k {histogram(its[:, 2])}; n "
                      f"{histogram(its[:, 4])}; "
                      f"p {histogram(its[:, 6])}; "
                      f"{chain_shapes(its, dk['ck'].numpy())}",
                      flush=True)
            ex.free()
        if kinds == "K8":
            continue
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        for direction, (plan, env, T) in _blocking_plans(
                mpo, mps, me, t).items():
            left = direction == "left"
            pools = [torch.as_tensor(p, device=device)
                     for p in _pools(plan, env, T, T, np.dtype(dtype))]
            dq = blocking_device.plain_tables(plan, device, tdt)
            dk = (blocking_device.kernel_tables(plan, device, tdt)
                  if device.type == "cuda" else dq)

            def k9(fn, d, left=left, pools=pools, plan=plan):
                return fn(*pools, d, left, torch.zeros(
                    plan.total_out + 1, dtype=tdt, device=device))

            n_bytes, flops, each, grouped = k9_bytes_flops(
                plan, pools[0].element_size())
            tab = blocking_device.k9_tables(plan)
            held = plan_host_bytes([plan])
            _check(acc, "K9_bucket_blocking", dtype, direction[0],
                   k9(blocking_device.bucket_blocking, dk),
                   k9(blocking_device.bucket_blocking_plain, dq),
                   ATOMIC_TOL[dtype],
                   time_ms(lambda: k9(blocking_device.bucket_blocking, dk),
                           device),
                   time_ms(lambda: k9(blocking_device.bucket_blocking_plain,
                                      dq), device), None,
                   n_bytes, flops,
                   f"contributions {len(plan.native['dl'])} groups "
                   f"{tab['n_groups']} sub-groups {len(tab['sg'])} chunks "
                   f"{len(tab['ck'])} (atomic "
                   f"{int(tab['ck'][:, 7].sum())}) out {plan.total_out} "
                   f"GFLOP {each / 1e9:.3f} contribution by contribution, "
                   f"{grouped / 1e9:.3f} grouped; tables "
                   f"{tab['seconds']:.3f} s, host {held[1] / 2 ** 20:.1f} "
                   f"MiB beside the plan's {held[0] / 2 ** 20:.1f} MiB")
            if dtype == np.float64:
                sg = tab["sg"].astype(np.int64)
                dx = plan.native["dx"][plan.native["grp_starts"][:-1]]
                e = (2, 4, 8, 16, 32)
                print(f"[3 kernels] K9 site {t} {direction}: sub-group "
                      f"dims dl {histogram(sg[:, 4], e)}; dk "
                      f"{histogram(sg[:, 5], e)}; output dx "
                      f"{histogram(dx, e)}; contributions a sub-group "
                      f"{histogram(sg[:, 1] - sg[:, 0], (1, 4, 16, 64))}; "
                      f"sub-groups a chunk "
                      f"{histogram(np.diff(tab['ck'][:, :2]), (1, 4, 16))}",
                      flush=True)
    if kinds != "all":
        return summary_rows(rows)
    # three roots: the host Davidson around K8 against the host matvec
    ex = exec_bucket.BucketExecutor(eff, dtype=np.float64, device=device)
    w, nmv, secs = davidson3(eff, ex.matvec)
    ex.free()
    w_h, nmv_h, secs_h = host3 or davidson3(eff, eff.matvec_np)
    d_th = np.abs(w - w_h).max()
    print(f"[3 kernels] K8 Davidson site {t}, 3 roots: "
          f"{' '.join(f'{x:.12f}' for x in w)} ({nmv} mv, {secs:.1f} s) "
          f"host {' '.join(f'{x:.12f}' for x in w_h)} ({nmv_h} mv, "
          f"{secs_h:.1f} s) max dtheta {d_th:.2e}", flush=True)
    if not d_th < 1e-10:
        fail(f"3-root Davidson around K8: max |dtheta| {d_th:.3e} >= 1e-10")
    return summary_rows(rows)


def _stacked_plans(mpo, mps, me, t, T=None):
    """The two blocking steps next to center t (left t -> t+1 from bond t,
    right t+1 -> t+1 from bond t+2) as bucket-engine plans (K10 + K11) and
    v1 tiled plans (K12; tile ``T`` when given), with their source pools
    and the live size of each."""
    from block2_preview_tpu_torch.ops.stacked import (build_stacked_plan,
                                                      env_pool)
    from block2_preview_tpu_torch.ops.tiled_blocking import (
        build_tiled_blocking_plan)
    g = mpo.group
    out = {}
    for direction, bond, st in (("left", t, t), ("right", t + 2, t + 1)):
        env = me.left_envs[bond] if direction == "left" \
            else me.right_envs[bond]
        meta, pool = env_pool(env, mpo.bond_dqs[bond], np.float64)
        args = (meta, mpo.tensors[st], mpo.site_quanta[st], mps.tensors[st],
                mps.tensors[st], g, direction, mpo.bond_dqs[bond],
                mpo.bond_dqs[t + 1])
        out[direction] = (build_stacked_plan(*args),
                          build_tiled_blocking_plan(*args, T=T), pool,
                          meta.total)
    return out


def _mix_library_call(plan, device, tdt):
    """K11's function as one PyTorch call, out.index_add_(0, dst,
    res[src] * coef), on element index lists built from the plan's rows
    (the yardstick only; the port never calls it)."""
    import torch
    n = plan.tgt[:, 1] * plan.tgt[:, 2]
    ri = np.repeat(np.arange(len(n)), n)
    e = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    src = torch.as_tensor(plan.roff[plan.wsrc][ri] + e, device=device)
    dst = torch.as_tensor(plan.tgt[ri, 0] + e, device=device)
    cf = torch.as_tensor(plan.coef, dtype=tdt, device=device)[
        torch.as_tensor(ri, device=device)]

    def call(res):
        out = torch.zeros(plan.out_cap, dtype=res.dtype, device=device)
        return out.index_add_(0, dst, res[src] * cf)
    return call


def gather_shape(h, terms: str = "rows") -> str:
    """The mix core's work split on its host tables ``h``
    (ops/stacked.py core_tables): output blocks, terms (``terms``) a
    block, elements a block, the thresholds and the warps (units) of each
    kind."""
    from block2_preview_tpu_torch.ops import stacked
    rows = np.diff(h["bstart"])
    n_el = h["blk"][:, 2] * h["blk"][:, 3]
    small = n_el <= stacked.GATHER_SPLIT
    return (f"blocks {len(rows)} {terms} a block median "
            f"{int(np.median(rows)) if len(rows) else 0} max "
            f"{int(rows.max()) if len(rows) else 0}; elements a block "
            f"{histogram(n_el, (1, 4, 16, 32, 256, 1024))}; split <= "
            f"{stacked.GATHER_SPLIT} elements: {int(small.sum())} warps, "
            f"chunks of {stacked.GATHER_CHUNK}: "
            f"{len(h['units']) - int(small.sum())} warps")


def table_bytes(d) -> int:
    """Bytes of the device tensors in a table dict (one level of nesting)."""
    import torch
    n = 0
    for v in d.values():
        if isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
        elif isinstance(v, dict):
            n += table_bytes(v)
    return n


def slab_shape(plan) -> str:
    """K10's shapes on a stacked plan: works, the percentiles (50, 90,
    99, max) of each work's dl, dk, dx, dy, and works (symbols) an
    item."""
    f = plan.items[plan.work[:, 0]]
    pct = " ".join(
        f"{name} " + "/".join(str(int(v)) for v in np.percentile(
            f[:, col], (50, 90, 99, 100), method="higher"))
        for name, col in (("dl", 3), ("dk", 5), ("dx", 4), ("dy", 6)))
    per = np.bincount(plan.work[:, 0])
    per = per[per > 0]
    return (f"items {len(plan.items)} works {len(f)} (p50/p90/p99/max "
            f"{pct}; works an item median {int(np.median(per))} max "
            f"{int(per.max())})")


def _bitwise(name, side, fn):
    """Two launches of ``fn`` on the same inputs must give bitwise equal
    outputs (the kernel makes no atomics)."""
    import torch
    a, b = fn(), fn()
    if not torch.equal(a, b):
        fail(f"{name} {side}: two launches differ "
             f"({float((a - b).abs().max()):.3e})")


def k5_ints(h, n_ent: int) -> int:
    """int32 table entries K5 (or K21) reads with its tables ``h``
    (blockv2.k5_host_tables): a run header of 9, 3 an item of the slab
    path, 4 an entry (ef), and on the tile path an item row of 13 with its
    cumu and efs entries and a unit index."""
    return (9 * len(h["rh"]) + 3 * len(h["wt"]) + 4 * n_ent
            + 15 * len(h["large"]) + len(h["units"]))


def k5_shape(rp) -> str:
    """K5's two paths on the rotate (or v2) plan ``rp``: the slab path's
    runs and items, items a run and the runs' dims, the tile path's items
    and units, whether the plan stores (no atomics) and the tables' host
    seconds."""
    from block2_preview_tpu_torch.ops import blockv2
    t0 = time.perf_counter()
    h = blockv2.k5_host_tables(rp)
    secs = time.perf_counter() - t0
    rh = h["rh"].astype(np.int64)
    dims = rh[:, 4:8].max(axis=1) if len(rh) else np.zeros(0, np.int64)
    return (f"slab path: runs {len(rh)}, items {len(h['small'])} (a run: "
            f"{histogram(rh[:, 1] - rh[:, 0], (1, 2, 4, 7))}; largest dim "
            f"a run: {histogram(dims, (8, 16, 24, 32))}); tile path: items "
            f"{len(h['large'])}, units {len(h['units'])}; "
            f"{'stores' if h['excl'] else 'atomics'}; tables "
            f"{secs:.3f} s on the host")


def k6_shape(npl, esize: int) -> str:
    """K6's items, runs, CUDA blocks and partial pool (its size beside the
    x scratch pool of the earlier two-launch design) and the tables' host
    seconds."""
    h = npl.host_tables()
    nb = h["nb"].astype(np.int64)
    runs = len(np.unique(nb[:, 5]))
    mib = esize / 2 ** 20
    return (f"items {len(npl.pn)} sectors {len(h['ns'])} runs {runs} "
            f"blocks {len(nb)} (DB a block: "
            f"{histogram(nb[:, 2], (16, 32, 48, 64, 128))}); partial pool "
            f"{h['n_part']} elements ({h['n_part'] * mib:.2f} MiB; the x "
            f"scratch was {npl.n_x * npl.T ** 2 * mib:.1f} MiB); tables "
            f"{h['seconds']:.3f} s on the host")


def k10_check(acc, device, dtype, side, sp, ep, bp, kp, e_total, tol):
    """K10 against its twin on the bucket-engine plan ``sp`` (the env pool
    ``ep`` of ``e_total`` live elements, the site pools ``bp``, ``kp``), and
    bitwise against a second launch; one phase-3 row.  Returns the twin's
    res (its live part)."""
    import torch
    from block2_preview_tpu_torch.ops import stacked
    tdt, esz = ep.dtype, ep.element_size()
    t0 = time.perf_counter()
    dk = (stacked.slab_kernel_tables(sp, device) if device.type == "cuda"
          else stacked.slab_plain_tables(sp, device, tdt))
    t_tab = time.perf_counter() - t0
    dp = stacked.slab_plain_tables(sp, device, tdt)

    def k10(fn, d):
        # the zero fill of res is part of the timed call
        return fn(ep, bp, kp, d, sp.left, torch.zeros(
            sp.res_total + 1, dtype=tdt, device=device))

    r_k = k10(stacked.slab_exec, dk)[:sp.res_total]
    r_t = k10(stacked.slab_plain, dp)[:sp.res_total]
    # env, bra and ket values in, res out, K10's tables (an env offset a
    # work, nine ints a CUDA block)
    nw = len(sp.work)
    h10 = sp._dev.get("k10", {})
    n_ch = len(h10.get("ch", ()))
    _check(acc, "K10_slab", dtype, side, r_k, r_t, tol,
           time_ms(lambda: k10(stacked.slab_exec, dk), device),
           time_ms(lambda: k10(stacked.slab_plain, dp), device, reps=1),
           None, live_bytes(esz, e_total + 1 + bp.numel() + kp.numel()
                            + sp.res_total, nw + 9 * n_ch),
           sp.flops,
           f"{slab_shape(sp)}; CUDA blocks {n_ch}; res {sp.res_total} "
           f"({sp.res_total * esz / 2 ** 20:.1f} MiB) GFLOP "
           f"{sp.flops / 1e9:.3f}; tables {h10.get('seconds', 0.0):.3f} s "
           f"on the host, {t_tab:.3f} s with the upload")
    if device.type == "cuda":
        _bitwise("K10", side, lambda: k10(stacked.slab_exec, dk))
    return r_t


def phase_slab_wide(device, mpo, mps, me, t):
    """K10 alone (f64, both sides, :func:`k10_check`) on the bucket-engine
    plans next to center t: at the Hubbard-L16 D=1000 site its operands
    pass 32 x 32 elements, so the kernel reads them from the pools rather
    than from shared memory."""
    import torch
    from block2_preview_tpu_torch.ops import stacked
    for direction, (sp, _, pool, e_total) in _stacked_plans(
            mpo, mps, me, t).items():
        ep = torch.as_tensor(pool, device=device)
        bp, kp = stacked.site_pools(sp, device, ep.dtype)
        k10_check(None, device, np.float64, direction[0], sp, ep, bp, kp,
                  e_total, ATOMIC_TOL[np.float64])


def phase_k5_strips(device, mpo, mps, me, t, T=16):
    """K5 (and K21 over two ranks' shares) on the v3 rotate plans next to
    center t built at tile ``T``, f64: at the Hubbard-L16 D=1000 site the
    wide items take the tile path with three and more strips of l, which
    a block sums in order and stores (csrc/blocking.cuh, kOwn).  Against
    the twin, bitwise over two launches, and the shares summed bitwise one
    launch; fails unless some item has three strips."""
    import torch
    from block2_preview_tpu_torch.ops import blockv2
    from block2_preview_tpu_torch.ops.stacked import env_pool, site_pools
    f64 = torch.float64
    for direction, bond, st in (("left", t, t), ("right", t + 2, t + 1)):
        env = me.left_envs[bond] if direction == "left" \
            else me.right_envs[bond]
        meta, pool = env_pool(env, mpo.bond_dqs[bond], np.float64)
        rp = blockv2.build_blocking_v2(
            meta, mpo.tensors[st], mpo.site_quanta[st], mps.tensors[st],
            mps.tensors[st], mpo.group, direction, mpo.bond_dqs[bond],
            mpo.bond_dqs[t + 1], T=T, gemm_mix=True).rot
        ep = torch.as_tensor(pool, device=device)
        bp, kp = site_pools(rp, device, f64)
        d5 = blockv2.blk_tables(rp, device, f64)
        h = rp._dev["k5"]
        nl = rp.it[h["large"], 7]

        def run(fn=blockv2.blk_exec, *a, ep=ep, bp=bp, kp=kp, d5=d5, rp=rp):
            return fn(ep, bp, kp, d5, *a, rp.T, rp.left,
                      torch.zeros(rp.ncap, dtype=f64, device=device))

        o_k = run()
        rel, _ = rel_err(o_k, run(blockv2.blk_twin))
        shares = sum(run(blockv2.blk_exec_part,
                         blockv2.blk_rank_part(rp, r, 2, device))
                     for r in range(2))
        same = torch.equal(o_k, run())
        one = torch.equal(shares, o_k)
        print(f"[3 kernels] K5_block f64 {direction[0]}3 at T {rp.T}: tile "
              f"path items {len(nl)} (strips of l: "
              f"{histogram(nl, (1, 2, 4, 8))}), units {d5['n_lunits']}; "
              f"rel {rel:.2e}; two launches "
              f"{'bitwise equal' if same else 'DIFFER'}; K21's 2 shares "
              f"summed {'bitwise one launch' if one else 'DIFFER'}",
              flush=True)
        if not (nl >= 3).any():
            fail(f"K5 {direction} T {rp.T}: no tile-path item of three "
                 f"strips of l")
        if not rel <= F64_TOL:
            fail(f"K5 {direction} T {rp.T}: rel err {rel:.3e}")
        if device.type == "cuda" and not (same and one):
            fail(f"K5 {direction} T {rp.T}: two launches differ, or K21's "
                 f"shares summed are not one launch, bitwise")


def phase_stacked_kernels(device, mpo, mps, me, t, T=None, summary=True,
                          bucket=True):
    """K10 and K11 (the bucket engine; unless ``bucket`` is False) and K12
    (v1 tiled blocking) against their twins on the left and right blocking
    plans next to center t of the host environments ``me``, f64 and f32;
    K11 and K12 also bitwise against a second launch.  ``T`` forces K12's
    tile.  Returns the summary rows of the f64 cases (none unless
    ``summary``)."""
    import torch
    from block2_preview_tpu_torch.ops import stacked, tiled_blocking
    rows = {}
    plans = _stacked_plans(mpo, mps, me, t, T=T)
    for dtype in (np.float64, np.float32):
        acc = rows if summary and dtype == np.float64 else None
        tol = ATOMIC_TOL[dtype]
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        for direction, (sp, tp, pool, e_total) in plans.items():
            side = direction[0]
            ep = torch.as_tensor(pool, dtype=tdt, device=device)
            bp, kp = stacked.site_pools(sp, device, tdt)
            esz = ep.element_size()
            if bucket:
                r_t = k10_check(acc, device, dtype, side, sp, ep, bp, kp,
                                e_total, tol)
                t0 = time.perf_counter()
                d11 = stacked.mix_tables(sp, device, tdt)
                t_tab = time.perf_counter() - t0
                h11 = sp._dev["k11"]
                res = torch.cat([r_t, r_t.new_zeros(1)])

                def k11(fn, sp=sp, d11=d11, res=res):
                    return fn(res, d11, torch.zeros(sp.out_cap, dtype=tdt,
                                                    device=device))

                lib = _mix_library_call(sp, device, tdt)
                m_t = k11(stacked.stk_mix_plain)
                rel, _ = rel_err(lib(res), m_t)
                if not rel <= tol:
                    fail(f"K11 {side}: the index_add_ yardstick disagrees "
                         f"({rel:.3e})")
                n_rows = len(h11["ts"])
                n_blk, n_u = d11["n_blocks"], d11["n_units"]
                _check(acc, "K11_stk_mix", dtype, side,
                       k11(stacked.stk_mix), m_t, tol,
                       time_ms(lambda: k11(stacked.stk_mix), device),
                       time_ms(lambda: k11(stacked.stk_mix_plain), device,
                               reps=1),
                       time_ms(lambda: lib(res), device),
                       # res read, the live output written, coefs; the
                       # rows' offsets, blocks, block starts, units
                       live_bytes(esz, sp.res_total + sp.meta_out.total
                                  + n_rows, n_rows + 5 * n_blk + 1
                                  + 2 * n_u),
                       2.0 * float(h11["work"][-1]),
                       f"rows {n_rows} elements {int(h11['work'][-1])} out "
                       f"{sp.meta_out.total}; {gather_shape(h11)}; tables "
                       f"{table_bytes(d11) / 2 ** 20:.1f} MiB built in "
                       f"{t_tab:.2f} s")
                _bitwise("K11", side, lambda: k11(stacked.stk_mix))
            t0 = time.perf_counter()
            d12 = tiled_blocking.tblk_tables(tp, device, tdt)
            t_tab = time.perf_counter() - t0
            h12 = tiled_blocking.tblk_host(tp)
            tb, tk = stacked.site_pools(tp, device, tdt)

            def k12(fn, tp=tp, d12=d12, ep=ep, tb=tb, tk=tk):
                return fn(ep, tb, tk, d12, tp.T, tp.left, torch.zeros(
                    tp.ncap, dtype=tdt, device=device))

            o_k = k12(tiled_blocking.tblk_exec)
            n1, n2 = d12["s1"].shape[1], d12["s2"].shape[1]
            c12 = h12["core"]
            n3, n_blk = len(c12["ts"]), len(c12["blk"])
            G, _, B = tp.s1.shape
            old_mib = G * B * (4 * (9 + 6 + 5) + esz) / 2 ** 20
            scratch = (d12["ntmp"] + d12["nprod"]) * tp.T ** 2 * esz
            _check(acc, "K12_tiled_blocking", dtype, side, o_k,
                   k12(tiled_blocking.tblk_plain), tol,
                   time_ms(lambda: k12(tiled_blocking.tblk_exec),
                           device),
                   time_ms(lambda: k12(tiled_blocking.tblk_plain),
                           device, reps=1), None,
                   # env, bra, ket in; the live output out; the live
                   # tasks and segment starts, stage 3's coefficients and
                   # core tables
                   live_bytes(esz, e_total + 1 + tb.numel() + tk.numel()
                              + tp.meta_out.total + n3,
                              8 * n1 + 5 * n2 + len(h12["seg1"])
                              + len(h12["seg2"]) + n3 + 5 * n_blk + 1
                              + 2 * len(c12["units"])),
                   tp.flops,
                   f"T {tp.T} groups {len(h12['groups'])} waves "
                   f"{len(h12['waves'])} tasks {n1}/{n2}/{n3} tiles tmp "
                   f"{len(h12['seg1']) - 1} prod {len(h12['seg2']) - 1} "
                   f"scratch {scratch / 2 ** 20:.1f} MiB; device tables "
                   f"{table_bytes(d12) / 2 ** 20:.1f} MiB (the [G, ., B] "
                   f"ones {old_mib:.1f}) built in {t_tab:.2f} s; stage 3 "
                   f"{gather_shape(c12)}; out {tp.meta_out.total} GFLOP "
                   f"{tp.flops / 1e9:.3f}")
            if float(o_k[tp.meta_out.total:].abs().max()) != 0.0:
                fail(f"K12 {side}: nonzero sentinel slots")
            _bitwise("K12", side, lambda: k12(tiled_blocking.tblk_exec))
    return summary_rows(rows)


def excited_case(L=8, D=80, ns=6):
    """(driver, MPO, schedule) of phase 7a: Hubbard-L (U=2, t=1, half
    filling), D, ns sweeps with noise 1e-5, Davidson |r|^2 < 1e-14."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    sched = dict(bond_dims=[D] * ns, noises=[1e-5] * ns + [0],
                 thrds=[1e-14], n_sweeps=ns, tol=0, iprint=0)
    return drv, mpo, sched


def host_excited(L=8, D=80, ns=6):
    """Phase 7a's host references, for a worker: ({n_roots or "proj":
    energies} (seed 7 but for "proj"), the host ground state, seconds)."""
    drv, mpo, sched = excited_case(L, D, ns)

    def host(seed, **kw):
        e = drv.dmrg(mpo, drv.get_random_mps(D, seed=seed), backend="numpy",
                     **sched, **kw)
        return np.atleast_1d(e), drv._last_dmrg.mps

    t0 = time.time()
    ref = {n: host(7, n_roots=n)[0] for n in (2, 3)}
    ref[1], gs = host(7)
    ref["proj"], _ = host(9, proj_mpss=[gs])
    return ref, gs, time.time() - t0


def phase_excited(device, L=8, D=80, ns=6, host=None):
    """Phase 7a: state-averaged roots, a projected excited state and an
    f32 root on the bucketed backends, and two roots on torch_tiled,
    against the host backend at a small size (``host``:
    :func:`host_excited`'s worker result; computed here without one).
    Returns the host energies {n_roots or "proj": array} (seed 7 but for
    "proj")."""
    from block2_preview_tpu_torch.ops import _kernels
    drv, mpo, sched = excited_case(L, D, ns)
    ref, gs, secs = host.get() if host is not None else host_excited(L, D,
                                                                      ns)
    print(f"[7a excited] Hubbard-L{L} D={D} x{ns} host references "
          f"({secs:.1f} s{' in a worker' if host is not None else ''}): roots "
          f"{' '.join(f'{x:.12f}' for x in ref[3])}, projected "
          f"{ref['proj'][0]:.12f}", flush=True)
    runs = [("torch", np.float64, dict(n_roots=3), 3, 7, HUB_TOL,
             ("K8_bucket",)),
            ("torch_device", np.float64, dict(n_roots=3), 3, 7, HUB_TOL,
             ("K8_bucket", "K9_bucket_blocking")),
            ("torch", np.float64, dict(proj_mpss=[gs]), "proj", 9, HUB_TOL,
             ("K8_bucket",)),
            ("torch_device", np.float32, {}, 1, 7, F32_E_TOL,
             ("K8_bucket", "K9_bucket_blocking")),
            ("torch_tiled", np.float64, dict(n_roots=2), 2, 7, HUB_TOL,
             ("K7_tiled",))]
    for backend, dtype, kw, which, seed, tol, must in runs:
        _kernels.reset_counts()
        t0 = time.time()
        e = np.atleast_1d(drv.dmrg(mpo, drv.get_random_mps(D, seed=seed),
                                   device=device, backend=backend,
                                   dtype=dtype, **sched, **kw))
        counts = _kernels.launch_counts()
        de = np.abs(e - ref[which]).max()
        what = "projected" if which == "proj" else f"{len(e)} roots"
        print(f"[7a excited] {backend} {np.dtype(dtype).name} {what}: "
              f"{' '.join(f'{x:.12f}' for x in e)} ({time.time() - t0:.1f} "
              f"s) max dE {de:.2e}  launches "
              f"{ {k: counts[k] for k in must} }  host_redo_count "
              f"{drv._last_dmrg.host_redo_count}", flush=True)
        if not de < tol:
            fail(f"7a {backend} {what}: max |dE| {de:.3e} >= {tol}")
        if device.type == "cuda" and not all(counts[k] > 0 for k in must):
            fail(f"7a {backend}: a kernel of the path was never launched "
                 f"({counts})")
    return ref


@contextlib.contextmanager
def env_var(name, value):
    """Environment variable ``name`` set to ``value`` (left unset for None)
    inside the block, restored after it."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def phase_stacked_parity(device, L=8, D=80, ns=6, ref=None):
    """Phase 8a: the stacked environments' blocking engines against the
    host backend at a small size — torch_stacked (bucket engine, K10 +
    K11) with one and three roots, and torch_resident and torch_tiled
    under B2TPU_STK_ENGINE=tiled_v1 (K12, no K5).  ``ref``: phase 7a's host
    energies of the same schedule and seed, computed when None."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    from block2_preview_tpu_torch.ops import _kernels
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    sched = dict(bond_dims=[D] * ns, noises=[1e-5] * ns + [0],
                 thrds=[1e-14], n_sweeps=ns, tol=0, iprint=0)
    if ref is None:
        ref = {n: np.atleast_1d(drv.dmrg(mpo, drv.get_random_mps(D, seed=7),
                                         backend="numpy", n_roots=n,
                                         **sched)) for n in (1, 3)}
    bucket = ("K10_slab", "K11_stk_mix", "K8_bucket")
    runs = [("torch_stacked", None, 1, bucket, ()),
            ("torch_stacked", None, 3, bucket, ()),
            ("torch_resident", "tiled_v1", 1, ("K12_tiled_blocking",),
             ("K5_block",)),
            ("torch_tiled", "tiled_v1", 1, ("K12_tiled_blocking",
                                            "K7_tiled"), ("K5_block",))]
    for backend, engine, n, must, never in runs:
        _kernels.reset_counts()
        t0 = time.time()
        with env_var("B2TPU_STK_ENGINE", engine):
            e = np.atleast_1d(drv.dmrg(mpo, drv.get_random_mps(D, seed=7),
                                       device=device, backend=backend,
                                       n_roots=n, **sched))
        counts = _kernels.launch_counts()
        de = np.abs(e - ref[n]).max()
        print(f"[8a stacked] {backend} {engine or 'bucket'} {n} roots: "
              f"{' '.join(f'{x:.12f}' for x in e)} ({time.time() - t0:.1f} "
              f"s) max dE {de:.2e}  launches "
              f"{ {k: counts[k] for k in must + never} }  "
              f"host_env_materialized "
              f"{drv._last_dmrg.host_env_materialized}", flush=True)
        if not de < HUB_TOL:
            fail(f"8a {backend} {engine}: max |dE| {de:.3e} >= {HUB_TOL}")
        if device.type == "cuda" and not (
                all(counts[k] > 0 for k in must)
                and not any(counts[k] for k in never)):
            fail(f"8a {backend} {engine}: launches {counts}")


def _sweep_lines(tag, log, kernels):
    for i, r in enumerate(log):
        print(f"[{tag}] sweep {i} wall {r['wall']:.1f} s  Teff "
              f"{r['teff']:.1f} Teig {r['teig']:.1f} Tdm {r['tdm']:.1f} Tblk "
              f"{r['tblk']:.1f} (plan {r['blk_plan']:.1f}, exec "
              f"{r['blk_exec']:.1f})  E {r['energy']:.10f}  "
              + " ".join(f"{k.split('_')[0]} {r['launches'][k]}"
                         for k in kernels)
              + f"  matvecs {r['matvecs']}  materialized "
              f"{r['materialized']}", flush=True)


def phase_stacked_full(device, drv, mpo, D=250):
    """Phase 8b: phase 5's start and schedule on torch_stacked (bucket
    engine, K10 + K11; host LW/RW; the host Davidson around K8), one root.
    Returns (launch counts, energy)."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t0 = time.time()
    e = drv.dmrg(mpo, drv.get_random_mps(D, seed=11), device=device,
                 backend="torch_stacked", **qc_sched(D))
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _kernels.launch_counts()
    solver = drv._last_dmrg
    log = solver.sweep_log
    _sweep_lines("8b stacked", log, ("K10_slab", "K11_stk_mix", "K8_bucket"))
    me = solver.me
    matvecs = sum(r["matvecs"] for r in log)
    mem = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
           else float("nan"))
    esz = np.dtype(np.float64).itemsize
    print(f"[8b stacked] torch_stacked {wall:.1f} s (environment init "
          f"{wall - sum(r['wall'] for r in log):.1f} s; blocking plan "
          f"{me.blk_time['plan']:.1f} s, exec {me.blk_time['exec']:.1f} s in "
          f"all)  E {e:.10f}  K10 {counts['K10_slab']} K11 "
          f"{counts['K11_stk_mix']} K8 {counts['K8_bucket']} matvecs "
          f"{matvecs}  largest res pool {me.max_res_pool} elements "
          f"({me.max_res_pool * esz / 2 ** 20:.1f} MiB)  "
          f"host_env_materialized {solver.host_env_materialized}  "
          f"max_memory_allocated {mem:.2f} GiB", flush=True)
    if cuda and not (counts["K10_slab"] > 0 and counts["K11_stk_mix"] > 0):
        fail(f"phase 8b never launched K10 or K11 ({counts})")
    if cuda and counts["K8_bucket"] != matvecs:
        fail(f"phase 8b: K8 launches {counts['K8_bucket']} != matvecs "
             f"{matvecs}")
    if not np.isfinite([e] + [r["energy"] for r in log]).all():
        fail("phase 8b: an energy is not finite")
    return counts, e


def phase_resident_v1(device, drv, mpo, D=250):
    """Phase 8c: phase 5's start and schedule on torch_resident with
    B2TPU_STK_ENGINE=tiled_v1 (blocking on K12, not K5).  Returns (launch
    counts, energy)."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t0 = time.time()
    with env_var("B2TPU_STK_ENGINE", "tiled_v1"):
        e = drv.dmrg(mpo, drv.get_random_mps(D, seed=11), device=device,
                     **qc_sched(D))
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _kernels.launch_counts()
    solver = drv._last_dmrg
    _sweep_lines("8c tiled_v1", solver.sweep_log,
                 ("K12_tiled_blocking", "K1_matvec"))
    mem = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
           else float("nan"))
    print(f"[8c tiled_v1] torch_resident tiled_v1 {wall:.1f} s  E {e:.10f}  "
          f"K12 {counts['K12_tiled_blocking']} K5 {counts['K5_block']}  "
          f"host_env_materialized {solver.host_env_materialized}  "
          f"host_ops_downloads {solver.host_ops_downloads}  "
          f"max_memory_allocated {mem:.2f} GiB", flush=True)
    if cuda and not (counts["K12_tiled_blocking"] > 0
                     and counts["K5_block"] == 0):
        fail(f"phase 8c: K12 must launch and K5 must not ({counts})")
    for what in ("host_redo_count", "host_env_materialized",
                 "host_ops_downloads"):
        if getattr(solver, what) != 0:
            fail(f"phase 8c: {what} {getattr(solver, what)}")
    return counts, e


def check_stacked(e8b, e8c, e5, ref):
    """Phases 8b and 8c against phase 5's host reference ``ref`` =
    (energy, seconds) to QC_TOL, and 8c against phase 5's port energy
    ``e5`` to HUB_TOL (the same Davidson; only the blocking engine
    differs)."""
    e_ref = ref[0]
    print(f"[8b stacked] E {e8b:.10f}  host {e_ref:.10f}  dE "
          f"{e8b - e_ref:.2e}  (phase 5 port {e5:.10f})", flush=True)
    print(f"[8c tiled_v1] E {e8c:.10f}  phase 5 {e5:.10f} dE "
          f"{e8c - e5:.2e}  host dE {e8c - e_ref:.2e}", flush=True)
    if not abs(e8b - e_ref) < QC_TOL:
        fail(f"8b |dE| {abs(e8b - e_ref):.3e} >= {QC_TOL}")
    if not (abs(e8c - e5) < HUB_TOL and abs(e8c - e_ref) < QC_TOL):
        fail(f"8c: |dE| to phase 5 {abs(e8c - e5):.3e}, to the host "
             f"{abs(e8c - e_ref):.3e}")


def mix_launch_rules(tag, ver, counts, me, cuda):
    """The launch rules of a run under B2TPU_MIX=ver (3 or 2): the
    engine's kernels launched (K13 + K14, or K15), no other mix kernel,
    and K3 only inside v3 environment blocking (one launch per
    BlockingV3Plan execution the environment counts)."""
    must = ("K13_env_gemm", "K14_place_v3") if ver == "3" else \
        ("K15_mix_v2",)
    never = tuple(k for k in ("K4_place", "K13_env_gemm", "K14_place_v3",
                              "K15_mix_v2") if k not in must)
    if not cuda:
        return
    if not (all(counts[k] > 0 for k in must)
            and not any(counts[k] for k in never)):
        fail(f"{tag}: launches {counts}")
    if counts["K3_mix"] != me.v3_blockings:
        fail(f"{tag}: K3 launched {counts['K3_mix']} times, the environment "
             f"ran {me.v3_blockings} v3 blockings (K3 ran in the mix)")


def k16_launches(by_phase):
    """K16's launches summed over the runs ``by_phase`` (phase -> launch
    counts of that run, each counted from a reset).  No path runs the v1
    slab matvec, as in the JAX package, so this fails unless every count
    is 0."""
    k16 = {tag: c["K16_slab_matvec"] for tag, c in by_phase.items()}
    print(f"[9 mix] K16 launches by phase {k16}", flush=True)
    if any(k16.values()):
        fail(f"K16 was launched on a sweep path: {k16}")
    return sum(k16.values())


def phase_mix_parity(device, L=8, D=80, ns=6, e_ref=None):
    """Phase 9a: torch_resident under B2TPU_MIX=3 (mix v3, K13 + K14) and
    =2 (mix v2, K15) with phase 4's schedule and start, each against the
    host energy ``e_ref`` (phase 4's; computed when None) to 1e-8 Ha, with
    the launch rules of :func:`mix_launch_rules`."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    from block2_preview_tpu_torch.ops import _kernels
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    sched = dict(bond_dims=[D] * ns, noises=[1e-5] * ns + [0],
                 thrds=[1e-10], n_sweeps=ns, tol=0, iprint=0)
    if e_ref is None:
        e_ref = _host_reference(mpo, drv.get_random_mps(D, seed=7), sched)
    for ver in ("3", "2"):
        _kernels.reset_counts()
        t0 = time.time()
        with env_var("B2TPU_MIX", ver):
            e = drv.dmrg(mpo, drv.get_random_mps(D, seed=7), device=device,
                         **sched)
        counts = _kernels.launch_counts()
        me = drv._last_dmrg.me
        de = e - e_ref
        print(f"[9a mix] Hubbard-L{L} D={D} x{ns} B2TPU_MIX={ver} {e:.12f} "
              f"({time.time() - t0:.1f} s) host {e_ref:.12f} dE {de:.2e}  "
              f"launches K3 {counts['K3_mix']} (v3 blockings "
              f"{me.v3_blockings}) K4 {counts['K4_place']} K13 "
              f"{counts['K13_env_gemm']} K14 {counts['K14_place_v3']} K15 "
              f"{counts['K15_mix_v2']}", flush=True)
        if not abs(de) < HUB_TOL:
            fail(f"9a B2TPU_MIX={ver}: |dE| {abs(de):.3e} >= {HUB_TOL}")
        mix_launch_rules(f"9a B2TPU_MIX={ver}", ver, counts, me,
                         device.type == "cuda")


def phase_mix_full(device, drv, mpo, ver, sched, tag, D=250):
    """Phases 9b / 9c: phase 5's start on torch_resident under
    B2TPU_MIX=ver with the schedule ``sched``: the per-sweep split (with
    the mix-plan build time inside Teff) and the mix kernels' launches;
    fails unless the launch rules hold and every host counter is 0.
    Returns (launch counts, energy, sweep-0 energy)."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    cuda = device.type == "cuda"
    _kernels.reset_counts()
    t0 = time.time()
    with env_var("B2TPU_MIX", ver):
        e = drv.dmrg(mpo, drv.get_random_mps(D, seed=11), device=device,
                     **sched)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _kernels.launch_counts()
    solver = drv._last_dmrg
    kernels = (("K13_env_gemm", "K14_place_v3") if ver == "3" else
               ("K15_mix_v2",)) + ("K3_mix", "K1_matvec")
    for i, r in enumerate(solver.sweep_log):
        print(f"[{tag}] sweep {i} wall {r['wall']:.1f} s  Teff "
              f"{r['teff']:.1f} (mix plans {r['mix_plan']:.1f}) Teig "
              f"{r['teig']:.1f} Tdm {r['tdm']:.1f} Tblk {r['tblk']:.1f}  E "
              f"{r['energy']:.10f}  "
              + " ".join(f"{k.split('_')[0]} {r['launches'][k]}"
                         for k in kernels), flush=True)
    print(f"[{tag}] torch_resident B2TPU_MIX={ver} {wall:.1f} s  E "
          f"{e:.10f}  launches "
          + " ".join(f"{k.split('_')[0]} {counts[k]}" for k in kernels)
          + f" K4 {counts['K4_place']}  v3 blockings "
          f"{solver.me.v3_blockings}  host_redo_count "
          f"{solver.host_redo_count}  host_env_materialized "
          f"{solver.host_env_materialized}  host_ops_downloads "
          f"{solver.host_ops_downloads}", flush=True)
    if ver in ("2", "3"):
        k = "k15" if ver == "2" else "k13"
        secs = [p._dev[k]["seconds"] for _, p in
                solver._res_caches["mix"].values() if k in p._dev]
        print(f"[{tag}] {k.upper()} host tables: {len(secs)} plans, "
              f"{sum(secs):.2f} s in all (a plan median "
              f"{np.median(secs) if secs else 0.0:.3f}, max "
              f"{max(secs, default=0.0):.3f} s), inside Teff", flush=True)
    mix_launch_rules(tag, ver, counts, solver.me, cuda)
    for what in ("host_redo_count", "host_env_materialized",
                 "host_ops_downloads"):
        if getattr(solver, what) != 0:
            fail(f"{tag}: {what} {getattr(solver, what)}")
    e0 = solver.sweep_log[0]["energy"]
    if not np.isfinite([e, e0]).all():
        fail(f"{tag}: an energy is not finite")
    return counts, e, e0


def check_mix(e9b, e9c0, e5, e5_0, ref):
    """9b against phase 5's port energy ``e5`` (1e-8 Ha: the same
    Davidson, only the mix engine differs) and its host reference ``ref``
    = (energy, seconds) (1e-6 Ha); 9c's one sweep against phase 5's
    sweep-0 energy ``e5_0`` (1e-8 Ha)."""
    e_ref = ref[0]
    print(f"[9b mix v3] E {e9b:.10f}  phase 5 {e5:.10f} dE {e9b - e5:.2e}  "
          f"host dE {e9b - e_ref:.2e}", flush=True)
    print(f"[9c mix v2] sweep 0 E {e9c0:.10f}  phase 5 sweep 0 {e5_0:.10f} "
          f"dE {e9c0 - e5_0:.2e}", flush=True)
    if not (abs(e9b - e5) < HUB_TOL and abs(e9b - e_ref) < QC_TOL):
        fail(f"9b: |dE| to phase 5 {abs(e9b - e5):.3e}, to the host "
             f"{abs(e9b - e_ref):.3e}")
    if not abs(e9c0 - e5_0) < HUB_TOL:
        fail(f"9c: |dE| to phase 5's sweep 0 {abs(e9c0 - e5_0):.3e}")


# elements of K15's library yardstick (int32 dst and src, the coefficient
# and the product per element: 24 bytes each) it may hold on the card
_K15_LIBRARY_ELEMS = 1 << 29


def _k15_library_call(plan, epool):
    """K15's function as one PyTorch call, out.index_add_(0, dst,
    epool[src] * cf), on element index lists expanded on the device from
    the plan's own task table (the yardstick only; the port never calls
    it); None where the lists would not fit."""
    import torch
    dev = epool.device
    T = plan.T
    s = torch.as_tensor(np.asarray(plan.s).transpose(2, 0, 1, 3)
                        .reshape(7, -1), device=dev)
    cf = torch.as_tensor(np.asarray(plan.coef).reshape(-1),
                         dtype=epool.dtype, device=dev)
    live = s[4] >= 0
    s = s[:, live].long()
    cf = cf[live]
    per = s[2].clamp(0, T) * s[3].clamp(0, T)
    n = int(per.sum())
    if n > _K15_LIBRARY_ELEMS:
        return None, n
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    src = torch.empty(n, dtype=torch.int32, device=dev)
    cfe = torch.empty(n, dtype=epool.dtype, device=dev)
    r = torch.arange(T, device=dev)[None, :, None]
    c = torch.arange(T, device=dev)[None, None, :]
    k = 0
    for a in range(0, s.shape[1], 8192):
        t = s[:, a:a + 8192, None, None]
        ok = (r < t[2]) & (c < t[3])
        m = int(ok.sum())
        dst[k:k + m] = (t[4] + r * t[5] + c * t[6])[ok].int()
        src[k:k + m] = (t[0] + r * t[1] + c)[ok].int()
        cfe[k:k + m] = cf[a:a + 8192, None, None].expand(ok.shape)[ok]
        k += m
    n_out = plan.ncap_out + 1

    def call(ep):
        out = torch.zeros(n_out, dtype=ep.dtype, device=ep.device)
        return out.index_add_(0, dst, torch.index_select(ep, 0, src) * cfe)
    return call, n


def _place_index(d3, n, zero_slot):
    """K14's source index of slab elements [0, n), ``zero_slot`` (a zero
    of OUT's padding) where no window covers one: what one torch.take
    needs to compute K14's function (the yardstick only)."""
    import torch
    from block2_preview_tpu_torch.ops import mixv3
    parts = []
    for k in range(0, n, mixv3._TWIN_PLACE_ELEMS):
        src, ok = mixv3.place_v3_src(d3, k, min(mixv3._TWIN_PLACE_ELEMS,
                                                n - k))
        parts.append(torch.where(ok, src, zero_slot))
    return torch.cat(parts)


def phase_mix_kernels(device, mpo, mps, me, t, summary=True):
    """K13 and K14 (mix v3 of the site's LW and RW plans, K13 summed over
    every GEMM group, and one K13 window at c0 > 0), K15 (mix v2 of the
    same sides; library: one index_add_) and K16 (the slab matvec on the
    site's LW/RW pools, also held against K1 on them) against their twins
    at center t of the host environments ``me``, f64 and f32.  Returns the
    summary rows of the f64 cases (none unless ``summary``)."""
    import torch
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu_torch.ops import mixv3, resident, tilev2
    eff = EffectiveHamiltonian2(me, t, assemble=False)
    tk, g = eff.target, mpo.group
    p3s, p2s, host_pools, metas = {}, {}, {}, {}
    for side, (meta, pool, args, kws) in site_mix_inputs(mpo, me, eff,
                                                         t).items():
        metas[side], host_pools[side] = meta, pool
        t0 = time.time()
        p3s[side] = mixv3.build_mix_plan_v3(*args, **kws)
        t1 = time.time()
        p2s[side] = resident.build_mix_plan(*args, **kws)
        p3, p2 = p3s[side], p2s[side]
        print(f"[3 kernels] mix plans site {t} {side}: v3 {len(p3.gemms)} "
              f"GEMMs, nnz {sum(len(x['wv']) for x in p3.gemms)}, OUT "
              f"{p3.out_total} ({t1 - t0:.1f} s); v2 T {p2.T}, tasks "
              f"{int((p2.s[:, :, 4] >= 0).sum())}, launches of the "
              f"reference {p2.n_launch} ({time.time() - t1:.1f} s); ncap "
              f"{p3.ncap_out} (live {p3.meta_out.total})", flush=True)
    pl, pr = p3s["lw"], p3s["rw"]
    ex1 = tilev2.MatvecV2(eff.ket_space, pl.meta_out, pr.meta_out, g, tk,
                          dtype=np.float64, bra_space=eff.bra_space)
    ex16 = resident.SlabMatvec(eff.ket_space, pl.meta_out, pr.meta_out, g,
                               tk, tk, dtype=np.float64,
                               bra_space=eff.bra_space)
    s1, s16 = ex1.struct, ex16.struct
    x = np.random.default_rng(5).standard_normal(eff.size)
    rows = {}
    for dtype in (np.float64, np.float32):
        acc = rows if summary and dtype == np.float64 else None
        tol = F64_TOL if dtype == np.float64 else F32_TOL
        atol = ATOMIC_TOL[dtype]
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        pools = {}
        for side in ("lw", "rw"):
            p3, p2 = p3s[side], p2s[side]
            ep = torch.as_tensor(host_pools[side], dtype=tdt, device=device)
            esz = ep.element_size()
            d3 = mixv3.v3_tables(p3, device, tdt)
            otp = mixv3._cap_class(p3.out_total + 1)
            h13 = mixv3.k13_host_tables(p3)

            def k13_twin(d3=d3, ep=ep, otp=otp):
                out = torch.zeros(otp, dtype=tdt, device=device)
                for dg in d3["gemms"]:
                    nw_p, dg_p = dg["nw_p"], dg["dg_p"]
                    mixv3.env_gemm_twin(ep, dg, 0, dg_p, out[
                        dg["goff"]:dg["goff"] + nw_p * dg_p].view(nw_p,
                                                                  dg_p))
                return out

            def k13_nan(d3=d3, ep=ep, otp=otp):
                # one launch a plan into OUT from NaNs (its tail zeroed,
                # as execute_mix_v3 leaves it): K13 stores every element
                out = torch.full((otp,), float("nan"), dtype=tdt,
                                 device=device)
                out[p3.out_total:] = 0
                return mixv3.env_gemm_plan(ep, d3, out)

            # per group: the env rows it reads, its triplets and CSR, the
            # live OUT it writes; 2 FLOPs per non-zero and live column
            ncols = [int(x_["secoff"][-1]) for x_ in p3.gemms]
            nnz = [len(x_["wv"]) for x_ in p3.gemms]
            k13_bytes = live_bytes(
                esz, sum(x_["ns"] * c_ + n_ + x_["nw"] * c_ for x_, c_, n_
                         in zip(p3.gemms, ncols, nnz)),
                sum(n_ + x_["nw"] + 1 + 3 * x_["nsec"] + 1 for x_, n_
                    in zip(p3.gemms, nnz)))
            k13_flops = 2.0 * sum(n_ * c_ for n_, c_ in zip(nnz, ncols))
            o_t = k13_twin()
            o_k = k13_nan()
            if not torch.equal(o_k, k13_nan()):
                fail(f"K13 {side}: two launches on the same inputs differ")
            out13 = torch.empty(otp, dtype=tdt, device=device)
            _check(acc, "K13_env_gemm", dtype, side, o_k, o_t, tol,
                   time_ms(lambda: mixv3.env_gemm_plan(ep, d3, out13),
                           device),
                   time_ms(k13_twin, device), None, k13_bytes, k13_flops,
                   f"groups {len(p3.gemms)} nnz {sum(nnz)} OUT "
                   f"{p3.out_total} GFLOP {k13_flops / 1e9:.3f} (on W's "
                   f"non-zeros; {h13['flops_nz'] / 1e9:.3f} walked of "
                   f"{h13['flops'] / 1e9:.3f} dense); tiles "
                   f"{len(h13['kt'])}, slices {h13['steps']}, gap zeros "
                   f"{h13['zeros']}; host tables {h13['seconds']:.3f} s; "
                   f"two launches bitwise equal")
            del out13
            # one window at c0 > 0 of the widest group
            dg = max(d3["gemms"], key=lambda x_: x_["dg_p"])
            c0, n = dg["dg_p"] // 3 + 1, min(1000, dg["dg_p"] // 2)

            def k13w(fn, dg=dg, ep=ep, c0=c0, n=n):
                return fn(ep, dg, c0, n, torch.full(
                    (dg["nw_p"], n), float("nan"), dtype=tdt, device=device))

            _check(None, "K13_env_gemm", dtype, f"{side} window",
                   k13w(mixv3.env_gemm_exec), k13w(mixv3.env_gemm_twin), tol,
                   time_ms(lambda: k13w(mixv3.env_gemm_exec), device),
                   time_ms(lambda: k13w(mixv3.env_gemm_twin), device), None,
                   live_bytes(esz, dg["nw_p"] * n), 0.0,
                   f"c0 {c0} n {n} of {dg['dg_p']} columns")
            n14 = p3.ncap_out + 1

            def k14(fn, d3=d3, o=o_t, n14=n14):
                return fn(o, d3, 0, n14, torch.empty(n14, dtype=tdt,
                                                     device=device))

            idx = _place_index(d3, n14, p3.out_total)
            s_t = k14(mixv3.place_v3_twin)
            if not torch.equal(torch.take(o_t, idx), s_t):
                fail(f"K14 {side}: the torch.take yardstick disagrees")
            tabs = p3.tables
            n_tab = sum(len(tabs[k]) for k in ("rowcell", "rowin", "colcell",
                                               "colin", "winsrc", "windk"))
            s_k = k14(mixv3.place_v3_exec)
            total = p3.meta_out.total
            if not torch.equal(s_k, s_t) or s_k[total:].any():
                fail(f"K14 {side}: kernel and twin differ, or the tail "
                     f"[{total}, {n14}) and the sentinel are not 0")
            # windows at c0 > 0 of odd length, one across the live end
            for c0, nw in ((total // 3 + 1, 1000001),
                           (max(1, total - 4097), 8193)):
                def k14w(fn, d3=d3, o=o_t, c0=c0, nw=nw):
                    return fn(o, d3, c0, nw, torch.empty(nw, dtype=tdt,
                                                         device=device))
                if not torch.equal(k14w(mixv3.place_v3_exec),
                                   k14w(mixv3.place_v3_twin)):
                    fail(f"K14 {side}: window c0 {c0} n {nw} differs")
            print(f"[3 kernels] K14 {side}: slab and windows bitwise equal "
                  f"to the twin, tail [{total}, {n14}) and sentinel 0",
                  flush=True)
            _check(acc, "K14_place_v3", dtype, side, s_k,
                   s_t, tol, time_ms(lambda: k14(mixv3.place_v3_exec),
                                     device, ROW_REPS),
                   time_ms(lambda: k14(mixv3.place_v3_twin), device,
                           ROW_REPS),
                   time_ms(lambda: torch.take(o_t, idx), device,
                           ROW_REPS),
                   # the whole slab written (its zero tail too: the output
                   # is torch.empty), one OUT value read per live element;
                   # tables
                   live_bytes(esz, n14 + total,
                              8 * len(tabs["sb_starts"]) + n_tab), 0.0,
                   f"slab {n14} live {p3.meta_out.total} windows "
                   f"{len(p3.winflat['src'])}")
            del idx
            pools[side] = s_t
            t0 = time.perf_counter()
            d2 = resident.mix_tables(p2, device, tdt)
            t_tab = time.perf_counter() - t0
            h15 = p2._dev["k15"]

            def k15(fn, d2=d2, ep=ep, p2=p2):
                return fn(torch.zeros(p2.ncap_out + 1, dtype=tdt,
                                      device=device), ep, d2)

            m_t = k15(resident.mix_v2_twin)
            rel, _ = rel_err(m_t, s_t)
            if not rel <= atol:
                fail(f"K15 {side}: the v2 pool differs from the v3 pool "
                     f"({rel:.3e})")
            lib, n_el = _k15_library_call(p2, ep)
            lib_ms = None
            if lib is not None:
                rel, _ = rel_err(lib(ep), m_t)
                if not rel <= atol:
                    fail(f"K15 {side}: the index_add_ yardstick disagrees "
                         f"({rel:.3e})")
                lib_ms = time_ms(lambda: lib(ep), device)
            del lib
            o_k = k15(resident.mix_v2_exec)
            rel, _ = rel_err(o_k, s_t)
            if not rel <= atol:
                fail(f"K15 {side}: the kernel's pool differs from the v3 "
                     f"pool ({rel:.3e})")
            if o_k[p2.meta_out.total:].any():
                fail(f"K15 {side}: the padding [{p2.meta_out.total}, "
                     f"{p2.ncap_out}] or the sentinel was written")
            n_tasks, n_blk = h15["n_tasks"], len(h15["blk"])
            _check(acc, "K15_mix_v2", dtype, side, o_k, m_t, atol,
                   time_ms(lambda: k15(resident.mix_v2_exec), device),
                   time_ms(lambda: k15(resident.mix_v2_twin), device,
                           reps=1), lib_ms,
                   # the env pool read, each task's coefficient, the live
                   # slab written; the tasks' env offsets, the windows,
                   # their term starts and the units; 2 FLOPs an element
                   live_bytes(esz, metas[side].total + 1 + n_tasks
                              + p2.meta_out.total,
                              n_tasks + 7 * n_blk + 1
                              + 2 * len(h15["units"])),
                   2.0 * n_el,
                   f"T {p2.T} tasks {n_tasks} elements {n_el}; "
                   f"{gather_shape(h15, 'tasks')}; tables "
                   f"{h15['seconds']:.3f} s on the host (the windows' "
                   f"check and the core's tables "
                   f"{h15['seconds_windows']:.3f} s), {t_tab:.3f} s with "
                   f"the upload"
                   + ("" if lib_ms is not None else
                      " (no library call: its index lists do not fit)"))
            _bitwise("K15", side, lambda: k15(resident.mix_v2_exec))
        xp = torch.as_tensor(ex16.pad(x), dtype=tdt, device=device)
        d16 = ex16.to_device(device)
        d1 = ex1.to_device(device)

        def k16(fn):
            return fn(xp, pools["lw"], pools["rw"], d16, s16["T"],
                      s16["nt1"], s16["nt2"])

        y16 = k16(resident.slab_mv_exec)
        y1 = tilev2.mv_exec(xp, pools["lw"], pools["rw"], d1, s1["T"],
                            s1["nt2"])
        n = eff.size
        rel, _ = rel_err(y16[:n], y1[:n])
        print(f"[3 kernels] K16 vs K1 {np.dtype(dtype).name}: rel {rel:.2e}",
              flush=True)
        if not rel <= atol:
            fail(f"K16 {np.dtype(dtype).name}: its sigma differs from K1's "
                 f"({rel:.3e})")
        h16 = ex16.k16_host()
        c16 = d16["chain"]
        f = h16["items"]
        a, k, nn, p = f[:, 1], f[:, 2], f[:, 4], f[:, 6]
        flops16 = 2.0 * float((a * k * nn + a * nn * p).sum())
        n_ent = c16["ent"].shape[0]
        _check(acc, "K16_slab_matvec", dtype, "", y16,
               k16(resident.slab_mv_twin), atol,
               time_ms(lambda: k16(resident.slab_mv_exec), device),
               time_ms(lambda: k16(resident.slab_mv_twin), device), None,
               # psi, LW, RW in; sigma out; the chain tables K16 reads: the
               # items (8 fields), the entries (2), the chunks (4) (K1's
               # count)
               live_bytes(xp.element_size(),
                          n + pl.meta_out.total + pr.meta_out.total
                          + eff.bra_space.size,
                          8 * len(f) + 2 * n_ent + 4 * c16["n_chunks"]),
               flops16,
               f"T {s16['T']} items {len(f)} (triples) entries {n_ent} "
               f"chunks {c16['n_chunks']} size {n} GFLOP "
               f"{flops16 / 1e9:.2f} (K1's {s1['flops'] / 1e9:.2f}); "
               f"tables {h16['seconds']:.3f} s on the host")
        ex16.free()
    return summary_rows(rows)


def phase_roots(device, drv, mpo, D=250, n_sweeps=2):
    """Phase 7b: three roots on torch_device at full width.  Returns the
    kernel launch counts of the run."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ket = drv.get_random_mps(D, seed=11)
    _kernels.reset_counts()
    t0 = time.time()
    e = drv.dmrg(mpo, ket, bond_dims=[D, D], noises=[1e-4, 0],
                 thrds=[1e-10], n_sweeps=n_sweeps, tol=0, iprint=0,
                 device=device, backend="torch_device", n_roots=3)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _kernels.launch_counts()
    solver = drv._last_dmrg
    log = solver.sweep_log
    for i, r in enumerate(log):
        print(f"[7b roots] sweep {i} D={D} wall {r['wall']:.1f} s  Teff "
              f"{r['teff']:.1f} Teig {r['teig']:.1f} Tdm {r['tdm']:.1f} "
              f"Tblk {r['tblk']:.1f}  E "
              f"{' '.join(f'{x:.10f}' for x in r['energies'])}  K8 "
              f"{r['launches']['K8_bucket']} K9 "
              f"{r['launches']['K9_bucket_blocking']} matvecs "
              f"{r['matvecs']}  uploads {r['uploads']} "
              f"({r['bytes_up'] / 2 ** 20:.1f} MiB) downloads "
              f"{r['downloads']} ({r['bytes_down'] / 2 ** 20:.1f} MiB)",
              flush=True)
    mem = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
           else float("nan"))
    plans = [p for _, p in getattr(solver.me, "_plan_cache", {}).values()
             if p is not None]
    nat, k9b = plan_host_bytes(plans)
    print(f"[7b roots] {len(plans)} cached blocking plans hold "
          f"{nat / 2 ** 20:.1f} MiB of native arrays and "
          f"{k9b / 2 ** 20:.1f} MiB of K9 tables on the host", flush=True)
    k8, k9 = counts["K8_bucket"], counts["K9_bucket_blocking"]
    init_k9 = k9 - sum(r["launches"]["K9_bucket_blocking"] for r in log)
    matvecs = sum(r["matvecs"] for r in log)
    print(f"[7b roots] torch_device f64 3 roots {wall:.1f} s (environment "
          f"init {wall - sum(r['wall'] for r in log):.1f} s, K9 {init_k9}) "
          f" E {' '.join(f'{x:.10f}' for x in e)}  K8 {k8} K9 {k9} matvecs "
          f"{matvecs}  host_redo_count {solver.host_redo_count}  "
          f"max_memory_allocated {mem:.2f} GiB", flush=True)
    if cuda and not (k8 > 0 and k9 > 0):
        fail(f"phase 7b never launched K8 or K9 ({counts})")
    if cuda and k8 != matvecs:
        fail(f"phase 7b: K8 launches {k8} != matvecs {matvecs}")
    nums = [x for r in log for x in r["energies"]] + list(e)
    if not (np.isfinite(nums).all() and np.all(np.diff(e) > 0)):
        fail(f"phase 7b: energies not finite and ascending ({e})")
    if solver.host_redo_count != 0:
        fail(f"phase 7b: host_redo_count {solver.host_redo_count}")
    return counts


def _host_reference(mpo, mps, sched):
    """The same schedule on the port's host path (backend="numpy")."""
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    return DMRG(mpo, mps, backend="numpy", iprint=0).solve(
        sched["bond_dims"], sched["noises"], sched["thrds"],
        n_sweeps=sched["n_sweeps"], tol=sched["tol"])


def phase_hubbard(device):
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    L, D, ns = 8, 80, 6
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    sched = dict(bond_dims=[D] * ns, noises=[1e-5] * ns + [0],
                 thrds=[1e-10], n_sweeps=ns, tol=0, iprint=0)
    t0 = time.time()
    e_port = drv.dmrg(mpo, drv.get_random_mps(D, seed=7), device=device,
                      **sched)
    t1 = time.time()
    e_ref = _host_reference(mpo, drv.get_random_mps(D, seed=7), sched)
    de = e_port - e_ref
    print(f"[4 parity] Hubbard-L8 D={D} x{ns} port {e_port:.12f} "
          f"({t1 - t0:.1f} s) host {e_ref:.12f} ({time.time() - t1:.1f} s) "
          f"dE {de:.2e}", flush=True)
    if not abs(de) < HUB_TOL:
        fail(f"Hubbard parity |dE| {abs(de):.3e} >= {HUB_TOL}")
    return e_ref, drv._last_dmrg.mps


def phase_tiled_parity(device, L=8, D=80, ns=6, e_ref=None):
    """Phase 6a: the torch_tiled ground state and both kinds of TDVP
    against the host backend at a small size.  ``e_ref``: the host energy
    of the same schedule and seed (phase 4's), computed when None."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    from block2_preview_tpu_torch.ops import _kernels
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    sched = dict(bond_dims=[D] * ns, noises=[1e-5] * ns + [0],
                 thrds=[1e-10], n_sweeps=ns, tol=0, iprint=0)
    _kernels.reset_counts()
    t0 = time.time()
    e_port = drv.dmrg(mpo, drv.get_random_mps(D, seed=7), device=device,
                      backend="torch_tiled", **sched)
    t1 = time.time()
    gs = drv._last_dmrg.mps
    if e_ref is None:
        e_ref = _host_reference(mpo, drv.get_random_mps(D, seed=7), sched)
    de = e_port - e_ref
    counts = _kernels.launch_counts()
    print(f"[6a tiled] Hubbard-L{L} D={D} x{ns} torch_tiled {e_port:.12f} "
          f"({t1 - t0:.1f} s, K7 launches {counts['K7_tiled']}, K5 "
          f"{counts['K5_block']}) host {e_ref:.12f} dE {de:.2e}", flush=True)
    if not abs(de) < HUB_TOL:
        fail(f"torch_tiled parity |dE| {abs(de):.3e} >= {HUB_TOL}")
    if device.type == "cuda" and counts["K5_block"] == 0:
        fail("6a: torch_tiled never blocked its environments on K5")
    for imaginary, dt in ((False, 0.05), (True, 0.1)):
        kind = "imaginary" if imaginary else "real"
        t0 = time.time()
        _, te = drv.td_dmrg(mpo, copy_mps(gs), dt, 2, D, imaginary=imaginary,
                            device=device)
        t1 = time.time()
        _, th = drv.td_dmrg(mpo, copy_mps(gs), dt, 2, D, imaginary=imaginary,
                            backend="numpy")
        de = np.abs(np.subtract(te.energies, th.energies)).max()
        dn = np.abs(np.subtract(te.norms, th.norms)).max()
        print(f"[6a tiled] {kind}-time TDVP dt {dt} x2: energies "
              f"{', '.join(f'{e:.12f}' for e in te.energies)} ({t1 - t0:.1f} "
              f"s, {te.n_matvec} matvecs) host "
              f"{', '.join(f'{e:.12f}' for e in th.energies)} "
              f"({time.time() - t1:.1f} s) max dE {de:.2e} max d|psi| "
              f"{dn:.2e} host matvecs {te.host_matvec_count}", flush=True)
        if not (de < HUB_TOL and dn < NORM_TOL):
            fail(f"{kind}-time TDVP parity dE {de:.3e} d|psi| {dn:.3e}")
        if te.host_matvec_count != 0:
            fail(f"{kind}-time TDVP ran {te.host_matvec_count} host matvecs")
    return gs


def phase_tdvp(device, drv, mpo, ket, D=250, dt=0.02):
    """Phase 6b: DMRGDriver.td_dmrg, one real-time step of ``ket`` (in
    place) at bond dimension D.  Returns the K7 launches of the run."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    t0 = time.time()
    e, te = drv.td_dmrg(mpo, ket, delta_t=dt, n_steps=1, bond_dim=D,
                        device=device)
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    k7 = _kernels.launch_counts()["K7_tiled"]
    log = te.sweep_log
    init = te.timings.blk - sum(r["blk"] for r in log)
    print(f"[6b tdvp] real-time step dt {dt} D={D}: {wall:.1f} s, host "
          f"environment init {init:.1f} s", flush=True)
    for r in log:
        print(f"[6b tdvp] sweep {'F' if r['forward'] else 'B'} wall "
              f"{r['wall']:.1f} s  blk {r['blk']:.1f} asm {r['asm']:.1f} "
              f"struct {r['struct']:.1f} pack+upload {r['pack']:.1f} "
              f"tables {r['tables']:.2f} krylov {r['krylov']:.1f} "
              f"dm {r['dm']:.1f}  K7 launches "
              f"{r['k7_launches']} matvecs {r['matvecs']} discarded "
              f"{r['discarded']:.3e}", flush=True)
    nrm, dw = te.norms[-1], te.discarded_weight
    mem = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
           else float("nan"))
    e0, n0 = te.initial
    print(f"[6b tdvp] E before {e0:.10f} (|psi| {n0:.12f}) after {e:.10f}  "
          f"|psi| {nrm:.12f}  summed discarded weight "
          f"{dw:.3e}  K7 launches {k7}  host matvecs "
          f"{te.host_matvec_count}  max_memory_allocated {mem:.2f} GiB",
          flush=True)
    if cuda and k7 == 0:
        fail("phase 6b never launched K7")
    nums = [e0, n0, e, nrm, dw] + [v for r in log for v in r.values()
                           if isinstance(v, float)]
    if not np.isfinite(nums).all():
        fail(f"phase 6b: a number is not finite ({nums})")
    if te.host_matvec_count != 0:
        fail(f"phase 6b ran {te.host_matvec_count} host matvecs")
    if not abs(1.0 - nrm) <= dw + NORM_TOL:
        fail(f"|1 - |psi|| {abs(1.0 - nrm):.3e} exceeds the discarded "
             f"weight {dw:.3e} + {NORM_TOL}")
    return k7


# ---------------------------------------------------------------------------
# phase 12: Green's functions, linear sweeps, orbital rotation and one-site
# sweeps (K7, K8)
# ---------------------------------------------------------------------------

GF_OMEGA, GF_ETA = -0.4, 0.05   # phase 12: omega relative to E0, eta
GF_ED_TOL = 5e-5    # phase 12a: G against ED (tests/test_td_gf.py:94)
GF_HOST_TOL = 1e-8  # phase 12a: the K7 G against the host backend's
ROT_TOL = 1e-8      # Ha, phase 12c: K7 rotation against the host's
TROTTER_TOL = 3e-4  # Ha, phase 12c: the rotated energy against E0
SIGMA_TOL = 1e-12   # phase 12b: K7 c128 against matvec_np, relative
ROT_D, ROT_STEPS = 200, 6   # phase 12c: bond dimension, TDVP steps


def hubbard_gf_ed(L=8):
    """(G, E0, N-1 sector size) of Hubbard-L (U=2, t=1, half filling) by
    exact diagonalization: G = <gs|d0^+ (E0 + omega + i eta - H)^-1
    d0|gs> in the N-1, 2Sz=-1 sector (sparse Lanczos for the ground
    state, a sparse solve for the resolvent)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from block2_preview_tpu_torch.core.expr import (build_term_table,
                                                    qc_term_table)
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.ops.local_ops import DES_A
    from block2_preview_tpu_torch.utils.ed import (sector_indices,
                                                   term_table_to_sparse)
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    h = term_table_to_sparse(qc_term_table(fd)).tocsr()
    ixn = sector_indices(L, L, 0)
    ixm = sector_indices(L, L - 1, -1)
    w, v = spla.eigsh(h[ixn][:, ixn], k=1, which="SA")
    e0 = float(w[0]) + fd.const_e
    d0 = term_table_to_sparse(build_term_table(L, [(1.0, [(0, DES_A)])]))
    bvec = d0.tocsr()[ixm][:, ixn] @ v[:, 0]
    z = e0 + GF_OMEGA + 1j * GF_ETA
    a = (z - fd.const_e) * sp.identity(len(ixm), format="csc") \
        - h[ixm][:, ixm].tocsc()
    return complex(np.vdot(bvec, spla.spsolve(a, bvec))), e0, len(ixm)


def _gf_run(tag, device, make, omega, eta, D, n_sweeps):
    """Run one Green's-function solve (``make()`` builds it) from a count
    reset; print its value, matvecs and K7 launches; fail unless K7
    launched once a matvec with no host matvec (on a card).  Returns (G,
    the solver, its K7 launches)."""
    from block2_preview_tpu_torch.ops import _kernels
    _kernels.reset_counts()
    t0 = time.time()
    gf = make()
    g = gf.solve(omega, eta, D, n_sweeps=n_sweeps)
    wall = time.time() - t0
    k7 = _kernels.launch_counts()["K7_tiled"]
    print(f"[12a gf] {tag}: G = {g.real:+.12f} {g.imag:+.12f}i ({wall:.1f} "
          f"s, {len(gf.sweep_log)} sweeps, {gf.n_matvec} matvecs, K7 "
          f"launches {k7}, host matvecs {gf.host_matvec_count})",
          flush=True)
    gf_launch_rules(tag, gf, k7, device)
    return g, gf, k7


def gf_launch_rules(tag, gf, k7, device):
    """A Green's function on the card: K7 launched, once a matvec, and no
    matvec on the host."""
    if gf.backend == "numpy":
        return
    if gf.host_matvec_count != 0:
        fail(f"{tag} ran {gf.host_matvec_count} host matvecs")
    if device.type == "cuda" and not (k7 > 0 and k7 == gf.n_matvec):
        fail(f"{tag}: K7 launches {k7} != matvecs {gf.n_matvec}")


def phase_gf_hubbard(device, gs, e0, ed, L=8, D=80, n_sweeps=4):
    """Phase 12a: the Green's function of Hubbard-L's state ``gs`` (energy
    ``e0``) at E0 - 0.4 + 0.05i: the driver's complex form on K7 c128
    (its right-hand side d0|gs> by Linear), the same |b> on the host
    backend, the squared form on K7 f64 with and without harmonic
    projection; each against ED (``ed`` from :func:`hubbard_gf_ed`) to
    5e-5, the complex one against the host to 1e-8; then compress_mps,
    multiply and addition on ``gs`` with tests/test_linear.py's bars.
    Returns the K7 launches of the device runs."""
    from block2_preview_tpu_torch.dmrg.expect import (mpo_expectation,
                                                      mps_overlap)
    from block2_preview_tpu_torch.dmrg.greens import (GreensFunction,
                                                      GreensFunctionSquared)
    from block2_preview_tpu_torch.ops import _kernels
    drv, mpo = hubbard_model(L)
    g_ed, e_ed, n_ed = ed
    omega = e0 + GF_OMEGA
    _kernels.reset_counts()
    t0 = time.time()
    g = drv.greens_function(mpo, gs, e0, "d", 0, GF_OMEGA, GF_ETA, D,
                            n_sweeps=n_sweeps, device=device)
    gf = drv._last_gf
    k7 = _kernels.launch_counts()["K7_tiled"]
    print(f"[12a gf] Hubbard-L{L} D={D} d_0 at E0 {GF_OMEGA:+} "
          f"{GF_ETA:+}i: ED (N-1 sector {n_ed} states, E0 {e_ed:.12f}) "
          f"G = {g_ed.real:+.12f} {g_ed.imag:+.12f}i", flush=True)
    print(f"[12a gf] greens_function K7 c128: G = {g.real:+.12f} "
          f"{g.imag:+.12f}i ({time.time() - t0:.1f} s with the Linear fit"
          f" of b, {len(gf.sweep_log)} sweeps, {gf.n_matvec} matvecs, K7 "
          f"launches {k7})", flush=True)
    gf_launch_rules("12a complex", gf, k7, device)
    launches = k7
    b, tb = gf.b, gf.b.info.target

    def x0():
        return drv.get_random_mps(D, target=tb, seed=13)

    g_host, _, _ = _gf_run("host (numpy) complex", device, lambda:
                           GreensFunction(mpo, b, x0(), backend="numpy"),
                           omega, GF_ETA, D, n_sweeps)
    vals = {"complex K7 c128": g}
    for nhp in (0, 2):
        vals[f"squared K7 f64 nhp={nhp}"], _, k = _gf_run(
            f"squared K7 f64 n_harmonic_projection={nhp}", device,
            lambda: GreensFunctionSquared(mpo, b, x0(), device=device,
                                          n_harmonic_projection=nhp),
            omega, GF_ETA, D, n_sweeps)
        launches += k
    dh = abs(g - g_host)
    print(f"[12a gf] |G - G_host| {dh:.2e}; |G - G_ED|: " + ", ".join(
        f"{k} {abs(v - g_ed):.2e}" for k, v in vals.items()), flush=True)
    if not dh < GF_HOST_TOL:
        fail(f"12a: K7 Green's function {dh:.3e} from the host's")
    for k, v in vals.items():
        if not abs(v - g_ed) < GF_ED_TOL:
            fail(f"12a: {k} Green's function {abs(v - g_ed):.3e} from ED")
    t0 = time.time()
    bra, nrm = drv.compress_mps(gs, 60, mpo, n_sweeps=4)
    ov = mps_overlap(bra, gs)
    de = mpo_expectation(mpo, bra) / mps_overlap(bra, bra) - e0
    prod, _ = drv.multiply(mpo, gs, D, n_sweeps=4)
    dm = mps_overlap(prod, gs) - (e0 - mpo.const_e)
    r = drv.get_random_mps(30, seed=99)
    x, _ = drv.addition(gs, r, mpo, 160, n_sweeps=4)
    da = mps_overlap(x, x) - (mps_overlap(gs, gs) + mps_overlap(r, r)
                              + 2 * mps_overlap(gs, r))
    print(f"[12a linear] compress_mps D=60: |nrm - 1| {abs(nrm - 1):.2e} "
          f"<x|gs> {ov:.10f} dE {de:.2e}; multiply: <Hgs|gs> - (E0 - "
          f"E_const) {dm:.2e}; addition D=160: d<x|x> {da:.2e} "
          f"({time.time() - t0:.1f} s, host sweeps)", flush=True)
    if not (abs(nrm - 1) < 1e-6 and ov > 0.99999 and abs(de) < 1e-5
            and abs(dm) < 1e-6 and abs(da) < 1e-8):
        fail("12a: a linear sweep missed tests/test_linear.py's bars")
    return launches


def phase_gf_full(device, drv, mpo, ket, e0, D=250, n_sweeps=2, t=7):
    """Phase 12b: one Green's-function point of the K=16 state ``ket``
    (energy ``e0``) at full width, complex, on K7 c128: per sweep the
    wall split, K7 launches, matvecs and GMRES matvecs a site, and G;
    fails unless G is finite with Im G < 0, K7 launched once a matvec and
    no matvec ran on the host.  Then K7's c128 sigma at center ``t`` of
    the solve's own Hamiltonian environments (complex |x>) against
    ``matvec_np`` to 1e-12 relative.  Returns the K7 launches of the
    solve."""
    import torch
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu_torch.ops import _kernels
    from block2_preview_tpu_torch.ops.tiled import TiledExecutor
    _kernels.reset_counts()
    t0 = time.time()
    g = drv.greens_function(mpo, ket, e0, "d", 0, GF_OMEGA, GF_ETA, D,
                            n_sweeps=n_sweeps, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    gf = drv._last_gf
    k7 = _kernels.launch_counts()["K7_tiled"]
    log = gf.sweep_log
    init = wall - sum(r["wall"] for r in log)
    print(f"[12b gf] K={mpo.n_sites} D={D} d_0 at E0 {GF_OMEGA:+} "
          f"{GF_ETA:+}i: {wall:.1f} s (Linear fit of b and environment init "
          f"{init:.1f} s)", flush=True)
    for r in log:
        sm = r["site_matvecs"]
        print(f"[12b gf] sweep {'F' if r['forward'] else 'B'} wall "
              f"{r['wall']:.1f} s  blk {r['blk']:.1f} asm {r['asm']:.1f} "
              f"struct {r['struct']:.1f} pack+upload {r['pack']:.1f} "
              f"tables {r['tables']:.2f} solve {r['solve']:.1f} dm "
              f"{r['dm']:.1f}  K7 launches {r['k7_launches']} matvecs "
              f"{r['matvecs']} GMRES matvecs a site max {max(sm)} median "
              f"{int(np.median(sm))}", flush=True)
    print(f"[12b gf] G = {g.real:+.12f} {g.imag:+.12f}i  K7 launches {k7} "
          f"matvecs {gf.n_matvec} host matvecs {gf.host_matvec_count}",
          flush=True)
    nums = [g.real, g.imag] + [v for r in log for v in r.values()
                               if isinstance(v, float)]
    if not np.isfinite(nums).all():
        fail(f"phase 12b: a number is not finite ({nums})")
    if not g.imag < 0:
        fail(f"phase 12b: Im G = {g.imag:.3e} is not negative")
    gf_launch_rules("12b", gf, k7, device)
    me = gf.me_h
    if log[-1]["forward"]:
        # a forward sweep last: the right environments are stale
        for s in range(mpo.n_sites - 1, t + 1, -1):
            me.update_right(s)
    for s in range(t):
        me.update_left(s)
    eff = EffectiveHamiltonian2(me, t)
    v = eff.flatten(eff.initial_guess())
    ex = TiledExecutor(eff, dtype=np.complex128, device=device)
    got = ex.matvec(v)
    ex.free()
    ref = eff.matvec_np(v)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"[12b gf] K7 c128 at the solve's center {t} ({eff.size} "
          f"unknowns, {np.dtype(eff.dtype)} operator, |x> "
          f"{np.dtype(v.dtype)}) against matvec_np: {err:.2e} relative",
          flush=True)
    if not (np.iscomplexobj(v) and err < SIGMA_TOL):
        fail(f"12b: K7 c128 {err:.3e} from matvec_np (complex |x>: "
             f"{np.iscomplexobj(v)})")
    return k7


def rotation_case(L=8):
    """(kappa, the rotated MPO) of Hubbard-L under U = exp(kappa), kappa a
    seeded antisymmetric matrix of scale 0.12 (tests/test_td_gf.py:142-172's
    recipe)."""
    import scipy.linalg as sla
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    drv, _ = hubbard_model(L)
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    k = np.random.RandomState(5).standard_normal((L, L)) * 0.12
    kappa = k - k.T
    u = sla.expm(kappa)
    g2 = np.einsum("pi,qj,rk,sl,pqrs->ijkl", u.T, u.T, u.T, u.T, fd.g2e,
                   optimize=True)
    return kappa, drv.get_qc_mpo(h1e=u @ fd.h1e @ u.T, g2e=g2,
                                 ecore=fd.const_e)


def rotated_energies(ket, L=8):
    """<H> of ``ket`` under the rotated and under the unrotated
    Hubbard-L Hamiltonian."""
    from block2_preview_tpu_torch.dmrg.expect import mpo_expectation
    _, mpo = hubbard_model(L)
    _, rot = rotation_case(L)
    return tuple(float(np.real(mpo_expectation(m, ket)) + m.const_e)
                 for m in (rot, mpo))


def host_rotation(gs, L=8, D=ROT_D, n_steps=ROT_STEPS):
    """:func:`rotated_energies` of ``gs`` rotated on the host backend."""
    drv, _ = hubbard_model(L)
    ket = copy_mps(gs)
    drv.orbital_rotation(ket, rotation_case(L)[0], D, n_steps=n_steps,
                         backend="numpy")
    return rotated_energies(ket, L)


def phase_rotation(device, gs, e0, host, L=8, D=ROT_D, n_steps=ROT_STEPS):
    """Phase 12c: orbital_rotation of Hubbard-L's state ``gs`` (energy
    ``e0``) on K7 c128 under the complex MPO i*G, against the host run
    ``host`` (:func:`host_rotation`): the energies under the rotated
    integrals to 1e-8 Ha, within 3e-4 Ha of E0 (the Trotter bar), and
    more than 1e-3 Ha from E0 under the unrotated ones.  Returns the K7
    launches."""
    from block2_preview_tpu_torch.ops import _kernels
    drv, _ = hubbard_model(L)
    kappa, _ = rotation_case(L)
    _kernels.reset_counts()
    t0 = time.time()
    ket = copy_mps(gs)
    drv.orbital_rotation(ket, kappa, D, n_steps=n_steps, device=device)
    wall = time.time() - t0
    te = drv._last_te
    k7 = _kernels.launch_counts()["K7_tiled"]
    e_rot, e_old = rotated_energies(ket, L)
    h_rot, h_old = host.get()
    cplx = any(np.iscomplexobj(w) for ent in te.mpo.tensors
               for w in ent.values())
    print(f"[12c rotation] Hubbard-L{L} D={D} {n_steps} steps: {wall:.1f} s"
          f", {te.n_matvec} matvecs, K7 launches {k7}, host matvecs "
          f"{te.host_matvec_count}, complex MPO {cplx}; E under the rotated"
          f" integrals {e_rot:.12f} (host {h_rot:.12f}, dE "
          f"{e_rot - h_rot:.2e}; E0 {e0:.12f}, {e_rot - e0:.2e}), under "
          f"the old {e_old:.12f} ({e_old - e0:.2e})", flush=True)
    if not (abs(e_rot - h_rot) < ROT_TOL and abs(e_old - h_old) < ROT_TOL):
        fail(f"12c: rotated energies {e_rot - h_rot:.3e} / "
             f"{e_old - h_old:.3e} from the host's")
    if not (abs(e_rot - e0) < TROTTER_TOL and abs(e_old - e0) > 1e-3):
        fail(f"12c: rotated energy {e_rot - e0:.3e} from E0, unrotated "
             f"{e_old - e0:.3e}")
    if not cplx or te.host_matvec_count != 0:
        fail(f"12c: complex MPO {cplx}, host matvecs "
             f"{te.host_matvec_count}")
    if device.type == "cuda" and not (k7 > 0 and k7 == te.n_matvec):
        fail(f"12c: K7 launches {k7} != matvecs {te.n_matvec}")
    return k7


def onedot_sched(D=80, ns=6):
    """Phase 12d's schedule: 6a's, one-site from sweep 4."""
    return dict(hub_sched(D, ns), twodot_to_onedot=4)


def host_onedot(L=8, D=80, ns=6, last_site_1site=False):
    """The host backend's energy of phase 12d's run."""
    drv, mpo = hubbard_model(L)
    sched = hub_sched(D, ns) if last_site_1site else onedot_sched(D, ns)
    return drv.dmrg(mpo, drv.get_random_mps(D, seed=7), backend="numpy",
                    last_site_1site=last_site_1site, **sched)


def phase_onedot(device, hosts, L=8, D=80, ns=6):
    """Phase 12d: Hubbard-L from 6a's start with twodot_to_onedot=4 on
    torch_tiled (K7) and torch (K8), and one last_site_1site solve on
    torch_tiled, each within 1e-8 Ha of the host backend's run (``hosts``:
    :func:`host_onedot`'s results for the two schedules); fails unless
    the kernel launched in both one-site sweeps (EffectiveHamiltonian1
    forward, 1R backward).  Returns the K7 launches."""
    from block2_preview_tpu_torch.ops import _kernels
    drv, mpo = hubbard_model(L)
    e_host, e_ls1 = (h.get() for h in hosts)
    k7 = 0
    for backend, kernel, ls1 in (("torch_tiled", "K7_tiled", False),
                                 ("torch", "K8_bucket", False),
                                 ("torch_tiled", "K7_tiled", True)):
        sched = hub_sched(D, ns) if ls1 else onedot_sched(D, ns)
        _kernels.reset_counts()
        t0 = time.time()
        e = drv.dmrg(mpo, drv.get_random_mps(D, seed=7), device=device,
                     backend=backend, last_site_1site=ls1, **sched)
        wall = time.time() - t0
        log = drv._last_dmrg.sweep_log
        per = [r["launches"][kernel] for r in log]
        k7 += _kernels.launch_counts()["K7_tiled"]
        ref = e_ls1 if ls1 else e_host
        tag = f"{backend} {'last_site_1site' if ls1 else 'twodot_to_onedot=4'}"
        print(f"[12d onedot] Hubbard-L{L} D={D} x{ns} {tag}: {e:.12f} "
              f"({wall:.1f} s, {kernel} launches a sweep {per}) host "
              f"{ref:.12f} dE {e - ref:.2e}", flush=True)
        if not abs(e - ref) < HUB_TOL:
            fail(f"12d {tag}: |dE| {abs(e - ref):.3e} >= {HUB_TOL}")
        # the one-site steps: sweeps 4 and 5, or every sweep's last site
        if device.type == "cuda" and not all(per[0 if ls1 else 4:]):
            fail(f"12d {tag}: {kernel} did not launch in a sweep with "
                 f"one-site steps ({per})")
    return k7


# ---------------------------------------------------------------------------
# phase 13: spin-adapted SU(2) DMRG through the driver's SU2 mode (K5 v2, K7)
# ---------------------------------------------------------------------------

SU2_TOL = 1e-8          # Ha, 13a/13b: against ED and the port's host engine
SU2_SIGMA_TOL = 1e-12   # 13b: K7's sigma against the host matvec, relative
SU2_POOL_TOL = 1e-12    # 13b: a K5 v2 output pool against its twin, relative
SU2_HUB = dict(kind="hubbard", L=8, n_elec=8, D=120, n_sweeps=6, tol=0.0)
SU2_QC = dict(kind="qc", L=10, n_elec=14, D=500, n_sweeps=6, tol=1e-10)
SU2_DEADLINE = 600      # s: 13b's spawned runs


def su2_system(cfg, twos=0):
    """(driver, SU2MPO) in the driver's SU2 mode for ``cfg``: kind
    "hubbard", the Hubbard chain (U=2, t=1), or "qc", the seeded integrals
    (``seeded_qc_integrals``) with the full SU(2) QC MPO; L sites, n_elec
    electrons, 2S = ``twos``."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    L = cfg["L"]
    if cfg["kind"] == "hubbard":
        fd = FCIDUMP.hubbard(L, u=2, t=1)
        h1e, g2e = fd.h1e, fd.g2e
    else:
        h1e, g2e = seeded_qc_integrals(L)
    drv = DMRGDriver(symm_type=SymmetryTypes.SU2)
    drv.initialize_system(n_sites=L, n_elec=cfg["n_elec"], spin=twos)
    return drv, drv.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=0.0)


def su2_sched(cfg):
    """13a's and 13b's schedule: D multiplets, noise [1e-4, 1e-5, 0],
    Davidson |r|^2 < 1e-12, at most ``n_sweeps`` sweeps, stopping below
    ``tol``."""
    return dict(bond_dims=[cfg["D"]], noises=[1e-4, 1e-5, 0.0],
                thrds=[1e-12], n_sweeps=cfg["n_sweeps"], tol=cfg["tol"],
                iprint=0)


def host_su2(cfg, twos=0):
    """(energy, per-sweep energies, seconds) of ``cfg``'s schedule on the
    port's host engine (backend="numpy"), for a worker."""
    drv, mpo = su2_system(cfg, twos)
    t0 = time.time()
    e = drv.dmrg(mpo, drv.get_random_mps(cfg["D"], seed=7), backend="numpy",
                 **su2_sched(cfg))
    return float(e), list(drv._last_dmrg.energies), time.time() - t0


def su2_hubbard_ed(cfg=SU2_HUB):
    """Lowest eigenvalue of the Hubbard chain's (N, 2Sz=0) sector
    (utils/ed.py): the singlet ground state of the half-filled chain."""
    from block2_preview_tpu_torch.core.expr import qc_term_table
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.utils.ed import ground_state_energy
    fd = FCIDUMP.hubbard(cfg["L"], u=2, t=1)
    return float(ground_state_energy(qc_term_table(fd), cfg["n_elec"], 0,
                                     const_e=fd.const_e)[0])


def su2_run(tag, device, cfg, twos):
    """One SU2-mode ``DMRGDriver.dmrg`` on ``device`` from a count reset;
    prints the energy, the wall time, per sweep the split (blocking: host
    plan build, the pools' host round trip, K5; LW/RW assembly; K7's
    executor set-up; the solve; the decimation) and the launches; fails
    unless K7 launched once a matvec with no host matvec, K5 once a
    blocking step, and no other kernel.  Returns (energy, engine,
    launches)."""
    from block2_preview_tpu_torch.ops import _kernels
    drv, mpo = su2_system(cfg, twos)
    _kernels.reset_counts()
    t0 = time.time()
    e = drv.dmrg(mpo, drv.get_random_mps(cfg["D"], seed=7), device=device,
                 **su2_sched(cfg))
    wall = time.time() - t0
    counts = _kernels.launch_counts()
    eng = drv._last_dmrg
    print(f"[{tag}] L={eng.L} N={eng.T[0]} 2S={eng.T[1]} D={cfg['D']}: E = "
          f"{e:.12f} ({wall:.1f} s, {len(eng.energies)} sweeps, init "
          f"{eng.t_init:.1f} s; K5 {counts['K5_block']} launches for "
          f"{eng.n_blocking} blocking steps ({eng.n_plan_builds} plans "
          f"built, {eng.n_blocking_empty} empty), K7 {counts['K7_tiled']} "
          f"for {eng.n_matvec} matvecs, host matvecs "
          f"{eng.host_matvec_count}; largest bond "
          f"{max(sum(b.values()) for b in eng.bonds)} multiplets)",
          flush=True)
    for i, r in enumerate(eng.sweep_log):
        setup = r["struct"] + r["pack"] + r["tables"]
        print(f"[{tag}] sweep {i} {'->' if r['forward'] else '<-'} "
              f"E {eng.energies[i]:.12f} wall {r['wall']:.2f} s: blocking "
              f"{r['blk']:.2f} (plans {r['blk_plan']:.2f}, round trip "
              f"{r['blk_rt']:.2f}, K5 {r['blk_k5']:.3f}) assembly "
              f"{r['asm']:.2f} K7 set-up {setup:.2f} solve {r['solve']:.2f} "
              f"decimation {r['dm']:.2f}; matvecs {r['matvecs']}",
              flush=True)
    if device.type == "cuda":
        if eng.host_matvec_count or counts["K7_tiled"] != eng.n_matvec:
            fail(f"{tag}: K7 launches {counts['K7_tiled']} != matvecs "
                 f"{eng.n_matvec} or host matvecs {eng.host_matvec_count}")
        if eng.n_blocking_empty or counts["K5_block"] != eng.n_blocking \
                or not eng.n_blocking:
            fail(f"{tag}: K5 launches {counts['K5_block']} for "
                 f"{eng.n_blocking} blocking steps ({eng.n_blocking_empty} "
                 "without a plan)")
        others = {k: c for k, c in counts.items()
                  if c and k not in ("K5_block", "K7_tiled")}
        if others:
            fail(f"{tag}: kernels off the SU(2) path launched: {others}")
    if not np.isfinite(e):
        fail(f"{tag}: energy {e}")
    return float(e), eng, counts


def phase_su2_hubbard(device, host, ed, cfg=SU2_HUB):
    """Phase 13a: Hubbard-L8 (U=2, N=8, 2S=0) at D=120 multiplets (exact),
    6 sweeps, through DMRGDriver(SU2) on the card, against ED (``ed``) and
    the port's host engine on the same schedule (``host``), both to 1e-8
    Ha.  Returns the K5 and K7 launches."""
    e, _, counts = su2_run("13a su2", device, cfg, 0)
    e_host, _, t_host = host.get()
    e_ed = ed.get()
    print(f"[13a su2] ED {e_ed:.12f} dE {e - e_ed:.2e}; host engine "
          f"{e_host:.12f} ({t_host:.1f} s in a worker) dE {e - e_host:.2e}",
          flush=True)
    for what, ref in (("ED", e_ed), ("the host engine", e_host)):
        if not abs(e - ref) < SU2_TOL:
            fail(f"13a: |E - {what}| {abs(e - ref):.3e} >= {SU2_TOL}")
    return counts["K5_block"], counts["K7_tiled"]


def su2_centre(eng, t):
    """Fill the environments the centre t reads (lenvs[t], renvs[t + 2])
    where the last sweep left them stale; on the device path they block on
    K5."""
    for u in range(eng.L - 1, t + 1, -1):
        if eng.renvs[u] is None:
            eng.renvs[u] = eng._right_contract(u)
    for u in range(t):
        if eng.lenvs[u + 1] is None:
            eng.lenvs[u + 1] = eng._left_contract(u)


def su2_kernel_rows(device, eng, t):
    """K7 on the SU(2) adapter and K5 on an SU(2) v2 plan at centre t of
    the engine ``eng``: K7's sigma against the host matvec (the grouped
    GEMMs) to 1e-12 relative and K5's output pool against its twin to
    1e-12 relative, each printed as a phase-3 row with its time, the
    twin's and the bound."""
    import torch
    from block2_preview_tpu_torch.dmrg.su2_fermion import _SU2EffAdapter
    from block2_preview_tpu_torch.dmrg.sweep import _eff_flops
    from block2_preview_tpu_torch.ops import blockv2, exec_bucket
    from block2_preview_tpu_torch.ops.stacked import site_pools
    from block2_preview_tpu_torch.ops.tiled import (TiledExecutor,
                                                    tiled_matvec)
    su2_centre(eng, t)
    keys, dims, offsets, size, _, _, matvec, _ = eng._effective(t)
    LW, RW, ranks = eng._last_ops
    ad = _SU2EffAdapter(keys, dims, offsets, size, LW, RW, ranks, eng.dn)
    ex = TiledExecutor(ad, device=device)
    x = np.random.default_rng(13).standard_normal(size)
    xp = torch.as_tensor(ex.pad(x), device=device)
    dp = exec_bucket.plain_tables(ex.struct, device)

    def k7(fn, d):
        return fn(xp, ex.lpool, ex.rpool, d, ex.size_p)

    sig = k7(tiled_matvec, ex._dev)
    host = torch.as_tensor(matvec(x), device=device)
    rel, _ = rel_err(sig[:size], host)
    print(f"[13b su2] K7 sigma at centre {t} (size {size}, {len(ad.triples)}"
          f" triples) against the host matvec: rel {rel:.2e}", flush=True)
    if not rel <= SU2_SIGMA_TOL:
        fail(f"13b: K7 sigma rel err {rel:.3e} > {SU2_SIGMA_TOL}")
    n_bytes, flops = sigma_bytes_flops(ad, np.float64)
    tab = exec_bucket.chain_tables(ex.struct)
    _check(None, "K7_tiled", np.float64, "su2", sig,
           k7(exec_bucket.bucket_sigma_plain, dp), ATOMIC_TOL[np.float64],
           time_ms(lambda: k7(tiled_matvec, ex._dev), device),
           time_ms(lambda: k7(exec_bucket.bucket_sigma_plain, dp), device),
           None, n_bytes, flops,
           f"SU(2) adapter, centre {t}: size {size} triples "
           f"{len(ad.triples)} items {len(tab['items'])} chunks "
           f"{len(tab['ck'])} true GFLOP {_eff_flops(ad) / 1e9:.3f}")
    ex.free()
    # K5: the cached v2 plan that built lenvs[t] from lenvs[t - 1]
    plan, in_meta, out_meta = eng._blk_cache[(t - 1, "left")][1]
    tdt = torch.float64
    ep = torch.as_tensor(in_meta.pack(eng.lenvs[t - 1]), dtype=tdt,
                         device=device)
    bp, kp = site_pools(plan, device, tdt)
    d5 = blockv2.blk_tables(plan, device, tdt)

    def k5(fn):
        return fn(ep, bp, kp, d5, plan.T, plan.left,
                  torch.zeros(plan.ncap, dtype=tdt, device=device))

    o_k, o_t = k5(blockv2.blk_exec), k5(blockv2.blk_twin)
    rel, _ = rel_err(o_k, o_t)
    out_total = max(o + dx * dy for (o, dx, dy) in out_meta.values())
    n_ent = live_items(plan.cum3)
    k5_bytes = live_bytes(8, in_meta.total + 1 + bp.numel() + kp.numel()
                          + n_ent + out_total,
                          k5_ints(plan._dev["k5"], n_ent))
    print(f"[13b su2] K5 v2 pool at site {t - 1} (left): rel {rel:.2e} "
          "against its twin", flush=True)
    if not rel <= SU2_POOL_TOL:
        fail(f"13b: K5 v2 pool rel err {rel:.3e} > {SU2_POOL_TOL}")
    _check(None, "K5_block", np.float64, "su2", o_k, o_t, SU2_POOL_TOL,
           time_ms(lambda: k5(blockv2.blk_exec), device),
           time_ms(lambda: k5(blockv2.blk_twin), device), None,
           k5_bytes, plan.flops,
           f"SU(2) v2 plan, site {t - 1} left: T {plan.T} items "
           f"{live_items(plan.cum1)} entries {n_ent} out {out_total} GFLOP "
           f"{plan.flops / 1e9:.3f}; {k5_shape(plan)}")
    if float(o_k[out_total:].abs().max()) != 0.0:
        fail("13b: K5 wrote past the SU(2) pool's live end")


def su2_proc(device, cfg, twos, rows, go, queue):
    """One 13b spin in a spawned process (the two spins' host assembly
    runs side by side): :func:`su2_run`, and with ``rows`` the kernel rows
    at the middle centre once ``go`` is set (so that they time the kernels
    on an otherwise idle card); puts (2S, {energy, launches}) on
    ``queue``, or (2S, {"error": ...}) if it failed."""
    import traceback
    try:
        from block2_preview_tpu_torch.runtime import resolve_device
        dev = resolve_device(device)
        e, eng, counts = su2_run(f"13b su2 2S={twos}", dev, cfg, twos)
        if rows:
            if not go.wait(SU2_DEADLINE):
                raise TimeoutError("the kernel rows were never let go")
            su2_kernel_rows(dev, eng, eng.L // 2 - 1)
        queue.put((twos, {"e": e, "K5_block": counts["K5_block"],
                          "K7_tiled": counts["K7_tiled"]}))
    except BaseException:
        queue.put((twos, {"error": traceback.format_exc()}))


def spawn_procs(jobs, tag, go=None, deadline=SU2_DEADLINE, threads=3):
    """Start each job {key: (target, args)} in a spawned process (their
    numerical libraries held to ``threads`` threads each); a target is
    called as target(*args, queue) and puts (key, result) on the queue, or
    (key, {"error": traceback}).  Returns a function that sets ``go`` (a
    spawn-context Event, if given), waits for every result, kills any
    process still alive at the deadline, and returns {key: result}; a
    missing result or an error fails the phase ``tag``."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    env = {k: str(threads) for k in ("OMP_NUM_THREADS",
                                     "OPENBLAS_NUM_THREADS",
                                     "MKL_NUM_THREADS")}
    saved = {k: os.environ.get(k) for k in env}
    procs = {key: ctx.Process(target=target, args=(*args, q))
             for key, (target, args) in jobs.items()}
    os.environ.update(env)
    try:
        for p in procs.values():
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    t_end = time.time() + deadline

    def wait():
        if go is not None:
            go.set()
        res = {}
        try:
            while len(res) < len(procs) and time.time() < t_end:
                try:
                    key, out = q.get(timeout=2)
                    res[key] = out
                except queue_mod.Empty:
                    if any(p.exitcode is not None and key not in res
                           for key, p in procs.items()):
                        break
        finally:
            for p in procs.values():
                p.join(timeout=10 if len(res) == len(procs) else 1)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        for key in procs:
            if key not in res:
                fail(f"{tag} {key}: no result within {deadline} s (exit "
                     f"code {procs[key].exitcode})")
            if "error" in res[key]:
                fail(f"{tag} {key} raised:\n{res[key]['error']}")
        return res
    return wait


def su2_spawn(device, cfg, deadline=SU2_DEADLINE):
    """Start 13b's two spins (2S=2, 2S=0; the kernel rows with 2S=0, let
    go when the returned function is called) in spawned processes on
    ``device`` (:func:`spawn_procs`)."""
    import multiprocessing as mp
    go = mp.get_context("spawn").Event()
    return spawn_procs({tw: (su2_proc, (str(device), cfg, tw, tw == 0, go))
                        for tw in (2, 0)}, "13b 2S=", go=go,
                       deadline=deadline)


def phase_su2_qc(runs, hosts):
    """Phase 13b: the seeded K=10 QC system with 14 electrons (full SU(2)
    QC MPO) at D=500 multiplets, noise [1e-4, 1e-5, 0], at most 6 sweeps,
    tol 1e-10, for 2S=2 and 2S=0 through DMRGDriver(SU2) on the card
    (``runs``: :func:`su2_spawn`'s wait; the launch rules and the kernel
    rows at the middle centre held in the runs): each energy within 1e-8
    Ha of the port's host engine on the same schedule (``hosts``: {2S:
    worker result}), E(2S=2) < E(2S=0).  Returns the K5 and K7 launches of
    the two runs."""
    res = runs()
    for twos, r in sorted(res.items(), reverse=True):
        e_host, sweeps, t_host = hosts[twos].get()
        print(f"[13b su2] 2S={twos}: {r['e']:.12f}, host engine "
              f"{e_host:.12f} ({t_host:.1f} s in a worker, {len(sweeps)} "
              f"sweeps) dE {r['e'] - e_host:.2e}", flush=True)
        if not abs(r["e"] - e_host) < SU2_TOL:
            fail(f"13b 2S={twos}: |dE| {abs(r['e'] - e_host):.3e} >= "
                 f"{SU2_TOL}")
    if not res[2]["e"] < res[0]["e"]:
        fail(f"13b: E(2S=2) {res[2]['e']:.12f} is not below E(2S=0) "
             f"{res[0]['e']:.12f}")
    return (sum(r["K5_block"] for r in res.values()),
            sum(r["K7_tiled"] for r in res.values()))


@contextlib.contextmanager
def noise_peaks(device):
    """Wraps the noise call (resident.noise_exec, K6) while the block
    runs: yields a dict with its ``calls``, the largest device memory one
    call allocated above what it found (``peak``, bytes) and the run's
    peak before the last call (``before``: the counter is reset around
    each call, so the run's peak is the larger of it and
    max_memory_allocated after the block)."""
    import torch
    from block2_preview_tpu_torch.ops import resident
    orig = resident.noise_exec
    out = {"calls": 0, "peak": 0, "before": 0}
    cuda = device.type == "cuda"

    def wrapped(*a, **k):
        out["calls"] += 1
        if not cuda:
            return orig(*a, **k)
        out["before"] = max(out["before"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        r = orig(*a, **k)
        out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated() - m0)
        return r

    resident.noise_exec = wrapped
    try:
        yield out
    finally:
        resident.noise_exec = orig


def k3_table_seconds(solver):
    """(plans, seconds) of K3's host tables over the plans a resident
    run holds at its end: its mix v4 plans and v3 blocking plans, each
    with the build time kept in its own ``_dev["k3"]``."""
    plans = [p for _, p in list(solver._res_caches.get("mix", {}).values())
             + list(solver.me._stk_plans.values())]
    hs = [h for h in (getattr(p, "_dev", None) or {} for p in plans)
          if "k3" in h]
    return len(hs), sum(h["k3"]["seconds"] for h in hs)


def phase_full(device, drv, mpo, D=250, n_orb=16):
    """Main path at full width; returns the kernel launch counts of the
    run, the MPS it leaves, its energy and its sweep-0 energy.

    Two sweeps from a random MPS are far from converged, so the energy
    after them depends to first order on each site's eigenvector, and
    the port's Davidson (M=20, thick restart) and the host's (M=30,
    restart to one vector) stop at different vectors within the
    residual threshold.  At |r|^2 < 1e-10 that alone moves the two
    energies ~2e-6 Ha apart (K=10, D=80 on the CPU), so both solve to
    |r|^2 < 1e-14 and the gap measures the port, not the threshold."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ket = drv.get_random_mps(D, seed=11)
    _kernels.reset_counts()
    t0 = time.time()
    with noise_peaks(device) as npk:
        e_port = drv.dmrg(mpo, ket, device=device, **qc_sched(D))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.time()
    counts = _kernels.launch_counts()
    solver = drv._last_dmrg
    for i, r in enumerate(solver.sweep_log):
        print(f"[5 full] sweep {i} D={D} E {r['energy']:.10f} wall "
              f"{r['wall']:.1f} s  Teff {r['teff']:.1f} Teig {r['teig']:.1f} "
              f"Tdm {r['tdm']:.1f} Tblk {r['tblk']:.1f}", flush=True)
    n_k3, k3_s = k3_table_seconds(solver)
    print(f"[5 full] K3 host tables: {n_k3} plans (mix and v3 blocking) "
          f"held at the end, {k3_s:.3f} s to build them, "
          f"{k3_s / max(len(solver.sweep_log), 1):.3f} s a sweep (inside "
          f"Teff and Tblk)", flush=True)
    mem = (max(torch.cuda.max_memory_allocated(), npk["before"]) / 2 ** 30
           if device.type == "cuda" else float("nan"))
    print(f"[5 full] noise calls {npk['calls']}: peak of one call "
          f"{npk['peak'] / 2 ** 20:.2f} MiB above what it found allocated",
          flush=True)
    print(f"[5 full] port total {t1 - t0:.1f} s  launches {counts}  "
          f"max_memory_allocated {mem:.2f} GiB  largest ROT pool "
          f"{solver.me.max_rot_pool} elements  host_redo_count "
          f"{solver.host_redo_count}  host_env_materialized "
          f"{solver.host_env_materialized}  host_ops_downloads "
          f"{solver.host_ops_downloads}", flush=True)
    for what in ("host_redo_count", "host_env_materialized",
                 "host_ops_downloads"):
        if getattr(solver, what) != 0:
            fail(f"{what} {getattr(solver, what)}")
    return counts, ket, e_port, solver.sweep_log[0]["energy"]


def check_full(e_port, ref, n_orb=16):
    """Phase 5's energy against the host reference ``ref`` = (energy,
    seconds) of :func:`timed_host_reference` on the same schedule."""
    e_ref, secs = ref
    de = e_port - e_ref
    print(f"[5 full] K={n_orb} QC host reference {e_ref:.10f} ({secs:.1f} "
          f"s)  port {e_port:.10f}  dE {de:.2e}", flush=True)
    if not abs(de) < QC_TOL:
        fail(f"QC |dE| {abs(de):.3e} >= {QC_TOL}")


def qc_sched(D, n_sweeps=2):
    """Phase 5's schedule (see phase_full), or its first ``n_sweeps``."""
    return dict(bond_dims=[D] * n_sweeps, noises=[1e-4, 0][:n_sweeps],
                thrds=[1e-14], n_sweeps=n_sweeps, tol=0, iprint=0)


def timed_host_reference(mpo, mps, sched):
    """(energy, seconds) of :func:`_host_reference`."""
    t0 = time.time()
    return _host_reference(mpo, mps, sched), time.time() - t0


def host_pool(threads: int = 3, workers: int = 3):
    """Worker processes (spawned, their numerical libraries held to
    ``threads`` threads each) for the host references of phases 5, 3, 10a
    and 10b, so that they run beside the device phases instead of after
    them.  Use it in a ``with`` block: leaving the block terminates the
    workers."""
    import multiprocessing as mp
    import os
    env = {k: str(threads) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                     "MKL_NUM_THREADS")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return mp.get_context("spawn").Pool(workers)  # they start here
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# phase 10: density matrices (K17), the chip probes (K19), PlanExecutor (K18)
# ---------------------------------------------------------------------------

def rdm_energy(h1e, g2e, ecore, dm1, dm2):
    """<H> from the spatial 1PDM and 2PDM (dm2[i, j, k, l] = sum_st
    <c+_is c+_jt c_kt c_ls>): H = sum h_ij E_ij + 1/2 sum (ij|kl)
    c+_is c+_kt c_lt c_js (tests/test_pdm.py's convention)."""
    return float(ecore + np.einsum("ij,ij->", h1e, dm1)
                 + 0.5 * np.einsum("ijkl,iklj->", g2e, dm2))


def hubbard_npdm_states(device, L=8, D=80, ns=6):
    """Phase 10a's states: a port ground state of Hubbard-L (phase 4's
    schedule and start) and a second state (D=30, 2 sweeps from seed 3).
    Returns (drv, mpo, fd, ket, bra)."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    drv.dmrg(mpo, drv.get_random_mps(D, seed=7), bond_dims=[D] * ns,
             noises=[1e-5] * ns + [0], thrds=[1e-10], n_sweeps=ns, tol=0,
             iprint=0, device=device)
    ket = drv._last_dmrg.mps
    Db = min(D, 30)
    drv.dmrg(mpo, drv.get_random_mps(Db, seed=3), bond_dims=[Db, Db],
             noises=[1e-4, 0], thrds=[1e-8], n_sweeps=2, tol=0, iprint=0,
             device=device)
    return drv, mpo, fd, ket, drv._last_dmrg.mps


def npdm_host_refs(ket, bra):
    """Phase 10a's host references (a worker): the determinant path
    (npdm_spatial) orders 1-4, pdm3_spatial, and the transition 1PDM and
    3PDM <bra|..|ket> by determinants; with the seconds spent."""
    from block2_preview_tpu_torch.dmrg.expect import pdm3_spatial
    from block2_preview_tpu_torch.dmrg.npdm import npdm_spatial
    t0 = time.time()
    out = {f"det{k}": npdm_spatial(ket, k) for k in (1, 2, 3, 4)}
    out["tdet1"] = npdm_spatial(ket, 1, bra=bra)
    out["tdet3"] = npdm_spatial(ket, 3, bra=bra)
    out["pdm3"] = pdm3_spatial(ket)
    out["secs"] = time.time() - t0
    return out


def host_gram(mps, order):
    """(G, seconds) of pooled_gram with every class close on host BLAS
    (device=None) — the host side of phase 10b (a worker)."""
    from block2_preview_tpu_torch.dmrg.npdm_scheme import pooled_gram
    t0 = time.time()
    G, _ = pooled_gram(mps, order, device=None)
    return G, time.time() - t0


def host_expectation(mpo, mps):
    """(<mps|H|mps>, seconds) by DMRGDriver.expectation (a worker)."""
    from block2_preview_tpu_torch.driver.core import DMRGDriver
    t0 = time.time()
    return DMRGDriver().expectation(mps, mpo, mps), time.time() - t0


def _hold(tag, got, ref, tol):
    d = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    print(f"[{tag}] max |d| {d:.2e}", flush=True)
    if not d <= tol:
        fail(f"{tag}: max |d| {d:.3e} > {tol:.0e}")
    return d


def phase_npdm_hubbard(device, drv, mpo, fd, ket, bra, refs):
    """Phase 10a (see the module docstring); ``refs`` from
    :func:`npdm_host_refs`.  Returns the K17 launches of the
    threshold-0 runs."""
    from block2_preview_tpu_torch.dmrg.npdm import gram_to_spatial
    from block2_preview_tpu_torch.dmrg.npdm_scheme import pooled_gram
    from block2_preview_tpu_torch.ops import _kernels
    L = ket.n_sites
    print(f"[10a npdm] Hubbard-L{L} host references (worker) "
          f"{refs['secs']:.1f} s", flush=True)
    t0 = time.time()
    dm1 = drv.get_npdm(ket, 1)
    dm2 = drv.get_npdm(ket, 2)
    print(f"[10a npdm] get_npdm orders 1-2 (host engine) "
          f"{time.time() - t0:.1f} s; order 2's singlet shortcut "
          f"(2 aa + 2 ab) differs from the full 2PDM by "
          f"{np.abs(dm2 - refs['det2']).max():.2e} (the state's spin "
          f"contamination)", flush=True)
    _hold("10a npdm order 1 get_npdm vs det", dm1.sum(axis=0), refs["det1"],
          PDM_TOL)
    _hold("10a npdm order 2 get_trans_2pdm(ket, ket) vs det",
          drv.get_trans_2pdm(ket, ket), refs["det2"], PDM_TOL)
    for k in (3, 4):
        _kernels.reset_counts()
        t0 = time.time()
        got = drv.get_npdm(ket, k, algo="poly", device=device)
        print(f"[10a npdm] get_npdm order {k} poly {time.time() - t0:.1f} s"
              f" K17 {_kernels.launch_counts()['K17_npdm_gemm']}",
              flush=True)
        _hold(f"10a npdm order {k} get_npdm poly vs det", got,
              refs[f"det{k}"], PDM_TOL)
        if k == 3:
            _hold("10a npdm order 3 get_npdm poly vs pdm3_spatial", got,
                  refs["pdm3"], PDM_TOL)
    k17 = 0
    for k in (1, 2, 3, 4):
        st = {}
        _kernels.reset_counts()
        G, combos = pooled_gram(ket, k, device=device, device_min_flop=0,
                                stats=st)
        n_dev = sum(1 for c in st["closes"] if c[5])
        launches = _kernels.launch_counts()["K17_npdm_gemm"]
        k17 += launches
        print(f"[10a npdm] pooled_gram order {k} device_min_flop=0: "
              f"{st['total']:.1f} s (pools {st['pools']:.1f} closes "
              f"{st['close']:.1f} scatter {st['scatter']:.1f}) closes "
              f"{len(st['closes'])} on the device {n_dev} K17 {launches}",
              flush=True)
        if device.type == "cuda" and launches != len(st["closes"]):
            fail(f"10a order {k}: K17 launches {launches} != closes "
                 f"{len(st['closes'])}")
        _hold(f"10a npdm order {k} pooled_gram (K17) vs det",
              gram_to_spatial(G, combos, L, k), refs[f"det{k}"], PDM_TOL)
    _hold("10a npdm transition 1PDM get_trans_1pdm vs det",
          drv.get_trans_1pdm(bra, ket).sum(axis=0), refs["tdet1"], PDM_TOL)
    _hold("10a npdm transition 3PDM get_trans_3pdm (poly) vs det",
          drv.get_trans_3pdm(bra, ket, device=device), refs["tdet3"],
          PDM_TOL)
    e_rdm = rdm_energy(fd.h1e, fd.g2e, fd.const_e, dm1.sum(axis=0), dm2)
    e_mpo = drv.expectation(ket, mpo, ket)
    de = e_rdm - e_mpo
    print(f"[10a npdm] energy from the 1PDM and 2PDM {e_rdm:.12f}  "
          f"expectation {e_mpo:.12f}  dE {de:.2e}", flush=True)
    if not abs(de) < RDM_E_TOL:
        fail(f"10a: RDM energy |dE| {abs(de):.3e} >= {RDM_E_TOL}")
    return k17


def _gram_run(device, tag, mps, order, ref):
    """One device Gram of phase 10b against the host Gram ``ref`` =
    (G, seconds); returns (the spatial PDM, stats, K17 launches)."""
    from block2_preview_tpu_torch.dmrg.npdm import gram_to_spatial
    from block2_preview_tpu_torch.dmrg.npdm_scheme import pooled_gram
    from block2_preview_tpu_torch.ops import _kernels
    st = {}
    _kernels.reset_counts()
    G, combos = pooled_gram(mps, order, device=device, stats=st)
    launches = _kernels.launch_counts()["K17_npdm_gemm"]
    dev = [c for c in st["closes"] if c[5]]
    gf = sum(2.0 * n * X * m for (_, _, n, X, m, _) in dev) / 1e9
    big = max(dev, key=lambda c: c[2] * c[3] * c[4], default=None)
    G_h, secs = ref
    print(f"[{tag}] order {order}: {st['total']:.1f} s (host pools "
          f"{st['pools']:.1f} closes {st['close']:.1f} scatter "
          f"{st['scatter']:.1f}) closes {len(st['closes'])}, on the device "
          f"{len(dev)} ({gf:.2f} GFLOP; largest bond {big and big[0]} "
          f"[{big and big[2]} x {big and big[3]}] @ [{big and big[3]} x "
          f"{big and big[4]}]) K17 {launches}; G {G.shape[0]}^2; host Gram "
          f"(worker) {secs:.1f} s", flush=True)
    if device.type == "cuda" and launches != len(dev):
        fail(f"{tag} order {order}: K17 launches {launches} != device "
             f"closes {len(dev)}")
    _hold(f"{tag} order {order} device Gram vs host Gram", G, G_h, GRAM_TOL)
    return gram_to_spatial(G, combos, mps.n_sites, order), st, launches


def _largest(st):
    """(n, X, m) of the largest device close of a pooled_gram run."""
    dev = [c for c in st["closes"] if c[5]]
    return max(dev, key=lambda c: c[2] * c[3] * c[4])[2:5] if dev else None


def phase_npdm_wide(device, mps, h1e, g2e, refs, e_ref, mps12, ref12):
    """Phase 10b (see the module docstring): the 1PDM and 2PDM of the
    K=16 state ``mps`` (``refs`` the host Grams of orders 1 and 2,
    ``e_ref`` = (expectation, seconds)), then the 3PDM of the K=12 state
    ``mps12`` against its host Gram ``ref12``.  Returns (K17 launches,
    the (n, X, m) of the largest device close of each run that had
    one)."""
    import torch
    tag = "10b npdm"
    cuda = device.type == "cuda"
    k17, shapes, dms = 0, [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for order, ref in zip((1, 2), refs):
        dm, st, n = _gram_run(device, tag, mps, order, ref)
        dms.append(dm)
        k17 += n
        shapes.append(_largest(st))
    e_rdm = rdm_energy(h1e, g2e, 0.0, dms[0], dms[1])
    de = e_rdm - e_ref[0]
    mem = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda \
        else float("nan")
    print(f"[{tag}] K={mps.n_sites} energy from the 1PDM and 2PDM "
          f"{e_rdm:.10f}  expectation (worker, {e_ref[1]:.1f} s) "
          f"{e_ref[0]:.10f}  dE {de:.2e}  max_memory_allocated {mem:.2f} "
          f"GiB", flush=True)
    if not abs(de) < RDM_E_TOL:
        fail(f"{tag}: RDM energy |dE| {abs(de):.3e} >= {RDM_E_TOL}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _, st, n = _gram_run(device, f"{tag} K={mps12.n_sites}", mps12, 3,
                         ref12)
    k17 += n
    shapes.append(_largest(st))
    mem = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda \
        else float("nan")
    print(f"[{tag}] K={mps12.n_sites} 3PDM max_memory_allocated "
          f"{mem:.2f} GiB", flush=True)
    if cuda and k17 == 0:
        fail(f"{tag}: K17 never launched")
    return k17, [x for x in shapes if x is not None]


def qc12_state(device, n_orb=12, D=100):
    """Phase 10b's 12-orbital state: the seeded K=12 QC (12 electrons)
    solved by the port at D=100, 2 sweeps from get_random_mps(100,
    seed=11).  Returns the MPS."""
    drv, mpo, _ = qc_system(n_orb, n_orb)
    t0 = time.time()
    e = drv.dmrg(mpo, drv.get_random_mps(D, seed=11), device=device,
                 **dict(qc_sched(D), thrds=[1e-10]))
    print(f"[10b npdm] K={n_orb} QC D={D} 2 sweeps E {e:.10f} "
          f"({time.time() - t0:.1f} s)", flush=True)
    return drv._last_dmrg.mps


def phase_probes(device, pool_elems=1 << 27, tiled=(8, 120, 6)):
    """Phase 10c: gpu_smoke.run_smoke on ``device`` and the TF32 negative
    control of its precision probe.  Returns the K19 launches of
    run_smoke."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels
    from block2_preview_tpu_torch.runtime import set_precision_policy
    from block2_preview_tpu_torch.utils import gpu_smoke
    _kernels.reset_counts()
    t0 = time.time()
    res = gpu_smoke.run_smoke(device, pool_elems=pool_elems, tiled=tiled)
    k19 = _kernels.launch_counts()["K19_probe"]
    print(f"[10c probes] run_smoke {time.time() - t0:.1f} s: "
          f"{json.dumps(res)}  K19 {k19}", flush=True)
    if not res["ok"]:
        fail(f"10c: a probe failed ({res})")
    if device.type == "cuda" and k19 == 0:
        fail("10c: K19 never launched")
    # negative control: TF32 in the float32 matmul must be caught
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = gpu_smoke.precision_probe(device)
    finally:
        set_precision_policy()
    print(f"[10c probes] TF32 control (allow_tf32=True): {json.dumps(ctl)}",
          flush=True)
    if device.type == "cuda" and ctl["ok"]:
        fail("10c: the precision probe passed with TF32 switched on")
    return k19


def plan_exec_check(device, eff, tag, rows=None):
    """PlanExecutor (K18) at one center ``eff``: f64 and f32 against its
    twin on the same stacks, and f64 against K8's sigma (BucketExecutor)
    to 1e-12 relative; prints the true against the padded GFLOP and K18's
    table build.  With ``rows`` the f64 case feeds the JSON row."""
    import torch
    from block2_preview_tpu_torch.ops import exec_bucket
    rng = np.random.default_rng(9)
    x = rng.standard_normal(eff.size)
    for dtype in (np.float64, np.float32):
        t0 = time.time()
        ex = exec_bucket.PlanExecutor(eff, dtype=dtype, device=device)
        t_build = time.time() - t0
        tab = ex.chain_tables()
        xp = torch.as_tensor(np.concatenate([x, np.zeros(ex.size_p + 1
                                                         - ex.size)]),
                             dtype=ex.vals.dtype, device=device)

        def k18():
            return exec_bucket.plan_exec(xp, ex)

        def twin():
            return exec_bucket.plan_exec_plain(xp, ex.device_buckets,
                                               ex.size_p + 1)

        n_bytes, flops = sigma_bytes_flops(eff, dtype)
        pad = sum(2.0 * A.shape[0] * A.shape[1] * R.shape[2]
                  * (A.shape[2] + R.shape[1])
                  for (A, R, _, _) in ex.device_buckets)
        _check(rows if dtype == np.float64 else None, "K18_plan_exec",
               dtype, tag, k18(), twin(), ATOMIC_TOL[dtype],
               time_ms(k18, device), time_ms(twin, device), None, n_bytes,
               flops, f"size {eff.size} triples {len(eff.triples)} buckets "
               f"{len(ex.device_buckets)} padded A+R {ex.vals.numel()} "
               f"GFLOP true {flops / 1e9:.2f} (the chain items' "
               f"{tab['flops'] / 1e9:.2f}) padded {pad / 1e9:.2f}; items "
               f"{len(tab['items'])} chunks {len(tab['ck'])} (tables "
               f"{tab['seconds']:.3f} s); stacks built in {t_build:.1f} s")
        if dtype == np.float64:
            got = ex.matvec(x)
            bx = exec_bucket.BucketExecutor(eff, dtype=dtype, device=device)
            ref = bx.matvec(x)
            bx.free()
            rel = float(np.abs(got - ref).max() / np.abs(ref).max())
            print(f"[10d plan] {tag}: PlanExecutor.matvec (K18) vs K8's "
                  f"sigma rel {rel:.2e}", flush=True)
            if not rel < 1e-12:
                fail(f"K18 vs K8 at {tag}: rel {rel:.3e} >= 1e-12")
        del ex


def hubbard_center(L=8, D=60, t=3):
    """The effective Hamiltonian at the Hubbard-L center t of an MPS after
    2 host sweeps at bond dimension D (phases 10d and 11b)."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
    mps = drv.get_random_mps(D, seed=1234)
    drv.dmrg(mpo, mps, bond_dims=[D, D], noises=[1e-4, 1e-4], thrds=[1e-8],
             n_sweeps=2, tol=0, iprint=0, backend="numpy")
    me, _ = mid_site(mpo, drv._last_dmrg.mps, t)
    return EffectiveHamiltonian2(me, t)


def phase_plan_exec(device, L=8, D=60, t=3):
    """Phase 10d: PlanExecutor at the Hubbard-L8 center t of an MPS after
    2 host sweeps at D=60.  Returns the K18 launches of the run."""
    from block2_preview_tpu_torch.ops import _kernels
    eff = hubbard_center(L, D, t)
    _kernels.reset_counts()
    plan_exec_check(device, eff, f"L{L}c{t}")
    k18 = _kernels.launch_counts()["K18_plan_exec"]
    print(f"[10d plan] Hubbard-L{L} center {t}: K18 {k18}", flush=True)
    if device.type == "cuda" and k18 == 0:
        fail("10d: K18 never launched")
    return k18


K17_EDGE = [(n, X, m) for n in (1, 4, 8, 16, 17, 100, 200)
            for X in (5, 257, 19545) for m in (1, 7, 1542)]


def k17_hold(tag, dM, dV, dtype):
    """Hold one K17 launch against its twin to ATOMIC_TOL and a second
    launch on the same inputs bitwise (the fixed-order sum of the split);
    returns (the first launch's result, its relative error)."""
    import torch
    from block2_preview_tpu_torch.ops import npdm_gemm
    got = npdm_gemm.npdm_gemm(dM, dV)
    again = npdm_gemm.npdm_gemm(dM, dV)
    if got.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"K17 {tag}: two launches on the same inputs differ")
    rel, _ = rel_err(got, npdm_gemm.npdm_gemm_plain(dM, dV))
    if not rel <= ATOMIC_TOL[dtype]:
        fail(f"K17 {tag}: rel err {rel:.3e} > {ATOMIC_TOL[dtype]:.0e}")
    return got, rel


def phase_k17_edges(device, shapes=K17_EDGE):
    """K17 at the edge ``shapes`` (n across both regimes and the
    threshold, X and m odd and even, one and many slices) and on a V that
    is not 16-byte aligned (8-byte copies), f64 and c128, seeded on the
    device: each against its twin and bitwise against a second launch."""
    import torch
    from block2_preview_tpu_torch.ops import npdm_gemm
    gen = torch.Generator(device=device).manual_seed(17)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 132)
    t0, worst = time.time(), 0.0
    for dt in (torch.float64, torch.complex128):
        dtype = np.float64 if dt == torch.float64 else np.complex128
        for n, X, m in shapes:
            dM = torch.randn((n, X), generator=gen, dtype=dt, device=device)
            dV = torch.randn((X, m), generator=gen, dtype=dt, device=device)
            p = npdm_gemm.plan(n, X, m, sms, dt.is_complex)
            worst = max(worst, k17_hold(
                f"{dtype.__name__} [{n} x {X}] @ [{X} x {m}] {p}", dM, dV,
                dtype)[1])
        flat = torch.randn(257 * 1542 + 1, generator=gen, dtype=dt,
                           device=device)
        dV = flat[1:].view(257, 1542)          # 8 bytes past an alignment
        for n in (8, 100):
            dM = torch.randn((n, 257), generator=gen, dtype=dt,
                             device=device)
            worst = max(worst, k17_hold(f"{dtype.__name__} unaligned V, n "
                                        f"{n}", dM, dV, dtype)[1])
    print(f"[3 kernels] K17 edges: {len(shapes)} shapes + 2 on an unaligned "
          f"V, f64 and c128, max rel err {worst:.2e} (<= "
          f"{ATOMIC_TOL[np.float64]:.0e}), two launches bitwise equal "
          f"({time.time() - t0:.1f} s)", flush=True)


def phase_new_kernels(device, shapes, eff, t):
    """Phase-3 rows of K17 (at the largest class closes ``shapes`` of
    phase 10b, seeded values; f64 and complex128; library one
    torch.matmul; each also bitwise against a second launch), K18
    (PlanExecutor at center t of the K=16 MPS, f64 and f32, and against
    K8) and K19 (dot of 2048 values, library torch.dot; fill of 2^27).
    Returns the summary rows."""
    import torch
    from block2_preview_tpu_torch.ops import _kernels, npdm_gemm
    from block2_preview_tpu_torch.utils import gpu_smoke
    rows = {}
    rng = np.random.default_rng(17)
    for n, X, m in shapes:
        for dtype in (np.float64, np.complex128):
            M = rng.standard_normal((n, X))
            V = rng.standard_normal((X, m))
            if dtype == np.complex128:
                M = M + 1j * rng.standard_normal((n, X))
                V = V + 1j * rng.standard_normal((X, m))
            dM = torch.as_tensor(M, device=device)
            dV = torch.as_tensor(V, device=device)
            esz = np.dtype(dtype).itemsize
            _check(rows if dtype == np.float64 else None, "K17_npdm_gemm",
                   dtype, "", k17_hold(f"[{n} x {X}] @ [{X} x {m}]", dM, dV,
                                       dtype)[0],
                   npdm_gemm.npdm_gemm_plain(dM, dV), ATOMIC_TOL[dtype],
                   time_ms(lambda: npdm_gemm.npdm_gemm(dM, dV), device,
                           ROW_REPS),
                   time_ms(lambda: npdm_gemm.npdm_gemm_plain(dM, dV),
                           device, ROW_REPS),
                   time_ms(lambda: torch.matmul(dM, dV), device,
                           ROW_REPS),
                   esz * (n * X + X * m + n * m),
                   (8 if dtype == np.complex128 else 2) * n * X * m,
                   f"[{n} x {X}] @ [{X} x {m}]")
            del dM, dV
    plan_exec_check(device, eff, f"c{t}", rows)
    a, b = (torch.as_tensor(v, device=device)
            for v in gpu_smoke.precision_inputs())
    got = gpu_smoke.dot(a, b)
    if got.shape != () or got.dtype != torch.float32:
        fail(f"K19 dot: a {got.dtype} of shape {tuple(got.shape)}")
    if device.type == "cuda":
        k19_stream_check(device, a, b)
        dot_us, lib_us = (host_us(lambda: f(a, b), device)
                          for f in (gpu_smoke.dot, torch.dot))
        call_us = launch_path_us(_kernels, a, b, device)
        print(f"[3 kernels] K19 dot host per call ({HOST_CALLS} calls): "
              f"gpu_smoke.dot {dot_us:.2f} us, torch.dot {lib_us:.2f} us,"
              f" _kernels.call {call_us:.2f} us", flush=True)
    _check(rows, "K19_probe", np.float32, "dot", got[None],
           gpu_smoke.dot_plain(a, b)[None], F32_TOL,
           time_ms(lambda: gpu_smoke.dot(a, b), device, ROW_REPS),
           time_ms(lambda: gpu_smoke.dot_plain(a, b), device, ROW_REPS),
           None, 4 * (2 * a.numel() + 1), 2 * a.numel(),
           f"{a.numel()} values; torch.dot "
           f"{time_ms(lambda: torch.dot(a, b), device, ROW_REPS):.4f} ms")
    n = gpu_smoke.POOL_ELEMS if device.type == "cuda" else 1 << 20
    x = torch.ones(1024, dtype=torch.float32, device=device)
    _check(rows, "K19_probe", np.float32, "fill",
           gpu_smoke.fill(x, n)[None], gpu_smoke.fill_plain(x, n)[None],
           0.0, time_ms(lambda: gpu_smoke.fill(x, n), device),
           time_ms(lambda: gpu_smoke.fill_plain(x, n), device), None,
           4 * (x.numel() + n + 1), n, f"pool {n} values")
    return summary_rows(rows)


# ---------------------------------------------------------------------------
# phase 11: the operator-sharded engines (K20-K22) on torch.distributed
# ---------------------------------------------------------------------------

SHARD_TOL = 1e-8    # Ha: 11a/11b against phases 4/5 (the reference's own
                    # bar for sharded vs one device at D=250)
RANK_TIMEOUT = 600  # s: the process groups' timeout and 11b's deadline


def hubbard_model(L=8):
    """(driver, MPO) of Hubbard-L, U=2, t=1, half filling."""
    from block2_preview_tpu_torch.core.fcidump import FCIDUMP
    from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
    fd = FCIDUMP.hubbard(L, u=2, t=1)
    drv = DMRGDriver(symm_type=SymmetryTypes.SZ)
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    return drv, drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)


def hub_sched(D=80, ns=6):
    """Phase 4's schedule."""
    return dict(bond_dims=[D] * ns, noises=[1e-5] * ns + [0],
                thrds=[1e-10], n_sweeps=ns, tol=0, iprint=0)


def mps_digest(mps) -> str:
    """A hash of every block of ``mps``: equal digests are bitwise-equal
    states."""
    import hashlib
    h = hashlib.sha1()
    for t in mps.tensors:
        for k in sorted(t.blocks, key=repr):
            h.update(repr(k).encode())
            h.update(np.ascontiguousarray(t.blocks[k]).tobytes())
    return h.hexdigest()


def _shard_sweeps(solver):
    """Per sweep of a sharded run: the numbers phase 11 prints."""
    out = []
    for r in solver.sweep_log:
        out.append({k: r[k] for k in ("energy", "wall", "teff", "teig",
                                      "tdm", "tblk", "matvecs",
                                      "idle_matvecs", "all_reduce",
                                      "all_reduce_s")})
        for k in ("K1_matvec", "K5_block", "K20_matvec_shard",
                  "K21_block_shard"):
            out[-1][k] = r["launches"][k]
        for k in ("K20_matvec_shard", "K21_block_shard"):
            out[-1][k + "_units"] = r["units"][k]
    return out


def phase_shard_one(device, e_ref, L=8, D=80, ns=6):
    """Phase 11a: a mesh of world size 1 (NCCL on the card, gloo on the
    CPU; file rendezvous) in this process, phase 4's start and schedule on
    torch_resident with the mesh, against phase 4's host energy
    ``e_ref``.  The group is destroyed after.  Returns the launches."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from block2_preview_tpu_torch.ops import _kernels
    from block2_preview_tpu_torch.parallel.multihost import (
        init_mesh, time_collectives)
    drv, mpo = hubbard_model(L)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_mesh(f"file://{tmp}/rendezvous", 1, 0,
                         device_type=device.type,
                         timeout=timedelta(seconds=RANK_TIMEOUT))
        time_collectives()
        try:
            _kernels.reset_counts()
            t0 = time.time()
            e = drv.dmrg(mpo, drv.get_random_mps(D, seed=7), device=device,
                         mesh=mesh, **hub_sched(D, ns))
            secs = time.time() - t0
            counts = _kernels.launch_counts()
            backend = dist.get_backend()
        finally:
            time_collectives(False)
            dist.destroy_process_group()
    sw = _shard_sweeps(drv._last_dmrg)
    print(f"[11a shard] world 1 ({backend}) Hubbard-L{L} D={D} x{ns} E "
          f"{e:.12f} ({secs:.1f} s)  phase 4 host {e_ref:.12f} dE "
          f"{e - e_ref:.2e}  K20 {counts['K20_matvec_shard']} K21 "
          f"{counts['K21_block_shard']} K1 {counts['K1_matvec']} K5 "
          f"{counts['K5_block']}  all_reduce "
          f"{sum(r['all_reduce'] for r in sw)} in "
          f"{sum(r['all_reduce_s'] for r in sw):.3f} s", flush=True)
    if not abs(e - e_ref) < SHARD_TOL:
        fail(f"11a: |dE| to phase 4 {abs(e - e_ref):.3e} >= {SHARD_TOL}")
    if device.type == "cuda" and not (
            counts["K20_matvec_shard"] > 0 and counts["K21_block_shard"] > 0
            and counts["K1_matvec"] == 0 and counts["K5_block"] == 0):
        fail(f"11a: K20 and K21 must launch, K1 and K5 must not ({counts})")
    return counts


def shard_rank(rank, world, init_method, cfg, queue):
    """One rank of phase 11b (a spawned process): puts (rank, its result)
    on ``queue``, or (rank, {"error": traceback}) if it raised."""
    import traceback
    try:
        queue.put((rank, _shard_rank(rank, world, init_method, cfg)))
    except Exception:
        queue.put((rank, {"error": traceback.format_exc()}))


def _shard_rank(rank, world, init_method, cfg):
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from block2_preview_tpu_torch.dmrg.npdm_scheme import pooled_gram
    from block2_preview_tpu_torch.ops import _kernels, exec_bucket
    from block2_preview_tpu_torch.parallel.multihost import (
        init_mesh, time_collectives)
    from block2_preview_tpu_torch.parallel.shard import ShardedPlanExecutor
    from block2_preview_tpu_torch.runtime import rank_device
    torch.set_num_threads(cfg["threads"])
    mesh = init_mesh(init_method, world, rank, device_type=cfg["device"],
                     backend=cfg.get("backend", "gloo"),
                     timeout=timedelta(seconds=cfg["timeout"]))
    time_collectives()
    try:
        dev = rank_device(mesh, None)
        if cfg["system"] == "qc":
            drv, mpo, _ = qc_system(cfg["n_orb"], cfg["n_orb"])
            ket = drv.get_random_mps(cfg["D"], seed=11)
            sched = qc_sched(cfg["D"], cfg["n_sweeps"])
        else:
            drv, mpo = hubbard_model(cfg["L"])
            ket = drv.get_random_mps(cfg["D"], seed=7)
            sched = hub_sched(cfg["D"], cfg["n_sweeps"])
        _kernels.reset_counts()
        t0 = time.time()
        e = drv.dmrg(mpo, ket, device=dev, mesh=mesh, **sched)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        solver = drv._last_dmrg
        out = {"device": str(dev), "energy": e, "wall": time.time() - t0,
               "launches": _kernels.launch_counts(),
               "sweeps": _shard_sweeps(solver),
               "idle_matvecs": solver.idle_matvecs,
               "matvecs": sum(r["matvecs"] for r in solver.sweep_log),
               "digest": mps_digest(solver.mps),
               "host": {k: getattr(solver, k) for k in (
                   "host_redo_count", "host_env_materialized",
                   "host_ops_downloads")}}
        # ShardedPlanExecutor (K22) against PlanExecutor (K18)
        eff = hubbard_center()
        x = np.random.default_rng(9).standard_normal(eff.size)
        _kernels.reset_counts()
        got = ShardedPlanExecutor(eff, mesh, dtype=np.float64).matvec(x)
        out["k22"] = _kernels.launch_counts()["K22_plan_exec_shard"]
        ref = exec_bucket.PlanExecutor(eff, device=dev).matvec(x)
        out["spe_rel"] = float(np.abs(got - ref).max() / np.abs(ref).max())
        # pooled_gram's closes row-sharded on K17 against one device
        _kernels.reset_counts()
        t0 = time.time()
        G, _ = pooled_gram(cfg["gram_state"], 2, device=mesh,
                           device_min_flop=0)
        out["gram_s"] = time.time() - t0
        out["k17"] = _kernels.launch_counts()["K17_npdm_gemm"]
        G1, _ = pooled_gram(cfg["gram_state"], 2, device=dev,
                            device_min_flop=0)
        out["gram_d"] = float(np.abs(G - G1).max())
    finally:
        time_collectives(False)
        dist.destroy_process_group()
    return out


def run_ranks(cfg, world=2, deadline=RANK_TIMEOUT, target=None):
    """Spawn ``world`` ranks of ``target`` (:func:`shard_rank` by default,
    or a top-level function of the same signature; ``cfg["backend"]``,
    gloo by default; a file rendezvous; their numerical libraries held to
    ``cfg["threads"]`` threads) and return their results in rank order.  A rank still alive at the
    deadline, or after another rank died without a result, is killed;
    a missing result fails the phase."""
    import multiprocessing as mp
    import queue as queue_mod
    import tempfile
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    env = {k: str(cfg["threads"]) for k in (
        "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
    saved = {k: os.environ.get(k) for k in env}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target or shard_rank, args=(
            r, world, f"file://{tmp}/rendezvous", cfg, q))
            for r in range(world)]
        os.environ.update(env)
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        t_end = time.time() + deadline
        try:
            while len(res) < world and time.time() < t_end:
                try:
                    r, out = q.get(timeout=2)
                    res[r] = out
                except queue_mod.Empty:
                    if any(p.exitcode is not None and i not in res
                           for i, p in enumerate(procs)):
                        break
        finally:
            for p in procs:
                p.join(timeout=10 if len(res) == world else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    missing = sorted(set(range(world)) - set(res))
    if missing:
        fail(f"11b: ranks {missing} gave no result within {deadline} s "
             f"(exit codes {[p.exitcode for p in procs]})")
    for r in range(world):
        if "error" in res[r]:
            fail(f"11b: rank {r} raised:\n{res[r]['error']}")
    return [res[r] for r in range(world)]


def check_shard_ranks(res, e_ref, what, cuda):
    """Phase 11b's rules on the ranks' results ``res``: energies and final
    states bitwise equal across ranks, the energy within SHARD_TOL of
    ``e_ref`` (``what`` names it), no host redo or download, the
    ShardedPlanExecutor within 1e-12 of K18 and the sharded Gram within
    1e-12 of one device's; on the card also K20's launches equal the
    matvecs of the sites where the rank owned units, K21, K22 and K17
    launched, K1 and K5 did not."""
    for i, r in enumerate(res):
        for j, w in enumerate(r["sweeps"]):
            print(f"[11b shard] rank {i} ({r['device']}) sweep {j} E "
                  f"{w['energy']:.12f} wall {w['wall']:.1f} s  Teff "
                  f"{w['teff']:.1f} Teig {w['teig']:.1f} Tdm {w['tdm']:.1f} "
                  f"Tblk {w['tblk']:.1f}  K20 {w['K20_matvec_shard']} "
                  f"({w['K20_matvec_shard_units']} units) K21 "
                  f"{w['K21_block_shard']} ({w['K21_block_shard_units']} "
                  f"units) K1 {w['K1_matvec']} K5 {w['K5_block']}  matvecs "
                  f"{w['matvecs']} (idle {w['idle_matvecs']})  all_reduce "
                  f"{w['all_reduce']} in {w['all_reduce_s']:.3f} s",
                  flush=True)
        print(f"[11b shard] rank {i}: E {r['energy']:.12f} ({r['wall']:.1f} "
              f"s) {what} {e_ref:.12f} dE {r['energy'] - e_ref:.2e}  state "
              f"{r['digest'][:12]}  ShardedPlanExecutor vs K18 rel "
              f"{r['spe_rel']:.2e} (K22 {r['k22']})  sharded Gram max |d| "
              f"{r['gram_d']:.2e} (K17 {r['k17']}, {r['gram_s']:.1f} s)",
              flush=True)
    e0, d0 = res[0]["energy"], res[0]["digest"]
    if any(r["energy"] != e0 for r in res):
        fail(f"11b: the ranks' energies differ "
             f"({[r['energy'] for r in res]})")
    if any(r["digest"] != d0 for r in res):
        fail("11b: the ranks' final states differ")
    if not abs(e0 - e_ref) < SHARD_TOL:
        fail(f"11b: |dE| to {what} {abs(e0 - e_ref):.3e} >= {SHARD_TOL}")
    for i, r in enumerate(res):
        if any(r["host"].values()):
            fail(f"11b: rank {i} host counters {r['host']}")
        if not r["spe_rel"] < 1e-12:
            fail(f"11b: rank {i} ShardedPlanExecutor vs K18 rel "
                 f"{r['spe_rel']:.3e} >= 1e-12")
        if not r["gram_d"] < 1e-12:
            fail(f"11b: rank {i} sharded Gram max |d| {r['gram_d']:.3e} "
                 ">= 1e-12")
        c = r["launches"]
        if cuda and not (
                c["K20_matvec_shard"] == r["matvecs"] - r["idle_matvecs"]
                and c["K21_block_shard"] > 0 and c["K1_matvec"] == 0
                and c["K5_block"] == 0 and r["k22"] > 0 and r["k17"] > 0):
            fail(f"11b: rank {i}: K20 must equal the matvecs with units "
                 f"({r['matvecs']} - {r['idle_matvecs']}), K21, K22 and "
                 f"K17 must launch, K1 and K5 must not ({c}, K22 "
                 f"{r['k22']}, K17 {r['k17']})")


def phase_shard_ranks(device, gram_state, e_ref, what, n_orb=16, D=250,
                      n_sweeps=2):
    """Phase 11b: two ranks on ``device``'s type under gloo (on one card
    both share it), each running phase 5's start and schedule (its first
    ``n_sweeps`` sweeps) with the mesh, then ShardedPlanExecutor at 10d's
    center and the sharded 2-particle Gram of ``gram_state``.  Returns the
    ranks' results."""
    cfg = dict(device=device.type, system="qc", n_orb=n_orb, D=D,
               n_sweeps=n_sweeps, gram_state=gram_state, threads=3,
               timeout=RANK_TIMEOUT)
    t0 = time.time()
    res = run_ranks(cfg)
    print(f"[11b shard] two gloo ranks on {res[0]['device']} / "
          f"{res[1]['device']}: K={n_orb} D={D} x{n_sweeps} in "
          f"{time.time() - t0:.1f} s (spawn to join)", flush=True)
    check_shard_ranks(res, e_ref, what, device.type == "cuda")
    return res


def shard_proc(device, e_hub, gram_state, e5, queue):
    """Phase 11 (11a, then 11b's two ranks) in a spawned process, beside
    phase 12: puts ("11", the K20-K22 launches of 11b) on ``queue``, or
    ("11", {"error": traceback}) if it failed."""
    import traceback
    try:
        from block2_preview_tpu_torch.runtime import resolve_device
        dev = resolve_device(device)
        phase_shard_one(dev, e_hub)
        res = phase_shard_ranks(dev, gram_state, e5, "phase 5 port")
        out = {k: sum(r["launches"][k] for r in res)
               for k in ("K20_matvec_shard", "K21_block_shard")}
        out["K22_plan_exec_shard"] = sum(r["k22"] for r in res)
        queue.put(("11", out))
    except BaseException:
        queue.put(("11", {"error": traceback.format_exc()}))


def _unique_sum(keys, sizes) -> int:
    """Sum of ``sizes`` over the first occurrence of each key (a block
    read by several items counts once)."""
    _, first = np.unique(np.asarray(keys), return_index=True)
    return int(np.asarray(sizes, np.int64)[first].sum())


def _item_index(ranges) -> np.ndarray:
    return np.concatenate([np.arange(a, b) for a, b in ranges] or
                          [np.zeros(0, np.int64)]).astype(np.int64)


def _item_shapes(eff):
    """True (a, k, n, p) of every PlanExecutor item, with the ids of the
    LW block (m, lk) and the RW block (m, rk) it reads, in the executor's
    order (its _round_dim keys sorted, triples in order inside a bucket):
    [n_items, 6] int64, the rows ``rank_part`` keeps index into it."""
    from block2_preview_tpu_torch.ops.exec_bucket import _round_dim
    buckets, ids = {}, {}
    for (m, lk, _pk, rk, _ok) in eff.triples:
        a0, k0 = eff.LW[m][lk].shape
        p0, n0 = eff.RW[m][rk].shape
        key = (_round_dim(a0), _round_dim(k0), _round_dim(n0),
               _round_dim(p0))
        buckets.setdefault(key, []).append((
            a0, k0, n0, p0, ids.setdefault(("L", m, lk), len(ids)),
            ids.setdefault(("R", m, rk), len(ids))))
    return np.asarray([s for k in sorted(buckets) for s in buckets[k]],
                      np.int64).reshape(-1, 6)


def phase_shard_kernels(device, mpo, mps, t, site, eff, close_shape,
                        world=2):
    """Phase-3 rows of the sharded kernels at site t, each rank's share of
    a world of ``world`` launched here with explicit (rank, world): K20
    (the site's matvec), K21 (the left and right v3 rotate plans next to
    the center), K22 (PlanExecutor's buckets) and B22e (K17 on the row
    slices of the largest 10b close ``close_shape``).  Each share against
    its twin, the shares' sum against K1 / K5 / K18 / one K17 (1e-12
    relative); the bound of each share counts its own items' live bytes
    (a block read by several items once) and FLOPs.  f64, and K22 also
    f32 (its shares against their twins).  Returns the summary rows (the
    f64 shares' times summed)."""
    import torch
    from block2_preview_tpu_torch.ops import (blockv2, exec_bucket,
                                              npdm_gemm, resident, tilev2)
    from block2_preview_tpu_torch.ops.stacked import env_pool, site_pools
    me, peff = site
    g = mpo.group
    rows = {}
    tdt = torch.float64
    plans, pools = {}, {}
    for side, (_meta, pool, args, kws) in site_mix_inputs(mpo, me, peff,
                                                          t).items():
        plans[side] = resident.build_mix_plan_v4(*args, **kws)
        pools[side] = resident.execute_mix_plan(
            plans[side], torch.as_tensor(pool, dtype=tdt, device=device))
    ex = tilev2.MatvecV2(peff.ket_space, plans["lw"].meta_out,
                         plans["rw"].meta_out, g, peff.target,
                         dtype=np.float64, bra_space=peff.bra_space)
    s = ex.struct
    dv = ex.to_device(device)
    xp = torch.as_tensor(ex.pad(np.random.default_rng(5).standard_normal(
        peff.size)), device=device)
    lw, rw = pools["lw"], pools["rw"]

    def hold(tag, total, full):
        rel, _ = rel_err(total, full)
        print(f"[3 kernels] {tag}: the {world} shares summed vs one launch "
              f"rel {rel:.2e}", flush=True)
        if not rel <= 1e-12:
            fail(f"{tag}: shares summed vs one launch rel {rel:.3e}")

    it = s["it"].astype(np.int64)
    total = None
    for r in range(world):
        part = ex.rank_part(r, world, device)
        groups = s["_parts"][(r, world)]["items"]
        items = _item_index(groups)
        f = it[items]
        flops = 2.0 * float((f[:, 2] * f[:, 1] * f[:, 4]
                             + f[:, 2] * f[:, 4] * f[:, 5]).sum())
        c = part["chain"]
        n_bytes = live_bytes(
            8, peff.size + peff.bra_space.size
            + _unique_sum(f[:, 0], f[:, 2] * f[:, 1])
            + _unique_sum(f[:, 3], f[:, 5] * f[:, 4]),
            8 * len(items) + 2 * c["ent"].shape[0] + 4 * c["n_chunks"])

        def k20(fn=tilev2.mv_exec_part, part=part):
            return fn(xp, lw, rw, dv, part, s["T"], s["nt2"])

        def twin(part=part):
            return tilev2.mv_twin(xp, lw, rw, dv, s["T"], s["nt2"],
                                  tasks=(part["t1"], part["t2"]))

        y = k20()
        _check(rows, "K20_matvec_shard", np.float64, f"r{r}", y, twin(),
               F64_TOL, time_ms(k20, device), time_ms(twin, device), None,
               n_bytes, flops,
               f"rank {r} of {world}: groups {len(groups)} of "
               f"{s['ng_live']}, items {len(items)}, units "
               f"{part['n_units']} of {dv['n_units']}, chunks "
               f"{c['n_chunks']} of {dv['chain']['n_chunks']}")
        total = y if total is None else total + y
    hold("K20_matvec_shard", total,
         tilev2.mv_exec(xp, lw, rw, dv, s["T"], s["nt2"]))

    for direction, bond, st in (("left", t, t), ("right", t + 2, t + 1)):
        env = me.left_envs[bond] if direction == "left" \
            else me.right_envs[bond]
        meta, pool = env_pool(env, mpo.bond_dqs[bond], np.float64)
        rp = blockv2.build_blocking_v2(
            meta, mpo.tensors[st], mpo.site_quanta[st], mps.tensors[st],
            mps.tensors[st], g, direction, mpo.bond_dqs[bond],
            mpo.bond_dqs[t + 1], gemm_mix=True).rot
        ep = torch.as_tensor(pool, dtype=tdt, device=device)
        bp, kp = site_pools(rp, device, tdt)
        d5 = blockv2.blk_tables(rp, device, tdt)
        bi = rp.it.astype(np.int64)
        ef = rp.ef.astype(np.int64)
        efs = d5["efs"].cpu().numpy().astype(np.int64)
        total = None
        for r in range(world):
            part = blockv2.blk_rank_part(rp, r, world, device)
            items = _item_index(part["items"])
            f = bi[items]
            ents = _item_index([(efs[i], efs[i + 1]) for i in items])
            e = ef[ents]
            flops = 2.0 * float((f[:, 2] * f[:, 1] * f[:, 4]
                                 + f[:, 2] * f[:, 6] * f[:, 4]).sum())
            n_bytes = live_bytes(
                8, _unique_sum(f[:, 0], f[:, 2] * f[:, 1])
                + _unique_sum(f[:, 3], f[:, 1] * f[:, 4])
                + _unique_sum(f[:, 5], f[:, 2] * f[:, 6])
                + len(ents) + _unique_sum(e[:, 1], e[:, 2] * e[:, 3]),
                k5_ints(part["k5"], len(ents)))

            def k21(fn=blockv2.blk_exec_part, part=part):
                return fn(ep, bp, kp, d5, part, rp.T, rp.left,
                          torch.zeros(rp.ncap, dtype=tdt, device=device))

            def twin(part=part):
                return blockv2.blk_twin(
                    ep, bp, kp, d5, rp.T, rp.left,
                    torch.zeros(rp.ncap, dtype=tdt, device=device),
                    items=part["items"])

            o = k21()
            _check(rows, "K21_block_shard", np.float64,
                   f"{direction[0]}{r}", o, twin(), F64_TOL,
                   time_ms(k21, device), time_ms(twin, device), None,
                   n_bytes, flops,
                   f"rank {r} of {world}: groups {len(part['items'])} of "
                   f"{len(rp.g1)}, items {len(items)}, units "
                   f"{part['n_units']} of {d5['n_units']} (slab runs "
                   f"{part['n_runs']}, tile units {part['n_lunits']}), "
                   f"entries "
                   f"{len(ents)}")
            total = o if total is None else total + o
        one = blockv2.blk_exec(ep, bp, kp, d5, rp.T, rp.left,
                               torch.zeros(rp.ncap, dtype=tdt, device=device))
        hold(f"K21_block_shard {direction}", total, one)
        # v3 rotate plans: one writer an element, so the shares summed are
        # one launch bitwise
        same = bool(torch.equal(total, one))
        print(f"[3 kernels] K21_block_shard {direction}: the {world} shares "
              f"summed {'bitwise equal to' if same else 'DIFFER from'} one "
              f"K5 launch", flush=True)
        if device.type == "cuda" and not same:
            fail(f"K21 {direction}: the shares summed are not one K5 launch "
                 f"bitwise")

    x = np.random.default_rng(9).standard_normal(eff.size)
    shapes = _item_shapes(eff)
    for dtype in (np.float64, np.float32):
        pe = exec_bucket.PlanExecutor(eff, dtype=dtype, device=device)
        if len(shapes) != len(pe.items):
            fail(f"K22: {len(pe.items)} items against {len(shapes)} "
                 f"triples")
        xq = torch.as_tensor(np.concatenate([x, np.zeros(pe.size_p + 1
                                                         - pe.size)]),
                             dtype=pe.vals.dtype, device=device)
        n18 = pe.chain_tables()["ck"].shape[0]
        total = None
        for r in range(world):
            part = pe.rank_part(r, world)
            a, k, n, p, lid, rid = shapes[part["rows"]].T
            flops = 2.0 * float((a * k * n + a * n * p).sum())
            # as K18's sigma_bytes_flops over this share: every LW/RW block
            # its items read once (a block shared by several items once),
            # psi and sigma once
            n_bytes = live_bytes(np.dtype(dtype).itemsize,
                                 2 * eff.size + _unique_sum(lid, a * k)
                                 + _unique_sum(rid, p * n))

            def k22(part=part):
                return exec_bucket.plan_exec_part(xq, pe, part)

            def twin(part=part):
                return exec_bucket.plan_exec_plain(xq, [
                    tuple(v[i0:i1] for v in bk) for bk, (i0, i1) in
                    zip(pe.device_buckets, part["slices"])], pe.size_p + 1)

            y = k22()
            c = part["chain"]
            _check(rows if dtype == np.float64 else None,
                   "K22_plan_exec_shard", dtype, f"r{r}", y, twin(),
                   ATOMIC_TOL[dtype], time_ms(k22, device),
                   time_ms(twin, device), None, n_bytes, flops,
                   f"rank {r} of {world}: items {len(part['rows'])} of "
                   f"{len(pe.items)}, chunks {c['n_chunks']} of K18's "
                   f"{n18}, GFLOP true {flops / 1e9:.2f} (tables "
                   f"{part['tables']['seconds']:.3f} s on the host)")
            total = y if total is None else total + y
        if dtype == np.float64:
            hold("K22_plan_exec_shard", total, exec_bucket.plan_exec(xq, pe))
        del pe

    n, X, m = close_shape
    rng = np.random.default_rng(17)
    M = torch.as_tensor(rng.standard_normal((n, X)), device=device)
    V = torch.as_tensor(rng.standard_normal((X, m)), device=device)
    per = -(-n // world)
    outs = []
    for r in range(world):
        Mr = torch.zeros((per, X), dtype=tdt, device=device)
        mine = M[r * per:(r + 1) * per]
        Mr[:mine.shape[0]] = mine
        y = npdm_gemm.npdm_gemm(Mr, V)
        _check(None, "K17_npdm_gemm", np.float64, f"B22e r{r}", y,
               npdm_gemm.npdm_gemm_plain(Mr, V), ATOMIC_TOL[np.float64],
               time_ms(lambda: npdm_gemm.npdm_gemm(Mr, V), device),
               time_ms(lambda: npdm_gemm.npdm_gemm_plain(Mr, V), device),
               time_ms(lambda: torch.matmul(Mr, V), device),
               8 * (mine.shape[0] * X + X * m + per * m),
               2 * mine.shape[0] * X * m,
               f"rank {r} of {world}: rows {mine.shape[0]} of {n} "
               f"(padded to {per}) of [{n} x {X}] @ [{X} x {m}]")
        outs.append(y)
    hold("B22e (K17 on row slices)", torch.cat(outs)[:n],
         npdm_gemm.npdm_gemm(M, V))
    return summary_rows(rows)


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        from block2_preview_tpu_torch.runtime import resolve_device
    except ImportError as exc:
        fail(f"the port package is not importable ({exc}); run from the "
             "repository root")
    from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
    device = resolve_device("cuda")
    t_start = time.time()

    def at(what):
        print(f"[time] {what} at {time.time() - t_start:.1f} s", flush=True)

    phase_device()
    phase_build()
    n_orb, D = 16, 250
    drv, mpo, t_mpo = qc_system(n_orb, n_orb)
    nbond = max(len(b) for b in mpo.bond_dqs)
    print(f"[5 full] K={n_orb} QC MPO built in {t_mpo:.1f} s, max MPO "
          f"bond {nbond}", flush=True)
    t = n_orb // 2 - 1
    with host_pool() as pool:
        ref5 = pool.apply_async(timed_host_reference, (
            mpo, drv.get_random_mps(D, seed=11), qc_sched(D)))
        e_hub, gs_hub = phase_hubbard(device)
        hub = hubbard_npdm_states(device)
        ref10a = pool.apply_async(npdm_host_refs, hub[3:])
        ref7a = pool.apply_async(host_excited)
        counts, ket, e5, e5_0 = phase_full(device, drv, mpo, D=D,
                                           n_orb=n_orb)
        later = ("K7_tiled", "K8_bucket", "K9_bucket_blocking", "K10_slab",
                 "K11_stk_mix", "K12_tiled_blocking", "K13_env_gemm",
                 "K14_place_v3", "K15_mix_v2", "K17_npdm_gemm",
                 "K18_plan_exec", "K19_probe", "K20_matvec_shard",
                 "K21_block_shard", "K22_plan_exec_shard")
        for k in later:
            counts.pop(k)   # the paths of phases 6b-10d
        c5_k16 = {"K16_slab_matvec": counts.pop("K16_slab_matvec")}
        if not all(c > 0 for c in counts.values()):
            fail(f"a kernel of the path was never launched: {counts}")
        at("phase 5")
        ket5 = copy_mps(ket)
        ref3 = pool.apply_async(host_davidson3, (mpo, ket5, t))
        ref10b = [pool.apply_async(host_gram, (ket5, k)) for k in (1, 2)]
        ref10e = pool.apply_async(host_expectation, (mpo, ket5))
        ket12 = qc12_state(device)
        ref12 = pool.apply_async(host_gram, (ket12, 3))
        phase_tiled_parity(device, e_ref=e_hub)
        counts["K7_tiled"] = phase_tdvp(device, drv, mpo, ket, D=D)
        phase_stacked_parity(device, ref=phase_excited(device, host=ref7a))
        roots = phase_roots(device, drv, mpo, D=D, n_sweeps=1)
        at("phases 6-7")
        c8b, e8b = phase_stacked_full(device, drv, mpo, D=D)
        c8c, e8c = phase_resident_v1(device, drv, mpo, D=D)
        phase_mix_parity(device, e_ref=e_hub)
        c9b, e9b, _ = phase_mix_full(device, drv, mpo, "3", qc_sched(D),
                                     "9b mix v3", D=D)
        c9c, _, e9c0 = phase_mix_full(device, drv, mpo, "2",
                                      qc_sched(D, n_sweeps=1), "9c mix v2",
                                      D=D)
        for k, c in (("K8_bucket", roots), ("K9_bucket_blocking", roots),
                     ("K10_slab", c8b), ("K11_stk_mix", c8b),
                     ("K12_tiled_blocking", c8c), ("K13_env_gemm", c9b),
                     ("K14_place_v3", c9b), ("K15_mix_v2", c9c)):
            counts[k] = c[k]
        counts["K16_slab_matvec"] = k16_launches(
            {"5": c5_k16, "7b": roots, "8b": c8b, "8c": c8c, "9b": c9b,
             "9c": c9c})
        phase_npdm_hubbard(device, *hub, ref10a.get())
        h1e, g2e = seeded_qc_integrals(n_orb)
        counts["K17_npdm_gemm"], k17_shapes = phase_npdm_wide(
            device, ket5, h1e, g2e, [r.get() for r in ref10b],
            ref10e.get(), ket12, ref12.get())
        counts["K19_probe"] = phase_probes(device)
        counts["K18_plan_exec"] = phase_plan_exec(device)
        at("phases 8-10")
        ed12 = pool.apply_async(hubbard_gf_ed)
        rot12 = pool.apply_async(host_rotation, (gs_hub,))
        one12 = [pool.apply_async(host_onedot, kwds={"last_site_1site": ls1})
                 for ls1 in (False, True)]
        hub13 = pool.apply_async(host_su2, (SU2_HUB,))
        ed13 = pool.apply_async(su2_hubbard_ed)
        qc13 = {tw: pool.apply_async(host_su2, (SU2_QC, tw)) for tw in (2, 0)}
        ref3t = pool.apply_async(host_davidson1, (mpo, ket5, t))
        r5 = ref5.get()
        check_full(e5, r5, n_orb)
        check_stacked(e8b, e8c, e5, r5)
        check_mix(e9b, e9c0, e5, e5_0, r5)
        # phase 11 and 13b's two spins run in their own processes beside
        # phase 12 (13b's kernel rows wait for phase 13)
        runs11 = spawn_procs({"11": (shard_proc, (str(device), e_hub,
                                                   hub[3], e5))}, "phase",
                             deadline=2 * RANK_TIMEOUT)
        runs13 = su2_spawn(device, SU2_QC)
        at("phases 11 and 13b started (the host references waited for)")
        k12 = phase_gf_hubbard(device, gs_hub, e_hub, ed12.get())
        at("phase 12a")
        # one sweep: the total passed 1140 s on slower hosts (PERF.md §6)
        k12 += phase_gf_full(device, drv, mpo, ket5, e5, D=D, n_sweeps=1)
        at("phase 12b")
        k12 += phase_rotation(device, gs_hub, e_hub, rot12)
        at("phase 12c")
        k12 += phase_onedot(device, one12)
        counts["K7_tiled"] += k12
        at("phase 12d")
        counts.update(runs11()["11"])
        at("phase 11 joined")
        t13 = time.time()
        k5_13, k7_13 = phase_su2_hubbard(device, hub13, ed13)
        at("phase 13a")
        k5_13b, k7_13b = phase_su2_qc(runs13, qc13)
        counts["K5_block"] += k5_13 + k5_13b
        counts["K7_tiled"] += k7_13 + k7_13b
        at(f"phase 13b (phase 13: {time.time() - t13:.1f} s)")
        site = mid_site(mpo, ket5, t)
        rows = phase_kernels(device, mpo, ket5, t, site=site)
        eff = EffectiveHamiltonian2(site[0], t)
        rows += phase_tiled(device, site[0], t,
                            complex_me=mid_site(mpo, ket, t)[0], eff=eff,
                            host1=ref3t)
        rows += phase_bucket(device, mpo, ket5, site[0], eff, t,
                             host3=ref3.get())
        rows += phase_stacked_kernels(device, mpo, ket5, site[0], t)
        rows += phase_mix_kernels(device, mpo, ket5, site[0], t)
        rows += phase_new_kernels(device, k17_shapes, eff, t)
        phase_k17_edges(device)
        rows += phase_shard_kernels(device, mpo, ket5, t, site, eff,
                                    k17_shapes[0])
        at("phase 3 at the K=16 site")
    t0 = time.time()
    wide = wide_system()
    print(f"[3 kernels] Hubbard-L16 D=1000 site 7 (T=128 tiles; MPS built "
          f"in {time.time() - t0:.1f} s)", flush=True)
    site = mid_site(*wide, 7)
    phase_kernels(device, *wide, 7, tile=128, blk_tile=128, site=site)
    eff = EffectiveHamiltonian2(site[0], 7)
    phase_tiled(device, site[0], 7, davidson=False, eff=eff)
    phase_bucket(device, wide[0], wide[1], site[0], eff, 7, summary=False,
                 kinds="K8")
    phase_stacked_kernels(device, *wide, site[0], 7, T=128, summary=False,
                          bucket=False)
    phase_slab_wide(device, *wide, site[0], 7)
    phase_k5_strips(device, *wide, site[0], 7)
    at("phase 3 at the T=128 site")
    if "jax" in sys.modules or "block2_preview_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


BESIDE_RUN = """
import pickle, sys, torch
import numpy as np
import chip_smoke as c
from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
from block2_preview_tpu_torch.ops import (blockv2, mixv4, resident, stacked,
                                          tilev2)
from block2_preview_tpu_torch.ops.stacked import env_pool
from block2_preview_tpu_torch.runtime import resolve_device
d = resolve_device(sys.argv[3] if len(sys.argv) > 3 else "cuda")
D = int(sys.argv[4]) if len(sys.argv) > 4 else 250
f64 = torch.float64
c.phase_build()
drv, mpo, _ = c.qc_system(16, 16)
with open(sys.argv[1], "rb") as f:
    held = pickle.load(f)
ket = held["ket"]
site = c.mid_site(mpo, ket, 7)
me, peff = site
# site 7's two environments as the driver made them: a host contraction
# may round differently from process to process (3.7e-16 on the card's
# host), and every turn's kernels must read bitwise-equal inputs
list.__setitem__(me.left_envs, 7, held["envs"][0])
list.__setitem__(me.right_envs, 9, held["envs"][1])
eff = EffectiveHamiltonian2(me, 7)
# phase 3's K1-K8, K10-K16, K18 and K20-K22 rows at site 7
c.phase_kernels(d, mpo, ket, 7, site=site)
c.phase_tiled(d, me, 7, davidson=False, eff=eff)
c.phase_bucket(d, mpo, ket, me, eff, 7, summary=False, kinds="K8")
c.phase_stacked_kernels(d, mpo, ket, me, 7, summary=False)
c.phase_mix_kernels(d, mpo, ket, me, 7, summary=False)
c.plan_exec_check(d, eff, "c7")
c.phase_shard_kernels(d, mpo, ket, 7, site, eff, (8, 19332, 1542))
# the paths K5, K6 and K10 run: phases 5 and 8b
c.phase_full(d, drv, mpo, D=D)
c.phase_stacked_full(d, drv, mpo, D=D)
# K10, K5 (v3 rotate plans) and K6 on fixed inputs, f64
outs = {}
for side, (sp, _, pool, _) in c._stacked_plans(mpo, ket, me, 7).items():
    ep = torch.as_tensor(pool, device=d)
    bp, kp = stacked.site_pools(sp, d, f64)
    outs["K10 input " + side] = torch.as_tensor(pool)
    tab = (stacked.slab_kernel_tables(sp, d) if d.type == "cuda" else
           stacked.slab_plain_tables(sp, d, f64))
    outs["K10 " + side] = stacked.slab_exec(
        ep, bp, kp, tab, sp.left,
        torch.zeros(sp.res_total + 1, dtype=f64, device=d)).cpu()
for direction, bond, st in (("left", 7, 7), ("right", 9, 8)):
    env = me.left_envs[bond] if direction == "left" else me.right_envs[bond]
    meta, pool = env_pool(env, mpo.bond_dqs[bond], np.float64)
    plan = blockv2.build_blocking_v2(
        meta, mpo.tensors[st], mpo.site_quanta[st], ket.tensors[st],
        ket.tensors[st], mpo.group, direction, mpo.bond_dqs[bond],
        mpo.bond_dqs[8], gemm_mix=True)
    outs["K5 input " + direction] = torch.as_tensor(pool)
    outs["K5 " + direction] = blockv2.execute_blocking_v2(
        plan.rot, torch.as_tensor(pool, device=d)).cpu()
    # K3 on the v3 plan's GEMM after K5 (bitwise the same ROT pool), and
    # its time as each tree's execute_blocking_v3 allocates the final pool:
    # zero-filled for a K3 that adds, unfilled for one that stores it all
    outs["K3 " + direction] = blockv2.execute_blocking_v3(
        plan, torch.as_tensor(pool, device=d)).cpu()
    rot = blockv2.execute_blocking_v2(plan.rot, torch.as_tensor(pool,
                                                                device=d))
    tab = blockv2.mix_tables(plan, d, f64)
    alloc = torch.empty if hasattr(mixv4, "k3_host_tables") else torch.zeros
    ms = c.time_ms(lambda: mixv4.mix_exec(rot, tab["wpool"], tab, alloc(
        plan.ncap, dtype=f64, device=d)), d)
    print(f"[3 kernels] K3 v3 blocking {direction[0]}3 f64: {ms:.4f} ms a "
          f"call, its pool's allocation included", flush=True)
plans, pools = {}, {}
for side, (_, pool, args, kws) in c.site_mix_inputs(mpo, me, peff,
                                                    7).items():
    plans[side] = resident.build_mix_plan_v4(*args, **kws)
    ep = torch.as_tensor(pool, device=d)
    pools[side] = resident.execute_mix_plan(plans[side], ep)
    # K3's OUT from a zero-filled buffer (the parent adds into it)
    tab = mixv4.plan_tables(plans[side], d, f64)
    outs["K3 " + side] = mixv4.mix_exec(ep, tab["wpool"], tab, torch.zeros(
        mixv4._cap_class(plans[side].out_total + 1) + 1, dtype=f64,
        device=d)).cpu()
# K2 on inputs made once for every turn (site 7 and the T=128 site)
for name, k in held["k2"].items():
    ds = resident.build_diag_struct(k["space"], k["ml"], k["mr"], k["T"],
                                    k["nt2"], k["sig_idx"])
    lw, rw = (torch.as_tensor(k[x], device=d) for x in ("lw", "rw"))
    outs["K2 " + name] = resident.execute_diag(ds, lw, rw).cpu()
    tab = resident.diag_tables(ds, d)
    ms = c.time_ms(lambda: resident.diag_exec(lw, rw, tab), d)
    print(f"[3 kernels] K2 {name}: {ms:.4f} ms a call ({ms.launches} "
          f"counted launch{'es' if ms.launches != 1 else ''})", flush=True)
ex = tilev2.MatvecV2(peff.ket_space, plans["lw"].meta_out,
                     plans["rw"].meta_out, mpo.group, peff.target,
                     dtype=np.float64, bra_space=peff.bra_space)
s = ex.struct
xp = torch.as_tensor(ex.pad(np.random.default_rng(5).standard_normal(
    peff.size)), device=d)
for side, meta in (("lw", plans["lw"].meta_out),
                   ("rw", plans["rw"].meta_out)):
    npl = resident.NoisePlan(peff.ket_space, meta, mpo.group, side, s["T"],
                             s["psi_idx"] if side == "lw" else None)
    tab = npl.tables(d)
    resident.noise_exec(xp, pools[side], tab, npl.T)
    if d.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
    outs["K6 " + side] = resident.noise_exec(xp, pools[side], tab,
                                             npl.T).cpu()
    if d.type == "cuda":
        print(f"[3 kernels] K6 {side}: one call allocates "
              f"{(torch.cuda.max_memory_allocated() - m0) / 2 ** 20:.2f} "
              f"MiB above what it found", flush=True)
torch.save(outs, sys.argv[2])
"""

# what --beside holds the change's outputs to against the parent's:
# bitwise, or a largest difference relative to the parent's largest entry
BESIDE_TOL = {"K10": 0.0, "K5": 1e-14, "K3": 1e-14, "K2": 1e-14}


def diag_inputs(device, mpo, mps, t, site=None):
    """What build_diag_struct and execute_diag take at center t of a
    state: the ket space, the LW/RW metas, the matvec plan's T, nt2 and
    sig_idx, and the LW/RW pools (host, f64) of this tree's mix — one
    input for every --beside turn's K2."""
    import torch
    from block2_preview_tpu_torch.ops import resident, tilev2
    me, eff = site or mid_site(mpo, mps, t)
    plans, pools = {}, {}
    for side, (_, pool, args, kws) in site_mix_inputs(mpo, me, eff,
                                                      t).items():
        plans[side] = resident.build_mix_plan_v4(*args, **kws)
        pools[side] = resident.execute_mix_plan(
            plans[side], torch.as_tensor(pool, device=device)).cpu().numpy()
    s = tilev2.MatvecV2(eff.ket_space, plans["lw"].meta_out,
                        plans["rw"].meta_out, mpo.group, eff.target,
                        dtype=np.float64, bra_space=eff.bra_space).struct
    return {"space": eff.ket_space, "ml": plans["lw"].meta_out,
            "mr": plans["rw"].meta_out, "T": s["T"], "nt2": s["nt2"],
            "sig_idx": s["sig_idx"], "lw": pools["lw"], "rw": pools["rw"]}



def site_envs(mpo, mps, t):
    """The host environments of center t of a state (its left bond t and
    right bond t + 2), which every --beside turn's site then reads."""
    me, _ = mid_site(mpo, mps, t)
    return me.left_envs[t], me.right_envs[t + 2]


def beside_parent(parent: str, turns=("parent", "change", "change",
                                      "parent")):
    """K1-K8, K10-K16, K18 and K20-K22 of this tree beside those of the
    tree at ``parent`` (an unpacked earlier commit): phase 3's rows of
    those kernels at the K=16 site 7 (with PlanExecutor against K8), then
    the runs of phases 5 and 8b, each in
    a process of its own, in the order ``turns``; the state is phase 5's
    port run, made once here and handed to every run as a pickle, with
    its site 7's two host environments and K2's inputs at that site and
    at the T=128 Hubbard-L16 site.  Each
    run builds its own tree's kernels and prints its phase-3 rows, its 5
    and 8b sweeps (Teff, Tblk) and each noise call's own allocation,
    prefixed by its turn, and saves K10's, K5's (the v3 rotate plans),
    K3's (the mix's OUT, the v3 blockings' final pools), K2's and K6's f64
    outputs on fixed inputs; the change's are then held against the
    parent's (:func:`beside_outputs`)."""
    import pickle
    import tempfile
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    from block2_preview_tpu_torch.runtime import resolve_device
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    if not os.path.isfile(os.path.join(parent, "chip_smoke.py")):
        fail(f"{parent} holds no chip_smoke.py")
    phase_device()
    phase_build()
    dev = resolve_device("cuda")
    drv, mpo, _ = qc_system(16, 16)
    _, ket, e5, _ = phase_full(dev, drv, mpo)
    held = {"ket": copy_mps(ket), "envs": site_envs(mpo, ket, 7),
            "k2": {"site7": diag_inputs(dev, mpo, ket, 7),
                   "T128": diag_inputs(dev, *wide_system(), 7)}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ket.pkl")
        with open(path, "wb") as f:
            pickle.dump(held, f)
        outs = []
        for i, turn in enumerate(turns):
            root = parent if turn == "parent" else here
            saved = os.path.join(tmp, f"out{i}.pt")
            t0 = time.time()
            run = subprocess.run([sys.executable, "-c", BESIDE_RUN, path,
                                  saved], cwd=root, capture_output=True,
                                 text=True, env=dict(os.environ,
                                                     PYTHONPATH=root))
            for line in run.stdout.splitlines():
                if line.startswith(("[3 kernels]", "[2 build]", "[5 full]",
                                    "[8b", "[10d", "FAIL")):
                    print(f"[beside {i} {turn}] {line}", flush=True)
            print(f"[beside {i} {turn}] exit {run.returncode} in "
                  f"{time.time() - t0:.1f} s", flush=True)
            if run.returncode != 0:
                print(run.stderr[-4000:], flush=True)
                fail(f"the {turn} run failed")
            outs.append((turn, torch.load(saved)))
    beside_outputs(outs)


def beside_outputs(outs):
    """Print each kernel output of every turn against the first parent
    turn's: bitwise equal, or the largest difference relative to the
    parent's largest entry; fail where a change turn's output of a kernel
    in BESIDE_TOL differs by more than its tolerance (inputs must be
    bitwise equal)."""
    ref = next(o for turn, o in outs if turn == "parent")
    for i, (turn, o) in enumerate(outs):
        for k, v in o.items():
            same = bool(v.equal(ref[k]))
            rel, _ = rel_err(v, ref[k])
            print(f"[beside {i} {turn}] {k} output "
                  + ("bitwise equal to the parent's" if same else
                     f"differs from the parent's: rel {rel:.2e}"),
                  flush=True)
            tol = 0.0 if " input " in k else BESIDE_TOL.get(k.split()[0])
            if turn == "change" and tol is not None and not (
                    same or rel <= tol):
                fail(f"beside: {k} rel {rel:.3e} against the parent's "
                     f"(allowed {tol:.0e})")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--beside"] and len(sys.argv) == 3:
        beside_parent(sys.argv[2])
    elif len(sys.argv) > 1:
        fail("usage: python3 chip_smoke.py [--beside PARENT_TREE]")
    else:
        main()
