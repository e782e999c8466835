"""chip_smoke.py on the CPU: it refuses to run without a CUDA card, and
its kernel and main-path phases run end to end at a small size (the
kernels' twins stand in for the kernels on CPU tensors)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_plans  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line, from the repo
    root and from a directory holding nothing but the script."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(lone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout
        assert "FAIL" in proc.stdout


def test_chip_smoke_beside_fails_without_a_card(tmp_path):
    """The parent-beside-change mode (``--beside``), and an argument the
    script does not take, exit non-zero with no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    for args in (["--beside", str(tmp_path)], ["--beside"], ["-x"]):
        proc = subprocess.run([sys.executable, "chip_smoke.py", *args],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout
        assert "FAIL" in proc.stdout


def test_chip_smoke_phases_on_cpu(capsys):
    """Phase 5 (main path against the port's host reference, run in the
    script's spawned worker; launch counts, host transfer counters) and
    phase 3 (K1-K6 vs twin rows on the MPS phase 5 leaves, with bound and
    library columns) at K=6, D=20 on the CPU."""
    dev = torch.device("cpu")
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    # the host reference runs in the spawned worker, as in main()
    with chip_smoke.host_pool(threads=1) as pool:
        ref = pool.apply_async(chip_smoke.timed_host_reference, (
            mpo, drv.get_random_mps(D, seed=11), chip_smoke.qc_sched(D)))
        counts, ket, e, e0 = chip_smoke.phase_full(dev, drv, mpo, D=D,
                                                    n_orb=n_orb)
        chip_smoke.check_full(e, ref.get(timeout=300), n_orb)
    # CPU tensors run the twins, which launch nothing
    assert counts == {"K1_matvec": 0, "K2_diag": 0, "K3_mix": 0,
                      "K4_place": 0, "K5_block": 0, "K6_noise": 0,
                      "K7_tiled": 0, "K8_bucket": 0,
                      "K9_bucket_blocking": 0, "K10_slab": 0,
                      "K11_stk_mix": 0, "K12_tiled_blocking": 0,
                      "K13_env_gemm": 0, "K14_place_v3": 0,
                      "K15_mix_v2": 0, "K16_slab_matvec": 0,
                      "K17_npdm_gemm": 0, "K18_plan_exec": 0,
                      "K19_probe": 0, "K20_matvec_shard": 0,
                      "K21_block_shard": 0, "K22_plan_exec_shard": 0}
    assert drv._last_dmrg.mps is ket
    assert e0 == drv._last_dmrg.sweep_log[0]["energy"] and e <= e0 + 1e-9
    rows = chip_smoke.phase_kernels(dev, mpo, ket, n_orb // 2 - 1)
    assert [r["name"] for r in rows] == list(counts)[:6]
    for r in rows:
        assert r["max_abs_err"] == 0.0      # twin against itself
        assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes",
                                                       "operations")
    lib = {r["name"]: r["library_ms"] for r in rows}
    assert lib.pop("K4_place") > 0 and set(lib.values()) == {None}
    out = capsys.readouterr().out
    assert "[5 full] sweep 1" in out and "dE" in out
    assert "host_env_materialized 0  host_ops_downloads 0" in out
    for k in ("K1_matvec f64", "K5_block  f64 l3", "K5_block  f32 r2",
              "K6_noise  f64 lw", "K6_noise  f32 rw"):
        assert f"[3 kernels] {k}" in out, k
    json.dumps(rows)
    assert np.isfinite([r["ms"] for r in rows]).all()


def test_chip_smoke_tiled_phases_on_cpu(capsys):
    """Phase 6a (torch_tiled ground state, real- and imaginary-time TDVP
    against the host backend), phase 6b (td_dmrg, one real-time step with
    its per-sweep split) and the phase-3 K7 rows with the tiled Davidson
    check at a small size on the CPU."""
    dev = torch.device("cpu")
    chip_smoke.phase_tiled_parity(dev, L=4, D=20, ns=4)
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    ket = drv.get_random_mps(D, seed=11)
    drv.dmrg(mpo, ket, bond_dims=[D], noises=[1e-4, 0], thrds=[1e-12],
             n_sweeps=2, tol=0, iprint=0, backend="numpy")
    ket5 = chip_smoke.copy_mps(ket)
    assert chip_smoke.phase_tdvp(dev, drv, mpo, ket, D=D) == 0
    t = n_orb // 2 - 1
    me5 = chip_smoke.mid_site(mpo, ket5, t)[0]
    rows = chip_smoke.phase_tiled(dev, me5, t,
                                  complex_me=chip_smoke.mid_site(mpo, ket,
                                                                 t)[0])
    assert [r["name"] for r in rows] == ["K7_tiled"]
    r = rows[0]
    assert r["max_abs_err"] == 0.0      # the plain version against itself
    assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
    assert r["bound_ms"] > 0 and r["library_ms"] is None
    out = capsys.readouterr().out
    for k in ("[6a tiled] Hubbard-L4", "[6a tiled] real-time TDVP",
              "[6a tiled] imaginary-time TDVP", "[6b tdvp] sweep F",
              "[6b tdvp] sweep B", "summed discarded weight",
              "[3 kernels] K7_tiled  f64", "[3 kernels] K7_tiled  c64",
              "[3 kernels] K7_tiled  c128 6b", "[3 kernels] K7 Davidson"):
        assert k in out, k


def test_chip_smoke_excited_phases_on_cpu(capsys):
    """Phase 7a (roots, a projected state, an f32 root and torch_tiled
    roots against the host backend), phase 7b (three roots on
    torch_device with the per-sweep split and counters) and the phase-3
    K8/K9 rows with the three-root Davidson check, at a small size on the
    CPU."""
    from block2_preview_tpu_torch.dmrg.effective import (
        EffectiveHamiltonian2)
    dev = torch.device("cpu")
    chip_smoke.phase_excited(dev, L=4, D=16, ns=4)
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    counts = chip_smoke.phase_roots(dev, drv, mpo, D=D)
    assert not any(counts.values())      # the twins launch nothing
    ket = drv._last_dmrg.mps
    t = n_orb // 2 - 1
    me = chip_smoke.mid_site(mpo, ket, t)[0]
    with chip_smoke.host_pool(threads=1) as pool:
        host3 = pool.apply_async(chip_smoke.host_davidson3, (mpo, ket, t))
        rows = chip_smoke.phase_bucket(dev, mpo, ket, me,
                                       EffectiveHamiltonian2(me, t), t,
                                       host3=host3.get(timeout=300))
    assert [r["name"] for r in rows] == ["K8_bucket", "K9_bucket_blocking"]
    for r in rows:
        assert r["max_abs_err"] == 0.0      # the plain version vs itself
        assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
        assert r["bound_ms"] > 0 and r["library_ms"] is None
    out = capsys.readouterr().out
    for k in ("[7a excited] torch float64 3 roots",
              "[7a excited] torch_device float64 3 roots",
              "[7a excited] torch float64 projected",
              "[7a excited] torch_device float32 1 roots",
              "[7a excited] torch_tiled float64 2 roots",
              "[7b roots] sweep 0", "[7b roots] sweep 1",
              "[3 kernels] K8_bucket f64", "[3 kernels] K8_bucket f32",
              "[3 kernels] K9_bucket_blocking f64 l",
              "[3 kernels] K9_bucket_blocking f32 r",
              "[3 kernels] K8 Davidson"):
        assert k in out, k


def test_chip_smoke_stacked_phases_on_cpu(capsys):
    """Phase 8a (torch_stacked with one and three roots, torch_resident and
    torch_tiled under tiled_v1, against the host backend), phases 8b and
    8c (the stacked backend and the tiled_v1 resident run at K=6, D=20,
    against phase 5's port energy and host reference) and the phase-3
    K10/K11/K12 rows, on the CPU."""
    dev = torch.device("cpu")
    chip_smoke.phase_stacked_parity(dev, L=4, D=16, ns=4)
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    c8b, e8b = chip_smoke.phase_stacked_full(dev, drv, mpo, D=D)
    c8c, e8c = chip_smoke.phase_resident_v1(dev, drv, mpo, D=D)
    assert not any(c8b.values()) and not any(c8c.values())
    _, ket, e5, _ = chip_smoke.phase_full(dev, drv, mpo, D=D, n_orb=n_orb)
    ref = chip_smoke.timed_host_reference(
        mpo, drv.get_random_mps(D, seed=11), chip_smoke.qc_sched(D))
    chip_smoke.check_stacked(e8b, e8c, e5, ref)
    with pytest.raises(SystemExit):
        chip_smoke.check_stacked(e8b, e8c + 1e-6, e5, ref)
    t = n_orb // 2 - 1
    me = chip_smoke.mid_site(mpo, ket, t)[0]
    rows = chip_smoke.phase_stacked_kernels(dev, mpo, ket, me, t)
    assert [r["name"] for r in rows] == ["K10_slab", "K11_stk_mix",
                                         "K12_tiled_blocking"]
    for r in rows:
        assert r["max_abs_err"] == 0.0      # the plain version vs itself
        assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
        assert r["bound_ms"] > 0
    assert [r["library_ms"] is None for r in rows] == [True, False, True]
    assert chip_smoke.phase_stacked_kernels(dev, mpo, ket, me, t, T=32,
                                            summary=False,
                                            bucket=False) == []
    out = capsys.readouterr().out
    for k in ("[8a stacked] torch_stacked bucket 1 roots",
              "[8a stacked] torch_stacked bucket 3 roots",
              "[8a stacked] torch_resident tiled_v1 1 roots",
              "[8a stacked] torch_tiled tiled_v1 1 roots",
              "[8b stacked] sweep 1", "largest res pool",
              "[8c tiled_v1] sweep 1", "[8c tiled_v1] E",
              "[3 kernels] K10_slab  f64 l", "[3 kernels] K11_stk_mix f32 r",
              "[3 kernels] K12_tiled_blocking f64 r", "(T 32 groups"):
        assert k in out, k


def test_chip_smoke_mix_phases_on_cpu(capsys):
    """Phase 9a (torch_resident under B2TPU_MIX=3 and =2 against the host
    backend), phases 9b and 9c (the v3 and v2 engines at K=6, D=20,
    against phase 5's port energy, sweep-0 energy and host reference) and
    the phase-3 K13-K16 rows, on the CPU."""
    dev = torch.device("cpu")
    chip_smoke.phase_mix_parity(dev, L=4, D=16, ns=4)
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    c9b, e9b, _ = chip_smoke.phase_mix_full(
        dev, drv, mpo, "3", chip_smoke.qc_sched(D), "9b mix v3", D=D)
    me = drv._last_dmrg.me
    assert me.v3_blockings > 0 and not any(c9b.values())
    # the rule a card run holds: K3 launches = v3 blockings
    with pytest.raises(SystemExit):
        chip_smoke.mix_launch_rules("9b", "3", c9b, me, True)
    c9c, _, e9c0 = chip_smoke.phase_mix_full(
        dev, drv, mpo, "2", chip_smoke.qc_sched(D, n_sweeps=1), "9c mix v2",
        D=D)
    assert len(drv._last_dmrg.sweep_log) == 1
    assert os.environ.get("B2TPU_MIX") is None    # restored
    c5, ket, e5, e5_0 = chip_smoke.phase_full(dev, drv, mpo, D=D,
                                              n_orb=n_orb)
    # K16 is on no path: its count is the measured one, and any launch fails
    by_phase = {"5": c5, "9b": c9b, "9c": c9c}
    assert chip_smoke.k16_launches(by_phase) == 0
    with pytest.raises(SystemExit):
        chip_smoke.k16_launches({**by_phase, "9b": {**c9b,
                                                    "K16_slab_matvec": 1}})
    ref = chip_smoke.timed_host_reference(
        mpo, drv.get_random_mps(D, seed=11), chip_smoke.qc_sched(D))
    chip_smoke.check_mix(e9b, e9c0, e5, e5_0, ref)
    with pytest.raises(SystemExit):
        chip_smoke.check_mix(e9b, e9c0 + 1e-6, e5, e5_0, ref)
    t = n_orb // 2 - 1
    me = chip_smoke.mid_site(mpo, ket, t)[0]
    rows = chip_smoke.phase_mix_kernels(dev, mpo, ket, me, t)
    assert [r["name"] for r in rows] == ["K13_env_gemm", "K14_place_v3",
                                         "K15_mix_v2", "K16_slab_matvec"]
    for r in rows:
        assert r["max_abs_err"] == 0.0      # the plain version vs itself
        assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
        assert r["bound_ms"] > 0
    assert [r["library_ms"] is None for r in rows] == [True, False, False,
                                                       True]
    out = capsys.readouterr().out
    for k in ("[9a mix] Hubbard-L4 D=16 x4 B2TPU_MIX=3",
              "[9a mix] Hubbard-L4 D=16 x4 B2TPU_MIX=2",
              "[9b mix v3] sweep 1", "(mix plans", "K13 0 K14 0",
              "[9c mix v2] sweep 0", "K15 0", "[9b mix v3] E",
              "[9c mix v2] sweep 0 E", "[9 mix] K16 launches by phase",
              "[3 kernels] mix plans site 2 rw",
              "[3 kernels] K13_env_gemm f64 lw", "lw window",
              "[3 kernels] K14_place_v3 f32 rw",
              "[3 kernels] K15_mix_v2 f64 rw", "[3 kernels] K16 vs K1",
              "[3 kernels] K16_slab_matvec f32"):
        assert k in out, k


def test_wide_site_checks_its_tile():
    """Phase 3's second site runs the kernels at the tile size it names,
    and fails when the plan picks another (here a small Hubbard-L8 MPS,
    whose plan picks T=16)."""
    dev = torch.device("cpu")
    mpo, mps = chip_smoke.wide_system(L=8, D=60)
    rows = chip_smoke.phase_kernels(dev, mpo, mps, 3, tile=16, blk_tile=32)
    assert len(rows) == 6
    with pytest.raises(SystemExit):
        chip_smoke.phase_kernels(dev, mpo, mps, 3, tile=128)


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19mv_kernelIdLi128EEEvPKT_S3_S3_PKiS5_S5_iPS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19mv_kernelIdLi128EEEvPKT_S3_S3_PKiS5_S5_iPS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 232 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113gather_kernelIfEEvPKT_PKixPS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113gather_kernelIfEEvPKT_PKixPS1_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 10 registers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111slab_stage1IdLi32EEEvPKT_S3_PKiS5_S5_S5_S5_iiPS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111slab_stage1IdLi32EEEvPKT_S3_PKiS5_S5_S5_S5_iiPS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__eb92dd_11_blocking_cu_001cab6c10blk_kernelIfLi16EEEvPKT_S3_S3_PKiS5_S5_iPS1_' for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__d85b1f52_8_tiled_cu_66d3a1d212tiled_kernelINS_4cplxIfEELi128EEEvPKT_' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__0a1b2c3d_11_mix_v2_cu_5e6f7a8b13mix_v2_kernelIdEEvPKT_PKiS3_iiPS1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 380 bytes cmem[0]
"""


def test_ptxas_usage_names_each_kernel_instance():
    assert chip_smoke.ptxas_usage(_PTXAS) == [
        ("mv_kernel<double,128>", 232, "0 bytes stack frame, 0 bytes spill "
         "stores, 0 bytes spill loads"),
        ("gather_kernel<float>", 10, "8 bytes stack frame, 4 bytes spill "
         "stores, 4 bytes spill loads"),
        ("slab_stage1<double,32>", 80, "0 bytes stack frame, 0 bytes spill "
         "stores, 0 bytes spill loads"),
        ("blk_kernel<float,16>", 64, "8 bytes stack frame, 8 bytes spill "
         "stores, 12 bytes spill loads"),
        ("tiled_kernel<complex<float>,128>", 128, "8 bytes stack frame, 4 "
         "bytes spill stores, 4 bytes spill loads"),
        ("mix_v2_kernel<double>", 30, "0 bytes stack frame, 0 bytes spill "
         "stores, 0 bytes spill loads")]


def test_launch_path_us_times_the_call_it_names():
    """Phase 3's host cost of the launch path: launch_path_us times
    ``kernels.call`` launching K19's dot on the given vectors into one
    preallocated output (any module with that interface, so a parent
    tree's _kernels can be timed beside the port's), one warm-up call
    first, and reports microseconds a call."""
    calls = []

    class Kernels:
        @staticmethod
        def call(*args):
            calls.append(args)

    a, b = torch.ones(2048), torch.ones(2048)
    us = chip_smoke.launch_path_us(Kernels, a, b, torch.device("cpu"), n=10)
    assert us > 0 and len(calls) == 11
    entry, dtype, x, y, n, out = calls[-1]
    assert (entry, dtype, n) == ("b2t_probe_dot", torch.float32, 2048)
    assert x is a and y is b and out.numel() == 1 and out is calls[0][-1]


def test_time_ms_counts_the_launches_a_call(capsys):
    """Phase 3's rows print the launches one timed call makes and the time
    a launch: time_ms counts the port's launch counters over the timed
    calls (not the warm-up) and returns them with the mean time."""
    from block2_preview_tpu_torch.ops import _kernels

    def two_launches():
        _kernels.KERNELS["K12_tiled_blocking"].launches += 2

    ms = chip_smoke.time_ms(two_launches, torch.device("cpu"), reps=3)
    _kernels.reset_counts()
    assert ms.launches == 2 and ms >= 0
    assert chip_smoke.time_ms(lambda: None, torch.device("cpu")).launches \
        == 0
    chip_smoke._check(None, "K12_tiled_blocking", np.float64, "l",
                      torch.ones(3), torch.ones(3), 1e-12, ms, 1.0, None,
                      8, 0.0, "shape")
    assert "(2 launches a call, " in capsys.readouterr().out


def test_histogram_and_chain_shapes():
    """The bins phase 3 prints for K8's item dims and the chain core's
    fragments: <= each edge (above the one before), then above the last;
    chain_shapes counts an item of 72 rows and 20 psi / sigma columns as
    two pieces (64 and 8 rows) of 24 and 3 live 8 x 8 fragments, one
    entry a chunk."""
    assert chip_smoke.histogram([1, 8, 9, 16, 200], (8, 16)) == \
        "<=8 2, <=16 2, >16 1"
    from block2_preview_tpu_torch.ops import chain_mv
    items = np.array([[0, 72, 5, 0, 20, 0, 20, 0]])
    tab = chain_mv.chunk_tables(items)
    txt = chip_smoke.chain_shapes(items, tab["ck"])
    assert txt.startswith("stage-1 fragments an entry: <=1 0, <=2 0, "
                          "<=4 1, <=8 0, <=16 0, <=32 1, ")
    assert "entries a chunk: <=1 2," in txt


def test_chip_smoke_npdm_phases_on_cpu(capsys):
    """Phases 10a (Hubbard-L4 PDMs through get_npdm and pooled_gram
    against the determinant path, transition PDMs, the RDM energy), 10b
    (K=6 1PDM/2PDM and a K=4 3PDM against host Grams from the script's
    worker, the RDM energy), 10c (run_smoke and the TF32 control), 10d
    (PlanExecutor against its twin and K8) and the phase-3 K17-K19 rows,
    at a small size on the CPU."""
    from block2_preview_tpu_torch.dmrg.effective import (
        EffectiveHamiltonian2)
    dev = torch.device("cpu")
    hub = chip_smoke.hubbard_npdm_states(dev, L=4, D=20, ns=4)
    chip_smoke.phase_npdm_hubbard(dev, *hub,
                                  chip_smoke.npdm_host_refs(*hub[3:]))
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    drv.dmrg(mpo, drv.get_random_mps(D, seed=11), bond_dims=[D],
             noises=[1e-4, 0], thrds=[1e-12], n_sweeps=2, tol=0, iprint=0,
             backend="numpy")
    ket = drv._last_dmrg.mps
    ket12 = chip_smoke.qc12_state(dev, n_orb=4, D=10)
    h1e, g2e = chip_smoke.seeded_qc_integrals(n_orb)
    with chip_smoke.host_pool(threads=1, workers=2) as pool:
        refs = [pool.apply_async(chip_smoke.host_gram, (ket, k))
                for k in (1, 2)]
        e_ref = pool.apply_async(chip_smoke.host_expectation, (mpo, ket))
        ref12 = pool.apply_async(chip_smoke.host_gram, (ket12, 3))
        k17, shapes = chip_smoke.phase_npdm_wide(
            dev, ket, h1e, g2e, [r.get(timeout=300) for r in refs],
            e_ref.get(timeout=300), ket12, ref12.get(timeout=300))
    assert k17 == 0 and shapes == []     # no close reaches 2e7 FLOP here
    assert chip_smoke.phase_probes(dev, pool_elems=1 << 16,
                                   tiled=(4, 20, 4)) == 0
    assert chip_smoke.phase_plan_exec(dev, L=6, D=20, t=2) == 0
    t = n_orb // 2 - 1
    eff = EffectiveHamiltonian2(chip_smoke.mid_site(mpo, ket, t)[0], t)
    rows = chip_smoke.phase_new_kernels(dev, [(5, 300, 40)], eff, t)
    assert [r["name"] for r in rows] == ["K17_npdm_gemm", "K18_plan_exec",
                                         "K19_probe"]
    for r in rows:
        assert r["max_abs_err"] == 0.0      # the plain version against itself
        assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes",
                                                       "operations")
    assert rows[0]["library_ms"] > 0
    assert rows[1]["library_ms"] is None and rows[2]["library_ms"] is None
    out = capsys.readouterr().out
    for k in ("[10a npdm order 4 get_npdm poly vs det]",
              "[10a npdm order 3 get_npdm poly vs pdm3_spatial]",
              "[10a npdm order 4 pooled_gram (K17) vs det]",
              "[10a npdm transition 3PDM", "[10a npdm] energy from the 1PDM",
              "[10b npdm order 2 device Gram vs host Gram]",
              "[10b npdm K=4 order 3 device Gram vs host Gram]",
              "[10b npdm] K=6 energy from the 1PDM and 2PDM",
              "[10c probes] run_smoke", "[10c probes] TF32 control",
              "[10d plan] L6c2: PlanExecutor.matvec (K18) vs K8",
              "[3 kernels] K17_npdm_gemm f64", "[3 kernels] K17_npdm_gemm c128",
              "[3 kernels] K18_plan_exec f32", "[3 kernels] K19_probe f32 dot",
              "[3 kernels] K19_probe f32 fill"):
        assert k in out, k


def test_npdm_phase_fails_on_a_wrong_pdm(monkeypatch):
    """10a's hold fails the script when a PDM leaves its tolerance."""
    dev = torch.device("cpu")
    hub = chip_smoke.hubbard_npdm_states(dev, L=4, D=20, ns=4)
    refs = chip_smoke.npdm_host_refs(*hub[3:])
    refs["det3"] = refs["det3"] + 1e-8
    with pytest.raises(SystemExit):
        chip_smoke.phase_npdm_hubbard(dev, *hub, refs)


def test_chip_smoke_shard_phases_on_cpu(capsys):
    """Phase 11a (a world-1 mesh in this process, gloo on the CPU, against
    the host energy of the same schedule) and the phase-3 K20-K22 and B22e
    rows (each rank's share of a world of two, forced into several task
    groups) at a small size on the CPU."""
    from block2_preview_tpu_torch.dmrg.effective import (
        EffectiveHamiltonian2)
    from block2_preview_tpu_torch.ops import blockv2, tilev2
    dev = torch.device("cpu")
    drv, mpo = chip_smoke.hubbard_model(4)
    e_ref = chip_smoke._host_reference(mpo, drv.get_random_mps(20, seed=7),
                                       chip_smoke.hub_sched(20, 2))
    counts = chip_smoke.phase_shard_one(dev, e_ref, L=4, D=20, ns=2)
    assert set(counts.values()) == {0}      # the twins launch nothing
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    drv.dmrg(mpo, drv.get_random_mps(D, seed=11), bond_dims=[D],
             noises=[1e-4, 0], thrds=[1e-12], n_sweeps=2, tol=0, iprint=0,
             backend="numpy")
    ket = drv._last_dmrg.mps
    t = n_orb // 2 - 1
    site = chip_smoke.mid_site(mpo, ket, t)
    eff = EffectiveHamiltonian2(site[0], t)
    saved = tilev2._CFG[16], blockv2._CFG[16]
    tilev2._CFG[16], blockv2._CFG[16] = (64, 64), (64, 64, 64)
    try:
        rows = chip_smoke.phase_shard_kernels(dev, mpo, ket, t, site, eff,
                                              (7, 300, 40))
    finally:
        tilev2._CFG[16], blockv2._CFG[16] = saved
    assert [r["name"] for r in rows] == ["K20_matvec_shard",
                                         "K21_block_shard",
                                         "K22_plan_exec_shard"]
    for r in rows:
        assert r["max_abs_err"] == 0.0      # the plain version against itself
        assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
        assert r["bound_ms"] > 0 and r["library_ms"] is None
    out = capsys.readouterr().out
    for k in ("[11a shard] world 1 (gloo) Hubbard-L4",
              "[3 kernels] K20_matvec_shard f64 r1",
              "[3 kernels] K21_block_shard f64 l1",
              "[3 kernels] K21_block_shard f64 r0",
              "[3 kernels] K22_plan_exec_shard f64 r1",
              "[3 kernels] K17_npdm_gemm f64 B22e r1",
              "B22e (K17 on row slices): the 2 shares summed"):
        assert k in out, k
    # both ranks own task groups under the small budgets
    assert "rank 1 of 2: groups 0 " not in out


def _rank_result(**kw):
    sweep = {"energy": -1.0, "wall": 1.0, "teff": 0.1, "teig": 0.1,
             "tdm": 0.1, "tblk": 0.1, "matvecs": 10, "idle_matvecs": 0,
             "all_reduce": 12, "all_reduce_s": 0.01, "K1_matvec": 0,
             "K5_block": 0, "K20_matvec_shard": 10, "K21_block_shard": 3,
             "K20_matvec_shard_units": 100, "K21_block_shard_units": 30}
    r = {"device": "cuda:0", "energy": -1.0, "wall": 1.0,
         "launches": {"K1_matvec": 0, "K5_block": 0,
                      "K20_matvec_shard": 10, "K21_block_shard": 3},
         "sweeps": [sweep], "idle_matvecs": 0, "matvecs": 10,
         "digest": "ab" * 20, "host": {"host_redo_count": 0},
         "k22": 1, "spe_rel": 1e-16, "k17": 5, "gram_d": 1e-16,
         "gram_s": 0.5}
    r.update(kw)
    return r


def test_shard_phase_rules(capsys):
    """11b's rules: it passes on agreeing ranks and fails the script when
    the ranks' energies or states differ in any bit, the energy leaves
    1e-8 Ha, K20 does not match the matvecs with units, K1 or K5 launched,
    K22 or K17 did not, a host counter moved, or ShardedPlanExecutor or
    the sharded Gram leaves 1e-12."""
    good = [_rank_result(), _rank_result()]
    chip_smoke.check_shard_ranks(good, -1.0 + 5e-9, "phase 5 port", True)
    out = capsys.readouterr().out
    assert "[11b shard] rank 1 (cuda:0) sweep 0 E" in out
    assert "all_reduce 12 in 0.010 s" in out
    launches = dict(good[0]["launches"])
    bad = [
        [_rank_result(), _rank_result(energy=-1.0 + 1e-15)],
        [_rank_result(), _rank_result(digest="cd" * 20)],
        [_rank_result(energy=-1.1), _rank_result(energy=-1.1)],
        [_rank_result(), _rank_result(idle_matvecs=2)],
        [_rank_result(), _rank_result(launches={**launches,
                                                "K1_matvec": 1})],
        [_rank_result(), _rank_result(launches={**launches,
                                                "K5_block": 2})],
        [_rank_result(), _rank_result(launches={**launches,
                                                "K21_block_shard": 0})],
        [_rank_result(k22=0), _rank_result()],
        [_rank_result(), _rank_result(k17=0)],
        [_rank_result(host={"host_redo_count": 1}), _rank_result()],
        [_rank_result(spe_rel=2e-12), _rank_result()],
        [_rank_result(), _rank_result(gram_d=3e-12)],
    ]
    for res in bad:
        with pytest.raises(SystemExit):
            chip_smoke.check_shard_ranks(res, -1.0, "phase 5 port", True)
    # on the CPU the twins launch nothing: the launch rules are the card's
    cpu = [_rank_result(launches={k: 0 for k in launches}, k22=0, k17=0)
           for _ in range(2)]
    chip_smoke.check_shard_ranks(cpu, -1.0, "world 1", False)


def test_shard_ranks_fail_on_a_rank_error(capsys):
    """Ranks that raise (here: a configuration without its system's size)
    fail 11b with their tracebacks."""
    cfg = dict(device="cpu", system="hubbard", threads=1, timeout=20)
    with pytest.raises(SystemExit):
        chip_smoke.run_ranks(cfg, deadline=60)
    assert "KeyError: 'L'" in capsys.readouterr().out
