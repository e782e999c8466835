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
              "K6_noise  f64 lw", "K6_noise  f32 rw", "K2_diag   f64",
              "K2_diag   f32"):
        assert f"[3 kernels] {k}" in out, k
    # K3's rows: the mix's lw and rw, then each v3 blocking plan's after
    # its K5 row, in f64 and f32; each names its tiles, gaps, slices and
    # both FLOP counts, and K2's its rows and zero rows
    k3 = [ln.split()[2:5] for ln in out.splitlines()
          if ln.startswith("[3 kernels] K3_mix")]
    assert k3 == [["K3_mix", t, side] for t in ("f64", "f32")
                  for side in ("lw", "rw", "l3", "r3")]
    order = [ln.split()[2] + " " + ln.split()[4] for ln in out.splitlines()
             if ln.startswith(("[3 kernels] K3_mix", "[3 kernels] K5_block"))
             and " f64 " in ln]
    assert order == ["K3_mix lw", "K3_mix rw", "K5_block l3", "K3_mix l3",
                     "K5_block l2", "K5_block r3", "K3_mix r3",
                     "K5_block r2"]
    assert out.count("zero tiles, ") == 8 and out.count(
        "on W's non-zeros; host tables") == 8
    assert out.count("zero rows ") == 2
    k3_line = [ln for ln in out.splitlines()
               if ln.startswith("[5 full] K3 host tables: ")]
    assert len(k3_line) == 1 and " s a sweep (inside " in k3_line[0]
    assert int(k3_line[0].split()[5]) > 0
    # K5's rows name its two paths, K6's its runs and partial pool, and
    # phase 5 the noise calls' own peak
    assert out.count("slab path: runs ") == 8 and "; stores;" in out
    assert "; atomics;" in out and out.count("partial pool ") == 4
    assert "[5 full] noise calls " in out
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
    K10/K11/K12 rows (K10's also alone, as at the wide site), on the
    CPU."""
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
    chip_smoke.phase_slab_wide(dev, mpo, ket, me, t)
    out = capsys.readouterr().out
    for k in ("[8a stacked] torch_stacked bucket 1 roots",
              "[8a stacked] torch_stacked bucket 3 roots",
              "[8a stacked] torch_resident tiled_v1 1 roots",
              "[8a stacked] torch_tiled tiled_v1 1 roots",
              "[8b stacked] sweep 1", "largest res pool",
              "[8c tiled_v1] sweep 1", "[8c tiled_v1] E",
              "[3 kernels] K10_slab  f64 l", "[3 kernels] K11_stk_mix f32 r",
              "[3 kernels] K12_tiled_blocking f64 r", "(T 32 groups",
              "works an item median", "CUDA blocks"):
        assert k in out, k
    assert out.count("[3 kernels] K10_slab  f64 r") == 2


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


def test_beside_run_times_k9_to_k16_and_keeps_their_outputs(
        tmp_path, monkeypatch, capsys):
    """The script ``--beside`` runs in each tree (BESIDE_RUN), on the CPU
    at K=10, D=12 (site 7): phase 3's K1-K6 rows, the stacked (K10-K12)
    and sharded (K20-K22) rows, phases 5 and 8b, and K10's, K5's (v3
    rotate plans), K3's (the mix's OUT and the v3 final pools), K2's (on
    the inputs the pickle holds, two sites) and K6's f64 outputs with
    K10's and K5's inputs saved for the parent-against-change check, which
    finds a run bitwise equal to itself and reports a difference."""
    import pickle
    drv, mpo, _ = chip_smoke.qc_system(10, 10)
    ket = chip_smoke.copy_mps(drv.get_random_mps(12, seed=11))
    path, saved = tmp_path / "ket.pkl", tmp_path / "out.pt"
    cpu = torch.device("cpu")
    wide = chip_smoke.wide_system(L=8, D=30)
    with open(path, "wb") as f:
        pickle.dump({"ket": ket, "envs": chip_smoke.site_envs(mpo, ket, 7),
                     "k2": {
            "site7": chip_smoke.diag_inputs(cpu, mpo, ket, 7),
            "T128": chip_smoke.diag_inputs(cpu, *wide, 3)}}, f)
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    monkeypatch.setattr(chip_smoke, "qc_system",
                        lambda n_orb, n_elec: (drv, mpo, 0.0))
    monkeypatch.setattr(sys, "argv", ["-c", str(path), str(saved), "cpu",
                                      "12"])
    exec(compile(chip_smoke.BESIDE_RUN, "BESIDE_RUN", "exec"),
         {"__name__": "__beside__"})
    out = capsys.readouterr().out
    for k in ("K5_block  f64 l3", "K5_block  f32 r2", "K6_noise  f64 rw",
              "K10_slab  f32 l", "K11_stk_mix f64 r",
              "K12_tiled_blocking f32 r", "K21_block_shard f64 l1",
              "K20_matvec_shard f64 r0"):
        assert f"[3 kernels] {k}" in out, k
    for k in ("[5 full] sweep 1", "[5 full] noise calls",
              "[8b stacked] sweep 1"):
        assert k in out, k
    outs = torch.load(saved)
    assert sorted(outs) == ["K10 input left", "K10 input right",
                            "K10 left", "K10 right", "K2 T128", "K2 site7",
                            "K3 left", "K3 lw", "K3 right", "K3 rw",
                            "K5 input left", "K5 input right", "K5 left",
                            "K5 right", "K6 lw", "K6 rw"]
    moved = {k: v.clone() for k, v in outs.items()}
    moved["K6 rw"][0] += 1.0
    chip_smoke.beside_outputs([("parent", outs), ("change", outs),
                               ("change", moved)])
    out = capsys.readouterr().out
    assert "[beside 1 change] K10 left output bitwise equal" in out
    assert "[beside 2 change] K6 rw output differs from the parent's" \
        in out


def test_beside_outputs_hold_k10_bitwise_and_k5_to_1e14(capsys):
    """The parent-against-change gate: K10's outputs and every input must
    be bitwise equal, K5's within 1e-14 of the parent's largest entry; a
    parent turn that differs is only reported."""
    f64 = torch.float64
    base = {"K10 left": torch.arange(4.0, dtype=f64),
            "K5 left": torch.ones(4, dtype=f64),
            "K5 input left": torch.ones(3, dtype=f64)}

    def run(turn, key, delta):
        moved = {k: v.clone() for k, v in base.items()}
        moved[key][0] += delta
        chip_smoke.beside_outputs([("parent", base), (turn, moved)])

    run("change", "K5 left", 1e-15)
    run("parent", "K10 left", 1.0)
    for key, delta in (("K10 left", 1e-12), ("K5 left", 1e-12),
                       ("K5 input left", 1e-12)):
        with pytest.raises(SystemExit):
            run("change", key, delta)
    assert "FAIL: beside: K10 left rel" in capsys.readouterr().out


def test_noise_peaks_counts_each_noise_call():
    """noise_peaks wraps the noise call for the block only: it counts the
    calls made through resident.noise_exec and restores it after (on the
    CPU no device memory is read)."""
    from block2_preview_tpu_torch.ops import resident
    orig = resident.noise_exec
    with chip_smoke.noise_peaks(torch.device("cpu")) as npk:
        assert resident.noise_exec is not orig
        with pytest.raises(Exception):
            resident.noise_exec(None, None, {}, 16)
    assert resident.noise_exec is orig
    assert npk["calls"] == 1 and npk["peak"] == 0


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


def test_k5_strips_phase_needs_three_strips(capsys):
    """The phase that runs K5's tile path over items of three and more
    strips of l (the Hubbard-L16 D=1000 site at T=16) passes there on the
    plain versions, printing its histogram, the bitwise checks and K21's
    shares; on a small Hubbard-L8 site, where no item has three strips,
    it fails."""
    dev = torch.device("cpu")
    mpo, mps = chip_smoke.wide_system()
    chip_smoke.phase_k5_strips(dev, mpo, mps,
                               chip_smoke.mid_site(mpo, mps, 7)[0], 7)
    out = capsys.readouterr().out
    for side in ("l3", "r3"):
        assert (f"[3 kernels] K5_block f64 {side} at T 16: tile path items "
                in out)
    assert out.count("two launches bitwise equal; K21's 2 shares summed "
                     "bitwise one launch") == 2
    mpo, mps = chip_smoke.wide_system(L=8, D=60)
    with pytest.raises(SystemExit):
        chip_smoke.phase_k5_strips(dev, mpo, mps,
                                   chip_smoke.mid_site(mpo, mps, 3)[0], 3)


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
ptxas info    : Compiling entry function '_ZN3b2t17mix_gather_kernelIdLb1EEEvPKT_iPKiiS5_S5_S5_PS3_PS1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
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
         "stores, 0 bytes spill loads"),
        ("mix_gather_kernel<double,true>", 40, "0 bytes stack frame, 0 "
         "bytes spill stores, 0 bytes spill loads")]


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


class _Ready:
    """A worker's result already in hand (``multiprocessing``'s
    ``AsyncResult.get``)."""

    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value


def test_chip_smoke_gf_phases_on_cpu(capsys):
    """Phases 12a-12d at a small size on the CPU (K7's and K8's plain
    versions): the Hubbard-L4 Green's function against ED and the host,
    the linear sweeps' bars, one K=4 QC point with its per-sweep split and
    the K7-vs-matvec_np check at the solve's center, orbital rotation
    against the host run and one-site sweeps against theirs."""
    dev = torch.device("cpu")
    L, D = 4, 16
    drv, mpo = chip_smoke.hubbard_model(L)
    gs = drv.get_random_mps(D, seed=7)
    e0 = drv.dmrg(mpo, gs, backend="numpy", **chip_smoke.hub_sched(D, 6))
    ed = chip_smoke.hubbard_gf_ed(L)
    assert abs(ed[1] - e0) < 1e-9 and ed[2] == 24    # C(4,1) C(4,2)
    assert chip_smoke.phase_gf_hubbard(dev, gs, e0, ed, L=L, D=D) == 0
    qdrv, qmpo, _ = chip_smoke.qc_system(4, 4)
    ket = qdrv.get_random_mps(D, seed=11)
    e5 = qdrv.dmrg(qmpo, ket, bond_dims=[D], noises=[1e-4, 0],
                   thrds=[1e-12], n_sweeps=2, tol=0, iprint=0,
                   backend="numpy")
    assert chip_smoke.phase_gf_full(dev, qdrv, qmpo, ket, e5, D=D, t=1) == 0
    host = chip_smoke.host_rotation(gs, L=L, D=D)
    assert chip_smoke.phase_rotation(dev, gs, e0, _Ready(host), L=L,
                                     D=D) == 0
    hosts = [_Ready(chip_smoke.host_onedot(L=L, D=D, last_site_1site=ls1))
             for ls1 in (False, True)]
    assert chip_smoke.phase_onedot(dev, hosts, L=L, D=D) == 0
    out = capsys.readouterr().out
    for k in ("[12a gf] Hubbard-L4 D=16", "[12a gf] greens_function K7",
              "[12a gf] host (numpy) complex", "n_harmonic_projection=2",
              "[12a linear] compress_mps", "[12b gf] sweep F",
              "[12b gf] sweep B", "GMRES matvecs a site max",
              "[12b gf] K7 c128 at the solve's center 1",
              "[12c rotation] Hubbard-L4", "[12d onedot] Hubbard-L4",
              "torch twodot_to_onedot=4", "torch_tiled last_site_1site"):
        assert k in out, k


def test_gf_and_rotation_phases_fail_off_their_references():
    """12a fails on a Green's function away from ED, 12c on a rotation
    away from the host's, 12d on an energy away from the host's."""
    dev = torch.device("cpu")
    L, D = 4, 16
    drv, mpo = chip_smoke.hubbard_model(L)
    gs = drv.get_random_mps(D, seed=7)
    e0 = drv.dmrg(mpo, gs, backend="numpy", **chip_smoke.hub_sched(D, 6))
    g, e_ed, n = chip_smoke.hubbard_gf_ed(L)
    with pytest.raises(SystemExit):
        chip_smoke.phase_gf_hubbard(dev, gs, e0, (g + 1e-4, e_ed, n), L=L,
                                    D=D)
    e_rot, e_old = chip_smoke.host_rotation(gs, L=L, D=D)
    with pytest.raises(SystemExit):
        chip_smoke.phase_rotation(dev, gs, e0, _Ready((e_rot + 1e-7,
                                                       e_old)), L=L, D=D)
    with pytest.raises(SystemExit):
        chip_smoke.phase_onedot(dev, [_Ready(e0 + 1e-6), _Ready(e0)], L=L,
                                D=D)


SU2_HUB4 = dict(chip_smoke.SU2_HUB, L=4, n_elec=4, D=20)
SU2_QC6 = dict(chip_smoke.SU2_QC, L=6, n_elec=8, D=60)


def test_chip_smoke_su2_phases_on_cpu(capsys):
    """Phase 13 at a small size on the CPU (K5's and K7's plain versions):
    13a on Hubbard-L4 against ED and the host engine, 13b's two spins of
    seeded K=6 integrals with 8 electrons (a triplet ground state) in
    spawned processes against the host engine, with the K7 sigma and K5
    pool checks at the middle centre."""
    dev = torch.device("cpu")
    runs = chip_smoke.su2_spawn(dev, SU2_QC6)
    assert chip_smoke.phase_su2_hubbard(
        dev, _Ready(chip_smoke.host_su2(SU2_HUB4)),
        _Ready(chip_smoke.su2_hubbard_ed(SU2_HUB4)), cfg=SU2_HUB4) == (0, 0)
    hosts = {tw: _Ready(chip_smoke.host_su2(SU2_QC6, tw)) for tw in (2, 0)}
    assert chip_smoke.phase_su2_qc(runs, hosts) == (0, 0)
    out = capsys.readouterr().out
    for k in ("[13a su2] L=4 N=4 2S=0 D=20", "[13a su2] sweep 5",
              "[13a su2] ED", "[13b su2] 2S=2:", "[13b su2] 2S=0:",
              "host engine"):
        assert k in out, k


def test_su2_phases_fail_off_their_references():
    """13a fails on an energy away from ED or the host engine; 13b on an
    energy away from the host's, on a singlet below the triplet, and on a
    run that raised."""
    dev = torch.device("cpu")
    e_host = chip_smoke.host_su2(SU2_HUB4)
    e_ed = chip_smoke.su2_hubbard_ed(SU2_HUB4)
    for host, ed in (((e_host[0] + 1e-7,) + e_host[1:], e_ed),
                     (e_host, e_ed + 1e-7)):
        with pytest.raises(SystemExit):
            chip_smoke.phase_su2_hubbard(dev, _Ready(host), _Ready(ed),
                                         cfg=SU2_HUB4)
    res = {2: {"e": -2.0, "K5_block": 0, "K7_tiled": 0},
           0: {"e": -1.0, "K5_block": 0, "K7_tiled": 0}}
    ok = {2: _Ready((-2.0, [], 0.0)), 0: _Ready((-1.0, [], 0.0))}
    assert chip_smoke.phase_su2_qc(lambda: res, ok) == (0, 0)
    with pytest.raises(SystemExit):
        chip_smoke.phase_su2_qc(lambda: res, {2: _Ready((-2.0 + 1e-7, [], 0)),
                                              0: ok[0]})
    flipped = {2: dict(res[2], e=-1.0), 0: dict(res[0], e=-2.0)}
    with pytest.raises(SystemExit):
        chip_smoke.phase_su2_qc(lambda: flipped, {
            2: _Ready((-1.0, [], 0.0)), 0: _Ready((-2.0, [], 0.0))})
    # 9 electrons on 2 sites: the spawned runs raise (target unreachable)
    runs = chip_smoke.su2_spawn(dev, dict(SU2_QC6, L=2, n_elec=9))
    with pytest.raises(SystemExit):
        runs()


def test_gf_full_one_sweep_blocks_the_stale_right_environments(capsys):
    """12b as the script runs it, one (forward) sweep: the centre check
    first blocks the right environments the sweep left stale, then holds
    K7's c128 sigma to matvec_np."""
    dev = torch.device("cpu")
    qdrv, qmpo, _ = chip_smoke.qc_system(4, 4)
    ket = qdrv.get_random_mps(16, seed=11)
    e5 = qdrv.dmrg(qmpo, ket, bond_dims=[16], noises=[1e-4, 0],
                   thrds=[1e-12], n_sweeps=2, tol=0, iprint=0,
                   backend="numpy")
    assert chip_smoke.phase_gf_full(dev, qdrv, qmpo, ket, e5, D=16, t=1,
                                    n_sweeps=1) == 0
    out = capsys.readouterr().out
    assert "[12b gf] sweep F" in out and "[12b gf] sweep B" not in out
    assert "[12b gf] K7 c128 at the solve's center 1" in out


def _echo_proc(value, queue):
    queue.put(("echo", {"value": value}))


def test_spawn_procs_collects_results_and_fails_on_errors():
    """The spawned phases' plumbing: a result comes back by its key, and
    phase 11's process failing (here: a CUDA device on a machine without
    one) fails the phase instead of passing silently."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA for the failing run")
    wait = chip_smoke.spawn_procs({"echo": (_echo_proc, (7,))}, "test")
    assert wait() == {"echo": {"value": 7}}
    runs = chip_smoke.spawn_procs({"11": (chip_smoke.shard_proc,
                                          ("cuda", -1.0, None, -1.0))},
                                  "phase")
    with pytest.raises(SystemExit):
        runs()
