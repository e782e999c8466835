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


def test_chip_smoke_phases_on_cpu(capsys):
    """Phase 5 (main path against the host reference, launch counts) and
    phase 3 (kernel vs twin rows on the MPS phase 5 leaves) at K=6, D=20
    on the CPU."""
    dev = torch.device("cpu")
    n_orb, D = 6, 20
    drv, mpo, _ = chip_smoke.qc_system(n_orb, n_orb)
    counts, ket = chip_smoke.phase_full(dev, drv, mpo, D=D, n_orb=n_orb)
    # CPU tensors run the twins, which launch nothing
    assert counts == {"K1_matvec": 0, "K2_diag": 0, "K3_mix": 0,
                      "K4_place": 0}
    assert drv._last_dmrg.mps is ket
    rows = chip_smoke.phase_kernels(dev, mpo, ket, n_orb // 2 - 1)
    assert [r["name"] for r in rows] == list(counts)
    for r in rows:
        assert r["max_abs_err"] == 0.0      # twin against itself
        assert r["route"] == "cuda" and (ROOT / r["source"]).is_file()
    out = capsys.readouterr().out
    assert "[5 full] sweep 1" in out and "dE" in out
    assert "[3 kernels] K1_matvec f64" in out
    json.dumps(rows)
    assert np.isfinite([r["ms"] for r in rows]).all()


def test_wide_site_checks_its_tile():
    """Phase 3's second site runs the kernels at the tile size it names,
    and fails when the plan picks another (here a small Hubbard-L8 MPS,
    whose plan picks T=16)."""
    dev = torch.device("cpu")
    mpo, mps = chip_smoke.wide_system(L=8, D=60)
    rows = chip_smoke.phase_kernels(dev, mpo, mps, 3, tile=16)
    assert len(rows) == 4
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
"""


def test_ptxas_usage_names_each_kernel_instance():
    assert chip_smoke.ptxas_usage(_PTXAS) == [
        ("mv_kernel<double,128>", 232, "0 bytes stack frame, 0 bytes spill "
         "stores, 0 bytes spill loads"),
        ("gather_kernel<float>", 10, "8 bytes stack frame, 4 bytes spill "
         "stores, 4 bytes spill loads")]
