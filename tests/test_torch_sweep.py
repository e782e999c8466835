"""The port's slice as a whole: DMRGDriver.dmrg(..., device="cpu") of
block2_preview_tpu_torch against the reference's jax_resident backend and
its host numpy backend (Hubbard-L8, D=80, 6 sweeps, noise 1e-5, f64:
|dE| < 1e-8 Ha, the bar of test_resident_backend_end_to_end), and a
subprocess proof that the port never needs JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from test_torch_plans import hubbard_driver

ROOT = Path(__file__).resolve().parents[1]
D, NS = 80, 6
SCHED = dict(bond_dims=[D] * NS, noises=[1e-5] * NS + [0], thrds=[1e-10],
             n_sweeps=NS, tol=0)


def _ref(mpo, mps, backend, **kw):
    return RefDMRG(mpo, mps, backend=backend, iprint=0, **kw).solve(
        SCHED["bond_dims"], SCHED["noises"], SCHED["thrds"], n_sweeps=NS,
        tol=0)


def test_port_matches_jax_resident_and_numpy(monkeypatch):
    from block2_preview_tpu_torch.driver.core import DMRGDriver
    monkeypatch.setenv("B2TPU_RES_MIN_SIZE", "1")
    monkeypatch.delenv("B2TPU_RES_EDGE_HOST", raising=False)
    drv, mpo = hubbard_driver()
    e_np = _ref(mpo, drv.get_random_mps(D, seed=7), "numpy")
    e_res = _ref(mpo, drv.get_random_mps(D, seed=7), "jax_resident",
                 dtype=np.float64)
    port = DMRGDriver()
    port.initialize_system(n_sites=8, n_elec=8, spin=0)
    e_port = port.dmrg(mpo, port.get_random_mps(D, seed=7), iprint=0,
                       device="cpu", **SCHED)
    assert abs(e_port - e_np) < 1e-8, (e_port, e_np)
    assert abs(e_port - e_res) < 1e-8, (e_port, e_res)
    solver = port._last_dmrg
    assert solver.backend == "torch_resident"
    assert solver.host_redo_count == 0
    assert len(solver.sweep_log) == NS


def test_port_float32_sweep():
    """The float32 path end to end (Ritz guard active) stays within
    float32 accuracy of the f64 host energy."""
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    drv, mpo = hubbard_driver()
    d, ns = 40, 4
    e_np = RefDMRG(mpo, drv.get_random_mps(d, seed=3), iprint=0).solve(
        [d] * ns, [1e-5] * (ns - 1) + [0], [1e-8], n_sweeps=ns, tol=0)
    s = DMRG(mpo, drv.get_random_mps(d, seed=3), device="cpu",
             dtype=np.float32, iprint=0)
    e = s.solve([d] * ns, [1e-5] * (ns - 1) + [0], [1e-8], n_sweeps=ns,
                tol=0)
    assert abs(e - e_np) < 1e-4, (e, e_np)
    assert s.host_redo_count == 0


def test_energy_floor_redoes_on_host(monkeypatch):
    """A device site energy below B2TPU_E_FLOOR is redone on the host and
    counted; the run still reaches the host energy."""
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    drv, mpo = hubbard_driver()
    d = 30
    e_np = RefDMRG(mpo, drv.get_random_mps(d, seed=5), iprint=0).solve(
        [d] * 2, [0], [1e-10], n_sweeps=2, tol=0)
    monkeypatch.setenv("B2TPU_E_FLOOR", "100.0")   # every site is below
    s = DMRG(mpo, drv.get_random_mps(d, seed=5), device="cpu", iprint=0)
    e = s.solve([d] * 2, [0], [1e-10], n_sweeps=2, tol=0)
    assert s.host_redo_count == 2 * (mpo.n_sites - 1)
    assert abs(e - e_np) < 1e-8


def test_guard_raises_on_the_card(monkeypatch):
    """On a CUDA device a rejected eigenpair raises, naming the site and
    theta; there is no host redo there."""
    import torch
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    drv, mpo = hubbard_driver(L=4)
    s = DMRG(mpo, drv.get_random_mps(10, seed=1), device="cpu", iprint=0)
    monkeypatch.setenv("B2TPU_E_FLOOR", "100.0")
    s.device = torch.device("cuda", 0)      # the check, not a launch
    with pytest.raises(RuntimeError, match=r"site 2 rejected.*theta -1\.5"):
        s._guard(None, -1.5, None, 2)
    assert s.host_redo_count == 0


def test_driver_requires_explicit_device():
    from block2_preview_tpu_torch.driver.core import DMRGDriver
    drv = DMRGDriver()
    drv.initialize_system(n_sites=4, n_elec=4, spin=0)
    _, mpo = hubbard_driver(L=4)
    with pytest.raises(ValueError):
        drv.dmrg(mpo, drv.get_random_mps(10), device=None)


_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
import block2_preview_tpu_torch
import block2_preview_tpu_torch.interop
from block2_preview_tpu_torch.ops import (device_davidson, mixv3, mixv4,
                                          resident, stacked, tilev2)
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu.core.fcidump import FCIDUMP
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
fd = FCIDUMP.hubbard(4, u=2, t=1)
drv = DMRGDriver()
drv.initialize_system(n_sites=4, n_elec=4, spin=0)
mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
kw = dict(n_sweeps=4, tol=0)
e = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), bond_dims=[20],
             noises=[1e-5, 1e-5, 0], thrds=[1e-10], iprint=0, device="cpu",
             **kw)
e_ref = RefDMRG(mpo, drv.get_random_mps(20, seed=3), iprint=0).solve(
    [20], [1e-5, 1e-5, 0], [1e-10], **kw)
assert abs(e - e_ref) < 1e-10, (e, e_ref)
print("ENERGY", e, e_ref)
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ENERGY" in proc.stdout


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = list((ROOT / "block2_preview_tpu_torch").rglob("*.py"))
    assert files
    for f in files + [ROOT / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f
