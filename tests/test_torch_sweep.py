"""The port's slice as a whole: DMRGDriver.dmrg(..., device="cpu") of
block2_preview_tpu_torch — blocking, mix, diagonal, matvec, Davidson and
noise on the device path (CPU tensors run the kernels' twins) — against
the reference's jax_resident backend and its host numpy backend
(Hubbard-L8, D=80, 6 sweeps, noise 1e-5, f64: |dE| < 1e-8 Ha, the bar of
test_resident_backend_end_to_end), with no environment or LW/RW download
on the way; and a subprocess proof that the port — the resident and
tiled ground states, the stacked backend and the tiled_v1 blocking
engine, the bucketed backends' roots and projected states, and time
evolution — needs neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from block2_preview_tpu_torch import interop

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
    pmpo = interop.mpo(mpo)
    e_port = port.dmrg(pmpo, port.get_random_mps(D, seed=7), iprint=0,
                       device="cpu", **SCHED)
    assert abs(e_port - e_np) < 1e-8, (e_port, e_np)
    assert abs(e_port - e_res) < 1e-8, (e_port, e_res)
    solver = port._last_dmrg
    assert solver.backend == "torch_resident"
    assert solver.host_redo_count == 0
    assert solver.host_env_materialized == 0
    assert solver.host_ops_downloads == 0
    assert solver.me.max_rot_pool > 0
    assert len(solver.sweep_log) == NS
    # the port's own host path (the oracle chip_smoke.py uses) agrees too
    e_host = port.dmrg(pmpo, port.get_random_mps(D, seed=7), iprint=0,
                       backend="numpy", **SCHED)
    assert abs(e_host - e_np) < 1e-10, (e_host, e_np)


def test_port_float32_sweep():
    """The float32 path end to end (Ritz guard active) stays within
    float32 accuracy of the f64 host energy."""
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    drv, mpo = hubbard_driver()
    d, ns = 40, 4
    e_np = RefDMRG(mpo, drv.get_random_mps(d, seed=3), iprint=0).solve(
        [d] * ns, [1e-5] * (ns - 1) + [0], [1e-8], n_sweeps=ns, tol=0)
    s = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(d, seed=3)),
             device="cpu", dtype=np.float32, iprint=0)
    e = s.solve([d] * ns, [1e-5] * (ns - 1) + [0], [1e-8], n_sweeps=ns,
                tol=0)
    assert abs(e - e_np) < 1e-4, (e, e_np)
    assert s.host_redo_count == 0
    assert s.host_env_materialized == 0 and s.host_ops_downloads == 0


def test_energy_floor_redoes_on_host(monkeypatch):
    """A device site energy below B2TPU_E_FLOOR is redone on the host and
    counted; the run still reaches the host energy."""
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    drv, mpo = hubbard_driver()
    d = 30
    e_np = RefDMRG(mpo, drv.get_random_mps(d, seed=5), iprint=0).solve(
        [d] * 2, [0], [1e-10], n_sweeps=2, tol=0)
    monkeypatch.setenv("B2TPU_E_FLOOR", "100.0")   # every site is below
    s = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(d, seed=5)),
             device="cpu", iprint=0)
    e = s.solve([d] * 2, [0], [1e-10], n_sweeps=2, tol=0)
    assert s.host_redo_count == 2 * (mpo.n_sites - 1)
    assert abs(e - e_np) < 1e-8


def test_guard_raises_on_the_card(monkeypatch):
    """On a CUDA device a rejected eigenpair raises, naming the site and
    theta; there is no host redo there."""
    import torch
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    drv, mpo = hubbard_driver(L=4)
    s = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(10, seed=1)),
             device="cpu", iprint=0)
    monkeypatch.setenv("B2TPU_E_FLOOR", "100.0")
    s.device = torch.device("cuda", 0)      # the check, not a launch
    with pytest.raises(RuntimeError, match=r"site 2 rejected.*theta -1\.5"):
        s._guard(None, -1.5, None, 2)
    assert s.host_redo_count == 0


def test_default_device_is_cuda():
    """The CPU must be asked for explicitly: with no device given,
    DMRGDriver.dmrg and DMRG pick "cuda".  That resolves to the card where
    there is one and raises where there is none — there is no fallback to
    the CPU."""
    import inspect
    import torch
    from block2_preview_tpu_torch.driver.core import DMRGDriver
    from block2_preview_tpu_torch.dmrg.sweep import DMRG
    from block2_preview_tpu_torch.runtime import resolve_device
    for fn in (DMRGDriver.dmrg, DMRG.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    drv = DMRGDriver()
    drv.initialize_system(n_sites=4, n_elec=4, spin=0)
    mpo = interop.mpo(hubbard_driver(L=4)[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drv.dmrg(mpo, drv.get_random_mps(10))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DMRG(mpo, drv.get_random_mps(10))


_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["block2_preview_tpu"] = None   # and of the JAX package
import pkgutil
import block2_preview_tpu_torch
for m in pkgutil.walk_packages(block2_preview_tpu_torch.__path__,
                               "block2_preview_tpu_torch."):
    __import__(m.name)
import chip_smoke
from block2_preview_tpu_torch.core.fcidump import FCIDUMP
from block2_preview_tpu_torch.driver.core import DMRGDriver
fd = FCIDUMP.hubbard(4, u=2, t=1)
drv = DMRGDriver()
drv.initialize_system(n_sites=4, n_elec=4, spin=0)
mpo = drv.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=fd.const_e)
kw = dict(bond_dims=[20], noises=[1e-5, 1e-5, 0], thrds=[1e-10],
          n_sweeps=4, tol=0, iprint=0)
e = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), device="cpu", **kw)
s = drv._last_dmrg
assert s.host_env_materialized == 0 and s.host_ops_downloads == 0
e_ref = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), backend="numpy",
                 **kw)
assert abs(e - e_ref) < 1e-10, (e, e_ref)
e_t = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), device="cpu",
               backend="torch_tiled", **kw)
assert abs(e_t - e_ref) < 1e-8, (e_t, e_ref)
import os
for backend, engine in (("torch_stacked", None),
                        ("torch_resident", "tiled_v1"),
                        ("torch_tiled", "tiled_v1")):
    if engine:
        os.environ["B2TPU_STK_ENGINE"] = engine
    e_s = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), device="cpu",
                   backend=backend, **kw)
    os.environ.pop("B2TPU_STK_ENGINE", None)
    assert abs(e_s - e_ref) < 1e-8, (backend, e_s, e_ref)
gs = drv._last_dmrg.mps
r_ref = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), backend="numpy",
                 n_roots=2, **kw)
for backend in ("torch", "torch_device"):
    r = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), device="cpu",
                 backend=backend, n_roots=2, **kw)
    assert abs(r - r_ref).max() < 1e-8, (backend, r, r_ref)
    e_p = drv.dmrg(mpo, drv.get_random_mps(20, seed=5), device="cpu",
                   backend=backend, proj_mpss=[gs], **kw)
    assert e_p > e_ref + 1e-3, (backend, e_p, e_ref)
for imaginary in (False, True):
    _, te = drv.td_dmrg(mpo, chip_smoke.copy_mps(gs), 0.05, 1, 20,
                        imaginary=imaginary, device="cpu")
    _, th = drv.td_dmrg(mpo, chip_smoke.copy_mps(gs), 0.05, 1, 20,
                        imaginary=imaginary, backend="numpy")
    assert te.host_matvec_count == 0 and te.n_matvec > 0
    assert abs(te.energies[-1] - th.energies[-1]) < 1e-8
import numpy as np
from block2_preview_tpu_torch.dmrg.npdm import npdm_spatial
for k in (1, 2, 3, 4):
    got = (drv.get_trans_2pdm(gs, gs) if k == 2 else
           drv.get_npdm(gs, k, algo="poly", device="cpu"))
    got = got.sum(axis=0) if k == 1 else got
    assert np.abs(got - npdm_spatial(gs, k)).max() < 1e-10, k
from block2_preview_tpu_torch.dmrg.effective import EffectiveHamiltonian2
from block2_preview_tpu_torch.ops.exec_bucket import (BucketExecutor,
                                                      PlanExecutor)
me = chip_smoke.mid_site(mpo, gs, 1)[0]
eff = EffectiveHamiltonian2(me, 1)
x = np.random.default_rng(1).standard_normal(eff.size)
assert np.allclose(PlanExecutor(eff, device="cpu").matvec(x),
                   BucketExecutor(eff, device="cpu").matvec(x), atol=1e-12)
from block2_preview_tpu_torch.utils.gpu_smoke import run_smoke
assert run_smoke("cpu", pool_elems=1 << 12, tiled=(4, 20, 4))["ok"]
import torch.distributed as dist
from block2_preview_tpu_torch.dmrg.npdm_scheme import pooled_gram
from block2_preview_tpu_torch.parallel.multihost import global_mesh
from block2_preview_tpu_torch.parallel.shard import ShardedPlanExecutor
mesh = global_mesh(device_type="cpu")
e_m = drv.dmrg(mpo, drv.get_random_mps(20, seed=3), device="cpu",
               mesh=mesh, **kw)
assert abs(e_m - e_ref) < 1e-10, (e_m, e_ref)
assert np.allclose(ShardedPlanExecutor(eff, mesh).matvec(x),
                   BucketExecutor(eff, device="cpu").matvec(x), atol=1e-12)
assert np.abs(pooled_gram(gs, 2, device=mesh, device_min_flop=0)[0]
              - pooled_gram(gs, 2, device=None)[0]).max() < 1e-12
dist.destroy_process_group()
assert not any(k == "jax" or k.startswith(("jax.", "block2_preview_tpu."))
               for k, v in sys.modules.items() if v is not None)
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
    """No port file and not chip_smoke.py imports JAX or the JAX package
    (file:line strings in comments may still name the reference)."""
    pat = re.compile(r"^\s*(import jax|from jax"
                     r"|(from|import)\s+block2_preview_tpu(?!_torch))", re.M)
    files = list((ROOT / "block2_preview_tpu_torch").rglob("*.py"))
    assert files
    for f in files + [ROOT / "chip_smoke.py", ROOT / "profile_port.py",
                      ROOT / "shard_cards.py"]:
        assert not pat.search(f.read_text()), f
