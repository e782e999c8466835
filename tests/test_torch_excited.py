"""Excited states on the port's bucketed and tiled backends against the JAX
package's on Hubbard-L6 (built in code), D=50, 4 sweeps, Davidson
|r|^2 < 1e-14: state-averaged roots on ``torch`` / ``torch_device`` /
``torch_tiled`` against ``jax`` / ``jax_device`` / ``jax_tiled`` and the
port's ``numpy`` backend, every root to 1e-8 Ha; one float32 root on
``torch_device`` against ``jax_device`` in float32 to 1e-5 Ha; projected
excited states (ortho and penalty) against ``jax`` with the same
projector (the recipe of tests/test_projection.py); the driver's
``extract_root`` and ``get_dmrg_results`` against the reference driver's;
and the backends' refusals.

The reference solves centers below 4096 unknowns on the host
(sweep.py:655-659); the port runs every center through its kernels'
plain versions here.  So the two are held to the energies, not to
per-site launch or matvec counts."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.sweep import DMRG
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu_torch.ops import _kernels

from test_torch_plans import hubbard_driver
from test_torch_tdvp import overlap

L6, D, NS = 6, 50, 4
SCHED = dict(bond_dims=[D], noises=[1e-5, 1e-5, 0], dav_thrds=[1e-14],
             n_sweeps=NS, tol=0)


def solve(solver):
    return np.atleast_1d(solver.solve(**SCHED))


def ref_run(mpo, mps, backend, **kw):
    return RefDMRG(mpo, mps, backend=backend, iprint=0, **kw)


def port_run(mpo, mps, backend, **kw):
    dev = {} if backend == "numpy" else {"device": "cpu"}
    return DMRG(interop.mpo(mpo), interop.mps(mps), backend=backend,
                iprint=0, **dev, **kw)


@pytest.fixture(scope="module")
def hubbard():
    return hubbard_driver(L6)


@pytest.fixture(scope="module")
def ground_state(hubbard):
    """The reference's host ground state (the projector of the
    state-specific runs)."""
    drv, mpo = hubbard
    s = ref_run(mpo, drv.get_random_mps(D, seed=7), "numpy")
    solve(s)
    return s.mps


@pytest.mark.parametrize("backend,ref_backend,n_roots", [
    ("torch", "jax", 3), ("torch_device", "jax_device", 3),
    ("torch_tiled", "jax_tiled", 2)])
def test_state_averaged_roots(hubbard, backend, ref_backend, n_roots):
    drv, mpo = hubbard
    _kernels.reset_counts()
    port = port_run(mpo, drv.get_random_mps(D, seed=7), backend,
                    n_roots=n_roots)
    e = solve(port)
    e_ref = solve(ref_run(mpo, drv.get_random_mps(D, seed=7), ref_backend,
                          n_roots=n_roots, dtype=np.float64))
    e_np = solve(port_run(mpo, drv.get_random_mps(D, seed=7), "numpy",
                          n_roots=n_roots))
    assert e.shape == (n_roots,) and np.all(np.diff(e) > 0)
    assert np.abs(e - e_ref).max() < 1e-8, (e, e_ref)
    assert np.abs(e - e_np).max() < 1e-8, (e, e_np)
    assert port.host_redo_count == 0
    # CPU tensors run the plain versions, which launch nothing
    assert not any(_kernels.launch_counts().values())
    log = port.sweep_log[-1]
    assert log["energies"].shape == (n_roots,) and log["matvecs"] > 0
    if backend == "torch_device":
        # every blocking step went through the device path: three pools,
        # the tables up and the output down
        assert log["downloads"] == L6 - 1 and log["uploads"] > 3 * log[
            "downloads"]
    else:
        assert log["uploads"] == log["downloads"] == 0


def test_float32_root_on_torch_device(hubbard):
    """One float32 root: the port's device Davidson around K8 (plain
    version) against jax_device in float32."""
    drv, mpo = hubbard
    port = port_run(mpo, drv.get_random_mps(D, seed=7), "torch_device",
                    dtype=np.float32)
    e = solve(port)
    e_ref = solve(ref_run(mpo, drv.get_random_mps(D, seed=7), "jax_device",
                          dtype=np.float32))
    assert abs(e[0] - e_ref[0]) < 1e-5, (e, e_ref)
    assert port.host_redo_count == 0


@pytest.mark.parametrize("weights", [None, [2.0]], ids=["ortho", "penalty"])
@pytest.mark.parametrize("backend", ["torch", "torch_device"])
def test_projected_excited_state(hubbard, ground_state, backend, weights):
    drv, mpo = hubbard
    kw = dict(proj_weights=weights)
    e = solve(port_run(mpo, drv.get_random_mps(D, seed=9), backend,
                       proj_mpss=[interop.mps(ground_state)], **kw))
    e_ref = solve(ref_run(mpo, drv.get_random_mps(D, seed=9), "jax",
                          proj_mpss=[ground_state], **kw))
    assert abs(e[0] - e_ref[0]) < 1e-8, (e, e_ref)


def test_extract_root_and_results_match_the_reference_driver(hubbard):
    from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
    _, mpo = hubbard
    ref, port = RefDriver(), DMRGDriver()
    for d in (ref, port):
        d.initialize_system(n_sites=L6, n_elec=L6, spin=0)
    kw = dict(bond_dims=[D], noises=[1e-5, 0], thrds=[1e-14], n_sweeps=NS,
              tol=0, iprint=0, n_roots=2)
    e_ref = ref.dmrg(mpo, ref.get_random_mps(D, seed=3), backend="jax",
                     **kw)
    e = port.dmrg(interop.mpo(mpo), interop.mps(ref.get_random_mps(
        D, seed=3)), backend="torch", device="cpu", **kw)
    assert np.abs(e - e_ref).max() < 1e-8
    (es, dws), (es_ref, dws_ref) = port.get_dmrg_results(), \
        ref.get_dmrg_results()
    assert len(es) == len(es_ref) == NS
    assert np.abs(np.subtract(es, es_ref)).max() < 1e-8
    assert np.abs(np.subtract(dws, dws_ref)).max() < 1e-10
    for r in range(2):
        m, m_ref = port.extract_root(r), ref.extract_root(r)
        assert m.tensors is not port._last_dmrg.mps.tensors
        c = port._last_dmrg._center_pos
        assert m.tensors[c] is port._last_dmrg._center_tensors[r]
        # the same state up to the sign of each root
        assert abs(abs(overlap(interop.mps(m_ref), m)) - 1.0) < 1e-10
        for t, t_ref in zip(m.tensors, m_ref.tensors):
            assert sorted(t.blocks) == sorted(t_ref.blocks)
            for k, b in t.blocks.items():
                # a sector's kept dimension may differ by states of
                # singular value ~1e-16, which one machine's rounding
                # keeps and another's drops (the state above is the
                # same); blocks of equal shape agree element by element
                if b.shape == t_ref.blocks[k].shape:
                    assert np.abs(np.abs(b) - np.abs(t_ref.blocks[k])
                                  ).max() < 1e-6


def test_refusals(hubbard):
    """torch_resident keeps the reference's one-root contract; a projector
    count must match its weights."""
    drv, mpo = hubbard
    with pytest.raises(ValueError, match="n_roots > 1 or proj_mpss"):
        port_run(mpo, drv.get_random_mps(10, seed=1), "torch_resident",
                 n_roots=2)
    gs = interop.mps(drv.get_random_mps(10, seed=2))
    with pytest.raises(ValueError, match="n_roots > 1 or proj_mpss"):
        port_run(mpo, drv.get_random_mps(10, seed=1), "torch_resident",
                 proj_mpss=[gs])
    with pytest.raises(ValueError, match="one proj_weight per proj_mps"):
        port_run(mpo, drv.get_random_mps(10, seed=1), "torch",
                 proj_mpss=[gs], proj_weights=[1.0, 2.0])
    assert torch.get_num_threads() == 1
