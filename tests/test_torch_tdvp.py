"""Time evolution of the port (block2_preview_tpu_torch/dmrg/tdvp.py: two-
site TDVP, every Krylov matvec on the tiled engine, kernel K7 — its plain
version on CPU tensors) against the JAX package's TimeEvolution with the
numpy and the jax_tiled backends, from the same Hubbard-L6 state carried
by ``interop.mps``: real time (complex128) and imaginary time (f64), the
per-step energies to 1e-8 Ha (test_tiled_complex.py::
test_tdvp_device_backend_parity); the real-time phase of an eigenstate and
monotone imaginary-time relaxation (test_td_gf.py); and the driver's
defaults."""

import inspect

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
from block2_preview_tpu.dmrg.tdvp import TimeEvolution as RefTE

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.tdvp import TimeEvolution
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu_torch.ops import _kernels

from test_torch_plans import hubbard_driver
from test_torch_tiled import copy_mps

L6, D = 6, 80


@pytest.fixture(scope="module")
def gs6():
    """Hubbard-L6 ground state at D=80 (exact at this size), six sweeps
    ending on a backward sweep, so the center sits at site 0."""
    drv, mpo = hubbard_driver(L6)
    gs = drv.get_random_mps(D, seed=2)
    e0 = RefDMRG(mpo, gs, iprint=0).solve([D], [1e-4, 1e-5, 0], [1e-10],
                                          n_sweeps=6, tol=0)
    return drv, mpo, gs, e0


def overlap(bra, ket) -> complex:
    """<bra|ket> by a plain numpy contraction of the two MPSs."""
    g = ket.group
    env = {(g.zero, g.zero): np.ones((1, 1))}
    for A, B in zip(bra.tensors, ket.tensors):
        new = {}
        for (ql, qp, qr), a in A.blocks.items():
            for (ql2, qp2, qr2), b in B.blocks.items():
                if qp2 != qp or (ql, ql2) not in env:
                    continue
                m = np.einsum("ab,apc,bpd->cd", env[(ql, ql2)], a.conj(), b)
                new[(qr, qr2)] = new.get((qr, qr2), 0) + m
        env = new
    tgt = ket.info.target
    return complex(env[(tgt, tgt)][0, 0])


@pytest.mark.parametrize("imaginary,dt", [(False, 0.05), (True, 0.1)],
                         ids=["real", "imaginary"])
def test_tdvp_matches_reference(gs6, imaginary, dt):
    """Two steps from the same state: real time from the ground state,
    imaginary time from a random MPS."""
    drv, mpo, gs, _ = gs6
    start = gs if not imaginary else drv.get_random_mps(40, seed=5)
    refs = []
    for kw in ({}, {"backend": "jax_tiled", "device_min_size": 1}):
        te = RefTE(mpo, copy_mps(start), imaginary=imaginary, iprint=0,
                   **kw)
        te.solve(2, dt, D)
        refs.append(te)
    pmpo = interop.mpo(mpo)
    _kernels.reset_counts()
    port = TimeEvolution(pmpo, interop.mps(start), imaginary=imaginary,
                         device="cpu")
    port.solve(2, dt, D)
    host = TimeEvolution(pmpo, interop.mps(start), imaginary=imaginary,
                         backend="numpy")
    host.solve(2, dt, D)
    for ref in refs:
        assert np.allclose(port.energies, ref.energies, rtol=0, atol=1e-8), \
            (port.energies, ref.energies)
        assert np.allclose(port.norms, ref.norms, rtol=0, atol=1e-10)
    assert np.allclose(host.energies, refs[0].energies, rtol=0, atol=1e-10)
    assert port.host_matvec_count == 0 and port.n_matvec > 0
    # n_matvec counts the Krylov matvecs; the measurements at t = 0 and
    # after each step add one each
    assert host.host_matvec_count == host.n_matvec + 3
    assert host.initial == pytest.approx(port.initial, abs=1e-10)
    assert len(port.sweep_log) == 4
    assert sum(r["matvecs"] for r in port.sweep_log) == port.n_matvec
    assert port.discarded_weight >= 0.0
    # CPU tensors run K7's plain version, which launches nothing
    assert _kernels.launch_counts()["K7_tiled"] == 0
    dtype = np.complex128 if not imaginary else np.float64
    assert all(b.dtype == dtype for t in port.mps.tensors
               for b in t.blocks.values())


def test_complex_mps_through_interop(gs6):
    """interop.mps carries a complex MPS with its dtype and values."""
    drv, mpo, gs, _ = gs6
    ref = copy_mps(gs)
    RefTE(mpo, ref, imaginary=False, iprint=0).solve(1, 0.05, D)
    port = interop.mps(ref)
    n = 0
    for a, b in zip(ref.tensors, port.tensors):
        assert sorted(a.blocks) == sorted(b.blocks)
        for k, v in a.blocks.items():
            assert b.blocks[k].dtype == np.complex128
            assert np.array_equal(b.blocks[k], v)
            n += int(np.abs(v.imag).max() > 0)
    assert n > 0


def test_real_time_phase(gs6):
    """An exact eigenstate only turns its phase: |<psi0|psi(t)>| = 1 and
    <psi0|psi(t)> = exp(-i (E0 - E_const) t)."""
    drv, mpo, gs, e0 = gs6
    ket0 = interop.mps(gs)
    mps = interop.mps(gs)
    te = TimeEvolution(interop.mpo(mpo), mps, imaginary=False, device="cpu")
    dt, nst = 0.05, 3
    te.solve(nst, dt, D)
    ov = overlap(ket0, mps)
    phase = np.exp(-1j * (e0 - mpo.const_e) * nst * dt)
    assert abs(abs(ov) - 1.0) < 1e-8, ov
    assert abs(ov - phase) < 1e-7, (ov, phase)
    assert te.host_matvec_count == 0


def test_imaginary_time_relaxation(gs6):
    drv, mpo, gs, e0 = gs6
    te = TimeEvolution(interop.mpo(mpo),
                       interop.mps(drv.get_random_mps(40, seed=5)),
                       imaginary=True, device="cpu")
    te.solve(5, 0.5, 60)
    e_early = te.energies[-1]
    te.solve(5, 0.5, 60)
    e_late = te.energies[-1]
    assert all(b <= a + 1e-10 for a, b in zip(te.energies, te.energies[1:]))
    assert e_late <= e_early + 1e-10
    assert e_late - e0 < 0.02, (e_late, e0)
    assert all(abs(n - 1.0) < 1e-10 for n in te.norms)   # normalized


def test_td_dmrg_defaults_to_cuda(gs6):
    """td_dmrg and TimeEvolution pick "cuda" and the tiled engine unless
    asked otherwise; without a card that raises (no fallback)."""
    drv, mpo, gs, _ = gs6
    for fn in (DMRGDriver.td_dmrg, TimeEvolution.__init__):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["backend"].default == "torch_tiled"
    if torch.cuda.is_available():
        return
    port = DMRGDriver()
    port.initialize_system(n_sites=L6, n_elec=L6, spin=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.td_dmrg(interop.mpo(mpo), interop.mps(gs), 0.05, 1, D)
    e, te = port.td_dmrg(interop.mpo(mpo), interop.mps(gs), 0.05, 1, D,
                         device="cpu")
    assert te.backend == "torch_tiled" and te.device.type == "cpu"
    assert np.isfinite(e) and te.host_matvec_count == 0
