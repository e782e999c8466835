"""The port's DMRGDriver in the SU2 mode (block2_preview_tpu_torch/driver/
core.py: ``get_qc_mpo``, ``get_random_mps``, ``dmrg``, ``extract_root``)
against the JAX package's driver in its SU2 mode on in-code Hamiltonians
(Hubbard-L6 and seeded K=6 integrals): the host engine
(``backend="numpy"``) to 1e-10 Ha, the device path on the kernels' twins
(``device="cpu"``) to 1e-8 Ha, the SZ-only backends refused, the card as
the default, and what is still missing named (ROADMAP A6b)."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
from block2_preview_tpu.driver.core import SymmetryTypes as RefSym

from block2_preview_tpu_torch.core.fcidump import FCIDUMP
from block2_preview_tpu_torch.driver.core import (DMRGDriver, SU2MPO,
                                                  SU2MPSSpec, SymmetryTypes)
from block2_preview_tpu_torch.dmrg.su2_fermion import SU2FermionDMRG

from test_torch_su2_core import seeded_qc

HOST_TOL = 1e-10   # Ha, backend="numpy" against the JAX driver
DEV_TOL = 1e-8     # Ha, the device path (twins) against the JAX driver
SCHED = dict(bond_dims=[100], noises=[1e-4, 1e-5, 0], thrds=[1e-12],
             n_sweeps=8, tol=1e-11, iprint=0)


def systems():
    fd = FCIDUMP.hubbard(6, t=1.0, u=2.0)
    h1e, g2e = seeded_qc(6, seed=11)
    return {"hubbard6": (fd.h1e, fd.g2e, 0.0, 6, 0),
            "qc6_triplet": (h1e, g2e, 0.3, 6, 2)}


def drivers(name):
    h1e, g2e, ecore, ne, tj = systems()[name]
    out = []
    for cls, sym in ((DMRGDriver, SymmetryTypes), (RefDriver, RefSym)):
        d = cls(sym.SU2)
        d.initialize_system(6, ne, tj)
        out.append((d, d.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=ecore)))
    return out


@pytest.mark.parametrize("name", ["hubbard6", "qc6_triplet"])
def test_host_backend_matches_jax_driver(name):
    (d, mpo), (rd, rmpo) = drivers(name)
    assert isinstance(mpo, SU2MPO)
    assert mpo.entries == rmpo.entries and mpo.sym_rank == rmpo.sym_rank
    ket = d.get_random_mps(100, seed=5)
    assert isinstance(ket, SU2MPSSpec) and ket.target == rd.target
    e = d.dmrg(mpo, ket, backend="numpy", **SCHED)
    er = rd.dmrg(rmpo, rd.get_random_mps(100, seed=5), **SCHED)
    assert abs(e - er) <= HOST_TOL
    eng = d._last_dmrg
    assert isinstance(eng, SU2FermionDMRG) and ket.engine is eng
    assert np.abs(np.array(eng.energies)
                  - np.array(rd._last_dmrg.energies)).max() <= HOST_TOL
    assert eng.host_matvec_count == eng.n_matvec > 0


@pytest.mark.parametrize("name", ["hubbard6", "qc6_triplet"])
def test_device_path_matches_jax_driver(name):
    """The default backend (torch_tiled) on the twins: every blocking
    step through K5's path, every matvec through K7's, per sweep against
    the JAX driver's host engine."""
    (d, mpo), (rd, rmpo) = drivers(name)
    e = d.dmrg(mpo, d.get_random_mps(100, seed=5), device="cpu", **SCHED)
    er = rd.dmrg(rmpo, rd.get_random_mps(100, seed=5), **SCHED)
    assert abs(e - er) <= DEV_TOL
    eng = d._last_dmrg
    assert eng.backend == "torch_tiled" and eng.device.type == "cpu"
    n = min(len(eng.energies), len(rd._last_dmrg.energies))
    assert n >= 3
    assert np.abs(np.array(eng.energies[:n])
                  - np.array(rd._last_dmrg.energies[:n])).max() <= DEV_TOL
    assert eng.host_matvec_count == 0 and eng.n_blocking > 0


def test_two_roots_and_extract_root():
    """Two state-averaged roots on the device path (twins), then root 1
    as a warm-started spec refined against root 0 (the statespecific
    workflow through the driver), against the JAX driver's roots."""
    (d, mpo), (rd, rmpo) = drivers("hubbard6")
    kw = dict(SCHED, bond_dims=[120], n_sweeps=10, tol=1e-10,
              thrds=[1e-10])
    e = d.dmrg(mpo, d.get_random_mps(120), n_roots=2, device="cpu", **kw)
    er = rd.dmrg(rmpo, rd.get_random_mps(120), n_roots=2, **kw)
    assert np.abs(np.asarray(e) - np.asarray(er)).max() <= 1e-7
    r0, r1 = d.extract_root(0), d.extract_root(1)
    assert isinstance(r1, SU2MPSSpec) and r1.init_tensors is not None
    kw1 = dict(kw, noises=[1e-5, 0], n_sweeps=8, tol=1e-11)
    e0 = d.dmrg(mpo, r0, device="cpu", **kw1)
    e1 = d.dmrg(mpo, r1, device="cpu", proj_mpss=[r0], **kw1)
    assert abs(e0 - er[0]) <= 1e-8 and abs(e1 - er[1]) <= 1e-7


@pytest.mark.parametrize("backend", ["torch_resident", "torch",
                                     "torch_device", "torch_stacked"])
def test_sz_only_backends_raise_in_su2_mode(backend):
    (d, mpo), _ = drivers("hubbard6")
    with pytest.raises(ValueError, match="SZ states only"):
        d.dmrg(mpo, d.get_random_mps(20), backend=backend, device="cpu",
               **SCHED)


def test_card_is_the_default_and_refusals_name_a6b():
    (d, mpo), _ = drivers("hubbard6")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            d.dmrg(mpo, d.get_random_mps(20), **SCHED)
    with pytest.raises(NotImplementedError, match="one-site"):
        d.dmrg(mpo, d.get_random_mps(20), device="cpu",
               twodot_to_onedot=2, **SCHED)
    with pytest.raises(NotImplementedError, match="A6b"):
        d.dmrg(mpo, d.get_random_mps(20), device="cpu", mesh=object(),
               **SCHED)
    with pytest.raises(NotImplementedError, match="A6b"):
        d.get_npdm(d.get_random_mps(20))
    for what in ("expr_builder", "get_mpo", "get_site_mpo"):
        with pytest.raises(NotImplementedError, match="A6b"):
            fn = getattr(d, what)
            fn() if what == "expr_builder" else fn(None, 0)
    for mode in (SymmetryTypes.SGF, SymmetryTypes.SAny):
        with pytest.raises(NotImplementedError, match="A6b"):
            DMRGDriver(mode)
    sz = DMRGDriver(SymmetryTypes.SZ)
    sz.initialize_system(4, 4, 0)
    with pytest.raises(NotImplementedError, match="A6b"):
        sz.expr_builder().add_term("(C+D)0", [0, 1], 1.0)
