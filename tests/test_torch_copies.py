"""The port's own copies of the JAX package's host modules equal the
reference: the MPO from the same integrals, the MPS from the same seed,
the environment maps after ``init_environments``, and the host
(backend="numpy") DMRG energy; and the ``interop`` converters rebuild
reference objects as the port's classes without changing a number."""

import numpy as np
import pytest

import chip_smoke
from block2_preview_tpu.core.fcidump import FCIDUMP as RefFCIDUMP
from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
from block2_preview_tpu.dmrg.environment import MovingEnvironment as RefME
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.core.fcidump import FCIDUMP
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu_torch.dmrg.environment import MovingEnvironment

import test_torch_plans  # noqa: F401  (one torch thread per worker)


def _drivers(kind, L):
    """(reference driver, port driver, reference MPO, port MPO)."""
    if kind == "hubbard":
        ref_fd, fd = RefFCIDUMP.hubbard(L, u=2, t=1), FCIDUMP.hubbard(L, u=2,
                                                                      t=1)
        assert np.array_equal(fd.h1e, ref_fd.h1e)
        assert np.array_equal(fd.g2e, ref_fd.g2e)
        h1e, g2e, ecore = fd.h1e, fd.g2e, fd.const_e
    else:
        h1e, g2e = chip_smoke.seeded_qc_integrals(L)
        ecore = 0.3
    out = []
    for cls in (RefDriver, DMRGDriver):
        drv = cls()
        drv.initialize_system(n_sites=L, n_elec=L, spin=0)
        out.append(drv)
    return (*out, out[0].get_qc_mpo(h1e=h1e, g2e=g2e, ecore=ecore),
            out[1].get_qc_mpo(h1e=h1e, g2e=g2e, ecore=ecore))


def _same_mpo(a, b):
    assert a.n_sites == b.n_sites and a.const_e == b.const_e
    assert tuple(a.group.kinds) == tuple(b.group.kinds)
    assert a.site_quanta == b.site_quanta
    assert a.bond_dqs == b.bond_dqs
    for ta, tb in zip(a.tensors, b.tensors):
        assert set(ta) == set(tb)
        for k in ta:
            assert np.array_equal(ta[k], tb[k]), k


def _same_mps(a, b):
    assert a.center == b.center
    for ba, bb in zip(a.info.bonds, b.info.bonds):
        assert dict(ba.items()) == dict(bb.items())
    for ta, tb in zip(a.tensors, b.tensors):
        assert set(ta.blocks) == set(tb.blocks)
        for k in ta.blocks:
            assert np.array_equal(ta.blocks[k], tb.blocks[k]), k


@pytest.mark.parametrize("kind,L", [("hubbard", 8), ("qc", 6)])
def test_mpo_and_mps_copies_equal_reference(kind, L):
    ref, port, rmpo, pmpo = _drivers(kind, L)
    _same_mpo(pmpo, rmpo)
    _same_mpo(interop.mpo(rmpo), rmpo)
    rmps, pmps = ref.get_random_mps(30, seed=5), port.get_random_mps(30,
                                                                     seed=5)
    _same_mps(pmps, rmps)
    _same_mps(interop.mps(rmps), rmps)


@pytest.mark.parametrize("kind,L", [("hubbard", 8), ("qc", 6)])
def test_environments_after_init_equal_reference(kind, L):
    """Host blocking (plans + native executor) of the copied
    MovingEnvironment gives the reference's right environments."""
    ref, port, rmpo, pmpo = _drivers(kind, L)
    rme = RefME(rmpo, ref.get_random_mps(30, seed=2))
    pme = MovingEnvironment(pmpo, port.get_random_mps(30, seed=2))
    rme.init_environments()
    pme.init_environments()
    n = 0
    for b in range(1, L + 1):
        re, pe = rme.right_envs[b], pme.right_envs[b]
        assert set(re) == set(pe), b
        for s, bm in re.items():
            assert pe[s].dq == bm.dq
            assert set(pe[s].blocks) == set(bm.blocks)
            for k, blk in bm.blocks.items():
                assert np.allclose(pe[s].blocks[k], blk, rtol=0,
                                   atol=1e-13), (b, s, k)
                n += 1
    assert n > 0


def test_numpy_energy_matches_jax_package():
    """backend="numpy" of the port against the JAX package's numpy
    backend: Hubbard-L8, D=40, noisy sweeps, to 1e-10 Ha."""
    ref, port, rmpo, pmpo = _drivers("hubbard", 8)
    kw = dict(n_sweeps=4, tol=0)
    sched = ([40], [1e-5, 1e-5, 0], [1e-10])
    e_ref = RefDMRG(rmpo, ref.get_random_mps(40, seed=9), iprint=0).solve(
        *sched, **kw)
    e = port.dmrg(pmpo, port.get_random_mps(40, seed=9), backend="numpy",
                  bond_dims=sched[0], noises=sched[1], thrds=sched[2],
                  iprint=0, **kw)
    assert abs(e - e_ref) < 1e-10, (e, e_ref)
    assert port._last_dmrg.device is None
