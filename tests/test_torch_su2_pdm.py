"""Density matrices of a spin-adapted state through SU2 -> SZ: the port's
``utils/transform.su2_to_sz_mps`` and the driver's ``trans_mps_to_sz`` /
``get_npdm`` on an ``SU2MPSSpec`` against the JAX package's, fed the same
engine tensors (a solved port engine behind a small shim): the SZ blocks
to 1e-14, the PDMs of orders 1-3 and a transition 1PDM to 1e-10 of the
JAX driver's; the expansion's norm and energy (under the SZ MPO) against
the spin-adapted energy and ED for a singlet, both projections of a
triplet and a singlet-embedded triplet; the forward sweep run first when
the engine last swept backward; and the refusals.  The su2_to_sz half of
tests/test_drt_mps.py (its CSF half is ROADMAP A6b.4)."""

import numpy as np
import pytest

from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
from block2_preview_tpu.driver.core import SU2MPSSpec as RefSpec
from block2_preview_tpu.driver.core import SymmetryTypes as RefSym
from block2_preview_tpu.utils.transform import su2_to_sz_mps as ref_to_sz
from block2_preview_tpu.utils.ed import sector_indices, term_table_to_sparse
from block2_preview_tpu.core.expr import qc_term_table as ref_qc_tt
from block2_preview_tpu.core.fcidump import FCIDUMP as RefFCIDUMP

from block2_preview_tpu_torch.core.fcidump import FCIDUMP
from block2_preview_tpu_torch.dmrg.expect import mps_overlap
from block2_preview_tpu_torch.dmrg.su2_fermion import SU2FermionDMRG
from block2_preview_tpu_torch.dmrg.su2_qc import (compile_su2_entries,
                                                  qc_su2_term_table)
from block2_preview_tpu_torch.driver.core import (DMRGDriver, SU2MPSSpec,
                                                  SymmetryTypes)
from block2_preview_tpu_torch.utils.transform import su2_to_sz_mps

import test_torch_plans  # noqa: F401  (pins torch to one thread)

BLOCK_TOL = 1e-14  # the SZ blocks against the JAX package's
PDM_TOL = 1e-10    # PDM elements against the JAX driver's
E_TOL = 1e-8       # Ha: the expansion's energy against the engine and ED
L = 4
SCHED = dict(bond_dims=[60], noises=[1e-4, 1e-5, 0], thrds=[1e-12],
             n_sweeps=8, tol=1e-12, iprint=0)


class Shim:
    """What su2_to_sz_mps reads of an engine, copied from a solved one."""

    def __init__(self, eng):
        self.L, self.T, self.LV = eng.L, eng.T, eng.LV
        self.site_pgs, self.mults = list(eng.site_pgs), eng.mults
        self.tensors = [dict(b) for b in eng.tensors]
        self._forward_next = eng._forward_next


def hubbard_ed(n_elec, twos):
    fd = RefFCIDUMP.hubbard(L, t=1.0, u=2.0)
    h = term_table_to_sparse(ref_qc_tt(fd))
    ix = sector_indices(L, n_elec, twos)
    return float(np.linalg.eigvalsh(h[np.ix_(ix, ix)].toarray())[0])


def solved(twos=0, device="cpu", forward_last=True):
    """A port SU2-mode driver and its solved Hubbard-L4 state (4 electrons,
    2S = twos) on the device path (twins); an even number of sweeps
    leaves the last one backward."""
    fd = FCIDUMP.hubbard(L, t=1.0, u=2.0)
    d = DMRGDriver(SymmetryTypes.SU2)
    d.initialize_system(n_sites=L, n_elec=4, spin=twos)
    mpo = d.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=0.0)
    ket = d.get_random_mps(60, seed=5)
    e = d.dmrg(mpo, ket, device=device,
               **dict(SCHED, n_sweeps=7 if forward_last else 8, tol=0.0))
    return d, ket, e


def sz_energy(sz):
    fd = FCIDUMP.hubbard(L, t=1.0, u=2.0)
    d = DMRGDriver(SymmetryTypes.SZ)
    d.initialize_system(n_sites=L, n_elec=sz.info.target[0],
                        spin=sz.info.target[1])
    mpo = d.get_qc_mpo(h1e=fd.h1e, g2e=fd.g2e, ecore=0.0)
    return d.expectation(sz, mpo, sz) / mps_overlap(sz, sz)


def hold_blocks(got, ref):
    assert got.info.target == tuple(ref.info.target)
    assert got.center == ref.center and got.n_sites == ref.n_sites
    for a, b in zip(got.tensors, ref.tensors):
        assert a.blocks.keys() == b.blocks.keys()
        for k in a.blocks:
            assert np.abs(a.blocks[k] - b.blocks[k]).max() <= BLOCK_TOL


@pytest.mark.parametrize("twos,tjz", [(0, None), (2, None), (2, -2)])
def test_su2_to_sz_blocks_equal_reference_and_ed(twos, tjz):
    """The same engine tensors through both packages' su2_to_sz_mps: equal
    SZ blocks; the expansion has norm 1 and the spin-adapted energy, ED's
    in the (N, 2Sz) sector, under the SZ Hubbard MPO."""
    _, ket, e = solved(twos)
    eng = ket.engine
    assert not eng._forward_next
    got = su2_to_sz_mps(eng, tjz=tjz)
    hold_blocks(got, ref_to_sz(Shim(eng), tjz=tjz))
    assert got.info.target == (4, twos if tjz is None else tjz, 0)
    assert abs(mps_overlap(got, got) - 1.0) <= 1e-12
    assert abs(sz_energy(got) - e) <= E_TOL
    assert abs(e - hubbard_ed(4, twos)) <= E_TOL


def test_singlet_embedded_triplet():
    """The singlet-embedding branch: a triplet as the singlet of a
    fictitious boundary multiplet (2, 2, 0) with target (6, 0, 0); the
    physical SZ component has norm^2 1/3 (the Clebsch-Gordan weight), the
    JAX package's blocks and, normalized, the direct triplet's energy."""
    fd = RefFCIDUMP.hubbard(L, t=1.0, u=2.0)
    ents, ns, dn, rk, reg = compile_su2_entries(
        qc_su2_term_table(fd.h1e, fd.g2e, 0.0))
    eng = SU2FermionDMRG(L, ents, ns, dn, target=(6, 0, 0), bond_dim=60,
                         ops=reg, ranks=rk, left_vacuum=(2, 2, 0),
                         device="cpu")
    e = eng.solve(n_sweeps=7, tol=0.0, noises=[1e-4, 1e-5, 0],
                  dav_thrds=[1e-12])
    for tjz in (2, 0):
        got = su2_to_sz_mps(eng, tjz=tjz)
        hold_blocks(got, ref_to_sz(Shim(eng), tjz=tjz))
        assert got.info.target == (4, tjz, 0)
        assert abs(mps_overlap(got, got) - 1.0 / 3.0) <= 1e-12
        assert abs(sz_energy(got) - e) <= E_TOL
    assert abs(e - hubbard_ed(4, 2)) <= E_TOL


def test_backward_last_sweep_runs_one_forward_sweep():
    """An engine whose last sweep ran backward sweeps forward once on its
    own backend (here K5's and K7's twins) before the expansion; the
    result then equals the JAX package's on the refreshed tensors."""
    _, ket, e = solved(0, forward_last=False)
    eng = ket.engine
    assert eng._forward_next
    n = len(eng.energies)
    blk = eng.n_blocking
    got = su2_to_sz_mps(eng)
    assert len(eng.energies) == n + 1 and not eng._forward_next
    assert eng.n_blocking > blk and eng.host_matvec_count == 0
    hold_blocks(got, ref_to_sz(Shim(eng)))
    assert abs(sz_energy(got) - e) <= E_TOL


def test_driver_pdms_equal_jax_driver():
    """get_1pdm, get_2pdm, get_3pdm (poly, every close on K17's twin) and
    get_trans_1pdm (the bra expanded too) of SU2MPSSpecs against the JAX
    driver's get_npdm on SU2MPSSpecs carrying the same tensors, to 1e-10;
    orders 1 and 2 route to the host string engine, as in the JAX
    driver."""
    d, ket, _ = solved(0)
    rd = RefDriver(RefSym.SU2)
    rd.initialize_system(L, 4, 0)

    def ref_spec(spec):
        r = RefSpec(spec.target, spec.bond_dim)
        r.engine = Shim(spec.engine)
        return r

    rket = ref_spec(ket)
    pairs = [(d.get_1pdm(ket), rd.get_npdm(rket, 1)),
             (d.get_2pdm(ket), rd.get_npdm(rket, 2)),
             (d.get_3pdm(ket, algo="poly", device="cpu", device_min_flop=0),
              rd.get_npdm(rket, 3, algo="poly")),
             (d.get_trans_1pdm(ket, ket), rd.get_npdm(rket, 1, bra=rket))]
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= PDM_TOL
    sz = d.trans_mps_to_sz(ket)
    assert np.abs(d.get_1pdm(sz) - pairs[0][0]).max() <= PDM_TOL


def test_refusals():
    """An unsolved SU2MPSSpec, a non-MPS, and an engine on custom
    multiplets (a t-J site has no SZ expansion here) raise."""
    d = DMRGDriver(SymmetryTypes.SU2)
    d.initialize_system(n_sites=L, n_elec=4, spin=0)
    with pytest.raises(ValueError, match="solved"):
        d.get_1pdm(d.get_random_mps(10))
    with pytest.raises(ValueError, match="solved"):
        d.trans_mps_to_sz(object())
    with pytest.raises(TypeError, match="SU2MPSSpec"):
        d.get_npdm(object(), 2)
    with pytest.raises(NotImplementedError, match="A6b.4"):
        d.get_csf_coefficients(d.get_random_mps(10))
    spec = SU2MPSSpec((3, 1, 0), 10)
    spec.engine = Shim(solved(0)[1].engine)
    spec.engine.mults = [[(0, 0, 0), (1, 1, 0)]] * L
    with pytest.raises(ValueError, match="multiplets"):
        d.get_1pdm(spec)
