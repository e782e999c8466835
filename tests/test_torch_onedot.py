"""One-site sweeps and orbital rotation of the port against the JAX
package's, on in-code Hubbard chains: ``EffectiveHamiltonian1R`` (the
right-fused one-site operator) field by field, its ``matvec_np`` and
``diagonal``; K7's and K8's plain versions (``TiledExecutor`` and
``BucketExecutor`` on CPU tensors, and K7's chunk walk) on
EffectiveHamiltonian1 and 1R items against ``matvec_np``; DMRG with
``twodot_to_onedot=4`` on ``torch_tiled`` and the bucketed backends
against the JAX ``jax_tiled`` and ``numpy`` energies to 1e-8 Ha and exact
diagonalization to 1e-5 Ha (test_tiled.py:102-116's bar); one
``last_site_1site`` solve; ``torch_resident``'s refusal; and
``orbital_rotation`` against the JAX driver's to 1e-8 (the pattern of
test_td_gf.py:142, whose deck is not in the repository)."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian1 as RefE1
from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian1R as RefE1R
from block2_preview_tpu.dmrg.environment import MovingEnvironment as RefME
from block2_preview_tpu.dmrg.expect import mpo_expectation as ref_expect
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.core.expr import qc_term_table
from block2_preview_tpu_torch.core.fcidump import FCIDUMP
from block2_preview_tpu_torch.dmrg.effective import (EffectiveHamiltonian1,
                                                     EffectiveHamiltonian1R)
from block2_preview_tpu_torch.dmrg.environment import MovingEnvironment
from block2_preview_tpu_torch.dmrg.expect import mpo_expectation
from block2_preview_tpu_torch.dmrg.sweep import DMRG
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu_torch.ops import chain_mv, exec_bucket
from block2_preview_tpu_torch.ops.exec_bucket import BucketExecutor
from block2_preview_tpu_torch.ops.tiled import TiledExecutor
from block2_preview_tpu_torch.utils.ed import ground_state_energy

from test_torch_plans import hubbard_driver
from test_torch_tiled import copy_mps

L6, D = 6, 50
E_TOL = 1e-8
ED_TOL = 1e-5
SCHED = dict(bond_dims=[D], noises=[1e-5] * 4 + [0], dav_thrds=[1e-12],
             n_sweeps=6, tol=0, twodot_to_onedot=4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def chain6():
    """Hubbard-L6 MPO and an MPS after two host sweeps at D=50."""
    drv, mpo = hubbard_driver(L6)
    mps = drv.get_random_mps(D, seed=3)
    RefDMRG(mpo, mps, iprint=0).solve([D], [1e-4], [1e-8], n_sweeps=2,
                                      tol=0)
    return drv, mpo, mps


def one_site_pair(mpo, mps, s, right):
    """The JAX and the port's one-site operator at site s (right-fused
    when ``right``) on host environments of the same state."""
    effs = []
    for me_cls, mpo_, mps_, e_cls in (
            (RefME, mpo, mps, RefE1R if right else RefE1),
            (MovingEnvironment, interop.mpo(mpo), interop.mps(mps),
             EffectiveHamiltonian1R if right else EffectiveHamiltonian1)):
        me = me_cls(mpo_, mps_)
        me.init_environments()
        for t in range(s):
            me.update_left(t)
        effs.append(e_cls(me, s))
    return effs


SITES = [(1, False), (3, True), (5, True), (0, True)]


@pytest.mark.parametrize("s,right", SITES,
                         ids=[f"s{s}{'R' if r else ''}" for s, r in SITES])
def test_one_site_operator_matches_reference(chain6, s, right):
    """Keys, shapes, offsets, triples, LW/RW, matvec_np, diagonal and the
    tensor <-> vector maps against the JAX package's."""
    _, mpo, mps = chain6
    ref, got = one_site_pair(mpo, mps, s, right)
    assert got.keys == ref.keys
    assert got.size == ref.size and got.shapes == ref.shapes
    assert got.offsets == ref.offsets and got.triples == ref.triples
    for mine, theirs in ((got.LW, ref.LW), (got.RW, ref.RW)):
        assert mine.keys() == theirs.keys()
        for m in mine:
            assert mine[m].keys() == theirs[m].keys()
            assert all(np.array_equal(mine[m][k], theirs[m][k])
                       for k in mine[m])
    x = np.random.RandomState(5).standard_normal(got.size)
    np.testing.assert_allclose(got.matvec_np(x), ref.matvec_np(x),
                               rtol=0, atol=1e-13)
    np.testing.assert_array_equal(got.diagonal(), ref.diagonal())
    v = got.tensor_to_vec(interop.mps(mps).tensors[s])
    np.testing.assert_array_equal(v, ref.tensor_to_vec(mps.tensors[s]))
    back = got.vec_to_tensor(v)
    np.testing.assert_array_equal(got.tensor_to_vec(back), v)


@pytest.mark.parametrize("s,right", SITES[:3],
                         ids=[f"s{s}{'R' if r else ''}" for s, r in SITES[:3]])
@pytest.mark.parametrize("kind", ["K7", "K8"])
def test_k7_k8_plain_on_one_site_items(chain6, s, right, kind):
    """K7's and K8's plain versions on the one-site operator's items and
    pools against its host matvec (f64 at 1e-12 of the largest entry);
    K7's chunk tables walked as the kernel walks them give the same."""
    _, mpo, mps = chain6
    _, eff = one_site_pair(mpo, mps, s, right)
    cls = TiledExecutor if kind == "K7" else BucketExecutor
    ex = cls(eff, dtype=np.float64, device=CPU)
    x = np.random.RandomState(9).standard_normal(eff.size)
    ref = eff.matvec_np(x)
    tol = 1e-12 * np.abs(ref).max()
    assert np.abs(ex.matvec(x) - ref).max() <= tol
    d = exec_bucket.kernel_tables(ex.struct, CPU)
    xp = torch.as_tensor(ex.pad(x))
    walk = chain_mv.chain_plain(xp, ex.lpool, ex.rpool, d, ex.size_p + 1)
    assert np.abs(walk[:eff.size].numpy() - ref).max() <= tol
    assert not walk[eff.size:].any()
    if kind == "K7":
        xc = x + 1j * np.random.RandomState(10).standard_normal(eff.size)
        exc = TiledExecutor(eff, dtype=np.complex128, device=CPU)
        refc = eff.matvec_np(xc)
        assert np.abs(exc.matvec(xc) - refc).max() <= \
            1e-12 * np.abs(refc).max()


@pytest.fixture(scope="module")
def onedot_refs(chain6):
    """The JAX package's energies of SCHED (four two-site sweeps, then
    one-site ones) on numpy and jax_tiled, and the ED ground energy."""
    drv, mpo, _ = chain6
    out = {}
    for be in ("numpy", "jax_tiled"):
        out[be] = RefDMRG(mpo, drv.get_random_mps(D, seed=7), backend=be,
                          iprint=0).solve(**SCHED)
    fd = FCIDUMP.hubbard(L6, u=2, t=1)
    out["ed"] = float(ground_state_energy(qc_term_table(fd), L6, 0,
                                          fd.const_e)[0])
    return out


@pytest.mark.parametrize("backend", ["torch_tiled", "torch", "torch_device",
                                     "torch_stacked", "numpy"])
def test_twodot_to_onedot_matches_reference(chain6, onedot_refs, backend):
    """Sweeps 4 and 5 one-site, on K7's (torch_tiled) or K8's (torch,
    torch_device, torch_stacked) plain version or the host: the energy to
    1e-8 Ha of the JAX package's numpy and jax_tiled runs, and to 1e-5 Ha
    of ED."""
    drv, mpo, _ = chain6
    dev = {} if backend == "numpy" else {"device": "cpu"}
    solver = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(
        D, seed=7)), backend=backend, iprint=0, **dev)
    e = solver.solve(**SCHED)
    for be in ("numpy", "jax_tiled"):
        assert abs(e - onedot_refs[be]) < E_TOL, (backend, be, e,
                                                   onedot_refs[be])
    assert abs(e - onedot_refs["ed"]) < ED_TOL
    assert len(solver.energies) == SCHED["n_sweeps"]
    assert solver.host_redo_count == 0


def test_one_site_sweeps_are_one_site(chain6, monkeypatch):
    """twodot_to_onedot=4 runs two-site steps in sweeps 0-3 and one-site
    steps on every site in sweeps 4 and 5, EffectiveHamiltonian1 forward
    and 1R backward, each through the tiled executor (K7)."""
    drv, mpo, _ = chain6
    kinds = []
    real = TiledExecutor.__init__

    def spy(self, eff, *a, **kw):
        kinds.append((type(eff).__name__, kw.get("cache_key")))
        real(self, eff, *a, **kw)

    monkeypatch.setattr(TiledExecutor, "__init__", spy)
    solver = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(
        D, seed=7)), backend="torch_tiled", device="cpu", iprint=0)
    solver.solve(**SCHED)
    two = [k for k in kinds if k[0] == "EffectiveHamiltonian2"]
    one = [k for k in kinds if k[0] != "EffectiveHamiltonian2"]
    assert len(two) == 4 * (L6 - 1) and len(one) == 2 * L6
    assert {k[0] for k in one[:L6]} == {"EffectiveHamiltonian1"}
    assert {k[0] for k in one[L6:]} == {"EffectiveHamiltonian1R"}
    assert all(key == (name, key[1]) for name, key in one)


@pytest.mark.parametrize("backend", ["torch_tiled", "numpy"])
def test_last_site_1site_matches_reference(chain6, backend):
    """last_site_1site=True: the last site of every two-site sweep gets a
    one-site update (the JAX package's numpy run, to 1e-8 Ha)."""
    drv, mpo, _ = chain6
    sched = dict(bond_dims=[D], noises=[1e-5] * 3 + [0], dav_thrds=[1e-12],
                 n_sweeps=4, tol=0)
    ref = RefDMRG(mpo, drv.get_random_mps(D, seed=7), iprint=0,
                  last_site_1site=True).solve(**sched)
    dev = {} if backend == "numpy" else {"device": "cpu"}
    e = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(D, seed=7)),
             backend=backend, iprint=0, last_site_1site=True,
             **dev).solve(**sched)
    assert abs(e - ref) < E_TOL, (e, ref)


def test_one_site_refusals(chain6):
    """torch_resident has no one-site engine: twodot_to_onedot and
    last_site_1site raise and name torch_tiled; one-site steps take one
    root."""
    drv, mpo, _ = chain6
    pm, ps = interop.mpo(mpo), interop.mps(drv.get_random_mps(D, seed=7))
    with pytest.raises(NotImplementedError, match="torch_tiled"):
        DMRG(pm, ps, backend="torch_resident", device="cpu", iprint=0,
             last_site_1site=True)
    solver = DMRG(pm, ps, backend="torch_resident", device="cpu", iprint=0)
    with pytest.raises(NotImplementedError, match="torch_tiled"):
        solver.solve(**SCHED)
    assert solver.energies == []
    solver = DMRG(pm, ps, backend="torch", device="cpu", iprint=0,
                  n_roots=2)
    with pytest.raises(NotImplementedError, match="one root"):
        solver.solve(**SCHED)


def test_expr_builder_and_site_mpo_match_reference():
    """ExprBuilder's SZ term table (complex sums of "cd"/"CD", a two-body
    string, a constant) and get_site_mpo against the JAX driver's; an
    SAny-SU(2) expression raises and names A6."""
    drv, _ = hubbard_driver(L6)
    port = DMRGDriver()
    port.initialize_system(n_sites=L6, n_elec=L6, spin=0)
    k = np.random.RandomState(3).standard_normal((L6, L6))
    tables = []
    for d in (drv, port):
        b = d.expr_builder()
        b.add_sum_term("cd", 1j * (k - k.T)).add_sum_term("CD", k)
        b.add_term("cdCD", [0, 1, 2, 3], 0.5).add_term("", [], 1.25)
        tables.append((b.finalize(), b.const_e))
    (ref, rc), (got, gc) = tables
    assert gc == rc == 1.25
    np.testing.assert_array_equal(got.opids, ref.opids)
    np.testing.assert_array_equal(got.coeffs, ref.coeffs)
    for op in ("c", "d", "C", "D"):
        ref_m, got_m = drv.get_site_mpo(op, 2), port.get_site_mpo(op, 2)
        assert [list(b) for b in got_m.bond_dqs] == \
            [[tuple(q) for q in b] for b in ref_m.bond_dqs]
        for a, b in zip(got_m.tensors, ref_m.tensors):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[key], b[key]) for key in a)
    with pytest.raises(NotImplementedError, match="A6"):
        port.expr_builder().add_term("((C+D)2+(C+D)2)0", [0, 1], 1.0)


@pytest.mark.parametrize("backend", ["torch_tiled", "numpy"])
def test_orbital_rotation_matches_reference(backend):
    """exp(kappa) applied to the Hubbard-L6 ground state by unit-time TDVP
    under i*G (a complex MPO; K7 in complex128 on the plain version): the
    rotated state's energies under the rotated and the unrotated
    Hamiltonians against the JAX driver's to 1e-8 Ha; under the rotated
    integrals it keeps E0 to 3e-4 Ha, under the old ones it does not."""
    drv, mpo = hubbard_driver(L6)
    gs = drv.get_random_mps(80, seed=2)
    e0 = RefDMRG(mpo, gs, iprint=0).solve([80], [1e-4, 1e-5, 0], [1e-12],
                                          n_sweeps=6, tol=0)
    fd = FCIDUMP.hubbard(L6, u=2, t=1)
    k = np.random.RandomState(5).standard_normal((L6, L6)) * 0.12
    kappa = k - k.T
    U = sla.expm(kappa)
    h2 = U @ fd.h1e @ U.T
    g2 = np.einsum("pi,qj,rk,sl,pqrs->ijkl", U.T, U.T, U.T, U.T, fd.g2e,
                   optimize=True)
    ref = copy_mps(gs)
    drv.orbital_rotation(ref, kappa, bond_dim=80, n_steps=6)
    rot_mpo = drv.get_qc_mpo(h1e=h2, g2e=g2, ecore=fd.const_e)
    port = DMRGDriver()
    port.initialize_system(n_sites=L6, n_elec=L6, spin=0)
    ket = interop.mps(gs)
    dev = {} if backend == "numpy" else {"device": "cpu"}
    assert port.orbital_rotation(ket, kappa, bond_dim=80, n_steps=6,
                                 backend=backend, **dev) is ket
    te = port._last_te
    assert te.n_matvec > 0
    assert te.host_matvec_count == (te.n_matvec if backend == "numpy"
                                    else 0)
    assert any(np.iscomplexobj(w) for ent in te.mpo.tensors
               for w in ent.values())
    for m_ref, m_port in ((rot_mpo, port.get_qc_mpo(h1e=h2, g2e=g2,
                                                    ecore=fd.const_e)),
                          (mpo, interop.mpo(mpo))):
        e_ref = np.real(ref_expect(m_ref, ref)) + fd.const_e
        e = np.real(mpo_expectation(m_port, ket)) + fd.const_e
        assert abs(e - e_ref) < E_TOL, (e, e_ref)
        if m_ref is rot_mpo:
            assert abs(e - e0) < 3e-4
        else:
            assert abs(e - e0) > 1e-3
    with pytest.raises(ValueError, match="antisymmetric"):
        port.orbital_rotation(ket, k, bond_dim=80, device="cpu")
