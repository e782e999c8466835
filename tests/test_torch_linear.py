"""Linear sweeps and the linear solvers of the port against the JAX
package's: ``identity_mpo``, the driver's ``compress_mps``, ``multiply``
and ``addition`` (block2_preview_tpu_torch/dmrg/linear.py, host sweeps)
on an in-code Hubbard-L6 ground state, with tests/test_linear.py's bars
and to 1e-10 of the JAX driver's; ``gmres_solve``, ``cg_solve``
(ops/krylov.py) and every solver of ops/solvers.py on seeded matrices
(non-Hermitian complex; Hermitian positive-definite for CG, deflated CG
and Chebyshev; real symmetric indefinite for MinRes) to 1e-10 of the JAX
functions; and ``harmonic_davidson`` (ops/davidson.py)."""

import numpy as np
import pytest

from block2_preview_tpu.dmrg.expect import mps_overlap as ref_overlap
from block2_preview_tpu.dmrg.linear import identity_mpo as ref_identity
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
from block2_preview_tpu.ops import davidson as ref_davidson
from block2_preview_tpu.ops import krylov as ref_krylov
from block2_preview_tpu.ops import solvers as ref_solvers

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.expect import (mpo_expectation,
                                                  mps_overlap)
from block2_preview_tpu_torch.dmrg.linear import identity_mpo
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu_torch.ops import davidson, krylov, solvers

from test_torch_plans import hubbard_driver

L6, D = 6, 80
TOL = 1e-10
N = 60


@pytest.fixture(scope="module")
def lin6():
    """Hubbard-L6 ground state at D=80 (exact) by the JAX package, the
    port's driver, and the port's copies of the MPO and state."""
    drv, mpo = hubbard_driver(L6)
    gs = drv.get_random_mps(D, seed=2)
    e = RefDMRG(mpo, gs, iprint=0).solve([D], [1e-4, 1e-5, 0], [1e-12],
                                         n_sweeps=6, tol=0)
    port = DMRGDriver()
    port.initialize_system(n_sites=L6, n_elec=L6, spin=0)
    return drv, mpo, gs, e, port, interop.mpo(mpo), interop.mps(gs)


def test_identity_mpo_matches_reference(lin6):
    _, mpo, _, _, _, pmpo, _ = lin6
    ref, got = ref_identity(mpo), identity_mpo(pmpo)
    assert got.n_sites == ref.n_sites and got.const_e == ref.const_e == 0
    assert [list(b) for b in got.bond_dqs] == \
        [[tuple(q) for q in b] for b in ref.bond_dqs]
    for a, b in zip(got.tensors, ref.tensors):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_compression(lin6):
    """|x> ~ |gs> at D=40 (test_linear.py's bars; the same fit as the JAX
    driver's to 1e-10)."""
    drv, mpo, gs, e, port, pmpo, pgs = lin6
    rbra, rnrm = drv.compress_mps(gs, 40, mpo, n_sweeps=6)
    bra, nrm = port.compress_mps(pgs, 40, pmpo, n_sweeps=6)
    assert abs(nrm - rnrm) <= TOL
    ov = mps_overlap(bra, pgs)
    assert abs(ov - ref_overlap(rbra, gs)) <= TOL
    assert abs(nrm - 1.0) < 1e-6 and ov > 0.99999
    e_x = mpo_expectation(pmpo, bra) / mps_overlap(bra, bra)
    assert abs(e_x - e) < 1e-5


def test_multiply_h_psi(lin6):
    """|x> ~ H|gs>: <x|gs> = <gs|H|gs> = E - const_e (the MPO carries the
    constant separately)."""
    drv, mpo, gs, e, port, pmpo, pgs = lin6
    rbra, rnrm = drv.multiply(mpo, gs, D, n_sweeps=6)
    bra, nrm = port.multiply(pmpo, pgs, D, n_sweeps=6)
    assert abs(nrm - rnrm) <= TOL * max(1.0, abs(rnrm))
    ov = mps_overlap(bra, pgs)
    assert abs(ov - ref_overlap(rbra, gs)) <= TOL
    assert abs(ov - (e - pmpo.const_e)) < 1e-6


def test_addition(lin6):
    """|x> ~ |gs> + |r> for a random normalized |r>."""
    drv, mpo, gs, e, port, pmpo, pgs = lin6
    r = drv.get_random_mps(30, seed=99)
    rx, _ = drv.addition(gs, r, mpo, D, n_sweeps=6)
    pr = interop.mps(r)
    x, _ = port.addition(pgs, pr, pmpo, D, n_sweeps=6)
    xx = mps_overlap(x, x)
    assert abs(xx - ref_overlap(rx, rx)) <= TOL
    expect = (mps_overlap(pgs, pgs) + mps_overlap(pr, pr)
              + 2 * mps_overlap(pgs, pr))
    assert abs(xx - expect) < 1e-8


# ---------------------------------------------------------------------------
# the solvers, on seeded matrices
# ---------------------------------------------------------------------------

def _mats():
    rng = np.random.RandomState(17)
    a = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    gen = a / np.sqrt(N) + 3.0 * np.eye(N)          # non-Hermitian complex
    q = np.linalg.qr(rng.standard_normal((N, N)))[0]
    w = np.linspace(0.5, 4.0, N)
    hpd = (q * w) @ q.T                             # real SPD, spectrum w
    sym = (q * np.linspace(-2.0, 3.0, N)) @ q.T     # real symmetric indef.
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    return gen, hpd, sym, b, rng


def _same(got, ref):
    assert got[1] == ref[1]                         # matvec counts
    assert np.abs(got[0] - ref[0]).max() <= TOL * np.abs(ref[0]).max()


def test_gmres_and_cg_match_reference():
    gen, hpd, _, b, _ = _mats()
    x0 = 0.1 * b
    _same(krylov.gmres_solve(lambda v: gen @ v, b, x0=x0),
          ref_krylov.gmres_solve(lambda v: gen @ v, b, x0=x0))
    got = krylov.gmres_solve(lambda v: gen @ v, b)
    assert np.abs(gen @ got[0] - b).max() < 1e-8
    br = b.real.copy()
    for diag in (None, np.diag(hpd).copy()):
        got = krylov.cg_solve(lambda v: hpd @ v, br, diag=diag)
        _same(got, ref_krylov.cg_solve(lambda v: hpd @ v, br, diag=diag))
        assert np.abs(hpd @ got[0] - br).max() < 1e-8


@pytest.mark.parametrize("name", ["minres", "gcrotmk", "lsqr", "idrs",
                                  "cheby_solve", "deflated_cg"])
def test_solvers_match_reference(name):
    """Each solver of ops/solvers.py against the JAX one on the same
    operator and right-hand side; the solution also solves the system."""
    gen, hpd, sym, b, rng = _mats()
    br = b.real.copy()
    ws = np.linalg.eigh(hpd)[1][:, :3]
    args = {"minres": (lambda v: sym @ v, br),
            "gcrotmk": (lambda v: gen @ v, b),
            "lsqr": (lambda v: gen @ v, lambda v: gen.conj().T @ v, b),
            "idrs": (lambda v: gen @ v, b),
            "cheby_solve": (lambda v: hpd @ v, br, 0.5, 4.0),
            "deflated_cg": (lambda v: hpd @ v, br, ws)}[name]
    mat = {"minres": sym, "cheby_solve": hpd, "deflated_cg": hpd}.get(
        name, gen)
    got = getattr(solvers, name)(*args)
    _same(got, getattr(ref_solvers, name)(*args))
    rhs = args[-1] if name in ("minres", "gcrotmk", "lsqr", "idrs") \
        else br
    assert np.abs(mat @ got[0] - rhs).max() < 1e-7 * np.abs(rhs).max()


def test_harmonic_davidson_matches_reference():
    """Two interior eigenpairs of a real symmetric matrix closest to a
    shift, against the JAX function and numpy's eigh."""
    _, _, sym, _, rng = _mats()
    x0 = rng.standard_normal((N, 2))
    shift = 0.3
    got = davidson.harmonic_davidson(lambda v: sym @ v, np.diag(sym).copy(),
                                     x0, shift, n_roots=2, conv_thrd=1e-12,
                                     max_subspace=N)
    ref = ref_davidson.harmonic_davidson(lambda v: sym @ v,
                                         np.diag(sym).copy(), x0, shift,
                                         n_roots=2, conv_thrd=1e-12,
                                         max_subspace=N)
    assert got[2] == ref[2]
    assert np.abs(got[0] - ref[0]).max() <= TOL
    assert np.abs(np.abs(got[1]) - np.abs(ref[1])).max() <= 1e-8
    w = np.linalg.eigvalsh(sym)
    near = w[np.argsort(np.abs(w - shift))[:2]]
    assert np.abs(np.sort(got[0]) - np.sort(near)).max() < 1e-8
