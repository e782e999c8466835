"""The port's abelian SAny mode (block2_preview_tpu_torch/driver/core.py:
``set_symmetry_groups`` with U1 / U1Fermi / Z<n> factors and
``get_custom_hamiltonian`` with numbered operator letters) against the JAX
package's on the same in-code inputs, on the SZ engines: the
``torch_resident`` default (K1-K6's plain versions with ``device="cpu"``)
and ``torch_tiled`` with quanta of one and two slots and a bosonic Z3
with an identity parity, the host backend, the JAX package's DMRG and ED.
Mirrors tests/test_sany_custom.py."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
from block2_preview_tpu.driver.core import SymmetryTypes as RefSym

from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes

import test_torch_plans  # noqa: F401  (pins torch to one thread)

E_TOL = 1e-8       # Ha: against the host backend, the JAX package and ED
SCHED = dict(bond_dims=[60], noises=[1e-4, 1e-5, 0], thrds=[1e-10],
             n_sweeps=8, tol=1e-11, iprint=0)


def hubbard(cls, sym, L=6, t=1.0, u=2.0):
    """Hubbard-L as a custom (U1Fermi charge, U1 2Sz) basis."""
    d = cls(sym.SZ)
    d.set_symmetry_groups("U1Fermi", "U1")
    c = np.zeros((4, 4))
    c[1, 0] = c[3, 2] = 1.0
    cb = np.zeros((4, 4))
    cb[2, 0], cb[3, 1] = 1.0, -1.0
    d.get_custom_hamiltonian(
        [[((0, 0), 1), ((1, 1), 1), ((1, -1), 1), ((2, 0), 1)]] * L,
        [{"c": c, "d": c.T.copy(), "C": cb, "D": cb.T.copy()}] * L)
    b = d.expr_builder()
    for i in range(L - 1):
        for x, y in ((i, i + 1), (i + 1, i)):
            b.add_term("cd", [x, y], -t)
            b.add_term("CD", [x, y], -t)
    for i in range(L):
        b.add_term("cdCD", [i, i, i, i], u)
    return d, d.get_mpo(b.finalize()), (L, 0)


def spinless(cls, sym, L=8, t=1.0, v=1.5):
    """The spinless t-V chain on a single U1Fermi factor."""
    d = cls(sym.SZ)
    d.set_symmetry_groups("U1Fermi")
    c = np.zeros((2, 2))
    c[1, 0] = 1.0
    d.get_custom_hamiltonian([[((0,), 1), ((1,), 1)]] * L,
                             [{"c": c, "d": c.T.copy()}] * L)
    b = d.expr_builder()
    for i in range(L - 1):
        b.add_term("cd", [i, i + 1], -t)
        b.add_term("cd", [i + 1, i], -t)
        b.add_term("cdcd", [i, i, i + 1, i + 1], v)
    return d, d.get_mpo(b.finalize()), (L // 2,)


def clock(cls, sym, L=6, f=0.7, j=1.0):
    """The 3-state clock chain on a bosonic Z3 factor."""
    d = cls(sym.SZ)
    d.set_symmetry_groups("Z3")
    sig = np.zeros((3, 3))
    for k in range(3):
        sig[(k + 1) % 3, k] = 1.0
    d.get_custom_hamiltonian([[((k,), 1) for k in range(3)]] * L,
                             [{"s": sig, "t": sig.T.copy(),
                               "z": np.diag([2.0, -1.0, -1.0])}] * L)
    b = d.expr_builder()
    for i in range(L):
        b.add_term("z", [i], -f)
    for i in range(L - 1):
        b.add_term("st", [i, i + 1], -j)
        b.add_term("ts", [i, i + 1], -j)
    return d, d.get_mpo(b.finalize()), (0,)


def ed_spinless(L=8, t=1.0, v=1.5):
    c = np.array([[0.0, 0.0], [1.0, 0.0]])
    cz = np.diag([1.0, -1.0])

    def op_at(i):
        out = np.eye(1)
        for s in range(L):
            out = np.kron(out, c if s == i else (cz if s < i else np.eye(2)))
        return out

    cs = [op_at(i) for i in range(L)]
    h = sum(-t * (cs[i] @ cs[i + 1].T + cs[i + 1] @ cs[i].T)
            + v * (cs[i] @ cs[i].T) @ (cs[i + 1] @ cs[i + 1].T)
            for i in range(L - 1))
    sel = np.isclose(np.diag(sum(x @ x.T for x in cs)), L // 2)
    return np.linalg.eigvalsh(h[np.ix_(sel, sel)])[0]


def ed_clock(L=6, f=0.7, j=1.0):
    sig = np.roll(np.eye(3), 1, axis=0)
    tau = np.diag([2.0, -1.0, -1.0])

    def kr(m, i):
        out = np.eye(1)
        for s in range(L):
            out = np.kron(out, m if s == i else np.eye(3))
        return out

    h = sum(-f * kr(tau, i) for i in range(L)) \
        + sum(-j * (kr(sig, i) @ kr(sig.T, i + 1)
                    + kr(sig.T, i) @ kr(sig, i + 1)) for i in range(L - 1))
    charges = sum((np.arange(3 ** L) // 3 ** (L - 1 - i)) % 3
                  for i in range(L)) % 3
    sel = charges == 0
    return np.linalg.eigvalsh(h[np.ix_(sel, sel)])[0]


CASES = {"hubbard6": (hubbard, -4.5463137943),
         "spinless8": (spinless, ed_spinless),
         "clock6": (clock, ed_clock)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_custom_bases_match_reference_and_ed(name):
    """(U1Fermi, U1) Hubbard-L6 against its FCI energy -4.5463137943
    (tests/test_sany_custom.py:43), the spinless t-V chain and the Z3
    clock chain against ED: torch_resident (the default) and torch_tiled
    on the kernels' twins and the host backend, each to 1e-8 Ha of the
    JAX package's DMRG on its own driver's MPO and of the anchor; the
    same quanta, letters and MPO bonds as the JAX driver's."""
    make, anchor = CASES[name]
    d, mpo, tgt = make(DMRGDriver, SymmetryTypes)
    rd, rmpo, _ = make(RefDriver, RefSym)
    g, rg = d.group, rd.group
    assert (g.kinds, g.names, g.fermion_index) == \
        (rg.kinds, rg.names, rg.fermion_index)
    assert d._custom_letters == rd._custom_letters
    assert [list(b) for b in mpo.bond_dqs] == \
        [[tuple(q) for q in b] for b in rmpo.bond_dqs]
    ref = RefDMRG(rmpo, rd.get_random_mps(60, target=tgt, seed=3),
                  iprint=0).solve(SCHED["bond_dims"], SCHED["noises"],
                                  SCHED["thrds"], n_sweeps=8, tol=1e-11)
    e_anchor = anchor if isinstance(anchor, float) else anchor()
    assert abs(ref - e_anchor) <= E_TOL
    for kw in (dict(device="cpu"), dict(device="cpu", backend="torch_tiled"),
               dict(backend="numpy")):
        ket = d.get_random_mps(60, target=tgt, seed=3)
        assert ket.info.site_quanta == \
            [[tuple(q) for q in qs] for qs in rmpo.site_quanta]
        e = d.dmrg(mpo, ket, **kw, **SCHED)
        assert abs(e - ref) <= E_TOL, (kw, e, ref)
        s = d._last_dmrg
        if kw.get("backend") is None:
            assert s.backend == "torch_resident"
            assert s.host_redo_count == s.host_env_materialized == 0
            assert s.host_ops_downloads == 0


def test_slot_target_and_letters():
    """initialize_system(target=) keeps the slot tuple as the default
    target of the abelian SAny mode; a letter the Hamiltonian does not
    define, or a length mismatch, raises; the site MPO is an SZ-only
    front."""
    d, mpo, _ = hubbard(DMRGDriver, SymmetryTypes, L=4)
    d.initialize_system(n_sites=4, target=(4, 2), hamil_init=False)
    assert d.target == (4, 2)
    assert d.get_random_mps(10, seed=1).info.target == (4, 2)
    b = d.expr_builder()
    with pytest.raises(ValueError, match="defines"):
        b.add_term("cx", [0, 1], 1.0)
    with pytest.raises(ValueError, match="site indices"):
        b.add_term("cd", [0], 1.0)
    with pytest.raises(ValueError, match="expr_builder"):
        d.get_site_mpo("c", 0)
    with pytest.raises(ValueError, match="set_symmetry_groups"):
        DMRGDriver().get_custom_hamiltonian([[((0,), 1)]], [{}])


def test_sany_entry_point_raises_without_a_card():
    """The abelian SAny mode runs torch_resident on the card by default:
    without CUDA it raises and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    d, mpo, tgt = spinless(DMRGDriver, SymmetryTypes, L=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        d.dmrg(mpo, d.get_random_mps(10, target=(2,)), bond_dims=[10],
               n_sweeps=1)
