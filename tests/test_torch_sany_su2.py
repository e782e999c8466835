"""The port's SAnySU2 mode (block2_preview_tpu_torch/dmrg/sany_su2.py and
the driver's ``set_symmetry_groups`` / ``get_custom_hamiltonian`` /
coupled ``ExprBuilder`` / ``get_mpo`` / ``dmrg``) against the JAX
package's on the same in-code inputs: the compiled term tables and
entries elementwise (Hubbard-L4, the 2x2 t-J plaquette, a pure-spin
chain), energies to 1e-8 Ha of the JAX driver and of ED, the L=8
tutorial anchor, ``pg_mod`` through the driver (SU2LZ and SU2K labels),
the refused compositions, the card as the default, and one SAnySU2 MPO
built with neither JAX nor the JAX package importable.  Mirrors
tests/test_sany_su2.py, tests/test_su2lz.py and tests/test_su2k.py."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from block2_preview_tpu.core.expr import build_term_table as ref_build_tt
from block2_preview_tpu.core.expr import qc_raw_terms as ref_qc_raw
from block2_preview_tpu.core.expr import \
    spin_square_raw_terms as ref_s2_raw
from block2_preview_tpu.core.fcidump import FCIDUMP as RefFCIDUMP
from block2_preview_tpu.dmrg import sany_su2 as ref_sany
from block2_preview_tpu.dmrg.su2_qc import \
    compile_su2_entries as ref_compile
from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
from block2_preview_tpu.driver.core import SymmetryTypes as RefSym
from block2_preview_tpu.utils.ed import sector_indices, term_table_to_sparse

from block2_preview_tpu_torch.dmrg import sany_su2
from block2_preview_tpu_torch.dmrg.su2_fermion import (SU2FermionDMRG,
                                                       hubbard_su2_dmrg)
from block2_preview_tpu_torch.dmrg.su2_qc import (SU2TermTable,
                                                  compile_su2_entries)
from block2_preview_tpu_torch.driver.core import (DMRGDriver, SU2MPO,
                                                  SU2MPSSpec, SymmetryTypes)

import test_torch_plans  # noqa: F401  (pins torch to one thread)

ROOT = Path(__file__).resolve().parents[1]
E_TOL = 1e-8       # Ha: against the JAX driver, ED and the anchors
SQ2 = 2 ** 0.5
HUB_MULTS = [(0, 0, 0), (1, 1, 0), (2, 0, 0)]
HUB_C = np.array([[0, 0, 0], [1, 0, 0], [0, -SQ2, 0]])
HUB_D = np.array([[0, SQ2, 0], [0, 0, 1], [0, 0, 0]])
TJ_C = np.array([[0, 0], [1, 0]])
TJ_D = np.array([[0, SQ2], [0, 0]])


def hub_terms(L, U):
    """The tutorial's SU(2) Hubbard terms (hopping, on-site U)."""
    return [("(C+D)0",
             [x for i in range(L - 1) for x in [i, i + 1, i + 1, i]], -SQ2),
            ("((C+(C+D)0)1+D)0", [x for i in range(L) for x in [i] * 4], U)]


def plaquette(lx=2, ly=2):
    bonds = []
    for i in range(lx):
        for j in range(ly):
            if i + 1 < lx:
                bonds.append((i * ly + j, (i + 1) * ly + j))
            if j + 1 < ly:
                bonds.append((i * ly + j, i * ly + j + 1))
    return bonds


def tj_terms(bonds, J=0.4):
    out = []
    for (a, b) in bonds:
        out += [("(C+D)0", [a, b, b, a], -SQ2),
                ("((C+D)2+(C+D)2)0", [a, a, b, b], J * -(3 ** 0.5) / 2),
                ("((C+D)0+(C+D)0)0", [a, a, b, b], J * -1 / 2)]
    return out


def spin_terms(L):
    return [("(T+T)0", [i, i + 1], -np.sqrt(3.0)) for i in range(L - 1)]


CASES = {
    # name: (symmetry groups, site basis, site ops, su2 ranks, terms, L,
    #        target slots)
    "hubbard4": (("U1Fermi", "SU2", "SU2"),
                 [((0, 0, 0), 1), ((1, 1, 1), 1), ((2, 0, 0), 1)],
                 {"": np.eye(3), "C": HUB_C, "D": HUB_D}, None,
                 hub_terms(4, 2.0), 4, (4, 0, 0)),
    "tj2x2": (("U1Fermi", "SU2", "SU2"), [((0, 0, 0), 1), ((1, 1, 1), 1)],
              {"": np.eye(2), "C": TJ_C, "D": TJ_D}, None,
              tj_terms(plaquette()), 4, (3, 1, 1)),
    "spin6": (("SU2", "SU2"), [((1, 1), 1)],
              {"T": np.array([[np.sqrt(3.0) / 2]])}, {"T": 2},
              spin_terms(6), 6, (0, 0)),
}


def build(cls, sym, name):
    """(driver, SU2MPO) of a case through the reference call style on the
    port's (cls = DMRGDriver) or the JAX package's driver."""
    groups, basis, ops, ranks, terms, L, tgt = CASES[name]
    d = cls(sym.SZ)
    d.set_symmetry_groups(*groups)
    d.initialize_system(n_sites=L, target=tgt, hamil_init=False)
    d.get_custom_hamiltonian([basis] * L, [ops] * L, su2_ranks=ranks)
    b = d.expr_builder()
    for expr, idx, c in terms:
        b.add_term(expr, idx, c)
    return d, d.get_mpo(b.finalize(adjust_order=True))


def test_parse_coupled_and_infer_quanta_equal_reference():
    for expr in ("((C+D)2+(C+D)2)0", "((C+(C+D)0)1+D)0", "(T+T)0", "C"):
        assert sany_su2.parse_coupled(expr) == ref_sany.parse_coupled(expr)
    tree, leaves = sany_su2.parse_coupled("((C+(C+D)0)1+D)0")
    assert leaves == ["C", "C", "D", "D"] and tree[1][3] == 1
    for mults, mat in ((HUB_MULTS, HUB_C), (HUB_MULTS, HUB_D),
                       ([(0, 0, 0), (1, 1, 0)], TJ_C),
                       ([(0, 1, 0)], np.ones((1, 1)))):
        n_of = [m[0] for m in mults]
        assert sany_su2.infer_op_quanta(mat, sany_su2.SiteSpaceSU2(mults),
                                        n_of) == \
            ref_sany.infer_op_quanta(mat, ref_sany.SiteSpaceSU2(mults), n_of)
    with pytest.raises(ValueError):
        sany_su2.infer_op_quanta(np.zeros((2, 2)),
                                 sany_su2.SiteSpaceSU2([(0, 0, 0)] * 2),
                                 [0, 0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_tables_and_entries_equal_reference(name):
    """compile_sany_su2_term_table and compile_su2_entries of both packages
    on the same sites and terms: the same rows, constants and registry,
    then the same symbols, ranks, dN and entries, elementwise."""
    port_tt = build(DMRGDriver, SymmetryTypes, name)[0].expr_builder()
    ref_tt = build(RefDriver, RefSym, name)[0].expr_builder()
    for b in (port_tt, ref_tt):
        for expr, idx, c in CASES[name][4]:
            b.add_term(expr, idx, c)
    got, ref = port_tt.finalize(), ref_tt.finalize()
    assert isinstance(got, SU2TermTable)
    assert got.L == ref.L and got.op_names == ref.op_names
    assert got.op_info == ref.op_info and got.coeffs == ref.coeffs
    assert len(got.rows) == len(ref.rows)
    assert all(np.array_equal(a, b) for a, b in zip(got.rows, ref.rows))
    assert got.registry.keys() == ref.registry.keys()
    for k, (red, k2, dn) in got.registry.items():
        rr, rk2, rdn = ref.registry[k]
        assert (k2, dn) == (rk2, rdn)
        np.testing.assert_array_equal(red, rr)
    ents, ns, dn, rk, reg = compile_su2_entries(got)
    rents, rns, rdn, rrk, rreg = ref_compile(ref)
    assert (ns, dn, rk) == (rns, rdn, rrk)
    assert ents == rents
    assert reg.keys() == rreg.keys()
    for k in reg:
        np.testing.assert_array_equal(reg[k][0], rreg[k][0])
        assert reg[k][1:] == rreg[k][1:]


def test_hubbard_vs_builtin_engine():
    """The compiled SU(2) Hubbard-L4 chain on the port's engine equals the
    built-in hand-derived Hubbard entries (tests/test_sany_su2.py:35)."""
    L, U, NE = 4, 2.0, 4
    ham = sany_su2.SAnySU2Hamil([HUB_MULTS] * L,
                                [{"C": (HUB_C, 1, 1),
                                  "D": (HUB_D, 1, -1)}] * L)
    ents, ns, dn, rk, reg = compile_su2_entries(
        sany_su2.compile_sany_su2_term_table(ham, hub_terms(L, U)))
    e = SU2FermionDMRG(
        L, ents, ns, dn, target=(NE, 0, 0), bond_dim=100, ops=reg,
        ranks=rk, site_mults=[HUB_MULTS] * L,
        site_ops={t: {"I": (np.eye(3), 0, 0)} for t in range(L)},
        device="cpu").solve(n_sweeps=8, tol=1e-11)
    ref = hubbard_su2_dmrg(L, 1.0, U, n_elec=NE, bond_dim=100,
                           backend="numpy").solve(n_sweeps=8, tol=1e-11)
    assert abs(e - ref) <= 1e-10


def test_driver_hubbard_anchor_and_reference():
    """tests/test_sany_su2.py:59, the tutorial's L=8 SU(2) Hubbard (U=2,
    N=8) in the full reference call style: the port's host engine within
    1e-8 Ha of the notebook's -6.225634144666362; the MPO carries the
    sites' multiplets and identity."""
    L, U, NE = 8, 2.0, 8
    d = DMRGDriver(SymmetryTypes.SZ)
    d.set_symmetry_groups("U1Fermi", "SU2", "SU2")
    d.initialize_system(n_sites=L, vacuum=(0, 0, 0), target=(NE, 0, 0),
                        hamil_init=False)
    d.get_custom_hamiltonian(
        [[((0, 0, 0), 1), ((1, 1, 1), 1), ((2, 0, 0), 1)]] * L,
        [{"": np.eye(3), "C": HUB_C, "D": HUB_D}] * L)
    b = d.expr_builder()
    for expr, idx, c in hub_terms(L, U):
        b.add_term(expr, idx, c)
    mpo = d.get_mpo(b.finalize(adjust_order=True))
    assert isinstance(mpo, SU2MPO)
    assert mpo.site_mults == [HUB_MULTS] * L
    assert np.array_equal(mpo.site_ops[3]["I"][0], np.eye(3))
    e = d.dmrg(mpo, d.get_random_mps(bond_dim=250),
               bond_dims=[250] * 4 + [400] * 4,
               noises=[1e-4] * 4 + [1e-5] * 3 + [0], thrds=[1e-10] * 8,
               n_sweeps=10, iprint=0, backend="numpy")
    assert abs(e - (-6.225634144666362)) <= E_TOL


def tj_ed(L, bonds, J, NE, TWOS):
    """t-J on the no-double-occupancy space from spinful JW fermions
    (tests/test_sany_su2.py:87's referee)."""
    dim = 4 ** L

    def cre(m):
        op = np.zeros((dim, dim))
        for s in range(dim):
            if not (s >> m) & 1:
                op[s | (1 << m), s] = \
                    (-1.0) ** bin(s & ((1 << m) - 1)).count("1")
        return op

    cu = [cre(2 * t) for t in range(L)]
    cd = [cre(2 * t + 1) for t in range(L)]
    nu = [c @ c.T for c in cu]
    nd = [c @ c.T for c in cd]
    H = np.zeros((dim, dim))
    for (a, b) in bonds:
        for ca in (cu, cd):
            H -= ca[a] @ ca[b].T + ca[b] @ ca[a].T
        spa, spb = cu[a] @ cd[a].T, cu[b] @ cd[b].T
        H += J * (0.25 * (nu[a] - nd[a]) @ (nu[b] - nd[b])
                  + 0.5 * (spa @ spb.T + spa.T @ spb)
                  - 0.25 * (nu[a] + nd[a]) @ (nu[b] + nd[b]))
    keep = []
    for s in range(dim):
        occ = [((s >> (2 * t)) & 1, (s >> (2 * t + 1)) & 1)
               for t in range(L)]
        if all(not (u and d) for u, d in occ) \
                and sum(u + d for u, d in occ) == NE \
                and sum(u - d for u, d in occ) == TWOS:
            keep.append(s)
    return np.linalg.eigvalsh(H[np.ix_(keep, keep)])[0]


def heisenberg_ed(L):
    sz, sp = np.diag([0.5, -0.5]), np.array([[0, 1.0], [0, 0]])

    def emb(op, t):
        m = np.ones((1, 1))
        for s in range(L):
            m = np.kron(m, op if s == t else np.eye(2))
        return m

    H = sum(emb(sz, i) @ emb(sz, i + 1)
            + 0.5 * (emb(sp, i) @ emb(sp.T, i + 1)
                     + emb(sp.T, i) @ emb(sp, i + 1)) for i in range(L - 1))
    return np.linalg.eigvalsh(H)[0]


@pytest.mark.parametrize("name", ["tj2x2", "spin6"])
def test_custom_multiplets_on_the_device_path_vs_ed(name):
    """The 2x2 t-J plaquette (two multiplets a site, N=3, 2S=1) and the
    S=1/2 Heisenberg chain (one multiplet a site, no particle-number slot,
    a rank given in su2_ranks): the device path on the kernels' twins and
    the host engine against ED and the JAX driver to 1e-8 Ha; the site
    identity reaches the engine's operator lookup."""
    e_ed = (tj_ed(4, plaquette(), 0.4, 3, 1) if name == "tj2x2"
            else heisenberg_ed(6))
    kw = dict(bond_dims=[60], noises=[1e-4, 1e-5, 0], thrds=[1e-11],
              n_sweeps=8, iprint=0)
    d, mpo = build(DMRGDriver, SymmetryTypes, name)
    ket = d.get_random_mps(bond_dim=60)
    assert isinstance(ket, SU2MPSSpec)
    e_dev = d.dmrg(mpo, ket, device="cpu", **kw)
    eng = d._last_dmrg
    assert eng.backend == "torch_tiled" and eng.host_matvec_count == 0
    assert eng.n_blocking > 0 and ket.engine is eng
    assert eng._op_at(1, "I")[0].shape == (len(CASES[name][1]),) * 2
    e_host = d.dmrg(mpo, d.get_random_mps(bond_dim=60), backend="numpy",
                    **kw)
    rd, rmpo = build(RefDriver, RefSym, name)
    e_ref = rd.dmrg(rmpo, rd.get_random_mps(bond_dim=60), **kw)
    for e in (e_dev, e_host, e_ref):
        assert abs(e - e_ed) <= E_TOL
    assert abs(e_host - e_ref) <= 1e-10


def lz_fcidump(seed=5, L=4):
    """tests/test_su2lz.py:21's Lz-conserving integrals (4 orbitals, Lz
    0, 1, -1, 0), in the JAX package's FCIDUMP."""
    rng = np.random.RandomState(seed)
    lz = np.array([0, 1, -1, 0])
    h1 = rng.standard_normal((L, L)) * 0.5
    h1 = (h1 + h1.T) / 2
    g = rng.standard_normal((L,) * 4) * 0.2
    g = g + g.transpose(1, 0, 2, 3) + g.transpose(0, 1, 3, 2) \
        + g.transpose(1, 0, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)
    h1[lz[:, None] != lz[None, :]] = 0.0
    for i, j, k, l in np.ndindex(L, L, L, L):
        if lz[i] - lz[j] + lz[k] - lz[l] != 0:
            g[i, j, k, l] = 0.0
    return h1, g, lz


def sector_spin_ed(h, s2, ix, labels, lab, twos):
    """Lowest eigenvalue in the sector of orbital label ``lab`` and spin
    2S = twos (inside the S^2 eigenspace)."""
    sel = np.nonzero(labels == lab)[0]
    w2, v2 = np.linalg.eigh(s2[np.ix_(sel, sel)])
    s = twos / 2.0
    P = v2[:, np.abs(w2 - s * (s + 1)) < 1e-8]
    hp = P.T @ h[np.ix_(sel, sel)] @ P
    return float(np.linalg.eigvalsh(0.5 * (hp + hp.T))[0])


def det_label(ix, L, weight, mod=None):
    out = []
    for i in ix:
        tot = 0
        for t in range(L):
            d = (int(i) // (4 ** (L - 1 - t))) % 4
            tot += weight[t] * (1 if d in (1, 2) else (2 if d == 3 else 0))
        out.append(tot % mod if mod else tot)
    return np.array(out)


@pytest.mark.parametrize("kind", ["su2lz", "su2k"])
def test_pg_mod_through_the_driver(kind):
    """pg_mod = N through the driver (tests/test_su2lz.py:77 with N=64
    larger than any total Lz; tests/test_su2k.py:51's k-space Hubbard-L4
    with N = L), on the device path (twins) against spin- and
    label-resolved ED to 1e-8 Ha."""
    L, ne = 4, 4
    if kind == "su2lz":
        h1, g2, lz = lz_fcidump()
        mod, labels_w = 64, lz
        cases = [(0, 0), (1, 0), (-1, 2)]
    else:
        from block2_preview_tpu.models.hubbard import hubbard_kspace
        fd, _, _, _ = hubbard_kspace(L, u=2.0, t=1.0, n_elec=ne)
        h1, g2, lz = fd.h1e, fd.g2e, np.arange(L)
        mod, labels_w = L, np.arange(L)
        cases = [(0, 0), (2, 2)]
    rfd = RefFCIDUMP(n_sites=L, n_elec=ne, twos=0,
                     orb_sym=np.zeros(L, dtype=np.int64), h1e=h1, g2e=g2)
    raw = (ref_qc_raw(rfd, cutoff=1e-13) if kind == "su2lz" else
           ref_qc_raw(rfd, cutoff=1e-13, pg_mode=L))
    ix = sector_indices(L, ne, 0)
    h = term_table_to_sparse(ref_build_tt(L, raw))[np.ix_(ix, ix)].toarray()
    s2 = term_table_to_sparse(ref_build_tt(L, ref_s2_raw(L)))
    s2 = s2[np.ix_(ix, ix)].toarray()
    labels = det_label(ix, L, labels_w, None if kind == "su2lz" else L)
    for lab, twos in cases:
        ref = sector_spin_ed(h, 0.5 * (s2 + s2.T), ix, labels, lab, twos)
        drv = DMRGDriver(SymmetryTypes.SU2)
        drv.initialize_system(L, ne, twos, orb_sym=lz % mod,
                              pg_irrep=lab % mod, pg_mod=mod)
        mpo = drv.get_qc_mpo(h1e=h1, g2e=g2)
        e = drv.dmrg(mpo, drv.get_random_mps(80), bond_dims=[80],
                     noises=[1e-4] * 4 + [0], thrds=[1e-10], n_sweeps=10,
                     tol=1e-11, iprint=0, device="cpu")
        assert drv._last_dmrg.pg_mod == mod
        assert abs(e - ref) <= E_TOL, (kind, lab, twos, e, ref)


def test_bad_compositions_and_routes_raise():
    """tests/test_sany_su2.py:280 and test_sany_custom.py:131: SU2 outside
    one consecutive pair, or beside a factor other than one U1, raises
    NotImplementedError; the slots are read as the reference reads them;
    an SU2TermTable outside the SAnySU2 mode and the QC MPO in the SAny
    mode raise."""
    for names in (("SU2", "U1Fermi", "SU2"), ("U1Fermi", "LZ", "SU2", "SU2"),
                  ("U1Fermi", "AbelianPG", "SU2", "SU2")):
        with pytest.raises(NotImplementedError):
            DMRGDriver(SymmetryTypes.SZ).set_symmetry_groups(*names)
    d = DMRGDriver(SymmetryTypes.SZ)
    d.set_symmetry_groups("U1Fermi", "SU2", "SU2")
    assert d._sany_su2 == {"n_slot": 0, "su2_slot": 1}
    assert d.symm_type == SymmetryTypes.SAny
    with pytest.raises(ValueError, match="unknown symmetry"):
        d.set_symmetry_groups("U2")
    with pytest.raises(ValueError, match="get_custom_hamiltonian"):
        d.get_qc_mpo(h1e=np.zeros((2, 2)), g2e=np.zeros((2,) * 4))
    su2 = DMRGDriver(SymmetryTypes.SU2)
    su2.initialize_system(4, 4, 0)
    with pytest.raises(ValueError, match="SAnySU2"):
        su2.get_mpo(SU2TermTable(4))
    with pytest.raises(ValueError, match="REDUCED"):
        d.get_custom_hamiltonian([[((0, 0, 0), 1)]], [{"C": np.eye(2)}])


def test_sany_su2_entry_point_raises_without_a_card():
    """dmrg's device is the card by default: without CUDA the SAnySU2 run
    raises and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    d, mpo = build(DMRGDriver, SymmetryTypes, "spin6")
    with pytest.raises(RuntimeError, match="CUDA"):
        d.dmrg(mpo, d.get_random_mps(20), bond_dims=[20], n_sweeps=1)


_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["block2_preview_tpu"] = None   # and of the JAX package
import numpy as np
from block2_preview_tpu_torch.driver.core import DMRGDriver, SymmetryTypes
import block2_preview_tpu_torch.dmrg.su2_heisenberg
import block2_preview_tpu_torch.utils.transform
L = 4
d = DMRGDriver(SymmetryTypes.SZ)
d.set_symmetry_groups("U1Fermi", "SU2", "SU2")
d.initialize_system(n_sites=L, target=(3, 1, 1), hamil_init=False)
C, D = np.array([[0, 0], [1, 0]]), np.array([[0, 2 ** 0.5], [0, 0]])
d.get_custom_hamiltonian([[((0, 0, 0), 1), ((1, 1, 1), 1)]] * L,
                         [{"": np.eye(2), "C": C, "D": D}] * L)
b = d.expr_builder()
for a in range(L - 1):
    b.add_term("(C+D)0", [a, a + 1, a + 1, a], -2 ** 0.5)
    b.add_term("((C+D)2+(C+D)2)0", [a, a, a + 1, a + 1], -0.4 * 3 ** 0.5 / 2)
mpo = d.get_mpo(b.finalize())
e = d.dmrg(mpo, d.get_random_mps(20), bond_dims=[20], n_sweeps=4,
           iprint=0, device="cpu")
assert not any(k == "jax" or k.startswith(("jax.", "block2_preview_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("SYMBOLS", mpo.n_symbols, "ENERGY", e)
"""


def test_sany_su2_mpo_builds_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SYMBOLS" in proc.stdout
