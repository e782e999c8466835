"""Spin-adapted (SU(2)) quantum-chemistry DMRG: term compiler + MPO.

This is the counterpart of block2's SU2 quantum-chemistry
universe (reference src/dmrg/qc_hamiltonian.hpp:629 SU2 site operators,
src/dmrg/qc_mpo.hpp:1851 MPOQC<SU2>, src/core/spin_permutation.hpp:1188
SpinPermScheme).  Where the reference hand-derives the spin-coupled
complementary-operator algebra, we derive it *numerically and generically*:

1.  Every spin-summed second-quantized string of the Hamiltonian
        sum_s  c+_{i s} c_{j s}                       (one-electron)
        sum_{s s'} c+_{i s} c+_{k s'} c_{l s'} c_{j s} (two-electron)
    is classified by its *pattern*: the assignment of string positions
    ("roles") to site-sorted slots.
2.  For each pattern we enumerate all site-ordered *coupled chains*:
    per-slot on-site composites of the elementary spinor tensors C
    (creation, rank 1/2) and D (annihilation, rank 1/2) with every
    allowed internal coupling, threaded by every allowed cumulative rank
    chain 0 -> K_1 -> ... -> 0.
3.  The expansion coefficients lambda(pattern, chain) are obtained by a
    dense least-squares solve on an explicit m-resolved Fock space (<= 4
    slots, dim <= 256), using *exactly* the graded coupled-product rule of
    the sweep engine.  The residual is asserted ~ 0, so the algebra is
    machine-verified at build time (the SpinPermScheme analog, with CG
    bookkeeping replaced by linear algebra).
4.  The resulting spin-adapted term table (rows of per-site
    (op, rank_in, rank_out) ids) is compiled into a compressed MPO by the
    same bipartite minimum-vertex-cover pass as the abelian builder
    (reference src/dmrg/general_mpo.hpp:152 MPOAlgorithmTypes::FastBipartite),
    yielding the O(K^2) complementary-operator bond scaling of
    qc_mpo.hpp's NC/CN partitions.

The compiled entries run on SU2FermionDMRG (su2_fermion.py), whose sweep
recoupling applies the 9j factors; reduced multiplet bond dimensions are
roughly half the equivalent abelian (SZ) bond dimensions.

Copied from block2_preview_tpu/dmrg/su2_qc.py (the port keeps its own copy),
with ``couple_components`` of the reference's dmrg/csf_big_site.py:223
copied in for the big-site table.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.clebsch_gordan import clebsch_gordan
from .su2_fermion import SU2FermionDMRG

# ---------------------------------------------------------------------------
# m-resolved single-orbital algebra.  Basis |0>, |up>, |dn>, |2>, with
# |2> = c+_up c+_dn |0>.  Spinor conventions of su2_fermion.SITE_OPS:
# C = (c+_up, c+_dn), D = (c_dn, -c_up)  (components keyed by doubled m).
# ---------------------------------------------------------------------------

_CU = np.zeros((4, 4)); _CU[1, 0] = 1.0; _CU[3, 2] = 1.0
_CD = np.zeros((4, 4)); _CD[2, 0] = 1.0; _CD[3, 1] = -1.0

ELEM = {
    "C": ({1: _CU, -1: _CD}, 1, +1),
    "D": ({1: _CD.T, -1: -_CU.T}, 1, -1),
}

# site parity (-1)^N and multiplet structure: state -> (multiplet, 2m)
_SITE_Z = np.diag([1.0, -1.0, -1.0, 1.0])
_STATE_MULT = [(0, 0), (1, 1), (1, -1), (2, 0)]
_MULT_J = [0, 1, 0]  # doubled spin per multiplet


def _reduced_from_components(comp: Dict[int, np.ndarray], tk: int
                             ) -> Optional[np.ndarray]:
    """Extract the 3x3 reduced matrix of a tensor operator from its
    m-resolved components via Wigner-Eckart; None if identically zero;
    raises if the components are NOT a well-formed rank-tk tensor."""
    red = np.zeros((3, 3))
    have = np.zeros((3, 3), dtype=bool)
    for tq, mat in comp.items():
        for ib in range(4):
            for ik in range(4):
                v = mat[ib, ik]
                mb, tmb = _STATE_MULT[ib]
                mk, tmk = _STATE_MULT[ik]
                cg = clebsch_gordan(_MULT_J[mk], tk, _MULT_J[mb],
                                    tmk, tq, tmb)
                if abs(cg) < 1e-14:
                    if abs(v) > 1e-12:
                        raise ValueError("not a rank-%d tensor" % tk)
                    continue
                r = v / cg
                if have[mb, mk]:
                    if abs(r - red[mb, mk]) > 1e-10:
                        raise ValueError("Wigner-Eckart violated")
                else:
                    red[mb, mk] = r
                    have[mb, mk] = True
    if np.max(np.abs(red)) < 1e-14:
        return None
    return red


def _couple_onsite(a: Dict[int, np.ndarray], ka: int,
                   b: Dict[int, np.ndarray], kb: int, k: int
                   ) -> Dict[int, np.ndarray]:
    """[A x B]^k on the same site: plain operator products, CG-coupled."""
    out = {tq: np.zeros((4, 4)) for tq in range(-k, k + 1, 2)}
    for tqa, ma in a.items():
        for tqb, mb in b.items():
            tq = tqa + tqb
            if abs(tq) > k:
                continue
            cg = clebsch_gordan(ka, kb, k, tqa, tqb, tq)
            if abs(cg) > 1e-14:
                out[tq] += cg * (ma @ mb)
    return out


@lru_cache(maxsize=None)
def _onsite_composite(elems: Tuple[str, ...], chain: Tuple[int, ...]):
    """On-site composite op from sequential coupling of elementary spinors.
    chain[s] = doubled rank after coupling elems[:s+1] (chain[0] == 1).
    Returns (components dict, reduced 3x3 or None, rank, dN)."""
    comp, k, dn = ELEM[elems[0]]
    comp = dict(comp)
    assert chain[0] == 1
    for s in range(1, len(elems)):
        comp2, k2, dn2 = ELEM[elems[s]]
        comp = _couple_onsite(comp, k, comp2, k2, chain[s])
        k = chain[s]
        dn += dn2
    red = _reduced_from_components(comp, k)
    return comp, red, k, dn


def _op_name(elems: Tuple[str, ...], chain: Tuple[int, ...]) -> str:
    if len(elems) == 1:
        return elems[0]
    return "".join(elems) + ":" + ",".join(map(str, chain[1:]))


def _internal_chains(n_ops: int):
    """All doubled-rank chains for sequentially coupling n_ops rank-1/2
    tensors on one site (doubled ranks capped at 3; identically-zero
    composites are pruned later by the reduced-matrix check)."""
    chains = [(1,)]
    for _ in range(n_ops - 1):
        nxt = []
        for c in chains:
            for k in range(abs(c[-1] - 1), min(c[-1] + 1, 3) + 1, 2):
                nxt.append(c + (k,))
        chains = nxt
    return chains


# ---------------------------------------------------------------------------
# Dense graded chain evaluation (for the lambda least-squares derivation).
# ---------------------------------------------------------------------------

def _chain_dense(slot_comps: List[Tuple[Dict[int, np.ndarray], int, int]],
                 cum: Tuple[int, ...]) -> np.ndarray:
    """Dense scalar (rank-0 component) of the graded coupled chain
    [[W_1 x W_2]^{K_1} x ...]^{0} on the 4^m-dim slot space, using the
    engine's rule [A x B] -> (A Z^{p_B}) (x) B."""
    acc = {0: np.ones((1, 1))}
    k_acc = 0
    zprev = np.ones(1)
    for s, (comp, kw, dnw) in enumerate(slot_comps):
        ko = cum[s]
        pw = abs(dnw) % 2
        dim = acc[next(iter(acc))].shape[0]
        wdim = next(iter(comp.values())).shape[0]   # 4, or the big slot
        out = {tq: np.zeros((dim * wdim, dim * wdim))
               for tq in range(-ko, ko + 1, 2)}
        for tqi, oi in acc.items():
            oi_z = oi * zprev[None, :] if pw else oi
            for tqw, w in comp.items():
                tqo = tqi + tqw
                if abs(tqo) > ko:
                    continue
                cg = clebsch_gordan(k_acc, kw, ko, tqi, tqw, tqo)
                if abs(cg) > 1e-14:
                    out[tqo] += cg * np.kron(oi_z, w)
        acc = out
        k_acc = ko
        zprev = np.kron(zprev, np.diag(_SITE_Z))
    assert k_acc == 0
    return acc[0]


def _elementary_dense(m: int, slot: int, op: str, tsz: int) -> np.ndarray:
    """Dense c+_{slot, sz} or c_{slot, sz} on the 4^m slot space (JW).
    These are RAW spin operators (the Hamiltonian string), not the
    annihilation tensor spinor D~ = (c_dn, -c_up)."""
    mat = {("C", 1): _CU, ("C", -1): _CD,
           ("D", 1): _CU.T, ("D", -1): _CD.T}[(op, tsz)]
    out = np.ones((1, 1))
    for s in range(m):
        if s < slot:
            out = np.kron(out, _SITE_Z)
        elif s == slot:
            out = np.kron(out, mat)
        else:
            out = np.kron(out, np.eye(4))
    return out


def _target_dense(pattern: Tuple[Tuple[int, ...], ...],
                  n_roles: int) -> np.ndarray:
    """Dense sum_{spins} of the Hamiltonian string on the slot space.
    Roles: n_roles == 2 -> (C_i, D_j) sharing spin s;
    n_roles == 4 -> (C_i, C_k, D_l, D_j) with spins (s, s', s', s)."""
    m = len(pattern)
    slot_of = {}
    for s, roles in enumerate(pattern):
        for r in roles:
            slot_of[r] = s
    tot = np.zeros((4 ** m, 4 ** m))
    if n_roles == 2:
        for ts in (1, -1):
            tot += (_elementary_dense(m, slot_of[0], "C", ts)
                    @ _elementary_dense(m, slot_of[1], "D", ts))
    else:
        for ts in (1, -1):
            for ts2 in (1, -1):
                tot += (_elementary_dense(m, slot_of[0], "C", ts)
                        @ _elementary_dense(m, slot_of[1], "C", ts2)
                        @ _elementary_dense(m, slot_of[2], "D", ts2)
                        @ _elementary_dense(m, slot_of[3], "D", ts))
    return tot


# cache: pattern -> list of (slot op specs, cumulative chain, lambda)
# slot op spec = (elems tuple, internal chain tuple)
_PATTERN_CACHE: Dict[Tuple, List] = {}


def _pattern_chains(pattern: Tuple[Tuple[int, ...], ...], n_roles: int):
    """All coupled chains + coefficients lambda expanding the spin-summed
    string over the pattern; machine-verified by dense least squares."""
    key = (pattern, n_roles)
    hit = _PATTERN_CACHE.get(key)
    if hit is not None:
        return hit
    m = len(pattern)
    role_op = (lambda r: "C" if (r == 0 if n_roles == 2 else r < 2) else "D")
    slot_elems = [tuple(role_op(r) for r in roles) for roles in pattern]
    # enumerate candidates: per-slot internal chains x cumulative chains
    slot_opts: List[List[Tuple]] = []
    for elems in slot_elems:
        opts = []
        for ch in _internal_chains(len(elems)):
            comp, red, k, dn = _onsite_composite(elems, ch)
            if red is None:
                continue
            opts.append((elems, ch, comp, k, dn))
        slot_opts.append(opts)

    cands: List[Tuple] = []   # (slot specs, cum chain)

    def rec(s, chosen, cum):
        if s == m:
            if cum[-1] == 0:
                cands.append((tuple(chosen), tuple(cum[1:])))
            return
        for opt in slot_opts[s]:
            k = opt[3]
            for ko in range(abs(cum[-1] - k), min(cum[-1] + k, 3) + 1, 2):
                rec(s + 1, chosen + [opt], cum + [ko])

    rec(0, [], [0])
    if not cands:
        raise ValueError(f"no coupled chains for pattern {pattern}")
    target = _target_dense(pattern, n_roles).ravel()
    cols = np.stack([_chain_dense([(o[2], o[3], o[4]) for o in specs],
                                  cum).ravel()
                     for specs, cum in cands], axis=1)
    lam, res, _rk, _sv = np.linalg.lstsq(cols, target, rcond=None)
    resid = np.linalg.norm(cols @ lam - target)
    if resid > 1e-9 * max(1.0, np.linalg.norm(target)):
        raise ValueError(f"pattern {pattern}: residual {resid}")
    out = []
    for (specs, cum), lv in zip(cands, lam):
        if abs(lv) > 1e-12:
            out.append((tuple((_op_name(o[0], o[1]), o[3], o[4])
                              for o in specs), cum, float(lv)))
    _PATTERN_CACHE[key] = out
    return out


def _graded_composite(slot_comps: List[Tuple[Dict[int, np.ndarray],
                                             int, int]],
                      subchain: Tuple[int, ...]):
    """Graded coupled composite of several 4-dim model slots keeping ALL
    tensor components (the multi-orbital big-site operator in the model
    space): returns (components, rank, dN)."""
    comp, k_acc, dn_acc = (dict(slot_comps[0][0]), slot_comps[0][1],
                           slot_comps[0][2])
    zprev = np.diag(_SITE_Z)
    for s in range(1, len(slot_comps)):
        w_comp, kw, dnw = slot_comps[s]
        ko = subchain[s]
        pw = abs(dnw) % 2
        dim = next(iter(comp.values())).shape[0]
        out = {tq: np.zeros((dim * 4, dim * 4))
               for tq in range(-ko, ko + 1, 2)}
        for tqi, oi in comp.items():
            oi_z = oi * zprev[None, :] if pw else oi
            for tqw, w in w_comp.items():
                tqo = tqi + tqw
                if abs(tqo) > ko:
                    continue
                cg = clebsch_gordan(k_acc, kw, ko, tqi, tqw, tqo)
                if abs(cg) > 1e-14:
                    out[tqo] += cg * np.kron(oi_z, w)
        comp = out
        k_acc = ko
        dn_acc += dnw
        zprev = np.kron(zprev, np.diag(_SITE_Z))
    return comp, k_acc, dn_acc


_PATTERN_BIG_CACHE: Dict[Tuple, List] = {}


def _pattern_chains_big(pattern: Tuple[Tuple[int, ...], ...],
                        n_roles: int, n_ext: int):
    """Like _pattern_chains, but the trailing n_ext slots belong to ONE
    big site: their composites merge into a single tensor operator of
    definite rank (coupled through an explicit sub-chain), and the
    expansion coefficients are machine-derived on the all-4-dim model
    space (orbital-independent, so cached per pattern).

    Returns [(int_specs, ext_spec, cum, lambda)] with
      int_specs: ((opname, k, dn), ...) for the internal slots,
      ext_spec: ((elems, chain) per ext slot, subchain, kappa, dn_big),
      cum: doubled cumulative ranks after each internal slot, then 0.
    """
    key = (pattern, n_roles, n_ext)
    hit = _PATTERN_BIG_CACHE.get(key)
    if hit is not None:
        return hit
    m = len(pattern)
    m_int = m - n_ext
    assert n_ext >= 1
    role_op = (lambda r: "C" if (r == 0 if n_roles == 2 else r < 2)
               else "D")
    slot_elems = [tuple(role_op(r) for r in roles) for roles in pattern]
    slot_opts: List[List[Tuple]] = []
    for elems in slot_elems:
        opts = []
        for ch in _internal_chains(len(elems)):
            comp, red, k, dn = _onsite_composite(elems, ch)
            if red is None:
                continue
            opts.append((elems, ch, comp, k, dn))
        slot_opts.append(opts)

    # enumerate big-site composites: per-ext-slot options x subchains
    big_opts: List[Tuple] = []   # (per-slot (elems, chain), subchain,
    #                              model comp, kappa, dn)
    def rec_ext(s, chosen, sub):
        if s == m:
            comp, kappa, dnb = _graded_composite(
                [(o[2], o[3], o[4]) for o in chosen], tuple(sub))
            if max(np.max(np.abs(v)) for v in comp.values()) > 1e-12:
                big_opts.append((tuple((o[0], o[1]) for o in chosen),
                                 tuple(sub), comp, kappa, dnb))
            return
        for opt in slot_opts[s]:
            k = opt[3]
            if s == m_int:
                rec_ext(s + 1, chosen + [opt], [k])
            else:
                for ko in range(abs(sub[-1] - k),
                                min(sub[-1] + k, 3) + 1, 2):
                    rec_ext(s + 1, chosen + [opt], sub + [ko])

    rec_ext(m_int, [], [])

    cands: List[Tuple] = []

    def rec_int(s, chosen, cum):
        if s == m_int:
            for bo in big_opts:
                if bo[3] == cum[-1]:   # final coupling K x kappa -> 0
                    cands.append((tuple(chosen), bo, tuple(cum[1:])))
            return
        for opt in slot_opts[s]:
            k = opt[3]
            for ko in range(abs(cum[-1] - k), min(cum[-1] + k, 3) + 1, 2):
                rec_int(s + 1, chosen + [opt], cum + [ko])

    rec_int(0, [], [0])
    if not cands:
        raise ValueError(f"no big-site chains for pattern {pattern}")
    target = _target_dense(pattern, n_roles).ravel()
    cols = np.stack(
        [_chain_dense([(o[2], o[3], o[4]) for o in specs]
                      + [(bo[2], bo[3], bo[4])],
                      cum + (0,)).ravel()
         for specs, bo, cum in cands], axis=1)
    lam, _res, _rk, _sv = np.linalg.lstsq(cols, target, rcond=None)
    resid = np.linalg.norm(cols @ lam - target)
    if resid > 1e-9 * max(1.0, np.linalg.norm(target)):
        raise ValueError(f"big pattern {pattern}: residual {resid}")
    out = []
    for (specs, bo, cum), lv in zip(cands, lam):
        if abs(lv) > 1e-12:
            int_specs = tuple((_op_name(o[0], o[1]), o[3], o[4])
                              for o in specs)
            ext_spec = (bo[0], bo[1], bo[3], bo[4])
            out.append((int_specs, ext_spec, cum + (0,), float(lv)))
    _PATTERN_BIG_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# Term table generation for H = sum h_ij E1(i,j) + 1/2 sum v_ijkl E2(i,k,l,j)
# ---------------------------------------------------------------------------

_NRANK = 4          # doubled ranks 0..3
_ID_BITS = _NRANK * _NRANK


class SU2TermTable:
    """Rows of per-site packed ids: id = op_id * 16 + rank_in * 4 + rank_out.
    op_id 0 is the identity (pass-through)."""

    def __init__(self, L: int):
        self.L = L
        self.op_names: List[str] = ["I"]
        self.op_ids: Dict[str, int] = {"I": 0}
        self.op_info: Dict[str, Tuple[int, int]] = {"I": (0, 0)}  # (rank, dN)
        self.rows: List[np.ndarray] = []
        self.coeffs: List[float] = []
        self.registry: Dict[str, Tuple[np.ndarray, int, int]] = {}

    def _op(self, name: str, red: np.ndarray, k: int, dn: int) -> int:
        oid = self.op_ids.get(name)
        if oid is None:
            oid = len(self.op_names)
            self.op_names.append(name)
            self.op_ids[name] = oid
            self.op_info[name] = (k, dn)
            self.registry[name] = (red, k, dn)
        return oid

    def add_term(self, sites: Sequence[int],
                 specs: Sequence[Tuple[str, int, int]],
                 cum: Sequence[int], coeff: float) -> None:
        """sites: sorted slot positions; specs: (opname, rank, dN) per slot;
        cum: doubled cumulative rank after each slot (last == 0)."""
        row = np.zeros(self.L, dtype=np.int32)
        prev_end = 0
        k_cur = 0
        for (site, (name, k, dn), ko) in zip(sites, specs, cum):
            for t in range(prev_end, site):
                row[t] = 0 * _ID_BITS + k_cur * _NRANK + k_cur
            if name in self.registry:
                # pre-registered (big-site composites register their
                # reduced matrices directly)
                red = self.registry[name][0]
            else:
                elems_chain = name.split(":")
                elems = tuple(elems_chain[0]) \
                    if ":" in name or len(name) > 1 else (name,)
                chain = ((1,) + tuple(int(x)
                                      for x in elems_chain[1].split(","))
                         if ":" in name else (1,))
                _comp, red, _k, _dn = _onsite_composite(elems, chain)
            oid = self._op(name, red, k, dn)
            row[site] = oid * _ID_BITS + k_cur * _NRANK + ko
            k_cur = ko
            prev_end = site + 1
        for t in range(prev_end, self.L):
            row[t] = 0 * _ID_BITS + k_cur * _NRANK + k_cur
        assert k_cur == 0
        self.rows.append(row)
        self.coeffs.append(float(coeff))

    def add_const(self, e: float) -> None:
        if e != 0.0:
            self.rows.append(np.zeros(self.L, dtype=np.int32))
            self.coeffs.append(float(e))

    def finalize(self):
        opids = np.stack(self.rows, axis=0)
        coeffs = np.asarray(self.coeffs)
        # merge duplicate rows
        from ..core.qc_terms_fast import row_hashes
        h1, h2 = row_hashes(opids)
        key = np.ascontiguousarray(
            np.stack([h1[:, 0], h2[:, 0]], axis=1)).view("V16").ravel()
        _u, first, inv = np.unique(key, return_index=True,
                                   return_inverse=True)
        merged = np.zeros(len(_u))
        np.add.at(merged, inv.ravel(), coeffs)
        keep = np.abs(merged) > 1e-14
        return opids[first[keep]], merged[keep]


def qc_su2_term_table(h1e: np.ndarray, g2e: Optional[np.ndarray],
                      ecore: float = 0.0, cutoff: float = 1e-13
                      ) -> SU2TermTable:
    """Spin-adapted term table for the chemist-notation Hamiltonian
    H = ecore + sum_ij h_ij E1(i,j) + 1/2 sum_ijkl (ij|kl) E2(i,k,l,j)."""
    K = h1e.shape[0]
    tt = SU2TermTable(K)
    tt.add_const(ecore)

    def emit(roles_sites: Sequence[int], n_roles: int, coeff: float):
        # roles_sites[r] = site of role r; build pattern by sorted slots
        order = sorted(set(roles_sites))
        pattern = tuple(tuple(r for r in range(n_roles)
                              if roles_sites[r] == s) for s in order)
        for specs, cum, lam in _pattern_chains(pattern, n_roles):
            tt.add_term(order, specs, cum, coeff * lam)

    for i in range(K):
        for j in range(K):
            if abs(h1e[i, j]) > cutoff:
                emit((i, j), 2, h1e[i, j])
    if g2e is not None:
        for i in range(K):
            for j in range(K):
                for k in range(K):
                    for l in range(K):
                        v = g2e[i, j, k, l]
                        if abs(v) > cutoff:
                            emit((i, k, l, j), 4, 0.5 * v)
    return tt


def couple_components(a: Dict[int, np.ndarray], ka: int,
                      b: Dict[int, np.ndarray], kb: int, k: int
                      ) -> Dict[int, np.ndarray]:
    """[A x B]^k via plain operator products (the determinant-space
    matrices carry the fermionic signs intrinsically).  Copied from
    block2_preview_tpu/dmrg/csf_big_site.py:223."""
    dim = next(iter(a.values())).shape[0]
    out = {tq: np.zeros((dim, dim)) for tq in range(-k, k + 1, 2)}
    for tqa, ma in a.items():
        for tqb, mb in b.items():
            tq = tqa + tqb
            if abs(tq) > k:
                continue
            cg = clebsch_gordan(ka, kb, k, tqa, tqb, tq)
            if abs(cg) > 1e-14:
                out[tq] += cg * (ma @ mb)
    return out


def qc_su2_big_term_table(h1e: np.ndarray, g2e: Optional[np.ndarray],
                          ecore: float, n_int: int, ext,
                          cutoff: float = 1e-13) -> "SU2TermTable":
    """Spin-adapted term table with the orbitals >= n_int collapsed into
    ONE CSF big site (reference CSFBigSite get_site_ops,
    src/big_site/csf_big_site.hpp:1060): every Hamiltonian term's
    external part becomes a coupled composite reduced over the external
    multiplet basis (ext: an external space with ``n_orbs``, ``spinor``
    and ``reduce``, as the reference's dmrg/csf_big_site.ExternalSpace)."""
    K = h1e.shape[0]
    assert K == n_int + ext.n_orbs
    L = n_int + 1
    tt = SU2TermTable(L)
    tt.add_const(ecore)
    bigred_cache: Dict[str, Optional[np.ndarray]] = {}

    def emit(roles_orbs: Sequence[int], n_roles: int, coeff: float):
        if all(o < n_int for o in roles_orbs):
            order = sorted(set(roles_orbs))
            pattern = tuple(tuple(r for r in range(n_roles)
                                  if roles_orbs[r] == s) for s in order)
            for specs, cum, lam in _pattern_chains(pattern, n_roles):
                tt.add_term(order, specs, cum, coeff * lam)
            return
        int_orbs = sorted(set(o for o in roles_orbs if o < n_int))
        ext_orbs = sorted(set(o for o in roles_orbs if o >= n_int))
        slot_keys = int_orbs + ext_orbs
        pattern = tuple(tuple(r for r in range(n_roles)
                              if roles_orbs[r] == s) for s in slot_keys)
        n_ext = len(ext_orbs)
        m_int = len(int_orbs)
        for int_specs, ext_spec, cum, lam in _pattern_chains_big(
                pattern, n_roles, n_ext):
            slot_specs, subchain, kappa, dn_big = ext_spec
            name = "X%s|%s|%s" % (
                ",".join(str(o - n_int) for o in ext_orbs),
                ";".join("".join(e) + ":" + ",".join(map(str, ch))
                         for (e, ch) in slot_specs),
                ",".join(map(str, subchain)))
            if name not in bigred_cache:
                comp = None
                k_acc = dn_acc = 0
                for s, (elems, chain) in enumerate(slot_specs):
                    orb = ext_orbs[s] - n_int
                    c, k, dn = ext.spinor(orb, elems[0])
                    c = dict(c)
                    for j in range(1, len(elems)):
                        c2, k2, dn2 = ext.spinor(orb, elems[j])
                        c = couple_components(c, k, c2, k2, chain[j])
                        k = chain[j]
                        dn += dn2
                    if comp is None:
                        comp, k_acc, dn_acc = c, k, dn
                    else:
                        comp = couple_components(comp, k_acc, c, k,
                                                 subchain[s])
                        k_acc = subchain[s]
                        dn_acc += dn
                assert k_acc == kappa and dn_acc == dn_big
                red = ext.reduce(comp, kappa)
                bigred_cache[name] = red
                if red is not None:
                    tt._op(name, red, kappa, dn_big)
            if bigred_cache[name] is None:
                continue    # vanishes on the restricted external space
            tt.add_term(list(int_orbs) + [n_int],
                        list(int_specs) + [(name, kappa, dn_big)],
                        cum, coeff * lam)

    for i in range(K):
        for j in range(K):
            if abs(h1e[i, j]) > cutoff:
                emit((i, j), 2, h1e[i, j])
    if g2e is not None:
        for i in range(K):
            for j in range(K):
                for k in range(K):
                    for l in range(K):
                        v = g2e[i, j, k, l]
                        if abs(v) > cutoff:
                            emit((i, k, l, j), 4, 0.5 * v)
    return tt


# ---------------------------------------------------------------------------
# Bipartite compression into engine entries
# ---------------------------------------------------------------------------

def compile_su2_entries(tt: SU2TermTable, cutoff: float = 1e-14):
    """Compress the term table into per-site entries for SU2FermionDMRG via
    the bipartite minimum-vertex-cover pass (same algorithm as
    dmrg/mpo_builder.build_mpo).  Returns (site_entries, n_symbols,
    sym_dn, sym_rank, ops_registry)."""
    from ..core.qc_terms_fast import row_hashes
    from .mpo_builder import _min_vertex_cover

    opids, coeffs = tt.finalize()
    L = tt.L
    sh1, sh2 = row_hashes(opids)

    info = [tt.op_info[n] for n in tt.op_names]   # (rank, dN) per op id

    act_rows = np.arange(len(coeffs), dtype=np.int64)
    act_sym = np.zeros(len(coeffs), dtype=np.int64)
    act_coeff = coeffs.copy()

    sym_dn: Dict[int, int] = {0: 0}
    sym_rank: Dict[int, int] = {0: 0}
    n_symbols = 1
    site_entries: List[List[Tuple[int, int, str, float]]] = []

    for t in range(L):
        m = len(act_rows)
        assert m > 0
        ids_here = opids[act_rows, t].astype(np.int64)
        lk_pack = act_sym * (len(info) * _ID_BITS) + ids_here
        lk_vals, lk_idx = np.unique(lk_pack, return_inverse=True)
        lk_sym = lk_vals // (len(info) * _ID_BITS)
        lk_id = lk_vals % (len(info) * _ID_BITS)
        nl = len(lk_vals)

        if t + 1 < L:
            skey = np.ascontiguousarray(
                np.stack([sh1[act_rows, t + 1], sh2[act_rows, t + 1]],
                         axis=1)).view("V16").ravel()
            _, rk_first, rk_idx = np.unique(skey, return_index=True,
                                            return_inverse=True)
            rk_idx = rk_idx.ravel()
            nr = len(rk_first)
        else:
            rk_first = np.zeros(1, dtype=np.int64)
            rk_idx = np.zeros(m, dtype=np.int64)
            nr = 1

        e_pack = lk_idx * nr + rk_idx
        e_vals, e_inv = np.unique(e_pack, return_inverse=True)
        e_coeff = np.zeros(len(e_vals))
        np.add.at(e_coeff, e_inv.ravel(), act_coeff)
        e_l = (e_vals // nr).astype(np.int64)
        e_r = (e_vals % nr).astype(np.int64)

        if t == L - 1:
            cov_l = np.zeros(nl, dtype=bool)
            cov_r = np.ones(nr, dtype=bool)
        else:
            cov_l, cov_r = _min_vertex_cover(nl, nr, e_l, e_r)

        recv_r = np.zeros(nr, dtype=bool)
        free_edges = ~cov_l[e_l]
        recv_r[e_r[free_edges]] = True
        cov_r = cov_r & recv_r if t < L - 1 else cov_r

        def _id_parts(idv: int):
            op = tt.op_names[idv // _ID_BITS]
            k_in = (idv % _ID_BITS) // _NRANK
            k_out = idv % _NRANK
            return op, k_in, k_out

        new_sym_of_lk = np.full(nl, -1, dtype=np.int64)
        new_sym_of_rk = np.full(nr, -1, dtype=np.int64)
        for i in np.nonzero(cov_l)[0]:
            op, k_in, k_out = _id_parts(int(lk_id[i]))
            s = n_symbols
            n_symbols += 1
            new_sym_of_lk[i] = s
            sym_dn[s] = sym_dn[int(lk_sym[i])] + tt.op_info[op][1]
            sym_rank[s] = k_out
            assert sym_rank[int(lk_sym[i])] == k_in
        rk_dn: Dict[int, int] = {}
        for i in np.nonzero(cov_r)[0]:
            s = n_symbols
            n_symbols += 1
            new_sym_of_rk[i] = s

        entries: List[Tuple[int, int, str, float]] = []
        for i in np.nonzero(cov_l)[0]:
            op, _ki, _ko = _id_parts(int(lk_id[i]))
            entries.append((int(lk_sym[i]), int(new_sym_of_lk[i]), op, 1.0))
        for ei in np.nonzero(free_edges)[0]:
            li, ri = int(e_l[ei]), int(e_r[ei])
            o_sym = int(new_sym_of_rk[ri])
            assert o_sym >= 0
            op, k_in, k_out = _id_parts(int(lk_id[li]))
            dn_here = sym_dn[int(lk_sym[li])] + tt.op_info[op][1]
            if o_sym in rk_dn:
                assert rk_dn[o_sym] == dn_here
                assert sym_rank[o_sym] == k_out
            else:
                rk_dn[o_sym] = dn_here
                sym_dn[o_sym] = dn_here
                sym_rank[o_sym] = k_out
            assert sym_rank[int(lk_sym[li])] == k_in
            if abs(e_coeff[ei]) > cutoff:
                entries.append((int(lk_sym[li]), o_sym, op,
                                float(e_coeff[ei])))
        site_entries.append(entries)

        if t == L - 1:
            break
        left_terms = cov_l[lk_idx]
        nxt_rows, nxt_sym, nxt_coeff = [], [], []
        if np.any(left_terms):
            lt_rows = act_rows[left_terms]
            lt_sym = new_sym_of_lk[lk_idx[left_terms]]
            lt_rk = rk_idx[left_terms]
            lt_coeff = act_coeff[left_terms]
            pack = lt_sym * nr + lt_rk
            uvals, ufirst, uinv = np.unique(pack, return_index=True,
                                            return_inverse=True)
            ucoeff = np.zeros(len(uvals))
            np.add.at(ucoeff, uinv.ravel(), lt_coeff)
            keep = np.abs(ucoeff) > cutoff
            nxt_rows.append(lt_rows[ufirst[keep]])
            nxt_sym.append(uvals[keep] // nr)
            nxt_coeff.append(ucoeff[keep])
        r_live = np.nonzero(cov_r)[0]
        if len(r_live):
            nxt_rows.append(act_rows[rk_first[r_live]])
            nxt_sym.append(new_sym_of_rk[r_live])
            nxt_coeff.append(np.ones(len(r_live)))
        act_rows = np.concatenate(nxt_rows)
        act_sym = np.concatenate(nxt_sym).astype(np.int64)
        act_coeff = np.concatenate(nxt_coeff)

    # terminal bond must be a single scalar symbol with the largest id
    last_syms = set(o for (_i, o, _w, _c) in site_entries[-1])
    assert last_syms == {n_symbols - 1}, last_syms
    assert sym_rank.get(n_symbols - 1, 0) == 0
    sym_dn.setdefault(n_symbols - 1, 0)
    return site_entries, n_symbols, sym_dn, sym_rank, dict(tt.registry)


def su2_qc_dmrg(h1e: np.ndarray, g2e: Optional[np.ndarray] = None,
                ecore: float = 0.0, n_elec: Optional[int] = None,
                twos: int = 0, orb_sym: Optional[Sequence[int]] = None,
                ipg: int = 0, bond_dim: int = 200, seed: int = 7,
                iprint: int = 0, backend: str = "torch_tiled",
                exec_dtype=np.float64, device="cuda") -> SU2FermionDMRG:
    """Spin-adapted DMRG solver for an ab initio Hamiltonian (the SU2
    analog of driver.get_qc_mpo + dmrg; reference pyblock2 core.py:3282).
    On the card (K5 + K7) unless ``device="cpu"`` (the twins) or
    ``backend="numpy"`` (the host engine)."""
    K = h1e.shape[0]
    tt = qc_su2_term_table(h1e, g2e, ecore)
    entries, n_sym, dn, ranks, reg = compile_su2_entries(tt)
    return SU2FermionDMRG(
        K, entries, n_sym, dn,
        target=(K if n_elec is None else n_elec, twos, ipg),
        bond_dim=bond_dim, seed=seed, iprint=iprint, ops=reg,
        ranks=ranks, site_pgs=orb_sym, backend=backend,
        exec_dtype=exec_dtype, device=device)
