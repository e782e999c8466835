"""SAny custom symmetry with non-abelian SU(2) factors (SAnySU2 mode).

Counterpart of the reference's SAnySU2 custom-Hamiltonian
route (src/core/symmetry.hpp:58 SAnyT with SU2 sub-groups,
src/dmrg/general_hamiltonian.hpp GeneralHamiltonian over coupled
expression strings, and the `set_symmetry_groups("U1Fermi", "SU2",
"SU2")` examples of docs/source/tutorial/custom-hamiltonians.ipynb —
t-J and SU(2) Hubbard models).

Design: instead of porting the reference's CG-bookkeeping operator
algebra, every user term — a coupled expression string such as
``"((C+D)2+(C+D)2)0"`` over per-site REDUCED operator matrices — is
*machine-compiled* into the site-ordered left-nested chains the
spin-adapted sweep engine (su2_fermion.SU2FermionDMRG) executes:

1.  The expression parses into a binary coupling tree whose leaves are
    user operators with definite spin rank (inferred from the reduced
    matrix's multiplet connectivity, or given explicitly).
2.  The term's *dense* scalar component is built on the model space of
    its distinct sites: reduced matrices expand to m-resolved components
    by Wigner-Eckart, fermionic leaves carry Jordan-Wigner parity
    strings over earlier slots, and tree nodes CG-couple component
    dicts with plain matrix products.
3.  Candidate site-ordered chains (all on-site internal couplings x all
    cumulative rank chains) are evaluated densely with *exactly* the
    sweep engine's graded coupled-product rule, and the expansion
    coefficients come from a least-squares solve whose residual is
    asserted ~ 0 — the same machine-verified recoupling strategy as
    dmrg/su2_qc.py, generalized from the fixed fermion site to
    arbitrary user multiplet bases.

The compiled SU2TermTable then rides the unmodified spin-adapted
bipartite MPO compiler + sweep engine (including the device executors).

Copied from block2_preview_tpu/dmrg/sany_su2.py (the port keeps its own
copy).  It is host numpy: the compiled entries run on the engine of
dmrg/su2_fermion.py, whose environment blocking is kernel K5 and whose
sigma products are kernel K7 on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.clebsch_gordan import clebsch_gordan
from .su2_qc import SU2TermTable

__all__ = ["parse_coupled", "SAnySU2Hamil", "SiteSpaceSU2",
           "compile_sany_su2_term_table", "infer_op_quanta"]

_KMAX = 3  # doubled-rank cap of the packed term-table ids (su2_qc._NRANK)


# ---------------------------------------------------------------------------
# coupled expression strings
# ---------------------------------------------------------------------------

def parse_coupled(expr: str):
    """Parse ``"((C+D)2+(C+D)2)0"`` into a coupling tree.

    Returns (tree, leaves): tree nodes are ``("op", letter)`` leaves or
    ``("cpl", left, right, k2)`` with doubled target rank k2; leaves is
    the list of operator letters in reading order."""
    pos = 0
    leaves: List[str] = []

    def rec():
        nonlocal pos
        if expr[pos] == "(":
            pos += 1
            a = rec()
            assert expr[pos] == "+", f"expected + at {pos} in {expr!r}"
            pos += 1
            b = rec()
            assert expr[pos] == ")", f"expected ) at {pos} in {expr!r}"
            pos += 1
            d0 = pos
            while pos < len(expr) and expr[pos].isdigit():
                pos += 1
            assert pos > d0, f"missing rank after ) in {expr!r}"
            return ("cpl", a, b, int(expr[d0:pos]))
        ch = expr[pos]
        pos += 1
        leaves.append(ch)
        return ("op", ch)

    tree = rec()
    assert pos == len(expr), f"trailing characters in {expr!r}"
    return tree, leaves


# ---------------------------------------------------------------------------
# site spaces: multiplet bases expanded to m-resolved states
# ---------------------------------------------------------------------------

class SiteSpaceSU2:
    """A site's multiplet basis [(N, 2S, pg)] expanded to |mult, m>."""

    def __init__(self, mults: Sequence[Tuple[int, int, int]]):
        self.mults = [tuple(int(x) for x in m) for m in mults]
        # m-resolved states (multiplet index, doubled m)
        self.states = [(im, tm)
                       for im, (_n, ts, _p) in enumerate(self.mults)
                       for tm in range(-ts, ts + 1, 2)]
        self.dim = len(self.states)
        # fermion parity (-1)^N per state, the JW/grading Z
        self.z = np.array([(-1.0) ** (self.mults[im][0] % 2)
                           for im, _tm in self.states])

    def full(self, red: np.ndarray, k2: int) -> Dict[int, np.ndarray]:
        """m-resolved components {2q: dense} of a rank-k2 reduced matrix
        via Wigner-Eckart (the convention of su2_qc
        _reduced_from_components: full = CG(2Sk, k2, 2Sb) * red)."""
        out = {tq: np.zeros((self.dim, self.dim))
               for tq in range(-k2, k2 + 1, 2)}
        for ib, (imb, tmb) in enumerate(self.states):
            for ik, (imk, tmk) in enumerate(self.states):
                r = red[imb, imk]
                if r == 0.0:
                    continue
                tq = tmb - tmk
                if abs(tq) > k2:
                    continue
                cg = clebsch_gordan(self.mults[imk][1], k2,
                                    self.mults[imb][1], tmk, tq, tmb)
                out[tq][ib, ik] = cg * r
        return out

    def reduced(self, comp: Dict[int, np.ndarray], k2: int
                ) -> Optional[np.ndarray]:
        """Inverse of full(); None if identically zero; raises if the
        components are not a well-formed rank-k2 tensor."""
        nm = len(self.mults)
        red = np.zeros((nm, nm))
        have = np.zeros((nm, nm), dtype=bool)
        for tq, mat in comp.items():
            for ib, (imb, tmb) in enumerate(self.states):
                for ik, (imk, tmk) in enumerate(self.states):
                    v = mat[ib, ik]
                    cg = clebsch_gordan(self.mults[imk][1], k2,
                                        self.mults[imb][1], tmk, tq, tmb)
                    if abs(cg) < 1e-14:
                        if abs(v) > 1e-10:
                            raise ValueError(
                                f"not a rank-{k2} tensor (|{v}| at "
                                f"forbidden element)")
                        continue
                    r = v / cg
                    if have[imb, imk]:
                        if abs(r - red[imb, imk]) > 1e-8 * max(
                                1.0, abs(red[imb, imk])):
                            raise ValueError("Wigner-Eckart violated")
                    else:
                        red[imb, imk] = r
                        have[imb, imk] = True
        if np.max(np.abs(red)) < 1e-13:
            return None
        return red


def infer_op_quanta(red: np.ndarray, space: SiteSpaceSU2,
                    n_of_mult: Sequence[int]) -> Tuple[int, int]:
    """Infer (doubled rank, dN) of a reduced operator matrix from its
    multiplet connectivity.  dN must be uniform over nonzeros; the rank
    is the smallest k2 >= max|d2S| with the fermion parity of dN.
    Rank-ambiguous operators (all-diagonal in S with even dN, e.g. a
    bare spin operator) need an explicit rank."""
    nz = np.argwhere(np.abs(red) > 0)
    if len(nz) == 0:
        raise ValueError("all-zero operator matrix")
    dns = {n_of_mult[b] - n_of_mult[k] for b, k in nz}
    if len(dns) != 1:
        raise ValueError(f"non-uniform particle-number change {dns}")
    dn = dns.pop()
    d2s = max(abs(space.mults[b][1] - space.mults[k][1]) for b, k in nz)
    k2 = d2s
    if k2 % 2 != abs(dn) % 2:
        k2 += 1
    return k2, dn


# ---------------------------------------------------------------------------
# dense model-space evaluation
# ---------------------------------------------------------------------------

def _embed_leaf(comp: Dict[int, np.ndarray], slot: int, dn: int,
                spaces: Sequence[SiteSpaceSU2]) -> Dict[int, np.ndarray]:
    """Embed a single-site component dict on the model space of all
    slots, with a Jordan-Wigner parity string over earlier slots for
    fermionic (odd-dN) operators."""
    odd = abs(dn) % 2 == 1
    out = {}
    for tq, mat in comp.items():
        acc = np.ones((1, 1))
        for s, sp in enumerate(spaces):
            if s < slot:
                acc = np.kron(acc, np.diag(sp.z) if odd
                              else np.eye(sp.dim))
            elif s == slot:
                acc = np.kron(acc, mat)
            else:
                acc = np.kron(acc, np.eye(sp.dim))
        out[tq] = acc
    return out


def _cpl_components(a: Dict[int, np.ndarray], ka: int,
                    b: Dict[int, np.ndarray], kb: int, k: int
                    ) -> Dict[int, np.ndarray]:
    """[A x B]^k via CG-weighted matrix products (operators already
    embedded on the same space, so grading is in the matrices)."""
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


def _tree_dense(tree, leaf_data, spaces) -> Tuple[Dict[int, np.ndarray],
                                                  int, int]:
    """Dense components of the coupled tree on the model space.
    leaf_data: iterator of (slot, comp, k2, dn) consumed in leaf order.
    Returns (components, k2, dn)."""
    if tree[0] == "op":
        slot, comp, k2, dn = next(leaf_data)
        return _embed_leaf(comp, slot, dn, spaces), k2, dn
    _, tl, tr, k2 = tree
    ca, ka, da = _tree_dense(tl, leaf_data, spaces)
    cb, kb, db = _tree_dense(tr, leaf_data, spaces)
    return _cpl_components(ca, ka, cb, kb, k2), k2, da + db


def _couple_site(a: Dict[int, np.ndarray], ka: int,
                 b: Dict[int, np.ndarray], kb: int, k: int
                 ) -> Dict[int, np.ndarray]:
    # on-site composite: plain products, CG-coupled (su2_qc
    # _couple_onsite generalized to arbitrary site dims)
    return _cpl_components(a, ka, b, kb, k)


def _chain_dense_g(slot_comps, slot_zs, cum) -> np.ndarray:
    """Dense scalar component of the site-ordered graded chain
    [[W_1 x W_2]^{K_1} x ...]^0 using the sweep engine's rule
    [A x B] -> (A Z^{p_B}) (x) B (su2_qc._chain_dense generalized to
    per-slot spaces)."""
    acc = {0: np.ones((1, 1))}
    k_acc = 0
    zprev = np.ones(1)
    for s, (comp, kw, dnw) in enumerate(slot_comps):
        ko = cum[s]
        pw = abs(dnw) % 2
        dim = acc[next(iter(acc))].shape[0]
        wdim = next(iter(comp.values())).shape[0]
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
        zprev = np.kron(zprev, slot_zs[s])
    assert k_acc == 0
    return acc[0]


# ---------------------------------------------------------------------------
# the Hamiltonian handle + term compiler
# ---------------------------------------------------------------------------

class SAnySU2Hamil:
    """Custom SU(2) Hamiltonian: per-site multiplet bases + reduced ops.

    site_mults[t]: [(N, 2S, pg)] multiplets; site_opdefs[t]: {letter:
    (reduced matrix, doubled rank, dN)}.  The driver front
    (DMRGDriver.get_custom_hamiltonian in SAnySU2 mode) builds this from
    reference-style (site_basis, site_ops) arguments."""

    def __init__(self, site_mults, site_opdefs):
        self.L = len(site_mults)
        self.site_mults = [list(ms) for ms in site_mults]
        self.spaces = [SiteSpaceSU2(ms) for ms in self.site_mults]
        self.site_opdefs = site_opdefs
        # homogeneous chains share composite names (and their registry
        # entries); heterogeneous ones tag names with the site index
        self.homogeneous = all(
            set(d) == set(site_opdefs[0])
            and all(d[k][1:] == site_opdefs[0][k][1:]
                    and np.array_equal(d[k][0], site_opdefs[0][k][0])
                    for k in d)
            for d in site_opdefs) and len(
                {tuple(map(tuple, ms)) for ms in self.site_mults}) == 1
        self._chain_cache: Dict = {}

    # -- candidate on-site composites -----------------------------------
    def _site_composites(self, t: int, letters: Tuple[str, ...]):
        key = (t if not self.homogeneous else -1, letters)
        hit = self._chain_cache.get(key)
        if hit is not None:
            return hit
        sp = self.spaces[t]
        defs = self.site_opdefs[t]
        comp0, k0, dn0 = (sp.full(defs[letters[0]][0], defs[letters[0]][1]),
                          defs[letters[0]][1], defs[letters[0]][2])
        opts = [((k0,), comp0, k0, dn0)]
        for ch in letters[1:]:
            red_w, kw, dnw = defs[ch]
            w = sp.full(red_w, kw)
            nxt = []
            for chain, comp, k, dn in opts:
                for ko in range(abs(k - kw), min(k + kw, _KMAX) + 1, 2):
                    c2 = _couple_site(comp, k, w, kw, ko)
                    nxt.append((chain + (ko,), c2, ko, dn + dnw))
            opts = nxt
        out = []
        for chain, comp, k, dn in opts:
            try:
                red = sp.reduced(comp, k)
            except ValueError:
                continue
            if red is None:
                continue
            tag = "" if self.homogeneous else f"@{t}"
            name = (letters[0] + tag if len(letters) == 1 else
                    "".join(letters) + ";" + ",".join(map(str, chain[1:]))
                    + tag)
            out.append((name, chain, comp, red, k, dn))
        self._chain_cache[key] = out
        return out

    # -- one term -> site-ordered chains --------------------------------
    def compile_term(self, tt: SU2TermTable, expr: str,
                     idx: Sequence[int], coeff: float) -> None:
        """Add ``coeff * expr(idx)`` to the term table.  idx is one group
        of site indices (len == number of leaves in expr)."""
        if not expr:
            tt.add_const(float(coeff))
            return
        tree, letters = parse_coupled(expr)
        assert len(idx) == len(letters), \
            f"{expr!r} has {len(letters)} operators, got {len(idx)} indices"
        sites = sorted(set(int(i) for i in idx))
        slot_of = {s: j for j, s in enumerate(sites)}
        spaces = [self.spaces[s] for s in sites]

        # dense target: leaves consumed in reading order
        leaf_iter = iter([
            (slot_of[int(i)],
             self.spaces[int(i)].full(self.site_opdefs[int(i)][ch][0],
                                      self.site_opdefs[int(i)][ch][1]),
             self.site_opdefs[int(i)][ch][1],
             self.site_opdefs[int(i)][ch][2])
            for ch, i in zip(letters, idx)])
        target_c, k_tot, _dn_tot = _tree_dense(tree, leaf_iter, spaces)
        assert k_tot == 0, \
            f"MPO terms must have total rank 0, got {k_tot} for {expr!r}"
        target = target_c[0].ravel()
        if np.max(np.abs(target)) < 1e-14:
            return

        # candidates: per-slot on-site composites x cumulative chains
        slot_letters = [tuple(ch for ch, i in zip(letters, idx)
                              if int(i) == s) for s in sites]
        slot_opts = [self._site_composites(s, ls)
                     for s, ls in zip(sites, slot_letters)]
        cands: List[Tuple] = []

        def rec(j, chosen, cum):
            if j == len(sites):
                if cum[-1] == 0:
                    cands.append((tuple(chosen), tuple(cum[1:])))
                return
            for opt in slot_opts[j]:
                k = opt[4]
                for ko in range(abs(cum[-1] - k),
                                min(cum[-1] + k, _KMAX) + 1, 2):
                    rec(j + 1, chosen + [opt], cum + [ko])

        rec(0, [], [0])
        if not cands:
            raise ValueError(f"no coupled chains for {expr!r} at {idx}")
        slot_zs = [sp.z for sp in spaces]
        cols = np.stack(
            [_chain_dense_g([(o[2], o[4], o[5]) for o in specs],
                            slot_zs, cum).ravel()
             for specs, cum in cands], axis=1)
        lam, _res, _rk, _sv = np.linalg.lstsq(cols, target, rcond=None)
        resid = np.linalg.norm(cols @ lam - target)
        if resid > 1e-9 * max(1.0, np.linalg.norm(target)):
            raise ValueError(
                f"term {expr!r} at {idx}: chain expansion residual "
                f"{resid:.2e} — the on-site composite span is incomplete")
        for (specs, cum), lv in zip(cands, lam):
            if abs(lv) < 1e-12:
                continue
            for (name, _chain, _comp, red, k, dn) in specs:
                if name not in tt.registry:
                    tt.registry[name] = (red, k, dn)
            tt.add_term(sites,
                        [(o[0], o[4], o[5]) for o in specs],
                        cum, float(coeff) * float(lv))


def compile_sany_su2_term_table(ham: SAnySU2Hamil,
                                terms: Sequence[Tuple[str, Sequence[int],
                                                      float]],
                                const_e: float = 0.0) -> SU2TermTable:
    """Build the spin-adapted term table for a list of
    (expr, flat_indices, coeff) entries.  Reference-style flat index
    lists covering several repetitions of the expression are split into
    groups (pyblock2 ExprBuilder.add_term semantics)."""
    tt = SU2TermTable(ham.L)
    tt.add_const(const_e)
    for expr, idx, coeff in terms:
        _tree, letters = parse_coupled(expr) if expr else (None, [])
        n = len(letters)
        if n == 0:
            tt.add_const(float(coeff))
            continue
        idx = list(idx)
        assert len(idx) % n == 0, \
            f"index list length {len(idx)} not a multiple of {n}"
        for g in range(0, len(idx), n):
            ham.compile_term(tt, expr, idx[g:g + n], coeff)
    return tt
