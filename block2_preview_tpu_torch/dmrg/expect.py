"""Expectation values: MPO expectations and operator-string sweeps (PDMs).

Counterpart of block2's Expect driver and the conventional
1PDM/2PDM machinery (reference src/dmrg/sweep_algorithm.hpp:5280 Expect,
src/dmrg/qc_pdm1.hpp:40 PDM1MPOQC, qc_pdm2.hpp:62 PDM2MPOQC).  Instead of
hand-coded PDM MPOs, density-matrix elements are evaluated as operator-string
expectations over the MPS with prefix-cached transfer environments — the same
O(K^2 L D^3)-ish complexity class, with the per-string transfer being the
identical blocked GEMM kernel the sweep engine uses.

Conventions match the reference: 1PDM dm[s, i, j] = <c+_{i,s} c_{j,s}>;
spatial 2PDM dm2[i, j, k, l] = sum_{s,t} <c+_{i,s} c+_{j,t} c_{k,t} c_{l,s}>
(reference pyblock2 get_npdm / unit_test/test_npdm_n2_sto3g.cpp:703-760).

Copied from block2_preview_tpu/dmrg/expect.py (the port keeps its own
copy); the transfers run on the port's host environments.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.expr import RawTerm, term_row
from ..core.symmetry import QN
from ..ops.local_ops import (CRE_A, CRE_B, DES_A, DES_B, OpRegistry)
from .environment import MovingEnvironment
from .mpo import MPO
from .mps import MPS

EnvBlocks = Dict[Tuple[QN, QN], np.ndarray]


def mpo_expectation(mpo: MPO, ket: MPS, bra: Optional[MPS] = None) -> float:
    """<bra|MPO|ket> by full left contraction (reference
    effective_hamiltonian.hpp:721 expect)."""
    me = MovingEnvironment(mpo, ket, bra=bra)
    L = mpo.n_sites
    for t in range(L):
        me.update_left(t)
    env = me.left_envs[L]
    target = ket.info.target
    val = 0.0
    for sym, bm in env.items():
        blk = bm.blocks.get((target, target))
        if blk is not None:
            val += blk[0, 0]
    if mpo.const_e != 0.0:
        val += mpo.const_e * mps_overlap(bra or ket, ket)
    val = complex(val)
    return val if abs(val.imag) > 1e-10 * max(abs(val.real), 1.0) \
        else float(val.real)


def mps_overlap(bra: MPS, ket: MPS) -> float:
    """<bra|ket> via identity transfer (complex preserved when the
    imaginary part is significant)."""
    g = bra.group
    e: EnvBlocks = {(g.zero, g.zero): np.ones((1, 1))}
    for t in range(bra.n_sites):
        e = _transfer_identity(e, bra.tensors[t], ket.tensors[t])
    target = ket.info.target
    val = complex(e.get((target, target), np.zeros((1, 1)))[0, 0])
    return val if abs(val.imag) > 1e-10 * max(abs(val.real), 1.0) \
        else float(val.real)


def _transfer_identity(e: EnvBlocks, Tb, Tk) -> EnvBlocks:
    out: EnvBlocks = {}
    for (qb, qk), eb in e.items():
        for (qlb, qpb, qrb), bb in Tb.blocks.items():
            if qlb != qb:
                continue
            mb = bb.reshape(bb.shape[0], bb.shape[2]).conj()
            for (qlk, qpk, qrk), bk in Tk.blocks.items():
                if qlk != qk or qpk != qpb:
                    continue
                mk = bk.reshape(bk.shape[0], bk.shape[2])
                key = (qrb, qrk)
                contrib = mb.T @ eb @ mk
                if key in out:
                    out[key] += contrib
                else:
                    out[key] = contrib
    return out


class StringExpectation:
    """Prefix-cached evaluation of <bra| operator-string |ket> for many
    strings sharing prefixes (the conventional-NPDM evaluation engine).

    With bra=None this is <psi|...|psi>; passing a different bra gives
    transition matrix elements (reference Expect::get_1pdm with bra != ket,
    pyblock2 get_trans_1pdm)."""

    def __init__(self, mps: MPS, bra: Optional[MPS] = None):
        self.g = mps.group
        self.L = mps.n_sites
        self.same = bra is None

        def _lcanon(src: MPS) -> MPS:
            # left-canonical copy: gauge change only, state preserved
            m = MPS(src.info, [t for t in src.tensors], src.center)
            m.tensors = [type(t)(t.group, dict(t.blocks))
                         for t in src.tensors]
            for t in range(self.L - 1):
                m.left_canonicalize_site(t)
            return m

        self.mps = _lcanon(mps)
        self.bra = self.mps if self.same else _lcanon(bra)
        self.registry = OpRegistry()
        self.site_quanta = mps.info.site_quanta
        self.target = mps.info.target
        self.bra_target = self.bra.info.target
        # right identity environments R[t] at every bond
        self.renvs: List[EnvBlocks] = [None] * (self.L + 1)
        self.renvs[self.L] = {(self.bra_target, self.target):
                              np.ones((1, 1))}
        for t in range(self.L - 1, -1, -1):
            self.renvs[t] = self._transfer_right_identity(
                self.renvs[t + 1], self.bra.tensors[t], self.mps.tensors[t])
        if self.same:
            self._ovlp = 1.0
        else:
            r0 = self.renvs[0].get((self.g.zero, self.g.zero))
            self._ovlp = float(r0[0, 0]) if r0 is not None else 0.0

    def _transfer_right_identity(self, e: EnvBlocks, Tb, Tk) -> EnvBlocks:
        out: EnvBlocks = {}
        kblocks = list(Tk.blocks.items())
        for (qb2, qk2), eb in e.items():
            for (qlb, qpb, qrb), bb in Tb.blocks.items():
                if qrb != qb2:
                    continue
                mb = bb.reshape(bb.shape[0], bb.shape[2]).conj()
                for (qlk, qpk, qrk), bk in kblocks:
                    if qrk != qk2 or qpk != qpb:
                        continue
                    mk = bk.reshape(bk.shape[0], bk.shape[2])
                    key = (qlb, qlk)
                    contrib = mb @ eb @ mk.T
                    if key in out:
                        out[key] += contrib
                    else:
                        out[key] = contrib
        return out

    def _transfer_op(self, e: Optional[EnvBlocks], t: int,
                     opmat: np.ndarray) -> EnvBlocks:
        """One site left-to-right transfer with a 4x4 site operator.
        e=None means 'exact identity environment' (left-canonical prefix)."""
        T = self.mps.tensors[t]
        Tb = self.bra.tensors[t]
        quanta = self.site_quanta[t]
        if e is None:
            # materialize identity on the bond-t basis; valid for t > 0
            # only when bra == ket (left-canonical prefix = identity env)
            assert self.same or t == 0
            dims: Dict[QN, int] = {}
            if t == 0:
                dims[self.g.zero] = 1
            else:
                for (ql, qp, qr), b in self.mps.tensors[t - 1].blocks.items():
                    dims[qr] = max(dims.get(qr, 0), b.shape[2])
            e = {(q, q): np.eye(d) for q, d in dims.items()}
        out: EnvBlocks = {}
        bidx: Dict[Tuple[QN, int], Tuple[QN, np.ndarray]] = {}
        for (ql, qp, qr), b in T.blocks.items():
            for p, q in enumerate(quanta):
                if q == qp:
                    bidx[(ql, p)] = (qr, b.reshape(b.shape[0], b.shape[2]))
        if self.same:
            bidx_b = bidx
        else:
            bidx_b = {}
            for (ql, qp, qr), b in Tb.blocks.items():
                for p, q in enumerate(quanta):
                    if q == qp:
                        bidx_b[(ql, p)] = (qr,
                                           b.reshape(b.shape[0], b.shape[2]))
        for pb, pk in zip(*np.nonzero(opmat)):
            w = opmat[pb, pk]
            for (qb, qk), eb in e.items():
                xb = bidx_b.get((qb, int(pb)))
                xk = bidx.get((qk, int(pk)))
                if xb is None or xk is None:
                    continue
                qrb, mb = xb
                qrk, mk = xk
                key = (qrb, qrk)
                contrib = w * (mb.conj().T @ eb @ mk)
                if key in out:
                    out[key] += contrib
                else:
                    out[key] = contrib
        return out

    def _close(self, e: Optional[EnvBlocks], t: int) -> float:
        """Contract an environment at bond t with the right identity env."""
        if e is None:
            # identity operator: <bra|ket>
            return self._ovlp
        r = self.renvs[t]
        val = 0.0
        for key, eb in e.items():
            rb = r.get(key)
            if rb is not None:
                val += float(np.sum(eb * rb))
        return val

    def evaluate(self, raw_terms: Sequence[RawTerm]) -> np.ndarray:
        """Expectations of many operator strings with prefix caching."""
        rows = []
        metas = []
        for i, (coeff, ops) in enumerate(raw_terms):
            res = term_row(self.L, coeff, ops, self.registry)
            if res is None:
                rows.append(None)
                metas.append(None)
                continue
            c, row = res
            nz = np.nonzero(row != OpRegistry.ID_I)[0]
            last = int(nz[-1]) if len(nz) else -1
            rows.append((c, tuple(int(x) for x in row), last))
        order = sorted((i for i in range(len(rows)) if rows[i] is not None),
                       key=lambda i: rows[i][1])
        vals = np.zeros(len(raw_terms))
        prev_key: Tuple[int, ...] = ()
        valid_upto = 0   # stack entries <= valid_upto agree with prev_key
        stack: List[Optional[EnvBlocks]] = [None] * (self.L + 1)
        # stack[t] = env after processing sites < t (None = identity)
        for i in order:
            c, key, last = rows[i]
            if last < 0:
                vals[i] = c * self._ovlp
                continue
            # common prefix with previous processed row
            cp = 0
            while cp < len(prev_key) and cp < len(key) \
                    and key[cp] == prev_key[cp]:
                cp += 1
            cp = min(cp, last + 1, valid_upto)
            # env at bond cp is valid; process sites cp..last
            e = stack[cp] if cp > 0 else None
            for t in range(cp, last + 1):
                opid = key[t]
                if e is None and opid == OpRegistry.ID_I and self.same:
                    stack[t + 1] = None
                    continue
                e = self._transfer_op(e, t, self.registry[opid])
                stack[t + 1] = e
            vals[i] = c * self._close(stack[last + 1], last + 1)
            prev_key = key
            valid_upto = last + 1
        return vals


# ----------------------------------------------------------------------
def pdm1(mps: MPS, orb_sym: Optional[np.ndarray] = None,
         bra: Optional[MPS] = None) -> np.ndarray:
    """Spin-resolved 1PDM dm[s, i, j] = <bra| c+_{i,s} c_{j,s} |ket>
    (reference Expect::get_1pdm, sweep_algorithm.hpp).  With bra given this
    is the transition 1PDM (reference pyblock2 get_trans_1pdm); note the
    matrix is then NOT symmetric, so both orderings are evaluated."""
    L = mps.n_sites
    eng = StringExpectation(mps, bra=bra)
    spins = ((CRE_A, DES_A), (CRE_B, DES_B))
    terms = []
    idx = []
    same = bra is None
    for s in (0, 1):
        cre, des = spins[s]
        for i in range(L):
            for j in range(i if same else 0, L):
                if orb_sym is not None and \
                        (int(orb_sym[i]) ^ int(orb_sym[j])) != 0:
                    continue
                terms.append((1.0, [(i, cre), (j, des)]))
                idx.append((s, i, j))
    vals = eng.evaluate(terms)
    dm = np.zeros((2, L, L))
    for (s, i, j), v in zip(idx, vals):
        dm[s, i, j] = v
        if same:
            dm[s, j, i] = v
    return dm


def pdm2_spatial(mps: MPS, orb_sym: Optional[np.ndarray] = None,
                 assume_singlet: bool = True,
                 bra: Optional[MPS] = None) -> np.ndarray:
    """Spatial 2PDM dm2[i,j,k,l] = sum_{s,t} <c+_{i,s} c+_{j,t} c_{k,t} c_{l,s}>
    (reference Expect::get_2pdm_spatial convention, checked against
    data/N2.STO3G.2PDM in unit_test/test_npdm_n2_sto3g.cpp:760).  With bra
    given this is the transition 2PDM."""
    L = mps.n_sites
    eng = StringExpectation(mps, bra=bra)
    dm2 = np.zeros((L, L, L, L))
    # spin sectors: (s,t) in {aa, ab, ba, bb}; for singlet Sz=0 states
    # aa == bb and ab == ba under spin flip
    spin_pairs = [((CRE_A, CRE_A, DES_A, DES_A), 2.0 if assume_singlet else 1.0),
                  ((CRE_A, CRE_B, DES_B, DES_A), 2.0 if assume_singlet else 1.0)]
    if not assume_singlet:
        spin_pairs += [((CRE_B, CRE_B, DES_B, DES_B), 1.0),
                       ((CRE_B, CRE_A, DES_A, DES_B), 1.0)]
    for (c1, c2, d2, d1), weight in spin_pairs:
        terms = []
        idx = []
        for i in range(L):
            for j in range(L):
                for k in range(L):
                    for l in range(L):
                        if orb_sym is not None and \
                                (int(orb_sym[i]) ^ int(orb_sym[j]) ^
                                 int(orb_sym[k]) ^ int(orb_sym[l])) != 0:
                            continue
                        terms.append((1.0, [(i, c1), (j, c2),
                                            (k, d2), (l, d1)]))
                        idx.append((i, j, k, l))
        vals = eng.evaluate(terms)
        for (i, j, k, l), v in zip(idx, vals):
            dm2[i, j, k, l] += weight * v
    return dm2


def pdm3_spatial(mps: MPS, bra: Optional[MPS] = None) -> np.ndarray:
    """Spatial 3PDM
    dm3[i,j,k,l,m,n] = sum_{s,t,u} <c+_{i,s} c+_{j,t} c+_{k,u}
                                    c_{l,u} c_{m,t} c_{n,s}>
    (reference get_3pdm_spatial convention, pyblock2/driver/core.py npdm
    with pdm_type=3).  Conventional-NPDM evaluation; O(L^6 * 8) strings,
    intended for small active spaces — the reference's fast NPDM scheme
    (src/dmrg/npdm.hpp) is future work."""
    L = mps.n_sites
    eng = StringExpectation(mps, bra=bra)
    dm3 = np.zeros((L,) * 6)
    ops = ((CRE_A, DES_A), (CRE_B, DES_B))
    for s in (0, 1):
        for t in (0, 1):
            for u in (0, 1):
                terms, idx = [], []
                for i in range(L):
                    for j in range(L):
                        for k in range(L):
                            for l in range(L):
                                for m in range(L):
                                    for n in range(L):
                                        terms.append(
                                            (1.0,
                                             [(i, ops[s][0]), (j, ops[t][0]),
                                              (k, ops[u][0]), (l, ops[u][1]),
                                              (m, ops[t][1]),
                                              (n, ops[s][1])]))
                                        idx.append((i, j, k, l, m, n))
                vals = eng.evaluate(terms)
                for ix, v in zip(idx, vals):
                    dm3[ix] += v
    return dm3


# ----------------------------------------------------------------------
def npc1(mps: MPS, kind: str = "charge",
         orb_sym: Optional[np.ndarray] = None) -> np.ndarray:
    """One-particle correlation matrices <N_i N_j> (charge) or <Sz_i Sz_j>
    (spin) — the NPC1MPOQC analog (reference src/dmrg/qc_ncorr.hpp:43)."""
    L = mps.n_sites
    eng = StringExpectation(mps)
    terms, idx = [], []
    for i in range(L):
        for j in range(L):
            for (ei, si) in ((CRE_A, 1.0), (CRE_B, 1.0 if kind == "charge"
                             else -1.0)):
                di = DES_A if ei == CRE_A else DES_B
                for (ej, sj) in ((CRE_A, 1.0), (CRE_B,
                                 1.0 if kind == "charge" else -1.0)):
                    dj = DES_A if ej == CRE_A else DES_B
                    w = si * sj * (1.0 if kind == "charge" else 0.25)
                    terms.append((w, [(i, ei), (i, di), (j, ej), (j, dj)]))
                    idx.append((i, j))
    vals = eng.evaluate(terms)
    out = np.zeros((L, L))
    for (i, j), v in zip(idx, vals):
        out[i, j] += v
    return out


def _matrix_unit_decomposition(spec=None):
    """Express each single-site matrix unit E_{pr} = |p><r| as an exact
    polynomial in the elementary fermion operators: E_{pr} = sum_k c_k P_k
    with P_k a product of elementary ops (by id).  Derived numerically: a
    greedy independent set of short products spans the full local operator
    algebra, then a 16x16 solve.  Returns {(p, r): [(coeff, (ids...)), ...]}.
    """
    from itertools import product as iproduct
    from ..ops.local_ops import SZ_SITE
    spec = spec or SZ_SITE
    d = spec.dim
    n_elem = len(spec.elem_mats)
    combos: List[Tuple[Tuple[int, ...], np.ndarray]] = [((), np.eye(d))]
    for ln in range(1, 5):
        for ids in iproduct(range(n_elem), repeat=ln):
            m = spec.elem_mats[ids[0]]
            for e in ids[1:]:
                m = m @ spec.elem_mats[e]
            if np.any(m):
                combos.append((ids, m))
    # greedy linearly-independent subset, shortest products first
    basis: List[Tuple[Tuple[int, ...], np.ndarray]] = []
    gs: List[np.ndarray] = []
    for ids, m in combos:
        v = m.ravel().astype(float)
        r = v.copy()
        for b in gs:
            r = r - (b @ v) * b
        if np.linalg.norm(r) > 1e-9:
            basis.append((ids, m))
            gs.append(r / np.linalg.norm(r))
        if len(basis) == d * d:
            break
    A = np.stack([m.ravel() for _, m in basis], axis=1)
    out = {}
    for p in range(d):
        for r in range(d):
            unit = np.zeros((d, d))
            unit[p, r] = 1.0
            c = np.linalg.solve(A, unit.ravel())
            out[(p, r)] = [(float(ck), basis[k][0])
                           for k, ck in enumerate(c) if abs(ck) > 1e-12]
    return out


def orbital_entropy_2site(mps: MPS) -> Tuple[np.ndarray, np.ndarray]:
    """Two-orbital von Neumann entropies S2[i, j] and mutual information
    I[i, j] = (S1[i] + S1[j] - S2[i, j]) / 2 (reference
    pyblock2/driver/core.py get_orbital_entropies ij_symm=2 /
    get_orbital_interaction_matrix; Rissler-Legeza convention with
    Jordan-Wigner-dressed operator expectations).

    The two-orbital RDM rho[(p,q),(r,s)] = <E^i_{pr} E^j_{qs}> is evaluated
    by expanding matrix units in elementary fermion operators, so the JW
    phase between the two orbitals is included exactly."""
    L = mps.n_sites
    g = mps.group
    eng = StringExpectation(mps)
    quanta = mps.info.site_quanta[0]
    d = len(quanta)
    decomp = _matrix_unit_decomposition()
    s1 = orbital_entropy_1site(mps)
    s2 = np.zeros((L, L))
    for i in range(L):
        for j in range(i + 1, L):
            terms, meta = [], []
            for p in range(d):
                for r in range(d):
                    dq_i = g.sub(quanta[p], quanta[r])
                    for q in range(d):
                        for s in range(d):
                            # conservation: q_p + q_q == q_r + q_s
                            if g.add(dq_i, g.sub(quanta[q],
                                                 quanta[s])) != g.zero:
                                continue
                            for (ci, opsi) in decomp[(p, r)]:
                                for (cj, opsj) in decomp[(q, s)]:
                                    ops = [(i, e) for e in opsi] + \
                                          [(j, e) for e in opsj]
                                    if not ops:
                                        terms.append(None)
                                    else:
                                        terms.append((ci * cj, ops))
                                    meta.append((p, q, r, s, ci * cj))
            flat = [t for t in terms if t is not None]
            vals = iter(eng.evaluate(flat))
            rho = np.zeros((d * d, d * d))
            for t, (p, q, r, s, c) in zip(terms, meta):
                v = c if t is None else next(vals)
                rho[p * d + q, r * d + s] += v
            rho = (rho + rho.T) / 2.0
            tr = np.trace(rho)
            if tr > 0:
                rho = rho / tr
            w = np.clip(np.linalg.eigvalsh(rho), 1e-300, 1.0)
            s2[i, j] = s2[j, i] = float(-(w * np.log(w)).sum())
    minfo = 0.5 * (s1[:, None] + s1[None, :] - s2)
    np.fill_diagonal(minfo, 0.0)
    np.fill_diagonal(s2, s1)
    return s2, minfo


def orbital_entropy_1site(mps: MPS) -> np.ndarray:
    """One-orbital von Neumann entropies (reference
    pyblock2/driver/core.py:9262 OrbitalEntropy / get_orbital_entropies)."""
    L = mps.n_sites
    eng = StringExpectation(mps)
    terms, idx = [], []
    for i in range(L):
        # <n_a>, <n_b>, <n_a n_b>
        terms.append((1.0, [(i, CRE_A), (i, DES_A)]))
        terms.append((1.0, [(i, CRE_B), (i, DES_B)]))
        terms.append((1.0, [(i, CRE_A), (i, DES_A), (i, CRE_B),
                            (i, DES_B)]))
        idx.append(i)
    vals = eng.evaluate(terms).reshape(L, 3)
    ent = np.zeros(L)
    for i in range(L):
        na, nb, nab = vals[i]
        probs = np.array([1 - na - nb + nab, na - nab, nb - nab, nab])
        probs = np.clip(probs, 1e-300, 1.0)
        ent[i] = float(-(probs * np.log(probs)).sum())
    return ent
