"""Spin-adapted (SU(2)) DMRG for spin chains, and the SU(2) coupling
factors of the spin-adapted engines.

Copied from block2_preview_tpu/dmrg/su2_spin.py (the port keeps its own
copy).  ``coupled_factor`` is the reduced element of a coupled operator
product on a Clebsch-Gordan-fused pair basis, which the fermionic engine
(``dmrg/su2_fermion.py``) and its blocking plans (``ops/su2blk.py``) bake
into their coefficients.

``SU2SpinDMRG`` generalizes the Heisenberg prototype to arbitrary site
spin s, arbitrary target total spin T, and an arbitrary reduced MPO given
as symbol entries (i, o, rank, site_reduced_element, coeff).  This is the
non-abelian sweep engine of block2's SU2 universe (reference
src/core/cg.hpp SU2CG; src/core/sparse_matrix.hpp ConnectionInfo 9j
recoupling) in the reduced-matrix (Wigner-Eckart) formulation, restricted
to one multiplet per site (spin chains).  It is host numpy with the port's
host Davidson (``ops/davidson.py``), as in the JAX package, which gives it
no device path: it launches no kernel.  Spin chains reach the card through
the driver's SAnySU2 mode instead (``set_symmetry_groups("SU2", "SU2")``,
which runs the fermionic engine on K5 and K7).

    e = SU2HeisenbergDMRG(16, bond_dim=64).solve(n_sweeps=6)
    e1 = SU2HeisenbergDMRG(6, bond_dim=40, tj_site=2).solve()  # spin 1

Conventions (doubled spins throughout):
  * <j' m'|T^k_q|j m> = <j m; k q|j' m'> <j'||T||j>
  * <(ja' jb') j'||[A^{k1} x B^{k2}]^k||(ja jb) j>
      = sqrt((2j+1)(2k+1)(2ja'+1)(2jb'+1))
        * 9j{ja jb j; k1 k2 k; ja' jb' j'} * <A> <B>
  * MPS tensors are plain reduced coefficients of fusion isometries
    (canonical gauge sum_jr B B^T = 1, unweighted)
  * multiplet density matrix rho(jL) = sum_jR psi psi^T / (2jL+1)
    for ANY target T (from sum_{mR,M} CG^2 = (2T+1)/(2jL+1))

Wavefunction sectors at a two-site center are independent (jL, jR) pairs
with triangle(jL, jR, T); sigma couples sectors through the cross factor
coupled_factor(jL, jR, T, k, k, 0, jL', jR', T).  There is no
center-wavefunction propagation: each center solves Davidson from a
deterministic random start; the variational fixed point is the same.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.clebsch_gordan import wigner_9j
from ..ops.davidson import davidson

__all__ = ["SU2HeisenbergDMRG", "SU2SpinDMRG", "coupled_factor",
           "heisenberg_entries", "spin_reduced_element"]


@lru_cache(maxsize=1 << 20)
def coupled_factor(ja, jb, j, k1, k2, k, jap, jbp, jp) -> float:
    """Reduced element of [A^{k1} x B^{k2}]^{k} on a CG-fused pair basis,
    divided by <A><B>.  Doubled spins.  Hot in the SU(2) QC engine
    (hundreds of thousands of lookups per sweep) — cached whole, not just
    the 9j part, to skip the sqrt arithmetic too."""
    return float(
        np.sqrt((j + 1.0) * (k + 1.0) * (jap + 1.0) * (jbp + 1.0))
        * wigner_9j(ja, jb, j, k1, k2, k, jap, jbp, jp))


def spin_reduced_element(tj: int = 1) -> float:
    """<s||S||s> = sqrt(s(s+1)); from <s s|Sz|s s> = s via Wigner-Eckart."""
    s = tj / 2.0
    return np.sqrt(s * (s + 1.0))


def heisenberg_entries(jcoup: float, tj_site: int = 1):
    """3-symbol MPO for H = J sum S_i.S_{i+1} = -sqrt(3) J sum [S x S]^0:
    symbols 0=I(rank 0), 1=S-pending(rank 2), 2=H(rank 0)."""
    red = spin_reduced_element(tj_site)
    return [(0, 0, 0, 1.0, 1.0),
            (0, 1, 2, red, 1.0),
            (1, 2, 2, red, -np.sqrt(3.0) * jcoup),
            (2, 2, 0, 1.0, 1.0)], 3


class SU2SpinDMRG:
    """Spin-adapted two-site DMRG on a chain of identical spin-s sites.

    entries: list of (in_symbol, out_symbol, rank_doubled, site_reduced,
    coeff); n_symbols: MPO width; boundary vectors are symbol 0 (left) and
    n_symbols-1 (right).  target_tj: doubled total spin of the state.
    """

    def __init__(self, L: int, entries, n_symbols: int, tj_site: int = 1,
                 target_tj: int = 0, bond_dim: int = 64, seed: int = 7,
                 iprint: int = 0):
        self.L = L
        self.entries = list(entries)
        self.n_sym = n_symbols
        self.tjs = tj_site
        self.T = target_tj
        self.D = bond_dim
        self.iprint = iprint
        # symbol ranks by propagation from the boundaries: the accumulated
        # operator flowing through symbol o has rank triangle(rank(i), k);
        # unique here because chain MPO symbols pair a pending rank-k
        # operator with its rank-k completion (total rank 0)
        self.rank: Dict[int, int] = {0: 0, n_symbols - 1: 0}
        changed = True
        while changed:
            changed = False
            for (i, o, k, _r, _c) in self.entries:
                if i in self.rank and o not in self.rank:
                    ki = self.rank[i]
                    ko = k if ki == 0 else (ki if k == 0 else None)
                    if ko is None:
                        raise ValueError(
                            "ambiguous symbol rank; set ranks explicitly")
                    self.rank[o] = ko
                    changed = True
        self.bonds = self._fci_bonds(L, bond_dim, tj_site, target_tj)
        rng = np.random.RandomState(seed)
        self.tensors: List[Dict[Tuple[int, int], np.ndarray]] = []
        for t in range(L):
            blk: Dict[Tuple[int, int], np.ndarray] = {}
            for jl, dl in self.bonds[t].items():
                for jr in self._fuse(jl):
                    dr = self.bonds[t + 1].get(jr, 0)
                    if dr:
                        blk[(jl, jr)] = rng.standard_normal((dl, dr))
            self.tensors.append(blk)
        self._canonicalize_right()
        self.lenvs: List[Optional[Dict]] = [None] * (L + 1)
        self.renvs: List[Optional[Dict]] = [None] * (L + 1)
        self.lenvs[0] = {0: {(0, 0): np.ones((1, 1))}}
        self.renvs[L] = {n_symbols - 1: {(target_tj, target_tj):
                                         np.ones((1, 1))}}
        for t in range(L - 1, 1, -1):
            self.renvs[t] = self._right_contract(t)
        self.energies: List[float] = []

    def _fuse(self, j: int) -> List[int]:
        return list(range(abs(j - self.tjs), j + self.tjs + 1, 2))

    def _fci_bonds(self, L, maxd, tjs, target):
        left = [{0: 1}]
        for t in range(L):
            nxt: Dict[int, int] = {}
            for j, m in left[t].items():
                for j2 in range(abs(j - tjs), j + tjs + 1, 2):
                    nxt[j2] = nxt.get(j2, 0) + m
            left.append(nxt)
        right: List[Optional[Dict[int, int]]] = [None] * (L + 1)
        right[L] = {target: 1}
        for t in range(L - 1, -1, -1):
            nxt = {}
            for j, m in right[t + 1].items():
                for j2 in range(abs(j - tjs), j + tjs + 1, 2):
                    nxt[j2] = nxt.get(j2, 0) + m
            right[t] = nxt
        bonds = []
        for t in range(L + 1):
            caps = {j: min(left[t][j], right[t][j])
                    for j in left[t] if j in right[t]}
            tot = sum(caps.values())
            if tot > maxd:
                caps = {j: max(1, int(round(c * maxd / tot)))
                        for j, c in caps.items()}
            bonds.append(caps)
        return bonds

    def _canonicalize_right(self):
        for t in range(self.L - 1, 0, -1):
            blk = self.tensors[t]
            by_jl: Dict[int, List] = {}
            for (jl, jr), b in blk.items():
                by_jl.setdefault(jl, []).append((jr, b))
            lmats = {}
            for jl, items in by_jl.items():
                items.sort(key=lambda x: x[0])
                m = np.concatenate([b for _, b in items], axis=1)
                q, r = np.linalg.qr(m.T)
                qt = q.T
                off = 0
                for (jr, b) in items:
                    blk[(jl, jr)] = qt[:, off:off + b.shape[1]]
                    off += b.shape[1]
                lmats[jl] = r.T
            prev = self.tensors[t - 1]
            for (jl, jr), b in list(prev.items()):
                if jr in lmats:
                    prev[(jl, jr)] = b @ lmats[jr]
                else:
                    del prev[(jl, jr)]

    # ------------------------------------------------------------------
    def _left_contract(self, t: int) -> Dict:
        env = self.lenvs[t]
        A = self.tensors[t]
        out: Dict[int, Dict[Tuple[int, int], np.ndarray]] = {}
        by_jl_b: Dict[int, List] = {}
        by_jl_k: Dict[int, List] = {}
        for (jl, jr), b in A.items():
            by_jl_b.setdefault(jl, []).append((jr, b))
            by_jl_k.setdefault(jl, []).append((jr, b))
        for (i, o, k_w, red, cf) in self.entries:
            e = env.get(i)
            if e is None:
                continue
            k_i, k_o = self.rank[i], self.rank[o]
            for (jlb, jlk), eb in e.items():
                for (jrb, ab) in by_jl_b.get(jlb, ()):
                    for (jrk, ak) in by_jl_k.get(jlk, ()):
                        fac = coupled_factor(jlk, self.tjs, jrk, k_i, k_w,
                                             k_o, jlb, self.tjs, jrb)
                        if abs(fac) < 1e-14:
                            continue
                        d = out.setdefault(o, {})
                        key = (jrb, jrk)
                        contrib = (fac * red * cf) * (ab.T @ eb @ ak)
                        d[key] = d.get(key, 0) + contrib
        return out

    def _right_contract(self, t: int) -> Dict:
        env = self.renvs[t + 1]
        B = self.tensors[t]
        out: Dict[int, Dict[Tuple[int, int], np.ndarray]] = {}
        by_jr: Dict[int, List] = {}
        for (jl, jr), b in B.items():
            by_jr.setdefault(jr, []).append((jl, b))
        for (i, o, k_w, red, cf) in self.entries:
            e = env.get(o)
            if e is None:
                continue
            k_i, k_o = self.rank[i], self.rank[o]
            for (jrb2, jrk2), eb in e.items():
                for (jlb, bb) in by_jr.get(jrb2, ()):
                    for (jlk, bk) in by_jr.get(jrk2, ()):
                        fac = coupled_factor(self.tjs, jrk2, jlk, k_w, k_o,
                                             k_i, self.tjs, jrb2, jlb)
                        if abs(fac) < 1e-14:
                            continue
                        d = out.setdefault(i, {})
                        key = (jlb, jlk)
                        contrib = (fac * red * cf) * (bb @ eb @ bk.T)
                        d[key] = d.get(key, 0) + contrib
        return out

    # ------------------------------------------------------------------
    def bonds_actual(self, t: int, side: str = "left") -> Dict[int, int]:
        if t == 0:
            return {0: 1}
        if t == self.L:
            return {self.T: 1}
        dims: Dict[int, int] = {}
        if side == "left":
            for (jl, jr), b in self.tensors[t - 1].items():
                dims[jr] = b.shape[1]
        else:
            for (jl, jr), b in self.tensors[t].items():
                dims[jl] = b.shape[0]
        return dims

    def _effective(self, t: int):
        env_l = self.lenvs[t]
        env_r = self.renvs[t + 2]
        bond_l = self.bonds_actual(t, "left")
        bond_r = self.bonds_actual(t + 2, "right")
        fl: Dict[int, List[Tuple[int, int, int]]] = {}
        for jl, d in sorted(bond_l.items()):
            for jL in self._fuse(jl):
                runs = fl.setdefault(jL, [])
                off = sum(r[2] for r in runs)
                runs.append((jl, off, d))
        fr: Dict[int, List[Tuple[int, int, int]]] = {}
        for jr2, d in sorted(bond_r.items()):
            for jR in self._fuse(jr2):
                runs = fr.setdefault(jR, [])
                off = sum(r[2] for r in runs)
                runs.append((jr2, off, d))
        # The target spin T lives on an inert right-boundary multiplet
        # (abelian-style: target charge at the right vacuum) and the TOTAL
        # object is a singlet, which forces the physical state to transform
        # as T.  Singlet coupling => sectors are (jL, jR) with jR == jL.
        keys: List[Tuple[int, int]] = [(j, j) for j in sorted(fl)
                                       if j in fr]
        dims = {k: (sum(r[2] for r in fl[k[0]]),
                    sum(r[2] for r in fr[k[1]])) for k in keys}
        offsets = {}
        off = 0
        for k in keys:
            offsets[k] = off
            off += dims[k][0] * dims[k][1]
        size = off

        LW = self._assemble_lw(env_l, fl)
        RW = self._assemble_rw(env_r, fr)
        cross: Dict[Tuple[Tuple[int, int], Tuple[int, int], int], float] = {}
        ranks = sorted(set(self.rank.values()))
        for kb in keys:
            for kk in keys:
                for km in ranks:
                    c = coupled_factor(kk[0], kk[1], 0, km, km, 0,
                                       kb[0], kb[1], 0)
                    if abs(c) > 1e-14:
                        cross[(kb, kk, km)] = c

        def matvec(x):
            psi = {k: x[offsets[k]:offsets[k] + dims[k][0] * dims[k][1]]
                   .reshape(dims[k]) for k in keys}
            sig = {k: np.zeros(dims[k]) for k in keys}
            for m, lw in LW.items():
                rw = RW.get(m)
                if rw is None:
                    continue
                km = self.rank[m]
                for (jLb, jLk), lb in lw.items():
                    for (jRb, jRk), rb in rw.items():
                        c = cross.get(((jLb, jRb), (jLk, jRk), km))
                        if c is None or (jLk, jRk) not in psi:
                            continue
                        sig[(jLb, jRb)] += c * (lb @ psi[(jLk, jRk)] @ rb.T)
            out = np.zeros(size)
            for k in keys:
                out[offsets[k]:offsets[k] + sig[k].size] = sig[k].ravel()
            return out

        diag = np.zeros(size)
        for m, lw in LW.items():
            rw = RW.get(m)
            if rw is None:
                continue
            km = self.rank[m]
            for k in keys:
                lb = lw.get((k[0], k[0]))
                rb = rw.get((k[1], k[1]))
                c = cross.get((k, k, km))
                if lb is None or rb is None or c is None:
                    continue
                o = offsets[k]
                diag[o:o + dims[k][0] * dims[k][1]] += \
                    (c * np.diag(lb)[:, None] * np.diag(rb)[None, :]).ravel()
        return keys, dims, offsets, size, fl, fr, matvec, diag

    def _assemble_lw(self, env_l, fl):
        LW: Dict[int, Dict[Tuple[int, int], np.ndarray]] = {}
        for (i, m, k_w, red, cf) in self.entries:
            e = env_l.get(i)
            if e is None:
                continue
            k_i, k_m = self.rank[i], self.rank[m]
            for (jlb, jlk), eb in e.items():
                for jLb in self._fuse(jlb):
                    if jLb not in fl:
                        continue
                    ob = dict((r[0], (r[1], r[2])) for r in fl[jLb])
                    if jlb not in ob:
                        continue
                    for jLk in self._fuse(jlk):
                        if jLk not in fl:
                            continue
                        ok = dict((r[0], (r[1], r[2])) for r in fl[jLk])
                        if jlk not in ok:
                            continue
                        fac = coupled_factor(jlk, self.tjs, jLk, k_i, k_w,
                                             k_m, jlb, self.tjs, jLb)
                        if abs(fac) < 1e-14:
                            continue
                        o1, d1 = ob[jlb]
                        o2, d2 = ok[jlk]
                        dm = LW.setdefault(m, {})
                        blk = dm.get((jLb, jLk))
                        if blk is None:
                            blk = np.zeros((sum(r[2] for r in fl[jLb]),
                                            sum(r[2] for r in fl[jLk])))
                            dm[(jLb, jLk)] = blk
                        blk[o1:o1 + d1, o2:o2 + d2] += (fac * red * cf) * eb
        return LW

    def _assemble_rw(self, env_r, fr):
        RW: Dict[int, Dict[Tuple[int, int], np.ndarray]] = {}
        for (m, o, k_w, red, cf) in self.entries:
            e = env_r.get(o)
            if e is None:
                continue
            k_m, k_o = self.rank[m], self.rank[o]
            for (jr2b, jr2k), eb in e.items():
                for jRb in self._fuse(jr2b):
                    if jRb not in fr:
                        continue
                    ob = dict((r[0], (r[1], r[2])) for r in fr[jRb])
                    if jr2b not in ob:
                        continue
                    for jRk in self._fuse(jr2k):
                        if jRk not in fr:
                            continue
                        ok = dict((r[0], (r[1], r[2])) for r in fr[jRk])
                        if jr2k not in ok:
                            continue
                        fac = coupled_factor(self.tjs, jr2k, jRk, k_w, k_o,
                                             k_m, self.tjs, jr2b, jRb)
                        if abs(fac) < 1e-14:
                            continue
                        o1, d1 = ob[jr2b]
                        o2, d2 = ok[jr2k]
                        dm = RW.setdefault(m, {})
                        blk = dm.get((jRb, jRk))
                        if blk is None:
                            blk = np.zeros((sum(r[2] for r in fr[jRb]),
                                            sum(r[2] for r in fr[jRk])))
                            dm[(jRb, jRk)] = blk
                        blk[o1:o1 + d1, o2:o2 + d2] += (fac * red * cf) * eb
        return RW

    # ------------------------------------------------------------------
    def sweep(self, forward: bool, dav_thrd: float = 1e-9) -> float:
        L = self.L
        emin = np.inf
        rng = range(L - 1) if forward else range(L - 2, -1, -1)
        for t in rng:
            keys, dims, offsets, size, fl, fr, matvec, diag = \
                self._effective(t)
            x0 = np.random.RandomState(11 + t).standard_normal(size)
            x0 /= np.linalg.norm(x0)
            w, v, nmv = davidson(matvec, diag, x0, conv_thrd=dav_thrd,
                                 max_iter=150, max_subspace=25)
            emin = min(emin, float(w[0]))
            psi = {k: v[offsets[k]:offsets[k] + dims[k][0] * dims[k][1],
                        0].reshape(dims[k]) for k in keys}
            if forward:
                rhos: Dict[int, np.ndarray] = {}
                for (jL, jR), p in psi.items():
                    r = p @ p.T / (jL + 1.0)
                    rhos[jL] = rhos.get(jL, 0) + r
                self._decimate_update(t, rhos, fl, forward=True)
            else:
                rhos = {}
                for (jL, jR), p in psi.items():
                    r = p.T @ p / (jR + 1.0)
                    rhos[jR] = rhos.get(jR, 0) + r
                self._decimate_update(t, rhos, fr, forward=False)
            if self.iprint >= 2:
                print(f"  su2 {'-->' if forward else '<--'} site {t:3d} "
                      f"E = {w[0]:.10f} nmv={nmv}")
        self.energies.append(emin)
        return emin

    def _decimate_update(self, t, rhos, fused, forward):
        eigs = []
        vecs = {}
        for j, r in rhos.items():
            ww, vv = np.linalg.eigh(r)
            vecs[j] = vv
            eigs += [(float(x), j, i) for i, x in enumerate(ww)]
        eigs.sort(key=lambda z: -z[0])
        kept: Dict[int, List[int]] = {}
        budget = self.D
        for (x, j, i) in eigs:
            if budget <= 0 or x <= 1e-14:
                break
            kept.setdefault(j, []).append(i)
            budget -= 1
        new_tensor: Dict[Tuple[int, int], np.ndarray] = {}
        for j, idxs in kept.items():
            vmat = vecs[j][:, idxs]
            for (jx, off, d) in fused[j]:
                if forward:
                    new_tensor[(jx, j)] = vmat[off:off + d, :]
                else:
                    new_tensor[(j, jx)] = vmat[off:off + d, :].T
        if forward:
            self.tensors[t] = new_tensor
            self.lenvs[t + 1] = self._left_contract(t)
            for u in range(t + 2, self.L + 1):
                self.lenvs[u] = None
            for u in range(t + 1, -1, -1):
                self.renvs[u] = None
        else:
            self.tensors[t + 1] = new_tensor
            self.renvs[t + 1] = self._right_contract(t + 1)
            for u in range(t, -1, -1):
                self.renvs[u] = None
            for u in range(t + 1, self.L + 1):
                self.lenvs[u] = None
            self.lenvs[0] = {0: {(0, 0): np.ones((1, 1))}}

    def solve(self, n_sweeps: int = 8, tol: float = 1e-9) -> float:
        last = np.inf
        forward = True
        for i in range(n_sweeps):
            e = self.sweep(forward)
            if self.iprint >= 1:
                print(f"su2 sweep {i}: E = {e:.12f}")
            if abs(e - last) < tol:
                break
            last = e
            forward = not forward
        return self.energies[-1]


class SU2HeisenbergDMRG(SU2SpinDMRG):
    """H = J sum S_i.S_{i+1} on spin-(tj_site/2) sites, singlet target."""

    def __init__(self, L: int, j_coupling: float = 1.0, bond_dim: int = 64,
                 tj_site: int = 1, target_tj: int = 0, seed: int = 7,
                 iprint: int = 0):
        entries, n_sym = heisenberg_entries(j_coupling, tj_site)
        super().__init__(L, entries, n_sym, tj_site=tj_site,
                         target_tj=target_tj, bond_dim=bond_dim, seed=seed,
                         iprint=iprint)
