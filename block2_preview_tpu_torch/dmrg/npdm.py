"""Arbitrary-order N-particle density matrices via determinant-space
reconstruction.

The reference evaluates high-order PDMs with the symbol-free NPDM-scheme
machinery (reference src/dmrg/general_npdm.hpp:43, spin_permutation.hpp:1843,
driver get_npdm pyblock2/driver/core.py:5504).  High orders (4PDM+) are only
ever feasible over small active spaces; there the route is to
reconstruct the exact CI vector from the MPS (a few-thousand-determinant
sector at most) and evaluate

    dmk[i1..ik, j1..jk] = sum_sigma  <c+_{i1 s1} .. c+_{ik sk}
                                      c_{j1 sk} .. c_{jk s1}>

with one dense GEMM: all annihilation strings c_{a1}..c_{ak}|psi> over sorted
spin-orbital combos become rows of a matrix W, the Gram matrix G = W W^H holds
every antisymmetrized matrix element, and spatial-orbital spin summation is a
vectorized gather with permutation signs.  Index/spin conventions follow the
conventional engine in expect.py (pdm2_spatial matches data/N2.STO3G.2PDM;
pdm3_spatial matches pyblock2 get_npdm pdm_type=3).

Low orders (1-3) over large lattices stay on the prefix-cached sweep engine
(expect.py); this module is the high-order / small-active-space complement,
and the two overlap on orders 1-3 for cross-validation.

Copied from block2_preview_tpu/dmrg/npdm.py (the port keeps its own copy).
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.symmetry import QN
from .mps import MPS


# ----------------------------------------------------------------------
# CI vector reconstruction
# ----------------------------------------------------------------------

def mps_to_civec(mps: MPS) -> Tuple[np.ndarray, np.ndarray]:
    """Exact CI expansion of an SZ-mode MPS.

    Returns (dets, coefs): dets is an [nd] int64 array of occupation
    bitmasks over spin orbitals ordered (0a, 0b, 1a, 1b, ...) — the
    Jordan-Wigner order of the site bases (ops/local_ops.py) — and coefs
    the corresponding coefficients <det|psi>.  Determinants are the
    ascending-creation-order product states, matching the standard FCI
    phase convention.  Intended for small L (full sector enumeration).
    """
    g = mps.group
    L = mps.n_sites
    # frontier: {ql: (coef matrix [n_prefix, D], det bitmasks [n_prefix])}
    front: Dict[QN, Tuple[np.ndarray, np.ndarray]] = {
        g.zero: (np.ones((1, 1)), np.zeros(1, dtype=np.int64))}
    # site state -> (alpha occ, beta occ); basis order |0>,|a>,|b>,|2>
    occ_bits = [(0, 0), (1, 0), (0, 1), (1, 1)]
    for t in range(L):
        quanta = mps.info.site_quanta[t]
        nf: Dict[QN, List[Tuple[np.ndarray, np.ndarray]]] = {}
        for p, qp in enumerate(quanta):
            oa, ob = occ_bits[p] if len(quanta) == 4 else (p, 0)
            bits = (oa << (2 * t)) | (ob << (2 * t + 1))
            for ql, (mat, dets) in front.items():
                qr = g.add(ql, qp)
                b = mps.tensors[t].blocks.get((ql, qp, qr))
                if b is None:
                    continue
                m = b.reshape(b.shape[0], b.shape[2])
                nf.setdefault(qr, []).append((mat @ m, dets | bits))
        front = {}
        for qr, parts in nf.items():
            D = parts[0][0].shape[1]
            mat = np.concatenate([x[0] for x in parts], axis=0)
            dets = np.concatenate([x[1] for x in parts])
            keep = np.abs(mat).max(axis=1) > 0
            front[qr] = (mat[keep], dets[keep])
    out = front.get(mps.info.target)
    if out is None:
        return np.zeros(0, dtype=np.int64), np.zeros(0)
    mat, dets = out
    return dets, mat[:, 0]


# ----------------------------------------------------------------------
# determinant algebra (vectorized bit tricks)
# ----------------------------------------------------------------------

def _parity_below(dets: np.ndarray, orb: int) -> np.ndarray:
    """(-1)^(number of occupied spin orbitals below `orb`) per det."""
    mask = (np.int64(1) << orb) - 1
    x = dets & mask
    # vectorized popcount
    cnt = np.zeros_like(x)
    while np.any(x):
        cnt += x & 1
        x >>= 1
    return 1 - 2 * (cnt & 1)


def _apply_annihilations(dets: np.ndarray, coefs: np.ndarray,
                         orbs: Sequence[int]
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """c_{a1} c_{a2} ... c_{ak} |psi>, rightmost first (standard operator
    order): returns (dets', coefs') with zero rows dropped."""
    d, c = dets, coefs.copy()
    for a in reversed(list(orbs)):
        bit = np.int64(1) << a
        keep = (d & bit) != 0
        d = d[keep]
        c = c[keep]
        if len(d) == 0:
            break
        c = c * _parity_below(d, a)
        d = d & ~bit
    return d, c


class _SectorMap:
    """Maps determinant bitmasks of one (na, nb) sector to dense indices."""

    def __init__(self):
        self.maps: Dict[Tuple[int, int], Tuple[np.ndarray, int]] = {}

    def index(self, key, dets: np.ndarray) -> Tuple[np.ndarray, int]:
        ent = self.maps.get(key)
        if ent is None:
            raise KeyError(key)
        table, n = ent
        return np.searchsorted(table, dets), n

    def build(self, key, all_dets: np.ndarray) -> None:
        table = np.unique(all_dets)
        self.maps[key] = (table, len(table))


def _counts(det_list: np.ndarray) -> np.ndarray:
    x = det_list.copy()
    cnt = np.zeros_like(x)
    while np.any(x):
        cnt += x & 1
        x >>= 1
    return cnt


def _apply_all_combos(dets: np.ndarray, coefs: np.ndarray,
                      combos: np.ndarray
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
    return [_apply_annihilations(dets, coefs, row.tolist())
            for row in combos]


def _embed(res_dets, n_beta, smap: _SectorMap, dtype) -> np.ndarray:
    """Embed per-combo (dets, coefs) string results into dense rows using
    shared per-sector index tables (combos removing different spin counts
    land in disjoint sectors; cross-sector Gram entries are masked out by
    the caller)."""
    dim = max((n for (_t, n) in smap.maps.values()), default=1)
    W = np.zeros((len(res_dets), max(dim, 1)), dtype=dtype)
    for i, (d, c) in enumerate(res_dets):
        if len(d) == 0:
            continue
        ix, _n = smap.index(int(n_beta[i]), d)
        np.add.at(W[i], ix, c.astype(dtype, copy=False))
    return W


def _perm_sign_and_rank(tuples: np.ndarray, combo_rank: Dict[int, int],
                        L2: int) -> Tuple[np.ndarray, np.ndarray]:
    """For each row (ordered spin-orbital tuple): sign of the permutation
    sorting it ascending and the rank of the sorted combo; rows with
    duplicate entries get rank -1."""
    n, k = tuples.shape
    order = np.argsort(tuples, axis=1, kind="stable")
    srt = np.take_along_axis(tuples, order, axis=1)
    dup = np.any(srt[:, 1:] == srt[:, :-1], axis=1)
    # permutation parity of `order` rows (k <= 6: count inversions)
    inv = np.zeros(n, dtype=np.int64)
    for a in range(k):
        for b in range(a + 1, k):
            inv += (order[:, a] > order[:, b])
    sign = 1 - 2 * (inv & 1)
    # encode sorted tuple
    enc = np.zeros(n, dtype=np.int64)
    for a in range(k):
        enc = enc * L2 + srt[:, a]
    rank = np.array([combo_rank.get(int(e), -1) for e in enc])
    rank[dup] = -1
    return sign, rank


def npdm_spatial(mps: MPS, order: int, bra: Optional[MPS] = None
                 ) -> np.ndarray:
    """Spatial k-PDM (k = order) with the block2 spatial convention
    (reference pyblock2 get_npdm npdm convention, core.py:5504):

    dmk[i1..ik, j1..jk] = sum_{s1..sk} <bra| c+_{i1 s1} .. c+_{ik sk}
                                             c_{j1 sk} .. c_{jk s1} |ket>
    """
    k = order
    L = mps.n_sites
    L2 = 2 * L
    dets_k, coef_k = mps_to_civec(mps)
    if bra is None:
        dets_b, coef_b = dets_k, coef_k
    else:
        dets_b, coef_b = mps_to_civec(bra)

    combos = np.array(list(combinations(range(L2), k)), dtype=np.int64)
    combo_rank: Dict[int, int] = {}
    for i, row in enumerate(combos):
        e = 0
        for a in row:
            e = e * L2 + int(a)
        combo_rank[e] = i

    n_beta = (combos & 1).sum(axis=1)
    res_k = _apply_all_combos(dets_k, coef_k, combos)
    res_b = res_k if bra is None else _apply_all_combos(dets_b, coef_b,
                                                        combos)
    # shared per-sector index tables over bra and ket results
    smap = _SectorMap()
    for key in np.unique(n_beta):
        allk = [r[0] for r, nb in zip(res_k, n_beta)
                if nb == key and len(r[0])]
        allk += [r[0] for r, nb in zip(res_b, n_beta)
                 if nb == key and len(r[0])]
        smap.build(int(key), np.concatenate(allk) if allk
                   else np.zeros(0, dtype=np.int64))
    dtype = np.result_type(coef_k.dtype, coef_b.dtype)
    Wk = _embed(res_k, n_beta, smap, dtype)
    Wb = Wk if bra is None else _embed(res_b, n_beta, smap, dtype)
    # Gram matrix; zero cross-sector blocks explicitly
    G = Wb.conj() @ Wk.T
    mask = n_beta[:, None] != n_beta[None, :]
    G[mask] = 0.0
    return gram_to_spatial(G, combos, L, k)


def gram_to_spatial(G: np.ndarray, combos: np.ndarray, L: int, k: int
                    ) -> np.ndarray:
    """Scatter the combo Gram matrix G[A, B] = <bra| c+_{a_k}..c+_{a_1}
    c_{b_1}..c_{b_k} |ket> (A, B ascending-sorted spin-orbital k-tuples,
    `combos` row order) into the spatial k-PDM.  Shared by the
    determinant (npdm_spatial) and pooled-sweep (npdm_scheme) engines."""
    L2 = 2 * L
    combo_rank: Dict[int, int] = {}
    for i, row in enumerate(combos):
        e = 0
        for a in row:
            e = e * L2 + int(a)
        combo_rank[e] = i
    # reversal phase: <c+_{a1}..c+_{ak} c_{b1}..c_{bk}>
    #   = (-1)^(k(k-1)/2) <(c_{a1}..c_{ak}) bra | (c_{b1}..c_{bk}) ket>
    G = G * (1 - 2 * ((k * (k - 1) // 2) & 1))

    dm = np.zeros((L,) * (2 * k), dtype=G.dtype)
    grid = np.stack(np.meshgrid(*([np.arange(L)] * k), indexing="ij"),
                    axis=-1).reshape(-1, k)          # [L^k, k]
    for spat in range(1 << k):
        sig = [(spat >> m) & 1 for m in range(k)]
        # creation tuple a_m = 2 i_m + s_m
        A = 2 * grid + np.array(sig, dtype=np.int64)[None, :]
        # annihilation tuple b_m = 2 j_m + s_{k+1-m}
        B = 2 * grid + np.array(sig[::-1], dtype=np.int64)[None, :]
        sgA, rkA = _perm_sign_and_rank(A, combo_rank, L2)
        sgB, rkB = _perm_sign_and_rank(B, combo_rank, L2)
        okA = rkA >= 0
        okB = rkB >= 0
        blk = G[np.ix_(np.where(okA, rkA, 0), np.where(okB, rkB, 0))]
        blk = blk * (sgA * okA)[:, None] * (sgB * okB)[None, :]
        dm += blk.reshape((L,) * (2 * k))
    return dm


def pdm4_spatial(mps: MPS, bra: Optional[MPS] = None) -> np.ndarray:
    """Spatial 4PDM (reference get_npdm pdm_type=4)."""
    return npdm_spatial(mps, 4, bra=bra)
