"""Vectorized quantum-chemistry term-table generation for large orbital counts.

The generic ``qc_raw_terms`` + ``term_row`` path loops over terms in Python —
fine for K <= 16 but hopeless for Cr2/SVP (K = 42, ~12M spin-resolved 2e
terms).  This module produces the identical packed TermTable with numpy
array programming: stable-argsort site ordering, permutation-parity lookup
tables, run-length site-grouping patterns, and a precomputed
(operator-sequence, JW-parity) -> registry-id product table.

This is the replacement for the C++ term machinery behind block2's
GeneralFCIDUMP/GeneralMPO expression processing (reference
src/core/integral_general.hpp:45, general_mpo.hpp:152).

Copied from block2_preview_tpu/core/qc_terms_fast.py (the port keeps its own copy).
"""

from __future__ import annotations

from itertools import product as iproduct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .expr import TermTable, qc_raw_terms, build_term_table
from .fcidump import FCIDUMP
from .symmetry import SZ_GROUP, SymmetryGroup
from ..ops.local_ops import (CRE_A, CRE_B, DES_A, DES_B, OpRegistry, SZ_SITE,
                             SiteBasisSpec)


def _perm_parity_lut() -> np.ndarray:
    """Parity of each packed 4-permutation (perm packed base-4)."""
    lut = np.zeros(256, dtype=np.int8)
    from itertools import permutations
    for perm in permutations(range(4)):
        inv = sum(1 for a in range(4) for b in range(a + 1, 4)
                  if perm[a] > perm[b])
        code = perm[0] + 4 * perm[1] + 16 * perm[2] + 64 * perm[3]
        lut[code] = 1 if (inv & 1) else 0
    return lut


def _product_table(spec: SiteBasisSpec, registry: OpRegistry
                   ) -> Dict[Tuple[Tuple[int, ...], int], int]:
    """(ordered elementary-op sequence, parity flag) -> registry id (-1 dead)."""
    table: Dict[Tuple[Tuple[int, ...], int], int] = {}
    codes = sorted(spec.elem_mats.keys())
    for ln in (1, 2, 3, 4):
        for seq in iproduct(codes, repeat=ln):
            mat = spec.elem_mats[seq[0]]
            for c in seq[1:]:
                mat = mat @ spec.elem_mats[c]
            for par in (0, 1):
                m2 = mat @ spec.parity if par else mat
                table[(seq, par)] = (registry.register(m2)
                                     if np.any(m2) else -1)
    return table


def qc_term_table_fast(fd: FCIDUMP, group: SymmetryGroup = SZ_GROUP,
                       cutoff: float = 1e-13,
                       spec: SiteBasisSpec = SZ_SITE,
                       chunk: int = 500_000) -> TermTable:
    """Vectorized equivalent of qc_term_table for RHF integrals in SZ mode."""
    assert not fd.uhf, "fast path: RHF integrals (use generic path for UHF)"
    L = fd.n_sites
    registry = spec.registry()
    ptab = _product_table(spec, registry)
    parity_lut = _perm_parity_lut()

    # 1e terms via the generic path (K^2 x 2, cheap)
    one_e = [(c, ops) for (c, ops) in qc_raw_terms(
        FCIDUMP(n_sites=L, n_elec=fd.n_elec, twos=fd.twos,
                orb_sym=fd.orb_sym, h1e=fd.h1e,
                g2e=np.zeros((1, 1, 1, 1))), cutoff)]
    base = build_term_table(L, one_e, group=group, registry=registry,
                            spec=spec, cutoff=cutoff)
    rows_list = [base.opids.astype(np.uint8)]
    coeff_list = [base.coeffs]

    g2e = fd.g2e
    idx = np.nonzero(np.abs(g2e) > cutoff)
    vals = g2e[idx]
    ii, jj, kk, ll = (np.asarray(x, dtype=np.int64) for x in idx)
    if fd.orb_sym is not None and np.any(fd.orb_sym):
        # drop point-group-violating integral noise (the reference's
        # symmetry-adapted loops never generate these terms)
        pg = np.asarray(fd.orb_sym, dtype=np.int64)
        keep = (pg[ii] ^ pg[jj] ^ pg[kk] ^ pg[ll]) == 0
        ii, jj, kk, ll, vals = ii[keep], jj[keep], kk[keep], ll[keep], \
            vals[keep]
    nv = len(vals)

    spin_combos = [(CRE_A, DES_A, CRE_A, DES_A), (CRE_B, DES_B, CRE_B, DES_B),
                   (CRE_A, DES_A, CRE_B, DES_B), (CRE_B, DES_B, CRE_A, DES_A)]

    for (cre_s, des_s, cre_t, des_t) in spin_combos:
        codes4 = np.array([cre_s, cre_t, des_t, des_s], dtype=np.int64)
        for lo in range(0, nv, chunk):
            hi = min(lo + chunk, nv)
            n = hi - lo
            S = np.stack([ii[lo:hi], kk[lo:hi], ll[lo:hi], jj[lo:hi]],
                         axis=1)                       # [n,4] sites
            C = np.broadcast_to(codes4, (n, 4))
            order = np.argsort(S, axis=1, kind="stable")
            Ss = np.take_along_axis(S, order, axis=1)
            Cs = np.take_along_axis(C, order, axis=1)
            packed = (order[:, 0] + 4 * order[:, 1] + 16 * order[:, 2]
                      + 64 * order[:, 3])
            sign = np.where(parity_lut[packed] == 1, -1.0, 1.0)
            coeffs = 0.5 * vals[lo:hi] * sign

            # adjacency equalities -> run pattern id (0..7)
            e01 = Ss[:, 0] == Ss[:, 1]
            e12 = Ss[:, 1] == Ss[:, 2]
            e23 = Ss[:, 2] == Ss[:, 3]
            pat = e01.astype(np.int64) + 2 * e12 + 4 * e23

            # JW parity of pass-through columns: #ops at sites > col, mod 2
            cols = np.arange(L, dtype=np.int64)
            cnt_le = (Ss[:, :, None] <= cols[None, None, :]).sum(axis=1)
            par_mask = ((4 - cnt_le) & 1).astype(np.uint8)
            rows = par_mask            # Z=ID_Z=1 where odd, I=0 where even
            rows = rows.copy()

            alive = np.ones(n, dtype=bool)
            # for each pattern: runs of equal sites
            run_defs = {
                0: [(0,), (1,), (2,), (3,)],
                1: [(0, 1), (2,), (3,)],
                2: [(0,), (1, 2), (3,)],
                3: [(0, 1, 2), (3,)],
                4: [(0,), (1,), (2, 3)],
                5: [(0, 1), (2, 3)],
                6: [(0,), (1, 2, 3)],
                7: [(0, 1, 2, 3)],
            }
            for p, runs in run_defs.items():
                mask = pat == p
                if not mask.any():
                    continue
                midx = np.nonzero(mask)[0]
                for run in runs:
                    end = run[-1] + 1
                    parity = (4 - end) & 1
                    # registry id per row: build lookup array over code tuples
                    keyarr = np.zeros(len(midx), dtype=np.int64)
                    for pos, c in enumerate(run):
                        keyarr = keyarr * 4 + Cs[midx, c]
                    # map packed code sequences -> ids via table
                    ids = np.empty(len(midx), dtype=np.int64)
                    uniq, inv = np.unique(keyarr, return_inverse=True)
                    id_of = np.empty(len(uniq), dtype=np.int64)
                    for u_i, u in enumerate(uniq):
                        seq = []
                        x = int(u)
                        for _ in run:
                            seq.append(x % 4)
                            x //= 4
                        seq = tuple(reversed(seq))
                        id_of[u_i] = ptab[(seq, parity)]
                    ids = id_of[inv.ravel()]
                    dead = ids < 0
                    if dead.any():
                        alive[midx[dead]] = False
                    site_col = Ss[midx, run[0]]
                    rows[midx, site_col] = np.where(
                        dead, 0, ids).astype(np.uint8)
            rows_list.append(rows[alive])
            coeff_list.append(coeffs[alive])

    all_rows = np.concatenate(rows_list, axis=0)
    all_coeffs = np.concatenate(coeff_list, axis=0)
    tt = TermTable(group, L, all_coeffs, all_rows, registry)
    return dedupe_hashed(tt, cutoff)


def row_hashes(opids: np.ndarray, mult: Tuple[int, int] = (0x9E3779B97F4A7C15,
                                                           0xC2B2AE3D27D4EB4F)
               ) -> Tuple[np.ndarray, np.ndarray]:
    """128-bit rolling suffix hashes: h[t] covers opids[:, t:]; h[L] = 0."""
    n, L = opids.shape
    h1 = np.zeros((n, L + 1), dtype=np.uint64)
    h2 = np.zeros((n, L + 1), dtype=np.uint64)
    m1 = np.uint64(mult[0])
    m2 = np.uint64(mult[1])
    one = np.uint64(1)
    with np.errstate(over="ignore"):
        for t in range(L - 1, -1, -1):
            col = opids[:, t].astype(np.uint64)
            h1[:, t] = h1[:, t + 1] * m1 + col + one
            h2[:, t] = h2[:, t + 1] * m2 + col + one
    return h1, h2


def dedupe_hashed(tt: TermTable, cutoff: float = 1e-14) -> TermTable:
    """Hash-based duplicate-row merge (replaces np.unique(axis=0))."""
    if len(tt) == 0:
        return tt
    h1, h2 = row_hashes(tt.opids)
    key = np.ascontiguousarray(
        np.stack([h1[:, 0], h2[:, 0]], axis=1)).view("V16").ravel()
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    coeffs = np.zeros(len(uniq), dtype=tt.coeffs.dtype)
    np.add.at(coeffs, inv.ravel(), tt.coeffs)
    keep = np.abs(coeffs) > cutoff
    return TermTable(tt.group, tt.n_sites, coeffs[keep],
                     tt.opids[first[keep]], tt.registry)
