"""MPO construction from packed term tables via per-bond bipartite compression.

Counterpart of block2's GeneralMPO with
MPOAlgorithmTypes::FastBipartite — the modern default MPO path (reference
src/dmrg/general_mpo.hpp:152, algorithm flags at general_mpo.hpp:43-99;
bipartite matching via the min-cost-flow machinery in src/core/flow.hpp:125).

Algorithm (left-to-right single pass):
  At bond t..t+1, every active term is a triple
      (incoming symbol, site-t operator, remaining suffix string).
  Build the bipartite graph between distinct (incoming symbol, site-op) "left
  keys" and distinct suffix "right keys".  A minimum vertex cover (Koenig's
  theorem from a maximum matching) becomes the new bond symbol set:
    * a covered LEFT key lambda becomes symbol b_lambda: MPO entry
      W[in, b_lambda] += op (weight 1); its terms continue with their residual
      coefficients (coefficient flows right — complementary-operator style);
    * a covered RIGHT key sigma becomes symbol b_sigma: for every edge
      (lambda', sigma) not left-covered, W[in(lambda'), b_sigma] +=
      (sum of term coeffs) * op(lambda'); exactly ONE continuation per sigma
      survives, with residual coefficient 1 (terms sharing the suffix merge).
  The last site force-absorbs all residual coefficients.

This yields O(K^2) bond dimension for quantum-chemistry Hamiltonians, the same
scaling block2 gets from its NC/CN complementary-operator partitions
(reference src/dmrg/qc_mpo.hpp:634-640).

Copied from block2_preview_tpu/dmrg/mpo_builder.py (the port keeps its own copy).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

from ..core.expr import TermTable
from ..core.symmetry import QN, SymmetryGroup
from ..ops.local_ops import (OpRegistry, SZ_SITE, SiteBasisSpec,
                             op_delta_quantum, sz_site_basis_quanta)
from .mpo import MPO


def _min_vertex_cover(nl: int, nr: int, el: np.ndarray, er: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum vertex cover of a bipartite graph (Koenig construction).
    Returns boolean masks (cover_left, cover_right)."""
    graph = csr_matrix((np.ones(len(el), dtype=np.int8), (el, er)),
                       shape=(nl, nr))
    # match_col[i] = column matched to row i (-1 if unmatched)
    match_col = maximum_bipartite_matching(graph, perm_type="column")
    match_row = np.full(nr, -1, dtype=np.int64)
    rows_matched = np.nonzero(match_col >= 0)[0]
    match_row[match_col[rows_matched]] = rows_matched

    # adjacency lists for BFS
    order = np.argsort(el, kind="stable")
    el_s, er_s = el[order], er[order]
    starts = np.searchsorted(el_s, np.arange(nl + 1))

    vis_l = np.zeros(nl, dtype=bool)
    vis_r = np.zeros(nr, dtype=bool)
    queue = deque(np.nonzero(match_col < 0)[0].tolist())
    vis_l[list(queue)] = True
    while queue:
        l = queue.popleft()
        for r in er_s[starts[l]:starts[l + 1]]:
            if not vis_r[r]:
                vis_r[r] = True
                l2 = match_row[r]
                if l2 >= 0 and not vis_l[l2]:
                    vis_l[l2] = True
                    queue.append(l2)
    return ~vis_l, vis_r


def build_mpo(tt: TermTable, site_pgs: Sequence[int] | None = None,
              const_e: float = 0.0, cutoff: float = 1e-14,
              spec: SiteBasisSpec = SZ_SITE,
              site_quanta=None) -> MPO:
    """Compile a TermTable into a bipartite-compressed numeric MPO.
    site_quanta overrides the per-site basis quanta (K-point/LZ modes where
    labels are not XOR point-group irreps)."""
    g = tt.group
    L = tt.n_sites
    specs = list(spec) if not isinstance(spec, SiteBasisSpec) else [spec] * L
    if site_quanta is None:
        if site_pgs is None:
            site_pgs = [0] * L
        site_quanta = [specs[t].quanta(int(p))
                       for t, p in enumerate(site_pgs)]

    def _mat(t: int, opid: int) -> np.ndarray:
        # identity/JW-parity are per-site (big sites have their own dims)
        if opid == OpRegistry.ID_I:
            return specs[t].ident
        if opid == OpRegistry.ID_Z:
            return specs[t].parity
        return tt.registry[opid]

    # delta quantum per (registry id, site); registry ids whose dims do not
    # match a site never occur there (heterogeneous chains)
    nreg = len(tt.registry)
    dq_table = [[g.zero if i < 2 else
                 (op_delta_quantum(g, tt.registry[i], site_quanta[t], strict=False)
                  if tt.registry[i].shape[0] == len(site_quanta[t]) else None)
                 for i in range(nreg)] for t in range(L)]

    # 128-bit rolling suffix hashes: O(1) suffix-identity keys per bond,
    # replacing lexicographic row sorts (required at Cr2 scale, ~12M terms)
    from ..core.qc_terms_fast import row_hashes
    sh1, sh2 = row_hashes(tt.opids)

    act_rows = np.arange(len(tt), dtype=np.int64)
    act_sym = np.zeros(len(tt), dtype=np.int64)
    act_coeff = tt.coeffs.copy()

    bond_dqs: List[List[QN]] = [[g.zero]]
    tensors: List[Dict[Tuple[int, int], np.ndarray]] = []

    for t in range(L):
        m = len(act_rows)
        assert m > 0, "no active terms — empty Hamiltonian?"
        o_ids = tt.opids[act_rows, t].astype(np.int64)

        # left keys: (incoming symbol, site op)
        lk_pack = act_sym * nreg + o_ids
        lk_vals, lk_idx = np.unique(lk_pack, return_inverse=True)
        lk_sym = lk_vals // nreg
        lk_op = lk_vals % nreg
        nl = len(lk_vals)

        # right keys: distinct suffixes (by 128-bit hash)
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

        # unique edges with summed coefficients
        e_pack = lk_idx * nr + rk_idx
        e_vals, e_inv = np.unique(e_pack, return_inverse=True)
        e_coeff = np.zeros(len(e_vals), dtype=tt.coeffs.dtype)
        np.add.at(e_coeff, e_inv.ravel(), act_coeff)
        e_l = e_vals // nr
        e_r = e_vals % nr

        if t == L - 1:
            cov_l = np.zeros(nl, dtype=bool)
            cov_r = np.ones(nr, dtype=bool)
        else:
            cov_l, cov_r = _min_vertex_cover(nl, nr, e_l, e_r)

        # right keys that actually receive a non-left-covered edge
        recv_r = np.zeros(nr, dtype=bool)
        free_edges = ~cov_l[e_l]
        recv_r[e_r[free_edges]] = True
        cov_r = cov_r & recv_r if t < L - 1 else cov_r

        # outgoing symbol numbering: left-covered keys first, then right keys
        new_sym_of_lk = np.full(nl, -1, dtype=np.int64)
        new_sym_of_rk = np.full(nr, -1, dtype=np.int64)
        dqs: List[QN] = []
        for i in np.nonzero(cov_l)[0]:
            new_sym_of_lk[i] = len(dqs)
            dqs.append(g.add(bond_dqs[t][lk_sym[i]], dq_table[t][lk_op[i]]))
        for i in np.nonzero(cov_r)[0]:
            new_sym_of_rk[i] = len(dqs)
            dqs.append(None)  # filled from first incoming edge below

        w: Dict[Tuple[int, int], np.ndarray] = {}

        def add_entry(i_sym: int, o_sym: int, mat: np.ndarray) -> None:
            key = (i_sym, o_sym)
            if key in w:
                w[key] = w[key] + mat
            else:
                w[key] = mat.copy()

        # left-covered symbols: weight-1 entries
        for i in np.nonzero(cov_l)[0]:
            add_entry(int(lk_sym[i]), int(new_sym_of_lk[i]),
                      _mat(t, int(lk_op[i])))
        # right-covered symbols: coefficient-absorbing entries
        for ei in np.nonzero(free_edges)[0]:
            li, ri = int(e_l[ei]), int(e_r[ei])
            o_sym = int(new_sym_of_rk[ri])
            assert o_sym >= 0, "edge not covered"
            dq_here = g.add(bond_dqs[t][int(lk_sym[li])],
                            dq_table[t][int(lk_op[li])])
            if dqs[o_sym] is None:
                dqs[o_sym] = dq_here
            else:
                assert dqs[o_sym] == dq_here, "inconsistent suffix charge"
            if abs(e_coeff[ei]) > cutoff:
                add_entry(int(lk_sym[li]), o_sym,
                          e_coeff[ei] * _mat(t, int(lk_op[li])))

        tensors.append(w)
        bond_dqs.append([d if d is not None else g.zero for d in dqs])

        # continuations
        if t == L - 1:
            break
        left_terms = cov_l[lk_idx]
        nxt_rows, nxt_sym, nxt_coeff = [], [], []
        if np.any(left_terms):
            lt_rows = act_rows[left_terms]
            lt_sym = new_sym_of_lk[lk_idx[left_terms]]
            lt_rk = rk_idx[left_terms]
            lt_coeff = act_coeff[left_terms]
            # dedupe (symbol, suffix) with coefficient summation
            pack = lt_sym * nr + lt_rk
            uvals, ufirst, uinv = np.unique(pack, return_index=True,
                                            return_inverse=True)
            ucoeff = np.zeros(len(uvals), dtype=tt.coeffs.dtype)
            np.add.at(ucoeff, uinv.ravel(), lt_coeff)
            keep = np.abs(ucoeff) > cutoff
            nxt_rows.append(lt_rows[ufirst[keep]])
            nxt_sym.append(uvals[keep] // nr)
            nxt_coeff.append(ucoeff[keep])
        r_live = np.nonzero(cov_r)[0]
        if len(r_live):
            rep_rows = act_rows[rk_first[r_live]] if t + 1 < L else act_rows[:1]
            nxt_rows.append(rep_rows)
            nxt_sym.append(new_sym_of_rk[r_live])
            nxt_coeff.append(np.ones(len(r_live)))
        act_rows = np.concatenate(nxt_rows)
        act_sym = np.concatenate(nxt_sym)
        act_coeff = np.concatenate(nxt_coeff)

    return MPO(group=g, n_sites=L, site_quanta=site_quanta,
               bond_dqs=bond_dqs, tensors=tensors, const_e=const_e)
