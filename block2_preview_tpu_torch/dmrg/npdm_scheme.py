"""Symbol-free polynomial N-PDM engine (middle-site pooled scheme).

Reference analog: GeneralNPDMMPO + NPDMScheme/NPDMCounter
(src/dmrg/general_npdm.hpp:43, src/core/spin_permutation.hpp:1703,1843)
evaluated through Expect's middle-site partitioning
(src/dmrg/sweep_algorithm.hpp:5280).  Every spin-orbital string
c+_{a_k}..c+_{a_1} c_{b_1}..c_{b_k} (the Gram convention of
dmrg/npdm.py) is assigned to the site of its (k+1)-th operator in site
order, so

    left  prefixes hold <= k   operators  (pool L, grown forward),
    right suffixes hold <= k-1 operators  (pools R[b], grown backward),

and polynomially many pooled bond environments replace the exponential
determinant expansion.  At each middle site the completed strings are
evaluated as (left env) x (site ops) x (right env), with the right pool
flattened into a dense [n_combo, X] matrix so each (left, site) pair
closes against every suffix in one BLAS gemv/gemm.

The result is the same Gram matrix G[A, B] = <bra| c+_{a_k}..c+_{a_1}
c_{b_1}..c_{b_k} |ket> over sorted spin-orbital k-subsets that
dmrg/npdm.py builds by determinant expansion; the spatial k-PDM scatter
is shared (npdm.gram_to_spatial).

Cost model (L sites, D bond dim, k = order): pools hold
O(C(4L, k)) [D, D] sector matrices; the dominant close step is
O(#strings / L) dot products of length ~D^2 per site, i.e. polynomial
in L where the determinant path is exponential.

Copied from block2_preview_tpu/dmrg/npdm_scheme.py (the port keeps its
own copy): the pools, ``_Flat``, the class grouping and
``_scatter_class`` are the reference's.  What differs is the device close
(``_device_gemm``): the middle ``[n, X] @ [X, m]`` class GEMMs at or above
``device_min_flop`` run on a torch device through kernel K17
(``ops/npdm_gemm.py``, ``csrc/npdm_gemm.cu``) — its plain twin on CPU
tensors — where the reference ran a jit matmul at full precision; with a
device mesh each rank closes its row slice on K17 and the slices are
gathered, as the reference's sharded closes are.
"""

from __future__ import annotations

from itertools import combinations
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.symmetry import QN
from ..ops.local_ops import CRE_A, CRE_B, DES_A, DES_B, ELEM_MATS, PARITY
from .expect import EnvBlocks, StringExpectation
from .mps import MPS

# canonical within-site operator order: the Gram term order
# [cre desc spin-orbital, ann asc spin-orbital] restricted to one site is
# always (c+_beta, c+_alpha, c_alpha, c_beta) — so products taken in this
# fixed order need no extra within-site sign
_RANK_ELEMS = (CRE_B, CRE_A, DES_A, DES_B)
_RANK_IS_CRE = (True, True, False, False)
# spin-orbital of rank r at site i: so = 2*i + spin  (alpha = 0)
_RANK_SPIN = (1, 0, 0, 1)

# nonempty canonical-ordered subsets of the 4 site ops (15 patterns)
_SITE_PATTERNS: List[Tuple[int, ...]] = [
    tuple(r for r in range(4) if (m >> r) & 1) for m in range(1, 16)]


def _pattern_mat(ranks: Tuple[int, ...], z: bool) -> np.ndarray:
    m = ELEM_MATS[_RANK_ELEMS[ranks[0]]]
    for r in ranks[1:]:
        m = m @ ELEM_MATS[_RANK_ELEMS[r]]
    if z:
        m = m @ PARITY
    return m


def _combo_info(ops: Tuple[int, ...]) -> Tuple[int, int]:
    """(n_cre, n_ann) of an op-int combo (op = 4*site + rank)."""
    nc = sum(1 for o in ops if _RANK_IS_CRE[o & 3])
    return nc, len(ops) - nc


def _string_sign_and_ranks(ops: Tuple[int, ...], combo_rank, L2: int
                           ) -> Optional[Tuple[int, int, int]]:
    """Map a site-sorted op string (canonical within-site order) to its
    Gram entry: (sign, rank_A, rank_B) or None if not a valid k|k
    string.  Term order is [cre desc so, ann asc so]; sign is the
    fermionic parity of the stable site-sort into canonical order."""
    cre = []
    ann = []
    for o in ops:
        site, r = divmod(o, 4)
        so = 2 * site + _RANK_SPIN[r]
        (cre if _RANK_IS_CRE[r] else ann).append(so)
    # term sequence sites: cre in descending so, then ann in ascending so
    cre_desc = sorted(cre, reverse=True)
    ann_asc = sorted(ann)
    seq = [so // 2 for so in cre_desc] + [so // 2 for so in ann_asc]
    inv = 0
    for i in range(len(seq)):
        si = seq[i]
        for j in range(i + 1, len(seq)):
            if si > seq[j]:
                inv += 1
    encA = 0
    for so in sorted(cre):
        encA = encA * L2 + so
    encB = 0
    for so in ann_asc:
        encB = encB * L2 + so
    ra = combo_rank.get(encA)
    rb = combo_rank.get(encB)
    if ra is None or rb is None:
        return None
    return (1 - 2 * (inv & 1), ra, rb)


class _Flat:
    """Fixed (sector-key -> offset) layout for flattening EnvBlocks of
    one bond into dense vectors."""

    def __init__(self, keys_shapes: Dict[Tuple[QN, QN], Tuple[int, int]]):
        self.offs: Dict[Tuple[QN, QN], Tuple[int, int, int]] = {}
        n = 0
        for key, (r, c) in sorted(keys_shapes.items()):
            self.offs[key] = (n, r, c)
            n += r * c
        self.size = n

    def vec(self, e: EnvBlocks, dtype) -> np.ndarray:
        v = np.zeros(self.size, dtype=dtype)
        for key, blk in e.items():
            ent = self.offs.get(key)
            if ent is None:
                continue
            o, r, c = ent
            v[o:o + r * c] = blk[:r, :c].ravel()
        return v


def pooled_gram(mps: MPS, order: int, bra: Optional[MPS] = None,
                dtype=np.float64, device="cuda",
                device_min_flop: float = 2e7, stats: Optional[dict] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Gram matrix G[A, B] = <bra| c+_{a_k}..c+_{a_1} c_{b_1}..c_{b_k}
    |ket> over all sorted spin-orbital k-subsets, via pooled sweeps.
    Returns (G, combos).

    ``device`` ("cuda" by default, or "cpu", or a torch.device) closes
    the middle [n, X] @ [X, m] class GEMMs there through kernel K17 (its
    plain twin on the CPU): each bond's flat right-pool matrix M uploads
    once and serves every left batch at that site; closes below
    ``device_min_flop`` stay on host BLAS, as in the reference.
    ``device=None`` closes everything on the host (the reference's
    device=False).  A 1-D ``DeviceMesh`` as ``device`` (every rank calls
    with the same state) splits each device close's rows over the ranks
    and gathers them (:func:`_device_gemm`).  ``dtype`` is float64, or
    complex128 for a complex state; any other type raises.

    ``stats``, when given, is filled with the wall split: "pools" (host
    pool transfers, flattening and batching), "close" (the class closes,
    device ones including their upload and download), "scatter"
    (``_scatter_class``), "total" seconds, and "closes", one (bond,
    (|c3|, n_cre), n, X, m, on_device) tuple per close."""
    if np.dtype(dtype) not in (np.dtype(np.float64),
                               np.dtype(np.complex128)):
        raise TypeError(f"pooled_gram takes float64 or complex128 (got "
                        f"{np.dtype(dtype)}): a lower precision breaks PDM "
                        "parity")
    t_start = time.perf_counter()
    t_close = t_scatter = 0.0
    closes = []
    k = order
    jmm = None if device is None else _device_gemm(device)
    eng = StringExpectation(mps, bra=bra)
    L = eng.L
    L2 = 2 * L
    combos = np.array(list(combinations(range(L2), k)), dtype=np.int64)
    combo_rank: Dict[int, int] = {}
    for i, row in enumerate(combos):
        e = 0
        for a in row:
            e = e * L2 + int(a)
        combo_rank[e] = i
    nC = len(combos)
    G = np.zeros((nC, nC), dtype=dtype)

    # site-op matrices per (pattern, z-dressing)
    pat_mats = {(p, z): _pattern_mat(p, bool(z))
                for p in _SITE_PATTERNS for z in (0, 1)}
    ident_z = {0: None, 1: PARITY}

    # ---- right suffix pools, built backward; RP[b] lives at bond b ----
    # (combo ops all at sites >= b, |combo| <= k-1; () = identity suffix)
    max_r = k - 1
    RP: List[Dict[Tuple[int, ...], EnvBlocks]] = [None] * (L + 1)
    RP[L] = {(): {(eng.bra_target, eng.target): np.ones((1, 1))}}
    for t in range(L - 1, -1, -1):
        cur = RP[t + 1]
        new: Dict[Tuple[int, ...], EnvBlocks] = {}
        for c, e in cur.items():
            # passive transfer: Z iff (#ops at sites > t) odd = |c| odd
            zmat = ident_z[len(c) & 1]
            new[c] = eng._transfer_right_identity(
                e, eng.bra.tensors[t], eng.mps.tensors[t]) \
                if zmat is None else _transfer_right_op(
                    eng, e, t, zmat)
            if len(c) >= max_r:
                continue
            for p in _SITE_PATTERNS:
                if len(c) + len(p) > max_r:
                    continue
                nc_, na_ = _combo_info(c)
                pc = sum(1 for r in p if _RANK_IS_CRE[r])
                if nc_ + pc > k or na_ + (len(p) - pc) > k:
                    continue
                w = pat_mats[(p, len(c) & 1)]
                e2 = _transfer_right_op(eng, e, t, w)
                if e2:
                    new[tuple(4 * t + r for r in p) + c] = e2
        RP[t] = new

    # dense rank lookup for sorted spin-orbital k-tuples
    rank_tab = np.full(L2 ** k, -1, dtype=np.int64)
    enc = np.zeros(nC, dtype=np.int64)
    for a in range(k):
        enc = enc * L2 + combos[:, a]
    rank_tab[enc] = np.arange(nC)

    # flatten right pools per bond, grouped by (|c3|, n_cre): each class
    # is one dense [n, X] matrix so every middle contraction is a GEMM
    flats: List[_Flat] = [None] * (L + 1)
    rgrp: List[Dict[Tuple[int, int], tuple]] = [None] * (L + 1)
    for b in range(L + 1):
        if RP[b] is None:
            continue
        ks: Dict[Tuple[QN, QN], Tuple[int, int]] = {}
        for e in RP[b].values():
            for key, blk in e.items():
                r, c = blk.shape
                if key in ks:
                    r0, c0 = ks[key]
                    ks[key] = (max(r, r0), max(c, c0))
                else:
                    ks[key] = (r, c)
        fl = _Flat(ks)
        flats[b] = fl
        by: Dict[Tuple[int, int], List[Tuple[int, ...]]] = {}
        for c in sorted(RP[b].keys()):
            nc_, _na = _combo_info(c)
            by.setdefault((len(c), nc_), []).append(c)
        grp: Dict[Tuple[int, int], tuple] = {}
        for cls, cl in by.items():
            n3, nc3 = cls
            M = np.zeros((len(cl), fl.size), dtype=dtype)
            cre = np.zeros((len(cl), nc3), dtype=np.int64)
            ann = np.zeros((len(cl), n3 - nc3), dtype=np.int64)
            for i, c in enumerate(cl):
                M[i] = fl.vec(RP[b][c], dtype)
                cs, as_ = [], []
                for o in c:
                    site, r = divmod(o, 4)
                    so = 2 * site + _RANK_SPIN[r]
                    (cs if _RANK_IS_CRE[r] else as_).append(so)
                cre[i] = sorted(cs)
                ann[i] = sorted(as_)
            grp[cls] = (M, cre, ann)
        rgrp[b] = grp

    def _scatter_class(allv, cre3, ann3, base_cre, base_ann):
        """G[rank(cre), rank(ann)] += sign * val for the full
        [n right combos x m left rows] class block at once."""
        n, m = allv.shape
        nb = base_cre.shape[1] if base_cre.size else 0
        creF = np.concatenate(
            [np.broadcast_to(base_cre[None, :, :], (n, m, nb)),
             np.broadcast_to(cre3[:, None, :], (n, m, cre3.shape[1]))],
            axis=2) if nb or cre3.shape[1] else \
            np.zeros((n, m, 0), dtype=np.int64)
        nb2 = base_ann.shape[1] if base_ann.size else 0
        annF = np.concatenate(
            [np.broadcast_to(base_ann[None, :, :], (n, m, nb2)),
             np.broadcast_to(ann3[:, None, :], (n, m, ann3.shape[1]))],
            axis=2)
        creS = np.sort(creF, axis=2)
        annS = np.sort(annF, axis=2)
        # term sequence sites: cre desc so then ann asc so
        seq = np.concatenate([creS[:, :, ::-1] // 2, annS // 2], axis=2)
        inv = np.zeros((n, m), dtype=np.int64)
        for a in range(2 * k):
            sa = seq[:, :, a]
            for bq in range(a + 1, 2 * k):
                inv += sa > seq[:, :, bq]
        sg = 1 - 2 * (inv & 1)
        eA = np.zeros((n, m), dtype=np.int64)
        eB = np.zeros((n, m), dtype=np.int64)
        for a in range(k):
            eA = eA * L2 + creS[:, :, a]
            eB = eB * L2 + annS[:, :, a]
        np.add.at(G, (rank_tab[eA].ravel(), rank_tab[eB].ravel()),
                  (sg * allv).ravel())

    # ---- forward sweep: left pool + middle contractions ----
    LP: Dict[Tuple[int, ...], Optional[EnvBlocks]] = {(): None}
    for t in range(L):
        grp_r = rgrp[t + 1]
        fl_r = flats[t + 1]
        # middle: strings whose (k+1)-th op sits at site t.  Batch the
        # flattened (left x site) environments per (need, n_cre3) class
        # and close every class in one [n_rows, X] @ [X, m] GEMM.
        batches: Dict[Tuple[int, int], List[tuple]] = {}
        for c1, e1 in LP.items():
            n1 = len(c1)
            nc1, na1 = _combo_info(c1)
            for p in _SITE_PATTERNS:
                n2 = len(p)
                need = 2 * k - n1 - n2
                if need < 0 or need > max_r or n1 + n2 < k + 1:
                    continue
                pc = sum(1 for r in p if _RANK_IS_CRE[r])
                nc3 = k - nc1 - pc
                na3 = k - na1 - (n2 - pc)
                if nc3 < 0 or na3 < 0 or nc3 + na3 != need:
                    continue
                if (need, nc3) not in grp_r:
                    continue
                w = pat_mats[(p, need & 1)]
                e2 = eng._transfer_op(e1, t, w)
                if not e2:
                    continue
                base = c1 + tuple(4 * t + r for r in p)
                bc, ba = [], []
                for o in base:
                    site, r = divmod(o, 4)
                    so = 2 * site + _RANK_SPIN[r]
                    (bc if _RANK_IS_CRE[r] else ba).append(so)
                batches.setdefault((need, nc3), []).append(
                    (fl_r.vec(e2, dtype),
                     np.asarray(sorted(bc), dtype=np.int64),
                     np.asarray(sorted(ba), dtype=np.int64)))
        for cls, rows in batches.items():
            M, cre3, ann3 = grp_r[cls]
            V = np.stack([r[0] for r in rows], axis=1)    # [X, m]
            t0 = time.perf_counter()
            on_dev = jmm is not None and 2.0 * M.shape[0] * M.shape[1] \
                * V.shape[1] >= device_min_flop
            if on_dev:
                allv = jmm(t + 1, cls, M, V)              # [n, m]
            else:
                allv = M @ V                              # [n, m]
            t1 = time.perf_counter()
            closes.append((t + 1, cls, M.shape[0], M.shape[1], V.shape[1],
                           on_dev))
            bcre = np.stack([r[1] for r in rows])          # [m, ncb]
            bann = np.stack([r[2] for r in rows])
            _scatter_class(allv, cre3, ann3, bcre, bann)
            t_close += t1 - t0
            t_scatter += time.perf_counter() - t1
        # extend the left pool through site t
        if t == L - 1:
            break
        new: Dict[Tuple[int, ...], Optional[EnvBlocks]] = {}
        for c1, e1 in LP.items():
            zmat = ident_z[len(c1) & 1]
            if e1 is None and zmat is None and eng.same:
                new[c1] = None          # identity prefix stays implicit
            else:
                new[c1] = eng._transfer_op(
                    e1, t, np.eye(4) if zmat is None else zmat)
            if len(c1) >= k:
                continue
            nc1, na1 = _combo_info(c1)
            for p in _SITE_PATTERNS:
                if len(c1) + len(p) > k:
                    continue
                pc = sum(1 for r in p if _RANK_IS_CRE[r])
                if nc1 + pc > k or na1 + (len(p) - pc) > k:
                    continue
                w = pat_mats[(p, (len(c1) + len(p)) & 1)]
                e2 = eng._transfer_op(e1, t, w)
                if e2:
                    new[c1 + tuple(4 * t + r for r in p)] = e2
        LP = new
    if stats is not None:
        total = time.perf_counter() - t_start
        stats.update(pools=total - t_close - t_scatter, close=t_close,
                     scatter=t_scatter, total=total, closes=closes)
    return G, combos


def _device_gemm(device):
    """Device close for the middle class GEMMs on ``device`` through
    kernel K17 (``ops/npdm_gemm.py``): per-(bond, class) M uploads are
    cached (each serves every left row batch at that site); V uploads per
    close; f64/complex128 pass through as stored (a lower precision would
    break PDM parity).

    ``device`` may be a 1-D ``DeviceMesh`` (the reference's mesh,
    :357-406): then each rank closes its slice of M's combo rows on K17 on
    its own device (the rows padded with zeros to a multiple of the mesh
    size, reference :396-399), V is replicated, and ``all_gather`` — the
    only collective — stacks the slices on every rank."""
    import torch

    from ..ops.npdm_gemm import npdm_gemm
    from ..runtime import rank_device
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(device, (str, torch.device, DeviceMesh)):
        raise TypeError("pooled_gram closes on a torch device or a "
                        f"DeviceMesh (got {type(device).__name__})")
    mesh = device if isinstance(device, DeviceMesh) else None
    group = rank = world = None
    if mesh is not None:
        from ..parallel.multihost import all_gather_rows, axis_info
        group, rank, world = axis_info(mesh, mesh.mesh_dim_names[0])
    dev = rank_device(mesh, None if mesh is not None else device)
    cache: Dict[tuple, tuple] = {}

    def close(bond, cls, M, V):
        key = (bond, cls)
        ent = cache.get(key)
        if ent is None or ent[1] != M.shape:
            rows = M
            if mesh is not None:
                per = -(-M.shape[0] // world)
                rows = np.zeros((per, M.shape[1]), M.dtype)
                mine = M[rank * per:(rank + 1) * per]
                rows[:mine.shape[0]] = mine
            ent = (torch.as_tensor(rows, device=dev), M.shape)
            cache[key] = ent
        out = npdm_gemm(ent[0], torch.as_tensor(V, device=dev))
        if mesh is not None:
            out = all_gather_rows(out, group)[:M.shape[0]]
        return out.cpu().numpy()

    return close


def _transfer_right_op(eng: StringExpectation, e: EnvBlocks, t: int,
                       opmat: np.ndarray) -> EnvBlocks:
    """Right-to-left transfer with a site operator: the op-dressed analog
    of StringExpectation._transfer_right_identity."""
    Tb = eng.bra.tensors[t]
    Tk = eng.mps.tensors[t]
    quanta = eng.site_quanta[t]
    bidx: Dict[Tuple[QN, int], List[Tuple[QN, np.ndarray]]] = {}
    kidx: Dict[Tuple[QN, int], List[Tuple[QN, np.ndarray]]] = {}
    for (ql, qp, qr), b in Tb.blocks.items():
        for p, q in enumerate(quanta):
            if q == qp:
                bidx.setdefault((qr, p), []).append(
                    (ql, b.reshape(b.shape[0], b.shape[2]).conj()))
    for (ql, qp, qr), b in Tk.blocks.items():
        for p, q in enumerate(quanta):
            if q == qp:
                kidx.setdefault((qr, p), []).append(
                    (ql, b.reshape(b.shape[0], b.shape[2])))
    out: EnvBlocks = {}
    for pb, pk in zip(*np.nonzero(opmat)):
        w = opmat[pb, pk]
        for (qb2, qk2), eb in e.items():
            for qlb, mb in bidx.get((qb2, int(pb)), ()):
                for qlk, mk in kidx.get((qk2, int(pk)), ()):
                    key = (qlb, qlk)
                    contrib = w * (mb @ eb @ mk.T)
                    if key in out:
                        out[key] += contrib
                    else:
                        out[key] = contrib
    return out


def npdm_spatial_poly(mps: MPS, order: int, bra: Optional[MPS] = None,
                      device="cuda", device_min_flop: float = 2e7
                      ) -> np.ndarray:
    """Spatial k-PDM via the polynomial pooled-sweep engine; same
    convention as dmrg/npdm.py npdm_spatial (block2 get_npdm).  The class
    closes of at least ``device_min_flop`` FLOPs run on ``device`` (see
    :func:`pooled_gram`)."""
    from .npdm import gram_to_spatial
    G, combos = pooled_gram(mps, order, bra=bra, device=device,
                            device_min_flop=device_min_flop)
    return gram_to_spatial(G, combos, mps.n_sites, order)
