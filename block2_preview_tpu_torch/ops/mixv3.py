"""LW/RW assembly, mix v3 — kernels K13 (env GEMM) and K14 (place).

Host side, copied from block2_preview_tpu/ops/mixv3.py:48-56, 185-582:
the plan (``build_mix_plan_v3``), whose tables the v4 form
(``ops/mixv4.py``) also reads.  Within one env delta-quantum group g the
mix is a linear map over the symbol axis: for every output row
w = (osym, pb, pk) and env sector s,

    OUT_g[w, s-block] = sum_j W_g[w, j] * ENV_g[j, s-block]

with W_g[w, j] = entries[(sym_j, osym)][pb, pk] (the reference's
symbol-mixing loop, src/core/operator_tensor.hpp:209
DelayedOperatorTensor).  After the j-reduction every slab element is
written by exactly one window, so the slab is a permutation of OUT.

Device side, :func:`execute_mix_v3` (reference :585-709) runs

  K13 (``csrc/env_gemm.cu``, replaces ``_env_gemm`` :62 and
      ``_env_gemm_chunk`` :88) once a plan: OUT_g = W_g @ ENV_g for every
      GEMM group, on K3's output-stationary body over the group-by-sector
      GEMM blocks (:func:`k13_host_tables`, W densified once a plan);
  K14 (``csrc/place_v3.cu``, replaces ``_place`` :143 and
      ``_place_chunk`` :109) once: slab[i] = OUT[window source of i];

with OUT laid out as the reference's (each group's [nw_p, dg_p] block in
plan order, padded to ``_cap_class(out_total + 1)``), which ``winsrc``
indexes.  K13 stores every element of the groups' blocks, zeros
included, so only the size-class tail past them is filled.  K14 and
K13's window form (:func:`env_gemm_exec`, one group) take a window
(c0, n) of their output — the reference's chunked jits.  The tables are
built once a plan and kept in its ``_dev``.  The reference's
device-struct cache, ``B2TPU_SYNC_MIX``, ``B2TPU_MIX_STATS`` and the
``B2TPU_MIX_CHUNK_ELEMS`` chunking are not carried.  On CPU tensors the
wrappers run the plain PyTorch twins; on CUDA tensors they launch the
kernels or raise.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .csr import w_nonzero as _w_nonzero
from .mixv4 import K3_SLICE, _k3_gaps, k3_host_tables
from .stacked import StackedMeta, _cap_class, _pow2

# slab elements per chunk of K14's plain version (bounds its temporaries)
_TWIN_PLACE_ELEMS = 1 << 22

# the place tables, in the order K14 takes them
PLACE_TABLES = ("sb_starts", "sb_blksz", "sb_dlk", "sb_rowoff", "sb_coloff",
                "sb_celloff", "sb_ncc", "sb_cells", "rowcell", "rowin",
                "colcell", "colin", "winsrc", "windk")


def _cls(n: int, keep_bits: int = 2) -> int:
    """1.25x-style size class (matches tilev2._quant)."""
    n = max(int(n), 1)
    if n <= (1 << keep_bits):
        return n
    shift = n.bit_length() - 1 - keep_bits
    step = 1 << shift
    return -(-n // step) * step


class MixPlanV3:
    """The reference's fields, and ``_dev``, the port's cache of K13's
    host tables (under "k13") and of the device tables (under (device,
    dtype))."""

    __slots__ = ("meta_out", "ncap_out", "gemms", "tables", "out_total",
                 "iscpx", "dims_hint", "n_launch", "winflat", "_dev")


def _build_tab(fused, quanta, ct, act, bond_is_first, group):
    """(bond sector, phys state) -> (fused q, first row, stride) — same
    semantics as the reference's ops.resident.build_mix_plan build_tab."""
    tab = {}
    for fq, runs in fused.maps.items():
        if act is not None and fq not in act:
            continue
        for (qa, qb2, off, da, db) in runs:
            if bond_is_first:
                qbond, p_qn = qa, qb2
            else:
                p_qn, qbond = qa, qb2
            qb_real = qbond if ct is None else group.sub(ct, qbond)
            idx_within = 0
            for p, q in enumerate(quanta):
                if q == p_qn:
                    if bond_is_first:
                        tab[(qb_real, p)] = (fq, off + idx_within, db)
                    else:
                        tab[(qb_real, p)] = (fq, off + idx_within * db, 1)
                    idx_within += 1
    return tab


def _fused_cells(fused, quanta, ct, act, bond_is_first, group):
    """Per fused sector: ordered cells [(qb_real, p, count, first,
    stride)] and an element table mapping fused index -> (cell, within).
    count = bond dim (the env-block extent along this axis); first +
    stride * arange(count) are the cell's fused-index positions."""
    cells: Dict = {}
    for fq, runs in fused.maps.items():
        if act is not None and fq not in act:
            continue
        cl = []
        dim = fused.info[fq]
        elc = np.full(dim, -1, np.int32)
        eli = np.zeros(dim, np.int32)
        for (qa, qb2, off, da, db) in runs:
            if bond_is_first:
                qbond, p_qn, nb, nphys = qa, qb2, da, db
            else:
                p_qn, qbond, nphys, nb = qa, qb2, da, db
            qb_real = qbond if ct is None else group.sub(ct, qbond)
            idx_within = 0
            for p, q in enumerate(quanta):
                if q != p_qn:
                    continue
                cid = len(cl)
                if bond_is_first:
                    first, stride = off + idx_within, db
                else:
                    first, stride = off + idx_within * db, 1
                rows = first + stride * np.arange(nb)
                elc[rows] = cid
                eli[rows] = np.arange(nb)
                cl.append((qb_real, p, nb, first, stride))
                idx_within += 1
        cells[fq] = (cl, elc, eli)
    return cells


def build_mix_plan_v3(meta_env: StackedMeta, entries, quanta,
                      fused, bond_is_first: bool, join_on_input: bool,
                      group, out_bond_dqs, comp_target=None,
                      active=None, fused_ket=None, comp_target_ket=None,
                      active_ket=None, T: Optional[int] = None
                      ) -> Optional[MixPlanV3]:
    g = group
    fused_k = fused if fused_ket is None else fused_ket
    ct_k = comp_target if comp_target_ket is None else comp_target_ket
    act_k = active if active_ket is None else active_ket

    tab_b = _build_tab(fused, quanta, comp_target, active, bond_is_first, g)
    tab_k = _build_tab(fused_k, quanta, ct_k, act_k, bond_is_first, g)

    # --- entry rows -------------------------------------------------------
    ent_by: Dict[int, List[Tuple[int, int, int, complex]]] = {}
    iscpx = False
    for (i, o), w in sorted(entries.items()):
        jsym = i if join_on_input else o
        osym = o if join_on_input else i
        if np.iscomplexobj(w):
            iscpx = True
        for pb, pk in zip(*_w_nonzero(w)):
            ent_by.setdefault(jsym, []).append(
                (osym, int(pb), int(pk), w[pb, pk]))
    if not ent_by:
        return None
    cdtype = np.complex128 if iscpx else np.float64

    # --- per-group W + env layout ------------------------------------------
    # rows: distinct (osym, pb, pk) with any entry from the group's syms
    gemm_specs = []       # per live group: dict
    grow_lookup = []      # per live group: (packed row keys sorted, row ids)
    gsec_index = []       # per live group: {qlb: sector position}
    dq_to_gi = {}
    out_sym_sectors: Dict[int, Dict] = {}
    pair_of: Dict = {}   # (dq of osym, fused bra sector) -> fused ket sector
    dims_hint: List[int] = []
    for gi, (dq_g, syms) in enumerate(meta_env.groups):
        rows: Dict[Tuple[int, int, int], int] = {}
        nnz_r, nnz_j, nnz_c = [], [], []
        for j, s in enumerate(syms):
            ents = ent_by.get(int(s))
            if ents is None:
                continue
            for (osym, pb, pk, cf) in ents:
                key = (osym, pb, pk)
                r = rows.get(key)
                if r is None:
                    r = len(rows)
                    rows[key] = r
                nnz_r.append(r)
                nnz_j.append(j)
                nnz_c.append(cf)
        if not rows:
            continue
        sec = meta_env.sectors[gi]
        qlbs = sorted(sec)
        nsec = len(qlbs)
        eoff = np.fromiter((sec[q][0] for q in qlbs), np.int64, nsec)
        db = np.fromiter((sec[q][1] for q in qlbs), np.int64, nsec)
        dk = np.fromiter((sec[q][2] for q in qlbs), np.int64, nsec)
        dbdk = db * dk
        secoff = np.concatenate([[0], np.cumsum(dbdk)])
        nw = len(rows)
        ns = len(syms)
        # W in deduplicated COO form (partly sparse: at site 7 of the
        # K=16 QC state of chip_smoke.py phase 5, 15% of the LW mix's
        # dense GEMM FLOPs and 70% of the RW mix's fall on non-zeros), so
        # that the plan and its cross-process pickle do not hold the
        # dense form (the device kernels densify)
        rr = np.asarray(nnz_r, np.int64)
        jj = np.asarray(nnz_j, np.int64)
        vv = np.asarray(nnz_c, dtype=cdtype)
        key = rr * ns + jj
        order = np.argsort(key, kind="stable")
        key = key[order]
        vv = vv[order]
        first = np.ones(len(key), bool)
        first[1:] = key[1:] != key[:-1]
        seg = np.cumsum(first) - 1
        wv = np.zeros(int(seg[-1]) + 1, dtype=cdtype)
        np.add.at(wv, seg, vv)
        ukey = key[first]
        wr = (ukey // ns).astype(np.int32)
        wc = (ukey % ns).astype(np.int32)
        # discover valid output sectors (must match the v2 discovery)
        rkeys = list(rows)
        for s_i, qlb in enumerate(qlbs):
            qlk = g.sub(qlb, dq_g)
            for (osym, pb, pk) in rkeys:
                vb = tab_b.get((qlb, pb))
                vk = tab_k.get((qlk, pk))
                if vb is None or vk is None:
                    continue
                qLb = vb[0]
                d = out_sym_sectors.setdefault(osym, {})
                if qLb not in d:
                    d[qLb] = (fused.info[qLb], fused_k.info[vk[0]])
                pair_of[(out_bond_dqs[osym], qLb)] = vk[0]
                dims_hint += [int(db[s_i]), int(dk[s_i])]
        spec = {"gi": gi, "nw": nw, "ns": ns, "nsec": nsec,
                "wr": wr, "wc": wc, "wv": wv,
                "eoff": eoff, "dbdk": dbdk, "secoff": secoff,
                "db": db, "dk": dk,
                "qlb_pos": {q: i2 for i2, q in enumerate(qlbs)}}
        dq_to_gi[dq_g] = len(gemm_specs)
        gemm_specs.append(spec)
        npq = len(quanta)
        pk_keys = np.fromiter(
            (((k[0] * npq) + k[1]) * npq + k[2] for k in rkeys),
            np.int64, nw)
        # packed (osym, pb, pk) -> row id via sorted arrays
        order = np.argsort(pk_keys, kind="stable")
        grow_lookup.append((pk_keys[order], np.arange(nw)[order]))
        gsec_index.append(spec["qlb_pos"])
    if not gemm_specs:
        return None

    meta_out = StackedMeta.from_bond(out_bond_dqs, out_sym_sectors)

    # --- OUT layout (padded per-group strides) ------------------------------
    goff = []
    out_total = 0
    for spec in gemm_specs:
        dg_p = _cls(int(spec["secoff"][-1]))
        ns_p = _cls(spec["ns"])
        nw_p = _cls(spec["nw"])
        spec["dg_p"], spec["ns_p"], spec["nw_p"] = dg_p, ns_p, nw_p
        goff.append(out_total)
        out_total += nw_p * dg_p
    for spec, go_ in zip(gemm_specs, goff):
        spec["goff"] = go_

    # --- placement tables ---------------------------------------------------
    cells_b = _fused_cells(fused, quanta, comp_target, active,
                           bond_is_first, g)
    cells_k = _fused_cells(fused_k, quanta, ct_k, act_k, bond_is_first, g)

    # shared per-fused-sector row/col tables
    rowoff_of: Dict = {}
    rowcell_l, rowin_l = [], []
    for fq, (cl, elc, eli) in cells_b.items():
        rowoff_of[fq] = sum(len(a) for a in rowcell_l)
        rowcell_l.append(elc)
        rowin_l.append(eli)
    coloff_of: Dict = {}
    colcell_l, colin_l = [], []
    for fq, (cl, elc, eli) in cells_k.items():
        coloff_of[fq] = sum(len(a) for a in colcell_l)
        colcell_l.append(elc)
        colin_l.append(eli)

    sb_starts, sb_blksz, sb_dlk = [], [], []
    sb_rowoff, sb_coloff, sb_celloff, sb_ncc, sb_cells = [], [], [], [], []
    winsrc_l, windk_l = [], []
    # flat per-window copy plan (v4 place: OUT window -> slab block as
    # affine 2-D tile tasks): src base/row-stride, dst base/row/col
    # strides, extents
    wf_src, wf_sst, wf_dst, wf_rs, wf_cs, wf_nb, wf_nk = \
        [], [], [], [], [], [], []
    celloff = 0
    for go, (dq_o, osyms) in enumerate(meta_out.groups):
        secs = meta_out.sectors[go]
        for qLb in sorted(secs):
            ooff, DLb, DLk = secs[qLb]
            # output ket fused sector, recorded during discovery (the
            # RW complement bookkeeping makes a closed-form qLk - dq
            # derivation fragile; the tab-based pairing is exact)
            qLk = pair_of.get((dq_o, qLb))
            cb = cells_b.get(qLb)
            ck = cells_k.get(qLk) if qLk is not None else None
            if cb is None or ck is None:
                # covered sector with no cell table: all zero
                sb_starts.append(ooff)
                sb_blksz.append(DLb * DLk)
                sb_dlk.append(DLk)
                sb_rowoff.append(0)
                sb_coloff.append(0)
                sb_celloff.append(celloff)
                sb_ncc.append(1)
                sb_cells.append(0)
                continue
            cl_b, _, _ = cb
            cl_k, _, _ = ck
            ncr, ncc = len(cl_b), len(cl_k)
            nsym_o = len(osyms)
            ws = np.full(nsym_o * ncr * ncc, -1, np.int64)
            wd = np.zeros(nsym_o * ncr * ncc, np.int64)
            for cri, (qb_b, pb, nb_b, fr_b, sr_b) in enumerate(cl_b):
                for cci, (qb_k, pk, nb_k, fc_k, sc_k) in enumerate(cl_k):
                    dq_env = g.sub(qb_b, qb_k)
                    gidx = dq_to_gi.get(dq_env)
                    if gidx is None:
                        continue
                    spec = gemm_specs[gidx]
                    s_i = spec["qlb_pos"].get(qb_b)
                    if s_i is None:
                        continue
                    if int(spec["db"][s_i]) != nb_b or \
                            int(spec["dk"][s_i]) != nb_k:
                        continue
                    keys, rids = grow_lookup[gidx]
                    # vectorized row lookup over all osyms
                    npq = len(quanta)
                    qk = np.fromiter(
                        (((int(o_) * npq) + pb) * npq + pk
                         for o_ in osyms), np.int64, nsym_o)
                    pos = np.searchsorted(keys, qk)
                    pos = np.clip(pos, 0, len(keys) - 1)
                    hit = keys[pos] == qk
                    wrow = np.where(hit, rids[pos], -1)
                    base = (spec["goff"]
                            + wrow.astype(np.int64) * spec["dg_p"]
                            + int(spec["secoff"][s_i]))
                    idx = (np.arange(nsym_o) * (ncr * ncc)
                           + cri * ncc + cci)
                    ws[idx] = np.where(hit, base, -1)
                    wd[idx] = int(spec["dk"][s_i])
            sb_starts.append(ooff)
            sb_blksz.append(DLb * DLk)
            sb_dlk.append(DLk)
            sb_rowoff.append(rowoff_of[qLb])
            sb_coloff.append(coloff_of[qLk])
            sb_celloff.append(celloff)
            sb_ncc.append(ncc)
            sb_cells.append(ncr * ncc)
            winsrc_l.append(ws)
            windk_l.append(wd)
            celloff += nsym_o * ncr * ncc
            # flat windows in the same [jo, cri, cci] order as ws/wd
            live = ws >= 0
            if live.any():
                fr_a = np.fromiter((c_[3] for c_ in cl_b), np.int64, ncr)
                sr_a = np.fromiter((c_[4] for c_ in cl_b), np.int64, ncr)
                nb_a = np.fromiter((c_[2] for c_ in cl_b), np.int64, ncr)
                fc_a = np.fromiter((c_[3] for c_ in cl_k), np.int64, ncc)
                sc_a = np.fromiter((c_[4] for c_ in cl_k), np.int64, ncc)
                nk_a = np.fromiter((c_[2] for c_ in cl_k), np.int64, ncc)
                jo_g, cr_g, cc_g = np.meshgrid(
                    np.arange(nsym_o, dtype=np.int64), np.arange(ncr),
                    np.arange(ncc), indexing="ij")
                jo_f = jo_g.ravel()[live]
                cr_f = cr_g.ravel()[live]
                cc_f = cc_g.ravel()[live]
                wf_src.append(ws[live])
                wf_sst.append(wd[live])
                wf_dst.append(ooff + jo_f * (DLb * DLk)
                              + fr_a[cr_f] * DLk + fc_a[cc_f])
                wf_rs.append(sr_a[cr_f] * DLk)
                wf_cs.append(sc_a[cc_f])
                wf_nb.append(nb_a[cr_f])
                wf_nk.append(nk_a[cc_f])

    def pad32(a, n_p, fill=0):
        out = np.full(n_p, fill, np.int32)
        out[:len(a)] = np.asarray(a, np.int64).astype(np.int32)
        return out

    nsb = len(sb_starts)
    nsb_p = _pow2(nsb + 1)
    winsrc = (np.concatenate(winsrc_l) if winsrc_l
              else np.zeros(0, np.int64))
    windk = (np.concatenate(windk_l) if windk_l
             else np.zeros(0, np.int64))
    nwin_p = _pow2(len(winsrc) + 1)
    rowcell = np.concatenate(rowcell_l) if rowcell_l \
        else np.zeros(0, np.int32)
    rowin = np.concatenate(rowin_l) if rowin_l else np.zeros(0, np.int32)
    colcell = np.concatenate(colcell_l) if colcell_l \
        else np.zeros(0, np.int32)
    colin = np.concatenate(colin_l) if colin_l else np.zeros(0, np.int32)
    nrt_p = _pow2(len(rowcell) + 1)
    nct_p = _pow2(len(colcell) + 1)

    tables = {
        # sentinel superblock start = total => searchsorted clamps tail
        "sb_starts": pad32(sb_starts, nsb_p, fill=meta_out.total),
        "sb_blksz": pad32(sb_blksz, nsb_p),
        "sb_dlk": pad32(sb_dlk, nsb_p, fill=1),
        "sb_rowoff": pad32(sb_rowoff, nsb_p),
        "sb_coloff": pad32(sb_coloff, nsb_p),
        "sb_celloff": pad32(sb_celloff, nsb_p),
        "sb_ncc": pad32(sb_ncc, nsb_p, fill=1),
        "sb_cells": pad32(sb_cells, nsb_p),
        "rowcell": pad32(rowcell, nrt_p, fill=-1),
        "rowin": pad32(rowin, nrt_p),
        "colcell": pad32(colcell, nct_p, fill=-1),
        "colin": pad32(colin, nct_p),
        "winsrc": pad32(winsrc, nwin_p, fill=-1),
        "windk": pad32(windk, nwin_p, fill=1),
    }

    plan = MixPlanV3()
    plan.meta_out = meta_out
    plan.ncap_out = _cap_class(meta_out.total + 1)
    plan.gemms = gemm_specs
    plan.tables = tables
    plan.winflat = {
        "src": (np.concatenate(wf_src) if wf_src
                else np.zeros(0, np.int64)),
        "sst": (np.concatenate(wf_sst) if wf_sst
                else np.zeros(0, np.int64)),
        "dst": (np.concatenate(wf_dst) if wf_dst
                else np.zeros(0, np.int64)),
        "rs": (np.concatenate(wf_rs) if wf_rs
               else np.zeros(0, np.int64)),
        "cs": (np.concatenate(wf_cs) if wf_cs
               else np.zeros(0, np.int64)),
        "nb": (np.concatenate(wf_nb) if wf_nb
               else np.zeros(0, np.int64)),
        "nk": (np.concatenate(wf_nk) if wf_nk
               else np.zeros(0, np.int64)),
    }
    plan.out_total = out_total
    if out_total + 1 >= (1 << 31):
        raise ValueError("mix v3: OUT pool exceeds int32 addressing")
    plan.iscpx = iscpx
    plan.dims_hint = dims_hint
    plan.n_launch = len(gemm_specs)
    plan._dev = {}
    return plan


# ---------------------------------------------------------------------------
# K13's host tables: K3's tiles over the group-by-sector GEMM blocks
# ---------------------------------------------------------------------------

# j depth of one K3 item: a 64-bit mask of K3_SLICE-deep slices
K13_DEPTH = 64 * K3_SLICE


def _k13_items(blocks) -> np.ndarray:
    """K3 item rows [n, 12] (the columns k3_host_tables reads: W offset, W
    row stride, rows, E offset, E row stride, OUT offset, OUT row stride,
    width, depth) of the GEMM blocks ``blocks`` [m, 9] = (W offset, W row
    stride, rows nw, depth ns, E offset, E row stride, OUT offset, OUT row
    stride, width), each cut in j at :data:`K13_DEPTH` into items that
    share its OUT, in j order."""
    b = np.asarray(blocks, np.int64).reshape(-1, 9)
    nj = -(-b[:, 3] // K13_DEPTH)
    f = b[np.repeat(np.arange(len(b)), nj)]
    j0 = (np.arange(int(nj.sum())) - np.repeat(np.cumsum(nj) - nj, nj)) \
        * K13_DEPTH
    it = np.zeros((len(f), 12), np.int64)
    it[:, 0] = f[:, 0] + j0
    it[:, 1:3] = f[:, 1:3]
    it[:, 3] = f[:, 4] + j0 * f[:, 5]
    it[:, 4:7] = f[:, 5:8]
    it[:, 10] = f[:, 8]
    it[:, 11] = np.minimum(K13_DEPTH, f[:, 3] - j0)
    return it


def _k13_tiles(blocks, wdense, zero_to: int) -> Dict:
    """:func:`mixv4.k3_host_tables` of the GEMM blocks ``blocks`` (see
    :func:`_k13_items`) over OUT [0, zero_to); with no block, zero tiles
    only."""
    if len(blocks):
        return k3_host_tables(_k13_items(blocks), wdense, zero_to)
    kz, zt = _k3_gaps(np.zeros(0, np.int64), np.zeros(0, np.int64),
                      zero_to)
    kt = np.zeros((len(zt), 8), np.int64)
    kt[:, :4] = zt
    return {"kt": kt.astype(np.int32), "kl": np.zeros((0, 8), np.int32),
            "kz": kz.astype(np.int32), "steps": 0, "flops": 0.0,
            "flops_nz": 0.0, "written": 0, "zeros": int(kz[:, 1].sum())}


def _group_blocks(spec, woff: int, goff: int, c0: int, n: int, ostride):
    """The GEMM blocks of one group restricted to its columns [c0, c0 +
    n): one a sector that meets them, W at ``woff`` (rows of ns), the
    sector's env rows from the column's place in it, OUT at ``goff`` +
    (column - c0) with row stride ``ostride``."""
    sec = np.asarray(spec["secoff"], np.int64)
    lo = np.maximum(sec[:-1], c0)
    hi = np.minimum(sec[1:], c0 + n)
    s = np.flatnonzero(hi > lo)
    ns, nw = spec["ns"], spec["nw"]
    b = np.zeros((len(s), 9), np.int64)
    b[:, 0], b[:, 1], b[:, 2], b[:, 3] = woff, ns, nw, ns
    b[:, 4] = np.asarray(spec["eoff"], np.int64)[s] + lo[s] - sec[s]
    b[:, 5] = np.asarray(spec["dbdk"], np.int64)[s]
    b[:, 6] = goff + lo[s] - c0
    b[:, 7] = ostride
    b[:, 8] = hi[s] - lo[s]
    return b


def k13_host_tables(plan: MixPlanV3) -> Dict:
    """K13's host tables of a v3 plan, built once and kept in its
    ``_dev["k13"]``: the dense W pool ``wdense`` (each group's W_g [nw,
    ns] at ``woff[g]``, densified once here; duplicates add, as the
    reference's ``.at[].add``) and :func:`mixv4.k3_host_tables` over the
    group-by-sector GEMM blocks (the v4 plan's, ``mixv4.plan_v4``) and OUT
    [0, out_total): every element of each group's [nw_p, dg_p] block that
    no block writes (rows nw..nw_p, columns past secoff[nsec]) is a zero
    range.  ``seconds``: the whole build."""
    h = plan._dev.get("k13")
    if h is not None:
        return h
    if plan.iscpx:
        raise TypeError("mix v3 takes real plans only (the reference's "
                        "execute_mix_v3 drops imaginary parts)")
    t0 = time.perf_counter()
    woff = np.concatenate([[0], np.cumsum([g["nw"] * g["ns"]
                                           for g in plan.gemms])])
    wdense = np.zeros(int(woff[-1]) + 1, np.float64)
    blocks = []
    for g, wo in zip(plan.gemms, woff):
        np.add.at(wdense, wo + g["wr"].astype(np.int64) * g["ns"] + g["wc"],
                  np.asarray(g["wv"]).real)
        blocks.append(_group_blocks(g, int(wo), g["goff"], 0,
                                    int(g["secoff"][-1]), g["dg_p"]))
    h = _k13_tiles(np.concatenate(blocks), wdense, plan.out_total)
    h["wdense"], h["woff"] = wdense, woff
    h["seconds"] = time.perf_counter() - t0
    plan._dev["k13"] = h
    return h


def _k13_upload(h: Dict, n_out: int, wpool) -> Dict:
    """What a K13 launch reads, on the device of the W pool ``wpool``:
    the host tables ``h``' ``kt``, ``kl``, ``kz``, ``zlim`` = [n_out] (the
    OUT elements it stores, also kept as the host int ``n_out``)."""
    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=wpool.device)

    return {"kt": i32(h["kt"]), "kl": i32(h["kl"]), "kz": i32(h["kz"]),
            "zlim": i32([n_out]), "n_out": n_out, "wpool": wpool}


def k13_tables(plan: MixPlanV3, device, dtype) -> Dict:
    """K13's tables on ``device`` (:func:`_k13_upload` of
    :func:`k13_host_tables` over OUT [0, out_total), the dense W pool in
    ``dtype``), uploaded once and kept in the plan's ``_dev``."""
    key = ("k13", str(device), dtype)
    d = plan._dev.get(key)
    if d is None:
        h = k13_host_tables(plan)
        d = plan._dev[key] = _k13_upload(
            h, plan.out_total, torch.as_tensor(h["wdense"], dtype=dtype,
                                               device=device))
    return d


# ---------------------------------------------------------------------------
# device tables
# ---------------------------------------------------------------------------

def v3_tables(plan: MixPlanV3, device, dtype) -> Dict:
    """Device tables of a v3 plan for K13/K14 (and their twins), built
    once a device and dtype and kept in the plan's ``_dev``.  Per GEMM
    group (``gemms``): the COO triplets padded as the reference uploads
    them (``wr``, ``wc``, ``wv`` to ``_pow2(nnz + 1)``, zero-valued pads),
    ``eoff``/``dbdk`` [nsec_p] and ``secoff`` [nsec_p + 1] padded by
    repeats, the group's OUT offset and sizes — what the twin reads; then
    the place tables.  On a CUDA device also K13's (``k13``,
    :func:`k13_tables`) and per group what its window form cuts
    (``win``)."""
    if plan.iscpx or dtype.is_complex:
        raise TypeError("mix v3 takes real plans and types only (the "
                        "reference's execute_mix_v3 drops imaginary parts)")
    key = (str(device), dtype)
    d = plan._dev.get(key)
    if d is not None:
        return d

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    k13 = None
    if torch.device(device).type == "cuda":
        h = k13_host_tables(plan)
        k13 = k13_tables(plan, device, dtype)
    gemms = []
    for gi, spec in enumerate(plan.gemms):
        nnz, nsec = len(spec["wv"]), spec["nsec"]
        nnz_p, nsec_p = _pow2(nnz + 1), _pow2(nsec + 1)
        wr = np.zeros(nnz_p, np.int64)
        wr[:nnz] = spec["wr"]
        wc = np.zeros(nnz_p, np.int64)
        wc[:nnz] = spec["wc"]
        wv = np.zeros(nnz_p, np.float64)
        wv[:nnz] = spec["wv"]
        eoff = np.zeros(nsec_p, np.int64)
        eoff[:nsec] = spec["eoff"]
        dbdk = np.ones(nsec_p, np.int64)
        dbdk[:nsec] = spec["dbdk"]
        secoff = np.full(nsec_p + 1, spec["secoff"][-1], np.int64)
        secoff[:nsec + 1] = spec["secoff"]
        gemms.append({"wr": i32(wr), "wc": i32(wc),
                      "wv": torch.as_tensor(wv, dtype=dtype, device=device),
                      "eoff": i32(eoff), "dbdk": i32(dbdk),
                      "secoff": i32(secoff), "goff": spec["goff"],
                      "nw_p": spec["nw_p"], "ns": spec["ns"],
                      "ns_p": spec["ns_p"], "dg_p": spec["dg_p"],
                      "nnz": nnz})
        if k13 is not None:
            gemms[-1]["win"] = {"spec": spec, "woff": int(h["woff"][gi]),
                                "wdense": h["wdense"],
                                "wpool": k13["wpool"], "cut": {}}
    d = {k: i32(plan.tables[k]) for k in PLACE_TABLES}
    d["gemms"] = gemms
    d["k13"] = k13
    plan._dev[key] = d
    return d


# ---------------------------------------------------------------------------
# kernel K13 (env GEMM) and its plain twin
# ---------------------------------------------------------------------------

def env_gemm_twin(epool, dg: Dict, c0: int, n: int, out):
    """Plain PyTorch version of K13 (same signature as
    :func:`env_gemm_exec`): out [nw_p, n] = W @ ENV[:, c0:c0+n] with W
    densified from the COO triplets (duplicates add) and ENV[j, d] =
    epool[eoff[s] + j*dbdk[s] + d - secoff[s]], s the sector of column d,
    zero for d >= secoff[-1] (the reference's _env_gemm_chunk)."""
    nw_p, ns_p = dg["nw_p"], dg["ns_p"]
    W = torch.zeros(nw_p * ns_p, dtype=epool.dtype, device=epool.device)
    W.index_add_(0, dg["wr"].long() * ns_p + dg["wc"].long(), dg["wv"])
    secoff = dg["secoff"].long()
    d = c0 + torch.arange(n, device=epool.device)
    s = (torch.searchsorted(secoff, d, right=True) - 1).clamp(
        0, dg["eoff"].shape[0] - 1)
    j = torch.arange(ns_p, device=epool.device)[:, None]
    ok = (d < secoff[-1]) & (j < dg["ns"])   # rows j >= ns meet zero W
    src = dg["eoff"].long()[s] + j * dg["dbdk"].long()[s] + d - secoff[s]
    env = torch.where(ok, epool[torch.where(ok, src, 0)], 0)
    out.copy_(W.reshape(nw_p, ns_p) @ env)
    return out


def _k13_launch(epool, t: Dict, out) -> None:
    if out.numel() < t["n_out"]:
        raise ValueError(f"K13: OUT holds {out.numel()} elements, the "
                         f"tables store {t['n_out']}")
    _kernels.launch("K13_env_gemm", "b2t_env_gemm", epool.dtype, epool,
                    t["wpool"], t["kt"], t["kl"], t["kz"], t["zlim"],
                    t["kt"].shape[0], out)


def env_gemm_plan(epool, d: Dict, out):
    """Env GEMM (kernel K13) of every group of a plan into the flat OUT
    ``out`` (at least ``out_total`` long): each group's [nw_p, dg_p] block
    at its ``goff``, every element of it stored, in one launch; ``d`` from
    :func:`v3_tables`.  On CPU tensors the twin runs group by group."""
    if epool.device.type == "cpu":
        for dg in d["gemms"]:
            nw_p, dg_p = dg["nw_p"], dg["dg_p"]
            env_gemm_twin(epool, dg, 0, dg_p, out[
                dg["goff"]:dg["goff"] + nw_p * dg_p].view(nw_p, dg_p))
        return out
    if not epool.is_cuda:
        raise ValueError(f"unsupported device {epool.device}")
    _k13_launch(epool, d["k13"], out)
    return out


def window_host_tables(spec, woff: int, wdense, c0: int, n: int) -> Dict:
    """K13's host tables for columns [c0, c0 + n) of one group (its plan
    ``spec``, its W at ``woff`` of :func:`k13_host_tables`' ``wdense``)
    into out [nw_p, n]: the group's blocks cut to the window and re-based
    to ``out`` (row stride n), every other element of ``out`` a zero
    range."""
    return _k13_tiles(_group_blocks(spec, woff, 0, c0, n, n), wdense,
                      spec["nw_p"] * n)


def window_tables(dg: Dict, c0: int, n: int) -> Dict:
    """:func:`window_host_tables` of one group's window on the device
    (``h``: the host tables), built once a window and kept in
    ``dg["win"]["cut"]``."""
    w = dg["win"]
    t = w["cut"].get((c0, n))
    if t is None:
        h = window_host_tables(w["spec"], w["woff"], w["wdense"], c0, n)
        t = w["cut"][(c0, n)] = _k13_upload(h, dg["nw_p"] * n, w["wpool"])
        t["h"] = h
    return t


def env_gemm_exec(epool, dg: Dict, c0: int, n: int, out):
    """Env GEMM (kernel K13) of one group over columns [c0, c0 + n) into
    ``out`` [nw_p, n] (every element written; the reference's chunked
    jit); ``dg`` is one entry of :func:`v3_tables`' ``gemms``.  On CUDA
    tensors K13 runs on :func:`window_tables`."""
    if epool.device.type == "cpu":
        return env_gemm_twin(epool, dg, c0, n, out)
    if not epool.is_cuda:
        raise ValueError(f"unsupported device {epool.device}")
    if out.shape != (dg["nw_p"], n):
        raise ValueError(f"env_gemm_exec: out {tuple(out.shape)} (expected "
                         f"({dg['nw_p']}, {n}))")
    _k13_launch(epool, window_tables(dg, c0, n), out)
    return out


# ---------------------------------------------------------------------------
# kernel K14 (place) and its plain twin
# ---------------------------------------------------------------------------

def place_v3_src(d: Dict, c0: int, n: int):
    """(src, ok) for slab elements [c0, c0 + n): the OUT index of each
    element's window and whether one covers it — the reference's _place
    index arithmetic (searchsorted over the superblock starts, then the
    row/column cell tables and the window bases)."""
    t = {k: d[k].long() for k in PLACE_TABLES}
    i = c0 + torch.arange(n, device=d["winsrc"].device)
    nsb = t["sb_starts"].shape[0]
    sb = (torch.searchsorted(t["sb_starts"], i, right=True) - 1).clamp(
        0, nsb - 1)
    off = i - t["sb_starts"][sb]
    bs = t["sb_blksz"][sb].clamp(min=1)
    jo = off // bs
    rem = off - jo * bs
    dlk = t["sb_dlk"][sb].clamp(min=1)
    rr = rem // dlk
    cc = rem - rr * dlk
    live = i < t["sb_starts"][(sb + 1).clamp(max=nsb - 1)]
    rpos = (t["sb_rowoff"][sb] + rr).clamp(0, t["rowcell"].shape[0] - 1)
    cpos = (t["sb_coloff"][sb] + cc).clamp(0, t["colcell"].shape[0] - 1)
    cr, ri = t["rowcell"][rpos], t["rowin"][rpos]
    cl, ci = t["colcell"][cpos], t["colin"][cpos]
    wpos = (t["sb_celloff"][sb] + jo * t["sb_cells"][sb]
            + cr * t["sb_ncc"][sb] + cl).clamp(0, t["winsrc"].shape[0] - 1)
    ws = t["winsrc"][wpos]
    ok = (ws >= 0) & (cr >= 0) & (cl >= 0) & live
    return ws + ri * t["windk"][wpos] + ci, ok


def place_v3_twin(outflat, d: Dict, c0: int, n: int, out):
    """Plain PyTorch version of K14 (same signature as
    :func:`place_v3_exec`): out[i - c0] = outflat[src(i)] where a window
    covers slab element i, else 0."""
    for k in range(0, n, _TWIN_PLACE_ELEMS):
        m = min(_TWIN_PLACE_ELEMS, n - k)
        src, ok = place_v3_src(d, c0 + k, m)
        out[k:k + m] = torch.where(ok, outflat[torch.where(ok, src, 0)], 0)
    return out


def place_v3_exec(outflat, d: Dict, c0: int, n: int, out):
    """Place (kernel K14) of slab elements [c0, c0 + n) into ``out`` [n]
    (every element written, zeros included); ``d`` from
    :func:`v3_tables`."""
    if outflat.device.type == "cpu":
        return place_v3_twin(outflat, d, c0, n, out)
    if not outflat.is_cuda:
        raise ValueError(f"unsupported device {outflat.device}")
    _kernels.launch("K14_place_v3", "b2t_place_v3", outflat.dtype, outflat,
                    *(d[k] for k in PLACE_TABLES), d["sb_starts"].shape[0],
                    d["rowcell"].shape[0], d["colcell"].shape[0],
                    d["winsrc"].shape[0], c0, n, out)
    return out


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def execute_mix_v3(plan: MixPlanV3, epool):
    """LW/RW slab pool [ncap_out + 1] (zero sentinel last) from the env
    slab pool ``epool`` on its device and in its dtype — what the
    reference's execute_mix_v3 returns: K13 once into OUT (which it writes
    whole up to ``out_total``; the size-class tail past it is filled
    here), then K14 once."""
    d = v3_tables(plan, epool.device, epool.dtype)
    outflat = torch.empty(_cap_class(plan.out_total + 1), dtype=epool.dtype,
                          device=epool.device)
    outflat[plan.out_total:].zero_()
    env_gemm_plan(epool, d, outflat)
    n = plan.ncap_out + 1
    return place_v3_exec(outflat, d, 0, n, torch.empty(
        n, dtype=epool.dtype, device=epool.device))
