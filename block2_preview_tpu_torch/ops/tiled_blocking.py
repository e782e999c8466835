"""Tiled blocking engine v1 on stacked environment pools — kernel K12
(``B2TPU_STK_ENGINE=tiled_v1``).

Host side, copied from block2_preview_tpu/ops/tiled_blocking.py:
``_CFG`` (:46), ``TiledBlockingPlan`` and ``build_tiled_blocking_plan``
(:112-400), so every table equals the reference's.  Every blocking
contribution

    E'[o][(qrb, qrk)] += w[pb, pk] * mb^T E[i][(qlb, qlk)] mk     (left)
    E'[i][(qlb, qlk)] += w[pb, pk] * mb  E[o][(qrb, qrk)] mk^T    (right)

is a set of T x T tile tasks in three stages, grouped under per-group
budgets (B tasks per stage, nt1 tmp tiles, ntp prod tiles):

  stage 1:  tmp[s1 tmp id]   += E_tile . mk_tile       (right: mk_tile^T)
  stage 2:  prod[s2 prod id] += mb_tile^T . tmp[src]   (right: mb_tile)
  stage 3:  out[block positions] += coef * prod[src]

``s1`` [G, 9, B]: ebase, estr, ermax, ecmax, kbase, kstr, krmax, kcmax,
tmp id; ``s2`` [G, 6, B]: bbase, bstr, brmax, bcmax, tmp src, prod id;
``s3`` [G, 5, B]: prod src, obase, ostr, ormax, ocmax; ``coef`` [G, B].
Padding tasks have tmp id ``nt1``, prod id ``ntp`` or obase -1.

Device side: K12 (``csrc/tiled_blocking.cu``, replaces
``_tiled_blocking_exec`` :64) runs the whole plan in one C call on the
compact tables of :func:`tblk_host` — the live tasks only, groups packed
into waves of at most ``_WAVE_ELEMS`` scratch elements, tile ids global
within a wave; per wave stage 1, stage 2 (one CUDA block a tile, segment
sums, no atomics), then stage 3 on the gather-by-output mix core shared
with K11 (``csrc/mix_gather.cuh``).  The padded [G, ., B] tables stay on
the host.  :func:`tblk_plain` is its plain twin on the same tables, used
for CPU tensors only.  ``execute_tiled_blocking`` returns the output pool
[ncap] (zero above ``meta_out.total``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _kernels, stacked
from .csr import w_nonzero as _w_nonzero
from .stacked import StackedMeta, _cap_class, expand_entries, site_pools
from .tiled import _pow2, pick_tile
from .tilev2 import gather_tiles
from ..core.symmetry import QN

# per tile size: (task chunk B, tmp tiles, prod tiles)
_CFG = {16: (8192, 16384, 16384), 32: (8192, 8192, 8192),
        64: (4096, 4096, 4096), 128: (4096, 2048, 2048)}
# K12's scratch budget: the tmp + prod tile elements of one wave of task
# groups (256 MiB at f64)
_WAVE_ELEMS = 1 << 25


class TiledBlockingPlan:
    """The reference's v1 tables (module docstring) with ``meta_out``,
    ``T``, ``nt1``, ``ntp``, ``ncap``, ``left``; ``bra_pool`` /
    ``ket_pool``: (site value matrices, offsets), refreshed by
    ``refresh_plan_sites``; ``flops``: 2 (dl dk dy + dx dl dy) summed over
    the plan's (item, entry-symbol) products at true dims; ``_dev`` caches
    device tables and pools."""

    __slots__ = ("meta_out", "T", "nt1", "ntp", "ncap", "left",
                 "s1", "s2", "s3", "coef", "bra_pool", "ket_pool", "flops",
                 "_dev", "_src")


def build_tiled_blocking_plan(meta_in: StackedMeta, entries, quanta,
                              bra_T, ket_T, group, direction: str,
                              bond_dqs_in, bond_dqs_out,
                              T: Optional[int] = None
                              ) -> Optional[TiledBlockingPlan]:
    """Same contract as ops.stacked.build_stacked_plan, tiled execution."""
    left = direction == "left"

    # site tensor registries keyed (bond sector, phys state) -> flat pools
    bra_tab: Dict[Tuple[QN, int], Tuple[int, Tuple[int, int], QN]] = {}
    ket_tab: Dict[Tuple[QN, int], Tuple[int, Tuple[int, int], QN]] = {}
    bra_mats: List[np.ndarray] = []
    ket_mats: List[np.ndarray] = []

    def reg(Tn, tab, mats):
        for (ql, qp, qr), b in sorted(Tn.blocks.items()):
            for p, q in enumerate(quanta):
                if q != qp:
                    continue
                m = b.reshape(b.shape[0], b.shape[2])
                if left:
                    tab[(ql, p)] = (len(mats), m.shape, qr)
                else:
                    tab[(qr, p)] = (len(mats), m.shape, ql)
                mats.append(m)

    reg(bra_T, bra_tab, bra_mats)
    reg(ket_T, ket_tab, ket_mats)
    if not bra_mats or not ket_mats:
        return None
    boffs = np.concatenate(
        [[0], np.cumsum([m.size for m in bra_mats])]).astype(np.int64)
    koffs = np.concatenate(
        [[0], np.cumsum([m.size for m in ket_mats])]).astype(np.int64)

    # entries grouped by (in-group, pb, pk, j) -> [(osym, coef)]
    ent_by: Dict[Tuple[int, int, int], Dict[int, List]] = {}
    for (i, o), w in sorted(entries.items()):
        jsym = i if left else o
        osym = o if left else i
        gp = meta_in.sym_pos.get(jsym)
        if gp is None:
            continue
        g, j = gp
        for pb, pk in zip(*_w_nonzero(w)):
            ent_by.setdefault((g, int(pb), int(pk)), {}).setdefault(
                j, []).append((osym, complex(w[pb, pk]) if
                               np.iscomplexobj(w) else float(w[pb, pk])))
    # the entries flat, by (key, j): segment start / length per (key, j)
    segs: Dict[Tuple[int, int, int], List[Tuple[int, int, int]]] = {}
    flat = []
    for key, by_j in sorted(ent_by.items()):
        segs[key] = []
        for j, ents in sorted(by_j.items()):
            segs[key].append((j, len(flat), len(ents)))
            flat += ents
    ent_os = np.asarray([e[0] for e in flat], np.int64)
    ent_c = np.asarray([isinstance(e[1], complex) for e in flat], bool)
    ent_cf = np.asarray([e[1] for e in flat])

    # item list: (eoff_j, db, dk, mb_id, mk_id, dx, dy, qrb, entry segment
    # start, length), one per (key, sector, j)
    items = []
    dims = []
    for (g, pb, pk), by_j in sorted(ent_by.items()):
        dq_g, syms = meta_in.groups[g]
        for qlb, (eoff, db, dkk) in sorted(meta_in.sectors[g].items()):
            qlk = group.sub(qlb, dq_g)
            vb = bra_tab.get((qlb, pb))
            vk = ket_tab.get((qlk, pk))
            if vb is None or vk is None:
                continue
            mb_id, (s1_, s2_), qrb = vb
            mk_id, (t1_, t2_), _qrk = vk
            if left:
                dl, dx = s1_, s2_
                dkk2, dy = t1_, t2_
            else:
                dx, dl = s1_, s2_
                dy, dkk2 = t1_, t2_
            assert dl == db and dkk2 == dkk
            for j, e0, ne in segs[(g, pb, pk)]:
                items.append((eoff + j * db * dkk, db, dkk, mb_id, mk_id,
                              dx, dy, qrb, e0, ne))
            dims += [db, dkk, dx, dy]
    if not items:
        return None
    nit = len(items)
    cols = [np.fromiter((it[c] for it in items), np.int64, nit)
            for c in (0, 1, 2, 3, 4, 5, 6, 8, 9)]
    eoff_a, db_a, dk_a, mb_a, mk_a, dx_a, dy_a, e0_a, n_ents_alloc = cols
    # output sectors and the valid flattened entries per item (stage 3)
    meta_out, e_row, e_pos, e_tgt, e_ok = expand_entries(
        e0_a, n_ents_alloc, [it[7] for it in items], dx_a, dy_a, ent_os,
        bond_dqs_out)
    if T is None:
        T = pick_tile(np.asarray(dims))
    B, nt1, ntp = _CFG[T]
    ncap = _cap_class(meta_out.total + 1)

    iscpx = any(np.iscomplexobj(m) for m in bra_mats + ket_mats) or \
        bool(ent_c[e_pos].any())

    nl_a = -(-db_a // T)
    nk_a = -(-dk_a // T)
    nx_a = -(-dx_a // T)
    ny_a = -(-dy_a // T)
    e_item = e_row[e_ok]
    e_base, e_odx, e_ody = e_tgt[e_ok, 0], e_tgt[e_ok, 1], e_tgt[e_ok, 2]
    e_cf = ent_cf[e_pos[e_ok]]
    if not iscpx:
        e_cf = e_cf.real
    nval = np.bincount(e_item, minlength=nit).astype(np.int64)
    itmp = nl_a * ny_a
    iprod = nx_a * ny_a
    n1_a = itmp * nk_a
    n2_a = iprod * nl_a
    n3_alloc = iprod * n_ents_alloc
    n3_val = iprod * nval
    if nit and (itmp.max() > nt1 or iprod.max() > ntp or n1_a.max() > B
                or n2_a.max() > B or n3_alloc.max() > B):
        raise ValueError(f"block too large for T={T}")
    # greedy grouping (budget uses the conservative stage-3 count): each
    # group is the longest run of items whose stage sums all fit, found by
    # searchsorted on the prefix sums (the reference's per-item scan)
    csum = [np.concatenate([[0], np.cumsum(a)]).astype(np.int64)
            for a in (itmp, iprod, n1_a, n2_a, n3_alloc)]
    starts = []
    i0 = 0
    while i0 < nit:
        starts.append(i0)
        i0 = max(min(int(np.searchsorted(c, c[i0] + cap, "right")) - 1
                     for c, cap in zip(csum, (nt1, ntp, B, B, B))), i0 + 1)
    starts_a = np.asarray(starts, np.int64)
    grp = np.repeat(np.arange(len(starts), dtype=np.int64),
                    np.diff(np.concatenate([starts_a, [nit]])))
    first = starts_a[grp]
    c3v = np.concatenate([[0], np.cumsum(n3_val)]).astype(np.int64)
    tb_a = csum[0][:-1] - csum[0][first]
    pb_a2 = csum[1][:-1] - csum[1][first]
    o1_a = csum[2][:-1] - csum[2][first]
    o2_a = csum[3][:-1] - csum[3][first]
    o3_a = c3v[:-1] - c3v[first]
    g = len(starts) - 1
    ng = (g + 1) if nit else 0
    G = _pow2(max(ng, 1))
    s1A = np.zeros((G, 9, B), dtype=np.int64)
    s1A[:, 8, :] = nt1
    s2A = np.zeros((G, 6, B), dtype=np.int64)
    s2A[:, 5, :] = ntp
    s3A = np.zeros((G, 5, B), dtype=np.int64)
    s3A[:, 1, :] = -1
    cfA = np.zeros((G, B), dtype=np.complex128 if iscpx else np.float64)
    if nit:
        # stage 1: tasks ordered (li, yi, ki)
        tot = int(n1_a.sum())
        itm = np.repeat(np.arange(nit), n1_a)
        cum = np.concatenate([[0], np.cumsum(n1_a)[:-1]])
        o = np.arange(tot) - np.repeat(cum, n1_a)
        nk1 = nk_a[itm]
        ny1 = ny_a[itm]
        li = o // (ny1 * nk1)
        yi = (o // nk1) % ny1
        ki = o % nk1
        gi = grp[itm]
        pos = np.repeat(o1_a, n1_a) + o
        dkI = dk_a[itm]
        dyI = dy_a[itm]
        s1A[gi, 0, pos] = eoff_a[itm] + li * T * dkI + ki * T
        s1A[gi, 1, pos] = dkI
        s1A[gi, 2, pos] = db_a[itm] - li * T
        s1A[gi, 3, pos] = dkI - ki * T
        if left:
            s1A[gi, 4, pos] = koffs[mk_a[itm]] + ki * T * dyI + yi * T
            s1A[gi, 5, pos] = dyI
            s1A[gi, 6, pos] = dkI - ki * T
            s1A[gi, 7, pos] = dyI - yi * T
        else:
            s1A[gi, 4, pos] = koffs[mk_a[itm]] + yi * T * dkI + ki * T
            s1A[gi, 5, pos] = dkI
            s1A[gi, 6, pos] = dyI - yi * T
            s1A[gi, 7, pos] = dkI - ki * T
        s1A[gi, 8, pos] = np.repeat(tb_a, n1_a) + li * ny1 + yi
        # stage 2: tasks ordered (xi, yi, li)
        tot = int(n2_a.sum())
        itm = np.repeat(np.arange(nit), n2_a)
        cum = np.concatenate([[0], np.cumsum(n2_a)[:-1]])
        o = np.arange(tot) - np.repeat(cum, n2_a)
        nl2 = nl_a[itm]
        ny2 = ny_a[itm]
        xi = o // (ny2 * nl2)
        yi = (o // nl2) % ny2
        li = o % nl2
        gi = grp[itm]
        pos = np.repeat(o2_a, n2_a) + o
        dbI = db_a[itm]
        dxI = dx_a[itm]
        if left:
            s2A[gi, 0, pos] = boffs[mb_a[itm]] + li * T * dxI + xi * T
            s2A[gi, 1, pos] = dxI
            s2A[gi, 2, pos] = dbI - li * T
            s2A[gi, 3, pos] = dxI - xi * T
        else:
            s2A[gi, 0, pos] = boffs[mb_a[itm]] + xi * T * dbI + li * T
            s2A[gi, 1, pos] = dbI
            s2A[gi, 2, pos] = dxI - xi * T
            s2A[gi, 3, pos] = dbI - li * T
        s2A[gi, 4, pos] = np.repeat(tb_a, n2_a) + li * ny2 + yi
        s2A[gi, 5, pos] = np.repeat(pb_a2, n2_a) + xi * ny2 + yi
        # stage 3: per valid entry, tiles ordered (xi, yi)
        nve = len(e_item)
        if nve:
            e_item_a = np.asarray(e_item, dtype=np.int64)
            per = iprod[e_item_a]
            tot = int(per.sum())
            ei = np.repeat(np.arange(nve), per)
            cum = np.concatenate([[0], np.cumsum(per)[:-1]])
            o = np.arange(tot) - np.repeat(cum, per)
            it3 = e_item_a[ei]
            ny3 = ny_a[it3]
            xi = o // ny3
            yi = o % ny3
            gi = grp[it3]
            # position: per-item stage-3 base + offset of this entry's
            # tile block within the item
            ent_rank = np.arange(nve, dtype=np.int64) - np.searchsorted(
                e_item, e_item, side="left")
            pos = np.repeat(o3_a[e_item_a] + ent_rank * iprod[e_item_a],
                            per) + o
            odyI = np.asarray(e_ody, dtype=np.int64)[ei]
            odxI = np.asarray(e_odx, dtype=np.int64)[ei]
            s3A[gi, 0, pos] = np.repeat(pb_a2[e_item_a], per) \
                + xi * ny3 + yi
            s3A[gi, 1, pos] = np.asarray(e_base, dtype=np.int64)[ei] \
                + xi * T * odyI + yi * T
            s3A[gi, 2, pos] = odyI
            s3A[gi, 3, pos] = odxI - xi * T
            s3A[gi, 4, pos] = odyI - yi * T
            cfA[gi, pos] = np.asarray(e_cf)[ei]

    plan = TiledBlockingPlan()
    plan.meta_out = meta_out
    plan.T = T
    plan.nt1 = nt1
    plan.ntp = ntp
    plan.ncap = ncap
    plan.left = left
    plan.s1 = s1A
    plan.s2 = s2A
    plan.s3 = s3A
    plan.coef = cfA
    plan.bra_pool = (bra_mats, boffs)
    plan.ket_pool = (ket_mats, koffs)
    plan.flops = float(2 * (db_a * dk_a * dy_a + dx_a * db_a * dy_a).sum())
    plan._dev = {}
    plan._src = (bra_T, ket_T)
    return plan


# ---------------------------------------------------------------------------
# kernel K12 and its plain twin
# ---------------------------------------------------------------------------

def _prefix(live):
    """The count of live tasks in each group of a [G, B] mask; they must
    be a prefix of the group's row (the builder fills each group from the
    front)."""
    n = live.sum(1)
    if not np.array_equal(live, np.arange(live.shape[1]) < n[:, None]):
        raise ValueError("a group's live tasks are not a prefix of its row")
    return n


def _compact(a, n):
    """The first ``n[g]`` tasks of every group g of a [G, C, B] (or
    [G, B]) stage table, concatenated over groups, and each task's
    group."""
    gs = np.flatnonzero(n)
    if not len(gs):
        return a[0, ..., :0], gs
    return (np.concatenate([a[g, ..., :n[g]] for g in gs.tolist()], -1),
            np.repeat(gs, n[gs]))


def _starts(ids, n: int, what: str):
    """Segment starts [n + 1] of tasks sorted by tile id ``ids`` in [0, n)
    (the reference sums them with ``indices_are_sorted=True``)."""
    if len(ids) and np.any(np.diff(ids) < 0):
        raise ValueError(f"{what} tasks are not sorted by tile")
    return np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n))])


def tblk_host(plan: TiledBlockingPlan) -> Dict:
    """K12's host tables, cached on the plan (``plan._dev["k12"]``): the
    live tasks of every group (the ``n1``/``n2``/``n3`` prefixes of its
    rows; the rest is padding), concatenated over groups, with the groups
    packed in order into waves whose tmp + prod tiles take at most
    ``_WAVE_ELEMS`` scratch elements (a group alone may take more).

    ``s1`` [8, n1] (stage 1 without its id) and ``seg1`` [tmp tiles + 1],
    its segment starts over the plan's tmp tiles numbered in group order;
    ``s2`` [5, n2] (the tmp source now the tile's slot in its wave's
    scratch) and ``seg2``; stage 3 as the mix core's tables
    (``ops.stacked.gather_tables``): one block an output tile of a wave
    (window min(ormax, T) x min(ocmax, T) at obase, stride ostr; the blocks
    of a wave contiguous, by obase), its terms the prod slot's offset
    (slot x T^2) and coefficient; ``waves`` [n_waves, 6] int64 (first tmp
    tile, tmp tiles, first prod tile, prod tiles, first unit, units) and
    ``wave_blocks`` [n_waves + 1]; ``groups`` [n, 4] (group, n1, n2, n3) of
    the live groups and ``wave_of`` [n] their waves; ``ntmp``/``nprod``:
    the largest wave's tiles."""
    h = plan._dev.get("k12")
    if h is not None:
        return h
    coef = np.asarray(plan.coef)
    if np.iscomplexobj(coef):
        raise TypeError("complex blocking plans are not on this slice")
    T = plan.T
    s1, s2, s3 = (np.asarray(a) for a in (plan.s1, plan.s2, plan.s3))
    n1 = _prefix(s1[:, 8, :] < plan.nt1)
    n2 = _prefix(s2[:, 5, :] < plan.ntp)
    n3 = _prefix(s3[:, 1, :] >= 0)
    c1, g1 = _compact(s1, n1)
    c2, g2 = _compact(s2, n2)
    c3, g3 = _compact(s3, n3)
    # tiles a group: its last task's id + 1 (ids are sorted within a
    # group, as _starts checks below)
    ntmp, nprod = np.zeros(len(n1), np.int64), np.zeros(len(n1), np.int64)
    for n, ids, tiles in ((n1, c1[8], ntmp), (n2, c2[5], nprod)):
        tiles[n > 0] = ids[np.cumsum(n)[n > 0] - 1] + 1
    groups = np.flatnonzero(n1 + n2 + n3 > 0)
    # waves: consecutive live groups while their scratch fits
    need = (ntmp + nprod) * T * T
    wave_of = np.zeros(len(groups), np.int64)
    w, used = 0, 0
    for i, g in enumerate(groups.tolist()):
        if used and used + need[g] > _WAVE_ELEMS:
            w, used = w + 1, 0
        wave_of[i], used = w, used + need[g]
    n_waves = w + 1 if len(groups) else 0
    wave = np.zeros(len(n1), np.int64)
    wave[groups] = wave_of
    first = groups[np.searchsorted(wave_of, np.arange(n_waves))]

    def bases(n):
        """(first tile over the plan, first slot in its wave's scratch) of
        each group's tiles."""
        glob = np.concatenate([[0], np.cumsum(n)[:-1]])
        return glob, glob - glob[first][wave]

    tglob, tslot = bases(ntmp)
    pglob, pslot = bases(nprod)
    seg1 = _starts(c1[8] + tglob[g1], int(ntmp.sum()), "stage-1")
    seg2 = _starts(c2[5] + pglob[g2], int(nprod.sum()), "stage-2")
    # stage 3: output tiles of a wave; obase made dense before the wave
    present = np.zeros(plan.ncap, bool)
    present[c3[1]] = True
    obases = np.flatnonzero(present)
    dense = np.zeros(plan.ncap, np.int64)
    dense[obases] = np.arange(len(obases))
    core = stacked.gather_tables(
        wave[g3] * len(obases) + dense[c3[1]], n_waves * len(obases),
        np.stack([c3[1], c3[2], np.minimum(c3[3], T),
                  np.minimum(c3[4], T)], 1),
        (c3[0] + pslot[g3]) * T * T, _compact(coef, n3)[0])
    wave_blocks = np.searchsorted(core["keys"] // max(len(obases), 1),
                                  np.arange(n_waves + 1))
    units = np.searchsorted(core["units"][:, 0], wave_blocks)
    waves = np.stack([tglob[first], np.bincount(wave_of, ntmp[groups],
                                                n_waves),
                      pglob[first], np.bincount(wave_of, nprod[groups],
                                                n_waves),
                      units[:-1], np.diff(units)], 1).astype(np.int64)
    h = {"s1": c1[:8], "seg1": seg1,
         "s2": np.concatenate([c2[:4], c2[4:5] + tslot[g2]]), "seg2": seg2,
         "core": core, "waves": waves,
         "wave_blocks": wave_blocks,
         "groups": np.stack([groups, n1[groups], n2[groups], n3[groups]], 1),
         "wave_of": wave_of,
         "ntmp": int(waves[:, 1].max()) if n_waves else 0,
         "nprod": int(waves[:, 3].max()) if n_waves else 0}
    plan._dev["k12"] = h
    return h


def tblk_tables(plan: TiledBlockingPlan, device, dtype) -> Dict:
    """K12's tables (its plain version's too) on ``device``, cached on the
    plan per (device, dtype): :func:`tblk_host`'s ``s1``, ``seg1``,
    ``s2``, ``seg2`` as int32, the core's tables under ``core``
    (``ops.stacked.gather_device``), and on the host ``waves`` (read by
    the C call), ``wave_blocks``, ``seg1_h``/``seg2_h``, ``ntmp`` and
    ``nprod``.  The reference's padded [G, ., B] tables never reach the
    device."""
    key = ("k12", str(device), dtype)
    d = plan._dev.get(key)
    if d is not None:
        return d
    from .exec_bucket import _int32
    h = tblk_host(plan)
    d = {k: torch.as_tensor(_int32(h[k], f"a K12 {k} entry"), device=device)
         for k in ("s1", "seg1", "s2", "seg2")}
    d.update(core=stacked.gather_device(h["core"], device, dtype, "K12's"),
             waves=np.ascontiguousarray(h["waves"], np.int64),
             wave_blocks=h["wave_blocks"], seg1_h=h["seg1"],
             seg2_h=h["seg2"], ntmp=h["ntmp"], nprod=h["nprod"])
    plan._dev[key] = d
    return d


def _tile_ids(seg, t0: int, n: int, dev):
    """Each task's slot among tiles [t0, t0 + n) of segment starts seg."""
    counts = torch.as_tensor(np.diff(seg[t0:t0 + n + 1]), device=dev)
    return torch.repeat_interleave(torch.arange(n, device=dev), counts)


def tblk_plain(ep, bp, kp, d: Dict, T: int, left: bool, out):
    """Plain PyTorch version of K12 on K12's own tables, wave by wave: the
    reference's scan body — tile gathers, batched products, ``index_add_``
    into the wave's tmp and prod tiles in place of its sorted
    ``segment_sum`` — then stage 3 by the mix core's plain version
    (``ops.stacked.gather_plain``) over the wave's output tiles.  Adds into
    ``out``; returns it."""
    dev = out.device
    for w, (t0, nt, p0, npr, _u0, _nu) in enumerate(d["waves"].tolist()):
        a, z = int(d["seg1_h"][t0]), int(d["seg1_h"][t0 + nt])
        g1 = d["s1"][:, a:z].long()
        ids = _tile_ids(d["seg1_h"], t0, nt, dev)
        E = gather_tiles(ep, g1[0], g1[1], g1[2], g1[3], T)
        K = gather_tiles(kp, g1[4], g1[5], g1[6], g1[7], T)
        tmp = out.new_zeros((nt, T, T)).index_add_(
            0, ids, torch.bmm(E, K if left else K.transpose(1, 2)))
        a, z = int(d["seg2_h"][p0]), int(d["seg2_h"][p0 + npr])
        g2 = d["s2"][:, a:z].long()
        ids = _tile_ids(d["seg2_h"], p0, npr, dev)
        Bm = gather_tiles(bp, g2[0], g2[1], g2[2], g2[3], T)
        prod = out.new_zeros((npr, T, T)).index_add_(
            0, ids, torch.bmm(Bm.transpose(1, 2) if left else Bm,
                              tmp[g2[4]]))
        stacked.gather_plain(prod.reshape(-1), d["core"], out, T,
                             int(d["wave_blocks"][w]),
                             int(d["wave_blocks"][w + 1]))
    return out


def tblk_exec(ep, bp, kp, d: Dict, T: int, left: bool, out):
    """v1 tiled blocking (kernel K12): adds the whole plan into the output
    pool ``out`` in one C call — per wave stage 1, stage 2, then stage 3
    on the mix core — on tmp/prod scratch sized for the largest wave.  CPU
    tensors run :func:`tblk_plain`."""
    if ep.device.type == "cpu":
        return tblk_plain(ep, bp, kp, d, T, left, out)
    if not ep.is_cuda:
        raise ValueError(f"unsupported device {ep.device}")
    tmp = out.new_empty(max(d["ntmp"], 1) * T * T)
    prod = out.new_empty(max(d["nprod"], 1) * T * T)
    c, waves = d["core"], d["waves"]
    _kernels.launch("K12_tiled_blocking", "b2t_tblk", ep.dtype, ep, bp, kp,
                    d["s1"], d["s1"].shape[1], d["seg1"], d["s2"],
                    d["s2"].shape[1], d["seg2"], c["units"], c["blk"],
                    c["bstart"], c["ts"], c["tc"], waves.ctypes.data,
                    len(waves), T, int(left), tmp, prod, out)
    return out


def execute_tiled_blocking(plan: TiledBlockingPlan, epool):
    """Output pool [ncap] (zero above ``meta_out.total``) of one blocking
    step from the source bond's pool ``epool``, on its device and in its
    dtype (kernel K12)."""
    dev, dt = epool.device, epool.dtype
    bp, kp = site_pools(plan, dev, dt)
    out = torch.zeros(plan.ncap, dtype=dt, device=dev)
    return tblk_exec(epool, bp, kp, tblk_tables(plan, dev, dt), plan.T,
                     plan.left, out)
