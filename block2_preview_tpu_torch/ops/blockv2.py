"""Environment blocking on the device — kernel K5 (+ K3 for v3 plans).

Host side, copied from block2_preview_tpu/ops/blockv2.py:221-763: the
plan builder ``build_blocking_v2`` and ``BlockingV2Plan`` /
``BlockingV3Plan``, so every table equals the reference's.  One blocking
step over a bond's slab pool computes, per contribution,

    E'[o][(qrb, qrk)] += w[pb, pk] * mb^T E[i][(qlb, qlk)] mk     (left)
    E'[i][(qlb, qlk)] += w[pb, pk] * mb  E[o][(qrb, qrk)] mk^T    (right)

as the reference's three stages on T x T tiles:

    stage 1:  tmp(l, y)  = sum_k E(l, k) mk(k, y)   (right: mk(y, k))
    stage 2:  prod(x, y) = sum_l mb(l, x) tmp(l, y) (right: mb(x, l))
    stage 3:  out[entry position] += coef * prod

Device side:

  K5 (``csrc/blocking.cu``, replaces ``_blk_scan`` :60 via
  ``_blk_exec_chunkp`` :177 / ``_blk_exec_chunk`` :157): one CUDA block per
  stage-1 unit (item, li, yi); stages 2 and 3 are linear, so the block adds
  coef x (its partial sum over l) for each entry of the item straight into
  the output pool with atomics.  One launch covers the whole plan: the
  reference's task groups (``g1/g2/g3``, ``tb``/``pb`` bases, the
  ``B``/``nt1``/``ntp`` budgets) and its launch chunking are not read.

``execute_blocking_v2`` runs K5 into the output pool; ``execute_blocking_v3``
runs K5 into the ROT pool (combos as the symbol axis, identity entries)
and then the symbol-mixing GEMM K3 (``csrc/mix.cu``) with the plan's
``gtab``/``wdense`` into the final pool (reference :766-816).  Both return
a pool [ncap] whose slots above ``meta_out.total`` are zero (the sentinel
K1 and K2 read).  On CPU tensors the wrappers run the plain twins; on CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .csr import w_triplets
from .mixv4 import emit_gemm_items, mix_exec
from .stacked import StackedMeta, _cap_class, _pow2, site_pools
from .tiled import pick_tile
from .tilev2 import _locate, gather_tiles, group_units, shard_groups
from ..core.symmetry import QN

# per tile size: (stage task capacity B, tmp tiles, prod tiles) — the
# reference's plan budgets; they shape the shared tables (T escalation,
# tb/pb bases, groups) but K5 reads none of them
_CFG = {16: (8192, 16384, 16384), 32: (8192, 8192, 8192),
        64: (4096, 4096, 4096), 128: (4096, 2048, 2048)}

# stage-1 tasks per chunk of the plain version (bounds its temporaries)
_TWIN_TASKS = 16384


class BlockingV2Plan:
    """it [n, 13] int32 item fields: ebase, dk, db, kbase, dy, bbase, dx,
    nl, nk, nx, ny, tb (tmp base), pb (prod base); ef [ne, 4] int32:
    item, obase, odx, ody; coef [ne]; cum1/cum2 [n+1] stage-1/2 task
    prefix sums; cum3 [ne+1] stage-3 tile prefix sums; g1/g2/g3 first
    task ids of the reference's groups.  bra_pool/ket_pool: (site value
    matrices, offsets), refreshed by ``refresh_plan_sites``.  ``_dev``
    caches the device tables per (device, dtype); ``_pools`` the packed
    site-value pools."""

    __slots__ = ("meta_out", "T", "B", "nt1", "ntp", "ncap", "left",
                 "it", "ef", "coef", "cum1", "cum2", "cum3",
                 "g1", "g2", "g3", "bra_pool", "ket_pool", "flops",
                 "_dev", "_src")


class BlockingV3Plan:
    """Blocking with the symbol mixing as a GEMM: the inner ``rot`` plan
    (a BlockingV2Plan whose entries are the identity) rotates every
    (combo, sector) block once into a ROT pool of ``rot_total`` elements,
    then the dense MPO coefficients ``wdense`` mix it into the final pool
    through the K3 item tables ``gtab`` (reference :253-322)."""

    __slots__ = ("rot", "meta_out", "ncap", "T", "flops", "gtab",
                 "wdense", "rot_total", "_dev")

    # site-value refresh delegates to the inner rotate plan
    @property
    def bra_pool(self):
        return self.rot.bra_pool

    @bra_pool.setter
    def bra_pool(self, v):
        self.rot.bra_pool = v

    @property
    def ket_pool(self):
        return self.rot.ket_pool

    @ket_pool.setter
    def ket_pool(self, v):
        self.rot.ket_pool = v

    @property
    def _src(self):
        return self.rot._src

    @_src.setter
    def _src(self, v):
        self.rot._src = v


# ---------------------------------------------------------------------------
# kernel K5 and its plain twin
# ---------------------------------------------------------------------------

def _cumu(plan: BlockingV2Plan) -> np.ndarray:
    """Prefix sums [n + 1] of the stage-1 units nl * ny of the live
    items."""
    it = plan.it.astype(np.int64)
    live = np.diff(plan.cum1.astype(np.int64)) > 0
    return np.concatenate([[0], np.cumsum(np.where(
        live, it[:, 7] * it[:, 10], 0))])


def blk_tables(plan: BlockingV2Plan, device, dtype) -> Dict:
    """Device tables of a v2 plan for K5 (and its twin), cached on the
    plan per (device, dtype).  Derived here, beside the shared layout:
    ``cumu`` [n+1], prefix sums of the stage-1 units nl * ny of the live
    items, and ``efs`` [n+1], each item's first entry row."""
    key = (str(device), dtype)
    d = plan._dev.get(key)
    if d is not None:
        return d
    cumu = _cumu(plan)
    ne = int(np.count_nonzero(np.diff(plan.cum3.astype(np.int64)) > 0))
    efs = np.searchsorted(plan.ef[:ne, 0], np.arange(len(plan.it) + 1),
                          side="left")
    if cumu[-1] >= (1 << 31):
        raise ValueError("blocking unit count exceeds int32")
    if np.iscomplexobj(plan.coef):
        raise TypeError("complex blocking plans are not on this slice")

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    d = {"it": i32(plan.it), "ef": i32(plan.ef), "cum1": i32(plan.cum1),
         "cum2": i32(plan.cum2), "cum3": i32(plan.cum3),
         "cumu": i32(cumu), "efs": i32(efs), "n_units": int(cumu[-1]),
         "coef": torch.as_tensor(plan.coef, dtype=dtype, device=device)}
    plan._dev[key] = d
    return d


def blk_twin(epool, bpool, kpool, d: Dict, T: int, left: bool, out,
             items=None):
    """Plain PyTorch version of K5 (same signature as :func:`blk_exec`):
    the reference's three stages, in chunks of whole items.  With
    ``items``, a list of item ranges (i0, i1) (one rank's task groups),
    only those run: the plain version of K21."""
    it = d["it"].long()
    ef, coef = d["ef"].long(), d["coef"]
    cum1, cum2, cum3 = d["cum1"].long(), d["cum2"].long(), d["cum3"].long()
    cumu, efs = d["cumu"].long(), d["efs"].long()
    # prod tiles nx * ny per live item, like cumu
    live = (cum1[1:] - cum1[:-1]) > 0
    cump = torch.cat([cum1.new_zeros(1), torch.cumsum(
        torch.where(live, it[:, 9] * it[:, 10], 0), 0)])
    c1h = d["cum1"].cpu().numpy().astype(np.int64)
    n = len(c1h) - 1
    r = torch.arange(T, device=out.device)[None, :, None]
    c = torch.arange(T, device=out.device)[None, None, :]
    chunks = []
    for i0, end in ([(0, n)] if items is None else items):
        while i0 < end and c1h[i0] < c1h[-1]:
            i1 = int(np.searchsorted(c1h, c1h[i0] + _TWIN_TASKS, "right"))
            i1 = min(max(i1 - 1, i0 + 1), end)
            chunks.append((i0, i1))
            i0 = i1
    for i0, i1 in chunks:
        u0 = int(cumu[i0])
        tmp = torch.zeros((int(cumu[i1]) - u0, T, T), dtype=out.dtype,
                          device=out.device)
        # stage 1: tasks (li, yi, ki)
        item, o = _locate(cum1, int(cum1[i0]), int(cum1[i1]))
        f = it[item]
        nk, ny = f[:, 8], f[:, 10]
        li, yi, ki = o // (ny * nk), (o // nk) % ny, o % nk
        E = gather_tiles(epool, f[:, 0] + li * T * f[:, 1] + ki * T,
                         f[:, 1], f[:, 2] - li * T, f[:, 1] - ki * T, T)
        if left:
            K = gather_tiles(kpool, f[:, 3] + ki * T * f[:, 4] + yi * T,
                             f[:, 4], f[:, 1] - ki * T, f[:, 4] - yi * T, T)
        else:
            K = gather_tiles(kpool, f[:, 3] + yi * T * f[:, 1] + ki * T,
                             f[:, 1], f[:, 4] - yi * T, f[:, 1] - ki * T,
                             T).transpose(1, 2)
        tmp.index_add_(0, cumu[item] + li * ny + yi - u0, torch.bmm(E, K))
        # stage 2: tasks (xi, yi, li)
        p0 = int(cump[i0])
        prod = torch.zeros((int(cump[i1]) - p0, T, T), dtype=out.dtype,
                           device=out.device)
        item, o = _locate(cum2, int(cum2[i0]), int(cum2[i1]))
        f = it[item]
        nl, ny = f[:, 7], f[:, 10]
        xi, yi, li = o // (ny * nl), (o // nl) % ny, o % nl
        if left:
            Bm = gather_tiles(bpool, f[:, 5] + li * T * f[:, 6] + xi * T,
                              f[:, 6], f[:, 2] - li * T, f[:, 6] - xi * T,
                              T).transpose(1, 2)
        else:
            Bm = gather_tiles(bpool, f[:, 5] + xi * T * f[:, 2] + li * T,
                              f[:, 2], f[:, 6] - xi * T, f[:, 2] - li * T, T)
        prod.index_add_(0, cump[item] + xi * ny + yi - p0,
                        torch.bmm(Bm, tmp[cumu[item] + li * ny + yi - u0]))
        # stage 3: tiles (xi, yi) of every entry of these items
        e0, e1 = int(efs[i0]), int(efs[i1])
        if e1 > e0:
            ent, o = _locate(cum3, int(cum3[e0]), int(cum3[e1]))
            e = ef[ent]
            ny3 = it[e[:, 0], 10]
            xi, yi = o // ny3, o % ny3
            vals = prod[cump[e[:, 0]] - p0 + xi * ny3 + yi] \
                * coef[ent][:, None, None]
            e, xi, yi = e[:, :, None, None], xi[:, None, None], \
                yi[:, None, None]
            idx = e[:, 1] + (xi * T + r) * e[:, 3] + yi * T + c
            ok = (r < e[:, 2] - xi * T) & (c < e[:, 3] - yi * T)
            out.index_add_(0, idx[ok], vals[ok])
    return out


def blk_exec(epool, bpool, kpool, d: Dict, T: int, left: bool, out):
    """Blocking (kernel K5): adds every contribution of the plan into the
    output pool ``out`` (zero-initialised by the caller) in place."""
    if epool.device.type == "cpu":
        return blk_twin(epool, bpool, kpool, d, T, left, out)
    if not epool.is_cuda:
        raise ValueError(f"unsupported device {epool.device}")
    _kernels.launch("K5_block", "b2t_block", epool.dtype, epool, bpool,
                    kpool, d["it"], d["cumu"], d["it"].shape[0], d["ef"],
                    d["coef"], d["efs"], d["n_units"], T, int(left), out)
    return out


# ---------------------------------------------------------------------------
# kernel K21: one rank's share of the operator-sharded blocking
# ---------------------------------------------------------------------------

def blk_rank_part(plan: BlockingV2Plan, rank: int, world: int,
                  device) -> Dict:
    """Rank ``rank`` of ``world``'s share of a v2 plan, on ``device``: the
    reference's round-robin interleave of the task groups (rank r runs the
    groups r, r + world, ...; ends in global group order first, reference
    blockv2.py:921-931, the same as the matvec's ``shard_groups``), as
    ``items`` (their item ranges, the plain version's), ``units`` (their
    stage-1 units, K21's index list, int32) and ``n_units``; cached on
    the plan."""
    key = ("part", rank, world, str(device))
    part = plan._dev.get(key)
    if part is not None:
        return part
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    g1i, g2i, e1i, e2i, ngl = shard_groups(plan.g1, plan.g2, plan.cum1,
                                           plan.cum2, world)
    sl = slice(rank * ngl, (rank + 1) * ngl)
    h = group_units(g1i[sl], e1i[sl], g2i[sl], e2i[sl], plan.cum1,
                    plan.cum2, _cumu(plan))
    part = {"items": h["items"], "n_units": int(h["units"].shape[0]),
            "units": torch.as_tensor(h["units"].astype(np.int32),
                                     device=device)}
    plan._dev[key] = part
    return part


def blk_exec_part(epool, bpool, kpool, d: Dict, part: Dict, T: int,
                  left: bool, out):
    """This rank's partial blocking (kernel K21): adds the contributions
    of the rank's task groups (``part`` from :func:`blk_rank_part`) into
    ``out`` in place.  CPU tensors run :func:`blk_twin` over the same
    items; CUDA tensors launch K21 (nothing when the rank owns no unit) or
    raise."""
    if epool.device.type == "cpu":
        return blk_twin(epool, bpool, kpool, d, T, left, out,
                        items=part["items"])
    if not epool.is_cuda:
        raise ValueError(f"unsupported device {epool.device}")
    if part["n_units"] > 0:
        _kernels.launch("K21_block_shard", "b2t_block_units", epool.dtype,
                        epool, bpool, kpool, d["it"], d["cumu"],
                        d["it"].shape[0], d["ef"], d["coef"], d["efs"],
                        part["units"], part["n_units"], T, int(left), out,
                        units=part["n_units"])
    return out


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def execute_blocking_v2(plan: BlockingV2Plan, epool, mesh=None,
                        axis: str = "op"):
    """Output pool [ncap] (zero above ``meta_out.total``) of one blocking
    step from the source bond's pool ``epool``, on its device and in its
    dtype (kernel K5).  With a ``mesh``, the task groups are split over
    its ``axis``: this rank's share runs on K21 and the partial pools are
    summed with ``all_reduce`` (the reference's psum, :193-216)."""
    dev, dt = epool.device, epool.dtype
    bpool, kpool = site_pools(plan, dev, dt)
    out = torch.zeros(plan.ncap, dtype=dt, device=dev)
    d = blk_tables(plan, dev, dt)
    if mesh is None:
        return blk_exec(epool, bpool, kpool, d, plan.T, plan.left, out)
    from ..parallel.multihost import all_reduce_, axis_info
    group, rank, world = axis_info(mesh, axis)
    blk_exec_part(epool, bpool, kpool, d, blk_rank_part(plan, rank, world,
                                                        dev),
                  plan.T, plan.left, out)
    return all_reduce_(out, group)


def mix_tables(plan: BlockingV3Plan, device, dtype) -> Dict:
    """K3 tables of a v3 plan's symbol-mixing GEMM, cached on the plan."""
    key = (str(device), dtype)
    d = plan._dev.get(key)
    if d is None:
        g = plan.gtab

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=device)

        if np.iscomplexobj(plan.wdense):
            raise TypeError("complex blocking plans are not on this slice")
        d = {"it": i32(g["it"]), "cum1": i32(g["cum1"]),
             "cum2": i32(g["cum2"]), "n2": int(g["cum2"][-1]),
             "wpool": torch.as_tensor(plan.wdense, dtype=dtype,
                                      device=device)}
        plan._dev[key] = d
    return d


def execute_blocking_v3(plan: BlockingV3Plan, epool, mesh=None,
                        axis: str = "op"):
    """K5 into the ROT pool, then the symbol-mixing GEMM (K3) into the
    final pool [ncap] (zero above ``meta_out.total``).  With a ``mesh``
    the rotate stage is sharded (K21 + ``all_reduce``); the mix stage is
    not, as in the reference (:766-776)."""
    rot = execute_blocking_v2(plan.rot, epool, mesh=mesh, axis=axis)
    d = mix_tables(plan, epool.device, epool.dtype)
    out = torch.zeros(plan.ncap, dtype=epool.dtype, device=epool.device)
    return mix_exec(rot, d["wpool"], d, out)


# ---------------------------------------------------------------------------
# host plan builder (copied from the reference)
# ---------------------------------------------------------------------------

def build_blocking_v2(meta_in: StackedMeta, entries, quanta,
                      bra_T, ket_T, group, direction: str,
                      bond_dqs_in, bond_dqs_out,
                      T: Optional[int] = None, gemm_mix: bool = False):
    """Same contract as ops.stacked.build_stacked_plan; compact per-item
    plan executed by _blk_exec.  Retries with a larger tile on budget
    overflow (a single huge block can exceed the per-group task budget
    at small T)."""
    left = direction == "left"

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

    # ---- flatten entries into flat arrays (vectorized over nonzeros;
    # at Cr2 mid-chain bonds the python dict-of-lists form of this cost
    # tens of seconds per bond) ----
    gl, jl, pbl, pkl, osl, cfl = [], [], [], [], [], []
    iscpx = any(np.iscomplexobj(m) for m in bra_mats + ket_mats)
    for (i, o), w in sorted(entries.items()):
        jsym = i if left else o
        osym = o if left else i
        gp = meta_in.sym_pos.get(jsym)
        if gp is None:
            continue
        r, c, v = w_triplets(w)
        n = len(r)
        if n == 0:
            continue
        if np.iscomplexobj(v):
            iscpx = True
        g, j = gp
        gl.append(np.full(n, g, np.int64))
        jl.append(np.full(n, j, np.int64))
        pbl.append(np.asarray(r, np.int64))
        pkl.append(np.asarray(c, np.int64))
        osl.append(np.full(n, osym, np.int64))
        cfl.append(np.asarray(v))
    if not gl:
        return None
    g_e = np.concatenate(gl)
    j_e = np.concatenate(jl)
    pb_e = np.concatenate(pbl)
    pk_e = np.concatenate(pkl)
    os_e = np.concatenate(osl)
    cf_e = np.concatenate(cfl).astype(
        np.complex128 if iscpx else np.float64)
    # stable sort by (g, pb, pk, j); entries keep their insertion order
    # within a combo (same accumulation order as the dict-based builder)
    order = np.lexsort((j_e, pk_e, pb_e, g_e))
    g_e, j_e = g_e[order], j_e[order]
    pb_e, pk_e = pb_e[order], pk_e[order]
    os_e, cf_e = os_e[order], cf_e[order]
    P = len(quanta)
    njmax = int(j_e.max()) + 1
    ckey = ((g_e * P + pb_e) * P + pk_e) * njmax + j_e
    newc = np.empty(len(ckey), bool)
    newc[0] = True
    np.not_equal(ckey[1:], ckey[:-1], out=newc[1:])
    cstart = np.flatnonzero(newc)            # combo -> first entry
    cend = np.concatenate([cstart[1:], [len(ckey)]])
    c_g = g_e[cstart]
    c_pb = pb_e[cstart]
    c_pk = pk_e[cstart]
    c_j = j_e[cstart]
    c_ne = cend - cstart

    # ---- dense (qn id, phys) lookup tables for bra/ket site blocks ----
    qn_ids: Dict[QN, int] = {}

    def _qid(q):
        i = qn_ids.get(q)
        if i is None:
            i = len(qn_ids)
            qn_ids[q] = i
        return i

    for (ql, _p), (_m, _s, qr) in bra_tab.items():
        _qid(ql)
        _qid(qr)
    for (ql, _p), (_m, _s, qr) in ket_tab.items():
        _qid(ql)
        _qid(qr)
    sec_by_g = []
    for g in range(len(meta_in.groups)):
        dq_g = meta_in.groups[g][0]
        rows = []
        for qlb, (eoff, db, dkk) in sorted(meta_in.sectors[g].items()):
            qlk = group.sub(qlb, dq_g)
            rows.append((_qid(qlb), _qid(qlk), eoff, db, dkk))
        sec_by_g.append(np.asarray(rows, np.int64).reshape(-1, 5))
    NQ = len(qn_ids)

    def _dense_tab(tab):
        idx = np.full((NQ, P), -1, np.int64)
        nm = len(tab)
        tm = np.empty(nm, np.int64)
        ts1 = np.empty(nm, np.int64)
        ts2 = np.empty(nm, np.int64)
        tqr = np.empty(nm, np.int64)
        for k2, ((ql, p), (mid, (a, b), qrv)) in enumerate(tab.items()):
            idx[qn_ids[ql], p] = k2
            tm[k2] = mid
            ts1[k2] = a
            ts2[k2] = b
            tqr[k2] = qn_ids[qrv]
        return idx, tm, ts1, ts2, tqr

    bidx_t, bm_t, bs1_t, bs2_t, bqr_t = _dense_tab(bra_tab)
    kidx_t, km_t, ks1_t, ks2_t, _kqr_t = _dense_tab(ket_tab)

    # ---- items = (combos x sectors of their group), tab-filtered ----
    pe, pd, pk2, pm, pq, pc = [], [], [], [], [], []
    for g in range(len(meta_in.groups)):
        sel = np.flatnonzero(c_g == g)
        sec = sec_by_g[g]
        if len(sel) == 0 or len(sec) == 0:
            continue
        S = len(sec)
        ci = np.repeat(sel, S)
        si = np.tile(np.arange(S, dtype=np.int64), len(sel))
        bi = bidx_t[sec[si, 0], c_pb[ci]]
        ki = kidx_t[sec[si, 1], c_pk[ci]]
        ok = (bi >= 0) & (ki >= 0)
        if not ok.any():
            continue
        ci, si, bi, ki = ci[ok], si[ok], bi[ok], ki[ok]
        db_i = sec[si, 3]
        dk_i = sec[si, 4]
        if left:
            dl, dx_i = bs1_t[bi], bs2_t[bi]
            dkk2, dy_i = ks1_t[ki], ks2_t[ki]
        else:
            dx_i, dl = bs1_t[bi], bs2_t[bi]
            dy_i, dkk2 = ks1_t[ki], ks2_t[ki]
        assert np.array_equal(dl, db_i) and np.array_equal(dkk2, dk_i)
        pe.append(sec[si, 2] + c_j[ci] * db_i * dk_i)
        pd.append(np.stack([db_i, dk_i, dx_i, dy_i], 1))
        pk2.append(ci)
        pm.append(np.stack([bm_t[bi], km_t[ki]], 1))
        pq.append(bqr_t[bi])
    if not pe:
        return None
    eoff_a = np.concatenate(pe)
    d4 = np.concatenate(pd)
    db_a, dk_a, dx_a, dy_a = d4[:, 0], d4[:, 1], d4[:, 2], d4[:, 3]
    combo_a = np.concatenate(pk2)
    m2 = np.concatenate(pm)
    mb_a, mk_a = m2[:, 0], m2[:, 1]
    qrb_a = np.concatenate(pq)
    nent_a = c_ne[combo_a]
    nit = len(eoff_a)

    # ---- flat (item x entry) expansion: ef rows, coefficients ----
    ne = int(nent_a.sum())
    efc = np.concatenate([[0], np.cumsum(nent_a)]).astype(np.int64)
    ef_item = np.repeat(np.arange(nit, dtype=np.int64), nent_a)
    ef_ent = (np.arange(ne, dtype=np.int64)
              - np.repeat(efc[:-1], nent_a)
              + np.repeat(cstart[combo_a], nent_a))
    ef_osym = os_e[ef_ent]
    coef = cf_e[ef_ent]
    ef_qrb = qrb_a[ef_item]

    # ---- output layout from the unique (osym, out sector) pairs ----
    id2qn = {v: k for k, v in qn_ids.items()}
    pkey = ef_osym * NQ + ef_qrb
    upk, ufirst = np.unique(pkey, return_index=True)
    out_sym_sectors: Dict[int, Dict[QN, Tuple[int, int]]] = {}
    for u, fi in zip(upk.tolist(), ufirst.tolist()):
        it_ = int(ef_item[fi])
        out_sym_sectors.setdefault(int(u) // NQ, {})[
            id2qn[int(u) % NQ]] = (int(dx_a[it_]), int(dy_a[it_]))
    meta_out = StackedMeta.from_bond(bond_dqs_out, out_sym_sectors)
    if T is None:
        T = pick_tile(np.concatenate([db_a, dk_a, dx_a, dy_a]))

    while True:
        B, nt1, ntp = _CFG[T]
        nl_a = -(-db_a // T)
        nk_a = -(-dk_a // T)
        nx_a = -(-dx_a // T)
        ny_a = -(-dy_a // T)
        itmp = nl_a * ny_a
        iprod = nx_a * ny_a
        n1_a = itmp * nk_a
        n2_a = iprod * nl_a
        # gemm_mix: stage 3 writes each rotated block ONCE (the entry
        # fan-out moves to the symbol-mixing GEMM, K3)
        n3_a = iprod if gemm_mix else iprod * nent_a
        if (itmp.max() <= nt1 and iprod.max() <= ntp
                and n1_a.max() <= B and n2_a.max() <= B
                and n3_a.max() <= B):
            break
        if T >= 128:
            raise ValueError("block too large for any tile config")
        T *= 2

    # greedy grouping under per-stage budgets: each group is the maximal
    # item prefix whose stage sums all fit, found by searchsorted on the
    # prefix sums (identical groups to the sequential per-item scan)
    c1 = np.concatenate([[0], np.cumsum(n1_a)]).astype(np.int64)
    c2 = np.concatenate([[0], np.cumsum(n2_a)]).astype(np.int64)
    c3 = np.concatenate([[0], np.cumsum(n3_a)]).astype(np.int64)
    cit = np.concatenate([[0], np.cumsum(itmp)]).astype(np.int64)
    cip = np.concatenate([[0], np.cumsum(iprod)]).astype(np.int64)
    starts = []
    i0 = 0
    while i0 < nit:
        starts.append(i0)
        e = min(int(np.searchsorted(cit, cit[i0] + nt1, "right")) - 1,
                int(np.searchsorted(cip, cip[i0] + ntp, "right")) - 1,
                int(np.searchsorted(c1, c1[i0] + B, "right")) - 1,
                int(np.searchsorted(c2, c2[i0] + B, "right")) - 1,
                int(np.searchsorted(c3, c3[i0] + B, "right")) - 1)
        i0 = max(e, i0 + 1)
    starts_a = np.asarray(starts, np.int64)
    gfirst1 = [int(x) for x in c1[starts_a]]
    gfirst2 = [int(x) for x in c2[starts_a]]
    gfirst3 = [int(x) for x in c3[starts_a]]
    gs_item = np.repeat(starts_a, np.diff(
        np.concatenate([starts_a, [nit]])))
    tb_a = cit[:-1] - cit[gs_item]
    pb_a = cip[:-1] - cip[gs_item]

    it = np.zeros((nit, 13), dtype=np.int32)
    it[:, 0] = eoff_a
    it[:, 1] = dk_a
    it[:, 2] = db_a
    it[:, 3] = koffs[mk_a]
    it[:, 4] = dy_a
    it[:, 5] = boffs[mb_a]
    it[:, 6] = dx_a
    it[:, 7] = nl_a
    it[:, 8] = nk_a
    it[:, 9] = nx_a
    it[:, 10] = ny_a
    it[:, 11] = tb_a
    it[:, 12] = pb_a

    # entries flat, in item order (cum3 counts iprod tiles per entry);
    # output offsets via dense (out group, out sector qn) tables
    nos = int(os_e.max()) + 1
    go_t = np.zeros(nos, np.int64)
    jo_t = np.zeros(nos, np.int64)
    for s, (go, jo) in meta_out.sym_pos.items():
        go_t[s] = go
        jo_t[s] = jo
    ngo = len(meta_out.groups)
    ooff_t = np.zeros((ngo, NQ), np.int64)
    odx_t = np.ones((ngo, NQ), np.int64)
    ody_t = np.ones((ngo, NQ), np.int64)
    for go in range(ngo):
        for qb, (ooff, odx, ody) in meta_out.sectors[go].items():
            qi = qn_ids[qb]
            ooff_t[go, qi] = ooff
            odx_t[go, qi] = odx
            ody_t[go, qi] = ody
    gtab = wdense = None
    rot_total = 0
    if gemm_mix:
        # ---- ROT pool layout: combos as the symbol axis ---------------
        # every entry of a combo must share one out group (charge
        # conservation fixes dq_o per (dq_env, pb, pk)); verified here,
        # falling back to the scatter path otherwise
        ent_go = go_t[os_e]
        ncombo = len(cstart)
        gmin = np.minimum.reduceat(ent_go, cstart)
        gmax = np.maximum.reduceat(ent_go, cstart)
        if not np.array_equal(gmin, gmax):
            return build_blocking_v2(
                meta_in, entries, quanta, bra_T, ket_T, group,
                direction, bond_dqs_in, bond_dqs_out, T=T,
                gemm_mix=False)
        combo_go = gmin
        # live combos (those with at least one item), row ids per group
        ngroups = len(meta_out.groups)
        live = np.zeros(ncombo, bool)
        live[combo_a] = True
        live_idx = np.flatnonzero(live)
        gg = combo_go[live_idx]
        order_l = np.argsort(gg, kind="stable")
        sl = live_idx[order_l]
        gs = combo_go[sl]
        cnt_g = np.bincount(gs, minlength=ngroups)
        gstart = np.concatenate([[0], np.cumsum(cnt_g)[:-1]])
        rowidx = np.full(ncombo, -1, np.int64)
        rowidx[sl] = np.arange(len(sl)) - gstart[gs]
        nrows_go = cnt_g.astype(np.int64)
        # ROT sectors per (go, qrb): offsets for [nrows_go, dx*dy] slabs
        item_go = combo_go[combo_a]
        skey = item_go * NQ + qrb_a
        uk, ufirst2 = np.unique(skey, return_index=True)
        u_g = uk // NQ
        u_dxdy = (dx_a[ufirst2] * dy_a[ufirst2]).astype(np.int64)
        u_sz = nrows_go[u_g] * u_dxdy
        u_off = np.concatenate([[0], np.cumsum(u_sz)[:-1]])
        rot_total = int(u_sz.sum())
        pos = np.searchsorted(uk, skey)
        ro = u_off[pos]
        rd = u_dxdy[pos]
        rot_off_t = {int(u): (int(o_), int(d_))
                     for u, o_, d_ in zip(uk, u_off, u_dxdy)}
        ef = np.empty((nit, 4), dtype=np.int32)
        ef[:, 0] = np.arange(nit)
        ef[:, 1] = ro + rowidx[combo_a] * rd
        ef[:, 2] = dx_a
        ef[:, 3] = dy_a
        coef = np.ones(nit, dtype=cf_e.dtype)
        ne = nit
        cum3 = np.concatenate([[0], np.cumsum(iprod)]).astype(np.int32)
        # ---- dense W2 per out group + GEMM sub-block specs ------------
        woffs = np.concatenate(
            [[0], np.cumsum([int(len(s_)) * int(nrows_go[gi])
                             for gi, (_dq, s_) in
                             enumerate(meta_out.groups)])]).astype(
                                 np.int64)
        wdense = np.zeros(int(woffs[-1]) + 1, dtype=cf_e.dtype)
        ent_combo = np.repeat(np.arange(ncombo), c_ne)
        col = rowidx[ent_combo]
        ok_e = col >= 0
        g_e2 = combo_go[ent_combo[ok_e]]
        flat = (woffs[g_e2] + jo_t[os_e[ok_e]] * nrows_go[g_e2]
                + col[ok_e])
        np.add.at(wdense, flat, cf_e[ok_e])
        specs = []
        for u in sorted(rot_off_t):
            g_i, q_i = u // NQ, u % NQ
            o_, dxdy = rot_off_t[u]
            nw_g = len(meta_out.groups[g_i][1])
            ns_g = int(nrows_go[g_i])
            ooff = int(ooff_t[g_i, q_i])
            specs.append((int(woffs[g_i]), ns_g, nw_g, ns_g, o_, dxdy,
                          ooff, dxdy, dxdy))
        gtab = emit_gemm_items(specs)
        if gtab is None:
            return build_blocking_v2(
                meta_in, entries, quanta, bra_T, ket_T, group,
                direction, bond_dqs_in, bond_dqs_out, T=T,
                gemm_mix=False)
    else:
        go_e2 = go_t[ef_osym]
        odx_e = odx_t[go_e2, ef_qrb]
        ody_e = ody_t[go_e2, ef_qrb]
        ef = np.empty((ne, 4), dtype=np.int32)
        ef[:, 0] = ef_item
        ef[:, 1] = ooff_t[go_e2, ef_qrb] + jo_t[ef_osym] * odx_e * ody_e
        ef[:, 2] = odx_e
        ef[:, 3] = ody_e
        cum3 = np.concatenate(
            [[0], np.cumsum(np.repeat(iprod, nent_a))]).astype(np.int32)

    plan = BlockingV2Plan()
    plan.meta_out = meta_out
    # pow2 item/entry counts, as the reference pads them (its jit
    # signatures depend on these shapes; kept so that the tables equal
    # the reference's).  Padded items/entries own no tasks (repeated cum
    # tail); blk_tables derives per-item tables from the live ones only.
    nit_q = _pow2(nit)
    it = np.concatenate(
        [it, np.zeros((nit_q - nit, 13), dtype=it.dtype)])
    it[nit:, 7:11] = 1
    c1 = np.concatenate([c1, np.full(nit_q - nit, c1[-1], c1.dtype)])
    c2 = np.concatenate([c2, np.full(nit_q - nit, c2[-1], c2.dtype)])
    ne_q = _pow2(ne)
    ef = np.concatenate([ef, np.zeros((ne_q - ne, 4), dtype=ef.dtype)])
    ef[ne:, 3] = 1
    coef = np.concatenate([coef, np.zeros(ne_q - ne, dtype=coef.dtype)])
    cum3 = np.concatenate(
        [cum3, np.full(ne_q - ne, cum3[-1], cum3.dtype)])

    plan.T = T
    plan.B = B
    plan.nt1 = nt1
    plan.ntp = ntp
    plan.ncap = _cap_class((rot_total if gemm_mix
                            else meta_out.total) + 1)
    plan.left = left
    plan.it = it
    plan.ef = ef
    plan.coef = coef
    plan.cum1 = c1.astype(np.int32)
    plan.cum2 = c2.astype(np.int32)
    plan.cum3 = cum3
    plan.g1 = np.asarray(gfirst1, dtype=np.int32)
    plan.g2 = np.asarray(gfirst2, dtype=np.int32)
    plan.g3 = np.asarray(gfirst3, dtype=np.int32)
    plan.bra_pool = (bra_mats, boffs)
    plan.ket_pool = (ket_mats, koffs)
    plan.flops = float(2 * (db_a * dk_a * dy_a
                            + db_a * dx_a * dy_a).sum())
    plan._dev = {}
    plan._src = (bra_T, ket_T)
    if not gemm_mix:
        return plan
    p3 = BlockingV3Plan()
    p3.rot = plan
    p3.meta_out = meta_out
    p3.ncap = _cap_class(meta_out.total + 1)
    p3.T = T
    # GEMM flops: dense W2 per group over its full sector width
    gf = 0.0
    for (_wb, _ws, nw_s, ns_s, _eb, _es, _ob, _os2, wid) in specs:
        gf += 2.0 * nw_s * ns_s * wid
    p3.flops = plan.flops + gf
    p3.gtab = gtab
    p3.wdense = wdense
    p3.rot_total = rot_total
    p3._dev = {}
    return p3
