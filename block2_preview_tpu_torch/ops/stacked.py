"""Symbol-stacked environments: the slab layout and the "bucket" blocking
engine — kernels K10 (slab product) and K11 (symbol mix scatter).

Host side, copied from block2_preview_tpu/ops/stacked.py: ``_pow2``,
``_cap_class``, ``StackedMeta`` and ``meta_from_env`` (:44-160, 547-554)
give byte-identical layouts to the reference, so every port kernel reads
the same flat pools as its JAX counterpart; ``refresh_plan_sites``
(:248-286) keeps cached blocking plans current; ``build_stacked_plan``
(:289-473) gives the reference's sector items and mix rows, in its order
once its shape buckets are taken out.

The environment of one bond lives in ONE flat pool, slab-contiguous: the
slab for (group g, sector qb) holds the S_g symbols of the group as
contiguous (db x dk) row-major blocks.  Pools shipped to the device carry
one extra zero slot at the end (the sentinel that masked reads use).

One blocking step of the bucket engine, per sector item c (a group g, an
MPO site pair (pb, pk) and an input sector) and symbol j of the group:

    res[c, j] = mb^T E[c, j] mk     (left;  right: mb E[c, j] mk^T)

then, per mix row m (an entry (i, o) of the MPO site tensor):

    out[tgt_m + x*dy + y] += coef_m * res[src_m][x, y]

Device side: K10 (``csrc/slab.cu``, replaces ``_slab_exec`` :163) forms
every referenced (c, j) product at true dims into a compact ``res`` pool;
K11 (``csrc/stk_mix.cu``, replaces ``_mix_scatter`` :205) adds every mix
row into the output pool on the gather-by-output mix core
(``csrc/mix_gather.cuh``, host tables :func:`gather_tables`, shared with
K12's stage 3): the rows grouped by output block, each output element
summed by one lane and written once, no atomics.  ``execute_stacked`` is
one launch of each for the whole plan.  Not carried: the pow2 shape
buckets (``q8``, ``_pow2(S)``), the 2^24-element launch chunks, the
pow2-padded mix chunks and ``warm_stacked`` (they bound XLA's compiles),
and the ``_cap_class``
padding of the site pools.  The output pool keeps the reference's layout
(``meta_out``, ``out_cap = _cap_class(meta_out.total + 1)``, zero
sentinel): K1/K2 and ``meta_out.unpack`` read it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.blocks import BlockMatrix
from ..core.symmetry import QN
from . import _kernels
from .csr import w_nonzero


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 0 else 1


def _cap_class(n: int) -> int:
    """Quantized pool capacity.  pow4 steps while small, pow2 above 4M
    elements (the reference's size classes; kept so pool layouts and
    sentinel positions match it exactly)."""
    c = 1 << 16
    while c < n and c < (1 << 22):
        c <<= 2
    while c < n:
        c <<= 1
    return c


class StackedMeta:
    """Layout of a stacked environment on one bond.

    groups: list of (dq, sym_ids [S]) — symbols sharing a delta quantum.
    sectors[g]: {qb: (offset, db, dk)} — slab offsets into the flat pool;
    the slab for (g, qb) holds S_g contiguous (db x dk) blocks.
    total: pool length (+1 sentinel slot at the end when shipped).
    """

    __slots__ = ("groups", "sectors", "total", "sym_pos", "_sig")

    def __init__(self, groups, sectors, total):
        self.groups = groups
        self.sectors = sectors
        self.total = total
        self._sig = None
        self.sym_pos: Dict[int, Tuple[int, int]] = {}
        for g, (_dq, syms) in enumerate(groups):
            for j, s in enumerate(syms):
                self.sym_pos[int(s)] = (g, j)

    def signature(self) -> int:
        """Structural hash (groups + sector layout), cached."""
        s = getattr(self, "_sig", None)
        if s is None:
            s = hash((tuple((dq, tuple(map(int, ss)))
                            for dq, ss in self.groups),
                      tuple(tuple(sorted(sec.items()))
                            for sec in self.sectors), self.total))
            self._sig = s
        return s

    @staticmethod
    def from_bond(bond_dqs: Sequence[QN], sym_sectors: Dict[int, Dict],
                  active: Optional[Sequence[int]] = None) -> "StackedMeta":
        """bond_dqs[s] = dq of symbol s; sym_sectors[s] = {qb: (db, dk)}."""
        syms = sorted(sym_sectors) if active is None else sorted(active)
        by_dq: Dict[QN, List[int]] = {}
        for s in syms:
            by_dq.setdefault(bond_dqs[s], []).append(s)
        groups = []
        sectors = []
        off = 0
        for dq in sorted(by_dq):
            ss = np.asarray(by_dq[dq], dtype=np.int64)
            # union of sectors over the group, with per-sector dims
            secs: Dict[QN, Tuple[int, int]] = {}
            for s in ss:
                for qb, (db, dk) in sym_sectors[int(s)].items():
                    if qb in secs:
                        if secs[qb] != (db, dk):
                            raise ValueError("inconsistent sector dims")
                    else:
                        secs[qb] = (db, dk)
            lay = {}
            for qb in sorted(secs):
                db, dk = secs[qb]
                lay[qb] = (off, db, dk)
                off += len(ss) * db * dk
            groups.append((dq, ss))
            sectors.append(lay)
        return StackedMeta(groups, sectors, off)

    def pack(self, env: Dict[int, BlockMatrix], dtype=np.float64
             ) -> np.ndarray:
        pool = np.zeros(self.total + 1, dtype=dtype)
        for g, (_dq, ss) in enumerate(self.groups):
            for j, s in enumerate(ss):
                bm = env.get(int(s))
                if bm is None:
                    continue
                for (qb, _qk), mat in bm.blocks.items():
                    ent = self.sectors[g].get(qb)
                    if ent is None:
                        continue
                    off, db, dk = ent
                    o = off + j * db * dk
                    pool[o:o + db * dk] = np.asarray(mat, dtype=dtype).ravel()
        return pool

    def unpack(self, pool: np.ndarray, group, bond_dqs,
               comp_target: Optional[QN] = None) -> Dict[int, BlockMatrix]:
        out: Dict[int, BlockMatrix] = {}
        pool = np.asarray(pool)
        for g, (dq, ss) in enumerate(self.groups):
            for qb, (off, db, dk) in self.sectors[g].items():
                qk = group.sub(qb, dq)
                for j, s in enumerate(ss):
                    o = off + j * db * dk
                    mat = pool[o:o + db * dk].reshape(db, dk)
                    if not np.any(mat):
                        continue
                    bm = out.get(int(s))
                    if bm is None:
                        bm = BlockMatrix(group, dq)
                        out[int(s)] = bm
                    bm.blocks[(qb, qk)] = mat
        return out


def meta_from_env(env: Dict[int, BlockMatrix], bond_dqs: Sequence[QN]
                  ) -> StackedMeta:
    """StackedMeta from a materialized {symbol -> BlockMatrix} env."""
    sym_sectors = {}
    for s, bm in env.items():
        sym_sectors[int(s)] = {qb: mat.shape
                               for (qb, _qk), mat in bm.blocks.items()}
    return StackedMeta.from_bond(bond_dqs, sym_sectors)


def env_pool(env: Dict[int, BlockMatrix], bond_dqs: Sequence[QN], dtype
             ) -> Tuple[StackedMeta, np.ndarray]:
    """(meta, host pool) of one bond's environment, padded to
    ``_cap_class(n + 1)`` with the zero sentinel in the last slot — the
    same layout the reference's ``MovingEnvironment._ensure_stk`` ships
    (block2_preview_tpu/dmrg/environment.py:515-538)."""
    meta = meta_from_env(env, bond_dqs)
    pool = meta.pack(env, dtype=dtype)
    # strictly > len: the last slot is the zero sentinel that masked
    # tile reads rely on — it must never hold real data
    pp = np.zeros(_cap_class(len(pool) + 1), dtype=dtype)
    pp[:len(pool)] = pool
    return meta, pp


def site_value_mats(T, quanta):
    """Site-tensor value matrices in plan registration order (the order
    ``build_blocking_v2``'s reg() emits: sorted block keys x physical
    quanta).  Copied from block2_preview_tpu/ops/stacked.py:234-245."""
    mats = []
    for (ql, qp, qr), b in sorted(T.blocks.items()):
        for p, q in enumerate(quanta):
            if q != qp:
                continue
            mats.append(b.reshape(b.shape[0], b.shape[2]))
    return mats


def refresh_plan_sites(plan, bra_T, ket_T, quanta):
    """Refresh the site-tensor VALUES captured inside a cached blocking
    plan (StackedPlan, TiledBlockingPlan, BlockingV2Plan, BlockingV3Plan:
    each keeps them as ``bra_pool``/``ket_pool`` and caches their device
    pools in ``_dev`` under a key starting with "pools") and drop its
    uploaded bra/ket pools, so the next execution uploads the new values.

    The plan caches key on structure only (block keys/shapes); the value
    matrices are captured at build time.  Once an MPS converges in
    *shape*, every later sweep hits the cache — and without this refresh
    the environments are contracted with rotation matrices from the
    build-time sweep, settling the run ~1e-6 off the true fixed point
    (copied from block2_preview_tpu/ops/stacked.py:248-286)."""
    src = plan._src
    if src is not None and src[0] is bra_T and src[1] is ket_T:
        return plan
    bmats = site_value_mats(bra_T, quanta)
    kmats = site_value_mats(ket_T, quanta)
    old_b, boffs = plan.bra_pool
    old_k, koffs = plan.ket_pool
    assert len(old_b) == len(bmats) and len(old_k) == len(kmats)
    plan.bra_pool = (bmats, boffs)
    plan.ket_pool = (kmats, koffs)
    inner = getattr(plan, "rot", plan)
    for key in [k for k in inner._dev if k[0] == "pools"]:
        del inner._dev[key]
    plan._src = (bra_T, ket_T)
    return plan


def site_pools(plan, device, dtype):
    """(bra pool, ket pool) of a blocking plan's site-value matrices on the
    device (raveled one after another, plus one zero), cached on the plan
    until ``refresh_plan_sites`` replaces the values."""
    key = ("pools", str(device), dtype)
    p = plan._dev.get(key)
    if p is None:
        def pack(mats, offs):
            if any(np.iscomplexobj(m) for m in mats):
                raise TypeError("complex site tensors are not on this slice")
            pool = np.zeros(int(offs[-1]) + 1, dtype=np.float64)
            for m, o in zip(mats, offs[:-1]):
                pool[o:o + m.size] = m.ravel()
            return torch.as_tensor(pool, dtype=dtype, device=device)

        p = (pack(*plan.bra_pool), pack(*plan.ket_pool))
        plan._dev[key] = p
    return p


# ---------------------------------------------------------------------------
# the bucket engine: plan
# ---------------------------------------------------------------------------

# item columns (the first seven of K9's contribution rows)
_EOFF, _BOFF, _KOFF, _DL, _DX, _DK, _DY = range(7)
# term elements a chunk of the mix core's plain version (bounds its
# temporaries)
_MIX_CHUNK = 1 << 24


class StackedPlan:
    """One blocking step of the bucket engine.

    ``items`` [C, 7] int64, one row per sector item in the reference's item
    order (its shape buckets taken out): eoff (the item's slab, symbol 0),
    boff, koff, dl, dx, dk, dy — left: mb (dl x dx), E (dl x dk), mk
    (dk x dy); right: mb (dx x dl), mk (dy x dk).  Mix rows, in the
    reference's order: ``row_c``/``row_j`` [M] (the item and symbol of the
    product a row reads), ``coef`` [M], ``tgt`` [M, 3] (output offset, dx,
    dy).  ``work`` [n, 2]: the (c, j) products the rows read, sorted;
    ``wsrc`` [M]: each row's work; ``roff`` [n + 1]: the works' offsets in
    the compact ``res`` pool of ``res_total`` elements.  ``bra_pool`` /
    ``ket_pool``: (site value matrices, offsets), refreshed by
    ``refresh_plan_sites``; ``_dev`` caches device tables and pools."""

    __slots__ = ("items", "row_c", "row_j", "coef", "tgt", "work", "wsrc",
                 "roff", "res_total", "meta_out", "out_cap", "left",
                 "bra_pool", "ket_pool", "flops", "_dev", "_src")


def stacked_plan(items, row_c, row_j, coef, tgt, meta_out, left, bra_pool,
                 ket_pool, src=None) -> StackedPlan:
    """A StackedPlan from its items and mix rows; derives the works (the
    distinct (item, symbol) products the rows read) and their ``res``
    layout."""
    p = StackedPlan()
    p.items = np.asarray(items, np.int64).reshape(-1, 7)
    p.row_c = np.asarray(row_c, np.int64)
    p.row_j = np.asarray(row_j, np.int64)
    p.coef = np.asarray(coef)
    p.tgt = np.asarray(tgt, np.int64).reshape(-1, 3)
    span = int(p.row_j.max()) + 1 if len(p.row_j) else 1
    keys, p.wsrc = np.unique(p.row_c * span + p.row_j, return_inverse=True)
    p.wsrc = p.wsrc.ravel().astype(np.int64)
    p.work = np.stack([keys // span, keys % span], axis=1).astype(np.int64)
    f = p.items[p.work[:, 0]]
    p.roff = np.concatenate([[0], np.cumsum(f[:, _DX] * f[:, _DY])]
                            ).astype(np.int64)
    p.res_total = int(p.roff[-1])
    p.flops = float(2 * (f[:, _DL] * f[:, _DK] * f[:, _DY]
                         + f[:, _DX] * f[:, _DL] * f[:, _DY]).sum())
    p.meta_out = meta_out
    p.out_cap = _cap_class(meta_out.total + 1)
    p.left = bool(left)
    p.bra_pool = bra_pool
    p.ket_pool = ket_pool
    p._dev = {}
    p._src = src
    return p


def build_stacked_plan(meta_in: StackedMeta, entries, quanta, bra_T, ket_T,
                       group, direction: str, bond_dqs_in, bond_dqs_out
                       ) -> Optional[StackedPlan]:
    """Blocking-step plan on stacked environments (copied from the
    reference's build_stacked_plan, without its shape buckets).

    direction 'left':  in-symbols join entry inputs, out = entry outputs,
        E'[o][(qrb,qrk)] += w[pb,pk] mb^T E[i][(qlb,qlk)] mk
    direction 'right': in = entry outputs (right env), out = entry inputs.
    For 'right', bond_dqs_* must already be complemented (target - dq).
    """
    left = direction == "left"

    # site tensor registries keyed (bond sector, phys state)
    bra_tab: Dict[Tuple[QN, int], Tuple[int, Tuple[int, int], QN]] = {}
    ket_tab: Dict[Tuple[QN, int], Tuple[int, Tuple[int, int], QN]] = {}
    bra_mats: List[np.ndarray] = []
    ket_mats: List[np.ndarray] = []

    def reg(T, tab, mats):
        for (ql, qp, qr), b in sorted(T.blocks.items()):
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
    bshape = np.asarray([m.shape for m in bra_mats], dtype=np.int64)
    kshape = np.asarray([m.shape for m in ket_mats], dtype=np.int64)
    boffs = np.concatenate([[0], np.cumsum(bshape[:, 0] * bshape[:, 1])])
    koffs = np.concatenate([[0], np.cumsum(kshape[:, 0] * kshape[:, 1])])

    # entries grouped by (in-group, pb, pk) with (in-pos, out-sym, coef)
    ent_by: Dict[Tuple[int, int, int], List[Tuple[int, int, float]]] = {}
    for (i, o), w in sorted(entries.items()):
        jsym = i if left else o
        osym = o if left else i
        gp = meta_in.sym_pos.get(jsym)
        if gp is None:
            continue
        g, j = gp
        for pb, pk in zip(*w_nonzero(w)):
            ent_by.setdefault((g, int(pb), int(pk)), []).append(
                (j, osym, float(w[pb, pk].real) if not np.iscomplexobj(w)
                 else w[pb, pk]))
    keys = sorted(ent_by)
    ents = [e for key in keys for e in ent_by[key]]
    klen = np.asarray([len(ent_by[key]) for key in keys], np.int64)
    kstart = np.concatenate([[0], np.cumsum(klen)[:-1]]).astype(np.int64)
    ent_j = np.asarray([e[0] for e in ents], np.int64)
    ent_os = np.asarray([e[1] for e in ents], np.int64)
    ent_cf = np.asarray([e[2] for e in ents])

    # sector items, in the reference's order: (key, eoff, boff, koff, dl,
    # dx, dk, dy, qrb)
    items = []
    for ik, (g, pb, pk) in enumerate(keys):
        dq_g, syms = meta_in.groups[g]
        for qlb, (eoff, db, dkk) in meta_in.sectors[g].items():
            qlk = group.sub(qlb, dq_g)
            vb = bra_tab.get((qlb, pb))
            vk = ket_tab.get((qlk, pk))
            if vb is None or vk is None:
                continue
            mb_id, (s1, s2), qrb = vb
            mk_id, (t1, t2), qrk = vk
            if left:
                dl, dx = s1, s2
                dkk2, dy = t1, t2
            else:
                dx, dl = s1, s2
                dy, dkk2 = t1, t2
            assert dl == db and dkk2 == dkk
            items.append((ik, eoff, boffs[mb_id], koffs[mk_id], dl, dx, dkk,
                          dy, qrb))
    if not items:
        return None
    ik = np.asarray([it[0] for it in items], np.int64)
    meta_out, row_c, pos, tgt, ok = expand_entries(
        kstart[ik], klen[ik], [it[8] for it in items],
        np.asarray([it[5] for it in items], np.int64),
        np.asarray([it[7] for it in items], np.int64), ent_os, bond_dqs_out)
    return stacked_plan([it[1:8] for it in items], row_c[ok],
                        ent_j[pos[ok]], ent_cf[pos[ok]], tgt[ok], meta_out,
                        left, (bra_mats, boffs), (ket_mats, koffs),
                        src=(bra_T, ket_T))


def expand_entries(seg_start, seg_len, item_qrb, item_dx, item_dy, ent_os,
                   bond_dqs_out):
    """Every (item, entry) pair of a stacked blocking plan, item-major and
    in entry order — item i owns entries ``seg_start[i]`` onwards, for
    ``seg_len[i]`` of them; an entry's output symbol is ``ent_os`` — and the
    output layout they define: each (output symbol, output sector qrb)
    with the dims (dx, dy) of its pairs, which must agree (ValueError).
    Returns (meta_out, the pairs' items, their entry indices, their
    targets [n, 3] (slab offset of the output block, dx, dy), and a mask of
    the pairs whose block meta_out holds).  This is the reference builders'
    per-entry loop over items (ops/stacked.py:365-370, 412-428;
    ops/tiled_blocking.py:188-195, 224-240) in array form."""
    qid: Dict[QN, int] = {}
    q_item = np.asarray([qid.setdefault(q, len(qid)) for q in item_qrb],
                        np.int64)
    qn_of = list(qid)
    nq = len(qn_of)
    row = np.repeat(np.arange(len(seg_len), dtype=np.int64), seg_len)
    pos = np.repeat(seg_start - np.cumsum(seg_len) + seg_len, seg_len) \
        + np.arange(int(seg_len.sum()), dtype=np.int64)
    osym, q = ent_os[pos], q_item[row]
    dx, dy = item_dx[row], item_dy[row]
    nsym = int(osym.max()) + 1 if len(osym) else 1
    key = osym * nq + q
    seen = np.zeros(nsym * nq, bool)
    tdx = np.zeros(nsym * nq, np.int64)
    tdy = np.zeros(nsym * nq, np.int64)
    seen[key], tdx[key], tdy[key] = True, dx, dy
    if not (np.array_equal(tdx[key], dx) and np.array_equal(tdy[key], dy)):
        raise ValueError("an output sector meets two block shapes")
    out_sym_sectors: Dict[int, Dict[QN, Tuple[int, int]]] = {}
    for k in np.flatnonzero(seen).tolist():
        out_sym_sectors.setdefault(k // nq, {})[qn_of[k % nq]] = (
            int(tdx[k]), int(tdy[k]))
    meta_out = StackedMeta.from_bond(bond_dqs_out, out_sym_sectors)
    # output offsets by (out group, sector) and (group, position) by symbol
    nsym = int(osym.max()) + 1 if len(osym) else 1
    go_t = np.full(nsym, -1, np.int64)
    jo_t = np.zeros(nsym, np.int64)
    for s, (go, jo) in meta_out.sym_pos.items():
        if s < nsym:
            go_t[s], jo_t[s] = go, jo
    ngo = len(meta_out.groups)
    sec = np.zeros((ngo, nq, 3), np.int64)
    has = np.zeros((ngo, nq), bool)
    for go, secs in enumerate(meta_out.sectors):
        for qb, ent in secs.items():
            if qb in qid:
                sec[go, qid[qb]] = ent
                has[go, qid[qb]] = True
    go = go_t[osym]
    ok = go >= 0
    ok[ok] = has[go[ok], q[ok]]
    s3 = sec[np.maximum(go, 0), q]
    tgt = np.stack([s3[:, 0] + jo_t[osym] * s3[:, 1] * s3[:, 2], s3[:, 1],
                    s3[:, 2]], axis=1)
    return meta_out, row, pos, tgt, ok


# ---------------------------------------------------------------------------
# kernels K10 (slab product), K11 (symbol mix) and their plain twins
# ---------------------------------------------------------------------------

def _check_real(plan: StackedPlan) -> None:
    if np.iscomplexobj(plan.coef):
        raise TypeError("complex blocking plans are not on this slice; "
                        "backend='torch_tiled' keeps complex environments "
                        "on the host")


def slab_kernel_tables(plan: StackedPlan, device) -> Dict:
    """K10's tables on ``device``, cached on the plan: the items ``it``
    [C, 7] int32, the works ``wk`` [n, 3] int32 (item, symbol, res
    offset) and ``cum`` [n + 1], the prefix sums of each work's CUDA
    blocks (csrc/chain.cuh)."""
    from .exec_bucket import _int32, chain_blocks
    key = ("k10", str(device))
    d = plan._dev.get(key)
    if d is None:
        f = plan.items[plan.work[:, 0]]
        last = f[:, _EOFF] + (plan.work[:, 1] + 1) * f[:, _DL] * f[:, _DK]
        _int32(last, "a K10 env offset")
        cum = np.concatenate([[0], np.cumsum(chain_blocks(f[:, _DX],
                                                          f[:, _DY]))])
        wk = np.stack([plan.work[:, 0], plan.work[:, 1], plan.roff[:-1]], 1)
        d = {"it": torch.as_tensor(_int32(plan.items, "a K10 pool offset"),
                                   device=device),
             "wk": torch.as_tensor(_int32(wk, "a K10 res offset"),
                                   device=device),
             "cum": torch.as_tensor(_int32(cum, "K10's block count"),
                                    device=device),
             "n_works": len(wk), "n_blocks": int(cum[-1])}
        plan._dev[key] = d
    return d


def slab_plain_tables(plan: StackedPlan, device, tdt) -> Dict:
    """The K10 twin's tables on ``device``: every work as one of K9's
    contribution rows (eoff + j dl dk, boff, koff, dl, dx, dk, dy, res
    offset) with coefficient 1, grouped in power-of-two shape classes."""
    from .blocking_device import class_tables
    f = plan.items[plan.work[:, 0]].copy()
    f[:, _EOFF] += plan.work[:, 1] * f[:, _DL] * f[:, _DK]
    rows = np.concatenate([f, plan.roff[:-1, None]], axis=1)
    return class_tables(rows, np.ones(len(rows)), device, tdt)


def slab_plain(ep, bp, kp, d: Dict, left: bool, res):
    """Plain PyTorch version of K10 (the reference's ``_slab_exec`` per
    shape class: padded gathers, one einsum, the true elements added into
    ``res`` [res_total + 1], whose last slot is cleared).  Returns res."""
    from .blocking_device import bucket_blocking_plain
    return bucket_blocking_plain(ep, bp, kp, d, left, res)


def slab_exec(ep, bp, kp, d: Dict, left: bool, res):
    """Slab product (kernel K10): every work's product at true dims into
    the zero-initialised compact pool ``res`` [res_total + 1], from the
    flat env/bra/ket pools; ``d`` from :func:`slab_kernel_tables` (CPU
    tensors run :func:`slab_plain` on :func:`slab_plain_tables`).
    Returns res."""
    if any(t.dim() != 1 for t in (ep, bp, kp, res)):
        raise ValueError("slab_exec takes flat pools and a flat res")
    if ep.device.type == "cpu":
        return slab_plain(ep, bp, kp, d, left, res)
    if not ep.is_cuda:
        raise ValueError(f"unsupported device {ep.device}")
    _kernels.launch("K10_slab", "b2t_slab", ep.dtype, ep, bp, kp, d["it"],
                    d["wk"], d["cum"], d["n_works"], d["n_blocks"],
                    int(left), res)
    return res


# ---------------------------------------------------------------------------
# the gather-by-output mix core (csrc/mix_gather.cuh): K11 and K12's stage 3
# ---------------------------------------------------------------------------

# blocks of at most GATHER_SPLIT elements: one warp, its lanes split over
# (term group, element); wider blocks: a warp each GATHER_CHUNK elements
# (csrc/mix_gather.cuh kSplitMax, kGatherChunk)
GATHER_SPLIT = 16
GATHER_CHUNK = 32


def stable_order(key: np.ndarray, n_keys: int) -> np.ndarray:
    """The stable argsort of integer keys in [0, n_keys), by 16-bit radix
    passes (numpy sorts 16-bit keys by counting, ~6x faster than a 64-bit
    merge sort at a plan's ~10M rows)."""
    key = np.asarray(key, np.int64)
    order = np.argsort((key & 0xFFFF).astype(np.uint16), kind="stable")
    shift = 16
    while n_keys > 1 << shift:
        d = ((key[order] >> shift) & 0xFFFF).astype(np.uint16)
        order = order[np.argsort(d, kind="stable")]
        shift += 16
    return order


def gather_tables(key, n_keys: int, rec, s, coef) -> Dict:
    """Host tables of the mix core from its terms: term i adds
    ``coef[i] src[s[i] + r sstr + c]`` into the output block ``key[i]``
    (an integer in [0, n_keys); blocks are ordered by key) whose window
    ``rec[i]`` = (ob, ostr, rows, cols) every term of the block must share
    (ValueError otherwise).  Returns numpy ``blk`` [nb, 4], ``bstart``
    [nb + 1], ``ts``, ``tc`` (the terms sorted stably by block), ``units``
    [U, 2] (block, first element), ``keys`` [nb] (each block's key) and
    ``work`` [nb + 1], the prefix sums of terms x elements a block."""
    key = np.asarray(key, np.int64)
    rec = np.asarray(rec, np.int64).reshape(-1, 4)
    present = np.zeros(n_keys, bool)
    present[key] = True
    keys = np.flatnonzero(present)
    dense = np.zeros(n_keys, np.int64)
    dense[keys] = np.arange(len(keys))
    bid = dense[key]
    order = stable_order(bid, len(keys))
    counts = np.bincount(bid, minlength=len(keys))
    bstart = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    blk = rec[order[bstart[:-1]]]
    if not np.array_equal(blk[bid], rec):
        raise ValueError("the terms of one output block disagree on its "
                         "window")
    n_el = blk[:, 2] * blk[:, 3]
    nu = np.where(n_el <= GATHER_SPLIT, 1, -(-n_el // GATHER_CHUNK))
    ub = np.repeat(np.arange(len(blk), dtype=np.int64), nu)
    ue = (np.arange(int(nu.sum()), dtype=np.int64)
          - np.repeat(np.cumsum(nu) - nu, nu)) * GATHER_CHUNK
    return {"blk": blk, "bstart": bstart, "ts": np.asarray(s)[order],
            "tc": np.asarray(coef)[order], "units": np.stack([ub, ue], 1),
            "keys": keys,
            "work": np.concatenate([[0], np.cumsum(counts * n_el)])}


def gather_device(h: Dict, device, tdt, what: str) -> Dict:
    """The core's tables ``h`` (:func:`gather_tables`) on ``device``, the
    coefficients in ``tdt``; ``bstart_h``/``work_h`` stay on the host for
    the plain version's chunks."""
    from .exec_bucket import _int32
    t = {k: torch.as_tensor(_int32(h[k], f"{what} {k}"), device=device)
         for k in ("blk", "bstart", "ts", "units")}
    t.update(tc=torch.as_tensor(h["tc"], dtype=tdt, device=device),
             n_units=len(h["units"]), n_blocks=len(h["blk"]),
             bstart_h=h["bstart"], work_h=h["work"])
    return t


def gather_plain(src, d: Dict, out, sstr: int, b0: int = 0,
                 b1: Optional[int] = None):
    """Plain PyTorch version of the mix core on its tables ``d``
    (:func:`gather_device`), output blocks [b0, b1): every term's window
    elements, scaled, added into ``out`` by ``index_add_`` in the tables'
    term order, in chunks of blocks of about ``_MIX_CHUNK`` elements.
    Returns out."""
    b1 = d["n_blocks"] if b1 is None else b1
    work, bs = d["work_h"], d["bstart_h"]
    dev = out.device
    while b0 < b1:
        c1 = int(np.searchsorted(work, work[b0] + _MIX_CHUNK, "right")) - 1
        c1 = min(max(c1, b0 + 1), b1)
        m0, m1 = int(bs[b0]), int(bs[c1])
        blk = d["blk"][b0:c1].long()
        cnt = torch.as_tensor(np.diff(bs[b0:c1 + 1]), device=dev)
        tb = torch.repeat_interleave(torch.arange(c1 - b0, device=dev), cnt)
        rows_t = blk[tb]
        n_el = rows_t[:, 2] * rows_t[:, 3]
        ti = torch.repeat_interleave(torch.arange(m1 - m0, device=dev), n_el)
        e = torch.arange(len(ti), device=dev) - (torch.cumsum(n_el, 0)
                                                 - n_el)[ti]
        w = rows_t[ti]
        r, c = e // w[:, 3], e % w[:, 3]
        s = d["ts"][m0:m1].long()[ti]
        out.index_add_(0, w[:, 0] + r * w[:, 1] + c,
                       src[s + r * sstr + c] * d["tc"][m0:m1][ti])
        b0 = c1
    return out


def mix_tables(plan: StackedPlan, device, tdt) -> Dict:
    """K11's tables (its plain version's too) on ``device``, cached on the
    plan: the mix core's (:func:`gather_device`) with one output block a
    distinct row target ``tgt[:, 0]`` — a window of one row of dx dy
    elements, source and output contiguous — and the rows ``res`` offset
    and coefficient as its terms.  The host tables are cached once a plan
    (``plan._dev["k11"]``)."""
    key = ("k11", str(device), tdt)
    d = plan._dev.get(key)
    if d is None:
        h = plan._dev.get("k11")
        if h is None:
            n = plan.tgt[:, 1] * plan.tgt[:, 2]
            one = np.ones_like(n)
            h = gather_tables(plan.tgt[:, 0], plan.out_cap,
                              np.stack([plan.tgt[:, 0], n, one, n], 1),
                              plan.roff[plan.wsrc], plan.coef)
            plan._dev["k11"] = h
        d = gather_device(h, device, tdt, "K11's")
        plan._dev[key] = d
    return d


def stk_mix_plain(res, d: Dict, out):
    """Plain PyTorch version of K11 (the reference's ``_mix_scatter``) on
    K11's own tables: :func:`gather_plain` over every output block.
    Returns out."""
    return gather_plain(res, d, out, 0)


def stk_mix(res, d: Dict, out):
    """Symbol mix (kernel K11): ``out[tgt + e] += coef res[src + e]`` for
    every row and element, into the output pool ``out``; ``d`` from
    :func:`mix_tables`.  CPU tensors run :func:`stk_mix_plain`.  Returns
    out."""
    if res.dim() != 1 or out.dim() != 1:
        raise ValueError("stk_mix takes a flat res and a flat output")
    if res.device.type == "cpu":
        return stk_mix_plain(res, d, out)
    if not res.is_cuda:
        raise ValueError(f"unsupported device {res.device}")
    _kernels.launch("K11_stk_mix", "b2t_stk_mix", res.dtype, res, d["units"],
                    d["n_units"], d["blk"], d["bstart"], d["ts"], d["tc"],
                    out)
    return out


def execute_stacked(plan: StackedPlan, epool):
    """Output pool [out_cap] (zero above ``meta_out.total``) of one
    blocking step from the source bond's pool ``epool``, on its device and
    in its dtype: one launch of K10 into the ``res`` pool, one of K11 into
    the output."""
    _check_real(plan)
    dev, dt = epool.device, epool.dtype
    bp, kp = site_pools(plan, dev, dt)
    d10 = slab_plain_tables(plan, dev, dt) if dev.type == "cpu" \
        else slab_kernel_tables(plan, dev)
    res = torch.zeros(plan.res_total + 1, dtype=dt, device=dev)
    slab_exec(epool, bp, kp, d10, plan.left, res)
    out = torch.zeros(plan.out_cap, dtype=dt, device=dev)
    return stk_mix(res, mix_tables(plan, dev, dt), out)
