"""SU(2) environment blocking on the abelian blocking kernel K5.

Copied from block2_preview_tpu/ops/su2blk.py (the port keeps its own copy
of the host planner): the SU(2) fermionic engine's environment
contraction (dmrg/su2_fermion.py ``_left_contract``/``_right_contract``)
is, per contribution, one ``A^T @ E @ A`` times a SCALAR (a 9j recoupling
factor x graded phase x reduced site element), so it maps exactly onto
the abelian blocking-v2 plan (``ops/blockv2.BlockingV2Plan``): items are
(env block, bra multiplet block, ket multiplet block) triples rotating E
through the site tensors, and the entry table carries the per-(item,
output) coefficient.  :func:`build_su2_blocking` builds that plan with
vectorized numpy, with the tile escalation of the port's ``pick_tile``
and the pool classes of its ``_cap_class``/``_pow2`` (both copies of the
reference's), so the tables equal the reference's field by field.

The plan runs on kernel K5's v2 path (``ops/blockv2.execute_blocking_v2``:
fan-out atomics, so an SU(2) environment is not bitwise repeatable on the
card) or, on CPU tensors, its plain twin.  The reference's device-cache
tokens (``_devtok``/``_pooltok``) are not carried: the port's plan caches
its device tables and site pools in ``_dev``, and
:func:`refresh_su2_sites` replaces the site values of a cached plan and
drops its uploaded pools.

Reference analog: the SU(2) specialization of
TensorFunctions::left_contract + OperatorFunctions::tensor_rotate
(src/core/operator_functions.hpp:175: the cg->wigner_9j factor applied
per renormalized block) dispatched through BatchGEMM.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .blockv2 import BlockingV2Plan, _CFG, execute_blocking_v2
from .stacked import _cap_class, _pow2
from .tiled import pick_tile


class SU2EnvMeta:
    """Flat-pool layout of one SU(2) environment: blocks keyed
    (symbol, q_bra, q_ket) at (offset, db, dk)."""

    __slots__ = ("layout", "total")

    def __init__(self, env: Dict):
        layout = {}
        off = 0
        for sym in sorted(env):
            for (qb, qk) in sorted(env[sym]):
                b = env[sym][(qb, qk)]
                layout[(sym, qb, qk)] = (off, b.shape[0], b.shape[1])
                off += b.size
        self.layout = layout
        self.total = off

    def pack(self, env: Dict, dtype=np.float64) -> np.ndarray:
        pool = np.zeros(_cap_class(self.total + 1), dtype=dtype)
        for (sym, qb, qk), (off, db, dk) in self.layout.items():
            pool[off:off + db * dk] = env[sym][(qb, qk)].ravel()
        return pool

    def unpack(self, pool: np.ndarray) -> Dict:
        return unpack_env(pool, self.layout)


def build_su2_blocking(eng, t: int, direction: str,
                       env: Dict) -> Optional[Tuple]:
    """Plan the SU(2) env contraction at site t as a BlockingV2Plan.

    Returns (plan, in_meta, out_meta) or None (empty).  out_meta is a
    SU2EnvMeta-like layout for the produced bond's env dict."""
    from functools import lru_cache

    from ..dmrg.su2_spin import coupled_factor

    left = direction == "left"
    A = eng.tensors[t]
    mults = eng.mults[t]
    mult_tj = np.asarray([m[1] for m in mults], np.int64)
    mult_n = np.asarray([m[0] for m in mults], np.int64)
    entries = eng.site_entries[t]

    in_meta = SU2EnvMeta(env)
    if not in_meta.layout:
        return None

    # --- qn id table -------------------------------------------------
    qn_ids: Dict[Tuple, int] = {}
    qn_list: List[Tuple] = []

    def qid(q):
        i = qn_ids.get(q)
        if i is None:
            i = len(qn_ids)
            qn_ids[q] = i
            qn_list.append(q)
        return i

    # --- site blocks indexed by the env-side bond quantum ------------
    # left: env pair is (qlb, qlk) and blocks A[(ql, m, qr)] join on ql;
    # right: env pair is (qrb, qrk) and blocks join on qr
    mats: List[np.ndarray] = []
    site_tab: Dict[int, List[Tuple[int, int, int]]] = {}

    for (ql, m, qr), b in sorted(A.items()):
        join_q, other_q = (ql, qr) if left else (qr, ql)
        jid = qid(join_q)
        oid = qid(other_q)
        site_tab.setdefault(jid, []).append((m, oid, len(mats)))
        mats.append(np.ascontiguousarray(b))
    moffs = np.concatenate(
        [[0], np.cumsum([m.size for m in mats])]).astype(np.int64)

    # CSR form of site_tab
    njq = len(qn_ids)
    st_cnt = np.zeros(njq + 1, np.int64)
    st_m, st_o, st_b = [], [], []
    for j in range(njq):
        rowsj = site_tab.get(j, [])
        st_cnt[j + 1] = st_cnt[j] + len(rowsj)
        for (m, oid, bid) in rowsj:
            st_m.append(m)
            st_o.append(oid)
            st_b.append(bid)
    st_m = np.asarray(st_m, np.int64)
    st_o = np.asarray(st_o, np.int64)
    st_b = np.asarray(st_b, np.int64)

    # --- env blocks as arrays ---------------------------------------
    eb_sym, eb_qb, eb_qk, eb_off, eb_db, eb_dk = [], [], [], [], [], []
    for (sym, qb, qk), (off, db, dk) in in_meta.layout.items():
        eb_sym.append(sym)
        eb_qb.append(qid(qb))
        eb_qk.append(qid(qk))
        eb_off.append(off)
        eb_db.append(db)
        eb_dk.append(dk)
    eb_sym = np.asarray(eb_sym, np.int64)
    eb_qb = np.asarray(eb_qb, np.int64)
    eb_qk = np.asarray(eb_qk, np.int64)
    eb_off = np.asarray(eb_off, np.int64)
    eb_db = np.asarray(eb_db, np.int64)
    eb_dk = np.asarray(eb_dk, np.int64)
    # env blocks by symbol
    order_e = np.argsort(eb_sym, kind="stable")
    nsym_max = int(eb_sym.max()) + 1 if len(eb_sym) else 0
    esym_cnt = np.bincount(eb_sym, minlength=nsym_max + 1)
    esym_start = np.concatenate([[0], np.cumsum(esym_cnt)])

    qn_n = np.asarray([q[0] for q in qn_list], np.int64)
    qn_tj = np.asarray([q[1] for q in qn_list], np.int64)

    # --- combos: distinct (env sym, w) over the entries --------------
    ent_i = np.asarray([e[0] for e in entries], np.int64)
    ent_o = np.asarray([e[1] for e in entries], np.int64)
    ent_cf = np.asarray([e[3] for e in entries], np.float64)
    ent_w = [e[2] for e in entries]
    jsym = ent_i if left else ent_o
    osym = ent_o if left else ent_i
    wname_ids: Dict[str, int] = {}
    wred_l, wk_l, wdn_l = [], [], []
    ent_wid = np.empty(len(entries), np.int64)
    for idx, w in enumerate(ent_w):
        wi = wname_ids.get(w)
        if wi is None:
            wi = len(wname_ids)
            wname_ids[w] = wi
            wr, kw, dnw = eng._op_at(t, w)
            wred_l.append(np.asarray(wr, np.float64))
            wk_l.append(kw)
            wdn_l.append(dnw)
        ent_wid[idx] = wi
    wk_a = np.asarray(wk_l, np.int64)
    wdn_a = np.asarray(wdn_l, np.int64)

    ckey = jsym * len(wname_ids) + ent_wid
    order_c = np.argsort(ckey, kind="stable")
    ckey_s = ckey[order_c]
    newc = np.ones(len(ckey_s), bool)
    newc[1:] = ckey_s[1:] != ckey_s[:-1]
    cstart = np.flatnonzero(newc)
    cend = np.concatenate([cstart[1:], [len(ckey_s)]])
    c_j = (ckey_s[cstart] // len(wname_ids))
    c_w = (ckey_s[cstart] % len(wname_ids))
    ncombo = len(cstart)

    rank = eng.rank

    # --- item expansion: combo x env-blocks x bra-rows x ket-rows ----
    it_rows = []     # per item: (ebid, bid_b, bid_k, combo, key args)
    ef_item, ef_obase_key, ef_coef = [], [], []
    out_layout: Dict[Tuple, Tuple[int, int, int]] = {}
    fac9 = lru_cache(maxsize=1 << 20)(coupled_factor)

    # per-combo python loop with vectorized inner joins (combos are the
    # (mpo bond symbol, site op) pairs: ~1e3-1e4; the 1e7 contribution
    # level stays in numpy)
    items_eb, items_bb, items_bk = [], [], []
    items_combo = []
    for ci in range(ncombo):
        jq = int(c_j[ci])
        wi = int(c_w[ci])
        if jq >= len(esym_start) - 1:
            continue
        lo, hi = esym_start[jq], esym_start[jq + 1]
        if lo == hi:
            continue
        bl = order_e[lo:hi]
        # join env blocks with bra rows (on qb) and ket rows (on qk)
        nb = st_cnt[eb_qb[bl] + 1] - st_cnt[eb_qb[bl]]
        nk = st_cnt[eb_qk[bl] + 1] - st_cnt[eb_qk[bl]]
        per = nb * nk
        tot = int(per.sum())
        if tot == 0:
            continue
        ebx = np.repeat(bl, per)
        cum = np.concatenate([[0], np.cumsum(per)[:-1]])
        o = np.arange(tot) - np.repeat(cum, per)
        nk_x = np.repeat(nk, per)
        bi = o // nk_x
        ki = o % nk_x
        rb = st_cnt[eb_qb[ebx]] + bi
        rk = st_cnt[eb_qk[ebx]] + ki
        wred = wred_l[wi]
        r_el = wred[st_m[rb], st_m[rk]]
        ok = r_el != 0.0
        if not ok.any():
            continue
        ebx, rb, rk, r_el = ebx[ok], rb[ok], rk[ok], r_el[ok]
        items_eb.append(ebx)
        items_bb.append(st_b[rb])
        items_bk.append(st_b[rk])
        items_combo.append(np.full(len(ebx), ci, np.int64))
    if not items_eb:
        return None
    items_eb = np.concatenate(items_eb)
    items_bb = np.concatenate(items_bb)
    items_bk = np.concatenate(items_bk)
    items_combo = np.concatenate(items_combo)
    nit = len(items_eb)

    # dims / quanta per item
    db_a = eb_db[items_eb]
    dk_a = eb_dk[items_eb]
    bshp = np.asarray([[m.shape[0], m.shape[1]] for m in mats],
                      np.int64)
    if left:
        dx_a = bshp[items_bb, 1]
        dy_a = bshp[items_bk, 1]
    else:
        dx_a = bshp[items_bb, 0]
        dy_a = bshp[items_bk, 0]
    # bra/ket block "other-side" quanta: build bid -> oid map
    bid_oid = np.empty(len(mats), np.int64)
    bid_m = np.empty(len(mats), np.int64)
    for j in range(njq):
        lo, hi = st_cnt[j], st_cnt[j + 1]
        bid_oid[st_b[lo:hi]] = st_o[lo:hi]
        bid_m[st_b[lo:hi]] = st_m[lo:hi]
    qrb_a = bid_oid[items_bb]
    qrk_a = bid_oid[items_bk]
    mb_a = bid_m[items_bb]
    mk_a = bid_m[items_bk]

    # --- per-(item, entry) coefficients ------------------------------
    # entries of combo ci: slice order_c[cstart[ci]:cend[ci]]
    n_per_combo = (cend - cstart)[items_combo]
    ne = int(n_per_combo.sum())
    efc = np.concatenate([[0], np.cumsum(n_per_combo)]).astype(np.int64)
    ef_it = np.repeat(np.arange(nit, dtype=np.int64), n_per_combo)
    within = (np.arange(ne, dtype=np.int64) - np.repeat(efc[:-1],
                                                        n_per_combo))
    ent_idx = order_c[np.repeat(cstart[items_combo], n_per_combo)
                      + within]
    e_os = osym[ent_idx]
    e_cf = ent_cf[ent_idx]
    # 9j factor arguments per (item, entry): spins + ranks
    k_w = wk_a[c_w[items_combo[ef_it]]]
    if left:
        k_i = np.asarray([rank[int(s)] for s in jsym[ent_idx]], np.int64)
        k_o = np.asarray([rank[int(s)] for s in e_os], np.int64)
        args = np.stack([
            qn_tj[eb_qk[items_eb[ef_it]]], mult_tj[mk_a[ef_it]],
            qn_tj[qrk_a[ef_it]],
            k_i, k_w, k_o,
            qn_tj[eb_qb[items_eb[ef_it]]], mult_tj[mb_a[ef_it]],
            qn_tj[qrb_a[ef_it]]], 1)
        # graded phase: (-1)^{p_w * N(qlk)}
        p_w = (np.abs(wdn_a[c_w[items_combo[ef_it]]]) % 2)
        phase = np.where((p_w == 1)
                         & (qn_n[eb_qk[items_eb[ef_it]]] % 2 == 1),
                         -1.0, 1.0)
    else:
        k_o2 = np.asarray([rank[int(s)] for s in jsym[ent_idx]],
                          np.int64)
        k_i2 = np.asarray([rank[int(s)] for s in e_os], np.int64)
        args = np.stack([
            mult_tj[mk_a[ef_it]], qn_tj[eb_qk[items_eb[ef_it]]],
            qn_tj[qrk_a[ef_it]],
            k_w, k_o2, k_i2,
            mult_tj[mb_a[ef_it]], qn_tj[eb_qb[items_eb[ef_it]]],
            qn_tj[qrb_a[ef_it]]], 1)
        # graded phase: (-1)^{p_o * N(ket site multiplet)}
        p_o = (np.abs(np.asarray([eng.dn[int(s)]
                                  for s in jsym[ent_idx]],
                                 np.int64)) % 2)
        phase = np.where((p_o == 1) & (mult_n[mk_a[ef_it]] % 2 == 1),
                         -1.0, 1.0)
    uargs, uinv = np.unique(args, axis=0, return_inverse=True)
    ufac = np.asarray([fac9(*map(int, row)) for row in uargs])
    r_item = np.zeros(nit)
    # reduced element per item (recompute: wred[mb, mk])
    for wi in range(len(wred_l)):
        sel = c_w[items_combo] == wi
        if sel.any():
            r_item[sel] = wred_l[wi][mb_a[sel], mk_a[sel]]
    coef = phase * ufac[uinv] * r_item[ef_it] * e_cf
    live_e = np.abs(coef) > 1e-14

    # --- output layout ----------------------------------------------
    okey = (e_os * njq + qrb_a[ef_it]) * njq + qrk_a[ef_it]
    okey_live = okey[live_e]
    if not len(okey_live):
        return None
    uok, ofirst = np.unique(okey_live, return_index=True)
    ef_lit = ef_it[live_e]
    out_off = {}
    ooff = 0
    for u, fi in zip(uok.tolist(), ofirst.tolist()):
        it0 = int(ef_lit[fi])
        dx, dy = int(dx_a[it0]), int(dy_a[it0])
        out_off[int(u)] = (ooff, dx, dy)
        ooff += dx * dy
    out_total = ooff
    pos = np.searchsorted(uok, okey_live)
    obase = np.asarray([out_off[int(u)][0] for u in uok])[pos]

    # drop items with no live entries
    live_it = np.zeros(nit, bool)
    live_it[ef_lit] = True
    idx_map = -np.ones(nit, np.int64)
    idx_map[live_it] = np.arange(int(live_it.sum()))
    items_sel = np.flatnonzero(live_it)
    nit2 = len(items_sel)
    ef_item2 = idx_map[ef_lit]
    # ef rows must be grouped by item (cum3 assumes item-ordered rows)
    order_ef = np.argsort(ef_item2, kind="stable")
    ef_item2 = ef_item2[order_ef]
    obase = obase[order_ef]
    coef2 = coef[live_e][order_ef]
    odx = dx_a[items_sel][ef_item2]
    ody = dy_a[items_sel][ef_item2]

    # --- blockv2 plan arrays -----------------------------------------
    db2 = db_a[items_sel]
    dk2 = dk_a[items_sel]
    dx2 = dx_a[items_sel]
    dy2 = dy_a[items_sel]
    nent2 = np.bincount(ef_item2, minlength=nit2)
    dims = np.concatenate([db2, dk2, dx2, dy2])
    T = pick_tile(dims)
    while True:
        B, nt1, ntp = _CFG[T]
        nl_a = -(-db2 // T)
        nk_a = -(-dk2 // T)
        nx_a = -(-dx2 // T)
        ny_a = -(-dy2 // T)
        itmp = nl_a * ny_a
        iprod = nx_a * ny_a
        n1_a = itmp * nk_a
        n2_a = iprod * nl_a
        n3_a = iprod * nent2
        if (itmp.max() <= nt1 and iprod.max() <= ntp
                and n1_a.max() <= B and n2_a.max() <= B
                and n3_a.max() <= B):
            break
        if T >= 128:
            raise ValueError("block too large for any tile config")
        T *= 2

    c1 = np.concatenate([[0], np.cumsum(n1_a)]).astype(np.int64)
    c2 = np.concatenate([[0], np.cumsum(n2_a)]).astype(np.int64)
    c3 = np.concatenate([[0], np.cumsum(n3_a)]).astype(np.int64)
    cit = np.concatenate([[0], np.cumsum(itmp)]).astype(np.int64)
    cip = np.concatenate([[0], np.cumsum(iprod)]).astype(np.int64)
    starts = []
    i0 = 0
    while i0 < nit2:
        starts.append(i0)
        e = min(int(np.searchsorted(cit, cit[i0] + nt1, "right")) - 1,
                int(np.searchsorted(cip, cip[i0] + ntp, "right")) - 1,
                int(np.searchsorted(c1, c1[i0] + B, "right")) - 1,
                int(np.searchsorted(c2, c2[i0] + B, "right")) - 1,
                int(np.searchsorted(c3, c3[i0] + B, "right")) - 1)
        i0 = max(e, i0 + 1)
    starts_a = np.asarray(starts, np.int64)
    gs_item = np.repeat(starts_a, np.diff(
        np.concatenate([starts_a, [nit2]])))
    tb_a = cit[:-1] - cit[gs_item]
    pb_a = cip[:-1] - cip[gs_item]

    it = np.zeros((nit2, 13), dtype=np.int32)
    it[:, 0] = eb_off[items_eb[items_sel]]
    it[:, 1] = dk2
    it[:, 2] = db2
    it[:, 3] = moffs[items_bk[items_sel]]
    it[:, 4] = dy2
    it[:, 5] = moffs[items_bb[items_sel]]
    it[:, 6] = dx2
    it[:, 7] = nl_a
    it[:, 8] = nk_a
    it[:, 9] = nx_a
    it[:, 10] = ny_a
    it[:, 11] = tb_a
    it[:, 12] = pb_a

    ne2 = len(ef_item2)
    ef = np.empty((ne2, 4), dtype=np.int32)
    ef[:, 0] = ef_item2
    ef[:, 1] = obase
    ef[:, 2] = odx
    ef[:, 3] = ody
    cum3 = np.concatenate(
        [[0], np.cumsum(iprod[ef_item2])]).astype(np.int32)

    plan = BlockingV2Plan()
    plan.meta_out = None
    nit_q = _pow2(nit2)
    it = np.concatenate([it, np.zeros((nit_q - nit2, 13), it.dtype)])
    it[nit2:, 7:11] = 1
    c1 = np.concatenate([c1, np.full(nit_q - nit2, c1[-1], c1.dtype)])
    c2 = np.concatenate([c2, np.full(nit_q - nit2, c2[-1], c2.dtype)])
    ne_q = _pow2(ne2)
    ef = np.concatenate([ef, np.zeros((ne_q - ne2, 4), ef.dtype)])
    ef[ne2:, 3] = 1
    coef2 = np.concatenate([coef2, np.zeros(ne_q - ne2)])
    cum3 = np.concatenate(
        [cum3, np.full(ne_q - ne2, cum3[-1], cum3.dtype)])

    plan.T = T
    plan.B = B
    plan.nt1 = nt1
    plan.ntp = ntp
    plan.ncap = _cap_class(out_total + 1)
    plan.left = left
    plan.it = it
    plan.ef = ef
    plan.coef = coef2
    plan.cum1 = c1.astype(np.int32)
    plan.cum2 = c2.astype(np.int32)
    plan.cum3 = cum3
    plan.g1 = c1[starts_a].astype(np.int32)
    plan.g2 = c2[starts_a].astype(np.int32)
    plan.g3 = c3[starts_a].astype(np.int32)
    plan.bra_pool = (mats, moffs)
    plan.ket_pool = (mats, moffs)
    plan.flops = float(2 * (db2 * dk2 * dy2 + db2 * dx2 * dy2).sum())
    plan._dev = {}
    plan._src = None

    # out meta for unpacking: (osym, q_bra, q_ket) -> (off, dx, dy)
    out_meta = {}
    for u, (off, dx, dy) in out_off.items():
        osym_u = u // (njq * njq)
        qrb_u = (u // njq) % njq
        qrk_u = u % njq
        out_meta[(int(osym_u), qn_list[int(qrb_u)],
                  qn_list[int(qrk_u)])] = (off, dx, dy)
    return plan, in_meta, out_meta


def refresh_su2_sites(plan: BlockingV2Plan, A: Dict) -> None:
    """Give a cached plan the current values of the site tensor ``A``
    (block dict keyed (ql, m, qr), the builder's sorted registration
    order) and drop its uploaded bra/ket pools (``plan._dev["pools",
    ...]``, ``ops/stacked.site_pools``), so the next launch reads the new
    rotation matrices.  Without the drop, every sweep after the first
    would contract with the first sweep's tensors."""
    mats = [np.ascontiguousarray(b) for _k, b in sorted(A.items())]
    offs = plan.bra_pool[1]
    if len(mats) + 1 != len(offs) or any(
            m.size != int(offs[i + 1] - offs[i]) for i, m in enumerate(mats)):
        raise ValueError("site tensor blocks do not match the cached plan")
    plan.bra_pool = (mats, offs)
    plan.ket_pool = (mats, offs)
    for key in [k for k in plan._dev if k[0] == "pools"]:
        del plan._dev[key]


def unpack_env(out: np.ndarray, out_meta: Dict) -> Dict:
    """The environment dict {symbol: {(q_bra, q_ket): block}} of a pool
    laid out by ``out_meta`` ((symbol, q_bra, q_ket) -> (offset, rows,
    columns)), all-zero blocks dropped (reference :62-70, :493-499)."""
    new_env: Dict = {}
    for (osym, qb, qk), (off, dx, dy) in out_meta.items():
        blk = np.asarray(out[off:off + dx * dy],
                         np.float64).reshape(dx, dy)
        if not blk.any():
            continue
        new_env.setdefault(osym, {})[(qb, qk)] = blk
    return new_env


def run_su2_blocking(plan: BlockingV2Plan, in_meta: SU2EnvMeta,
                     out_meta: Dict, env: Dict, dtype=np.float64,
                     device="cuda", timings: Optional[Dict] = None) -> Dict:
    """One SU(2) blocking step of a built plan: the environment packed
    into its pool and uploaded, kernel K5 (its twin on the CPU), the
    output pool read back into a host dict — the reference's host round
    trip (su2_fermion.py:547-556).  With ``timings``, adds the seconds of
    the round trip ("blk_rt") and of K5 ("blk_k5"), the card synchronised
    around the launch."""
    from ..runtime import resolve_device, torch_dtype
    dev = resolve_device(device)

    def sync():
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    pool = torch.as_tensor(in_meta.pack(env, dtype=dtype),
                           dtype=torch_dtype(dtype), device=dev)
    sync()
    t1 = time.perf_counter()
    out = execute_blocking_v2(plan, pool)
    sync()
    t2 = time.perf_counter()
    new_env = unpack_env(out.cpu().numpy(), out_meta)
    if timings is not None:
        timings["blk_rt"] += (t1 - t0) + (time.perf_counter() - t2)
        timings["blk_k5"] += t2 - t1
    return new_env


def su2_contract_device(eng, t: int, direction: str, env: Dict,
                        dtype=np.float64, device="cuda") -> Optional[Dict]:
    """Full SU(2) env contraction step on kernel K5 (its twin on
    ``device="cpu"``); returns the new env dict (or None if the plan is
    empty)."""
    res = build_su2_blocking(eng, t, direction, env)
    if res is None:
        return None
    return run_su2_blocking(*res, env, dtype=dtype, device=device)
