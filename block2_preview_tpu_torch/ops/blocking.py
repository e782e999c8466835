"""Host assembly of the fused-basis operators LW/RW and the join helpers
of host blocking (numpy).

Copied from block2_preview_tpu/ops/blocking.py (``pair_join``,
``_round_vec``, the plan signatures and ``assemble_fused_ops``) for the
port's host path (backend="numpy", the oracle) and for the mix-plan cache
signatures.  The reference's one-step ``contract_env_site`` and its
stacked-pool assembly path are not carried: host blocking runs through
``ops/blocking_plan.py`` and the device path assembles on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .csr import w_nonzero as _w_nonzero

from ..core.symmetry import QN


def pair_join(ga: np.ndarray, gb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All index pairs (ia, ib) with ga[ia] == gb[ib]."""
    sa = np.argsort(ga, kind="stable")
    sb = np.argsort(gb, kind="stable")
    gsa, gsb = ga[sa], gb[sb]
    ua, ca = np.unique(gsa, return_counts=True)
    ub, cb = np.unique(gsb, return_counts=True)
    common, iua, iub = np.intersect1d(ua, ub, assume_unique=True,
                                      return_indices=True)
    if len(common) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    na, nb = ca[iua], cb[iub]
    sta = np.concatenate([[0], np.cumsum(ca)])[iua]
    stb = np.concatenate([[0], np.cumsum(cb)])[iub]
    sizes = na * nb
    total = int(sizes.sum())
    reps = np.repeat(np.arange(len(common)), sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    lin = np.arange(total) - offs[reps]
    ia = sta[reps] + lin // nb[reps]
    ib = stb[reps] + lin % nb[reps]
    return sa[ia], sb[ib]


def _round_dim(d: int) -> int:
    if d <= 1:
        return 1
    if d <= 16:
        return 1 << (d - 1).bit_length()
    return ((d + 15) // 16) * 16


_ROUND_LUT = np.array([_round_dim(i) for i in range(65536)], dtype=np.int64)


def _round_vec(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, dtype=np.int64)
    if d.size and int(d.max(initial=0)) < len(_ROUND_LUT):
        return _ROUND_LUT[d]
    safe = np.maximum(d, 1)
    p2 = np.int64(1) << np.ceil(np.log2(safe)).astype(np.int64)
    m16 = ((d + 15) // 16) * 16
    return np.where(d <= 1, 1, np.where(d <= 16, p2, m16))


def _exec_assembly_cached(struct, env, group, dtype=np.float64):
    """Execute a cached assembly plan: refill the env pool and run the
    native scatter kernel (float64, or complex128 when ``dtype`` or an env
    block is complex)."""
    import ctypes

    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    eoffs = struct["eoffs"]
    blocks = [env[sym].blocks[k] for sym, k in struct["env_order"]]
    if any(np.iscomplexobj(b) for b in blocks):
        dtype = np.complex128
    if dtype not in (np.float64, np.complex128):
        return None
    epool = np.zeros(int(eoffs[-1]) + 1, dtype=dtype)
    for ii, blk in enumerate(blocks):
        epool[eoffs[ii]:eoffs[ii + 1]] = blk.ravel()
    flat = np.zeros(struct["total"], dtype=dtype)
    dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    fn = lib.assemble_exec_z if dtype == np.complex128 else lib.assemble_exec
    fn(
        len(struct["eoff_c"]), epool.ctypes.data_as(dp),
        struct["eoff_c"].ctypes.data_as(i64),
        struct["d1_c"].ctypes.data_as(i32),
        struct["d2_c"].ctypes.data_as(i32),
        struct["coef_c"].ctypes.data_as(dp),
        struct["ooff_c"].ctypes.data_as(i64),
        struct["rs_c"].ctypes.data_as(i64),
        struct["cs_c"].ctypes.data_as(i64),
        struct["grp"].ctypes.data_as(i64), len(struct["grp"]) - 1,
        flat.ctypes.data_as(dp))
    out: Dict[int, Dict] = {}
    for (m, qb_f, qk_f, o0, o1, r, c) in struct["out_meta"]:
        out.setdefault(m, {})[(qb_f, qk_f)] = flat[o0:o1].reshape(r, c)
    return out


def _fused_sig(fused):
    if fused is None:
        return 0
    h = 0
    for q, runs in fused.maps.items():
        h = hash((h, q, tuple(runs)))
    return h


def _entries_sig(entries):
    """Content digest of the MPO site tensor: (in, out) symbols AND matrix
    values.  The scatter plan bakes w[pb, pk] into coef_c, so two MPOs with
    identical structure but different integrals must never validate against
    each other's cached plan."""
    import hashlib
    hs = hashlib.blake2b(digest_size=8)
    for (i, o) in sorted(entries):
        w = entries[(i, o)]
        hs.update(int(i).to_bytes(8, "little", signed=True))
        hs.update(int(o).to_bytes(8, "little", signed=True))
        hs.update(np.ascontiguousarray(w).tobytes())
    return int.from_bytes(hs.digest(), "little")


def _plan_args_sig(entries, fused, fused_ket, active, active_ket,
                   comp_target, comp_target_ket):
    """Signature over every non-env input the scatter plan depends on:
    MPO entry content (symbols + coefficient values), the fused bra/ket
    bases (these are filtered against the *other* bond, which can change
    while the env side stays put), active symbol sets, complement targets.
    Process-stable (QNs are int tuples; entries digested via hashlib)."""
    return hash((_entries_sig(entries), comp_target, comp_target_ket,
                 _fused_sig(fused),
                 _fused_sig(fused_ket) if fused_ket is not fused else 1,
                 tuple(sorted(active)) if active is not None else None,
                 tuple(sorted(active_ket)) if active_ket is not None
                 else None))


def _assembly_sig(env, args_sig):
    """args_sig (_plan_args_sig) + the env block layout."""
    h = args_sig
    for sym, bm in env.items():
        for k, blk in bm.blocks.items():
            h = hash((h, sym, k, blk.shape))
    return h


def assemble_fused_ops(env, entries, quanta, fused, bond_is_first: bool,
                       join_on_input: bool, comp_target=None, group=None,
                       active=None, dtype=np.float64, fused_ket=None,
                       comp_target_ket=None, active_ket=None,
                       plan_cache=None, plan_key=None):
    """Vectorized assembly of fused-basis effective operators LW[m]/RW[m]
    (the DelayedOperatorTensor contraction of block2, reference
    src/core/operator_tensor.hpp:209), replacing per-block Python loops in
    EffectiveHamiltonian2._assemble.

    env:     {symbol -> BlockMatrix} on a bond basis
    entries: MPO site tensor {(i, o) -> (d, d) matrix}
    fused:   FusedBasis of (bond x site) if bond_is_first else
             (site x comp-bond)
    join_on_input: True -> join env symbol with entry's *input* symbol and
             key outputs by the entry's output symbol (LW);
             False -> join on the entry's *output* symbol, key by input (RW).
    comp_target: if set, bond sectors are complemented (q -> target - q)
             before fusing (the right-half convention).
    Returns {m -> {(q_bra_fused, q_ket_fused) -> ndarray}}.
    """
    g = group
    nphys = len(quanta)
    use_cache = plan_cache is not None and plan_key is not None
    args_sig = _plan_args_sig(entries, fused, fused_ket, active,
                              active_ket, comp_target,
                              comp_target_ket) if use_cache else None
    if use_cache:
        sig = _assembly_sig(env, args_sig)
        ent = plan_cache.get(plan_key)
        if ent is not None and ent[0] == sig:
            out = _exec_assembly_cached(ent[1], env, group, dtype)
            if out is not None:
                return out
    # bond sector codes
    code_of: Dict[QN, int] = {}
    code_list: List[QN] = []

    def code(q):
        c = code_of.get(q)
        if c is None:
            c = len(code_list)
            code_of[q] = c
            code_list.append(q)
        return c

    esym, eqb, eqk, emats = [], [], [], []
    env_order = []
    for sym, bm in env.items():
        for (qb, qk), mat in bm.blocks.items():
            env_order.append((sym, (qb, qk)))
            esym.append(sym)
            eqb.append(code(qb))
            eqk.append(code(qk))
            emats.append(mat)
    if not emats:
        return {}
    esym = np.asarray(esym, dtype=np.int64)
    eqb = np.asarray(eqb, dtype=np.int64)
    eqk = np.asarray(eqk, dtype=np.int64)
    ncodes0 = len(code_list)

    wi, wo, wpb, wpk, wc = [], [], [], [], []
    for (i, o), w in entries.items():
        for pb, pk in zip(*_w_nonzero(w)):
            wi.append(i)
            wo.append(o)
            wpb.append(int(pb))
            wpk.append(int(pk))
            wc.append(w[pb, pk])
    if not wi:
        return {}
    wi = np.asarray(wi, dtype=np.int64)
    wo = np.asarray(wo, dtype=np.int64)
    wpb = np.asarray(wpb, dtype=np.int64)
    wpk = np.asarray(wpk, dtype=np.int64)
    wc = np.asarray(wc)

    # lookup: (bond code, phys idx) -> fused sector id, sub-offset, run dim
    fused_k = fused if fused_ket is None else fused_ket
    ct_k = comp_target if comp_target_ket is None else comp_target_ket
    act_k = active if active_ket is None else active_ket
    fsec_of: Dict[Tuple[int, QN], int] = {}
    fsec_list: List[Tuple[int, QN]] = []

    def _build_tab(fb, ct, act, side):
        """(bond code, phys state) -> fused sector id, base offset within the
        sector, and the stride between consecutive bond states.  Runs are
        laid out (a-major, b-minor); with degenerate site quanta the site
        multiplicity strides the bond axis on whichever side the bond is."""
        tab_sec = np.full((ncodes0, nphys), -1, dtype=np.int64)
        tab_off = np.zeros((ncodes0, nphys), dtype=np.int64)
        tab_str = np.ones((ncodes0, nphys), dtype=np.int64)
        for fq, runs in fb.maps.items():
            if act is not None and fq not in act:
                continue
            key = (side, fq)
            if key not in fsec_of:
                fsec_of[key] = len(fsec_list)
                fsec_list.append(key)
            fid = fsec_of[key]
            for (qa, qb2, off, da, db) in runs:
                if bond_is_first:
                    qbond, p_qn = qa, qb2
                else:
                    p_qn, qbond = qa, qb2
                qb_real = qbond if ct is None else g.sub(ct, qbond)
                cc = code_of.get(qb_real)
                if cc is None:
                    continue
                idx_within = 0
                for p, q in enumerate(quanta):
                    if q == p_qn:
                        tab_sec[cc, p] = fid
                        if bond_is_first:
                            # fused index = off + bond*db + idx_within
                            tab_off[cc, p] = off + idx_within
                            tab_str[cc, p] = db
                        else:
                            # fused index = off + idx_within*db + bond
                            tab_off[cc, p] = off + idx_within * db
                            tab_str[cc, p] = 1
                        idx_within += 1
        return tab_sec, tab_off, tab_str

    tab_sec_b, tab_off_b, tab_str_b = _build_tab(fused, comp_target,
                                                 active, 0)
    tab_sec_k, tab_off_k, tab_str_k = _build_tab(fused_k, ct_k, act_k, 1)
    fdims = np.asarray([(fused.info[q] if side == 0 else fused_k.info[q])
                        for side, q in fsec_list], dtype=np.int64)

    join_key = wi if join_on_input else wo
    out_key = wo if join_on_input else wi
    ie, iw = pair_join(esym, join_key)
    if len(ie) == 0:
        return {}
    sb = tab_sec_b[eqb[ie], wpb[iw]]
    sk = tab_sec_k[eqk[ie], wpk[iw]]
    valid = (sb >= 0) & (sk >= 0)
    ie, iw, sb, sk = ie[valid], iw[valid], sb[valid], sk[valid]
    if len(ie) == 0:
        return {}
    ob = tab_off_b[eqb[ie], wpb[iw]]
    ok = tab_off_k[eqk[ie], wpk[iw]]
    stb = tab_str_b[eqb[ie], wpb[iw]]
    stk = tab_str_k[eqk[ie], wpk[iw]]
    msym = out_key[iw]
    coefs = wc[iw]
    eshape = np.asarray([m.shape for m in emats], dtype=np.int64)
    d1 = eshape[ie, 0]
    d2 = eshape[ie, 1]
    dtype = np.result_type(dtype, emats[0].dtype, wc.dtype)

    # output buffers: unique (msym, sb, sk)
    nf = len(fsec_list)
    okey = (msym * nf + sb) * nf + sk
    uniq, first, inv = np.unique(okey, return_index=True, return_inverse=True)
    inv = inv.ravel()
    u_sb = sb[first]
    u_sk = sk[first]
    out_rows = fdims[u_sb]
    out_cols = fdims[u_sk]
    sizes = out_rows * out_cols
    offs = np.concatenate([[0], np.cumsum(sizes)])
    flat = np.zeros(int(offs[-1]), dtype=dtype)

    # pooled env data
    epool = np.empty(int(np.sum(d1 * 0) + sum(m.size for m in emats)) + 1,
                     dtype=dtype)
    eoffs = np.zeros(len(emats) + 1, dtype=np.int64)
    for ii, m in enumerate(emats):
        eoffs[ii + 1] = eoffs[ii] + m.size
        epool[eoffs[ii]:eoffs[ii + 1]] = m.ravel()
    epool[-1] = 0.0

    # native (C++/OpenMP) scatter-assembly fast path (real coefficients,
    # float64 or complex128 data)
    if dtype in (np.float64, np.complex128) and not np.iscomplexobj(coefs):
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            import ctypes
            order2 = np.argsort(inv, kind="stable")
            inv_s = inv[order2]
            gbnd = np.nonzero(np.diff(inv_s))[0] + 1
            grp = np.ascontiguousarray(
                np.concatenate([[0], gbnd, [len(order2)]]).astype(np.int64))
            eoff_c = np.ascontiguousarray(eoffs[ie[order2]])
            d1_c = np.ascontiguousarray(d1[order2].astype(np.int32))
            d2_c = np.ascontiguousarray(d2[order2].astype(np.int32))
            coef_c = np.ascontiguousarray(coefs[order2].astype(np.float64))
            cols_c = out_cols[inv_s]
            ooff_c = np.ascontiguousarray(
                offs[inv_s] + ob[order2] * cols_c + ok[order2])
            rs_c = np.ascontiguousarray(stb[order2] * cols_c)
            cs_c = np.ascontiguousarray(stk[order2])
            dp = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.POINTER(ctypes.c_int64)
            i32 = ctypes.POINTER(ctypes.c_int32)
            fn = (lib.assemble_exec_z if dtype == np.complex128
                  else lib.assemble_exec)
            fn(
                len(order2), epool.ctypes.data_as(dp),
                eoff_c.ctypes.data_as(i64),
                d1_c.ctypes.data_as(i32), d2_c.ctypes.data_as(i32),
                coef_c.ctypes.data_as(dp),
                ooff_c.ctypes.data_as(i64), rs_c.ctypes.data_as(i64),
                cs_c.ctypes.data_as(i64),
                grp.ctypes.data_as(i64), len(grp) - 1,
                flat.ctypes.data_as(dp))
            out_n: Dict[int, Dict] = {}
            out_meta = []
            for u in range(len(uniq)):
                m = int((uniq[u] // nf) // nf)
                qb_f = fsec_list[int(u_sb[u])][1]
                qk_f = fsec_list[int(u_sk[u])][1]
                out_n.setdefault(m, {})[(qb_f, qk_f)] = \
                    flat[offs[u]:offs[u + 1]].reshape(int(out_rows[u]),
                                                      int(out_cols[u]))
                out_meta.append((m, qb_f, qk_f, int(offs[u]),
                                 int(offs[u + 1]), int(out_rows[u]),
                                 int(out_cols[u])))
            if use_cache:
                struct = {
                    "env_order": env_order, "eoffs": eoffs.copy(),
                    "eoff_c": eoff_c, "d1_c": d1_c, "d2_c": d2_c,
                    "coef_c": coef_c, "ooff_c": ooff_c, "rs_c": rs_c,
                    "cs_c": cs_c, "grp": grp, "total": int(offs[-1]),
                    "out_meta": out_meta, "args_sig": args_sig}
                plan_cache[plan_key] = (sig, struct)
            return out_n

    # chunk by padded env-block shape
    r1, r2 = _round_vec(d1), _round_vec(d2)
    bkey = (r1 << 20) | r2
    order = np.argsort(bkey, kind="stable")
    bounds = np.nonzero(np.diff(bkey[order]))[0] + 1
    starts = np.concatenate([[0], bounds, [len(order)]])
    for si in range(len(starts) - 1):
        sel_all = order[starts[si]:starts[si + 1]]
        for lo in range(0, len(sel_all), 8192):
            sel = sel_all[lo:lo + 8192]
            R = int(r1[sel[0]])
            Cc = int(r2[sel[0]])
            rr = np.arange(R)[None, :, None]
            cc2 = np.arange(Cc)[None, None, :]
            rt = d1[sel][:, None, None]
            ct = d2[sel][:, None, None]
            mask = (rr < rt) & (cc2 < ct)
            gidx = eoffs[ie[sel]][:, None, None] + rr * ct + cc2
            vals = epool[np.where(mask, gidx, len(epool) - 1)]
            vals = vals * coefs[sel][:, None, None]
            # target flat index: out offset + (ob + r*stride_b) * cols
            #                    + ok + c*stride_k
            oid = inv[sel]
            cols = out_cols[oid][:, None, None]
            tidx = (offs[oid][:, None, None]
                    + (ob[sel][:, None, None]
                       + rr * stb[sel][:, None, None]) * cols
                    + ok[sel][:, None, None]
                    + cc2 * stk[sel][:, None, None])
            np.add.at(flat, tidx[mask], vals[mask])

    out: Dict[int, Dict] = {}
    for u in range(len(uniq)):
        m = int((uniq[u] // nf) // nf)
        qb_f = fsec_list[int(u_sb[u])][1]
        qk_f = fsec_list[int(u_sk[u])][1]
        out.setdefault(m, {})[(qb_f, qk_f)] = \
            flat[offs[u]:offs[u + 1]].reshape(int(out_rows[u]),
                                              int(out_cols[u]))
    return out
