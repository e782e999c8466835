"""Reusable, device-executable environment-blocking plans.

The join/bucket structure of one blocking step (ops/blocking.py) depends only
on the *block structure* of the environment, the MPO site tensor, and the MPS
site tensors — not on their numeric contents.  This module separates the two:

  * ``BlockingPlan``: gather indices, padded bucket descriptors, MPO
    coefficients, and a pre-sorted global scatter map (permutation +
    reduceat/segment boundaries), built once per (site, direction,
    structure-signature) and cached across sweeps — the plan-cache role of
    block2's ConnectionInfo (reference src/core/sparse_matrix.hpp:71).
  * Executors: numpy (gather -> batched einsum -> reduceat) for f64 host
    parity, and the native C++ executor (``native/sandwich.cpp``).

Sweeps revisit identical structures after the bond dimensions stabilize, so
plan construction amortizes exactly like the reference's ConnectionInfo.

Copied from block2_preview_tpu/ops/blocking_plan.py (the port keeps its own copy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .csr import w_nonzero as _w_nonzero

from ..core.blocks import BlockMatrix
from ..core.symmetry import QN
from .blocking import _round_vec, pair_join


class BlockingPlan:
    __slots__ = ("buckets", "out_meta", "out_offs", "total_out",
                 "env_order", "bra_order", "ket_order",
                 "env_sizes", "bra_sizes", "ket_sizes", "direction",
                 "dq_out", "native")


def structure_signature(env, entries_id, bra_T, ket_T) -> int:
    """Cheap hash of the block structure of one blocking step."""
    h = hash(entries_id)
    for sym in sorted(env):
        bm = env[sym]
        for k in sorted(bm.blocks):
            b = bm.blocks[k]
            h = hash((h, sym, k, b.shape))
    for T in (bra_T, ket_T):
        for k in sorted(T.blocks):
            h = hash((h, k, T.blocks[k].shape))
    return h


def build_plan(env: Dict[int, BlockMatrix], entries, quanta, bra_T, ket_T,
               bond_dqs_out, group, direction: str,
               chunk: int = 16384) -> Optional[BlockingPlan]:
    """Structure pass: identical joins/bucketing as
    blocking.contract_env_site, but emitting index arrays instead of numbers.
    """
    nphys = len(quanta)
    code_of: Dict[QN, int] = {}

    def code(q: QN) -> int:
        c = code_of.get(q)
        if c is None:
            c = len(code_of)
            code_of[q] = c
        return c

    # site tensor block registry (shapes only; numeric pools built at exec)
    bra_keys: List = []
    bra_shapes: List[Tuple[int, int]] = []
    bra_out: List[int] = []
    ket_keys: List = []
    ket_shapes: List[Tuple[int, int]] = []
    ket_out: List[int] = []
    bra_tab: Dict[Tuple[int, int], int] = {}
    ket_tab: Dict[Tuple[int, int], int] = {}
    for T, keys, shapes, outs, tab in (
            (bra_T, bra_keys, bra_shapes, bra_out, bra_tab),
            (ket_T, ket_keys, ket_shapes, ket_out, ket_tab)):
        for (ql, qp, qr), b in sorted(T.blocks.items()):
            # degenerate site quanta (trivial-symmetry qubits, big sites):
            # several basis states p share one MPS block; each gets its own
            # registry slice along the block's physical axis
            islice = 0
            for p, q in enumerate(quanta):
                if q != qp:
                    continue
                if direction == "left":
                    key = (code(ql), p)
                    out_code = code(qr)
                else:
                    key = (p, code(qr))
                    out_code = code(ql)
                tab[key] = len(keys)
                keys.append(((ql, qp, qr), islice))
                shapes.append((b.shape[0], b.shape[2]))
                outs.append(out_code)
                islice += 1
    bra_out = np.asarray(bra_out, dtype=np.int64)
    ket_out = np.asarray(ket_out, dtype=np.int64)

    env_order: List = []
    esym, eqb, eqk, eshapes = [], [], [], []
    for sym in sorted(env):
        for k in sorted(env[sym].blocks):
            mat = env[sym].blocks[k]
            env_order.append((sym, k))
            esym.append(sym)
            eqb.append(code(k[0]))
            eqk.append(code(k[1]))
            eshapes.append(mat.shape)
    if not env_order:
        return None
    esym = np.asarray(esym, dtype=np.int64)
    eqb = np.asarray(eqb, dtype=np.int64)
    eqk = np.asarray(eqk, dtype=np.int64)
    eshapes = np.asarray(eshapes, dtype=np.int64)

    wi, wo, wpb, wpk, wc = [], [], [], [], []
    for (i, o), w in sorted(entries.items()):
        for pb, pk in zip(*_w_nonzero(w)):
            wi.append(i)
            wo.append(o)
            wpb.append(int(pb))
            wpk.append(int(pk))
            wc.append(w[pb, pk])
    if not wi:
        return None
    wi = np.asarray(wi, dtype=np.int64)
    wo = np.asarray(wo, dtype=np.int64)
    wpb = np.asarray(wpb, dtype=np.int64)
    wpk = np.asarray(wpk, dtype=np.int64)
    wc = np.asarray(wc)

    ncodes = len(code_of)
    if direction == "left":
        btab = np.full((ncodes, nphys), -1, dtype=np.int64)
        ktab = np.full((ncodes, nphys), -1, dtype=np.int64)
    else:
        btab = np.full((nphys, ncodes), -1, dtype=np.int64)
        ktab = np.full((nphys, ncodes), -1, dtype=np.int64)
    for (a, b), v in bra_tab.items():
        btab[a, b] = v
    for (a, b), v in ket_tab.items():
        ktab[a, b] = v

    join_on = wi if direction == "left" else wo
    out_sym_arr = wo if direction == "left" else wi
    ie, iw = pair_join(esym, join_on)
    if len(ie) == 0:
        return None
    if direction == "left":
        bb = btab[eqb[ie], wpb[iw]]
        kk = ktab[eqk[ie], wpk[iw]]
    else:
        bb = btab[wpb[iw], eqb[ie]]
        kk = ktab[wpk[iw], eqk[ie]]
    valid = (bb >= 0) & (kk >= 0)
    ie, iw, bb, kk = ie[valid], iw[valid], bb[valid], kk[valid]
    if len(ie) == 0:
        return None
    osym = out_sym_arr[iw]
    oqb = bra_out[bb]
    oqk = ket_out[kk]
    coefs = wc[iw]

    bshape = np.asarray(bra_shapes, dtype=np.int64)
    kshape = np.asarray(ket_shapes, dtype=np.int64)
    if direction == "left":
        d_l = bshape[bb, 0]
        d_x = bshape[bb, 1]
        d_k = kshape[kk, 0]
        d_y = kshape[kk, 1]
    else:
        d_x = bshape[bb, 0]
        d_l = bshape[bb, 1]
        d_y = kshape[kk, 0]
        d_k = kshape[kk, 1]

    # output block registry
    okey = (osym * ncodes + oqb) * ncodes + oqk
    uniq, first, inv = np.unique(okey, return_index=True, return_inverse=True)
    inv = inv.ravel()
    out_d1 = (bshape[bb[first], 1] if direction == "left"
              else bshape[bb[first], 0])
    out_d2 = (kshape[kk[first], 1] if direction == "left"
              else kshape[kk[first], 0])
    out_sizes = out_d1 * out_d2
    out_offs = np.concatenate([[0], np.cumsum(out_sizes)])
    total_out = int(out_offs[-1])
    code_list = [None] * ncodes
    for q, c in code_of.items():
        code_list[c] = q

    # pools layout
    def sizes_offsets(shapes_arr):
        sz = shapes_arr[:, 0] * shapes_arr[:, 1]
        offs = np.concatenate([[0], np.cumsum(sz)])
        return offs

    eoffs = sizes_offsets(eshapes)
    boffs = sizes_offsets(bshape)
    koffs = sizes_offsets(kshape)
    sent_e = int(eoffs[-1])
    sent_b = int(boffs[-1])
    sent_k = int(koffs[-1])

    rl, rx, rk, ry = (_round_vec(d) for d in (d_l, d_x, d_k, d_y))
    bkey = (rl << 48) | (rx << 32) | (rk << 16) | ry
    order = np.argsort(bkey, kind="stable")
    boundsb = np.nonzero(np.diff(bkey[order]))[0] + 1
    starts = np.concatenate([[0], boundsb, [len(order)]])

    # native (C++/OpenMP) execution arrays: contributions grouped by output
    # block (conflict-free parallel partitioning)
    order2 = np.argsort(inv, kind="stable")
    inv_s = inv[order2]
    gb = np.nonzero(np.diff(inv_s))[0] + 1
    native = {
        "eoff": np.ascontiguousarray(eoffs[ie[order2]]),
        "boff": np.ascontiguousarray(boffs[bb[order2]]),
        "koff": np.ascontiguousarray(koffs[kk[order2]]),
        "dl": np.ascontiguousarray(d_l[order2].astype(np.int32)),
        "dx": np.ascontiguousarray(d_x[order2].astype(np.int32)),
        "dk": np.ascontiguousarray(d_k[order2].astype(np.int32)),
        "dy": np.ascontiguousarray(d_y[order2].astype(np.int32)),
        "coef_order": order2,
        "out_off": np.ascontiguousarray(out_offs[inv_s]),
        "grp_starts": np.ascontiguousarray(
            np.concatenate([[0], gb, [len(order2)]]).astype(np.int64)),
    }
    native["coefs"] = np.ascontiguousarray(coefs[order2])

    # compact per-bucket structure only (O(C) memory); gather index matrices
    # are rebuilt at execution time (free relative to the einsum volume)
    buckets = []
    for si in range(len(starts) - 1):
        sel_all = order[starts[si]:starts[si + 1]]
        for lo in range(0, len(sel_all), chunk):
            sel = sel_all[lo:lo + chunk]
            buckets.append({
                "shape": (len(sel), int(rl[sel[0]]), int(rx[sel[0]]),
                          int(rk[sel[0]]), int(ry[sel[0]])),
                "e": ie[sel].astype(np.int32),
                "b": bb[sel].astype(np.int32),
                "k": kk[sel].astype(np.int32),
                "oid": inv[sel].astype(np.int32),
                "dl": d_l[sel].astype(np.int32),
                "dx": d_x[sel].astype(np.int32),
                "dk": d_k[sel].astype(np.int32),
                "dy": d_y[sel].astype(np.int32),
                "coef": coefs[sel].copy(),
            })

    plan = BlockingPlan()
    plan.direction = direction
    plan.buckets = buckets
    plan.out_meta = [(int((uniq[u] // ncodes) // ncodes),
                      code_list[int((uniq[u] // ncodes) % ncodes)],
                      code_list[int(uniq[u] % ncodes)],
                      int(out_d1[u]), int(out_d2[u]))
                     for u in range(len(uniq))]
    plan.out_offs = out_offs
    plan.total_out = total_out
    plan.env_order = env_order
    plan.bra_order = bra_keys
    plan.ket_order = ket_keys
    plan.env_sizes = (eoffs, sent_e)
    plan.bra_sizes = (boffs, sent_b)
    plan.ket_sizes = (koffs, sent_k)
    plan.dq_out = bond_dqs_out
    plan.native = native
    return plan


def _pools(plan: BlockingPlan, env, bra_T, ket_T, dtype):
    conj_bra = True
    eoffs, sent_e = plan.env_sizes
    boffs, sent_b = plan.bra_sizes
    koffs, sent_k = plan.ket_sizes
    epool = np.zeros(sent_e + 1, dtype=dtype)
    for ii, (sym, k) in enumerate(plan.env_order):
        epool[eoffs[ii]:eoffs[ii + 1]] = env[sym].blocks[k].ravel()
    bpool = np.zeros(sent_b + 1, dtype=dtype)
    for ii, (k, isl) in enumerate(plan.bra_order):
        m = bra_T.blocks[k][:, isl, :]
        if np.iscomplexobj(m):
            m = m.conj()
        bpool[boffs[ii]:boffs[ii + 1]] = m.ravel()
    kpool = np.zeros(sent_k + 1, dtype=dtype)
    for ii, (k, isl) in enumerate(plan.ket_order):
        kpool[koffs[ii]:koffs[ii + 1]] = ket_T.blocks[k][:, isl, :].ravel()
    return epool, bpool, kpool


def _gather(pool, offs, idx_blocks, rows_true, cols_true, R, Cc, sent):
    r = np.arange(R)[None, :, None]
    c = np.arange(Cc)[None, None, :]
    rt = rows_true[:, None, None]
    ct = cols_true[:, None, None]
    g = offs[idx_blocks][:, None, None] + r * ct + c
    return pool[np.where((r < rt) & (c < ct), g, sent)]


def execute_plan_numpy(plan: BlockingPlan, env, bra_T, ket_T, group,
                       dtype=np.float64) -> Dict[int, BlockMatrix]:
    if plan.native is not None:
        dtype = np.result_type(dtype, plan.native["coefs"].dtype)
    epool, bpool, kpool = _pools(plan, env, bra_T, ket_T, dtype)
    eoffs, sent_e = plan.env_sizes
    boffs, sent_b = plan.bra_sizes
    koffs, sent_k = plan.ket_sizes
    flat = np.zeros(plan.total_out, dtype=dtype)
    for bk in plan.buckets:
        C, Lp, Xp, Kp, Yp = bk["shape"]
        if plan.direction == "left":
            MB = _gather(bpool, boffs, bk["b"], bk["dl"], bk["dx"],
                         Lp, Xp, sent_b)
            E = _gather(epool, eoffs, bk["e"], bk["dl"], bk["dk"],
                        Lp, Kp, sent_e)
            MK = _gather(kpool, koffs, bk["k"], bk["dk"], bk["dy"],
                         Kp, Yp, sent_k)
            res = np.einsum("clx,clk,cky->cxy", MB, E, MK, optimize=True)
        else:
            MB = _gather(bpool, boffs, bk["b"], bk["dx"], bk["dl"],
                         Xp, Lp, sent_b)
            E = _gather(epool, eoffs, bk["e"], bk["dl"], bk["dk"],
                        Lp, Kp, sent_e)
            MK = _gather(kpool, koffs, bk["k"], bk["dy"], bk["dk"],
                         Yp, Kp, sent_k)
            res = np.einsum("cxl,clk,cyk->cxy", MB, E, MK, optimize=True)
        res *= bk["coef"][:, None, None]
        # scatter-add true elements into the flat output buffer
        r = np.arange(Xp)[None, :, None]
        c = np.arange(Yp)[None, None, :]
        rt = bk["dx"][:, None, None]
        ct = bk["dy"][:, None, None]
        vmask = (r < rt) & (c < ct)
        tgt = plan.out_offs[bk["oid"]][:, None, None] + r * ct + c
        np.add.at(flat, tgt[vmask], res[vmask])
    out: Dict[int, BlockMatrix] = {}
    for u, (sym, qb, qk, d1, d2) in enumerate(plan.out_meta):
        bm = out.get(sym)
        if bm is None:
            bm = BlockMatrix(group, plan.dq_out[sym])
            out[sym] = bm
        bm.blocks[(qb, qk)] = flat[plan.out_offs[u]:
                                   plan.out_offs[u + 1]].reshape(d1, d2)
    return out


def execute_plan_native(plan: BlockingPlan, env, bra_T, ket_T, group,
                        dtype=np.float64
                        ) -> Optional[Dict[int, BlockMatrix]]:
    """C++/OpenMP execution of a blocking plan in float64 or complex128
    (``dtype``; the MPO coefficients must be real); returns None when the
    native library is unavailable or the coefficients are complex (caller
    falls back to numpy)."""
    import ctypes

    from ..native import get_lib
    lib = get_lib()
    if lib is None or plan.native is None or \
            np.iscomplexobj(plan.native["coefs"]):
        return None
    dtype = np.dtype(dtype)
    epool, bpool, kpool = _pools(plan, env, bra_T, ket_T, dtype)
    nat = plan.native
    n = len(nat["eoff"])
    flat = np.zeros(plan.total_out + 1, dtype=dtype)
    dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    coefs = np.ascontiguousarray(nat["coefs"], dtype=np.float64)
    fn = lib.sandwich_exec_z if dtype.kind == "c" else lib.sandwich_exec
    fn(
        0 if plan.direction == "left" else 1, n,
        epool.ctypes.data_as(dp), bpool.ctypes.data_as(dp),
        kpool.ctypes.data_as(dp),
        nat["eoff"].ctypes.data_as(i64), nat["boff"].ctypes.data_as(i64),
        nat["koff"].ctypes.data_as(i64),
        nat["dl"].ctypes.data_as(i32), nat["dx"].ctypes.data_as(i32),
        nat["dk"].ctypes.data_as(i32), nat["dy"].ctypes.data_as(i32),
        coefs.ctypes.data_as(dp),
        nat["out_off"].ctypes.data_as(i64),
        nat["grp_starts"].ctypes.data_as(i64),
        len(nat["grp_starts"]) - 1,
        flat.ctypes.data_as(dp))
    out: Dict[int, BlockMatrix] = {}
    for u, (sym, qb, qk, d1, d2) in enumerate(plan.out_meta):
        bm = out.get(sym)
        if bm is None:
            bm = BlockMatrix(group, plan.dq_out[sym])
            out[sym] = bm
        bm.blocks[(qb, qk)] = flat[plan.out_offs[u]:
                                   plan.out_offs[u + 1]].reshape(d1, d2)
    return out
