"""Environment blocking plans on the device — kernel K9.

Counterpart of block2_preview_tpu/ops/blocking_jax.py (``execute_plan_jax``
:213-263, ``_blk_exec`` :87), the blocking of the reference's
``jax_device`` backend: one ``BlockingPlan`` of ``ops/blocking_plan.py``
(the same plan the host executors run) goes to the device as three flat
pools (env, bra, ket; ``blocking_plan._pools``) and per-contribution
scalars, runs through K9, and comes back as the same
``Dict[int, BlockMatrix]`` the host executors return.

Not carried: the reference's power-of-four sticky pool capacities, its
power-of-two shape classes with a floor of 8, its 1024-contribution chunks
and its parallel compile warm-up (blocking_jax.py:43-84, 198-210).  They
bound XLA's compiles; one K9 launch takes the whole plan at true dims.

K9 reads the plan's contributions (offsets and true dims, grouped by
output block) through host tables built once per plan and cached with it
(:func:`k9_tables`, ``plan.native["k9"]``): inside each output block the
contributions that share their bra and ket blocks form a sub-group, whose
coefficient-weighted env blocks the kernel sums before it multiplies the
chain once; every output block is cut into pieces of at most
:data:`PIECE` x :data:`PIECE` elements and the sub-groups of a piece into
FLOP-capped chunks, one warp a chunk.  The tables go up with the pools on
every call (an int and a coefficient a contribution, six ints a
sub-group, eight a chunk).  Real types only: complex coefficients or
complex blocks raise (the reference returns None there and the host runs
the plan, blocking_jax.py:215-224; its ``.real`` cast of the
coefficients, :185, is not copied).

:func:`bucket_blocking` is K9's wrapper; on CPU tensors it runs
:func:`bucket_blocking_plain`, the reference's gather / einsum / masked
scatter-add per shape class.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.blocks import BlockMatrix
from . import _kernels
from .blocking_plan import BlockingPlan, _pools
from .exec_bucket import _PLAIN_CHUNK, _grid, _int32

# item columns
_EOFF, _BOFF, _KOFF, _DL, _DX, _DK, _DY, _OOFF = range(8)
# rows and columns of an output piece, one warp's share of an output block
# (csrc/bucket_blocking.cu kP)
PIECE = 32
# chunks a plan is cut into at least, where its output blocks allow (the
# FLOP cap is the plan's FLOPs over this): some four waves of the card's
# resident warps
TARGET_CHUNKS = 8192


def _pow2(d: np.ndarray) -> np.ndarray:
    d = np.maximum(np.asarray(d, dtype=np.int64), 1)
    return np.int64(1) << np.ceil(np.log2(d)).astype(np.int64)


def plan_items(plan: BlockingPlan) -> np.ndarray:
    """The plan's contributions as int64 items [C, 8] (native order)."""
    nat = plan.native
    return np.stack([nat["eoff"], nat["boff"], nat["koff"], nat["dl"],
                     nat["dx"], nat["dk"], nat["dy"], nat["out_off"]],
                    axis=1).astype(np.int64)


def class_tables(it: np.ndarray, coef, device, tdt) -> Dict:
    """The tables :func:`bucket_blocking_plain` reads, on ``device``: the
    items ``it`` [C, 8] (int64), their coefficients, and the item indices
    of each power-of-two shape class (Lp, Xp, Kp, Yp)."""
    cls = np.stack([_pow2(it[:, c]) for c in (_DL, _DX, _DK, _DY)], axis=1)
    keys, inv = np.unique(cls, axis=0, return_inverse=True)
    inv = inv.ravel()
    return {"items": torch.as_tensor(it, device=device),
            "coef": torch.as_tensor(coef, dtype=tdt, device=device),
            "classes": [(tuple(int(v) for v in key),
                         torch.as_tensor(np.flatnonzero(inv == i),
                                         device=device))
                        for i, key in enumerate(keys)]}


def plain_tables(plan: BlockingPlan, device, tdt) -> Dict:
    """:func:`class_tables` of the plan's contributions."""
    return class_tables(plan_items(plan), plan.native["coefs"], device, tdt)


def _cdiv(a, b):
    return -(-a // b)


def _block_index(offs, at):
    """(the index of the block that starts at each offset ``at``, the
    number of blocks) of a pool whose blocks start at ``offs[:-1]``."""
    lut = np.zeros(int(offs[-1]) + 1, np.int32)
    lut[np.asarray(offs[:-1], np.int64)] = np.arange(len(offs) - 1)
    return lut[at].astype(np.int64), len(offs) - 1


def k9_order(plan: BlockingPlan) -> np.ndarray:
    """K9's order of the plan's contributions, as their native indices:
    the plan's output groups (``grp_starts``) in turn, inside each by
    (bra block, ket block), the blocks numbered through a table over the
    site tensor's pool (a gather, not a search); a stable sort."""
    nat = plan.native
    gs = np.asarray(nat["grp_starts"], np.int64)
    grp = np.repeat(np.arange(len(gs) - 1), np.diff(gs))
    bi, nb = _block_index(plan.bra_sizes[0], np.asarray(nat["boff"]))
    ki, nk = _block_index(plan.ket_sizes[0], np.asarray(nat["koff"]))
    return np.argsort((grp * nb + bi) * nk + ki, kind="stable")


def k9_tables(plan: BlockingPlan) -> Dict:
    """K9's host tables of ``plan``, built once and cached in
    ``plan.native["k9"]`` (numpy arrays; the plan's structure fixes them).

    The contributions go in :func:`k9_order`; a run of one (output block,
    boff, koff) is a *sub-group* — the same bra and ket blocks, so one
    shape.  Each output block is cut into pieces of at most PIECE x PIECE;
    the sub-groups of one piece (a *segment*) are cut into chunks where the
    FLOPs ahead of a sub-group in its segment cross a multiple of ``cap``
    (the plan's FLOPs over TARGET_CHUNKS).  Returns ``ce`` [C] (int32 env
    offsets) and ``cc`` [C] (coefficients) in that order, ``sg``
    [n_sg, 6] = (first contribution, end, boff, koff, dl, dk), ``ck``
    [n_chunks, 8] = (first sub-group, end, ooff, dx, dy, x0, y0, atomic)
    (int32, chunks by decreasing FLOPs; atomic where a piece spans
    chunks), ``flops`` (the grouped form: 2 (dl dk dy + dx dl dy) a
    sub-group + 2 dl dk a contribution), ``n_groups`` and ``seconds``.
    The order itself is not kept: 12 bytes a contribution stay with the
    plan."""
    nat = plan.native
    tab = nat.get("k9")
    if tab is not None:
        return tab
    t0 = time.perf_counter()
    gs = np.asarray(nat["grp_starts"], np.int64)
    n_grp = len(gs) - 1
    n = int(gs[-1])
    order = k9_order(plan)
    grp = np.repeat(np.arange(n_grp), np.diff(gs))[order]
    boff = np.asarray(nat["boff"], np.int64)[order]
    koff = np.asarray(nat["koff"], np.int64)[order]
    new = np.ones(n, bool)
    new[1:] = ((grp[1:] != grp[:-1]) | (boff[1:] != boff[:-1])
               | (koff[1:] != koff[:-1]))
    s_beg = np.flatnonzero(new)
    s_end = np.append(s_beg[1:], n)
    lead = order[s_beg]          # a contribution of each sub-group
    dl = np.asarray(nat["dl"], np.int64)[lead]
    dk = np.asarray(nat["dk"], np.int64)[lead]
    n_c = s_end - s_beg
    sg = np.stack([s_beg, s_end, boff[s_beg], koff[s_beg], dl, dk], 1)
    # sub-groups of each group, and each group's output block
    g_lead = grp[s_beg]
    g_sg = np.concatenate([[0], np.cumsum(np.bincount(g_lead,
                                                      minlength=n_grp))])
    first = gs[:-1]
    dx = np.asarray(nat["dx"], np.int64)[first]
    dy = np.asarray(nat["dy"], np.int64)[first]
    ooff = np.asarray(nat["out_off"], np.int64)[first]
    # segments: (group, piece), pieces row-major in each output block
    npy = _cdiv(dy, PIECE)
    n_pc = _cdiv(dx, PIECE) * npy
    seg_g = np.repeat(np.arange(n_grp), n_pc)
    seg_p = np.arange(len(seg_g)) - np.repeat(np.cumsum(n_pc) - n_pc, n_pc)
    x0 = seg_p // npy[seg_g] * PIECE
    y0 = seg_p % npy[seg_g] * PIECE
    px = np.minimum(PIECE, dx[seg_g] - x0)
    py = np.minimum(PIECE, dy[seg_g] - y0)
    # entries: (segment, sub-group), sub-groups in order inside a segment
    cnt = np.diff(g_sg)[seg_g]
    seg_first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    e_seg = np.repeat(np.arange(len(seg_g)), cnt)
    e_sg = g_sg[seg_g][e_seg] + np.arange(len(e_seg)) - seg_first
    fl = 2 * dl[e_sg] * (dk[e_sg] * (n_c[e_sg] + py[e_seg])
                         + px[e_seg] * py[e_seg])
    cap = max(float(fl.sum()) / TARGET_CHUNKS, 1.0)
    cum = np.cumsum(fl)
    before = cum - fl - (cum - fl)[seg_first]   # FLOPs ahead in the segment
    band = (before // cap).astype(np.int64)
    cut = np.ones(len(e_seg), bool)
    cut[1:] = (e_seg[1:] != e_seg[:-1]) | (band[1:] != band[:-1])
    starts = np.flatnonzero(cut)
    ends = np.append(starts[1:], len(e_seg))
    cs = e_seg[starts]
    many = np.bincount(cs, minlength=len(seg_g)) > 1
    ck = np.stack([e_sg[starts], e_sg[ends - 1] + 1, ooff[seg_g[cs]],
                   dx[seg_g[cs]], dy[seg_g[cs]], x0[cs], y0[cs],
                   many[cs]], 1).reshape(-1, 8)
    cfl = np.add.reduceat(fl, starts) if len(starts) else fl[:0]
    ck = ck[np.argsort(-cfl, kind="stable")]
    dxs, dys = dx[g_lead], dy[g_lead]
    tab = {"ce": _int32(np.asarray(nat["eoff"], np.int64)[order],
                        "a K9 env offset"),
           "cc": np.asarray(nat["coefs"])[order],
           "sg": _int32(sg, "a K9 pool offset"),
           "ck": _int32(ck, "a K9 output offset"),
           "flops": int((2 * (dl * dk * dys + dxs * dl * dys)).sum()
                        + (2 * n_c * dl * dk).sum()),
           "n_groups": n_grp, "seconds": time.perf_counter() - t0}
    nat["k9"] = tab
    return tab


def kernel_tables(plan: BlockingPlan, device, tdt) -> Dict:
    """The tables K9 reads, on ``device``: :func:`k9_tables`'s ``ce``,
    ``cc`` (as ``tdt``), ``sg``, ``ck`` and ``n_chunks``."""
    tab = k9_tables(plan)
    d = {k: torch.as_tensor(tab[k], device=device)
         for k in ("ce", "sg", "ck")}
    d["cc"] = torch.as_tensor(tab["cc"], dtype=tdt, device=device)
    d["n_chunks"] = int(tab["ck"].shape[0])
    return d


def bucket_blocking_plain(ep, bp, kp, d: Dict, left: bool, out):
    """Plain PyTorch version of K9 (the reference's ``_blk_exec`` per shape
    class): padded gathers of MB, E, MK from the flat pools (padding reads
    each pool's trailing zero), one einsum, the coefficients, and a
    scatter-add of the true elements into ``out`` [total_out + 1] (padding
    lands in its last slot, cleared at the end).  Returns ``out``."""
    se, sb, sk = ep.shape[0] - 1, bp.shape[0] - 1, kp.shape[0] - 1
    drop = out.shape[0] - 1
    for (Lp, Xp, Kp, Yp), sel in d["classes"]:
        step = max(1, _PLAIN_CHUNK // max(Lp * Xp, Lp * Kp, Kp * Yp,
                                          Xp * Yp))
        for s in range(0, len(sel), step):
            idx = sel[s:s + step]
            f = d["items"][idx][:, :, None, None]
            dl, dx, dk, dy = f[:, _DL], f[:, _DX], f[:, _DK], f[:, _DY]
            E = ep[_grid(f[:, _EOFF], dl, dk, Lp, Kp, se)]
            if left:
                MB = bp[_grid(f[:, _BOFF], dl, dx, Lp, Xp, sb)]
                MK = kp[_grid(f[:, _KOFF], dk, dy, Kp, Yp, sk)]
                res = torch.einsum("clx,clk,cky->cxy", MB, E, MK)
            else:
                MB = bp[_grid(f[:, _BOFF], dx, dl, Xp, Lp, sb)]
                MK = kp[_grid(f[:, _KOFF], dy, dk, Yp, Kp, sk)]
                res = torch.einsum("cxl,clk,cyk->cxy", MB, E, MK)
            res = res * d["coef"][idx][:, None, None]
            out.index_add_(0, _grid(f[:, _OOFF], dx, dy, Xp, Yp,
                                    drop).reshape(-1), res.reshape(-1))
    out[drop] = 0
    return out


def bucket_blocking(ep, bp, kp, d: Dict, left: bool, out):
    """One blocking plan (kernel K9): adds every contribution into the flat
    output ``out`` [total_out + 1] on the device of ``ep``, from the flat
    env/bra/ket pools (each with a trailing zero); ``d`` holds
    :func:`kernel_tables` there.  CPU tensors run
    :func:`bucket_blocking_plain` (``d`` from :func:`plain_tables`).
    Returns ``out``."""
    if any(t.dim() != 1 for t in (ep, bp, kp, out)):
        raise ValueError("bucket_blocking takes flat pools and output")
    if ep.device.type == "cpu":
        return bucket_blocking_plain(ep, bp, kp, d, left, out)
    if not ep.is_cuda:
        raise ValueError(f"unsupported device {ep.device}")
    _kernels.launch("K9_bucket_blocking", "b2t_bucket_blk", ep.dtype, ep, bp,
                    kp, d["ce"], d["cc"], d["sg"], d["ck"], d["n_chunks"],
                    int(left), out)
    return out


def _check_real(plan: BlockingPlan, env, bra_T, ket_T, dtype) -> None:
    complex_blocks = any(
        np.iscomplexobj(b) for blocks in
        ([b for bm in env.values() for b in bm.blocks.values()],
         bra_T.blocks.values(), ket_T.blocks.values()) for b in blocks)
    if np.dtype(dtype).kind != "f" or complex_blocks or \
            np.iscomplexobj(plan.native["coefs"]):
        raise TypeError("device blocking is real only (a complex plan, "
                        "block or dtype); backend='torch_tiled' keeps "
                        "complex environments on the host")


def execute_plan_device(plan: BlockingPlan, env, bra_T, ket_T, group,
                        dtype=np.float64, device="cuda",
                        transfers: Optional[Dict] = None
                        ) -> Dict[int, BlockMatrix]:
    """Run a blocking plan through K9 on ``device``; returns the same map
    {mpo bond symbol -> BlockMatrix} as ``execute_plan_numpy``.  The three
    pools and the item tables go up, the flat output comes down;
    ``transfers`` (when given) counts them: ``uploads``/``downloads`` and
    their ``bytes_up``/``bytes_down``."""
    from ..runtime import resolve_device, torch_dtype
    _check_real(plan, env, bra_T, ket_T, dtype)
    dev = resolve_device(device)
    tdt = torch_dtype(dtype)
    d = (plain_tables if dev.type == "cpu" else kernel_tables)(plan, dev,
                                                                tdt)
    pools = [torch.as_tensor(p, device=dev)
             for p in _pools(plan, env, bra_T, ket_T, np.dtype(dtype))]
    out = torch.zeros(plan.total_out + 1, dtype=tdt, device=dev)
    bucket_blocking(*pools, d, plan.direction == "left", out)
    host = out[:plan.total_out].cpu().numpy()
    if transfers is not None:
        up = pools + [v for v in d.values() if isinstance(v, torch.Tensor)]
        transfers["uploads"] += len(up)
        transfers["bytes_up"] += sum(t.numel() * t.element_size()
                                     for t in up)
        transfers["downloads"] += 1
        transfers["bytes_down"] += host.nbytes
    res: Dict[int, BlockMatrix] = {}
    for u, (sym, qb, qk, d1, d2) in enumerate(plan.out_meta):
        bm = res.get(sym)
        if bm is None:
            bm = BlockMatrix(group, plan.dq_out[sym])
            res[sym] = bm
        bm.blocks[(qb, qk)] = host[plan.out_offs[u]:
                                   plan.out_offs[u + 1]].reshape(d1, d2)
    return res
