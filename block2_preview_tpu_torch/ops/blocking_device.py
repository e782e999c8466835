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

The contributions are the plan's native arrays (offsets and true dims,
grouped by output block), as int32 [C, 8] items — eoff, boff, koff, dl,
dx, dk, dy, ooff — with their coefficients, derived and uploaded with the
pools on every call (a few ints per contribution).  Real types only: complex
coefficients or complex blocks raise (the reference returns None there
and the host runs the plan, blocking_jax.py:215-224; its ``.real`` cast of
the coefficients, :185, is not copied).

:func:`bucket_blocking` is K9's wrapper; on CPU tensors it runs
:func:`bucket_blocking_plain`, the reference's gather / einsum / masked
scatter-add per shape class.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.blocks import BlockMatrix
from . import _kernels
from .blocking_plan import BlockingPlan, _pools
from .exec_bucket import _PLAIN_CHUNK, _grid, _int32, chain_blocks

# item columns
_EOFF, _BOFF, _KOFF, _DL, _DX, _DK, _DY, _OOFF = range(8)


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


def kernel_tables(plan: BlockingPlan, device, tdt) -> Dict:
    """The tables K9 reads, on ``device``: the items as int32 [C, 8], the
    coefficients and the prefix sums ``cum`` [C + 1] of the items' CUDA
    blocks."""
    it = plan_items(plan)
    cum = np.concatenate([[0], np.cumsum(chain_blocks(it[:, _DX],
                                                      it[:, _DY]))])
    return {"it": torch.as_tensor(_int32(it, "a K9 pool offset"),
                                  device=device),
            "coef": torch.as_tensor(plan.native["coefs"], dtype=tdt,
                                    device=device),
            "cum": torch.as_tensor(_int32(cum, "K9's block count"),
                                   device=device),
            "n_items": len(it), "n_blocks": int(cum[-1])}


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
                    kp, d["it"], d["coef"], d["cum"], d["n_items"],
                    d["n_blocks"], int(left), out)
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
