"""Chunk tables of the chain-matvec core shared by kernels K1, K20, K8, K7
and K18 (``csrc/chain_mv.cuh``), and the plain walk of those tables.

The sigma matvecs compute, for every item (one triple of the effective
Hamiltonian),

    sigma[ooff] (a x p) += L[loff] (a x k) @ psi[poff] (k x n) @ R[roff]^T

with L, psi, R and sigma row-major in flat pools at the item's offsets.
An item is eight int32 fields ``loff, a, k, poff, n, roff, p, ooff`` (K8's
own items, which K7 reads too, in any of four types; K1's are derived from
its MatvecV2 plan in :func:`block2_preview_tpu_torch.ops.tilev2.k1_items`).
K18's items have ten: two more, the row lengths of L and R in their pools
(``exec_bucket.plan_chain_tables``: blocks read in place from padded
stacks); the chunks are cut from the first eight.

The core cuts an item into *entries* (item, ar, pi, ni): rows [ar T,
ar T + T) of its output, columns [pi T, pi T + T) and the columns
[ni T, ni T + T) of psi (the stage-2 depth), T the core's tile
(:data:`TILE`, whatever the plan's own tile).
All entries that write the same output piece (ooff, ar, pi) form a
*segment*; a segment is cut into *chunks* of at most :data:`MAX_ENT`
entries: a chunk starts where the FLOPs ahead of an entry in its segment
cross a multiple of ``cap``, so the entries of a chunk before its last
one hold less than ``cap`` FLOPs.  One CUDA block runs one chunk: it sums
its entries' products in registers and adds the piece into sigma once
(one atomic an element a chunk).  Chunks are ordered by decreasing FLOPs,
so the longest start first.

Tables (int32): ``ent`` [n_ent, 2] = (item, ni), in segment order;
``ck`` [n_chunks, 4] = (first entry, end entry, ar, pi).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

# the core's tile: rows and columns of an output piece and columns of a psi
# slice (csrc/chain_mv.cuh kT), whatever the plan's own tile
TILE = 64
# entries of one chunk, staged in shared memory (csrc/chain_mv.cuh kMaxEnt)
MAX_ENT = 64
# chunks a plan is cut into at least, where its segments allow (the FLOP
# cap is the plan's FLOPs over this): about four waves of two blocks an SM
# on 132 SMs (1024 timed a few percent faster than 512, 2048 or 4096 on an
# H100 at a K=16 QC site, PERF.md §6)
TARGET_CHUNKS = 1024


# item columns
LOFF, A, K, POFF, N, ROFF, P, OOFF = range(8)


def _cdiv(a, b):
    return -(-a // b)


def entries(items: np.ndarray) -> Dict:
    """Every entry (item, ar, pi, ni) of ``items`` [n, 8], item-major,
    with its output rows ``lr``, psi columns ``nc``, output columns ``pc``
    and its FLOPs (stage 1 and 2; stage 1 is repeated for
    each pi of an item)."""
    T = TILE
    it = np.asarray(items, np.int64).reshape(-1, 8)
    a, k, n, p = it[:, A], it[:, K], it[:, N], it[:, P]
    nr, npp, nn = _cdiv(a, T), _cdiv(p, T), _cdiv(n, T)
    cnt = nr * npp * nn
    item = np.repeat(np.arange(len(it)), cnt)
    o = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pn = (npp * nn)[item]
    ar, rem = o // pn, o % pn
    pi, ni = rem // nn[item], rem % nn[item]
    lr = np.minimum(T, a[item] - ar * T)
    nc = np.minimum(T, n[item] - ni * T)
    pc = np.minimum(T, p[item] - pi * T)
    return {"item": item, "ar": ar, "pi": pi, "ni": ni, "lr": lr, "nc": nc,
            "pc": pc, "flops": 2 * lr * nc * (k[item] + pc)}


def chunk_tables(items: np.ndarray, cap: Optional[float] = None) -> Dict:
    """The chunk tables of ``items`` [n, 8] (int64 or int32):
    ``ent`` [n_ent, 2] and ``ck`` [n_chunks, 4] (int32, see the
    module docstring), ``flops`` (the entries' FLOPs, stage 1 counted once
    per pi) and ``seconds`` (the build time).  ``cap``: the FLOP band of a
    chunk (module docstring); default the plan's FLOPs over
    :data:`TARGET_CHUNKS`."""
    t0 = time.perf_counter()
    it = np.asarray(items, np.int64).reshape(-1, 8)
    e = entries(it)
    fl = e["flops"]
    n_ent = len(fl)
    if cap is None:
        cap = max(float(fl.sum()) / TARGET_CHUNKS, 1.0)
    # segments: the entries of one output piece (ooff, ar, pi), in item
    # order inside
    order = np.lexsort((e["pi"], e["ar"], it[e["item"], OOFF]))
    key = np.stack([it[e["item"], OOFF][order], e["ar"][order],
                    e["pi"][order]])
    idx = np.arange(n_ent)
    seg_new = np.ones(n_ent, bool)
    seg_new[1:] = (key[:, 1:] != key[:, :-1]).any(0)
    seg_start = np.maximum.accumulate(np.where(seg_new, idx, 0))
    fo = fl[order]
    cum = np.cumsum(fo)
    before = cum - fo - (cum - fo)[seg_start]   # FLOPs ahead in the segment
    band = (before // cap).astype(np.int64)
    band_new = seg_new.copy()
    band_new[1:] |= band[1:] != band[:-1]
    band_start = np.maximum.accumulate(np.where(band_new, idx, 0))
    new = band_new | ((idx - band_start) % MAX_ENT == 0)
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], n_ent)[:len(starts)]
    ck = np.stack([starts, ends, e["ar"][order][starts],
                   e["pi"][order][starts]], 1)
    cfl = np.add.reduceat(fo, starts) if n_ent else np.zeros(0, np.int64)
    ck = ck[np.argsort(-cfl, kind="stable")]
    ent = np.stack([e["item"][order], e["ni"][order]], 1)
    return {"ent": ent.astype(np.int32).reshape(-1, 2),
            "ck": ck.astype(np.int32).reshape(-1, 4),
            "flops": int(fl.sum()), "seconds": time.perf_counter() - t0}


def device_tables(items: np.ndarray, tables: Dict, device) -> Dict:
    """The tables the core reads, on ``device``: ``items`` [n, 8] (or
    [n, 10], the strided instance's), ``ent``, ``ck`` (int32) and
    ``n_chunks``."""
    return {"items": torch.as_tensor(np.ascontiguousarray(items,
                                                          np.int32),
                                     device=device),
            "ent": torch.as_tensor(tables["ent"], device=device),
            "ck": torch.as_tensor(tables["ck"], device=device),
            "n_chunks": int(tables["ck"].shape[0])}


def chain_plain(xp, lpool, rpool, d: Dict, n_out: int):
    """Plain walk of the chunk tables ``d`` (:func:`device_tables`): chunk
    by chunk, the sum of its entries' L @ psi @ R^T pieces added into a
    flat sigma [n_out] at the chunk's output piece — what the core
    computes, in the core's order of chunks and entries (not of the sums
    inside a product).  For the tests and the chip's checks of the tables;
    the wrappers' plain versions are the kernels' twins.  Ten-field items
    (K18's) read L and R at their own row lengths."""
    out = xp.new_zeros(n_out)
    items = d["items"].cpu().numpy().astype(np.int64)
    ent = d["ent"].cpu().numpy().astype(np.int64)
    T = TILE
    for e0, e1, ar, pi in d["ck"].cpu().numpy().astype(np.int64):
        f0 = items[ent[e0, 0]]
        a, p, ooff = f0[A], f0[P], f0[OOFF]
        r0, c0 = ar * T, pi * T
        lr, pc = min(T, a - r0), min(T, p - c0)
        acc = None
        for item, ni in ent[e0:e1]:
            f = items[item]
            k, n = f[K], f[N]
            ldl, ldr = (f[8], f[9]) if len(f) > 8 else (k, n)
            n0 = ni * T
            nc = min(T, n - n0)
            L = lpool[f[LOFF] + r0 * ldl:f[LOFF] + (r0 + lr) * ldl].view(
                lr, ldl)[:, :k]
            ps = xp[f[POFF]:f[POFF] + k * n].view(k, n)[:, n0:n0 + nc]
            R = rpool[f[ROFF] + c0 * ldr:f[ROFF] + (c0 + pc) * ldr].view(
                pc, ldr)[:, n0:n0 + nc]
            y = (L @ ps) @ R.T
            acc = y if acc is None else acc + y
        dst = (ooff + (r0 + torch.arange(lr, device=xp.device)[:, None]) * p
               + c0 + torch.arange(pc, device=xp.device)[None, :])
        out.index_add_(0, dst.reshape(-1), acc.reshape(-1))
    return out
