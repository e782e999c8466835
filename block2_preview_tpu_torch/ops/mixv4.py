"""LW/RW assembly, mix v4 form — kernels K3 (mix GEMM) and K4 (place).

Host side, copied from block2_preview_tpu/ops/mixv4.py:136-425 (the
plan: ``emit_gemm_items``, ``MixPlanV4``, ``plan_v4``) so the item and
window tables are byte-identical to the reference's.  The reference's
single packed int32 upload (a remedy for a slow host link) is not
carried: the port uploads the tables once a plan and device, cached in
the plan's ``_dev`` with K3's host tables (:func:`k3_host_tables`).

Device side, :func:`execute_mix_v4` runs

  K3 (``csrc/mix.cu``, replaces ``_mix4_scan``):
      OUT[w, d] = sum_j W[w, j] * E[j, d] per GEMM block, one CUDA block
      a 64 x 64 OUT tile, each element stored once (no atomics);
  K4 (``csrc/place.cu``, replaces ``_place4_exec_packed``):
      slab[dst + r*rs + c*cs] = OUT[src + r*sst + c] per window (the
      windows are disjoint), every other slab element 0;

and returns the LW/RW slab pool [ncap_out + 1] with the zero sentinel
last.  OUT is not zero-filled: K3 writes all of it that K4 reads, the
ranges that no GEMM block covers as zeros.  On CPU tensors the wrappers
run the plain PyTorch twins; on CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from . import _kernels
from .stacked import _cap_class, _pow2
from .tilev2 import _locate, gather_tiles

_T4 = 128          # GEMM layout tile
_B4 = 512          # stage-1 tasks per group (plan budget)
_NTP4 = 512        # prod tiles per group (plan budget)
_TP = 16           # place copy tile
_BP = 8192         # place tasks per group (plan field png)

# items of the plain versions per chunk (bounds their temporaries)
_TWIN_PROD_TILES = 256
_TWIN_PLACE_TASKS = 8192


# sub-block chunking (tiles per axis): bounds per-item stage-1 tasks to
# _WCH*_JCH*_DCH <= _B4 and prod tiles to _WCH*_DCH <= _NTP4
_WCH = 4
_JCH = 8
_DCH4 = 8


def emit_gemm_items(specs):
    """Split GEMM blocks into bounded sub-items + grouped task tables.

    specs: iterable of (wbase, wstride, nw, ns, ebase, estride, obase,
    ostride, width) — one OUT[w 0:nw, d 0:width] += W[w, j 0:ns]
    E[j, d] block with W at wbase (row stride wstride), E rows at
    ebase (row stride estride), OUT rows at obase (row stride
    ostride).  Returns dict(it, cum1, cum2, g1, g2, e1, e2, ng_live)
    ready for _mix4_exec."""
    T = _T4
    rows = []
    for (wb, wstr, nw, ns, eb, estr, ob, ostr, width) in specs:
        nwT = -(-nw // T)
        njT = -(-ns // T)
        ndT = -(-width // T)
        for w0 in range(0, nwT, _WCH):
            nw_l = min(nw - w0 * T, _WCH * T)
            for j0 in range(0, njT, _JCH):
                ns_l = min(ns - j0 * T, _JCH * T)
                for d0 in range(0, ndT, _DCH4):
                    wd_l = min(width - d0 * T, _DCH4 * T)
                    rows.append((wb + w0 * T * wstr + j0 * T, wstr,
                                 nw_l,
                                 eb + j0 * T * estr + d0 * T, estr,
                                 ob + w0 * T * ostr + d0 * T, ostr,
                                 -(-ns_l // T), -(-wd_l // T),
                                 0, wd_l, ns_l))
    if not rows:
        return None
    it8 = np.asarray(rows, dtype=np.int64)
    n = len(it8)
    nwT = -(-it8[:, 2] // T)
    njT = it8[:, 7]
    ndT = it8[:, 8]
    n1 = nwT * ndT * njT
    n2 = nwT * ndT
    B, ntp = _B4, _NTP4
    assert int(n1.max()) <= B and int(n2.max()) <= ntp
    c1 = np.concatenate([[0], np.cumsum(n1)]).astype(np.int64)
    c2 = np.concatenate([[0], np.cumsum(n2)]).astype(np.int64)
    starts = []
    i0 = 0
    while i0 < n:
        starts.append(i0)
        e = min(int(np.searchsorted(c1, c1[i0] + B, "right")) - 1,
                int(np.searchsorted(c2, c2[i0] + ntp, "right")) - 1)
        i0 = max(e, i0 + 1)
    starts_a = np.asarray(starts, np.int64)
    gs_item = np.repeat(starts_a, np.diff(
        np.concatenate([starts_a, [n]])))
    it8[:, 9] = c2[:-1] - c2[gs_item]

    n_q = _pow2(n)
    it = np.zeros((n_q, 12), np.int32)
    it[:n] = it8
    it[n:, 7:9] = 1
    it[n:, 11] = 1
    c1 = np.concatenate([c1, np.full(n_q - n, c1[-1], c1.dtype)])
    c2 = np.concatenate([c2, np.full(n_q - n, c2[-1], c2.dtype)])
    g1 = c1[starts_a]
    g2 = c2[starts_a]
    e1 = np.concatenate([g1[1:], c1[-1:]])
    e2 = np.concatenate([g2[1:], c2[-1:]])
    ngl = len(starts_a)
    gcap = max(64, _pow2(ngl))
    pad = np.full(gcap - ngl, c1[-1])
    pad2 = np.full(gcap - ngl, c2[-1])
    return {"it": it, "cum1": c1.astype(np.int32),
            "cum2": c2.astype(np.int32),
            "g1": np.concatenate([g1, pad]).astype(np.int32),
            "g2": np.concatenate([g2, pad2]).astype(np.int32),
            "e1": np.concatenate([e1, pad]).astype(np.int32),
            "e2": np.concatenate([e2, pad2]).astype(np.int32),
            "ng_live": ngl}


class MixPlanV4:
    """Execution form derived from a MixPlanV3 (same meta_out / place
    tables; see build_mix_plan_v3): the reference's fields, and ``_dev``,
    the port's cache of K3's host tables (under "k3") and of the device
    tables (under (device, dtype))."""

    __slots__ = ("meta_out", "ncap_out", "out_total", "iscpx",
                 "dims_hint", "n_launch",
                 "it", "cum1", "cum2", "g1", "g2", "e1", "e2",
                 "ng_live", "wdense", "pit", "pcum", "png", "_dev")


def plan_v4(p3) -> Optional["MixPlanV4"]:
    """Convert a MixPlanV3 into the v4 packed/tiled execution form."""
    if p3 is None:
        return None
    T = _T4
    specs = []   # (wbase, wstride, nw, ns, ebase, estride, obase,
    #               ostride, width)
    woff = 0
    wslices = []
    for spec in p3.gemms:
        nw, ns = spec["nw"], spec["ns"]
        goff, dg_p = spec["goff"], spec["dg_p"]
        wslices.append((woff, nw, ns, spec["wr"], spec["wc"],
                        spec["wv"]))
        eoff = spec["eoff"]
        dbdk = spec["dbdk"]
        secoff = spec["secoff"]
        for s_i in range(spec["nsec"]):
            specs.append((woff, ns, nw, ns, int(eoff[s_i]),
                          int(dbdk[s_i]),
                          goff + int(secoff[s_i]), dg_p,
                          int(dbdk[s_i])))
        woff += nw * ns
    g = emit_gemm_items(specs)
    if g is None:
        return None

    p = MixPlanV4()
    p.meta_out = p3.meta_out
    p.ncap_out = p3.ncap_out
    p.out_total = p3.out_total
    p.iscpx = p3.iscpx
    p.dims_hint = p3.dims_hint
    p.n_launch = 1
    p.ng_live = g["ng_live"]
    p.it = g["it"]
    p.cum1 = g["cum1"]
    p.cum2 = g["cum2"]
    p.g1 = g["g1"]
    p.g2 = g["g2"]
    p.e1 = g["e1"]
    p.e2 = g["e2"]

    # place window tile tasks
    wf = p3.winflat
    nwin = len(wf["src"])
    if nwin == 0:
        return None
    Tp = _TP
    nbT = -(-wf["nb"] // Tp)
    nkT = -(-wf["nk"] // Tp)
    ptasks = nbT * nkT
    pcum = np.concatenate([[0], np.cumsum(ptasks)]).astype(np.int64)
    nwin_q = _pow2(nwin)
    pit = np.zeros((nwin_q, 8), np.int32)
    pit[:nwin, 0] = wf["src"]
    pit[:nwin, 1] = wf["sst"]
    pit[:nwin, 2] = wf["dst"]
    pit[:nwin, 3] = wf["rs"]
    pit[:nwin, 4] = wf["cs"]
    pit[:nwin, 5] = wf["nb"]
    pit[:nwin, 6] = wf["nk"]
    pit[:nwin, 7] = nkT
    pit[nwin:, 7] = 1
    pcum = np.concatenate(
        [pcum, np.full(nwin_q - nwin, pcum[-1], pcum.dtype)])
    p.pit = pit
    p.pcum = pcum.astype(np.int32)
    p.png = int(-(-int(pcum[-1]) // _BP))

    # dense W pool (complex stays complex; real densified at upload)
    wdense = np.zeros(_pow2(woff + 1),
                      np.complex128 if p3.iscpx else np.float64)
    for (wo, nw, ns, wr, wc, wv) in wslices:
        wd = np.zeros((nw, ns), wdense.dtype)
        np.add.at(wd, (wr, wc), wv)
        wdense[wo:wo + nw * ns] = wd.ravel()
    p.wdense = wdense
    p._dev = {}

    return p


# ---------------------------------------------------------------------------
# kernel K3 (mix GEMM) and its plain twin
# ---------------------------------------------------------------------------

def mix_twin(epool, wpool, d: Dict, out):
    """Plain PyTorch version of K3 (same signature as :func:`mix_exec`):
    stage 1 forms prod tiles (item, wi, di) = sum_ji W tile @ E tile with
    global prod ids cum2[item] + wi*ndT + di; stage 2 adds them into OUT
    at affine positions.  Items are processed in chunks of whole items."""
    T = _T4
    it = d["it"].long()
    cum1, cum2 = d["cum1"].long(), d["cum2"].long()
    c2h = d["cum2"].cpu().numpy().astype(np.int64)
    n = len(c2h) - 1
    r = torch.arange(T, device=out.device)[None, :, None]
    c = torch.arange(T, device=out.device)[None, None, :]
    i0 = 0
    while i0 < n and c2h[i0] < c2h[-1]:
        i1 = int(np.searchsorted(c2h, c2h[i0] + _TWIN_PROD_TILES, "right"))
        i1 = min(max(i1 - 1, i0 + 1), n)
        p0, p1 = int(c2h[i0]), int(c2h[i1])
        prod = torch.zeros((p1 - p0, T, T), dtype=out.dtype,
                           device=out.device)
        item, o = _locate(cum1, int(cum1[i0]), int(cum1[i1]))
        f = it[item]
        njT, ndT = f[:, 7], f[:, 8]
        wi = o // (ndT * njT)
        rem = o % (ndT * njT)
        di = rem // njT
        ji = rem % njT
        Wt = gather_tiles(wpool, f[:, 0] + wi * T * f[:, 1] + ji * T,
                          f[:, 1], f[:, 2] - wi * T, f[:, 11] - ji * T, T)
        Et = gather_tiles(epool, f[:, 3] + ji * T * f[:, 4] + di * T,
                          f[:, 4], f[:, 11] - ji * T, f[:, 10] - di * T, T)
        prod.index_add_(0, cum2[item] + wi * ndT + di - p0,
                        torch.bmm(Wt, Et))
        item, o = _locate(cum2, p0, p1)
        f = it[item]
        ndT = f[:, 8]
        wi = (o // ndT)[:, None, None]
        di = (o % ndT)[:, None, None]
        f = f[:, :, None, None]
        idx = f[:, 5] + (wi * T + r) * f[:, 6] + di * T + c
        ok = (r < f[:, 2] - wi * T) & (c < f[:, 10] - di * T)
        out.index_add_(0, idx[ok], prod[ok])
        i0 = i1
    return out


# K3's OUT tile (csrc/mix.cu kMT), the depth of one mask bit (kKS) and
# the elements of one zero tile
K3_TILE = 64
K3_SLICE = 16
K3_ZERO = 1 << 14


def _segments(n):
    """(owner, position) of every element of consecutive segments of
    lengths ``n``: the segment each belongs to and its place in it."""
    own = np.repeat(np.arange(len(n)), n)
    return own, np.arange(len(own)) - np.repeat(np.cumsum(n) - n, n)


def _w_masks(f, wdense):
    """For the live item rows ``f`` [n, 12]: (masks, moff, inv, nnz) —
    ``masks[moff[inv[i]] + wt]``, the bitmap of the K3_SLICE-deep j slices
    in which item i's W rows [K3_TILE wt, + K3_TILE) hold a non-zero, and
    ``nnz[inv[i]]``, the non-zeros of its W block.  Formed once per
    distinct W block (an item's W block is the same for all items with
    its W offset: the sectors of one GEMM), from a prefix count of the
    pool's non-zeros: a (row, slice) holds one where the count grows
    across it."""
    _, first, inv = np.unique(f[:, 0], return_index=True,
                              return_inverse=True)
    wb, ws, nw, ns = f[first][:, [0, 1, 2, 11]].T
    if not np.array_equal(f[:, [1, 2, 11]],
                          np.stack([ws, nw, ns], 1)[inv.reshape(-1)]):
        raise ValueError("K3: items with one W offset differ in W shape")
    nsl = -(-ns // K3_SLICE)
    if np.any(nsl > 64) or np.any(wb + (nw - 1) * ws + ns > len(wdense)):
        raise ValueError("K3: a W block out of range")
    cnt = np.zeros(len(wdense) + 1, np.int32)
    np.cumsum((wdense != 0).view(np.uint8), dtype=np.int32, out=cnt[1:])
    ru, r = _segments(nw)                    # every row of every block
    pu, q = _segments(np.repeat(nsl, nw))    # every slice of every row
    start = (wb[ru] + r * ws[ru])[pu] + q * K3_SLICE
    end = start + np.minimum(K3_SLICE, ns[ru][pu] - q * K3_SLICE)
    bit = np.where(cnt[end] > cnt[start],
                   np.left_shift(np.uint64(1), q.astype(np.uint64)),
                   np.uint64(0))
    rows = np.bitwise_or.reduceat(bit, np.flatnonzero(q == 0))
    masks = np.bitwise_or.reduceat(rows, np.flatnonzero(r % K3_TILE == 0))
    row0 = wb[ru] + r * ws[ru]
    nnz = np.add.reduceat(cnt[row0 + ns[ru]] - cnt[row0],
                          np.flatnonzero(r == 0))
    moff = np.concatenate([[0], np.cumsum(-(-nw // K3_TILE))])
    return masks, moff, inv.reshape(-1), nnz


def _k3_cover(ob, S, nw, wd):
    """The OUT elements that GEMM blocks (obase ``ob`` ascending, row
    stride ``S``, ``nw`` rows of ``wd`` elements) write, as (starts, ends)
    of disjoint intervals, merged where they touch.  Blocks side by side in
    the same rows (the sectors of one mix GEMM) are joined first, so there
    is an interval a GEMM row, or one a block whose rows touch.  Raises if
    two blocks share an element (K3 stores each element once)."""
    full = (wd == S) | (nw == 1)
    link = np.zeros(len(ob), bool)
    link[1:] = ((ob[1:] == ob[:-1] + wd[:-1]) & (S[1:] == S[:-1])
                & (nw[1:] == nw[:-1]) & ~full[1:] & ~full[:-1])
    head = np.flatnonzero(~link)
    cw = np.add.reduceat(wd, head)
    hob, hS, hnw = ob[head], S[head], nw[head]
    if np.any(cw > np.where(hnw > 1, hS, cw)):
        raise ValueError("K3: GEMM blocks overlap in OUT")
    one = (cw == hS) | (hnw == 1)            # contiguous rows: one interval
    nr = np.where(one, 1, hnw)
    ri = np.arange(int(nr.sum())) - np.repeat(np.cumsum(nr) - nr, nr)
    starts = np.repeat(hob, nr) + ri * np.repeat(hS, nr)
    ends = starts + np.repeat(np.where(one, (hnw - 1) * hS + cw, cw), nr)
    o = np.argsort(starts, kind="stable")
    starts, ends = starts[o], ends[o]
    if np.any(starts[1:] < ends[:-1]):
        raise ValueError("K3: GEMM blocks overlap in OUT")
    brk = np.ones(len(starts), bool)
    brk[1:] = starts[1:] != ends[:-1]
    last = np.append(np.flatnonzero(brk)[1:] - 1, len(ends) - 1)
    return starts[brk], ends[last]


def _k3_gaps(cs, ce, n: int):
    """The ranges of [0, n) outside the intervals [cs, ce), cut into
    pieces of at most K3_ZERO elements (``kz`` [n_gaps, 2]: start,
    length), and the zero tiles (-1, gaps, first gap, 0) that store them:
    runs of at most 64 gaps and about K3_ZERO elements."""
    if len(ce) and ce[-1] > n:
        raise ValueError("K3: OUT blocks reach past the buffer")
    zs = np.concatenate([[0], ce])
    zn = np.concatenate([cs, [n]]) - zs
    zs, zn = zs[zn > 0], zn[zn > 0]
    k = -(-zn // K3_ZERO)
    zi = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    z0 = np.repeat(zs, k) + zi * K3_ZERO
    kz = np.stack([z0, np.minimum(np.repeat(zs + zn, k) - z0, K3_ZERO)], 1)
    before = np.cumsum(kz[:, 1]) - kz[:, 1]
    run = before // K3_ZERO
    new = np.ones(len(kz), bool)
    new[1:] = run[1:] != run[:-1]
    pos = np.arange(len(kz)) - np.maximum.accumulate(
        np.where(new, np.arange(len(kz)), 0))
    first = np.flatnonzero(new | (pos % 64 == 0))
    cnt = np.diff(np.append(first, len(kz)))
    kt = np.stack([np.full(len(first), -1), cnt, first,
                   np.zeros(len(first), np.int64)], 1)
    return kz, kt


def k3_host_tables(it, wdense, zero_to: int) -> Dict:
    """K3's output tiles for the item table ``it`` [n, 12] and the dense W
    pool ``wdense`` (host, real), built once a plan, so that K3 writes
    every element of OUT [0, zero_to), each once.  A GEMM block is the
    items with one obase (its j-chunks, in plan order; one at every width
    this repository runs); its OUT is cut into 64 x 64 tiles.

    ``kt`` [n_tiles, 8] int32: (first entry of ``kl``, entries, rows,
    columns, OUT offset of the tile, OUT row stride, d0, 0) a tile, the
    heaviest first, then the zero tiles (-1, gaps, first gap, 0, ...).
    ``kl`` [n_entries, 8] int32: (W offset of the tile's first row, W row
    stride, E offset, E row stride, depth, mask lo, mask hi, item), the
    block's items for one 64-row tile in j order, each with the bitmap of
    the 16-deep j slices in which its W rows of the tile hold a non-zero
    (the kernel skips the other slices).
    ``kz`` [n_gaps, 2] int32: (start, length), the OUT ranges below
    ``zero_to`` that no block writes, stored as zeros.
    Also ``steps`` (slices walked), ``flops`` (dense, as the reference
    multiplies), ``flops_nz`` (on W's non-zeros), ``written`` (elements
    the blocks store), ``zeros`` and ``seconds``."""
    t0 = time.perf_counter()
    T = K3_TILE
    it = np.asarray(it)
    live = np.flatnonzero((it[:, 2] > 0) & (it[:, 10] > 0)
                          & (it[:, 11] > 0))
    f = it[live].astype(np.int64)
    o = np.argsort(f[:, 5], kind="stable")   # by obase, then plan order
    live, f = live[o], f[o]
    first = np.ones(len(f), bool)
    first[1:] = f[1:, 5] != f[:-1, 5]
    gs = np.flatnonzero(first)
    cnt = np.diff(np.append(gs, len(f)))
    g = f[gs]
    gi = np.repeat(np.arange(len(gs)), cnt)
    if not np.array_equal(f[:, [2, 6, 10]], g[gi][:, [2, 6, 10]]):
        raise ValueError("K3: items with one obase differ in OUT shape")
    cs, ce = _k3_cover(g[:, 5], g[:, 6], g[:, 2], g[:, 10])
    kz, zt = _k3_gaps(cs, ce, int(zero_to))
    masks, moff, inv, nnz = _w_masks(f, wdense)

    # list entries: per block and 64-row tile, the block's items in j order
    nwt = -(-g[:, 2] // T)
    ne = nwt * cnt
    es = np.concatenate([[0], np.cumsum(ne)])
    eg = np.repeat(np.arange(len(gs)), ne)
    loc = np.arange(int(es[-1])) - es[eg]
    ewt = loc // cnt[eg]
    ek = gs[eg] + loc % cnt[eg]
    emask = np.ascontiguousarray(masks[moff[inv[ek]] + ewt])
    fe = f[ek]
    kl = np.zeros((len(ek), 8), np.int64)
    kl[:, 0] = fe[:, 0] + ewt * T * fe[:, 1]
    kl[:, 1:5] = fe[:, [1, 3, 4, 11]]
    kl[:, 7] = live[ek]
    # slices a 64-row tile walks, summed over its entries
    pc = np.unpackbits(emask.view(np.uint8)).reshape(-1, 64).sum(
        axis=1, dtype=np.int64)
    steps_gw = np.add.reduceat(pc, np.flatnonzero(loc % cnt[eg] == 0)) \
        if len(pc) else pc

    # tiles: per block, 64-row tile and 64-column tile, heaviest first
    ndt = -(-g[:, 10] // T)
    nt = nwt * ndt
    ts = np.concatenate([[0], np.cumsum(nt)])
    tg = np.repeat(np.arange(len(gs)), nt)
    tl = np.arange(int(ts[-1])) - ts[tg]
    w0, d0 = (tl // ndt[tg]) * T, (tl % ndt[tg]) * T
    gw = np.concatenate([[0], np.cumsum(nwt)])[tg] + w0 // T
    gt = g[tg]
    kt = np.zeros((len(tg) + len(zt), 8), np.int64)
    kt[:len(tg), 0] = es[tg] + (w0 // T) * cnt[tg]
    kt[:len(tg), 1] = cnt[tg]
    kt[:len(tg), 2] = np.minimum(T, gt[:, 2] - w0)
    kt[:len(tg), 3] = np.minimum(T, gt[:, 10] - d0)
    kt[:len(tg), 4] = gt[:, 5] + w0 * gt[:, 6] + d0
    kt[:len(tg), 5] = gt[:, 6]
    kt[:len(tg), 6] = d0
    kt[:len(tg)] = kt[np.argsort(-steps_gw[gw], kind="stable")]
    kt[len(tg):, :4] = zt
    if max(zero_to, int(kl.max(initial=0)), int(kt.max(initial=0))) \
            >= (1 << 31):
        raise ValueError("K3 tables exceed int32")
    kl = kl.astype(np.int32)
    kl[:, 5:7] = emask.view(np.int32).reshape(-1, 2)
    width = f[:, 10].astype(np.float64)
    h = {"kt": kt.astype(np.int32), "kl": kl, "kz": kz.astype(np.int32),
         "steps": int(steps_gw[gw].sum()),
         "flops": 2.0 * float((f[:, 2] * f[:, 11] * width).sum()),
         "flops_nz": 2.0 * float((nnz[inv] * width).sum()),
         "written": int((ce - cs).sum()), "zeros": int(kz[:, 1].sum()),
         "seconds": time.perf_counter() - t0}
    return h


def mix_exec(epool, wpool, d: Dict, out):
    """Mix GEMM (kernel K3): stores every GEMM block's W @ E into ``out``
    (the flat OUT buffer) in place and zeros into the rest of it below
    ``d["zlim"]`` (a device int: the end of what OUT's reader reads), so
    ``out`` needs no fill.  On CPU tensors the twin adds the blocks into
    ``out`` zeroed here."""
    if epool.device.type == "cpu":
        return mix_twin(epool, wpool, d, out.zero_())
    if not epool.is_cuda:
        raise ValueError(f"unsupported device {epool.device}")
    _kernels.launch("K3_mix", "b2t_mix", epool.dtype, epool, wpool,
                    d["kt"], d["kl"], d["kz"], d["zlim"], d["kt"].shape[0],
                    out)
    return out


# ---------------------------------------------------------------------------
# kernel K4 (window place) and its plain twin
# ---------------------------------------------------------------------------

def place_twin(outflat, d: Dict, res):
    """Plain PyTorch version of K4 (same signature as :func:`place_exec`)."""
    T = _TP
    pit, pcum = d["pit"].long(), d["pcum"].long()
    r = torch.arange(T, device=res.device)[None, :, None]
    c = torch.arange(T, device=res.device)[None, None, :]
    tot = int(pcum[-1])
    for s in range(0, tot, _TWIN_PLACE_TASKS):
        win, o = _locate(pcum, s, min(s + _TWIN_PLACE_TASKS, tot))
        f = pit[win][:, :, None, None]
        nkT = f[:, 7]
        rr = (o[:, None, None] // nkT) * T + r
        cc = (o[:, None, None] % nkT) * T + c
        ok = (rr < f[:, 5]) & (cc < f[:, 6])
        src = (f[:, 0] + rr * f[:, 1] + cc)[ok]
        dst = (f[:, 2] + rr * f[:, 3] + cc * f[:, 4])[ok]
        res.index_add_(0, dst, outflat[src])
    return res


def place_exec(outflat, d: Dict, res):
    """Window place (kernel K4): writes the whole slab pool ``res`` in
    place — every window of OUT, zeros elsewhere (its prior contents are
    never read).  K4 assembles slab chunks from the windows that reach
    into them (``d["wend"]``, ``d["wbeg"]``); on CPU tensors the twin adds
    the windows into ``res`` zeroed here.  The two agree because the
    plan's windows are disjoint."""
    if outflat.device.type == "cpu":
        return place_twin(outflat, d, res.zero_())
    if not outflat.is_cuda:
        raise ValueError(f"unsupported device {outflat.device}")
    dt = outflat.dtype
    _kernels.launch("K4_place", "b2t_place", dt, outflat, d["pit"],
                    d["wend"], d["wbeg"], d["pit"].shape[0], res.numel(),
                    res)
    return res


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def plan_host(plan: MixPlanV4) -> Dict:
    """K3's host tables of a v4 plan (:func:`k3_host_tables` over OUT
    [otp + 1]; the elements K4 reads are the GEMM blocks'), built once and
    kept in its ``_dev``."""
    h = plan._dev.get("k3")
    if h is None:
        h = plan._dev["k3"] = k3_host_tables(
            plan.it, plan.wdense.real, _cap_class(plan.out_total + 1) + 1)
    return h


def plan_tables(plan: MixPlanV4, device, dtype) -> Dict:
    """Device tables of a v4 plan for K3/K4 (and their twins), uploaded
    once a device and dtype and kept in the plan's ``_dev``.  K4's
    ``wend`` (prefix maximum of each window's last slab position + 1) and
    ``wbeg`` (suffix minimum of its first) are formed on the device from
    ``pit``: no host work per plan; pad rows own no position."""
    key = (str(device), dtype)
    d = plan._dev.get(key)
    if d is not None:
        return d

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    if plan.iscpx:
        raise TypeError("complex mix plans are not on this slice")
    h = plan_host(plan)
    pit = i32(plan.pit)
    dst, rs, cs, nb, nk = pit[:, 2:7].unbind(1)
    live = (nb > 0) & (nk > 0)
    ext_r, ext_c = (nb - 1) * rs, (nk - 1) * cs
    first = dst + ext_r.clamp(max=0) + ext_c.clamp(max=0)
    last = dst + ext_r.clamp(min=0) + ext_c.clamp(min=0)
    wend = torch.where(live, last + 1, 0).cummax(0).values
    wbeg = torch.where(live, first, torch.iinfo(torch.int32).max) \
        .flip(0).cummin(0).values.flip(0)
    # the end of the last OUT element a window reads: K3 zeroes no gap
    # past it (OUT's size-class tail), formed here on the device
    zlim = torch.where(live, pit[:, 0].long() + (nb.long() - 1)
                       * pit[:, 1].long() + nk, 0).max()
    d = plan._dev[key] = {
        "it": i32(plan.it), "cum1": i32(plan.cum1), "cum2": i32(plan.cum2),
        "kt": i32(h["kt"]), "kl": i32(h["kl"]), "kz": i32(h["kz"]),
        "zlim": zlim.to(torch.int32).reshape(1), "pit": pit,
        "pcum": i32(plan.pcum),
        "wend": wend.contiguous(), "wbeg": wbeg.contiguous(),
        "wpool": torch.as_tensor(plan.wdense.real, dtype=dtype,
                                 device=device)}
    return d


def execute_mix_v4(plan: MixPlanV4, epool, d: Optional[Dict] = None):
    """LW/RW slab pool [ncap_out + 1] (zero sentinel last) from the env
    slab pool ``epool`` on its device and in its dtype — what the
    reference's execute_mix_v4 returns.  ``d``: tables from
    :func:`plan_tables` (taken from the plan's cache when omitted).  OUT
    is allocated unfilled: K3 writes all of it that K4 reads."""
    if d is None:
        d = plan_tables(plan, epool.device, epool.dtype)
    otp = _cap_class(plan.out_total + 1)
    out = torch.empty(otp + 1, dtype=epool.dtype, device=epool.device)
    mix_exec(epool, d["wpool"], d, out)
    res = torch.empty(plan.ncap_out + 1, dtype=epool.dtype,
                      device=epool.device)
    return place_exec(out[:otp], d, res)
