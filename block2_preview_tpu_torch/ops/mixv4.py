"""LW/RW assembly, mix v4 form — kernels K3 (mix GEMM) and K4 (place).

Host side, copied from block2_preview_tpu/ops/mixv4.py:136-425 (the
plan: ``emit_gemm_items``, ``MixPlanV4``, ``plan_v4``) so the item and
window tables are byte-identical to the reference's.  The reference's
single packed int32 upload (a remedy for a slow host link) is not
carried: the port uploads the tables as they are.

Device side, :func:`execute_mix_v4` runs

  K3 (``csrc/mix.cu``, replaces ``_mix4_scan``):
      OUT[w, d] += sum_j W[w, j] * E[j, d] per plan item, W dense;
  K4 (``csrc/place.cu``, replaces ``_place4_exec_packed``):
      slab[dst + r*rs + c*cs] += OUT[src + r*sst + c] per window;

and returns the LW/RW slab pool [ncap_out + 1] with the zero sentinel
last.  On CPU tensors the wrappers run the plain PyTorch twins; on CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

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
    tables; see build_mix_plan_v3).  Host arrays only: device tables are
    uploaded per execution and never stored on the plan."""

    __slots__ = ("meta_out", "ncap_out", "out_total", "iscpx",
                 "dims_hint", "n_launch",
                 "it", "cum1", "cum2", "g1", "g2", "e1", "e2",
                 "ng_live", "wdense", "pit", "pcum", "png")


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


def mix_exec(epool, wpool, d: Dict, out):
    """Mix GEMM (kernel K3): adds every plan item's W @ E into ``out``
    (the flat OUT buffer, zero-initialised by the caller) in place."""
    if epool.device.type == "cpu":
        return mix_twin(epool, wpool, d, out)
    if not epool.is_cuda:
        raise ValueError(f"unsupported device {epool.device}")
    dt = epool.dtype
    if 4 * d["n2"] >= (1 << 31):
        raise ValueError("mix task count exceeds the grid")
    _kernels.launch("K3_mix", "b2t_mix", dt, epool, wpool, d["it"],
                    d["cum2"], d["it"].shape[0], d["n2"], out)
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
    """Window place (kernel K4): adds every window of OUT into the slab
    pool ``res`` (zero-initialised by the caller) in place."""
    if outflat.device.type == "cpu":
        return place_twin(outflat, d, res)
    if not outflat.is_cuda:
        raise ValueError(f"unsupported device {outflat.device}")
    dt = outflat.dtype
    _kernels.launch("K4_place", "b2t_place", dt, outflat, d["pit"],
                    d["pcum"], d["pit"].shape[0], d["np"], res)
    return res


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def plan_tables(plan: MixPlanV4, device, dtype) -> Dict:
    """Device tables of a v4 plan for K3/K4 (and their twins)."""
    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    if plan.iscpx:
        raise TypeError("complex mix plans are not on this slice")
    return {"it": i32(plan.it), "cum1": i32(plan.cum1),
            "cum2": i32(plan.cum2), "pit": i32(plan.pit),
            "pcum": i32(plan.pcum),
            "n2": int(plan.cum2[-1]), "np": int(plan.pcum[-1]),
            "wpool": torch.as_tensor(plan.wdense.real, dtype=dtype,
                                     device=device)}


def execute_mix_v4(plan: MixPlanV4, epool, d: Optional[Dict] = None):
    """LW/RW slab pool [ncap_out + 1] (zero sentinel last) from the env
    slab pool ``epool`` on its device and in its dtype — what the
    reference's execute_mix_v4 returns.  ``d``: tables from
    :func:`plan_tables` (built here when omitted)."""
    if d is None:
        d = plan_tables(plan, epool.device, epool.dtype)
    otp = _cap_class(plan.out_total + 1)
    out = torch.zeros(otp + 1, dtype=epool.dtype, device=epool.device)
    mix_exec(epool, d["wpool"], d, out)
    res = torch.zeros(plan.ncap_out + 1, dtype=epool.dtype,
                      device=epool.device)
    return place_exec(out[:otp], d, res)
