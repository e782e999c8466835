"""Tiled sigma matvec over LW/RW slab pools (v2 task tables) — kernel K1.

Host side: ``MatvecV2._build`` is copied from
block2_preview_tpu/ops/tilev2.py:257-501 so the per-item tables (`it`,
`cum1`/`cum2`, `g1`/`g2`, `psi_idx`/`sig_idx`, ...) are byte-identical to
the reference's and both engines can run on one plan.

Device side: :func:`mv_exec` is the wrapper of kernel K1
(``csrc/matvec.cu``).  It computes, for every item (m, pk, ok),

    sigma[ok] += LW[m][lk] @ psi[pk] @ RW[m][rk]^T

on T x T tiles and flattens the sigma tile pool through ``sig_idx`` —
what the reference's ``_mv_exec`` (tilev2.py:187) computes after
materializing tile pools with ``_tile_gather`` (:168).  On CPU tensors
the wrapper runs :func:`mv_twin`, the plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import _kernels
from .stacked import StackedMeta, _pow2
from .tiled import pick_tile

# per tile size: stage task capacity B and tmp-pool tiles per group
_CFG = {16: (8192, 8192), 32: (8192, 8192), 64: (4096, 4096),
        128: (2048, 2048)}

# struct layout version (the reference's _V2_VER)
_V2_VER = 3

# stage tasks per chunk of the plain version (bounds its temporaries)
_TWIN_CHUNK = 8192


def _grid(n, T):
    return -(-n // T)


def _grid_a(x, T):
    return -(-np.asarray(x, dtype=np.int64) // T)


# ---------------------------------------------------------------------------
# kernel K1 and its plain twin
# ---------------------------------------------------------------------------

def gather_tiles(pool, base, stride, rmax, cmax, T):
    """[n, T, T] tiles of a flat pool at base + r*stride + c, zero outside
    (rmax, cmax) or where base < 0 (the reference's _gtile)."""
    r = torch.arange(T, device=pool.device)[None, :, None]
    c = torch.arange(T, device=pool.device)[None, None, :]
    idx = base[:, None, None] + r * stride[:, None, None] + c
    ok = (r < rmax[:, None, None]) & (c < cmax[:, None, None]) \
        & (base[:, None, None] >= 0)
    vals = pool[torch.where(ok, idx, torch.zeros_like(idx))]
    return torch.where(ok, vals, torch.zeros_like(vals))


def _locate(cum, t0, t1):
    """Tasks [t0, t1) -> (task ids, item, offset within item): the
    reference's _locate (searchsorted right, minus one)."""
    tau = torch.arange(t0, t1, device=cum.device)
    item = torch.searchsorted(cum, tau, right=True) - 1
    return item, tau - cum[item]


def mv_twin(xp, lpool, rpool, d: Dict, T: int, nt2: int):
    """Plain PyTorch version of K1 (same signature as :func:`mv_exec`).

    Stage 1 forms one tmp tile per unit (item, ai, ni) with a global unit
    id (``cumt``); stage 2 adds tmp @ R^T into the sigma tiles."""
    it = d["it"].long()
    cum1, cum2, cumt = d["cum1"].long(), d["cum2"].long(), d["cumt"].long()
    pp = xp[d["psi_idx"].long()].reshape(-1, T, T)
    tmp = torch.zeros((int(cumt[-1]) + 1, T, T), dtype=xp.dtype,
                      device=xp.device)
    tot1 = int(cum1[-1])
    for s in range(0, tot1, _TWIN_CHUNK):
        item, o = _locate(cum1, s, min(s + _TWIN_CHUNK, tot1))
        f = it[item]
        nn, nk = f[:, 11], f[:, 9]
        ai = o // (nn * nk)
        rem = o % (nn * nk)
        ni = rem // nk
        ki = rem % nk
        L = gather_tiles(lpool, f[:, 0] + ai * T * f[:, 1] + ki * T,
                         f[:, 1], f[:, 2] - ai * T, f[:, 1] - ki * T, T)
        P = pp[f[:, 6] + ki * nn + ni]
        tmp.index_add_(0, cumt[item] + ai * nn + ni, torch.bmm(L, P))
    sig = torch.zeros((nt2 + 1, T, T), dtype=xp.dtype, device=xp.device)
    tot2 = int(cum2[-1])
    for s in range(0, tot2, _TWIN_CHUNK):
        item, o = _locate(cum2, s, min(s + _TWIN_CHUNK, tot2))
        f = it[item]
        nn, npp = f[:, 11], f[:, 10]
        ai = o // (npp * nn)
        rem = o % (npp * nn)
        pi = rem // nn
        ni = rem % nn
        R = gather_tiles(rpool, f[:, 3] + pi * T * f[:, 4] + ni * T,
                         f[:, 4], f[:, 5] - pi * T, f[:, 4] - ni * T, T)
        prod = torch.bmm(tmp[cumt[item] + ai * nn + ni], R.transpose(1, 2))
        sig.index_add_(0, f[:, 7] + ai * npp + pi, prod)
    return sig.reshape(-1)[d["sig_idx"].long()]


def mv_exec(xp, lpool, rpool, d: Dict, T: int, nt2: int):
    """Sigma matvec (kernel K1): flat sigma [sizb_p] from the padded flat
    psi ``xp`` [size_p + 1] (zero last slot) and the LW/RW slab pools.
    ``d`` holds the device tables of :meth:`MatvecV2.to_device`."""
    if xp.device.type == "cpu":
        return mv_twin(xp, lpool, rpool, d, T, nt2)
    if not xp.is_cuda:
        raise ValueError(f"unsupported device {xp.device}")
    dt = xp.dtype
    sig = torch.zeros((nt2 + 1) * T * T, dtype=dt, device=xp.device)
    out = torch.empty(d["sig_idx"].shape[0], dtype=dt, device=xp.device)
    _kernels.launch("K1_matvec", "b2t_matvec", dt, xp, lpool, rpool,
                    d["psi_idx"], d["it"], d["cumt"], d["it"].shape[0],
                    d["n_units"], T, sig)
    _kernels.call("b2t_gather", dt, sig, d["sig_idx"], out.shape[0], out)
    return out


# ---------------------------------------------------------------------------
# host struct (copied from the reference)
# ---------------------------------------------------------------------------

class MatvecV2:
    """Sigma-vector executor over LW/RW slab pools, v2 task derivation.

    space/bra_space: _Space objects (sector keys/shapes/offsets);
    meta_lw/meta_rw: StackedMeta layouts of the assembled center
    operators (from ops.mixv4.execute_mix_v4).
    """

    def __init__(self, space, meta_lw: StackedMeta, meta_rw: StackedMeta,
                 group, target_b, dtype=np.float32,
                 T: Optional[int] = None, cache: dict = None,
                 cache_key=None, bra_space=None):
        self.dtype = dtype
        self.space = space
        self.bra_space = bra_space if bra_space is not None else space
        self.size = space.size
        self.out_size = self.bra_space.size
        struct = None
        sig = None
        if cache is not None and cache_key is not None:
            sig = hash((_V2_VER, meta_lw.signature(), meta_rw.signature(),
                        tuple(space.keys),
                        tuple(sorted(space.shapes.items())),
                        tuple(self.bra_space.keys), T))
            ent = cache.get(cache_key)
            if ent is not None and ent[0] == sig:
                struct = ent[1]
        if struct is None:
            struct = self._build(space, self.bra_space, meta_lw, meta_rw,
                                 group, target_b, T)
            if cache is not None and cache_key is not None:
                cache[cache_key] = (sig, struct)
        self.struct = struct
        self._dev = None

    @staticmethod
    def _build(space, bra_space, meta_lw, meta_rw, g, tb_t, T):
        lw_dq = {}
        for gi, (dq, syms) in enumerate(meta_lw.groups):
            for s in syms:
                lw_dq[int(s)] = dq
        dims = []
        for k in space.keys:
            dims += list(space.shapes[k])
        for k in bra_space.keys:
            dims += list(bra_space.shapes[k])
        if T is None:
            T = pick_tile(np.asarray(dims if dims else [16]))
        B, nt1 = _CFG[T]

        def vec_layout(sp):
            vb = {}
            nv = 0
            for k in sp.keys:
                r, c = sp.shapes[k]
                vb[k] = (nv, _grid(r, T), _grid(c, T))
                nv += _grid(r, T) * _grid(c, T)
            return vb, nv

        vbk, nvk = vec_layout(space)
        vbb, nvb = vec_layout(bra_space)
        nt2 = _pow2(nvb + 1)
        size_p = _pow2(space.size + 1)
        sizb_p = _pow2(bra_space.size + 1)

        npsit = _pow2(nvk + 1)
        psi_idx = np.full((npsit, T, T), size_p, dtype=np.int32)
        for k in space.keys:
            off = space.offsets[k]
            r, c = space.shapes[k]
            base, nr, ncc = vbk[k]
            fr, fc = np.divmod(np.arange(r * c), c)
            tidx = ((base + (fr // T) * ncc + (fc // T)) * (T * T)
                    + (fr % T) * T + (fc % T))
            psi_idx.reshape(-1)[tidx] = off + np.arange(r * c)
        sig_idx = np.full(sizb_p, (nt2 + 1) * T * T - 1, dtype=np.int32)
        for k in bra_space.keys:
            off = bra_space.offsets[k]
            r, c = bra_space.shapes[k]
            base, nr, ncc = vbb[k]
            fr, fc = np.divmod(np.arange(r * c), c)
            tidx = ((base + (fr // T) * ncc + (fc // T)) * (T * T)
                    + (fr % T) * T + (fc % T))
            sig_idx[off + np.arange(r * c)] = tidx

        bkeys = set(bra_space.keys)
        rows = []   # lbase, DLk, DLb, rbase, DRk, DRb, pb, ob
        for m, (gl, jl) in sorted(meta_lw.sym_pos.items()):
            gr_jr = meta_rw.sym_pos.get(m)
            if gr_jr is None:
                continue
            gr, jr = gr_jr
            dq = lw_dq[m]
            sec_l = meta_lw.sectors[gl]
            sec_r = meta_rw.sectors[gr]
            for (qLk, qRk) in space.keys:
                qLb = g.add(qLk, dq)
                qRb = g.sub(tb_t, qLb)
                if (qLb, qRb) not in bkeys:
                    continue
                el = sec_l.get(qLb)
                er = sec_r.get(qRb)
                if el is None or er is None:
                    continue
                loff, DLb, DLk = el
                roff, DRb, DRk = er
                if DLk != space.shapes[(qLk, qRk)][0] or \
                        DRk != space.shapes[(qLk, qRk)][1] or \
                        DLb != bra_space.shapes[(qLb, qRb)][0] or \
                        DRb != bra_space.shapes[(qLb, qRb)][1]:
                    continue
                rows.append((loff + jl * DLb * DLk, DLk, DLb,
                             roff + jr * DRb * DRk, DRk, DRb,
                             vbk[(qLk, qRk)][0], vbb[(qLb, qRb)][0]))
        if not rows:
            raise ValueError("no matvec triples")
        it = np.asarray(rows, dtype=np.int64)
        # sort items by output tile base for near-sorted stage-2 segments
        order = np.argsort(it[:, 7], kind="stable")
        it = it[order]
        n = len(it)
        na = _grid_a(it[:, 2], T)
        nk = _grid_a(it[:, 1], T)
        npp = _grid_a(it[:, 5], T)
        nn = _grid_a(it[:, 4], T)
        itmp = na * nn
        is1 = itmp * nk
        is2 = itmp * npp
        if int(max(is1.max(), is2.max())) > B or int(itmp.max()) > nt1:
            raise ValueError(f"item too large for T={T}")
        # greedy grouping: budgets nt1 (tmp tiles) and B (tasks/stage)
        tb = np.empty(n, dtype=np.int64)
        gfirst1 = [0]
        gfirst2 = [0]
        t_used = u1 = u2 = 0
        c1 = np.concatenate([[0], np.cumsum(is1)])
        c2 = np.concatenate([[0], np.cumsum(is2)])
        for i in range(n):
            if (t_used + itmp[i] > nt1 or u1 + is1[i] > B
                    or u2 + is2[i] > B):
                gfirst1.append(int(c1[i]))
                gfirst2.append(int(c2[i]))
                t_used = u1 = u2 = 0
            tb[i] = t_used
            t_used += itmp[i]
            u1 += is1[i]
            u2 += is2[i]
        # operator tile descriptors (the reference's _tile_gather
        # inputs; K1 reads L/R tiles straight from the slab pools)
        nl_item = na * nk
        nr_item = npp * nn
        lt_base = np.concatenate([[0], np.cumsum(nl_item)])
        rt_base = np.concatenate([[0], np.cumsum(nr_item)])
        nlt, nrt = int(lt_base[-1]), int(rt_base[-1])

        def tile_desc(base_a, dk_a, db_a, grow, gcol, tbase, ntile):
            cnt = grow * gcol
            item = np.repeat(np.arange(n), cnt)
            o = np.arange(ntile) - np.repeat(tbase[:-1], cnt)
            gci = gcol[item]
            ri = o // gci
            ci = o % gci
            d = np.empty((4, ntile), np.int32)
            d[0] = base_a[item] + ri * T * dk_a[item] + ci * T
            d[1] = dk_a[item]
            d[2] = db_a[item] - ri * T
            d[3] = dk_a[item] - ci * T
            return d

        ltd = tile_desc(it[:, 0], it[:, 1], it[:, 2], na, nk,
                        lt_base, nlt)
        rtd = tile_desc(it[:, 3], it[:, 4], it[:, 5], npp, nn,
                        rt_base, nrt)
        nlt_p = _pow2(nlt + 1)
        nrt_p = _pow2(nrt + 1)
        ltd = np.concatenate(
            [ltd, np.tile([[-1], [1], [0], [0]], (1, nlt_p - nlt))], 1)
        rtd = np.concatenate(
            [rtd, np.tile([[-1], [1], [0], [0]], (1, nrt_p - nrt))], 1)

        tot1, tot2 = int(c1[-1]), int(c2[-1])
        item1 = np.repeat(np.arange(n), is1)
        o = np.arange(tot1) - np.repeat(c1[:-1], is1)
        nn1, nk1 = nn[item1], nk[item1]
        ki = o % nk1
        ai = o // (nn1 * nk1)
        l_tid = (lt_base[item1] + ai * nk1 + ki).astype(np.int64)
        item2 = np.repeat(np.arange(n), is2)
        o = np.arange(tot2) - np.repeat(c2[:-1], is2)
        nn2, np2 = nn[item2], npp[item2]
        rem = o % (np2 * nn2)
        pi = rem // nn2
        ni = rem % nn2
        r_tid = (rt_base[item2] + pi * nn2 + ni).astype(np.int64)
        l_tid_p = np.full(_pow2(tot1 + 1), nlt_p, np.int32)
        l_tid_p[:tot1] = l_tid
        r_tid_p = np.full(_pow2(tot2 + 1), nrt_p, np.int32)
        r_tid_p[:tot2] = r_tid

        # padded items own zero tasks: the repeated cum tail is never
        # selected by the item search
        np_q = _pow2(n)
        itf = np.zeros((np_q, 13), dtype=np.int32)
        itf[:n, :8] = it[:, :8]
        itf[:n, 8] = na
        itf[:n, 9] = nk
        itf[:n, 10] = npp
        itf[:n, 11] = nn
        itf[:n, 12] = tb
        # non-zero grids on pad rows keep the divmods well-defined
        itf[n:, 8:12] = 1
        c1 = np.concatenate([c1, np.full(np_q - n, c1[-1], c1.dtype)])
        c2 = np.concatenate([c2, np.full(np_q - n, c2[-1], c2.dtype)])
        ng_live = len(gfirst1)
        ng = max(64, _pow2(ng_live))
        gfirst1 += [int(c1[-1])] * (ng - ng_live)
        gfirst2 += [int(c2[-1])] * (ng - ng_live)
        return {"T": T, "B": B, "nt1": nt1, "nt2": nt2,
                "size_p": size_p, "sizb_p": sizb_p, "ng_live": ng_live,
                "psi_idx": psi_idx, "sig_idx": sig_idx,
                "it": itf,
                "cum1": c1.astype(np.int32), "cum2": c2.astype(np.int32),
                "g1": np.asarray(gfirst1, dtype=np.int32),
                "g2": np.asarray(gfirst2, dtype=np.int32),
                "ltd": ltd, "rtd": rtd, "nlt_p": nlt_p, "nrt_p": nrt_p,
                "l_tid": l_tid_p, "r_tid": r_tid_p,
                "flops": int(2 * (it[:, 2] * it[:, 1] * it[:, 4]
                                  + it[:, 2] * it[:, 4] * it[:, 5]).sum())}

    # ------------------------------------------------------------------
    def to_device(self, device) -> Dict:
        """Device tables K1 and its twin read.  ``cumt`` [n_items + 1]
        is derived here (not part of the reference struct): prefix sums
        of the stage-1 units (item, ai, ni), na * nn per live item."""
        if self._dev is None or self._dev["device"] != torch.device(device):
            s = self.struct
            it = s["it"].astype(np.int64)
            live = np.diff(s["cum1"].astype(np.int64)) > 0
            units = np.where(live, it[:, 8] * it[:, 11], 0)
            cumt = np.concatenate([[0], np.cumsum(units)])
            if cumt[-1] >= (1 << 31):
                raise ValueError("matvec unit count exceeds int32")
            dev = {k: torch.as_tensor(s[k], device=device)
                   for k in ("psi_idx", "sig_idx", "it", "cum1", "cum2")}
            dev["psi_idx"] = dev["psi_idx"].reshape(-1)
            dev["cumt"] = torch.as_tensor(cumt.astype(np.int32),
                                          device=device)
            dev["n_units"] = int(cumt[-1])
            dev["device"] = torch.device(device)
            self._dev = dev
        return self._dev

    def pad(self, x: np.ndarray) -> np.ndarray:
        xp = np.zeros(self.struct["size_p"] + 1, dtype=self.dtype)
        xp[:self.size] = x
        return xp

    def matvec_device(self, xp, lpool, rpool):
        """Flat sigma [sizb_p] on the device of ``xp`` (kernel K1)."""
        s = self.struct
        return mv_exec(xp, lpool, rpool, self.to_device(xp.device),
                       s["T"], s["nt2"])
