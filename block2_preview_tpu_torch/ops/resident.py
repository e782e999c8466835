"""Device-resident two-site effective-Hamiltonian step (torch) — kernels
K2 (diagonal) and K6 (noise density matrix).

Port of block2_preview_tpu/ops/resident.py:594-711, 853-1133, 1159-1472
for the SZ ground-state path.  Per center site t:

  env slab pools on the device (MovingEnvironment.device_pool)
  --execute_mix_v4 (K3 + K4)--> LW/RW slab pools (device)
  --execute_diag (K2)--> diagonal     --davidson around K1--> psi (host)
  --noise_rho (K6, noise > 0)--> {qb: rho_noise [D, D]} (host)

Only the center wavefunction, the initial guess, the small noise density
matrix and scalars cross between host and device.  ``build_diag_struct``
and ``NoisePlan`` are copied from the reference so their tables equal it.
``host_ops`` (a download of assembled LW/RW, for tests) is not on the
sweep's path; each call counts one ``host_ops_downloads``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import _kernels
from .blocking import _plan_args_sig
from .device_davidson import davidson
from .mixv3 import build_mix_plan_v3
from .mixv4 import execute_mix_v4, plan_v4
from .stacked import StackedMeta, _pow2
from .tilev2 import MatvecV2, _locate, gather_tiles, mv_exec
from ..runtime import torch_dtype

# diag tile tasks per chunk of the plain version
_TWIN_CHUNK = 4096


def build_diag_struct(space, meta_lw: StackedMeta, meta_rw: StackedMeta,
                      T: int, nt2: int, sig_idx: np.ndarray):
    """Diag tasks: only center symbols with dq = 0 contribute
    (LW[m][(qL,qL)] x RW[m][(qR,qR)] diagonals).  Emits (1) strided
    diag-gather tasks building DL/DR row-major [M0p, Dpad] per sector and
    (2) GEMM tile tasks contracting over m.  Returns a struct executable
    by execute_diag."""
    g0l = g0r = None
    zero = None
    for gi, (dq, syms) in enumerate(meta_lw.groups):
        if all(x == 0 for x in dq):
            g0l = gi
            zero = dq
            break
    for gi, (dq, syms) in enumerate(meta_rw.groups):
        if all(x == 0 for x in dq):
            g0r = gi
            break
    if g0l is None or g0r is None:
        return None
    dql, syml = meta_lw.groups[g0l]
    dqr, symr = meta_rw.groups[g0r]
    # common symbols, positions in each slab
    posl = {int(s): j for j, s in enumerate(syml)}
    posr = {int(s): j for j, s in enumerate(symr)}
    common = sorted(set(posl) & set(posr))
    if not common:
        return None
    M0 = len(common)
    M0p = -(-M0 // T) * T

    # DL/DR pool layout: per psi sector (qL, qR): [M0p rows x DLpad cols]
    gtasks_l = []   # (base, stride, imax, outrow)
    gtasks_r = []
    gemm = []       # (abase, astr, armax, acmax, bbase, ..., out tile)
    dl_off = dr_off = 0
    dl_secoff = {}
    dr_secoff = {}
    for (qL, qR) in space.keys:
        el = meta_lw.sectors[g0l].get(qL)
        er = meta_rw.sectors[g0r].get(qR)
        DL, DR = space.shapes[(qL, qR)]
        if el is None or er is None:
            continue
        loff, DLb, DLk = el
        roff, DRb, DRk = er
        if DLb != DL or DLk != DL or DRb != DR or DRk != DR:
            continue
        DLpad = -(-DL // T) * T
        DRpad = -(-DR // T) * T
        dl_secoff[(qL, qR)] = (dl_off, DLpad)
        dr_secoff[(qL, qR)] = (dr_off, DRpad)
        for mi, m in enumerate(common):
            jl, jr = posl[m], posr[m]
            for tile in range(DLpad // T):
                gtasks_l.append((loff + jl * DL * DL + tile * T * (DL + 1),
                                 DL + 1, DL - tile * T,
                                 dl_off + mi * DLpad + tile * T))
            for tile in range(DRpad // T):
                gtasks_r.append((roff + jr * DR * DR + tile * T * (DR + 1),
                                 DR + 1, DR - tile * T,
                                 dr_off + mi * DRpad + tile * T))
        dl_off += M0p * DLpad
        dr_off += M0p * DRpad
    if not gtasks_l:
        return None

    # GEMM tile tasks: diag_sec[a, b] = sum_m DL[m, a] * DR[m, b]
    vbb = {}
    nv = 0
    for k in space.keys:
        r, c = space.shapes[k]
        vbb[k] = (nv, -(-r // T), -(-c // T))
        nv += (-(-r // T)) * (-(-c // T))
    a4t, b4t, sDt = [], [], []
    for (qL, qR) in space.keys:
        if (qL, qR) not in dl_secoff:
            continue
        doff, DLpad = dl_secoff[(qL, qR)]
        roff2, DRpad = dr_secoff[(qL, qR)]
        DL, DR = space.shapes[(qL, qR)]
        base, nr, ncc = vbb[(qL, qR)]
        for ai in range(nr):
            for bi in range(ncc):
                for mi in range(M0p // T):
                    a4t.append((doff + mi * T * DLpad + ai * T, DLpad,
                                M0 - mi * T, DL - ai * T))
                    b4t.append((roff2 + mi * T * DRpad + bi * T, DRpad,
                                M0 - mi * T, DR - bi * T))
                    sDt.append(base + ai * ncc + bi)
    order = np.argsort(np.asarray(sDt), kind="stable")
    nB = _pow2(len(a4t))
    a4 = np.zeros((4, nB), dtype=np.int32)
    a4[0, :] = -1
    b4 = np.zeros((4, nB), dtype=np.int32)
    b4[0, :] = -1
    sD = np.full(nB, nt2, dtype=np.int32)
    a4[:, :len(a4t)] = np.asarray(a4t, dtype=np.int32)[order].T
    b4[:, :len(b4t)] = np.asarray(b4t, dtype=np.int32)[order].T
    sD[:len(sDt)] = np.asarray(sDt, dtype=np.int32)[order]

    def exp_g(tasks, total):
        """Expand strided-row gather tasks to int32 arrays + out dims."""
        t = np.asarray(tasks, dtype=np.int64)
        nBg = _pow2(len(t))
        arr = np.zeros((4, nBg), dtype=np.int32)
        arr[0, :] = -1
        arr[0, :len(t)] = t[:, 0]
        arr[1, :len(t)] = t[:, 1]
        arr[2, :len(t)] = t[:, 2]
        arr[3, :len(t)] = t[:, 3]
        return arr, _pow2(total + 1)

    gl, dl_cap = exp_g(gtasks_l, dl_off)
    gr, dr_cap = exp_g(gtasks_r, dr_off)
    return {"gl": gl, "gr": gr, "dl_cap": dl_cap, "dr_cap": dr_cap,
            "a4": a4, "b4": b4, "sD": sD, "T": T, "nt2": nt2,
            "sig_idx": sig_idx}


# ---------------------------------------------------------------------------
# kernel K2 (diagonal) and its plain twin
# ---------------------------------------------------------------------------

def diag_tables(dstruct, device) -> Dict:
    """Device tables of a diag struct for K2 (and its twin)."""
    d = {k: torch.as_tensor(dstruct[k], device=device)
         for k in ("gl", "gr", "a4", "b4", "sD", "sig_idx")}
    d.update({k: dstruct[k] for k in ("dl_cap", "dr_cap", "T", "nt2")})
    return d


def _dl_build_twin(pool, g4, cap: int, T: int):
    """out[outoff + i] = pool[base + i*stride] for i < imax (the
    reference's _dl_build)."""
    g4 = g4.long()
    i = torch.arange(T, device=pool.device)[None, :]
    idx = g4[0][:, None] + i * g4[1][:, None]
    ok = (i < g4[2][:, None]) & (g4[0][:, None] >= 0)
    out = torch.zeros(cap, dtype=pool.dtype, device=pool.device)
    out[(g4[3][:, None] + i)[ok]] = pool[idx[ok]]
    return out


def diag_twin(lpool, rpool, d: Dict):
    """Plain PyTorch version of K2 (same signature as :func:`diag_exec`)."""
    T, nt2 = d["T"], d["nt2"]
    dl = _dl_build_twin(lpool, d["gl"], d["dl_cap"], T)
    dr = _dl_build_twin(rpool, d["gr"], d["dr_cap"], T)
    a4, b4, sD = d["a4"].long(), d["b4"].long(), d["sD"].long()
    tiles = torch.zeros((nt2 + 1, T, T), dtype=lpool.dtype,
                        device=lpool.device)
    for s in range(0, a4.shape[1], _TWIN_CHUNK):
        sl = slice(s, s + _TWIN_CHUNK)
        A = gather_tiles(dl, a4[0, sl], a4[1, sl], a4[2, sl], a4[3, sl], T)
        B = gather_tiles(dr, b4[0, sl], b4[1, sl], b4[2, sl], b4[3, sl], T)
        tiles.index_add_(0, sD[sl], torch.bmm(A.transpose(1, 2), B))
    return tiles.reshape(-1)[d["sig_idx"].long()]


def diag_exec(lpool, rpool, d: Dict):
    """Flat diagonal [sizb_p] of the effective Hamiltonian from the LW/RW
    slab pools (kernel K2); ``d`` from :func:`diag_tables`."""
    if lpool.device.type == "cpu":
        return diag_twin(lpool, rpool, d)
    if not lpool.is_cuda:
        raise ValueError(f"unsupported device {lpool.device}")
    dt, dev, T = lpool.dtype, lpool.device, d["T"]
    dl = torch.zeros(d["dl_cap"], dtype=dt, device=dev)
    dr = torch.zeros(d["dr_cap"], dtype=dt, device=dev)
    _kernels.call("b2t_dl_build", dt, lpool, d["gl"], d["gl"].shape[1], T,
                  dl)
    _kernels.call("b2t_dl_build", dt, rpool, d["gr"], d["gr"].shape[1], T,
                  dr)
    tiles = torch.zeros((d["nt2"] + 1) * T * T, dtype=dt, device=dev)
    _kernels.launch("K2_diag", "b2t_diag", dt, dl, dr, d["a4"], d["b4"],
                    d["sD"], d["a4"].shape[1], T, tiles)
    out = torch.empty(d["sig_idx"].shape[0], dtype=dt, device=dev)
    _kernels.call("b2t_gather", dt, tiles, d["sig_idx"], out.shape[0], out)
    return out


def execute_diag(dstruct, lpool, rpool):
    """Flat diagonal [sizb_p] on the pools' device (kernel K2)."""
    return diag_exec(lpool, rpool, diag_tables(dstruct, lpool.device))


# ---------------------------------------------------------------------------
# kernel K6 (perturbative-noise density matrix) and its plain twin
# rho_n[qb] += sum_m (W_m psi)(W_m psi)^T (reference
# src/dmrg/effective_hamiltonian.hpp:253 perturbative_noise)
# ---------------------------------------------------------------------------

# stage tasks per chunk of the plain version (bounds its temporaries)
_TWIN_NOISE_TASKS = 8192


class NoisePlan:
    """Per-(site, side) task structure of the device noise term, copied
    from the reference (block2_preview_tpu/ops/resident.py:913-1133)
    without the TPU task groups and the pre-materialised W tile pool.

    side='lw' (forward): x[qLb, qR] = LW[m][(qLb, qLk)] @ psi[(qLk, qR)],
    rho[qLb] += x x^T — W tiles read from the LW slab pool, psi tiles
    through the matvec's ``psi_idx``.  side='rw' (backward): y = x^T =
    RW[m] @ psi^T — the same kernel with the RW slab pool and a TRANSPOSED
    psi tile gather (built here), and rho[qRb] += y y^T.

    it [n, 10] int32: wbase, wstride, DB, pb, na, nk, nn, tb, rb, DK, as
    the reference's, except ``tb``: here the item's first tile in ONE x
    scratch pool of ``n_x`` tiles (the reference restarted it per task
    group).  cum1/cum2 [n+1]: stage-1 tasks (ai, ni, ki) and stage-2 tasks
    (ar, ac, ni) per item.  rho tiles: [nrho + 1, T, T]."""

    __slots__ = ("it", "cum1", "cum2", "nrho", "T", "sectors", "psi_idx",
                 "n_x", "flops", "_dev")

    def __init__(self, space, meta, group, side, T, psi_idx):
        self.T = T
        # psi tile layout bases (must match the psi_idx tile order)
        vbk = {}
        nv = 0
        for k in space.keys:
            r, c = space.shapes[k]
            if side == "rw":
                r, c = c, r
            vbk[k] = nv
            nv += (-(-r // T)) * (-(-c // T))
        if side == "rw" and psi_idx is None:
            # transposed psi tiles: tile grid over [DRk, DLk]
            sp = _pow2(space.size + 1)
            psi_idx = np.full((_pow2(nv + 1), T, T), sp, dtype=np.int32)
            for k in space.keys:
                off = space.offsets[k]
                r, c = space.shapes[k]   # psi block [r, c] row-major
                base = vbk[k]
                ncc = -(-r // T)         # cols of psi^T = r
                # element (i, j) of psi^T = psi[j, i] at off + j*c + i
                fr, fc = np.divmod(np.arange(c * r), r)   # psi^T coords
                tidx = ((base + (fr // T) * ncc + (fc // T)) * (T * T)
                        + (fr % T) * T + (fc % T))
                psi_idx.reshape(-1)[tidx] = off + fc * c + fr
        self.psi_idx = psi_idx

        dq_of = {}
        for gi, (dq, syms) in enumerate(meta.groups):
            for s in syms:
                dq_of[int(s)] = dq
        # rho sectors over the bond quantum qb; tiled [na, na] per sector
        rows = []       # wbase, wstride, DB, pb, DK, DN
        rkeys = []      # qb per row
        sec_dims = {}
        for m, (gm, jm) in sorted(meta.sym_pos.items()):
            dq = dq_of[m]
            sec = meta.sectors[gm]
            for k in space.keys:
                qLk, qRk = k
                if side == "lw":
                    qb = group.add(qLk, dq)
                    ent = sec.get(qb)
                    if ent is None:
                        continue
                    off, DB, DKw = ent
                    DK, DN = space.shapes[k]
                else:
                    # RW meta group dq is the left-cumulative MPO bond
                    # charge: qRk = qRb + dq (see host_ops), so
                    # qRb = qRk - dq
                    qb = group.sub(qRk, dq)
                    ent = sec.get(qb)
                    if ent is None:
                        continue
                    off, DB, DKw = ent
                    DN, DK = space.shapes[k]
                if DKw != DK:
                    continue
                rows.append((off + jm * DB * DKw, DKw, DB, vbk[k], DK,
                             DN))
                rkeys.append(qb)
                d = sec_dims.get(qb)
                if d is None or DB > d:
                    sec_dims[qb] = DB
        if not rows:
            raise RuntimeError("no noise items")
        # rho tile layout
        roff = {}
        nrho = 0
        for qb in sorted(sec_dims):
            na = -(-sec_dims[qb] // T)
            roff[qb] = (nrho, na, sec_dims[qb])
            nrho += na * na
        self.sectors = roff
        self.nrho = _pow2(nrho + 1) - 1

        n = len(rows)
        # x = W psi (DB x DK x DN) and x x^T (DB x DB x DN) per item
        self.flops = float(sum(2 * DB * DN * (DK + DB)
                               for (_, _, DB, _, DK, DN) in rows))
        itf = np.zeros((n, 10), dtype=np.int64)
        for i, ((wb, ws, DB, pb, DK, DN), qb) in enumerate(
                zip(rows, rkeys)):
            itf[i] = (wb, ws, DB, pb, -(-DB // T), -(-DK // T),
                      -(-DN // T), 0, roff[qb][0], DK)
        na_a, nk_a, nn_a = itf[:, 4], itf[:, 5], itf[:, 6]
        nx_a = na_a * nn_a
        itf[:, 7] = np.concatenate([[0], np.cumsum(nx_a)[:-1]])
        self.n_x = int(nx_a.sum())
        c1 = np.concatenate([[0], np.cumsum(nx_a * nk_a)])
        c2 = np.concatenate([[0], np.cumsum(na_a * na_a * nn_a)])
        n_q = _pow2(n)
        it32 = np.zeros((n_q, 10), dtype=np.int32)
        it32[:n] = itf
        it32[n:, 4:7] = 1
        self.it = it32
        self.cum1 = np.concatenate(
            [c1, np.full(n_q - n, c1[-1])]).astype(np.int32)
        self.cum2 = np.concatenate(
            [c2, np.full(n_q - n, c2[-1])]).astype(np.int32)
        self._dev = {}

    def tables(self, device) -> Dict:
        """Device tables for K6 (and its twin), cached per device.
        Derived here: ``cumr`` [n+1], prefix sums of the stage-2 units
        na * na of the live items (K6's x kernel runs one block per x
        tile, ``n_x`` of them)."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            it = self.it.astype(np.int64)
            live = np.diff(self.cum1.astype(np.int64)) > 0
            cumr = np.concatenate([[0], np.cumsum(
                np.where(live, it[:, 4] * it[:, 4], 0))])
            cumx = np.concatenate([[0], np.cumsum(
                np.where(live, it[:, 4] * it[:, 6], 0))])

            def i32(a):
                return torch.as_tensor(
                    np.ascontiguousarray(a, dtype=np.int32), device=device)

            d = {"it": i32(self.it), "cum1": i32(self.cum1),
                 "cum2": i32(self.cum2), "cumx": i32(cumx),
                 "cumr": i32(cumr), "n_r": int(cumr[-1]),
                 "psi_idx": i32(self.psi_idx.reshape(-1)),
                 "n_x": self.n_x, "nrho": self.nrho}
            self._dev[key] = d
        return d

    def unpack(self, rho_tiles: np.ndarray):
        """Tiled rho pool [nrho + 1, T, T] -> {qb: dense [D, D]} (f64)."""
        T = self.T
        out = {}
        for qb, (base, na, D) in self.sectors.items():
            blk = rho_tiles[base:base + na * na] \
                .reshape(na, na, T, T).transpose(0, 2, 1, 3) \
                .reshape(na * T, na * T)[:D, :D]
            out[qb] = np.asarray(blk, dtype=np.float64)
        return out


def noise_twin(xp, wpool, d: Dict, T: int):
    """Plain PyTorch version of K6 (same signature as :func:`noise_exec`):
    stage 1 forms the x tiles into the scratch pool, stage 2 adds their
    outer products into the rho tiles."""
    it = d["it"].long()
    cum1, cum2 = d["cum1"].long(), d["cum2"].long()
    pp = xp[d["psi_idx"].long()].reshape(-1, T, T)
    x = torch.zeros((d["n_x"] + 1, T, T), dtype=xp.dtype, device=xp.device)
    tot1 = int(cum1[-1])
    for s in range(0, tot1, _TWIN_NOISE_TASKS):
        item, o = _locate(cum1, s, min(s + _TWIN_NOISE_TASKS, tot1))
        f = it[item]
        nk, nn = f[:, 5], f[:, 6]
        ai, ni, ki = o // (nn * nk), (o // nk) % nn, o % nk
        W = gather_tiles(wpool, f[:, 0] + ai * T * f[:, 1] + ki * T,
                         f[:, 1], f[:, 2] - ai * T, f[:, 1] - ki * T, T)
        x.index_add_(0, f[:, 7] + ai * nn + ni,
                     torch.bmm(W, pp[f[:, 3] + ki * nn + ni]))
    rho = torch.zeros((d["nrho"] + 1, T, T), dtype=xp.dtype,
                      device=xp.device)
    tot2 = int(cum2[-1])
    for s in range(0, tot2, _TWIN_NOISE_TASKS):
        item, o = _locate(cum2, s, min(s + _TWIN_NOISE_TASKS, tot2))
        f = it[item]
        na, nn = f[:, 4], f[:, 6]
        ar, ac, ni = o // (na * nn), (o // nn) % na, o % nn
        rho.index_add_(0, f[:, 8] + ar * na + ac,
                       torch.bmm(x[f[:, 7] + ar * nn + ni],
                                 x[f[:, 7] + ac * nn + ni].transpose(1, 2)))
    return rho


def noise_exec(xp, wpool, d: Dict, T: int):
    """Noise density-matrix tiles [nrho + 1, T, T] (kernel K6) from the
    padded flat psi ``xp`` [size_p + 1] (zero last slot) and the LW (or RW)
    slab pool; ``d`` from :meth:`NoisePlan.tables`."""
    if xp.device.type == "cpu":
        return noise_twin(xp, wpool, d, T)
    if not xp.is_cuda:
        raise ValueError(f"unsupported device {xp.device}")
    dt, dev = xp.dtype, xp.device
    x = torch.empty(max(d["n_x"], 1) * T * T, dtype=dt, device=dev)
    rho = torch.zeros((d["nrho"] + 1) * T * T, dtype=dt, device=dev)
    _kernels.call("b2t_noise_x", dt, xp, wpool, d["psi_idx"], d["it"],
                  d["cumx"], d["it"].shape[0], d["n_x"], T, x)
    _kernels.launch("K6_noise", "b2t_noise_rho", dt, x, d["it"], d["cumr"],
                    d["it"].shape[0], d["n_r"], T, rho)
    return rho.reshape(-1, T, T)


# ---------------------------------------------------------------------------
# per-site orchestration
# ---------------------------------------------------------------------------

def _mix_sig(meta_env, entries, fused, fused_ket, active, active_ket,
             comp_target, comp_target_ket, out_bond_dqs):
    """Validation signature for a cached mix plan: env pool layout + every
    non-env input (MPO entry content, fused bases, active sets, targets,
    output bond charges)."""
    return hash((meta_env.signature(),
                 _plan_args_sig(entries, fused, fused_ket, active,
                                active_ket, comp_target, comp_target_ket),
                 tuple(out_bond_dqs)))


def build_mix_plan(*args, **kw):
    """v3 plan content in the v4 execution form; None when the site has
    no effective operators.  A plan the v4 form cannot take raises: the
    reference runs such plans through mix v3, which is not on this
    slice."""
    p3 = build_mix_plan_v3(*args, **kw)
    if p3 is None:
        return None
    p4 = plan_v4(p3)
    if p4 is None:
        raise RuntimeError("mix plan has no v4 form (v3 execution is not "
                           "ported)")
    return p4


class ResidentSite:
    """Device-resident two-site effective-Hamiltonian step.

    Host-side structures (mix plans, matvec structs, diag structs) are
    cached across sweeps in ``caches`` (sub-dicts 'mix', 'v2', 'diag'),
    keyed by site and validated against content signatures.  An empty
    mix plan raises RuntimeError; nothing falls back to the host.

    Reference analog: MovingEnvironment::eff_ham
    (src/dmrg/moving_environment.hpp:2063) + EffectiveHamiltonian::eigs
    (src/dmrg/effective_hamiltonian.hpp:471).
    """

    def __init__(self, me, eff, device, dtype=np.float64, caches=None):
        self.me = me
        self.eff = eff
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        torch_dtype(dtype)
        t = eff.t
        mpo, g = me.mpo, me.mpo.group
        if caches is None:
            caches = {}
        for k in ("mix", "v2", "diag"):
            caches.setdefault(k, {})
        self.caches = caches

        tk = eff.target
        tb = me.bra.info.target if eff.mixed else tk
        flb, frb = eff.bra_space.fl, eff.bra_space.fr
        flk, frk = eff.ket_space.fl, eff.ket_space.fr
        active_lb = {qL for (qL, _) in eff.bra_space.keys}
        active_rb = {qR for (_, qR) in eff.bra_space.keys}
        active_lk = {qL for (qL, _) in eff.ket_space.keys}
        active_rk = {qR for (_, qR) in eff.ket_space.keys}

        meta_l, pool_l = me.device_pool("l", t)
        meta_r, pool_r = me.device_pool("r", t + 2)

        def plan(key, build, sig):
            ent = caches["mix"].get(key)
            if ent is not None and ent[0] == sig:
                return ent[1]
            p = build()
            caches["mix"][key] = (sig, p)
            return p

        sig_l = _mix_sig(meta_l, mpo.tensors[t], flb, flk, active_lb,
                         active_lk, None, None, mpo.bond_dqs[t + 1])
        pl = plan((t, "lw"), lambda: build_mix_plan(
            meta_l, mpo.tensors[t], mpo.site_quanta[t], flb,
            bond_is_first=True, join_on_input=True, group=g,
            out_bond_dqs=mpo.bond_dqs[t + 1], active=active_lb,
            fused_ket=flk, active_ket=active_lk), sig_l)
        sig_r = _mix_sig(meta_r, mpo.tensors[t + 1], frb, frk, active_rb,
                         active_rk, tb, tk, mpo.bond_dqs[t + 1])
        pr = plan((t, "rw"), lambda: build_mix_plan(
            meta_r, mpo.tensors[t + 1], mpo.site_quanta[t + 1], frb,
            bond_is_first=False, join_on_input=False, group=g,
            out_bond_dqs=mpo.bond_dqs[t + 1], comp_target=tb,
            active=active_rb, fused_ket=frk, comp_target_ket=tk,
            active_ket=active_rk), sig_r)
        if pl is None or pr is None:
            raise RuntimeError(f"empty mix plan at site {t} "
                               "(no effective operators)")
        self.pl, self.pr = pl, pr
        # env pools are consumed here; the mix returns new LW/RW pools
        # (zero sentinel last) on the device
        self.lw_pool = execute_mix_v4(pl, pool_l)
        self.rw_pool = execute_mix_v4(pr, pool_r)
        self.ex = MatvecV2(eff.ket_space, pl.meta_out, pr.meta_out, g,
                           tb, dtype=self.dtype, cache=caches["v2"],
                           cache_key=(type(eff).__name__, t),
                           bra_space=eff.bra_space)
        self.size = eff.size

    # -- LW/RW download (tests; not on the sweep's path) --------------------
    def host_ops(self, which: str):
        """Download + unpack one side's assembled operators as
        {sym -> {(qb, qk) -> ndarray}} on the host; counts one
        ``host_ops_downloads`` on the environment."""
        meta, pool = ((self.pl.meta_out, self.lw_pool) if which == "lw"
                      else (self.pr.meta_out, self.rw_pool))
        flat = pool.cpu().numpy()
        self.me.host_ops_downloads += 1
        g = self.me.mpo.group
        out: Dict[int, Dict] = {}
        for gi, (dq, syms) in enumerate(meta.groups):
            for qb, (off, db, dk) in meta.sectors[gi].items():
                # LW: qLb = qLk + dq; RW (complemented right half):
                # qRk = qRb + dq (group dq is the left-cumulative MPO
                # bond charge in both metas)
                qk = g.sub(qb, dq) if which == "lw" else g.add(qb, dq)
                for j, s in enumerate(syms):
                    blk = flat[off + j * db * dk:off + (j + 1) * db * dk]
                    if not blk.any():
                        continue
                    out.setdefault(int(s), {})[(qb, qk)] = \
                        blk.reshape(db, dk)
        return out

    # ------------------------------------------------------------------
    def diagonal_device(self):
        key = ("diag", self.eff.t)
        s = self.ex.struct
        sig = hash((self.pl.meta_out.signature(),
                    self.pr.meta_out.signature(), s["T"], s["nt2"]))
        ent = self.caches["diag"].get(key)
        if ent is not None and ent[0] == sig:
            ds = ent[1]
        else:
            ds = build_diag_struct(self.eff.ket_space, self.pl.meta_out,
                                   self.pr.meta_out, s["T"], s["nt2"],
                                   s["sig_idx"])
            self.caches["diag"][key] = (sig, ds)
        if ds is None:
            raise RuntimeError("no diagonal contributions")
        return execute_diag(ds, self.lw_pool, self.rw_pool)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """One sigma matvec of a host vector (kernel K1), on the host."""
        xp = torch.as_tensor(self.ex.pad(x), device=self.device)
        y = self.ex.matvec_device(xp, self.lw_pool, self.rw_pool)
        return y.cpu().numpy().astype(np.float64)[:self.size]

    def solve_ground_state(self, x0: np.ndarray, conv_thrd: float = 1e-8,
                           max_iter: int = 100, max_subspace: int = 20):
        """On-device Davidson; returns (theta, x[host], n_iter)."""
        s = self.ex.struct
        d = self.ex.to_device(self.device)
        dg = self.diagonal_device()
        # diag [sizb_p] -> [size_p + 1]; pad slots are exact zeros
        diag_p = torch.zeros(s["size_p"] + 1, dtype=dg.dtype,
                             device=self.device)
        diag_p[:dg.shape[0]] = dg
        xp0 = torch.as_tensor(self.ex.pad(x0), device=self.device)

        def mv(v):
            return mv_exec(v, self.lw_pool, self.rw_pool, d, s["T"],
                           s["nt2"])

        th, xv, it = davidson(mv, diag_p, xp0, conv_thrd=conv_thrd,
                              max_iter=max_iter, max_subspace=max_subspace)
        return th, xv.cpu().numpy().astype(np.float64)[:self.size], it

    def noise_rho(self, x: np.ndarray, forward: bool):
        """Perturbative-noise density matrix {q_bond: [D, D]} (host, f64)
        for the converged wavefunction x (host flat), from the LW (forward)
        or RW (backward) slab pool on the device (kernel K6)."""
        side = "lw" if forward else "rw"
        meta = self.pl.meta_out if forward else self.pr.meta_out
        s = self.ex.struct
        key = (self.eff.t, side)
        sig = hash((meta.signature(), tuple(self.eff.ket_space.keys),
                    tuple(sorted(self.eff.ket_space.shapes.items())),
                    s["T"]))
        cache = self.caches.setdefault("noise", {})
        ent = cache.get(key)
        if ent is not None and ent[0] == sig:
            plan = ent[1]
        else:
            plan = NoisePlan(self.eff.ket_space, meta, self.me.mpo.group,
                             side, s["T"], s["psi_idx"] if forward else None)
            cache[key] = (sig, plan)
        xp = torch.as_tensor(self.ex.pad(x), device=self.device)
        pool = self.lw_pool if forward else self.rw_pool
        rho = noise_exec(xp, pool, plan.tables(self.device), plan.T)
        return plan.unpack(rho.cpu().numpy())
