"""Device-resident two-site effective-Hamiltonian step (torch) — kernel K2.

Port of block2_preview_tpu/ops/resident.py:594-711, 1159-1472 for the
SZ ground-state path.  Per center site t:

  host env maps --pack--> env slab pools (device)
  --execute_mix_v4 (K3 + K4)--> LW/RW slab pools (device)
  --execute_diag (K2)--> diagonal     --davidson around K1--> psi (host)

``build_diag_struct`` is copied from the reference so the diagonal task
tables are byte-identical.  Environment blocking and the perturbative
noise term stay on the host in this slice: ``host_ops`` downloads the
assembled LW/RW operators for the host noise term, as the reference does
when its device noise plan does not apply.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from block2_preview_tpu.ops.blocking import _plan_args_sig

from . import _kernels
from .device_davidson import davidson
from .mixv3 import build_mix_plan_v3
from .mixv4 import execute_mix_v4, plan_v4
from .stacked import StackedMeta, _pow2, env_pool
from .tilev2 import MatvecV2, gather_tiles, mv_exec
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

        meta_l, pool_l = self._env_pool("l", t)
        meta_r, pool_r = self._env_pool("r", t + 2)

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

    def _env_pool(self, side: str, bond: int):
        """(meta, device pool) of a bond's host environment map."""
        envs = self.me.left_envs if side == "l" else self.me.right_envs
        env = envs[bond]
        if env is None:
            raise RuntimeError(f"no environment at bond {bond} ({side})")
        meta, pool = env_pool(env, self.me.mpo.bond_dqs[bond], self.dtype)
        return meta, torch.as_tensor(pool, device=self.device)

    # -- LW/RW download for the host noise term ----------------------------
    def host_ops(self, which: str):
        """Download + unpack one side's assembled operators as
        {sym -> {(qb, qk) -> ndarray}} on the host (noise term)."""
        meta, pool = ((self.pl.meta_out, self.lw_pool) if which == "lw"
                      else (self.pr.meta_out, self.rw_pool))
        flat = pool.cpu().numpy()
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
