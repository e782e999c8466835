"""Device-resident two-site effective-Hamiltonian step (torch) — kernels
K2 (diagonal), K6 (noise density matrix), K15 (mix v2) and K16 (slab
matvec).

Port of block2_preview_tpu/ops/resident.py:56-592, 853-1133, 1136-1472
for the SZ ground-state path.  Per center site t:

  env slab pools on the device (MovingEnvironment.device_pool)
  --the mix engine B2TPU_MIX names--> LW/RW slab pools (device)
  --execute_diag (K2)--> diagonal     --davidson around K1--> psi (host)
  --noise_rho (K6, noise > 0)--> {qb: rho_noise [D, D]} (host)

The mix engine follows the reference's ``_mix_ver`` (:1151-1156): 4 (the
default) runs mix v4 (``ops/mixv4.py``, K3 + K4) and, for a plan that
``plan_v4`` cannot take, mix v3; 3 runs mix v3 (``ops/mixv3.py``, K13 +
K14); anything else runs the v2 scatter mix of this module
(:func:`build_mix_plan` + :func:`execute_mix`, K15).  All three give the
same LW/RW pools.

Only the center wavefunction, the initial guess, the small noise density
matrix and scalars cross between host and device.  ``MixPlan``,
``build_mix_plan``, ``SlabMatvec._build``, ``build_diag_struct`` and
``NoisePlan`` are copied from the reference so their tables equal it
(``build_mix_plan``'s per-contribution loops as array code).
``SlabMatvec`` (the v1 resident sigma matvec, K16) is run by no sweep, as
in the reference.  ``host_ops`` (a download of assembled LW/RW, for
tests) is not on the sweep's path; each call counts one
``host_ops_downloads``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import _kernels, chain_mv
from .blocking import _plan_args_sig
from .csr import w_nonzero as _w_nonzero
from .device_davidson import davidson
from .mixv3 import MixPlanV3, _build_tab, build_mix_plan_v3, execute_mix_v3
from .mixv4 import MixPlanV4, execute_mix_v4, plan_v4
from .stacked import (StackedMeta, _cap_class, _pow2, check_windows,
                      core_tables, gather_device, gather_plain)
from .tiled import _TILE_CFG, pick_tile
from .tilev2 import (MatvecV2, _locate, gather_tiles, mv_exec,
                     mv_exec_sharded)
from ..runtime import torch_dtype

# diag tile tasks per chunk of the plain version
_TWIN_CHUNK = 4096


# ---------------------------------------------------------------------------
# mix v2: plan (host) and kernel K15 with its plain twin
# ---------------------------------------------------------------------------

# the reference's scan depth per launch and tasks per scan step; they shape
# the plan's [n_launch, _MIX_SCAN, 7, _MIX_B] table (its TPU watchdog
# bound), which the port keeps as it is; K15 runs every live task of it in
# one launch, through tables grouped by output window (k15_tables)
_MIX_SCAN = 8
_MIX_B = 4096


class MixPlan:
    """A v2 mix plan: the reference's fields, and ``_dev``, the K15
    tables cached with it (host under "k15", device under ("k15", device,
    dtype))."""
    __slots__ = ("meta_out", "T", "ncap_out", "s", "coef", "n_launch",
                 "dims_hint", "_dev")


def build_mix_plan(meta_env: StackedMeta, entries, quanta,
                   fused, bond_is_first: bool, join_on_input: bool,
                   group, out_bond_dqs, comp_target=None,
                   active=None, fused_ket=None, comp_target_ket=None,
                   active_ket=None, T: Optional[int] = None
                   ) -> Optional[MixPlan]:
    """Plan the LW (join_on_input) or RW assembly from a stacked env pool
    as T x T scatter tile tasks (the reference's v2 builder,
    block2_preview_tpu/ops/resident.py:102-266; its per-contribution
    Python loops are array code here, the tables unchanged).  Row j of
    ``s`` holds ebase, estr, ermax, ecmax, obase, orstr, ocstr per task,
    sorted by obase; ``coef`` the task's MPO coefficient (complex for
    complex MPO entries)."""
    g = group
    fused_k = fused if fused_ket is None else fused_ket
    ct_k = comp_target if comp_target_ket is None else comp_target_ket
    act_k = active if active_ket is None else active_ket
    tab_b = _build_tab(fused, quanta, comp_target, active, bond_is_first, g)
    tab_k = _build_tab(fused_k, quanta, ct_k, act_k, bond_is_first, g)

    # entries keyed by joined symbol, in the reference's order
    ent_by: Dict[int, list] = {}
    iscpx = False
    for (i, o), w in sorted(entries.items()):
        jsym = i if join_on_input else o
        osym = o if join_on_input else i
        if np.iscomplexobj(w):
            iscpx = True
        for pb, pk in zip(*_w_nonzero(w)):
            ent_by.setdefault(jsym, []).append(
                (osym, int(pb), int(pk), w[pb, pk]))
    if not ent_by:
        return None
    cdt = np.complex128 if iscpx else np.float64
    ents = {}
    for s, lst in ent_by.items():
        n = len(lst)
        ents[s] = tuple(np.fromiter((e[i] for e in lst), dt, n)
                        for i, dt in enumerate((np.int64, np.int64,
                                                np.int64, cdt)))

    # fused sectors as integer codes; tab lookups per (bond sector, phys)
    nphys = len(quanta)
    fq_b_of, fq_k_of = list(fused.maps), list(fused_k.maps)
    fq_b = {q: i for i, q in enumerate(fq_b_of)}
    fq_k = {q: i for i, q in enumerate(fq_k_of)}

    def lookup(tab, codes, q):
        """[4, nphys]: valid, fused code, offset, stride of (q, p)."""
        out = np.zeros((4, nphys), np.int64)
        for p in range(nphys):
            v = tab.get((q, p))
            if v is not None:
                out[:, p] = (1, codes[v[0]], v[1], v[2])
        return out

    # contributions in the reference's order: group, symbol, env sector,
    # entry
    names = ("ebase", "db", "dk", "osym", "qb", "ob", "sb", "qk", "ok",
             "sk", "cf")
    cols = {k: [] for k in names}
    for gi, (dq_g, syms) in enumerate(meta_env.groups):
        sec = list(meta_env.sectors[gi].items())
        if not sec:
            continue
        eoff, db, dk = (np.fromiter((v[i] for _, v in sec), np.int64,
                                    len(sec)) for i in range(3))
        lb = np.stack([lookup(tab_b, fq_b, q) for q, _ in sec], axis=1)
        lk = np.stack([lookup(tab_k, fq_k, g.sub(q, dq_g)) for q, _ in sec],
                      axis=1)
        for j, s in enumerate(syms):
            e = ents.get(int(s))
            if e is None:
                continue
            osym, pb, pk, cf = e
            si, ei = np.nonzero((lb[0][:, pb] > 0) & (lk[0][:, pk] > 0))
            if len(si) == 0:
                continue
            pbe, pke = pb[ei], pk[ei]
            for k, v in zip(names, (
                    eoff[si] + j * db[si] * dk[si], db[si], dk[si], osym[ei],
                    lb[1][si, pbe], lb[2][si, pbe], lb[3][si, pbe],
                    lk[1][si, pke], lk[2][si, pke], lk[3][si, pke], cf[ei])):
                cols[k].append(v)
    if not cols["ebase"]:
        return None
    c = {k: np.concatenate(v) for k, v in cols.items()}
    nc = len(c["ebase"])

    # output sectors (osym, qLb) -> (DLb, DLk), from the first
    # contribution of each
    okey = c["osym"] * len(fq_b_of) + c["qb"]
    _, first, inv = np.unique(okey, return_index=True, return_inverse=True)
    out_sym_sectors: Dict[int, Dict] = {}
    for f in first:
        qLb, qLk = fq_b_of[c["qb"][f]], fq_k_of[c["qk"][f]]
        out_sym_sectors.setdefault(int(c["osym"][f]), {})[qLb] = (
            fused.info[qLb], fused_k.info[qLk])
    meta_out = StackedMeta.from_bond(out_bond_dqs, out_sym_sectors)
    dims = np.stack([c["db"], c["dk"]], axis=1).ravel().tolist()
    if T is None:
        T = pick_tile(np.asarray(dims))

    # output slab base: ooff + jo*DLb*DLk + ob*DLk + ok (row stride DLk)
    u_base = np.empty(len(first), np.int64)
    u_dlk = np.empty(len(first), np.int64)
    for u, f in enumerate(first):
        go, jo = meta_out.sym_pos[int(c["osym"][f])]
        ooff, DLb, DLk = meta_out.sectors[go][fq_b_of[c["qb"][f]]]
        u_base[u] = ooff + jo * DLb * DLk
        u_dlk[u] = DLk
    inv = inv.reshape(-1)
    dlk_a = u_dlk[inv]
    obase_a = u_base[inv] + c["ob"] * dlk_a + c["ok"]
    ebase_a, db_a, dk_a = c["ebase"], c["db"], c["dk"]

    # tile expansion: (ri, ci) grid over (db, dk)
    nr = -(-db_a // T)
    ncc = -(-dk_a // T)
    per = nr * ncc
    tot = int(per.sum())
    it = np.repeat(np.arange(nc), per)
    cum = np.concatenate([[0], np.cumsum(per)[:-1]])
    o = np.arange(tot) - np.repeat(cum, per)
    ncc_i = ncc[it]
    ri = o // ncc_i
    ci = o % ncc_i
    t_eb = ebase_a[it] + ri * T * dk_a[it] + ci * T
    t_es = dk_a[it]
    t_rm = db_a[it] - ri * T
    t_cm = dk_a[it] - ci * T
    t_ors = c["sb"][it] * dlk_a[it]
    t_ocs = c["sk"][it]
    t_ob = obase_a[it] + ri * T * t_ors + ci * T * t_ocs

    # sort by output base for scatter locality
    order = np.argsort(t_ob, kind="stable")
    B = _MIX_B
    n_launch = -(-max(tot, 1) // (B * _MIX_SCAN))
    cap = n_launch * B * _MIX_SCAN
    s_arr = np.zeros((7, cap), dtype=np.int32)
    s_arr[4, :] = -1
    cf_arr = np.zeros(cap, dtype=cdt)
    for row, a in enumerate((t_eb, t_es, t_rm, t_cm, t_ob, t_ors, t_ocs)):
        s_arr[row, :tot] = a[order]
    cf_arr[:tot] = c["cf"][it][order]

    plan = MixPlan()
    plan.meta_out = meta_out
    plan.T = T
    plan.ncap_out = _cap_class(meta_out.total + 1)
    plan.s = s_arr.reshape(7, n_launch, _MIX_SCAN, B).transpose(1, 2, 0, 3)
    plan.coef = cf_arr.reshape(n_launch, _MIX_SCAN, B)
    plan.n_launch = n_launch
    plan.dims_hint = dims
    plan._dev = {}
    return plan


def k15_tables(plan: MixPlan) -> Dict:
    """K15's host tables of a v2 plan, built once and cached in
    ``plan._dev["k15"]``: the strided mix core's
    (:func:`stacked.core_tables`) with one output block a distinct obase
    of the live tasks (obase >= 0; padded tasks dropped), ``blk`` [nb, 6]
    = (obase, orstr, min(ermax, T), min(ecmax, T), ocstr, estr), and its
    terms the tasks' (ebase, coef) in the plan's order.  The plan sorts
    its tasks by obase (stably), so a block is a run of its table: no
    sort.  Raises ValueError where the live tasks are out of obase order,
    where the tasks of one obase disagree on (orstr, ocstr, ermax, ecmax,
    estr), or where two windows share an output element or reach the
    sentinel slot ``ncap_out`` (:func:`stacked.check_windows`).  Adds
    ``n_tasks``, ``seconds`` (the build) and ``seconds_windows`` (its
    disjointness check and the core's tables)."""
    h = plan._dev.get("k15")
    if h is not None:
        return h
    t0 = time.perf_counter()
    s = np.asarray(plan.s)

    def row(r):
        """Row r of the task table, every task in the plan's order."""
        return s[:, :, r, :].reshape(-1)

    ob = row(4)
    live = np.flatnonzero((ob >= 0) & (row(2) > 0) & (row(3) > 0))
    n = len(live)
    # the plan's live tasks are its first n (build_mix_plan pads after
    # them): slice them out rather than gather
    pick = ((lambda a: a[:n]) if n and live[-1] == n - 1 else
            (lambda a: a[live]))
    ob = pick(ob)
    if (ob[1:] < ob[:-1]).any():
        raise ValueError("the v2 plan's live tasks are not in obase order")
    # (obase, orstr, ermax, ecmax, ocstr, estr): a block is a run of one
    # obase, whose tasks must agree on the rest
    cols = [ob] + [pick(row(r)) for r in (5, 2, 3, 6, 1)]
    new = np.ones(n, bool)
    new[1:] = ob[1:] != ob[:-1]
    differ = np.zeros(max(n - 1, 0), bool)
    for c in cols[1:]:
        differ |= c[1:] != c[:-1]
    if (differ & ~new[1:]).any():
        raise ValueError("the tasks of one output window disagree on its "
                         "strides or shape")
    first = np.flatnonzero(new)
    blk = np.stack([c[first] for c in cols], 1).astype(np.int64)
    blk[:, 2:4] = np.minimum(blk[:, 2:4], plan.T)
    t1 = time.perf_counter()
    check_windows(blk, plan.ncap_out)
    h = core_tables(blk, np.append(first, n), pick(row(0)),
                    pick(np.asarray(plan.coef).reshape(-1)))
    h.update(n_tasks=n, seconds=time.perf_counter() - t0,
             seconds_windows=time.perf_counter() - t1)
    plan._dev["k15"] = h
    return h


def mix_tables(plan: MixPlan, device, dtype) -> Dict:
    """K15's tables (its plain version's too) on ``device``, the
    coefficients in ``dtype``: :func:`k15_tables` through
    :func:`stacked.gather_device`, cached on the plan for each device and
    type, so they go up once a plan."""
    if np.iscomplexobj(plan.coef) or dtype.is_complex:
        raise TypeError("mix v2 takes real plans and types only (the "
                        "reference's execute_mix drops imaginary parts)")
    key = ("k15", str(device), dtype)
    d = plan._dev.get(key)
    if d is None:
        d = plan._dev[key] = gather_device(k15_tables(plan), device, dtype,
                                           "K15's")
    return d


def mix_v2_twin(out, epool, d: Dict):
    """Plain PyTorch version of K15 (same signature as
    :func:`mix_v2_exec`) on K15's own tables: :func:`stacked.gather_plain`
    over every output window, its tasks' tiles in the plan's order.
    Padded tasks are not in the tables, so the sentinel slot stays as it
    was (the reference's _mix_exec)."""
    return gather_plain(epool, d, out, 0)


def mix_v2_exec(out, epool, d: Dict):
    """Mix v2 (kernel K15): adds every live task of the plan into the slab
    pool ``out`` (zero-initialised by the caller) in place, each output
    window summed by one lane an element; ``d`` from :func:`mix_tables`.
    CPU tensors run :func:`mix_v2_twin`."""
    if epool.device.type == "cpu":
        return mix_v2_twin(out, epool, d)
    if not epool.is_cuda:
        raise ValueError(f"unsupported device {epool.device}")
    _kernels.launch("K15_mix_v2", "b2t_mix_v2", epool.dtype, epool,
                    d["units"], d["n_units"], d["blk"], d["bstart"], d["ts"],
                    d["tc"], out)
    return out


def execute_mix(plan: MixPlan, epool):
    """LW/RW slab pool [ncap_out + 1] (zero sentinel last) from the env
    slab pool ``epool`` on its device and in its dtype, by a v2 plan —
    what the reference's execute_mix returns — in one K15 launch over all
    live tasks."""
    d = mix_tables(plan, epool.device, epool.dtype)
    out = torch.zeros(plan.ncap_out + 1, dtype=epool.dtype,
                      device=epool.device)
    return mix_v2_exec(out, epool, d)


# ---------------------------------------------------------------------------
# v1 slab matvec (SlabMatvec): struct (host) and kernel K16 with its twin
# sigma[ok] += LW[m][lk] @ psi[pk] @ RW[m][rk]^T over the row-major slab
# pools: the twin on the struct's L/R tiles, K16 on K1's chain core over
# one item a triple (k16_items)
# ---------------------------------------------------------------------------

# stage tasks per chunk of the plain version (bounds its temporaries)
_TWIN_SLAB_TASKS = 8192


def slab_mv_twin(xp, lpool, rpool, d: Dict, T: int, nt1: int, nt2: int):
    """Plain PyTorch version of K16 (same signature as
    :func:`slab_mv_exec`): stage 1 sums L @ psi tiles into tmp tile
    ``toff[g] + s1``, stage 2 sums tmp @ R^T into sigma tile ``s2``; the
    sigma tiles are flattened through ``sig_idx``."""
    l4, r4, toff = d["l4"].long(), d["r4"].long(), d["toff"].long()
    pa, s1, ta, s2 = (d[k].long() for k in ("pa", "s1", "ta", "s2"))
    B = pa.shape[1]
    pp = xp[d["psi_idx"].long()].reshape(-1, T, T)
    tmp = torch.zeros((d["ntmp"] + 1, T, T), dtype=xp.dtype,
                      device=xp.device)
    sig = torch.zeros((nt2 + 1, T, T), dtype=xp.dtype, device=xp.device)
    for stage, (seg, nseg, t4, pool) in enumerate(((s1, nt1, l4, lpool),
                                                   (s2, nt2, r4, rpool))):
        live = torch.nonzero((seg < nseg).reshape(-1)).squeeze(1)
        for k in range(0, len(live), _TWIN_SLAB_TASKS):
            ids = live[k:k + _TWIN_SLAB_TASKS]
            g, b = ids // B, ids % B
            W = gather_tiles(pool, t4[g, 0, b], t4[g, 1, b], t4[g, 2, b],
                             t4[g, 3, b], T)
            if stage == 0:
                tmp.index_add_(0, toff[g] + s1[g, b],
                               torch.bmm(W, pp[pa[g, b]]))
            else:
                sig.index_add_(0, s2[g, b], torch.bmm(
                    tmp[toff[g] + ta[g, b]], W.transpose(1, 2)))
    return sig.reshape(-1)[d["sig_idx"].long()]


def slab_mv_exec(xp, lpool, rpool, d: Dict, T: int, nt1: int, nt2: int):
    """Slab sigma matvec (kernel K16): flat sigma [sizb_p] from the padded
    flat psi ``xp`` [size_p + 1] (zero last slot) and the LW/RW slab
    pools; ``d`` from :meth:`SlabMatvec.to_device`.  CPU tensors run
    :func:`slab_mv_twin`; CUDA tensors launch K16 (the chain core over
    ``d["chain"]``, sigma written at its flat offsets: no tile pool or
    gather) or raise."""
    if xp.device.type == "cpu":
        return slab_mv_twin(xp, lpool, rpool, d, T, nt1, nt2)
    if not xp.is_cuda:
        raise ValueError(f"unsupported device {xp.device}")
    c = d["chain"]
    out = torch.zeros(d["sig_idx"].shape[0], dtype=xp.dtype,
                      device=xp.device)
    _kernels.launch("K16_slab_matvec", "b2t_slab_mv", xp.dtype, xp, lpool,
                    rpool, c["items"], c["ent"], c["ck"], c["n_chunks"],
                    chain_mv.TILE, out)
    return out


def k16_items(struct: Dict) -> np.ndarray:
    """K16's items in the chain core's fields (``ops/chain_mv.py``), one
    row a triple of ``struct`` (:meth:`SlabMatvec._build`) in the order
    it was built: L offset, DLb, DLk, the flat psi offset of the ket
    sector, DRk, R offset, DRb, the flat sigma offset of the bra sector
    (int64 [n_triples, 8]).

    Read from the struct's task tables alone, so a struct made elsewhere
    (``interop.slab_matvec``) gives them too.  A triple's tasks touch the
    tmp tiles (ai, ni) of its group.  The stage-1 task of a tile at ki = 0
    is the one whose L column bound equals its stride (DLk): its L base
    is the row band's (``lbase + ai T DLk``), its row bound ``DLb - ai T``
    and its psi tile ``pb + ni``.  The tile's stage-2 tasks carry ni as
    ``(stride - cmax) / T`` of their R tiles, and the one with the lowest R
    base has pi = 0: ``rbase + ni T``, row bound DRb, sigma tile
    ``ob + ai npp``.  The tiles at ni = 0 of one triple share the end of
    its L block (``base + rows DLk``), pb and rbase, which no other
    triple shares; the one with the most rows is ai = 0 (L base lbase,
    psi tile pb, sigma tile ob).  The flat offsets are psi_idx at pb's
    first element and the flat index sig_idx sends to ob's."""
    T = struct["T"]
    TT = T * T
    nt1, nt2 = struct["nt1"], struct["nt2"]
    l4 = struct["l4"].astype(np.int64)
    r4 = struct["r4"].astype(np.int64)
    s1, s2 = struct["s1"], struct["s2"]
    # stage 1 at ki = 0: one task a tmp tile (g, s1)
    g1, b1 = np.nonzero((s1 < nt1) & (l4[:, 3] == l4[:, 1]))
    k1 = g1 * nt1 + s1[g1, b1]
    # stage 2 at pi = 0: the lowest R base of each tmp tile (g, ta)
    g2, b2 = np.nonzero(s2 < nt2)
    k2 = g2 * nt1 + struct["ta"][g2, b2]
    o = np.lexsort((r4[g2, 0, b2], k2))
    o = o[np.r_[True, k2[o][1:] != k2[o][:-1]]] if len(o) else o
    g2, b2, k2 = g2[o], b2[o], k2[o]
    j = np.argsort(k1)
    pos = np.minimum(np.searchsorted(k1[j], k2), max(len(j) - 1, 0))
    if len(k1) != len(k2) or not np.array_equal(k1[j][pos], k2):
        raise ValueError("K16: the struct's stage-1 and stage-2 tasks do "
                         "not cover the same tmp tiles")
    g1, b1 = g1[j][pos], b1[j][pos]
    ni = (r4[g2, 1, b2] - r4[g2, 3, b2]) // T
    z = ni == 0
    g1, b1, g2, b2, k2 = g1[z], b1[z], g2[z], b2[z], k2[z]
    lb, dlk, rows = l4[g1, 0, b1], l4[g1, 1, b1], l4[g1, 2, b1]
    pb = struct["pa"][g1, b1].astype(np.int64)
    rb = r4[g2, 0, b2]
    # a triple's tiles: one key (L block end, pb, rbase); ai = 0 first
    o = np.lexsort((-rows, rb, pb, lb + rows * dlk))
    key = np.stack([(lb + rows * dlk)[o], pb[o], rb[o]])
    o = o[np.r_[True, (key[:, 1:] != key[:, :-1]).any(0)]] if len(o) else o
    o = o[np.argsort(k2[o])]
    sig = struct["sig_idx"].astype(np.int64)
    first = np.flatnonzero(sig % TT == 0)
    tile_first = np.full(nt2 + 2, -1, np.int64)
    tile_first[sig[first] // TT] = first
    poff = struct["psi_idx"].reshape(-1)[pb[o] * TT].astype(np.int64)
    soff = tile_first[s2[g2[o], b2[o]]]
    if (soff < 0).any():
        raise ValueError("K16: a bra sector's first tile has no flat "
                         "element")
    return np.stack([lb[o], rows[o], dlk[o], poff, r4[g2[o], 1, b2[o]],
                     rb[o], r4[g2[o], 2, b2[o]], soff], 1)


class SlabMatvec:
    """Sigma-vector executor reading LW/RW directly from slab pools (the
    StackedMeta layout every mix engine produces): the reference's v1
    resident matvec (block2_preview_tpu/ops/resident.py:347-592).

    ``_build`` is copied, so the struct (``T``, ``nt1``, ``nt2``,
    ``size_p``, ``sizb_p``, ``psi_idx``, ``sig_idx``, ``l4``, ``pa``,
    ``s1``, ``ta``, ``r4``, ``s2``) equals the reference's; it depends
    only on (meta_lw, meta_rw, psi space) and is cached across calls via
    cache/cache_key.  :meth:`matvec_device` runs K16 over
    :meth:`k16_host`'s items, kept here and not in the struct (which keeps
    the reference's keys).  No sweep runs it, as in the reference."""

    def __init__(self, space, meta_lw: StackedMeta, meta_rw: StackedMeta,
                 group, target_b, target_k, dtype=np.float64,
                 T: Optional[int] = None, cache: dict = None,
                 cache_key=None, bra_space=None):
        self.dtype = np.dtype(dtype)
        self.space = space
        self.bra_space = bra_space if bra_space is not None else space
        self.size = space.size
        sig = None
        struct = None
        if cache is not None and cache_key is not None:
            sig = hash((meta_lw.signature(), meta_rw.signature(),
                        tuple(space.keys),
                        tuple(sorted(space.shapes.items())),
                        tuple(self.bra_space.keys), T))
            ent = cache.get(cache_key)
            if ent is not None and ent[0] == sig:
                struct = ent[1]
        if struct is None:
            struct = self._build(space, self.bra_space, meta_lw, meta_rw,
                                 group, target_b, target_k, T)
            if cache is not None and cache_key is not None:
                cache[cache_key] = (sig, struct)
        self.struct = struct
        self._k16 = None
        self._dev = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _build(space, bra_space, meta_lw, meta_rw, g, tb, tk, T):
        # map center symbol -> (lw slab position, rw slab position, dq)
        lw_dq = {}
        for gi, (dq, syms) in enumerate(meta_lw.groups):
            for s in syms:
                lw_dq[int(s)] = dq
        # triples: for m, psi key (qLk, qRk): qLb = qLk + dq_m; out key
        # (qLb, tb - qLb); need lw sector qLb and rw sector qRb.
        dims = []
        for k in space.keys:
            dims += list(space.shapes[k])
        for k in bra_space.keys:
            dims += list(bra_space.shapes[k])
        trip = []   # (lbase, lstr, DLb, DLk, rbase, rstr, DRb, DRk, pk, ok)
        bkeys = set(bra_space.keys)
        for m, (gl, jl) in meta_lw.sym_pos.items():
            gr_jr = meta_rw.sym_pos.get(m)
            if gr_jr is None:
                continue
            gr, jr = gr_jr
            dq = lw_dq[m]
            sec_l = meta_lw.sectors[gl]
            sec_r = meta_rw.sectors[gr]
            for (qLk, qRk) in space.keys:
                qLb = g.add(qLk, dq)
                qRb = g.sub(tb, qLb)
                if (qLb, qRb) not in bkeys:
                    continue
                el = sec_l.get(qLb)
                er = sec_r.get(qRb)
                if el is None or er is None:
                    continue
                loff, DLb, DLk = el
                roff, DRb, DRk = er
                if DLk != space.shapes[(qLk, qRk)][0] or \
                        DRk != space.shapes[(qLk, qRk)][1]:
                    continue
                trip.append((loff + jl * DLb * DLk, DLk, DLb,
                             roff + jr * DRb * DRk, DRk, DRb,
                             (qLk, qRk), (qLb, qRb)))
        if T is None:
            T = pick_tile(np.asarray(dims if dims else [16]))
        B, nt1 = _TILE_CFG[T]

        # tiled layout of flat psi (ket space) and sigma (bra space)
        def vec_layout(sp):
            vb = {}
            nv = 0
            for k in sp.keys:
                r, c = sp.shapes[k]
                nr, ncc = -(-r // T), -(-c // T)
                vb[k] = (nv, nr, ncc)
                nv += nr * ncc
            return vb, nv

        vbk, nvk = vec_layout(space)
        vbb, nvb = vec_layout(bra_space)
        nt2 = _pow2(nvb + 1)
        size_p = _pow2(space.size + 1)
        sizb_p = _pow2(bra_space.size + 1)

        psi_idx = np.full((_pow2(nvk + 1), T, T), size_p, dtype=np.int32)
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

        ntr = len(trip)
        if ntr == 0:
            raise ValueError("no matvec triples")
        lbase_a = np.fromiter((x[0] for x in trip), np.int64, ntr)
        DLk_a = np.fromiter((x[1] for x in trip), np.int64, ntr)
        DLb_a = np.fromiter((x[2] for x in trip), np.int64, ntr)
        rbase_a = np.fromiter((x[3] for x in trip), np.int64, ntr)
        DRk_a = np.fromiter((x[4] for x in trip), np.int64, ntr)
        DRb_a = np.fromiter((x[5] for x in trip), np.int64, ntr)
        pb_a = np.fromiter((vbk[x[6]][0] for x in trip), np.int64, ntr)
        ob_a = np.fromiter((vbb[x[7]][0] for x in trip), np.int64, ntr)
        # tile grids: a over DLb, k over DLk, p over DRb, n over DRk
        na_a = -(-DLb_a // T)
        nk_a = -(-DLk_a // T)
        np_a = -(-DRb_a // T)
        nn_a = -(-DRk_a // T)
        itmp = na_a * nn_a
        is1 = itmp * nk_a
        is2 = itmp * np_a
        if (itmp.max() > nt1 or is1.max() > B or is2.max() > B):
            raise ValueError(f"block too large for tile cfg T={T}")
        grp = np.empty(ntr, dtype=np.int64)
        tb_a = np.empty(ntr, dtype=np.int64)
        o1_a = np.empty(ntr, dtype=np.int64)
        o2_a = np.empty(ntr, dtype=np.int64)
        gidx = t_used = u1 = u2 = 0
        for i in range(ntr):
            if (t_used + itmp[i] > nt1 or u1 + is1[i] > B
                    or u2 + is2[i] > B):
                gidx += 1
                t_used = u1 = u2 = 0
            grp[i] = gidx
            tb_a[i] = t_used
            o1_a[i] = u1
            o2_a[i] = u2
            t_used += itmp[i]
            u1 += is1[i]
            u2 += is2[i]
        ng = gidx + 1
        G = _pow2(ng)
        l4 = np.zeros((G, 4, B), dtype=np.int32)
        l4[:, 0, :] = -1
        pa = np.full((G, B), _pow2(nvk + 1), dtype=np.int32)
        s1 = np.full((G, B), nt1, dtype=np.int32)
        ta = np.full((G, B), nt1, dtype=np.int32)
        r4 = np.zeros((G, 4, B), dtype=np.int32)
        r4[:, 0, :] = -1
        s2 = np.full((G, B), nt2, dtype=np.int32)
        # stage 1 tasks (ai, ni, ki)
        tot1 = int(is1.sum())
        item1 = np.repeat(np.arange(ntr), is1)
        cum1 = np.concatenate([[0], np.cumsum(is1)[:-1]])
        o = np.arange(tot1) - np.repeat(cum1, is1)
        nk1 = nk_a[item1]
        nn1 = nn_a[item1]
        ai = o // (nn1 * nk1)
        ni = (o // nk1) % nn1
        ki = o % nk1
        pos = np.repeat(o1_a, is1) + o
        gi = grp[item1]
        l4[gi, 0, pos] = lbase_a[item1] + ai * T * DLk_a[item1] + ki * T
        l4[gi, 1, pos] = DLk_a[item1]
        l4[gi, 2, pos] = DLb_a[item1] - ai * T
        l4[gi, 3, pos] = DLk_a[item1] - ki * T
        pa[gi, pos] = pb_a[item1] + ki * nn1 + ni
        s1[gi, pos] = np.repeat(tb_a, is1) + ai * nn1 + ni
        # stage 2 tasks (ai, ni, pi), sorted per group by target tile
        tot2 = int(is2.sum())
        item2 = np.repeat(np.arange(ntr), is2)
        cum2 = np.concatenate([[0], np.cumsum(is2)[:-1]])
        o = np.arange(tot2) - np.repeat(cum2, is2)
        nn2 = nn_a[item2]
        npp = np_a[item2]
        ai = o // (nn2 * npp)
        ni = (o // npp) % nn2
        pi = o % npp
        v_s2 = ob_a[item2] + ai * npp + pi
        v_ta = np.repeat(tb_a, is2) + ai * nn2 + ni
        v_rb = rbase_a[item2] + pi * T * DRk_a[item2] + ni * T
        gi2 = grp[item2]
        order = np.lexsort((v_rb, v_ta, v_s2, gi2))
        gsz = np.bincount(gi2, minlength=ng)
        gstart = np.concatenate([[0], np.cumsum(gsz)[:-1]])
        pos2 = np.arange(tot2) - np.repeat(gstart, gsz)
        go = gi2[order]
        s2[go, pos2] = v_s2[order]
        ta[go, pos2] = v_ta[order]
        r4[go, 0, pos2] = v_rb[order]
        r4[go, 1, pos2] = DRk_a[item2][order]
        r4[go, 2, pos2] = (DRb_a[item2] - pi * T)[order]
        r4[go, 3, pos2] = (DRk_a[item2] - ni * T)[order]

        return {"T": T, "nt1": nt1, "nt2": nt2, "size_p": size_p,
                "sizb_p": sizb_p,
                "psi_idx": psi_idx, "sig_idx": sig_idx,
                "l4": l4, "pa": pa, "s1": s1, "ta": ta, "r4": r4,
                "s2": s2}

    # ------------------------------------------------------------------
    def k16_host(self) -> Dict:
        """K16's host tables, built once and kept: ``items``
        (:func:`k16_items` in ``chain_mv.ket_round_robin``'s order), their
        chunks (``ops/chain_mv.chunk_tables``: ``ent``, ``ck``, ``flops``)
        and the ``seconds`` the build took."""
        if self._k16 is None:
            t0 = time.perf_counter()
            items = k16_items(self.struct)
            items = items[chain_mv.ket_round_robin(items)]
            tab = chain_mv.chunk_tables(items)
            tab["items"] = items
            tab["seconds"] = time.perf_counter() - t0
            self._k16 = tab
        return self._k16

    def to_device(self, device) -> Dict:
        """Device tables for K16 and its twin, cached per device: the
        struct's tile tables and, derived here, ``toff`` [G + 1] (each
        group's first tile in ONE tmp pool of ``ntmp`` tiles, the twin's;
        the reference restarts its tmp pool per group) and ``chain`` (K16's
        items and chunk tables, :meth:`k16_host`)."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            s = self.struct
            s1 = np.where(s["s1"] < s["nt1"], s["s1"].astype(np.int64), -1)
            toff = np.concatenate([[0], np.cumsum(s1.max(axis=1) + 1)])
            d = {k: torch.as_tensor(np.ascontiguousarray(s[k]),
                                    device=device)
                 for k in ("psi_idx", "sig_idx", "l4", "pa", "s1", "ta",
                           "r4", "s2")}
            d["toff"] = torch.as_tensor(toff.astype(np.int32), device=device)
            d["ntmp"] = int(toff[-1])
            h = self.k16_host()
            d["chain"] = chain_mv.device_tables(h["items"], h, device)
            self._dev[key] = d
        return d

    def pad(self, x: np.ndarray) -> np.ndarray:
        xp = np.zeros(self.struct["size_p"] + 1, dtype=self.dtype)
        xp[:self.size] = x
        return xp

    def matvec_device(self, xp, lpool, rpool):
        """Flat sigma [sizb_p] on the pools' device (kernel K16)."""
        s = self.struct
        return slab_mv_exec(xp, lpool, rpool, self.to_device(xp.device),
                            s["T"], s["nt1"], s["nt2"])

    def free(self):
        self._dev = {}


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
    secs = [(space.offsets[k], *space.shapes[k], el[0], er[0], vbb[k])
            for k in space.keys if k in dl_secoff
            for el, er in [(meta_lw.sectors[g0l][k[0]],
                            meta_rw.sectors[g0r][k[1]])]]
    return {"gl": gl, "gr": gr, "dl_cap": dl_cap, "dr_cap": dr_cap,
            "a4": a4, "b4": b4, "sD": sD, "T": T, "nt2": nt2,
            "sig_idx": sig_idx,
            "k2": _k2_rows(secs, sig_idx, T),
            "k2m": np.asarray([(posl[m], posr[m]) for m in common],
                              np.int32)}


# K2's pieces (csrc/diag.cu kDP): at most K2_PIECE x K2_PIECE elements of
# one sector; zero ranges of at most K2_ZERO elements
K2_PIECE = 32
K2_ZERO = 1 << 14


def _k2_rows(secs, sig_idx, T: int) -> np.ndarray:
    """K2's rows [n, 9] int32 (flat offset, DL, DR, a0, na, b0, nb, LW
    sector offset, RW sector offset) over the sectors ``secs`` (flat
    offset, DL, DR, LW offset, RW offset, (tile base, tile rows, tile
    columns)), then zero ranges (offset, 0, 0, 0, 0, 0, n, 0, 0) over the
    rest of the flat diagonal [sizb_p]: the output ``sig_idx`` gives the
    tile pool's diagonal, element for element.  Raises if ``sig_idx`` puts
    a sector elsewhere than its row-major block at its flat offset (a bra
    space laid out otherwise than the ket space)."""
    rows, spans = [], []
    for (foff, DL, DR, loff, roff, (base, _, ncc)) in secs:
        a, b = np.divmod(np.arange(DL * DR), DR)
        tidx = ((base + (a // T) * ncc + b // T) * (T * T)
                + (a % T) * T + b % T)
        if not np.array_equal(sig_idx[foff:foff + DL * DR], tidx):
            raise ValueError("K2: the bra layout is not the ket space's")
        spans.append((foff, foff + DL * DR))
        for a0 in range(0, DL, K2_PIECE):
            for b0 in range(0, DR, K2_PIECE):
                rows.append((foff, DL, DR, a0, min(K2_PIECE, DL - a0), b0,
                             min(K2_PIECE, DR - b0), loff, roff))
    spans.sort()
    pos = 0
    for (s0, s1) in spans + [(len(sig_idx), len(sig_idx))]:
        for z in range(pos, s0, K2_ZERO):
            rows.append((z, 0, 0, 0, 0, 0, min(K2_ZERO, s0 - z), 0, 0))
        pos = max(pos, s1)
    return np.asarray(rows, np.int64).astype(np.int32).reshape(-1, 9)


# ---------------------------------------------------------------------------
# kernel K2 (diagonal) and its plain twin
# ---------------------------------------------------------------------------

def diag_plain_tables(dstruct, device) -> Dict:
    """The plain version's tables of a diag struct (the reference's
    gathers, GEMM tile tasks and ``sig_idx``) on ``device``."""
    d = {k: torch.as_tensor(dstruct[k], device=device)
         for k in ("gl", "gr", "a4", "b4", "sD", "sig_idx")}
    d.update({k: dstruct[k] for k in ("dl_cap", "dr_cap", "T", "nt2")})
    return d


def diag_tables(dstruct, device) -> Dict:
    """The tables of :func:`diag_exec`: K2's (``rows``, ``sym``, ``n``) on
    a CUDA device, the plain version's on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return diag_plain_tables(dstruct, device)
    return {"rows": torch.as_tensor(dstruct["k2"], device=device),
            "sym": torch.as_tensor(dstruct["k2m"], device=device),
            "n": int(dstruct["sig_idx"].shape[0])}


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
    """Plain PyTorch version of K2 (same signature as :func:`diag_exec`,
    on :func:`diag_plain_tables`)."""
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
    slab pools (kernel K2: one launch, every element stored once); ``d``
    from :func:`diag_tables`."""
    if lpool.device.type == "cpu":
        return diag_twin(lpool, rpool, d)
    if not lpool.is_cuda:
        raise ValueError(f"unsupported device {lpool.device}")
    out = torch.empty(d["n"], dtype=lpool.dtype, device=lpool.device)
    _kernels.launch("K2_diag", "b2t_diag", lpool.dtype, lpool, rpool,
                    d["rows"], d["sym"], d["sym"].shape[0],
                    d["rows"].shape[0], out)
    return out


def execute_diag(dstruct, lpool, rpool, cache: Optional[Dict] = None):
    """Flat diagonal [sizb_p] on the pools' device (kernel K2).
    ``cache``: a dict that keeps the tables per device (the diag struct's
    entry in ``ResidentSite``'s cache), so they are uploaded once."""
    key = str(lpool.device)
    d = None if cache is None else cache.get(key)
    if d is None:
        d = diag_tables(dstruct, lpool.device)
        if cache is not None:
            cache[key] = d
    return diag_exec(lpool, rpool, d)


# ---------------------------------------------------------------------------
# kernel K6 (perturbative-noise density matrix) and its plain twin
# rho_n[qb] += sum_m (W_m psi)(W_m psi)^T (reference
# src/dmrg/effective_hamiltonian.hpp:253 perturbative_noise)
# ---------------------------------------------------------------------------

# stage tasks per chunk of the plain version (bounds its temporaries)
_TWIN_NOISE_TASKS = 8192
# items of one K6 run at most, and the rows of its rho strips
# (csrc/noise.cu kStrip); runs are also cut at 1 / NOISE_BLOCKS of the
# plan's FLOPs, unless the partial pool would pass NOISE_PART elements
NOISE_RUN = 16
NOISE_STRIP = 64
NOISE_BLOCKS = 2048
NOISE_PART = 1 << 23


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
    pool of ``n_x`` tiles (the plain version's; the reference restarted it
    per task group).  cum1/cum2 [n+1]: stage-1 tasks (ai, ni, ki) and
    stage-2 tasks (ar, ac, ni) per item.  rho tiles: [nrho + 1, T, T].
    ``pn`` [n, 2]: each item's flat psi offset and DN (what K6 reads in
    place of the tiles).  ``psi_idx``, the psi tile gather of the plain
    version, is built at first use (the RW side's transposed one in
    Python)."""

    __slots__ = ("it", "cum1", "cum2", "nrho", "T", "sectors", "_psi_idx",
                 "_psi_args", "side", "pn", "n_x", "flops", "_dev")

    def __init__(self, space, meta, group, side, T, psi_idx):
        self.T = T
        self.side = side
        # psi tile layout bases (must match the psi_idx tile order)
        vbk = {}
        nv = 0
        for k in space.keys:
            r, c = space.shapes[k]
            if side == "rw":
                r, c = c, r
            vbk[k] = nv
            nv += (-(-r // T)) * (-(-c // T))
        self._psi_idx = psi_idx
        self._psi_args = (space, vbk, nv)
        self._rows(space, meta, group, side, T, vbk)

    @property
    def psi_idx(self):
        """The psi tile gather of the plain version: the matvec's
        ``psi_idx`` (LW side) or the transposed one (RW side), built here
        at first use."""
        if self._psi_idx is None and self.side == "rw":
            space, vbk, nv = self._psi_args
            T = self.T
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
            self._psi_idx = psi_idx
        return self._psi_idx

    def _rows(self, space, meta, group, side, T, vbk):
        dq_of = {}
        for gi, (dq, syms) in enumerate(meta.groups):
            for s in syms:
                dq_of[int(s)] = dq
        # rho sectors over the bond quantum qb; tiled [na, na] per sector
        rows = []       # wbase, wstride, DB, pb, DK, DN
        rkeys = []      # qb per row
        poffs = []      # flat psi offset per row
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
                poffs.append(space.offsets[k])
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
        self.pn = np.asarray([(o, r[5]) for o, r in zip(poffs, rows)],
                             np.int64).reshape(-1, 2)
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

    def host_tables(self) -> Dict:
        """K6's numpy tables (cached in ``_dev["k6"]``; ``csrc/noise.cu``):
        ``nw`` [n, 5] (W offset, psi offset, DK, DN, DB) of the items
        sorted stably by rho sector; ``nb`` [n_blocks, 6] (first item, end,
        DB, a, c, partial offset), a CUDA block a run of at most
        ``NOISE_RUN`` items of one sector (cut at 1 / ``NOISE_BLOCKS`` of
        the plan's FLOPs while the partial pool stays within
        ``NOISE_PART`` elements) and a pair a <= c of its
        ``NOISE_STRIP``-row strips, by decreasing FLOPs; ``ns`` [n_sec, 5]
        (partial offset of the sector's first run, runs, DB, rb, na);
        ``n_part`` (the partial pool: DB^2 elements a run),
        ``sum_blocks``, ``wide`` (a sector wider than two strips: K6 runs
        its two-blocks-an-SM instance) and ``seconds``."""
        h = self._dev.get("k6")
        if h is not None:
            return h
        from .exec_bucket import _int32
        t0 = time.perf_counter()
        n = len(self.pn)
        order = np.argsort(self.it[:n, 8], kind="stable")
        f = self.it[:n].astype(np.int64)[order]
        pn = self.pn[order]
        nw = np.stack([f[:, 0], pn[:, 0], f[:, 9], pn[:, 1], f[:, 2]], 1)
        rb = f[:, 8]
        sec = {base: (na, D) for base, na, D in self.sectors.values()}
        new = np.ones(n, bool)
        new[1:] = rb[1:] != rb[:-1]
        start = np.maximum.accumulate(np.where(new, np.arange(n), 0))
        rank = np.arange(n) - start
        # each item's FLOPs (x and x x^T over its whole sector) and the
        # FLOPs before it in its sector
        ifl = 2 * nw[:, 4] * nw[:, 3] * (nw[:, 2] + nw[:, 4])
        cfl = np.concatenate([[0], np.cumsum(ifl)])
        before = cfl[:-1] - cfl[start]
        cap = max(float(cfl[-1]) / NOISE_BLOCKS, 1.0)
        while True:
            # a run: at most NOISE_RUN items of one sector, cut where the
            # sector's FLOPs pass a multiple of the cap
            key = np.floor(before / cap).astype(np.int64)
            cut = new.copy()
            cut[1:] |= ((rank[1:] // NOISE_RUN != rank[:-1] // NOISE_RUN)
                        | (key[1:] != key[:-1]))
            first = np.flatnonzero(cut)
            end = np.append(first[1:], n)[:len(first)]
            run_rb = rb[first]
            run_d = np.asarray([sec[int(b)][1] for b in run_rb], np.int64)
            pbase = np.concatenate([[0], np.cumsum(run_d * run_d)])
            if pbase[-1] <= NOISE_PART or cap >= cfl[-1]:
                break
            cap *= 2
        # blocks: (run, a, c), a <= c, over the run's strips (rho is
        # symmetric: the sum writes the (c, a) strip pair from (a, c))
        nst = -(-run_d // NOISE_STRIP)
        rep = nst * (nst + 1) // 2
        m = int(nst.max()) if len(nst) else 0
        pairs = np.asarray([(a, c) for c in range(m) for a in range(c + 1)],
                           np.int64).reshape(-1, 2)
        r = np.repeat(np.arange(len(first)), rep)
        k = np.arange(int(rep.sum())) - np.repeat(np.cumsum(rep) - rep, rep)
        sa, sc = pairs[k, 0], pairs[k, 1]
        d = run_d[r]
        ra = np.minimum(NOISE_STRIP, d - sa * NOISE_STRIP)
        rc = np.minimum(NOISE_STRIP, d - sc * NOISE_STRIP)
        # per run: sum DN DK and sum DN of its items
        cdk = np.concatenate([[0], np.cumsum(nw[:, 3] * nw[:, 2])])
        cdn = np.concatenate([[0], np.cumsum(nw[:, 3])])
        sdk = (cdk[end] - cdk[first])[r]
        sdn = (cdn[end] - cdn[first])[r]
        fl = sdk * (ra + np.where(sa == sc, 0, rc)) + sdn * ra * rc
        nb = np.stack([first[r], end[r], d, sa, sc, pbase[r]], 1)
        nb = nb[np.argsort(-fl, kind="stable")].reshape(-1, 6)
        # sectors: their runs are consecutive
        snew = np.flatnonzero(np.append(True, run_rb[1:] != run_rb[:-1]))
        scount = np.diff(np.append(snew, len(first)))
        sna = np.asarray([sec[int(b)][0] for b in run_rb[snew]], np.int64)
        ns = np.stack([pbase[snew], scount, run_d[snew], run_rb[snew],
                       sna.reshape(-1)], 1).reshape(-1, 5)
        dmax = int(run_d.max()) if len(run_d) else 0
        h = {"nw": _int32(nw, "a K6 pool offset"),
             "nb": _int32(nb, "a K6 partial offset"),
             "ns": _int32(ns, "a K6 sector field"),
             "n_part": int(pbase[-1]),
             "sum_blocks": max(1, min(-(-dmax * dmax // 256), 4096)),
             "wide": int(dmax > 2 * NOISE_STRIP),
             "seconds": time.perf_counter() - t0}
        self._dev["k6"] = h
        return h

    def twin_tables(self, device) -> Dict:
        """The plain version's tables on ``device`` (the reference's item
        rows and task prefix sums, the psi tile gather), cached."""
        key = ("twin", str(device))
        d = self._dev.get(key)
        if d is None:
            def i32(a):
                return torch.as_tensor(
                    np.ascontiguousarray(a, dtype=np.int32), device=device)

            d = {"it": i32(self.it), "cum1": i32(self.cum1),
                 "cum2": i32(self.cum2),
                 "psi_idx": i32(self.psi_idx.reshape(-1)),
                 "n_x": self.n_x, "nrho": self.nrho}
            self._dev[key] = d
        return d

    def tables(self, device) -> Dict:
        """The tables :func:`noise_exec` takes on ``device``, cached: K6's
        (:meth:`host_tables`) on a CUDA device, the plain version's
        (:meth:`twin_tables`) on the CPU."""
        device = torch.device(device)
        if device.type == "cpu":
            return self.twin_tables(device)
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            h = self.host_tables()
            d = {k: torch.as_tensor(h[k], device=device)
                 for k in ("nw", "nb", "ns")}
            d.update(n_blocks=len(h["nb"]), n_sec=len(h["ns"]),
                     n_part=h["n_part"], sum_blocks=h["sum_blocks"],
                     rw=int(self.side == "rw"), wide=h["wide"],
                     nrho=self.nrho)
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
    """Plain PyTorch version of K6 (the reference's two stages; ``d`` from
    :meth:`NoisePlan.twin_tables`): stage 1 forms the x tiles into a
    scratch pool, stage 2 adds their outer products into the rho tiles."""
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
    slab pool; ``d`` from :meth:`NoisePlan.tables` on ``xp``'s device.
    CPU tensors run :func:`noise_twin`; CUDA tensors launch K6 into a
    partial pool of ``d["n_part"]`` elements, or raise."""
    if xp.device.type == "cpu":
        return noise_twin(xp, wpool, d, T)
    if not xp.is_cuda:
        raise ValueError(f"unsupported device {xp.device}")
    dt, dev = xp.dtype, xp.device
    part = torch.empty(max(d["n_part"], 1), dtype=dt, device=dev)
    rho = torch.zeros((d["nrho"] + 1) * T * T, dtype=dt, device=dev)
    _kernels.launch("K6_noise", "b2t_noise", dt, xp, wpool, d["nw"],
                    d["nb"], d["n_blocks"], d["ns"], d["n_sec"],
                    d["sum_blocks"], T, d["rw"], d["wide"], part, rho)
    return rho.reshape(-1, T, T)


# ---------------------------------------------------------------------------
# per-site orchestration
# ---------------------------------------------------------------------------

def _mix_ver() -> int:
    """Active mix engine (B2TPU_MIX), with the reference's mapping
    (resident.py:1151-1156): 4 and above mix v4 (the default), 3 mix v3,
    anything else the v2 scatter mix."""
    return int(os.environ.get("B2TPU_MIX", "4"))


def _mix_sig(meta_env, entries, fused, fused_ket, active, active_ket,
             comp_target, comp_target_ket, out_bond_dqs, ver):
    """Validation signature for a cached mix plan: env pool layout, every
    non-env input (MPO entry content, fused bases, active sets, targets,
    output bond charges) and the mix engine ``ver`` (:func:`_mix_ver`), so
    a plan of one engine never serves another."""
    return hash((meta_env.signature(),
                 _plan_args_sig(entries, fused, fused_ket, active,
                                active_ket, comp_target, comp_target_ket),
                 tuple(out_bond_dqs), ver))


def build_mix_plan_v4(*args, **kw):
    """Mix plan of engine 4: the v3 plan in the v4 execution form, or the
    v3 plan itself where ``plan_v4`` cannot take it (no GEMM items or no
    place windows; the reference's fallback, resident.py:1229-1238); None
    when the site has no effective operators."""
    p3 = build_mix_plan_v3(*args, **kw)
    p4 = plan_v4(p3)
    return p4 if p4 is not None else p3


def execute_mix_plan(plan, epool):
    """LW/RW slab pool [ncap_out + 1] from a plan of any engine: v4 (K3 +
    K4), v3 (K13 + K14) or v2 (K15)."""
    if isinstance(plan, MixPlanV4):
        return execute_mix_v4(plan, epool)
    if isinstance(plan, MixPlanV3):
        return execute_mix_v3(plan, epool)
    return execute_mix(plan, epool)


class ResidentSite:
    """Device-resident two-site effective-Hamiltonian step.

    The LW/RW mix runs on the engine ``B2TPU_MIX`` names (see the module
    docstring).  Host-side structures (mix plans, matvec structs, diag
    structs) are cached across sweeps in ``caches`` (sub-dicts 'mix',
    'v2', 'diag'), keyed by site and validated against content
    signatures, the engine included.  ``t_plan`` is the host time spent
    building this site's mix plans (0 on a cache hit).  An empty mix plan
    raises RuntimeError; nothing falls back to the host.

    Reference analog: MovingEnvironment::eff_ham
    (src/dmrg/moving_environment.hpp:2063) + EffectiveHamiltonian::eigs
    (src/dmrg/effective_hamiltonian.hpp:471).
    """

    def __init__(self, me, eff, device, dtype=np.float64, caches=None):
        self.me = me
        self.eff = eff
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        # operator sharding (reference :1186-1187): with a mesh every
        # sigma matvec runs this rank's task groups on K20 and sums the
        # partials with all_reduce; the mix, diagonal and noise do not
        # shard, as in the reference
        self.mesh = getattr(me, "mesh", None)
        self.mesh_axis = getattr(me, "mesh_axis", "op")
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

        self.t_plan = 0.0

        def plan(key, build, sig):
            ent = caches["mix"].get(key)
            if ent is not None and ent[0] == sig:
                return ent[1]
            t0 = time.time()
            p = build()
            self.t_plan += time.time() - t0
            caches["mix"][key] = (sig, p)
            return p

        ver = _mix_ver()
        bmp = (build_mix_plan_v4 if ver >= 4 else
               build_mix_plan_v3 if ver >= 3 else build_mix_plan)

        sig_l = _mix_sig(meta_l, mpo.tensors[t], flb, flk, active_lb,
                         active_lk, None, None, mpo.bond_dqs[t + 1], ver)
        pl = plan((t, "lw"), lambda: bmp(
            meta_l, mpo.tensors[t], mpo.site_quanta[t], flb,
            bond_is_first=True, join_on_input=True, group=g,
            out_bond_dqs=mpo.bond_dqs[t + 1], active=active_lb,
            fused_ket=flk, active_ket=active_lk), sig_l)
        sig_r = _mix_sig(meta_r, mpo.tensors[t + 1], frb, frk, active_rb,
                         active_rk, tb, tk, mpo.bond_dqs[t + 1], ver)
        pr = plan((t, "rw"), lambda: bmp(
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
        self.lw_pool = execute_mix_plan(pl, pool_l)
        self.rw_pool = execute_mix_plan(pr, pool_r)
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
        if ent is None or ent[0] != sig:
            ds = build_diag_struct(self.eff.ket_space, self.pl.meta_out,
                                   self.pr.meta_out, s["T"], s["nt2"],
                                   s["sig_idx"])
            # the struct, and its device tables kept beside it
            ent = self.caches["diag"][key] = (sig, ds, {})
        if ent[1] is None:
            raise RuntimeError("no diagonal contributions")
        return execute_diag(ent[1], self.lw_pool, self.rw_pool, ent[2])

    def _sigma(self):
        """The sigma matvec of this site on padded device vectors: K1, or
        with a mesh this rank's share on K20 + all_reduce."""
        s = self.ex.struct
        d = self.ex.to_device(self.device)
        if self.mesh is None:
            return lambda v: mv_exec(v, self.lw_pool, self.rw_pool, d,
                                     s["T"], s["nt2"])
        from ..parallel.multihost import axis_info, broadcast_
        group, rank, world = axis_info(self.mesh, self.mesh_axis)
        part = self.ex.rank_part(rank, world, self.device)

        def mv(v):
            # the partials must be of one vector: v becomes rank 0's, in
            # place (a Davidson basis row), because the subspace algebra
            # on the card (cuBLAS, cuSOLVER) need not round alike on every
            # rank, and partials of drifting vectors sum to no operator
            broadcast_(v, group)
            return mv_exec_sharded(v, self.lw_pool, self.rw_pool, d, part,
                                   s["T"], s["nt2"], group)
        return mv

    @property
    def shard_units(self) -> Optional[int]:
        """This rank's K20 units per matvec (None without a mesh)."""
        if self.mesh is None:
            return None
        from ..parallel.multihost import axis_info
        _, rank, world = axis_info(self.mesh, self.mesh_axis)
        return self.ex.rank_part(rank, world, self.device)["n_units"]

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """One sigma matvec of a host vector (kernel K1, or K20 with a
        mesh), on the host."""
        xp = torch.as_tensor(self.ex.pad(x), device=self.device)
        y = self._sigma()(xp)
        return y.cpu().numpy().astype(np.float64)[:self.size]

    def solve_ground_state(self, x0: np.ndarray, conv_thrd: float = 1e-8,
                           max_iter: int = 100, max_subspace: int = 20):
        """On-device Davidson; returns (theta, x[host], n_iter).

        With a mesh it is the reference's _v2_dav_sharded (:828, chunks
        :792): every matvec is this rank's share on K20 summed with
        all_reduce, and the subspace work runs on every rank.  Each
        matvec's input is rank 0's basis vector (:meth:`_sigma`), each
        iteration's stop decision rank 0's, and so is the eigenpair
        returned, so the ranks stay in lockstep and agree bitwise."""
        s = self.ex.struct
        dg = self.diagonal_device()
        # diag [sizb_p] -> [size_p + 1]; pad slots are exact zeros
        diag_p = torch.zeros(s["size_p"] + 1, dtype=dg.dtype,
                             device=self.device)
        diag_p[:dg.shape[0]] = dg
        xp0 = torch.as_tensor(self.ex.pad(x0), device=self.device)
        group = None
        if self.mesh is not None:
            from ..parallel.multihost import axis_info, broadcast_
            group = axis_info(self.mesh, self.mesh_axis)[0]
        th, xv, it = davidson(self._sigma(), diag_p, xp0,
                              conv_thrd=conv_thrd, max_iter=max_iter,
                              max_subspace=max_subspace, group=group)
        if group is not None:
            broadcast_(xv, group)
            th_it = broadcast_(torch.tensor([th, it], dtype=torch.float64,
                                            device=self.device), group)
            th, it = float(th_it[0]), int(th_it[1])
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
