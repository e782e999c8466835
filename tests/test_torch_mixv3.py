"""Mix v3 of the port — kernels K13 (env GEMM) and K14 (place): their
plain twins (what execute_mix_v3 runs on CPU tensors) against the
reference's _env_gemm / _env_gemm_chunk and _place / _place_chunk (JAX on
the CPU) on the same plan tables, execute_mix_v3 against the reference's
(f64: 1e-12 relative to the pool scale; f32: 1e-5), the v3 pools against
the v4 ones, and ResidentSite's engine switch (B2TPU_MIX): the v4 -> v3
fallback, the plan cache's engine signature, and torch_resident under
B2TPU_MIX=3 against jax_resident under the same variable."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
from block2_preview_tpu.ops import mixv3 as ref_mixv3

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.effective import (
    EffectiveHamiltonian2 as PortEff)
from block2_preview_tpu_torch.dmrg.environment import (
    MovingEnvironment as PortME)
from block2_preview_tpu_torch.dmrg.sweep import DMRG
from block2_preview_tpu_torch.ops import mixv3, mixv4, resident
from block2_preview_tpu_torch.ops.mixv3 import MixPlanV3
from block2_preview_tpu_torch.ops.mixv4 import MixPlanV4

from test_torch_mixv4 import mix_walk
from test_torch_plans import SITES, Site, hubbard_driver, hubbard_system


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


def _plan(site, side):
    """Reference v3 plan, its port copy and the reference env pool."""
    r3, _, pool = site.ref_plans(side)
    return r3, interop.mix_plan_v3(r3), pool


def _close(got, ref, tol):
    scale = max(np.abs(ref).max(), 1.0)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * scale


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_env_gemm_twin_matches_jax(system, t, side):
    """K13's twin against _env_gemm on every GEMM group, and one window at
    c0 > 0 against _env_gemm_chunk."""
    import jax.numpy as jnp
    _, p3, pool = _plan(Site(*system, t), side)
    d = mixv3.v3_tables(p3, "cpu", torch.float64)
    ep = torch.as_tensor(pool)
    jp = jnp.asarray(pool)
    for dg in d["gemms"]:
        args = [jnp.asarray(dg[k].numpy()) for k in
                ("wr", "wc", "wv", "eoff", "dbdk", "secoff")]
        nw_p, ns_p, dg_p = dg["nw_p"], dg["ns_p"], dg["dg_p"]
        ref = np.asarray(ref_mixv3._env_gemm(jp, *args, nw_p, ns_p, dg_p))
        got = mixv3.env_gemm_exec(ep, dg, 0, dg_p,
                                  torch.empty(nw_p, dg_p, dtype=ep.dtype))
        _close(got.numpy(), ref, 1e-12)
        c0, n = dg_p // 3 + 1, 16
        ref = np.asarray(ref_mixv3._env_gemm_chunk(
            jp, *args, np.int32(c0), nw_p, ns_p, n))
        got = mixv3.env_gemm_exec(ep, dg, c0, n,
                                  torch.empty(nw_p, n, dtype=ep.dtype))
        _close(got.numpy(), ref, 1e-12)


# ---------------------------------------------------------------------------
# K13 on K3's output-stationary body: mixv3.k13_host_tables (and a window's
# window_host_tables) walked in the kernel's order (test_torch_mixv4's
# mix_walk)
# ---------------------------------------------------------------------------

_K13_TOL = {np.float64: 1e-13, np.float32: 1e-5}


def _jax_args(dg):
    import jax.numpy as jnp
    return [jnp.asarray(dg[k].numpy()) for k in
            ("wr", "wc", "wv", "eoff", "dbdk", "secoff")]


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k13_walk_matches_jax(system, t, side, dtype):
    """K13's walk over the plan's K3 tiles (one launch a plan: the
    group-by-sector GEMM blocks, the all-zero W slices skipped) stores
    every element of each group's [nw_p, dg_p] block exactly once from a
    buffer of NaNs (the padded rows and columns as zeros, nothing past the
    last group) and gives the JAX _env_gemm's block for every group; the
    tables are built once a plan."""
    import jax.numpy as jnp
    _, p3, pool = _plan(Site(*system, t), side)
    h = mixv3.k13_host_tables(p3)
    assert mixv3.k13_host_tables(p3) is h and h["seconds"] > 0
    ep = pool.astype(dtype)
    got, seen, by_block = mix_walk(ep, h["wdense"].astype(dtype), h,
                                   p3.out_total)
    assert np.all(seen == 1)
    d = mixv3.v3_tables(p3, "cpu", torch.float64)
    jp = jnp.asarray(ep)
    live = np.zeros(p3.out_total, bool)
    for dg, spec in zip(d["gemms"], p3.gemms):
        nw_p, ns_p, dg_p = dg["nw_p"], dg["ns_p"], dg["dg_p"]
        blk = np.s_[dg["goff"]:dg["goff"] + nw_p * dg_p]
        want = np.asarray(ref_mixv3._env_gemm(jp, *_jax_args(dg), nw_p, ns_p,
                                              dg_p))
        _close(got[blk].reshape(nw_p, dg_p), want, _K13_TOL[dtype])
        lv = live[blk].reshape(nw_p, dg_p)
        lv[:spec["nw"], :int(spec["secoff"][-1])] = True
    assert np.array_equal(by_block, live)     # the rest stored as zeros
    assert not got[~live].any()


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k13_window_walk_matches_jax_chunk(system, t, side, dtype):
    """K13's window form (one group's columns [c0, c0 + n), c0 > 0: the
    blocks cut to the window and re-based to out [nw_p, n]) walked from
    NaNs: every element stored once, the JAX _env_gemm_chunk's values, on
    the widest group and on a window that runs past the group's live
    columns."""
    import jax.numpy as jnp
    _, p3, pool = _plan(Site(*system, t), side)
    h = mixv3.k13_host_tables(p3)
    ep = pool.astype(dtype)
    d = mixv3.v3_tables(p3, "cpu", torch.float64)
    gi = max(range(len(p3.gemms)), key=lambda i: p3.gemms[i]["dg_p"])
    dg, spec = d["gemms"][gi], p3.gemms[gi]
    live = int(spec["secoff"][-1])
    for c0, n in ((dg["dg_p"] // 3 + 1, 16),
                  (max(1, live - 7), dg["dg_p"] - max(1, live - 7) + 9)):
        hw = mixv3.window_host_tables(spec, int(h["woff"][gi]),
                                      h["wdense"], c0, n)
        got, seen, _ = mix_walk(ep, h["wdense"].astype(dtype), hw,
                                dg["nw_p"] * n)
        assert np.all(seen == 1)
        want = np.asarray(ref_mixv3._env_gemm_chunk(
            jnp.asarray(ep), *_jax_args(dg), np.int32(c0), dg["nw_p"],
            dg["ns_p"], n))
        _close(got.reshape(dg["nw_p"], n), want, _K13_TOL[dtype])


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_place_twin_matches_jax(system, t, side):
    """K14's twin against _place (the whole slab) and _place_chunk (a
    window at c0 > 0), on a random OUT buffer."""
    import jax.numpy as jnp
    _, p3, _ = _plan(Site(*system, t), side)
    d = mixv3.v3_tables(p3, "cpu", torch.float64)
    outflat = np.random.default_rng(3).standard_normal(
        mixv3._cap_class(p3.out_total + 1))
    tabs = [jnp.asarray(p3.tables[k]) for k in mixv3.PLACE_TABLES]
    n = p3.ncap_out + 1
    ref = np.asarray(ref_mixv3._place(jnp.asarray(outflat), *tabs,
                                      jnp.zeros(n)))
    got = mixv3.place_v3_exec(torch.as_tensor(outflat), d, 0, n,
                              torch.empty(n, dtype=torch.float64)).numpy()
    assert np.array_equal(got, ref)        # a gather: exact
    assert got[-1] == 0.0
    total = p3.meta_out.total
    assert not got[total:].any()           # the tail and the sentinel
    for c0, m in ((total // 2 + 1, 1000), (total // 3 + 1, 999),
                  (total - 7, 1001)):      # odd n, one across the tail
        ref = np.asarray(ref_mixv3._place_chunk(jnp.asarray(outflat), *tabs,
                                                np.int32(c0), m))
        got = mixv3.place_v3_exec(torch.as_tensor(outflat), d, c0, m,
                                  torch.empty(m, dtype=torch.float64))
        assert np.array_equal(got.numpy(), ref)


# csrc/place_v3.cu's kPlaceTile and kPlaceSb
PLACE_TILE, PLACE_SB = 4096, 64


def _place_walk(tabs, c0, n, tile=PLACE_TILE, sb_max=PLACE_SB):
    """(src, ok) of slab elements [c0, c0 + n) as K14's blocks find them:
    per tile of ``tile`` elements, zeros at or past the live end (the last
    superblock start); else the superblocks lo..hi of the tile's first and
    last live element, staged when there are at most ``sb_max`` of them
    (each thread's scan over the staged starts lands on the last start at
    or below its element, as its elements increase), else a search per
    element; then place_elem's arithmetic (floor division, clips, early
    zeros)."""
    t = {k: np.asarray(tabs[k], np.int64) for k in mixv3.PLACE_TABLES}
    st, nsb = t["sb_starts"], len(t["sb_starts"])
    live_end = st[-1]
    src = np.zeros(n, np.int64)
    ok = np.zeros(n, bool)

    def find(i):                    # find_sb: last start <= i, else 0
        return np.maximum(np.searchsorted(st, i, side="right") - 1, 0)

    for e0 in range(0, n, tile):
        i = c0 + np.arange(e0, min(n, e0 + tile))
        if i[0] >= live_end:
            continue                # the zero tail
        lo = find(i[0])
        hi = find(min(i[-1], live_end - 1))
        if i[0] < st[0] or hi - lo + 1 > sb_max:
            sb = find(i)
        else:
            sb = lo + np.searchsorted(st[lo:hi + 1], i, side="right") - 1
            sb = np.maximum(sb, lo)
        off = i - st[sb]
        bs = np.maximum(t["sb_blksz"][sb], 1)
        jo = off // bs
        rem = off - jo * bs
        dlk = np.maximum(t["sb_dlk"][sb], 1)
        rr, cc = rem // dlk, rem % dlk
        live = (i < live_end) & (i < st[np.minimum(sb + 1, nsb - 1)])
        rpos = np.clip(t["sb_rowoff"][sb] + rr, 0, len(t["rowcell"]) - 1)
        cpos = np.clip(t["sb_coloff"][sb] + cc, 0, len(t["colcell"]) - 1)
        cr, cl = t["rowcell"][rpos], t["colcell"][cpos]
        wpos = np.clip(t["sb_celloff"][sb] + jo * t["sb_cells"][sb]
                       + cr * t["sb_ncc"][sb] + cl, 0, len(t["winsrc"]) - 1)
        ws = t["winsrc"][wpos]
        good = live & (cr >= 0) & (cl >= 0) & (ws >= 0)
        sl = slice(e0, e0 + len(i))
        ok[sl] = good
        src[sl] = np.where(good, ws + t["rowin"][rpos] * t["windk"][wpos]
                           + t["colin"][cpos], 0)
    return src, ok


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
@pytest.mark.parametrize("tile,sb_max", [(PLACE_TILE, PLACE_SB), (64, 2)])
def test_place_walk_matches_place_src(system, t, side, tile, sb_max):
    """K14's block walk (tiles, the zero tail, staged superblocks, the
    per-element search past ``sb_max``; emulated by :func:`_place_walk`)
    picks every slab element's OUT index and coverage exactly as
    place_v3_src (the reference's _place arithmetic): the whole slab with
    its tail and sentinel, a window at c0 > 0 of odd length, and one
    across the live end."""
    _, p3, _ = _plan(Site(*system, t), side)
    d = mixv3.v3_tables(p3, "cpu", torch.float64)
    total, n = p3.meta_out.total, p3.ncap_out + 1
    for c0, m in ((0, n), (total // 3 + 1, 999), (total - 7, 1001)):
        want_src, want_ok = (x.numpy() for x in mixv3.place_v3_src(d, c0, m))
        src, ok = _place_walk(p3.tables, c0, m, tile, sb_max)
        assert np.array_equal(ok, want_ok)
        assert np.array_equal(src[ok], want_src[ok])
        assert not ok[max(0, total - c0):].any()


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_execute_mix_v3_matches_jax_and_v4(system, t, side):
    """execute_mix_v3 (f64) against the reference's on the same plan and
    pool, and against the port's v4 pool (mirrors
    test_mixv3.py::test_mixv3_matches_v2)."""
    import jax.numpy as jnp
    r3, p3, pool = _plan(Site(*system, t), side)
    ref = np.asarray(ref_mixv3.execute_mix_v3(r3, jnp.asarray(pool),
                                              dtype=np.float64))
    ep = interop.slab_pool(pool, "cpu")
    got = mixv3.execute_mix_v3(p3, ep).numpy()
    _close(got, ref, 1e-12)
    assert got[-1] == 0.0
    v4 = mixv4.execute_mix_v4(mixv4.plan_v4(p3), ep).numpy()
    _close(got, v4, 1e-12)


def test_execute_mix_v3_f32(system):
    """float32 pools (mirrors test_mixv3.py::test_mixv3_f32)."""
    import jax.numpy as jnp
    r3, p3, pool = _plan(Site(*system, SITES[1]), "lw")
    pool = pool.astype(np.float32)
    ref = np.asarray(ref_mixv3.execute_mix_v3(r3, jnp.asarray(pool),
                                              dtype=np.float32))
    got = mixv3.execute_mix_v3(p3, interop.slab_pool(pool, "cpu",
                                                     np.float32))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)


def test_complex_plan_in_a_real_dtype_raises(system):
    """The reference's executor takes wv.real; the port refuses."""
    site = Site(*system, SITES[1])
    meta, pool = site.ref_pool("lw")
    ent, quanta, fused = site.ppos["lw"]
    cent = {k: w.astype(np.complex128) for k, w in ent.items()}
    p3 = mixv3.build_mix_plan_v3(interop.stacked_meta(meta), cent, quanta,
                                 fused, **site.pkw["lw"])
    assert p3.iscpx
    with pytest.raises(TypeError):
        mixv3.execute_mix_v3(p3, torch.as_tensor(pool))


def _port_site(site, t, caches):
    """The port's ResidentSite at t on its device environment chain (CPU
    tensors)."""
    me = PortME(site.pmpo, site.pmps, device=torch.device("cpu"))
    me.init_environments()
    for s in range(t):
        me.update_left(s)
    eff = PortEff(me, t, assemble=False)
    return resident.ResidentSite(me, eff, "cpu", caches=caches), eff


def test_plan_without_windows_runs_v3(system, monkeypatch):
    """A v3 plan with no place windows has no v4 form (plan_v4 returns
    None); ResidentSite under B2TPU_MIX=4 runs it through v3, and the
    pools equal the v4 ones."""
    monkeypatch.setenv("B2TPU_MIX", "4")
    site = Site(*system, SITES[1])
    rs4, _ = _port_site(site, SITES[1], {})
    assert isinstance(rs4.pl, MixPlanV4)
    build = resident.build_mix_plan_v3

    def no_windows(*a, **kw):
        p = build(*a, **kw)
        p.winflat = {k: v[:0] for k, v in p.winflat.items()}
        return p

    monkeypatch.setattr(resident, "build_mix_plan_v3", no_windows)
    rs, eff = _port_site(site, SITES[1], {})
    assert mixv4.plan_v4(rs.pl) is None
    assert isinstance(rs.pl, MixPlanV3) and isinstance(rs.pr, MixPlanV3)
    assert torch.equal(rs.lw_pool, rs4.lw_pool)
    assert torch.equal(rs.rw_pool, rs4.rw_pool)
    x0 = np.random.RandomState(2).standard_normal(eff.size)
    th, _, _ = rs.solve_ground_state(x0 / np.linalg.norm(x0),
                                     conv_thrd=1e-12, max_iter=200)
    th4, _, _ = rs4.solve_ground_state(x0 / np.linalg.norm(x0),
                                       conv_thrd=1e-12, max_iter=200)
    assert abs(th - th4) < 1e-10


def test_plan_cache_rebuilds_when_the_engine_changes(system, monkeypatch):
    """One cache across engines: a change of B2TPU_MIX rebuilds the plans
    (the engine is part of the signature), and every engine gives the
    same pools."""
    site = Site(*system, SITES[1])
    caches = {}
    kinds = {"4": MixPlanV4, "3": MixPlanV3, "2": resident.MixPlan}
    pools = []
    for ver in ("4", "3", "2", "4"):
        monkeypatch.setenv("B2TPU_MIX", ver)
        rs, _ = _port_site(site, SITES[1], caches)
        assert isinstance(rs.pl, kinds[ver]) and \
            isinstance(rs.pr, kinds[ver]), ver
        pools.append((rs.lw_pool, rs.rw_pool))
    for lw, rw in pools[1:]:
        scale = float(pools[0][0].abs().max())
        assert float((lw - pools[0][0]).abs().max()) <= 1e-12 * scale
        assert float((rw - pools[0][1]).abs().max()) <= 1e-12 * scale


SCHED = dict(bond_dims=[20] * 4, noises=[1e-5] * 3 + [0], thrds=[1e-12],
             n_sweeps=4, tol=0)


def test_resident_under_mix3_matches_jax(monkeypatch):
    """torch_resident under B2TPU_MIX=3 (K13/K14 twins) against
    jax_resident under the same variable, Hubbard-L6, D=20."""
    monkeypatch.setenv("B2TPU_MIX", "3")
    monkeypatch.setenv("B2TPU_RES_MIN_SIZE", "1")
    monkeypatch.delenv("B2TPU_RES_EDGE_HOST", raising=False)
    drv, mpo = hubbard_driver(L=6)
    sched = (SCHED["bond_dims"], SCHED["noises"], SCHED["thrds"])
    e_ref = RefDMRG(mpo, drv.get_random_mps(20, seed=7),
                    backend="jax_resident", iprint=0,
                    dtype=np.float64).solve(*sched, n_sweeps=4, tol=0)
    s = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(20, seed=7)),
             device="cpu", iprint=0)
    e = s.solve(*sched, n_sweeps=4, tol=0)
    assert abs(e - e_ref) < 1e-8, (e, e_ref)
    assert all(isinstance(p, MixPlanV3)
               for _, p in s._res_caches["mix"].values())
    assert s.host_redo_count == 0 and s.host_ops_downloads == 0
    assert s.sweep_log[0]["mix_plan"] > 0
