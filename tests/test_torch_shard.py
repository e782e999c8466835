"""The operator-sharded engines of the port (kernels K20-K22 through their
plain twins, torch.distributed on the CPU under gloo) against the JAX
package's sharded functions on its 8 virtual CPU devices.

Per-rank partials: for a world of W ranks, each rank's share of the
matvec (K20's twin) and of the blocking (K21's twin) equals the
reference's local scan (``_mv_scan`` / ``_blk_scan``) fed that device's
round-robin slice of the task groups, run outside ``shard_map``; the ranks'
sum equals the reference's ``shard_map`` + ``psum`` result on
``default_mesh(W)``.  The plans are built under small stage budgets so
that they split into many task groups.  ``ShardedPlanExecutor`` (K22's
twin) and ``pooled_gram(device=mesh)`` (K17's twin on row slices) against
the reference's sharded versions.  One test spawns two gloo ranks that run
a sharded DMRG through real collectives."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import torch.distributed as dist

import block2_preview_tpu.ops.blockv2 as ref_bv2
import block2_preview_tpu.ops.tilev2 as ref_tv2
from block2_preview_tpu.dmrg import npdm_scheme as ref_scheme
from block2_preview_tpu.ops.stacked import _cap_class
from block2_preview_tpu.parallel.shard import (
    ShardedPlanExecutor as RefSharded, default_mesh as ref_mesh)

import block2_preview_tpu_torch.ops.blockv2 as bv2
import block2_preview_tpu_torch.ops.tilev2 as tv2
import chip_smoke
from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg import npdm_scheme
from block2_preview_tpu_torch.ops import chain_mv, exec_bucket
from block2_preview_tpu_torch.ops.stacked import site_pools
from block2_preview_tpu_torch.parallel import multihost
from block2_preview_tpu_torch.parallel.shard import (ShardedPlanExecutor,
                                                     default_mesh)

from test_torch_blockv2 import (BONDS, _plans, blk_walk,  # noqa: F401
                                chain, check_k5_tables)
from test_torch_npdm import _solved
from test_torch_plan_exec import l8  # noqa: F401
from test_torch_plans import SITES, Site, hubbard_system
from test_torch_tilev2 import _ref_pools

TOL = 1e-12
WORLDS = [1, 2, 3, 8]


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-300))


@pytest.fixture(scope="module")
def mesh1():
    """A port mesh of world size 1 on the CPU (gloo, an in-process
    store), destroyed after this module."""
    mesh = multihost.global_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# K20: the matvec's per-rank partials
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mv_site():
    """The reference's matvec at the Hubbard-L8 mid center under stage
    budgets that split it into many task groups, its JAX-mixed LW/RW
    pools and the port's MatvecV2 on the same struct."""
    site = Site(*hubbard_system(), SITES[1])
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    f = site.ref_matvec(pl, pr, T=16).struct["it"].astype(np.int64)
    na, nk, npp, nn = f[:, 8], f[:, 9], f[:, 10], f[:, 11]
    cfg = (int(max((na * nn * nk).max(), (na * nn * npp).max())),
           max(int((na * nn).max()), 1))
    saved = ref_tv2._CFG[16]
    ref_tv2._CFG[16] = cfg
    try:
        ref_ex = site.ref_matvec(pl, pr, T=16)
    finally:
        ref_tv2._CFG[16] = saved
    assert ref_ex.struct["ng_live"] >= 8, "budgets did not force groups"
    return ref_ex, interop.matvec_v2(ref_ex), lw, rw


@pytest.mark.parametrize("world", WORLDS)
def test_matvec_rank_partials_match_reference(mv_site, world):
    ref_ex, ex, lw, rw = mv_site
    s = ref_ex.struct
    ng = s["ng_live"]
    want = ref_tv2.shard_groups(s["g1"][:ng], s["g2"][:ng], s["cum1"],
                                s["cum2"], world)
    got = ex.sharded_groups(world)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    g1i, g2i, e1i, e2i, ngl = want
    d = ref_ex.to_device()
    lt, rt = ref_ex.tile_pools(jnp.asarray(lw), jnp.asarray(rw))
    xh = ex.pad(np.random.RandomState(3).standard_normal(ex.size))
    xj = jnp.asarray(xh)
    xt = torch.as_tensor(xh)
    tl, tr = interop.slab_pool(lw, "cpu"), interop.slab_pool(rw, "cpu")
    dv = ex.to_device("cpu")
    total = 0.0
    units = 0
    for r in range(world):
        sl = slice(r * ngl, (r + 1) * ngl)
        sig = ref_tv2._mv_scan(
            xj, lt, rt, d["l_tid"], d["r_tid"], d["psi_idx"], d["it"],
            d["cum1"], d["cum2"], jnp.asarray(g1i[sl]), jnp.asarray(g2i[sl]),
            jnp.asarray(e1i[sl]), jnp.asarray(e2i[sl]), ngl, s["nt1"],
            s["nt2"], s["T"], s["B"])
        ref_r = np.asarray(sig.reshape(-1)[d["sig_idx"]])
        part = ex.rank_part(r, world, "cpu")
        got_r = tv2.mv_exec_part(xt, tl, tr, dv, part, s["T"],
                                 s["nt2"]).numpy()
        assert np.abs(got_r - ref_r).max() <= TOL * np.abs(ref_r).max() \
            + 1e-300
        total = total + got_r
        units += part["n_units"]
    assert units == dv["n_units"]      # every unit on exactly one rank
    sharded = np.asarray(ref_ex.matvec_device_sharded(
        xj, jnp.asarray(lw), jnp.asarray(rw), ref_mesh(world)))
    assert rel(total, sharded) < TOL


@pytest.mark.parametrize("world", WORLDS)
def test_matvec_rank_chunks_match_reference(mv_site, world):
    """K20's chunk tables of each rank (its groups' items only, entries
    pointing into K1's items): every entry of the rank's items once, a
    chunk within one sigma piece; walked as the kernel walks them, each
    rank's partial equals the reference's per-device scan, and the ranks'
    entries together are K1's."""
    from test_torch_tilev2 import check_chunks
    ref_ex, ex, lw, rw = mv_site
    s = ref_ex.struct
    ng = s["ng_live"]
    g1i, g2i, e1i, e2i, ngl = ref_tv2.shard_groups(
        s["g1"][:ng], s["g2"][:ng], s["cum1"], s["cum2"], world)
    d = ref_ex.to_device()
    lt, rt = ref_ex.tile_pools(jnp.asarray(lw), jnp.asarray(rw))
    xh = ex.pad(np.random.RandomState(6).standard_normal(ex.size))
    tl, tr = interop.slab_pool(lw, "cpu"), interop.slab_pool(rw, "cpu")
    dv = ex.to_device("cpu")
    items = dv["chain"]["items"].numpy().astype(np.int64)
    all_ent = []
    for r in range(world):
        sl = slice(r * ngl, (r + 1) * ngl)
        sig = ref_tv2._mv_scan(
            jnp.asarray(xh), lt, rt, d["l_tid"], d["r_tid"], d["psi_idx"],
            d["it"], d["cum1"], d["cum2"], jnp.asarray(g1i[sl]),
            jnp.asarray(g2i[sl]), jnp.asarray(e1i[sl]), jnp.asarray(e2i[sl]),
            ngl, s["nt1"], s["nt2"], s["T"], s["B"])
        ref_r = np.asarray(sig.reshape(-1)[d["sig_idx"]])
        c = ex.rank_part(r, world, "cpu")["chain"]
        tab = {"ent": c["ent"].numpy(), "ck": c["ck"].numpy()}
        mine = np.unique(tab["ent"][:, 0].astype(np.int64))
        if len(tab["ent"]):
            sub = {"ent": np.stack([np.searchsorted(mine, tab["ent"][:, 0]),
                                    tab["ent"][:, 1]], 1).astype(np.int32),
                   "ck": tab["ck"]}
            fl = chain_mv.entries(items[mine])["flops"]
            check_chunks(items[mine], sub,
                         max(fl.sum() / chain_mv.TARGET_CHUNKS, 1.0))
        got = chain_mv.chain_plain(
            torch.as_tensor(xh), tl, tr, {"items": dv["chain"]["items"],
                                          **c}, len(ref_r)).numpy()
        assert np.abs(got - ref_r).max() <= TOL * max(np.abs(ref_r).max(),
                                                      1e-300)
        all_ent += [tuple(e) for e in tab["ent"].tolist()]
    k1 = tv2.k1_host(ex.struct)
    assert sorted(all_ent) == sorted(tuple(e) for e in k1["ent"].tolist())


def test_matvec_sharded_on_a_world_of_one(mv_site, mesh1):
    """matvec_device_sharded on the port's world-1 mesh (twin + a real
    all_reduce) equals the one-device matvec."""
    _, ex, lw, rw = mv_site
    xt = torch.as_tensor(ex.pad(np.random.RandomState(5).standard_normal(
        ex.size)))
    tl, tr = interop.slab_pool(lw, "cpu"), interop.slab_pool(rw, "cpu")
    n0 = multihost.stats["all_reduce"]
    got = ex.matvec_device_sharded(xt, tl, tr, mesh1)
    assert multihost.stats["all_reduce"] == n0 + 1
    assert rel(got.numpy(), ex.matvec_device(xt, tl, tr).numpy()) < TOL


def test_group_units_refuses_groups_that_split_items():
    """A stage-2 range that does not cover its stage-1 range's items is
    refused (the rank's partial would not be the reference's)."""
    cum1 = np.array([0, 2, 4, 6])
    cum2 = np.array([0, 3, 6, 9])
    cumu = np.array([0, 1, 2, 3])
    h = tv2.group_units([0], [4], [0], [6], cum1, cum2, cumu)
    assert h["items"] == [(0, 2)] and list(h["units"]) == [0, 1]
    assert list(h["t1"]) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="same whole items"):
        tv2.group_units([0], [4], [0], [3], cum1, cum2, cumu)
    with pytest.raises(ValueError, match="same whole items"):
        tv2.group_units([1], [4], [3], [6], cum1, cum2, cumu)


# ---------------------------------------------------------------------------
# K21: the blocking's per-rank partials
# ---------------------------------------------------------------------------

def _budget_plans(chain, monkeypatch, mix):
    """Reference and port plans of the left step at the last bond under
    budgets that force many task groups (test_torch_blockv2's)."""
    t = BONDS["left"][-1]
    _, port0, _ = _plans(chain, t, "left", False, T=16)
    f = port0.it.astype(np.int64)
    nl, nk, nx, ny = f[:, 7], f[:, 8], f[:, 9], f[:, 10]
    nent = np.diff(np.searchsorted(port0.ef[:, 0], np.arange(len(f) + 1)))
    need = int(max((nl * ny * nk).max(), (nx * ny * nl).max(),
                   (nx * ny * nent).max()))
    cfg = (need, int((nl * ny).max()), int((nx * ny).max()))
    monkeypatch.setitem(ref_bv2._CFG, 16, cfg)
    monkeypatch.setitem(bv2._CFG, 16, cfg)
    ref, port, pool = _plans(chain, t, "left", mix, T=16)
    assert len((port.rot if mix else port).g1) >= 8
    return ref, port, pool


def _ref_pack(mats, offs):
    pool = np.zeros(int(offs[-1]) + 1)
    for m, o in zip(mats, offs[:-1]):
        pool[o:o + m.size] = np.asarray(m, np.float64).ravel()
    full = np.zeros(_cap_class(len(pool)))
    full[:len(pool)] = pool
    return jnp.asarray(full)


def _ref_rank_partials(ref, pool, world):
    """The reference's per-device partial output pools of a v2 plan for a
    world of ``world``: its local scan ``_blk_scan`` fed each device's
    round-robin slice of the task groups (blockv2.py:921-946), outside
    ``shard_map``."""
    ns = len(ref.g1)
    ngl = -(-ns // world)

    def ilv(a, fill):      # the reference's interleave (blockv2.py:926)
        out = np.full(ngl * world, fill, dtype=np.int32)
        out[:ns] = a
        return np.ascontiguousarray(out.reshape(ngl, world).T).reshape(-1)

    c1, c2, c3 = (np.asarray(getattr(ref, k)) for k in ("cum1", "cum2",
                                                        "cum3"))
    g = {k: ilv(np.asarray(getattr(ref, k)), c[-1])
         for k, c in (("g1", c1), ("g2", c2), ("g3", c3))}
    e = {k: ilv(np.concatenate([np.asarray(getattr(ref, gk))[1:], c[-1:]]),
                c[-1])
         for k, gk, c in (("e1", "g1", c1), ("e2", "g2", c2),
                          ("e3", "g3", c3))}
    ep = jnp.asarray(pool)
    bp, kp = _ref_pack(*ref.bra_pool), _ref_pack(*ref.ket_pool)
    coef = jnp.asarray(np.asarray(ref.coef).real.astype(np.float64))
    for r in range(world):
        sl = slice(r * ngl, (r + 1) * ngl)
        out = ref_bv2._blk_scan(
            ep, bp, kp, jnp.asarray(ref.it), jnp.asarray(ref.ef), coef,
            jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(c3),
            *(jnp.asarray(g[k][sl]) for k in ("g1", "g2", "g3")),
            *(jnp.asarray(e[k][sl]) for k in ("e1", "e2", "e3")), ngl,
            ref.nt1, ref.ntp, ref.T, ref.B, ref.left, ref.ncap)
        yield np.asarray(out)


@pytest.mark.parametrize("world", WORLDS)
def test_blocking_rank_partials_match_reference(chain, monkeypatch,  # noqa
                                                world):
    ref, port, pool = _budget_plans(chain, monkeypatch, False)
    tp = interop.slab_pool(pool, "cpu")
    pb, pk = site_pools(port, torch.device("cpu"), torch.float64)
    d = bv2.blk_tables(port, "cpu", torch.float64)
    total = 0.0
    for r, ref_r in enumerate(_ref_rank_partials(ref, pool, world)):
        part = bv2.blk_rank_part(port, r, world, "cpu")
        got_r = bv2.blk_exec_part(tp, pb, pk, d, part, port.T, port.left,
                                  torch.zeros(port.ncap,
                                              dtype=torch.float64)).numpy()
        scale = max(np.abs(ref_r).max(), 1e-300)
        assert np.abs(got_r - ref_r).max() <= TOL * scale
        total = total + got_r
    sharded = np.asarray(ref_bv2.execute_blocking_v2(
        ref, jnp.asarray(pool), dtype=np.float64, mesh=ref_mesh(world)))
    assert rel(total, sharded) < TOL


@pytest.mark.parametrize("mix", [False, True], ids=["v2", "v3"])
@pytest.mark.parametrize("world", WORLDS)
def test_blocking_rank_runs_walk_matches_reference(chain, monkeypatch,
                                                   world, mix):
    """K21's tables (blk_rank_part's ``k5``, and the same tables with a
    staging of 24 elements, which sends the wider items down the tile
    path): each rank's slab runs and tile-path units cover exactly the
    items of its task groups (check_k5_tables), the ranks' items
    partition the plan's live items, and each rank's walk in the kernel's
    order (blk_walk) matches the reference's partial for that device
    (_blk_scan on its groups) to 1e-12; on v3 rotate plans each element
    has one writer, so the ranks' walks summed equal one walk of the
    whole plan bitwise."""
    ref, port, pool = _budget_plans(chain, monkeypatch, mix)
    rp, rr = (port.rot, ref.rot) if mix else (port, ref)
    bp, kp = site_pools(rp, torch.device("cpu"), torch.float64)
    pools = (pool, bp.numpy(), kp.numpy())
    live = np.flatnonzero(np.diff(rp.cum1.astype(np.int64)) > 0)
    refs = list(_ref_rank_partials(rr, pool, world))
    for stage in (bv2.K5_STAGE, 24):
        seen, total = [], 0.0
        for r, ref_r in enumerate(refs):
            part = bv2.blk_rank_part(rp, r, world, "cpu")
            h = part["k5"] if stage == bv2.K5_STAGE else \
                bv2.k5_host_tables(rp, items=part["items"], stage=stage)
            check_k5_tables(rp, h, items=part["items"])
            seen.append(np.concatenate([h["small"], h["large"]]))
            got_r = blk_walk(rp, h, pools, np.float64)
            scale = max(np.abs(ref_r).max(), 1e-300)
            assert np.abs(got_r - ref_r).max() <= TOL * scale
            total = total + got_r
        assert np.array_equal(np.sort(np.concatenate(seen)), live)
        if mix and stage == bv2.K5_STAGE:
            one = blk_walk(rp, bv2.k5_host_tables(rp), pools, np.float64)
            assert np.array_equal(total, one)


@pytest.mark.parametrize("mix", [False, True], ids=["v2", "v3"])
def test_blocking_sharded_on_a_world_of_one(chain, monkeypatch,  # noqa
                                            mesh1, mix):
    """execute_blocking_v2/_v3 with the port's world-1 mesh (K21's twin +
    all_reduce; v3's mix stage unsharded) against the reference's sharded
    blocking on the 8-device mesh."""
    ref, port, pool = _budget_plans(chain, monkeypatch, mix)
    run = bv2.execute_blocking_v3 if mix else bv2.execute_blocking_v2
    ref_run = ref_bv2.execute_blocking_v3 if mix \
        else ref_bv2.execute_blocking_v2
    got = run(port, interop.slab_pool(pool, "cpu"), mesh=mesh1).numpy()
    want = np.asarray(ref_run(ref, jnp.asarray(pool), dtype=np.float64,
                              mesh=ref_mesh(8)))
    assert rel(got, want) < TOL
    assert not got[port.meta_out.total:].any()


# ---------------------------------------------------------------------------
# K22: ShardedPlanExecutor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_plan_executor_matches_reference(l8, world):  # noqa: F811
    reff, peff = l8
    x = np.random.default_rng(4).standard_normal(reff.size)
    want = RefSharded(reff, ref_mesh(world), dtype=np.float64).matvec(x)
    pe = exec_bucket.PlanExecutor(peff, device="cpu")
    xp = torch.as_tensor(np.concatenate([x, np.zeros(pe.size_p + 1
                                                     - pe.size)]))
    total = 0.0
    items = 0
    for r in range(world):
        part = pe.rank_part(r, world)
        total = total + exec_bucket.plan_exec_part(xp, pe, part).numpy()
        items += len(part["tables"]["items"])
    assert items == len(pe.items)       # no padding item, no item twice
    assert rel(total[:pe.size], want) < 1e-11


@pytest.mark.parametrize("world", WORLDS)
def test_k22_chunk_walk_matches_twin_and_reference(l8, world):  # noqa: F811
    """Each rank's K22 chunk tables walked in the kernel's order
    (chain_mv.chain_plain, A and R read in place from ``vals``) against
    the twin on the rank's sliced buckets (1e-12 relative); the ranks' sum
    against the JAX ShardedPlanExecutor (1e-11) and K18's walk; nothing
    is written past the size."""
    reff, peff = l8
    x = np.random.default_rng(8).standard_normal(reff.size)
    want = RefSharded(reff, ref_mesh(world), dtype=np.float64).matvec(x)
    pe = exec_bucket.PlanExecutor(peff, device="cpu")
    xp = torch.as_tensor(np.concatenate([x, np.zeros(pe.size_p + 1
                                                     - pe.size)]))
    total = 0.0
    for r in range(world):
        part = pe.rank_part(r, world)
        got = chain_mv.chain_plain(xp, pe.vals, pe.vals, part["chain"],
                                   pe.size_p + 1).numpy()
        twin = exec_bucket.plan_exec_part(xp, pe, part).numpy()
        assert np.abs(got - twin).max() <= TOL * max(np.abs(twin).max(),
                                                     1e-300)
        assert not got[pe.size:].any()
        total = total + got
    assert rel(total[:pe.size], want) < 1e-11
    one = chain_mv.chain_plain(xp, pe.vals, pe.vals, pe.k18_tables(),
                               pe.size_p + 1).numpy()
    assert rel(total, one) < TOL


def test_sharded_plan_executor_on_a_world_of_one(l8, mesh1):  # noqa: F811
    reff, peff = l8
    x = np.random.default_rng(6).standard_normal(reff.size)
    spe = ShardedPlanExecutor(peff, mesh1)
    assert spe.device.type == "cpu" and spe.size_p == spe.base.size_p
    want = RefSharded(reff, ref_mesh(8), dtype=np.float64).matvec(x)
    assert rel(spe.matvec(x), want) < 1e-11


# ---------------------------------------------------------------------------
# B22e: pooled_gram's row-sharded closes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2])
def test_pooled_gram_on_a_mesh_matches_reference(mesh1, order):
    mpo, ket = _solved(6, 30, 1, n_sweeps=2)
    G_ref, c_ref = ref_scheme.pooled_gram(ket, order, device=ref_mesh(8),
                                          device_min_flop=0)
    st = {}
    G, c = npdm_scheme.pooled_gram(interop.mps(ket), order, device=mesh1,
                                   device_min_flop=0, stats=st)
    assert np.array_equal(c, c_ref)
    assert all(cl[5] for cl in st["closes"])
    assert np.abs(G - G_ref).max() < TOL


def test_default_mesh_refuses_a_wrong_world():
    with pytest.raises(ValueError, match="need 2 ranks"):
        default_mesh(2, device_type="cpu")


# ---------------------------------------------------------------------------
# the collective path: two gloo ranks
# ---------------------------------------------------------------------------

NUDGE = 1e-8


def nudged_rank(rank, world, init_method, cfg, queue):
    """A rank of :func:`test_two_gloo_ranks_agree_bitwise` (a spawned
    process): chip_smoke's rank program under stage budgets that split the
    small system's plans into task groups every rank owns, with rank 1's
    Davidson subspace matrices nudged by ``NUDGE`` relative."""
    from block2_preview_tpu_torch.ops import device_davidson
    tv2._CFG[16], bv2._CFG[16] = (64, 64), (64, 64, 64)
    if rank > 0:
        eigh = device_davidson.masked_eigh

        def nudged(h, mask, M):
            return eigh(h * (1 + NUDGE), mask, M)

        device_davidson.masked_eigh = nudged
    chip_smoke.shard_rank(rank, world, init_method, cfg, queue)


def test_two_gloo_ranks_agree_bitwise():
    """Two spawned ranks (gloo, a file rendezvous, a group timeout and a
    join deadline) run DMRG(backend="torch_resident", device="cpu",
    mesh=...) on Hubbard-L8 (D=40, 2 sweeps with noise; stage budgets that
    give every rank task groups), then ShardedPlanExecutor and
    pooled_gram(device=mesh) through real collectives.  Rank 1's Davidson
    subspace matrices are nudged by 1e-8 relative (the card's dense
    algebra need not round alike in two processes; the CPU's does): the
    sharded matvec must still take one vector's partials.  Both ranks'
    energies and final states are bitwise equal, within 1e-9 Ha of the
    port's world-1 energy."""
    import time
    L, D = 8, 40
    _, ket6 = _solved(6, 20, 1, n_sweeps=2)
    cfg = dict(device="cpu", system="hubbard", L=L, D=D, n_sweeps=2,
               gram_state=interop.mps(ket6), threads=1, timeout=60)
    t0 = time.time()
    res = chip_smoke.run_ranks(cfg, deadline=60, target=nudged_rank)
    assert time.time() - t0 < 60
    drv, mpo = chip_smoke.hubbard_model(L)
    e1 = drv.dmrg(mpo, drv.get_random_mps(D, seed=7), device="cpu",
                  **chip_smoke.hub_sched(D, 2))
    assert res[0]["energy"] == res[1]["energy"]
    assert res[0]["digest"] == res[1]["digest"]
    assert abs(res[0]["energy"] - e1) < 1e-9
    # both ranks owned matvec units somewhere, and every collective ran
    assert res[1]["idle_matvecs"] < res[1]["matvecs"]
    assert all(w["all_reduce"] > w["matvecs"] for r in res
               for w in r["sweeps"])
    chip_smoke.check_shard_ranks(res, e1, "world 1", False)
