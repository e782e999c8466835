"""Environment blocking of the port (ops/blockv2.py, kernel K5 + K3 for
v3 plans): ``build_blocking_v2`` plans equal the reference's field by
field, and the plain twins on CPU tensors equal the JAX package's
``execute_blocking_v2``/``v3`` on the same plan and pool (rel <= 1e-11)
and the host contraction ``_left_contract``/``_right_contract`` (atol
1e-12), left and right, v2 and v3 — mirroring test_blockv2.py and
test_blockv3.py."""

import numpy as np
import pytest
import torch

import block2_preview_tpu.ops.blockv2 as ref_bv2
from block2_preview_tpu.dmrg.environment import MovingEnvironment as RefME
from block2_preview_tpu.ops.stacked import meta_from_env as ref_meta_from_env

import block2_preview_tpu_torch.ops.blockv2 as bv2
from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.core.blocks import MPSTensor
from block2_preview_tpu_torch.dmrg.environment import MovingEnvironment
from block2_preview_tpu_torch.ops.stacked import env_pool

from test_torch_plans import _eq, hubbard_system

BONDS = {"left": (0, 3, 5), "right": (7, 4, 2)}
_V2_FIELDS = ("T", "B", "nt1", "ntp", "ncap", "left", "it", "ef", "coef",
              "cum1", "cum2", "cum3", "g1", "g2", "g3", "flops")


@pytest.fixture(scope="module")
def chain():
    """Reference and port host environments over one Hubbard-L8 MPS (the
    port's from the converted MPO/MPS), left ones up to the middle."""
    mpo, mps = hubbard_system(D=40)
    rme = RefME(mpo, mps)
    pme = MovingEnvironment(interop.mpo(mpo), interop.mps(mps))
    for me in (rme, pme):
        me.init_environments()
        for s in range(max(BONDS["left"]) + 1):
            me.update_left(s)
    return rme, pme


def _args(me, t, direction):
    """build_blocking_v2 arguments of bond step t, and the source pool."""
    left = direction == "left"
    src = t if left else t + 1
    env = me.left_envs[src] if left else me.right_envs[src]
    mpo = me.mpo
    return ((mpo.tensors[t], mpo.site_quanta[t], me.bra.tensors[t],
             me.ket.tensors[t], mpo.group, direction, mpo.bond_dqs[src],
             mpo.bond_dqs[t + 1 if left else t]), env, src)


def _plans(chain, t, direction, mix, **kw):
    rme, pme = chain
    rargs, renv, src = _args(rme, t, direction)
    pargs, penv, _ = _args(pme, t, direction)
    rmeta = ref_meta_from_env(renv, rme.mpo.bond_dqs[src])
    pmeta, pool = env_pool(penv, pme.mpo.bond_dqs[src], np.float64)
    ref = ref_bv2.build_blocking_v2(rmeta, *rargs, gemm_mix=mix, **kw)
    port = bv2.build_blocking_v2(pmeta, *pargs, gemm_mix=mix, **kw)
    return ref, port, pool


def _same_v2(p, r):
    assert p.meta_out.signature() == hash(
        (tuple((dq, tuple(map(int, ss))) for dq, ss in r.meta_out.groups),
         tuple(tuple(sorted(sec.items())) for sec in r.meta_out.sectors),
         r.meta_out.total))
    for k in _V2_FIELDS:
        _eq(getattr(p, k), getattr(r, k), k)
    for which in ("bra_pool", "ket_pool"):
        (pm, po), (rm, ro) = getattr(p, which), getattr(r, which)
        _eq(po, ro, which)
        _eq(list(pm), list(rm), which)


@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("mix", [True, False], ids=["v3", "v2"])
def test_blocking_plans_equal(chain, direction, mix):
    for t in BONDS[direction]:
        ref, port, _ = _plans(chain, t, direction, mix)
        if mix:
            assert isinstance(port, bv2.BlockingV3Plan)
            _same_v2(port.rot, ref.rot)
            for k in ("ncap", "T", "flops", "rot_total", "gtab", "wdense"):
                _eq(getattr(port, k), getattr(ref, k), k)
        else:
            _same_v2(port, ref)


def _jax_out(ref, pool, mix):
    import jax.numpy as jnp
    run = ref_bv2.execute_blocking_v3 if mix else ref_bv2.execute_blocking_v2
    return np.asarray(run(ref, jnp.asarray(pool), dtype=np.float64))


def _port_out(port, pool, mix, dtype=np.float64):
    run = bv2.execute_blocking_v3 if mix else bv2.execute_blocking_v2
    return run(port, interop.slab_pool(pool, "cpu", dtype)).numpy()


def _check_host(chain, port, out, t, direction):
    """Every host-contracted block appears in the unpacked pool."""
    rme = chain[0]
    host = rme._left_contract(t) if direction == "left" \
        else rme._right_contract(t)
    got = port.meta_out.unpack(out, chain[1].g, None)
    n = 0
    for o, bm in host.items():
        for key, blk in bm.blocks.items():
            g2 = got.get(o)
            g2 = None if g2 is None else g2.blocks.get(key)
            if g2 is None:
                assert np.abs(blk).max() <= 1e-12, (o, key)
                continue
            assert np.abs(g2 - blk).max() <= 1e-12, (o, key)
            n += 1
    assert n > 0


@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("mix", [True, False], ids=["v3", "v2"])
def test_blocking_twin_matches_jax_and_host(chain, direction, mix):
    for t in BONDS[direction]:
        ref, port, pool = _plans(chain, t, direction, mix)
        want = _jax_out(ref, pool, mix)
        got = _port_out(port, pool, mix)
        assert got.shape == want.shape == (port.ncap,)
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()
        # sentinel slots stay exactly zero
        assert not got[port.meta_out.total:].any()
        _check_host(chain, port, got, t, direction)


def test_blocking_twin_chunk_boundary(chain, monkeypatch):
    """The twin processes items in chunks; with a one-task chunk budget
    every item is its own chunk, and with the reference's stage budgets
    cut down the plan splits into many task groups (which K5 does not
    read).  Plans and results stay equal to the JAX package's (mirrors
    test_blockv2.py::test_blockv2_multigroup)."""
    t = BONDS["left"][-1]
    ref0, port0, pool = _plans(chain, t, "left", False, T=16)
    f = port0.it.astype(np.int64)
    nl, nk, nx, ny = f[:, 7], f[:, 8], f[:, 9], f[:, 10]
    nent = np.diff(np.searchsorted(port0.ef[:, 0], np.arange(len(f) + 1)))
    need = int(max((nl * ny * nk).max(), (nx * ny * nl).max(),
                   (nx * ny * nent).max()))
    cfg = (need, int((nl * ny).max()), int((nx * ny).max()))
    monkeypatch.setitem(ref_bv2._CFG, 16, cfg)
    monkeypatch.setitem(bv2._CFG, 16, cfg)
    monkeypatch.setattr(bv2, "_TWIN_TASKS", 1)
    for mix in (False, True):
        ref, port, pool = _plans(chain, t, "left", mix, T=16)
        inner = port.rot if mix else port
        assert len(inner.g1) > 2, "budgets did not force task groups"
        _same_v2(inner, ref.rot if mix else ref)
        want = _jax_out(ref, pool, mix)
        got = _port_out(port, pool, mix)
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


def test_blocking_twin_f32(chain):
    ref, port, pool = _plans(chain, BONDS["right"][1], "right", True)
    want = _jax_out(ref, pool, True)
    got = _port_out(port, pool, True, np.float32)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_device_chain_matches_host_chain():
    """The port's device environment chain (CPU tensors, K5 + K3 twins)
    gives the host chain's environments at every bond, and the cached
    plans take the new site values on a signature hit."""
    mpo, mps = hubbard_system(D=30)
    pmpo, pmps = interop.mpo(mpo), interop.mps(mps)
    dev = MovingEnvironment(pmpo, pmps, device=torch.device("cpu"))
    host = MovingEnvironment(pmpo, pmps)
    for _ in range(2):
        dev.init_environments()
        host.init_environments()
        for b in range(2, mpo.n_sites):
            got = dev.right_envs[b]         # materializes (counted)
            for s, bm in host.right_envs[b].items():
                for key, blk in bm.blocks.items():
                    g2 = got[s].blocks.get(key) if s in got else None
                    if g2 is None:
                        assert np.abs(blk).max() <= 1e-12
                    else:
                        assert np.abs(g2 - blk).max() <= 1e-12
        # new site tensors of the same structure (as a sweep makes them):
        # the next pass hits the plan cache and must refresh the values
        pmps.tensors = [MPSTensor(T.group, {k: 0.5 * b for k, b in
                                            T.blocks.items()})
                        for T in pmps.tensors]
    assert dev.host_env_materialized == 2 * (mpo.n_sites - 2)
    assert dev.max_rot_pool > 0


def test_blocking_refuses_complex_plans(chain):
    """A complex plan is refused rather than run with its imaginary parts
    dropped (the reference's f64 cast of a complex pool did that)."""
    _, port, pool = _plans(chain, BONDS["left"][1], "left", True)
    port.wdense = port.wdense.astype(np.complex128)
    with pytest.raises(TypeError, match="complex"):
        bv2.execute_blocking_v3(port, interop.slab_pool(pool, "cpu"))
    _, port, pool = _plans(chain, BONDS["left"][1], "left", False)
    port.coef = port.coef.astype(np.complex128)
    with pytest.raises(TypeError, match="complex"):
        bv2.execute_blocking_v2(port, interop.slab_pool(pool, "cpu"))


# ---------------------------------------------------------------------------
# K5's tables, walked as csrc/blocking.cuh walks them
# ---------------------------------------------------------------------------

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def check_k5_tables(plan, h, items=None):
    """K5's tables of ``plan`` (or of its item ranges ``items``): every
    live item of the selection lies in exactly one slab run or takes the
    tile path, a run joins at most K5_RUN items with equal bbase, kbase and
    dims (its header's), runs by decreasing FLOPs, each run item's row is
    (env offset, its entry range), and the tile path's units are exactly
    the stage-1 units of its items (on exclusive plans those of li = 0,
    one a column strip)."""
    it = plan.it.astype(np.int64)
    live = np.diff(plan.cum1.astype(np.int64)) > 0
    if items is not None:
        sel = np.zeros(len(it), bool)
        for a, b in items:
            sel[a:b] = True
        live &= sel
    assert h["rh"].dtype == h["wt"].dtype == h["units"].dtype == np.int32
    efs = bv2._efs(plan)
    held = np.zeros(len(it), np.int64)
    np.add.at(held, h["small"], 1)
    np.add.at(held, h["large"], 1)
    assert np.array_equal(held, live.astype(np.int64))
    rh = h["rh"].astype(np.int64)
    wt = h["wt"].astype(np.int64)
    assert rh.shape[1] == 9 and (rh[:, 8] == 0).all()
    w = np.zeros(len(wt), np.int64)
    for p0, p1, bb, kb, dl, dx, dk, dy, _ in rh:
        assert 0 < p1 - p0 <= bv2.K5_RUN
        w[p0:p1] += 1
        f = it[h["small"][p0:p1]]
        assert (f[:, [5, 3, 2, 6, 1, 4]] == [bb, kb, dl, dx, dk, dy]).all()
    assert (w == 1).all()
    fl = (rh[:, 1] - rh[:, 0]) * rh[:, 4] * rh[:, 7] * (rh[:, 6] + rh[:, 5])
    assert (np.diff(fl) <= 0).all()
    s = h["small"]
    assert np.array_equal(wt, np.stack([it[s, 0], efs[s], efs[s + 1]], 1))
    cu = bv2._cumu(plan)
    # exclusive plans: the units li = 0 only (a block a column strip)
    want = [np.arange(cu[i], cu[i] + it[i, 10] if h["excl"] else cu[i + 1])
            for i in h["large"]]
    assert np.array_equal(h["units"], np.concatenate(
        want + [np.zeros(0, np.int64)]))
    if h["excl"]:
        assert (efs[s + 1] - efs[s] == 1).all()


def blk_walk(plan, h, pools, dtype, rows=16):
    """K5's tables walked in numpy and ``dtype`` as the kernel walks them:
    the slab path run by run and item by item, the rows of E in runs of
    ``rows`` (tmp = E[run] MK, r = MB[run]^T tmp; exclusive plans store
    coef x r, then add it, into the item's one entry block; fan-out plans
    sum r over the runs first, then add coef x r into each entry's block),
    then the tile path unit by unit (item, li, yi): its strip of tmp and
    the partial product over li added, times coef, into every entry of the
    item (on exclusive plans a unit (item, 0, yi) adds those of li = 0, 1,
    ... in order into its column strip).  Returns the output pool
    [ncap]."""
    ep, bp, kp = (np.asarray(p, dtype) for p in pools)
    out = np.zeros(plan.ncap, dtype)
    it, ef = plan.it.astype(np.int64), plan.ef.astype(np.int64)
    coef = plan.coef.astype(dtype)
    left = plan.left

    def ops(bb, kb, dl, dx, dk, dy):
        mb = bp[bb:bb + dl * dx]
        mb = mb.reshape(dl, dx) if left else mb.reshape(dx, dl).T
        mk = kp[kb:kb + dk * dy]
        mk = mk.reshape(dk, dy) if left else mk.reshape(dy, dk).T
        return mb, mk

    def block(en):
        _, ob, odx, ody = ef[en]
        return out[ob:ob + odx * ody].reshape(odx, ody)

    wt = h["wt"].astype(np.int64)
    for p0, p1, bb, kb, dl, dx, dk, dy, _ in h["rh"].astype(np.int64):
        mb, mk = ops(bb, kb, dl, dx, dk, dy)
        for w in range(p0, p1):
            e = ep[wt[w, 0]:wt[w, 0] + dl * dk].reshape(dl, dk)
            r = np.zeros((dx, dy), dtype)
            for l0 in range(0, dl, rows):
                part = mb[l0:l0 + rows].T @ (e[l0:l0 + rows] @ mk)
                if h["excl"]:
                    o = block(wt[w, 1])
                    xm, ym = min(dx, o.shape[0]), min(dy, o.shape[1])
                    o[:xm, :ym] += coef[wt[w, 1]] * part[:xm, :ym]
                else:
                    r += part
            if not h["excl"]:
                for en in range(wt[w, 1], wt[w, 2]):
                    o = block(en)
                    xm, ym = min(dx, o.shape[0]), min(dy, o.shape[1])
                    o[:xm, :ym] += coef[en] * r[:xm, :ym]
    T = plan.T
    cu = bv2._cumu(plan)
    efs = bv2._efs(plan)
    for u in h["units"].astype(np.int64):
        i = int(np.searchsorted(cu, u, "right")) - 1
        f = it[i]
        ny = f[10]
        l0, yi = divmod(int(u - cu[i]), ny)
        dl, dk, dx, dy = f[2], f[1], f[6], f[4]
        mb, mk = ops(f[5], f[3], dl, dx, dk, dy)
        e = ep[f[0]:f[0] + dl * dk].reshape(dl, dk)
        ys = slice(yi * T, (yi + 1) * T)
        for li in range(l0, f[7] if h["excl"] else l0 + 1):
            ls = slice(li * T, (li + 1) * T)
            part = mb[ls].T @ (e[ls] @ mk[:, ys])
            for en in range(efs[i], efs[i + 1]):
                o = block(en)[:, ys]
                xm = min(dx, o.shape[0])
                o[:xm] += coef[en] * part[:xm, :o.shape[1]]
    return out


@pytest.mark.parametrize("stage,rows", [(bv2.K5_STAGE, 16), (24, 4)],
                         ids=["stage", "tiny"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mix", [True, False], ids=["v3", "v2"])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_k5_walk_matches_jax(chain, direction, mix, dtype, stage, rows):
    """At every bond of the chain: K5's tables (check_k5_tables; with a
    staging of 24 elements the wider items take the tile path, and the
    rows of E are walked in runs of 4 so that an item's later runs add
    into its block), walked as the kernel walks them (blk_walk) in
    ``dtype``, against the JAX
    package's execute_blocking_v2 (v2 plans, and the v3 plans' ROT pool
    through their rotate plan) and execute_blocking_v3 (the walk's ROT
    pool through K3's plain version), f64 to 1e-12 and f32 to 1e-5
    relative; the ROT pool's slots above its total stay zero, and on the
    v3 plans every item stores its own block (excl)."""
    import jax.numpy as jnp
    from block2_preview_tpu_torch.ops import mixv4
    n_large = 0
    for t in BONDS[direction]:
        ref, port, pool = _plans(chain, t, direction, mix)
        rp = port.rot if mix else port
        h = bv2.k5_host_tables(rp, stage=stage)
        check_k5_tables(rp, h)
        assert h["excl"] == mix
        n_large += len(h["large"])
        bp, kp = bv2.site_pools(rp, "cpu", torch.float64)
        got = blk_walk(rp, h, (pool, bp.numpy(), kp.numpy()), dtype, rows)
        assert got.dtype == dtype
        want = np.asarray(ref_bv2.execute_blocking_v2(
            ref.rot if mix else ref, jnp.asarray(pool), dtype=np.float64))
        total = rp.meta_out.total if not mix else port.rot_total
        assert not got[total:].any()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= TOL[dtype] * scale
        if mix:
            d3 = bv2.mix_tables(port, "cpu", torch.float64)
            fin = mixv4.mix_twin(torch.as_tensor(got.astype(np.float64)),
                                 d3["wpool"], d3,
                                 torch.zeros(port.ncap,
                                             dtype=torch.float64)).numpy()
            want3 = _jax_out(ref, pool, True)
            assert np.abs(fin - want3).max() <= TOL[dtype] * \
                np.abs(want3).max()
    assert (n_large > 0) == (stage < bv2.K5_STAGE)


@pytest.fixture(scope="module")
def wide_chain():
    """As ``chain``, at D=120 after one host sweep: its right bond 4 has
    items of dl = 17 > T = 16, two strips of l."""
    mpo, mps = hubbard_system(D=120, n_sweeps=1)
    rme = RefME(mpo, mps)
    pme = MovingEnvironment(interop.mpo(mpo), interop.mps(mps))
    for me in (rme, pme):
        me.init_environments()
        for s in range(4):
            me.update_left(s)
    return rme, pme


@pytest.mark.parametrize("mix", [True, False], ids=["v3", "v2"])
@pytest.mark.parametrize("direction,t", [("left", 3), ("right", 4)])
def test_k5_tile_path_sums_strips_of_l(wide_chain, direction, t, mix):
    """K5's tile path over items with more than one strip of l (T = 16, a
    staging of 24 elements so every wide item takes it): on the v3 plans
    one unit a column strip (item, 0, yi) sums the strips li = 0, 1, ...
    itself (check_k5_tables), on v2 plans one unit a strip; walked as the
    kernel walks them (blk_walk), against the JAX package's
    execute_blocking_v2 to 1e-12 relative."""
    import jax.numpy as jnp
    ref, port, pool = _plans(wide_chain, t, direction, mix, T=16)
    rp = port.rot if mix else port
    h = bv2.k5_host_tables(rp, stage=24)
    check_k5_tables(rp, h)
    nl = rp.it[h["large"], 7]
    assert (nl > 1).any() == (direction == "right")
    ny = rp.it[h["large"], 10]
    assert len(h["units"]) == int((ny if mix else nl * ny).sum())
    bp, kp = bv2.site_pools(rp, "cpu", torch.float64)
    got = blk_walk(rp, h, (pool, bp.numpy(), kp.numpy()), np.float64)
    want = np.asarray(ref_bv2.execute_blocking_v2(
        ref.rot if mix else ref, jnp.asarray(pool), dtype=np.float64))
    assert np.abs(got - want).max() <= TOL[np.float64] * np.abs(want).max()


def test_k5_tables_cached_and_device(chain):
    """blk_tables keeps K5's host tables on the plan (``_dev["k5"]``) and
    its device tables beside the shared layout; the slab path's runs and
    the tile path's units are what k5_host_tables gives."""
    _, port, _ = _plans(chain, BONDS["left"][1], "left", True)
    rp = port.rot
    d = bv2.blk_tables(rp, "cpu", torch.float64)
    h = rp._dev["k5"]
    assert d["n_runs"] == len(h["rh"]) and d["excl"] == 1
    assert np.array_equal(d["rh"].numpy(), h["rh"])
    assert np.array_equal(d["wt"].numpy(), h["wt"])
    assert d["n_lunits"] == len(h["units"]) == 0
    assert bv2.blk_tables(rp, "cpu", torch.float64) is d


def test_k5_exclusive_needs_disjoint_blocks(chain):
    """The store path is taken only where every live item has one entry
    and the entry blocks are disjoint: a v3 rotate plan with two items'
    blocks made to overlap, and a v2 plan, are not exclusive."""
    _, port, _ = _plans(chain, BONDS["right"][1], "right", True)
    rp = port.rot
    efs = bv2._efs(rp)
    assert bv2.exclusive(rp, efs)
    ne = int(efs[-1])
    o = np.argsort(rp.ef[:ne, 1], kind="stable")
    rp.ef = rp.ef.copy()
    rp.ef[o[1], 1] = rp.ef[o[0], 1]
    assert not bv2.exclusive(rp, efs)
    _, p2, _ = _plans(chain, BONDS["right"][1], "right", False)
    assert not bv2.exclusive(p2, bv2._efs(p2))


def test_k5_wrappers_launch_or_raise(chain):
    """blk_exec and blk_exec_part run the plain version only on CPU
    tensors; any other device is refused, never run on the host."""
    _, port, pool = _plans(chain, BONDS["left"][1], "left", True)
    rp = port.rot
    d = bv2.blk_tables(rp, "cpu", torch.float64)
    part = bv2.blk_rank_part(rp, 0, 2, "cpu")
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bv2.blk_exec(meta, meta, meta, d, rp.T, rp.left, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        bv2.blk_exec_part(meta, meta, meta, d, part, rp.T, rp.left, meta)
