"""The stacked environment's bucket engine of the port (ops/stacked.py,
kernels K10 and K11; backend "torch_stacked") against the JAX package's
(ops/stacked.py, backend "jax_stacked") on the same state, at a Hubbard-L8
(D=60) and a K=8 quantum-chemistry (D=40) MPS built in code: the plan's
sector items and mix rows against ``build_stacked_plan`` (the reference's
order once its shape buckets and padding rows are taken out), the plain
versions of K10 and K11 against ``_slab_exec`` and ``_mix_scatter`` bucket
by bucket, K10's tables (CUDA blocks of runs of one item's works, their
``res`` blocks covering the pool once) walked in the kernel's order
against ``_slab_exec`` in f64 and f32, K11's tables (the mix core's: rows
grouped stably by output block) against the plan's rows and the
kernel's walk of them emulated in numpy (``gather_emulate``: every
output element written once),
``execute_stacked`` against the JAX ``execute_stacked`` (f64 to 1e-12 and
f32 to 1e-5 relative to the largest entry) and against the host
blocking ``execute_plan_numpy`` over four-bond chains (1e-11, mirroring
tests/test_stacked.py), the cached plan's site-value refresh, and
``DMRG(backend="torch_stacked")`` against "jax_stacked" and "numpy" (one
and three roots, 1e-8 Ha)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import block2_preview_tpu.ops.stacked as ref_stacked
from block2_preview_tpu.dmrg.environment import MovingEnvironment as RefME
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.core.blocks import MPSTensor
from block2_preview_tpu_torch.dmrg.environment import MovingEnvironment
from block2_preview_tpu_torch.dmrg.sweep import DMRG
from block2_preview_tpu_torch.ops import _kernels, stacked
from block2_preview_tpu_torch.ops.blocking_plan import (build_plan,
                                                        execute_plan_numpy)
from block2_preview_tpu_torch.ops.stacked import env_pool

from test_torch_bucket import _state
from test_torch_plans import hubbard_driver

CPU = torch.device("cpu")
TOL = {np.float64: 1e-12, np.float32: 1e-5}
BONDS = {"left": (0, 3, 5), "right": (7, 4, 2)}


@pytest.fixture(scope="module", params=["hubbard", "qc"])
def chain(request):
    """Host environments of both packages over one MPS after two host
    sweeps, left ones up to the middle."""
    mpo, mps, _ = _state(request.param)
    rme = RefME(mpo, mps)
    pme = MovingEnvironment(interop.mpo(mpo), interop.mps(mps))
    for me in (rme, pme):
        me.init_environments()
        for s in range(max(BONDS["left"]) + 1):
            me.update_left(s)
    return rme, pme


def step_args(me, t, direction):
    """Blocking-plan arguments of bond step t after the meta, and the
    source bond's host map and index."""
    left = direction == "left"
    src = t if left else t + 1
    env = me.left_envs[src] if left else me.right_envs[src]
    mpo = me.mpo
    return ((mpo.tensors[t], mpo.site_quanta[t], me.bra.tensors[t],
             me.ket.tensors[t], mpo.group, direction, mpo.bond_dqs[src],
             mpo.bond_dqs[t + 1 if left else t]), env, src)


def plans(chain, t, direction, ref_build, port_build, **kw):
    """(reference plan, port plan, the source pool, the port's meta_in)
    of bond step t, each package's builder on its own environments."""
    rme, pme = chain
    rargs, renv, src = step_args(rme, t, direction)
    pargs, penv, _ = step_args(pme, t, direction)
    rmeta = ref_stacked.meta_from_env(renv, rme.mpo.bond_dqs[src])
    pmeta, pool = env_pool(penv, pme.mpo.bond_dqs[src], np.float64)
    return (ref_build(rmeta, *rargs, **kw), port_build(pmeta, *pargs, **kw),
            pool, pmeta)


def _stacked_plans(chain, t, direction):
    return plans(chain, t, direction, ref_stacked.build_stacked_plan,
                 stacked.build_stacked_plan)


def same_meta(p, r):
    assert p.signature() == hash(
        (tuple((dq, tuple(map(int, ss))) for dq, ss in r.groups),
         tuple(tuple(sorted(sec.items())) for sec in r.sectors), r.total))


def _bucket_order(plan, meta_in):
    """The port's items in the reference's order: a stable sort by its
    bucket key (pow2 group size, then the dims rounded up to powers of two
    of at least 8)."""
    size = {off: len(ss) for (_dq, ss), secs in zip(meta_in.groups,
                                                    meta_in.sectors)
            for (off, _db, _dk) in secs.values()}

    def q8(v):
        return 1 << (max(int(v), 8) - 1).bit_length()

    keys = [(stacked._pow2(size[int(f[0])]), q8(f[3]), q8(f[5]), q8(f[4]),
             q8(f[6])) for f in plan.items]
    return np.asarray(sorted(range(len(keys)), key=keys.__getitem__))


@pytest.mark.parametrize("direction", ["left", "right"])
def test_plan_items_and_rows_equal_the_reference(chain, direction):
    for t in BONDS[direction]:
        ref, port, _, meta_in = _stacked_plans(chain, t, direction)
        conv = interop.stacked_plan(ref)
        same_meta(port.meta_out, ref.meta_out)
        assert port.out_cap == ref.out_cap and port.left == conv.left
        order = _bucket_order(port, meta_in)
        assert np.array_equal(port.items[order], conv.items)
        new = np.empty(len(order), np.int64)
        new[order] = np.arange(len(order))
        rows = np.argsort(new[port.row_c], kind="stable")
        assert np.array_equal(new[port.row_c][rows], conv.row_c)
        for k in ("row_j", "coef", "tgt"):
            assert np.array_equal(getattr(port, k)[rows], getattr(conv, k)), k
        for which in ("bra_pool", "ket_pool"):
            (pm, po), (rm, ro) = getattr(port, which), getattr(conv, which)
            assert np.array_equal(po, ro)
            assert all(np.array_equal(a, b) for a, b in zip(pm, rm))
        # every work is read by some row; res holds each once
        assert len(port.work) == len(np.unique(port.wsrc))
        assert port.res_total == int(np.sum(
            port.items[port.work[:, 0], 4] * port.items[port.work[:, 0], 6]))


def gather_emulate(src, h, sstr, out):
    """The mix core as csrc/mix_gather.cuh runs it, in numpy, on its host
    tables ``h``: unit by unit, a split block's lanes as term groups summed
    by the xor tree, a wider block's chunk one lane an element.  Adds into
    ``out``; returns it and the writes each output element received."""
    writes = np.zeros(len(out), np.int64)
    for b, e0 in h["units"]:
        ob, ostr, rows, cols, oc, ss = window(h["blk"][b], sstr)
        n_el = rows * cols
        m = np.arange(h["bstart"][b], h["bstart"][b + 1])
        if n_el <= stacked.GATHER_SPLIT:
            assert e0 == 0
            groups = 32 >> int(n_el - 1).bit_length()
            e = np.arange(n_el)
        else:
            assert e0 % stacked.GATHER_CHUNK == 0 and e0 < n_el
            groups = 1
            e = np.arange(e0, min(e0 + stacked.GATHER_CHUNK, n_el))
        r, c = e // cols, e % cols
        part = np.zeros((groups, len(e)))
        for g in range(groups):
            mm = m[g::groups]
            part[g] = (h["tc"][mm, None]
                       * src[h["ts"][mm, None] + r * ss + c]).sum(0)
        d = groups // 2
        while d:
            part = part + part[np.arange(groups) ^ d]
            d //= 2
        idx = ob + r * ostr + c * oc
        out[idx] += part[0]
        writes[idx] += 1
    return out, writes


def window(rec, sstr):
    """(ob, ostr, rows, cols, ocstr, sstr) of a mix-core block record: a
    strided one (K15) carries its column and source row strides, a plain
    one has ocstr 1 and the launch's ``sstr``."""
    rec = [int(v) for v in rec]
    return tuple(rec) if len(rec) == 6 else (*rec, 1, sstr)


def check_units(h, writes):
    """Every element of every output block was written once, and nothing
    else (``writes`` from :func:`gather_emulate`)."""
    want = np.zeros_like(writes)
    for rec in h["blk"]:
        ob, ostr, rows, cols, oc, _ = window(rec, 0)
        want[ob + np.arange(rows)[:, None] * ostr
             + np.arange(cols) * oc] += 1
    assert np.array_equal(writes, want) and want.max() <= 1


def check_mix_tables(plan):
    """K11's host tables against the plan's rows: one output block per
    distinct row target, in offset order and disjoint; each block's rows
    share its dx dy and are the plan's rows with that target in the plan's
    order (so every row appears once)."""
    stacked.mix_tables(plan, CPU, torch.float64)
    h = plan._dev["k11"]
    tg, n = plan.tgt[:, 0], plan.tgt[:, 1] * plan.tgt[:, 2]
    order = np.argsort(tg, kind="stable")
    blocks, first = np.unique(tg[order], return_index=True)
    assert np.array_equal(h["blk"][:, 0], blocks)
    assert np.array_equal(h["bstart"], np.append(first, len(tg)))
    assert (h["blk"][:, 2] == 1).all()
    assert np.array_equal(h["blk"][:, 1], h["blk"][:, 3])
    assert np.array_equal(np.repeat(h["blk"][:, 3], np.diff(h["bstart"])),
                          n[order])
    assert (blocks[:-1] + h["blk"][:-1, 3] <= blocks[1:]).all()
    assert np.array_equal(h["ts"], plan.roff[plan.wsrc][order])
    assert np.array_equal(h["tc"], plan.coef[order])
    return h


def _run_bucket(ref, bk, pool, left):
    """The JAX kernels on one reference bucket: res [C, S, Xp, Yp] and the
    output pool after its mix chunks."""
    bp, kp = ref_stacked._plan_site_pools(ref, np.float64)
    res = ref_stacked._slab_exec(
        jnp.asarray(pool), bp, kp, bk["eoff"], bk["boff"], bk["koff"],
        bk["dl"], bk["dk"], bk["dx"], bk["dy"], bk["S"], bk["Lp"], bk["Kp"],
        bk["Xp"], bk["Yp"], left)
    out = jnp.zeros(ref.out_cap, dtype=np.float64)
    for src, coef, tgt in bk["mix"]:
        out = ref_stacked._mix_scatter(out, res, src,
                                       jnp.asarray(coef.real), tgt,
                                       ref.out_cap)
    return np.asarray(res), np.asarray(out)


@pytest.mark.parametrize("direction", ["left", "right"])
def test_twins_match_slab_exec_and_mix_scatter(chain, direction):
    """Bucket by bucket: K10's twin against _slab_exec on every work, K11's
    twin (on K10's result) against _mix_scatter's output pool."""
    t = BONDS[direction][1]
    ref, _, pool, _ = _stacked_plans(chain, t, direction)
    left = direction == "left"
    ep = torch.as_tensor(pool)
    assert len(ref.buckets) > 1
    for bk in ref.buckets:
        res_ref, out_ref = _run_bucket(ref, bk, pool, left)
        one = interop.stacked_plan(SimpleNamespace(
            buckets=[bk], meta_out=ref.meta_out, direction=ref.direction,
            bra_sizes=ref.bra_sizes, ket_sizes=ref.ket_sizes))
        bp, kp = stacked.site_pools(one, CPU, torch.float64)
        res = stacked.slab_exec(
            ep, bp, kp, stacked.slab_plain_tables(one, CPU, torch.float64),
            left, torch.zeros(one.res_total + 1, dtype=torch.float64))
        r = res.numpy()
        scale = max(np.abs(res_ref).max(), 1e-300)
        for (c, j), o in zip(one.work, one.roff[:-1]):
            dx, dy = one.items[c, 4], one.items[c, 6]
            got = r[o:o + dx * dy].reshape(dx, dy)
            assert np.abs(got - res_ref[c, j, :dx, :dy]).max() \
                <= 1e-12 * scale
        out = stacked.stk_mix(res, stacked.mix_tables(one, CPU,
                                                      torch.float64),
                              torch.zeros(one.out_cap, dtype=torch.float64))
        scale = max(np.abs(out_ref).max(), 1e-300)
        assert np.abs(out.numpy() - out_ref).max() <= 1e-12 * scale
        # the kernel's own walk of the same tables
        h = check_mix_tables(one)
        emu, writes = gather_emulate(r, h, 0, np.zeros(one.out_cap))
        check_units(h, writes)
        assert np.abs(emu - out_ref).max() <= 1e-12 * scale


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_execute_matches_jax(chain, direction, dtype):
    """The port's own plan on CPU tensors (K10 + K11 twins) against the
    JAX execute_stacked on the reference's plan, the whole output pool."""
    ref, port, pool, _ = _stacked_plans(chain, BONDS[direction][1],
                                        direction)
    want = np.asarray(ref_stacked.execute_stacked(ref, jnp.asarray(pool),
                                                  dtype=np.float64))
    got = stacked.execute_stacked(
        port, interop.slab_pool(pool, "cpu", dtype)).numpy()
    assert got.dtype == dtype and got.shape == want.shape == (port.out_cap,)
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()
    assert not got[port.meta_out.total:].any()
    # the reference's plan, carried over, runs the same
    got2 = stacked.execute_stacked(interop.stacked_plan(ref),
                                   interop.slab_pool(pool, "cpu", dtype))
    assert np.abs(got2.numpy() - want).max() <= TOL[dtype] * \
        np.abs(want).max()


@pytest.mark.parametrize("direction", ["left", "right"])
def test_mix_tables_follow_the_rows(chain, direction):
    """K11's tables at every bond of the chain (check_mix_tables), the
    work split covering every output element once, and the kernel's walk of
    them (gather_emulate) on the whole plan against the JAX
    execute_stacked."""
    for t in BONDS[direction]:
        ref, port, pool, _ = _stacked_plans(chain, t, direction)
        h = check_mix_tables(port)
        bp, kp = stacked.site_pools(port, CPU, torch.float64)
        res = stacked.slab_exec(
            torch.as_tensor(pool), bp, kp,
            stacked.slab_plain_tables(port, CPU, torch.float64), port.left,
            torch.zeros(port.res_total + 1, dtype=torch.float64)).numpy()
        got, writes = gather_emulate(res, h, 0, np.zeros(port.out_cap))
        check_units(h, writes)
        want = np.asarray(ref_stacked.execute_stacked(
            ref, jnp.asarray(pool), dtype=np.float64))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def check_slab_tables(plan):
    """K10's host tables against the plan's works: every env offset is its
    work's block eoff + j dl dk; the CUDA blocks are runs of at most
    SLAB_WORKS works of one item, with that item's bra and ket blocks and
    dims and its first work's res offset, by decreasing FLOPs; together
    they hold every work once, and their res blocks cover ``res`` exactly
    once but its last slot.  Returns the tables."""
    h = stacked.slab_host_tables(plan)
    assert h["ce"].dtype == np.int32 and h["ch"].dtype == np.int32
    f = plan.items[plan.work[:, 0]]
    assert np.array_equal(h["ce"], f[:, 0] + plan.work[:, 1] * f[:, 3]
                          * f[:, 5])
    ch = h["ch"].astype(np.int64)
    w0, w1 = ch[:, 0], ch[:, 1]
    assert ((w1 > w0) & (w1 - w0 <= stacked.SLAB_WORKS)).all()
    held = np.zeros(len(plan.work), np.int64)
    cover = np.zeros(plan.res_total + 1, np.int64)
    for a, b, boff, koff, dl, dx, dk, dy, r0 in ch:
        held[a:b] += 1
        assert (plan.work[a:b, 0] == plan.work[a, 0]).all()
        assert tuple(plan.items[plan.work[a, 0], 1:]) == (boff, koff, dl,
                                                          dx, dk, dy)
        assert np.array_equal(plan.roff[a:b + 1],
                              r0 + dx * dy * np.arange(b - a + 1))
        cover[r0:r0 + (b - a) * dx * dy] += 1
    assert (held == 1).all()
    assert (cover[:-1] == 1).all() and cover[-1] == 0
    flops = (w1 - w0) * ch[:, 4] * ch[:, 7] * (ch[:, 6] + ch[:, 5])
    assert (np.diff(flops) <= 0).all()
    return h


def slab_walk(h, pools, left, dtype, n_out, rows=16):
    """K10's tables walked as csrc/slab.cu walks them, in numpy and
    ``dtype``: block by block, work by work, the work's rows of E in runs
    of ``rows`` — tmp = E[run] MK, then res (+)= MB[run]^T tmp — into a
    flat res of ``n_out`` (the last slot untouched)."""
    ep, bp, kp = (np.asarray(p, dtype) for p in pools)
    out = np.zeros(n_out, dtype)
    for a, b, boff, koff, dl, dx, dk, dy, r0 in h["ch"].astype(np.int64):
        mb = bp[boff:boff + dl * dx]
        mb = mb.reshape(dl, dx) if left else mb.reshape(dx, dl).T
        mk = kp[koff:koff + dk * dy]
        mk = mk.reshape(dk, dy) if left else mk.reshape(dy, dk).T
        for w in range(a, b):
            e = ep[h["ce"][w]:h["ce"][w] + dl * dk].reshape(dl, dk)
            o = out[r0 + (w - a) * dx * dy:r0 + (w - a + 1) * dx * dy]
            for l0 in range(0, dl, rows):
                part = mb[l0:l0 + rows].T @ (e[l0:l0 + rows] @ mk)
                o += part.reshape(-1)
    return out


@pytest.mark.parametrize("direction", ["left", "right"])
def test_slab_tables_cover_each_work(chain, direction):
    """K10's tables at every bond of the chain (check_slab_tables), and
    walked as the kernel walks them (slab_walk) they give K10's plain
    version's res, f64 to 1e-12; the device tables are the host ones,
    cached on the plan."""
    for t in BONDS[direction]:
        _, port, pool, _ = _stacked_plans(chain, t, direction)
        h = check_slab_tables(port)
        bp, kp = stacked.site_pools(port, CPU, torch.float64)
        want = stacked.slab_exec(
            torch.as_tensor(pool), bp, kp,
            stacked.slab_plain_tables(port, CPU, torch.float64), port.left,
            torch.zeros(port.res_total + 1, dtype=torch.float64)).numpy()
        got = slab_walk(h, (pool, bp.numpy(), kp.numpy()), port.left,
                        np.float64, port.res_total + 1)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        d = stacked.slab_kernel_tables(port, CPU)
        assert d["n_chunks"] == len(h["ch"]) and d["ch"].dtype == \
            torch.int32
        assert stacked.slab_kernel_tables(port, CPU) is d


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_slab_walk_matches_slab_exec(chain, direction, dtype):
    """Bucket by bucket: K10's tables walked in the kernel's order in
    ``dtype`` (slab_walk; also in runs of 4 rows of E, so a work's later
    runs add into its block) against the JAX _slab_exec on every work, f64
    to 1e-12 and f32 to 1e-5 relative to the bucket's largest entry."""
    ref, _, pool, _ = _stacked_plans(chain, BONDS[direction][1], direction)
    left = direction == "left"
    for bk in ref.buckets:
        res_ref, _ = _run_bucket(ref, bk, pool, left)
        one = interop.stacked_plan(SimpleNamespace(
            buckets=[bk], meta_out=ref.meta_out, direction=ref.direction,
            bra_sizes=ref.bra_sizes, ket_sizes=ref.ket_sizes))
        bp, kp = stacked.site_pools(one, CPU, torch.float64)
        h = check_slab_tables(one)
        scale = max(np.abs(res_ref).max(), 1e-300)
        for rows in (16, 4):
            r = slab_walk(h, (pool, bp.numpy(), kp.numpy()), left, dtype,
                          one.res_total + 1, rows)
            assert r.dtype == dtype and r[-1] == 0
            for (c, j), o in zip(one.work, one.roff[:-1]):
                dx, dy = one.items[c, 4], one.items[c, 6]
                got = r[o:o + dx * dy].reshape(dx, dy)
                assert np.abs(got - res_ref[c, j, :dx, :dy]).max() \
                    <= TOL[dtype] * scale


def _cmp(host, got):
    """Largest difference between two env maps (a block missing from
    ``got`` counts as zero)."""
    err = 0.0
    for s, bm in host.items():
        for k, m in bm.blocks.items():
            g = got.get(s)
            g = None if g is None else g.blocks.get(k)
            err = max(err, float(np.abs(m if g is None else m - g).max()))
    return err


def port_system(D, seed):
    """The port's Hubbard-L8 MPO and a random MPS of bond dimension D."""
    from block2_preview_tpu_torch.driver.core import DMRGDriver
    drv = DMRGDriver()
    drv.initialize_system(n_sites=8, n_elec=8, spin=0)
    return interop.mpo(hubbard_driver()[1]), drv.get_random_mps(D, seed=seed)


def chain_check(build, execute, **kw):
    """Four-bond left and right chains of a Hubbard-L8 D=80 random MPS:
    each step's device-format plan (``build``, ``execute`` on CPU tensors)
    against the host plan of ops/blocking_plan.py and execute_plan_numpy
    on the same environment, 1e-11 (mirrors tests/test_stacked.py)."""
    mpo, mps = port_system(80, seed=21)
    g, L = mpo.group, mpo.n_sites
    me = MovingEnvironment(mpo, mps)
    for direction, steps, env in (("left", range(4), me.left_envs[0]),
                                  ("right", range(L - 1, L - 5, -1),
                                   me.right_envs[L])):
        left = direction == "left"
        for t in steps:
            src, dst = (t, t + 1) if left else (t + 1, t)
            meta, pool = env_pool(env, mpo.bond_dqs[src], np.float64)
            plan = build(meta, mpo.tensors[t], mpo.site_quanta[t],
                         mps.tensors[t], mps.tensors[t], g, direction,
                         mpo.bond_dqs[src], mpo.bond_dqs[dst], **kw)
            got = plan.meta_out.unpack(
                execute(plan, torch.as_tensor(pool)).numpy(), g, None)
            dq_out = mpo.bond_dqs[dst] if left else \
                [g.sub(mpo.bond_dqs[-1][0], dq) for dq in mpo.bond_dqs[t]]
            host_plan = build_plan(env, mpo.tensors[t], mpo.site_quanta[t],
                                   mps.tensors[t], mps.tensors[t], dq_out, g,
                                   direction)
            host = execute_plan_numpy(host_plan, env, mps.tensors[t],
                                      mps.tensors[t], g)
            assert _cmp(host, got) < 1e-11, (direction, t)
            env = host


def test_chains_match_host_blocking():
    chain_check(stacked.build_stacked_plan, stacked.execute_stacked)


def refresh_check(build, execute):
    """A plan cached on structure keeps the site values it was built with
    until refresh_plan_sites sees new site tensors: the next execution
    then gives the new tensors' blocking (the reference's 2.4e-6 Ha
    stale-rotation fault, ops/stacked.py:255-258)."""
    mpo, mps = port_system(40, seed=3)
    me = MovingEnvironment(mpo, mps)
    t, g = 2, mpo.group
    for s in range(t):
        me.update_left(s)
    meta, pool = env_pool(me.left_envs[t], mpo.bond_dqs[t], np.float64)
    args = (meta, mpo.tensors[t], mpo.site_quanta[t])
    plan = build(*args, mps.tensors[t], mps.tensors[t], g, "left",
                 mpo.bond_dqs[t], mpo.bond_dqs[t + 1])
    ep = torch.as_tensor(pool)
    before = execute(plan, ep).numpy().copy()
    new = MPSTensor(g, {k: 0.5 * b for k, b in mps.tensors[t].blocks.items()})
    want = execute(build(*args, new, new, g, "left", mpo.bond_dqs[t],
                         mpo.bond_dqs[t + 1]), ep).numpy()
    assert np.abs(execute(plan, ep).numpy() - before).max() == 0
    stacked.refresh_plan_sites(plan, new, new, mpo.site_quanta[t])
    got = execute(plan, ep).numpy()
    assert np.abs(want - 0.25 * before).max() <= 1e-12 * np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_refresh_reaches_the_cached_plan():
    refresh_check(stacked.build_stacked_plan, stacked.execute_stacked)


SCHED = dict(bond_dims=[30] * 4, noises=[1e-5] * 3 + [0], thrds=[1e-12],
             n_sweeps=4, tol=0)


def _jax(mpo, mps, backend, **kw):
    return np.atleast_1d(RefDMRG(mpo, mps, backend=backend, iprint=0,
                                 **kw).solve(SCHED["bond_dims"],
                                             SCHED["noises"], SCHED["thrds"],
                                             n_sweeps=4, tol=0))


@pytest.mark.parametrize("n_roots", [1, 3])
def test_stacked_backend_matches_jax_stacked_and_numpy(n_roots):
    """Mirrors test_stacked.py::test_stacked_backend_dmrg (Hubbard-L6,
    D=30, 4 sweeps)."""
    drv, mpo = hubbard_driver(L=6)
    kw = dict(n_roots=n_roots)
    e_np = _jax(mpo, drv.get_random_mps(30, seed=7), "numpy", **kw)
    e_js = _jax(mpo, drv.get_random_mps(30, seed=7), "jax_stacked", **kw)
    _kernels.reset_counts()
    s = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(30, seed=7)),
             device="cpu", backend="torch_stacked", iprint=0, **kw)
    e = np.atleast_1d(s.solve(SCHED["bond_dims"], SCHED["noises"],
                              SCHED["thrds"], n_sweeps=4, tol=0))
    assert np.abs(e - e_np).max() < 1e-8, (e, e_np)
    assert np.abs(e - e_js).max() < 1e-8, (e, e_js)
    assert s.me.stk_engine == "bucket" and s.me.max_res_pool > 0
    assert s.host_env_materialized > 0 and s.host_redo_count == 0
    assert not any(_kernels.launch_counts().values())   # the twins ran
    assert all(r["blk_plan"] > 0 and r["materialized"] > 0
               for r in s.sweep_log)


def test_complex_state_on_torch_stacked_raises():
    drv, mpo = hubbard_driver(L=4)
    pmpo = interop.mpo(mpo)
    mps = interop.mps(drv.get_random_mps(10, seed=1))
    mps.tensors[1] = MPSTensor(mps.tensors[1].group, {
        k: b.astype(np.complex128) for k, b in mps.tensors[1].blocks.items()})
    with pytest.raises(TypeError, match="torch_tiled"):
        DMRG(pmpo, mps, device="cpu", backend="torch_stacked")
    with pytest.raises(TypeError, match="unsupported dtype"):
        DMRG(pmpo, interop.mps(drv.get_random_mps(10, seed=1)), device="cpu",
             backend="torch_stacked", dtype=np.complex128)


def test_wrappers_launch_or_raise_off_the_cpu():
    """Tensors that are not on the CPU never reach a twin: a device the
    kernels do not take raises, and without a card the stacked backend
    cannot be asked for the card (no fallback to the CPU)."""
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stacked.slab_exec(x, x, x, {}, True, x)
    with pytest.raises(ValueError, match="unsupported device"):
        stacked.stk_mix(x, {}, x)
    if torch.cuda.is_available():
        return
    drv, mpo = hubbard_driver(L=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(10, seed=1)),
             backend="torch_stacked")
