"""Mix v2 of the port — kernel K15 (scatter tile mix on the
gather-by-output mix core): the plan of build_mix_plan field by field
against the reference's, K15's tables (one block a distinct output
window, from the plan's own obase order) against the plan's task table,
their windows element-disjoint and the kernel's walk of them emulated in
numpy against the reference's _mix_exec, hand-made plans whose windows
overlap (or disagree, or leave the pool, or come out of order) refused,
K15's plain twin (what execute_mix runs on CPU tensors) against
_mix_exec (JAX on the CPU) on the same plan, execute_mix against the
reference's and against the v3/v4 pools (f64: 1e-12 relative to the pool
scale; f32: 1e-5), the LW/RW blocks against the host assembly, and
torch_resident under B2TPU_MIX=2 against jax_resident under the same
variable."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
from block2_preview_tpu.ops import resident as ref_resident

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.sweep import DMRG
from block2_preview_tpu_torch.ops import mixv3, mixv4, resident
from block2_preview_tpu_torch.ops.stacked import env_pool

from test_torch_plans import (SITES, Site, _eq, hubbard_driver,
                              hubbard_system)
from test_torch_stacked import check_units, gather_emulate


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


def _close(got, ref, tol):
    scale = max(np.abs(ref).max(), 1.0)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * scale


def _ref_plan(site, side):
    meta, pool = site.ref_pool(side)
    return ref_resident.build_mix_plan(meta, *site.pos[side],
                                       **site.kw[side]), pool


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_v2_plans_equal(system, t, side):
    """The port's build_mix_plan (its loops as array code) gives the
    reference's plan: meta_out, T, ncap_out, s, coef, n_launch and the
    dims hint."""
    site = Site(*system, t)
    r2, _ = _ref_plan(site, side)
    meta, _ = env_pool(site.penv[side], site.dqs[side], np.float64)
    p2 = resident.build_mix_plan(meta, *site.ppos[side], **site.pkw[side])
    assert p2.meta_out.signature() == r2.meta_out.signature()
    for k in ("T", "ncap_out", "s", "coef", "n_launch", "dims_hint"):
        _eq(getattr(p2, k), getattr(r2, k), k)
    # the v3 plan lays the pool out the same way
    assert site.port_plans(side)[0].meta_out.signature() == \
        p2.meta_out.signature()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mix_twin_matches_mix_exec(system, dtype):
    """K15's twin against _mix_exec, launch by launch, with a nonzero
    sentinel in the input pool: the output's sentinel stays 0."""
    r2, pool = _ref_plan(Site(*system, SITES[1]), "rw")
    pool = pool.astype(dtype)
    pool[-1] = 7.0
    ref = _jax_mix(r2, pool, dtype)
    p2 = interop.mix_plan_v2(r2)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    d = resident.mix_tables(p2, "cpu", tdt)
    got = resident.mix_v2_exec(torch.zeros(p2.ncap_out + 1, dtype=tdt),
                               torch.as_tensor(pool), d).numpy()
    _close(got, ref, 1e-12 if dtype == np.float64 else 1e-5)
    assert got[-1] == 0.0 and ref[-1] == 0.0


def _jax_mix(r2, pool, dtype):
    """The reference's _mix_exec over every launch of its plan."""
    import jax.numpy as jnp
    out = jnp.zeros(r2.ncap_out + 1, dtype=dtype)
    for li in range(r2.n_launch):
        out = ref_resident._mix_exec(
            out, jnp.asarray(pool), jnp.asarray(r2.s[li]),
            jnp.asarray(r2.coef[li].astype(dtype)), r2.T, r2.ncap_out,
            ref_resident._MIX_SCAN)
    return np.asarray(out)


def check_k15_tables(p2):
    """K15's tables against the plan's task table: the live tasks only
    (obase >= 0), one block a distinct obase in increasing order, every
    task's window, strides and source stride its block's record, and the
    terms the live tasks' (ebase, coef) in the plan's order.  Returns the
    tables."""
    h = resident.k15_tables(p2)
    s = np.asarray(p2.s).transpose(2, 0, 1, 3).reshape(7, -1)
    live = s[4] >= 0
    assert h["n_tasks"] == int(live.sum()) == len(h["ts"])
    t = s[:, live].astype(np.int64)
    blk = h["blk"]
    assert blk.shape[1] == 6 and (np.diff(blk[:, 0]) > 0).all()
    of = np.repeat(np.arange(len(blk)), np.diff(h["bstart"]))
    want = np.stack([t[4], t[5], np.minimum(t[2], p2.T),
                     np.minimum(t[3], p2.T), t[6], t[1]], 1)
    assert np.array_equal(blk[of], want)
    assert np.array_equal(h["ts"], t[0])
    assert np.array_equal(h["tc"], np.asarray(p2.coef).reshape(-1)[live])
    return h


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_k15_tables_follow_the_plan(system, t, side):
    """K15's tables on the reference's plan (check_k15_tables) and on the
    port's own (the same tables), their windows element-disjoint and off
    the sentinel, and the kernel's walk of them (the mix core's, emulated
    by gather_emulate: every output element written once, by one lane)
    against the reference's _mix_exec, f64 to 1e-12."""
    site = Site(*system, t)
    r2, pool = _ref_plan(site, side)
    h = check_k15_tables(interop.mix_plan_v2(r2))
    meta, _ = env_pool(site.penv[side], site.dqs[side], np.float64)
    hp = resident.k15_tables(resident.build_mix_plan(
        meta, *site.ppos[side], **site.pkw[side]))
    for k in ("blk", "bstart", "ts", "tc", "units"):
        _eq(hp[k], h[k], k)
    got, writes = gather_emulate(pool, h, 0, np.zeros(r2.ncap_out + 1))
    check_units(h, writes)
    assert writes.max() == 1 and writes[-1] == 0 and got[-1] == 0.0
    _close(got, _jax_mix(r2, pool, np.float64), 1e-12)


def hand_plan(tasks, T=4, ncap=15):
    """A v2 plan of hand-made tasks (ebase, estr, ermax, ecmax, obase,
    orstr, ocstr), coefficients 1, 2, ..., padded as build_mix_plan pads."""
    B = resident._MIX_B * resident._MIX_SCAN
    s = np.zeros((7, B), np.int32)
    s[4] = -1
    s[:, :len(tasks)] = np.asarray(tasks, np.int32).T
    p = resident.MixPlan()
    p.T, p.ncap_out, p.n_launch, p._dev = T, ncap, 1, {}
    p.s = s.reshape(7, 1, resident._MIX_SCAN, resident._MIX_B).transpose(
        1, 2, 0, 3)
    p.coef = np.zeros(B)
    p.coef[:len(tasks)] = np.arange(1, len(tasks) + 1)
    p.coef = p.coef.reshape(1, resident._MIX_SCAN, resident._MIX_B)
    return p


def test_k15_tables_refuse_bad_windows():
    """Hand-made plans: two interleaved strided windows (element-disjoint)
    and two tasks of one window pass, and give the hand-computed output
    with the sentinel 0; overlapping windows, a window past the pool, two
    tasks of one obase with different windows, and tasks out of obase
    order raise."""
    ep = torch.arange(1.0, 17.0, dtype=torch.float64)
    # A: 2 x 2 at 0, columns 0, 2; B: at 1, columns 1, 3; C adds into A
    ok = hand_plan([(0, 4, 2, 2, 0, 4, 2), (0, 4, 2, 2, 0, 4, 2),
                    (5, 4, 2, 2, 1, 4, 2)])
    h = check_k15_tables(ok)
    assert len(h["blk"]) == 2 and list(h["bstart"]) == [0, 2, 3]
    out = resident.execute_mix(ok, ep).numpy()
    want = np.zeros(16)
    e = ep.numpy()
    for k, (eb, es, ob) in enumerate(((0, 4, 0), (0, 4, 0), (5, 4, 1))):
        for r in range(2):
            for c in range(2):
                want[ob + 4 * r + 2 * c] += (k + 1) * e[eb + es * r + c]
    assert np.array_equal(out, want) and out[-1] == 0.0
    for tasks, match in (
            ([(0, 4, 2, 2, 0, 4, 1), (0, 4, 2, 2, 1, 4, 1)], "share"),
            ([(0, 4, 2, 2, 0, 4, 2), (0, 4, 2, 3, 4, 4, 2)], "share"),
            ([(0, 4, 4, 4, 3, 4, 1)], "leaves"),
            ([(0, 4, 2, 2, 0, 4, 1), (0, 4, 2, 3, 0, 4, 1)], "disagree"),
            ([(0, 4, 2, 2, 0, 4, 1), (0, 3, 2, 2, 0, 4, 1)], "disagree"),
            ([(0, 4, 1, 1, 5, 4, 1), (0, 4, 1, 1, 2, 4, 1)], "order")):
        with pytest.raises(ValueError, match=match):
            resident.k15_tables(hand_plan(tasks))


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_execute_mix_matches_jax_and_v3_v4(system, t, side):
    """execute_mix (f64) against the reference's on the same plan and
    pool; the v2, v3 and v4 pools of the port are equal."""
    import jax.numpy as jnp
    site = Site(*system, t)
    r2, pool = _ref_plan(site, side)
    ref = np.asarray(ref_resident.execute_mix(r2, jnp.asarray(pool),
                                              dtype=np.float64))
    ep = interop.slab_pool(pool, "cpu")
    got = resident.execute_mix(interop.mix_plan_v2(r2), ep).numpy()
    _close(got, ref, 1e-12)
    r3, r4, _ = site.ref_plans(side)
    v3 = mixv3.execute_mix_v3(interop.mix_plan_v3(r3), ep).numpy()
    v4 = mixv4.execute_mix_v4(interop.mix_plan_v4(r4), ep).numpy()
    _close(got, v3, 1e-12)
    _close(got, v4, 1e-12)


def test_execute_mix_f32(system):
    import jax.numpy as jnp
    r2, pool = _ref_plan(Site(*system, SITES[1]), "lw")
    pool = pool.astype(np.float32)
    ref = np.asarray(ref_resident.execute_mix(r2, jnp.asarray(pool),
                                              dtype=np.float32))
    got = resident.execute_mix(interop.mix_plan_v2(r2),
                               interop.slab_pool(pool, "cpu", np.float32))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, 1e-5)


def test_mix_matches_host_assembly(system):
    """Every host-assembled LW/RW block equals the v2 slab content
    (mirrors test_resident.py::test_mix_matches_host_assembly)."""
    site = Site(*system, SITES[1])
    n_checked = 0
    for side, ops in (("lw", site.eff.LW), ("rw", site.eff.RW)):
        r2, pool = _ref_plan(site, side)
        p2 = interop.mix_plan_v2(r2)
        slab = resident.execute_mix(p2, torch.as_tensor(pool)).numpy()
        meta = p2.meta_out
        for m, blocks in ops.items():
            gi, j = meta.sym_pos[m]
            for (qb, qk), blk in blocks.items():
                off, db, dk = meta.sectors[gi][qb]
                got = slab[off + j * db * dk:off + (j + 1) * db * dk]
                assert np.allclose(got.reshape(db, dk), blk, atol=1e-12), \
                    (side, m, qb, qk)
                n_checked += 1
    assert n_checked > 0


def test_complex_plan_in_a_real_dtype_raises(system):
    """The reference's executor takes cf.real; the port refuses."""
    site = Site(*system, SITES[1])
    meta, pool = site.ref_pool("rw")
    ent, quanta, fused = site.ppos["rw"]
    cent = {k: w.astype(np.complex128) for k, w in ent.items()}
    p2 = resident.build_mix_plan(interop.stacked_meta(meta), cent, quanta,
                                 fused, **site.pkw["rw"])
    assert p2.coef.dtype == np.complex128
    with pytest.raises(TypeError):
        resident.execute_mix(p2, torch.as_tensor(pool))


def test_other_devices_raise():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resident.mix_v2_exec(x, x, {})


SCHED = dict(bond_dims=[20] * 4, noises=[1e-5] * 3 + [0], thrds=[1e-12],
             n_sweeps=4, tol=0)


def test_resident_under_mix2_matches_jax(monkeypatch):
    """torch_resident under B2TPU_MIX=2 (K15's twin) against jax_resident
    under the same variable, Hubbard-L6, D=20."""
    monkeypatch.setenv("B2TPU_MIX", "2")
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
    assert all(isinstance(p, resident.MixPlan)
               for _, p in s._res_caches["mix"].values())
    assert s.host_redo_count == 0 and s.host_ops_downloads == 0
