"""The v1 tiled blocking engine of the port (ops/tiled_blocking.py, kernel
K12; ``B2TPU_STK_ENGINE=tiled_v1``) against the JAX package's
(ops/tiled_blocking.py) on the same state, at a Hubbard-L8 (D=60) and a
K=8 quantum-chemistry (D=40) MPS built in code: every field of
``build_tiled_blocking_plan`` at T=16 and T=32, the plain version of K12
on CPU tensors against the JAX ``execute_tiled_blocking`` (f64 to 1e-12
and f32 to 1e-5 relative to the largest entry; also with budgets cut so a
plan splits into many task groups, and with the scratch budget cut so it
runs in several waves), K12's compact tables against the plan's padded
ones (``check_k12_tables``: every live task once, ids inside their wave,
disjoint output tiles walked once by the mix core), against the host blocking
``execute_plan_numpy`` over four-bond chains (1e-11), the cached plan's
site-value refresh, and the "torch_resident" and "torch_tiled" backends
under tiled_v1 against "jax_resident" and "jax_tiled" under the same
variable (1e-8 Ha)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import block2_preview_tpu.ops.tiled_blocking as ref_tb
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

import block2_preview_tpu_torch.ops.tiled_blocking as tb
from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.sweep import DMRG
from block2_preview_tpu_torch.ops import _kernels

from test_torch_plans import hubbard_driver
from test_torch_stacked import (BONDS, TOL, chain, chain_check,  # noqa: F401
                                check_units, gather_emulate, plans,
                                refresh_check, same_meta)

_FIELDS = ("T", "nt1", "ntp", "ncap", "left", "s1", "s2", "s3", "coef")


def _plans(chain, t, direction, T=None):
    return plans(chain, t, direction, ref_tb.build_tiled_blocking_plan,
                 tb.build_tiled_blocking_plan, T=T)


def _same(port, ref):
    same_meta(port.meta_out, ref.meta_out)
    for k in _FIELDS:
        p, r = getattr(port, k), getattr(ref, k)
        if isinstance(r, np.ndarray):
            assert p.dtype == r.dtype and np.array_equal(p, r), k
        else:
            assert p == r, k
    for which in ("bra_pool", "ket_pool"):
        (pm, po), (rm, ro) = getattr(port, which), getattr(ref, which)
        assert np.array_equal(po, ro)
        assert len(pm) == len(rm)
        assert all(np.array_equal(a, b) for a, b in zip(pm, rm))


@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_plan_fields_equal_the_reference(chain, direction, T):
    for t in BONDS[direction]:
        ref, port, _, _ = _plans(chain, t, direction, T=T)
        _same(port, ref)
        assert port.flops > 0


def _jax_out(ref, pool, dtype=np.float64):
    return np.asarray(ref_tb.execute_tiled_blocking(ref, jnp.asarray(pool),
                                                    dtype=dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_execute_matches_jax(chain, direction, dtype):
    """The port's own plan on CPU tensors (K12's twin) against the JAX
    execute_tiled_blocking on the reference's plan, the whole pool; the
    reference's plan, carried over, runs the same."""
    ref, port, pool, _ = _plans(chain, BONDS[direction][1], direction)
    want = _jax_out(ref, pool)
    for plan in (port, interop.tiled_blocking_plan(ref)):
        got = tb.execute_tiled_blocking(
            plan, interop.slab_pool(pool, "cpu", dtype)).numpy()
        assert got.dtype == dtype and got.shape == want.shape == (port.ncap,)
        assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()
        assert not got[port.meta_out.total:].any()


def test_many_task_groups(chain, monkeypatch):
    """With the stage budgets cut, a plan splits into many task groups, all
    in one wave at the default scratch budget; tables and results stay
    equal to the JAX package's."""
    cfg = (128, 128, 128)
    monkeypatch.setitem(ref_tb._CFG, 16, cfg)
    monkeypatch.setitem(tb._CFG, 16, cfg)
    for direction in ("left", "right"):
        ref, port, pool, _ = _plans(chain, BONDS[direction][1], direction,
                                    T=16)
        _same(port, ref)
        h = tb.tblk_host(port)
        assert len(h["groups"]) > 2 and len(h["waves"]) == 1
        assert (h["groups"][:, 1:] <= 128).all()
        check_k12_tables(port, h)
        want = _jax_out(ref, pool)
        got = tb.execute_tiled_blocking(port, torch.as_tensor(pool)).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def check_k12_tables(plan, h):
    """K12's host tables against the plan's padded ones: every live task
    of s1/s2/s3 appears once, in group order; tile ids rebuilt from the
    segment starts and slots equal the plan's, and every id stays inside
    its wave's scratch; the output tiles of a wave are disjoint, one window
    each, and the core's walk covers each of their elements once."""
    T = plan.T
    live1 = plan.s1[:, 8, :] < plan.nt1
    live2 = plan.s2[:, 5, :] < plan.ntp
    live3 = plan.s3[:, 1, :] >= 0
    g1, g2, g3 = (np.nonzero(m)[0] for m in (live1, live2, live3))
    assert np.array_equal(h["s1"], plan.s1.transpose(1, 0, 2)[:8, live1])
    assert np.array_equal(h["s2"][:4],
                          plan.s2.transpose(1, 0, 2)[:4, live2])
    waves, groups, wave_of = h["waves"], h["groups"], h["wave_of"]
    assert np.array_equal(groups[:, 0], np.unique(np.concatenate(
        [g1, g2, g3])))
    assert np.all(np.diff(wave_of) >= 0)
    wave = np.zeros(len(plan.s1), np.int64)
    wave[groups[:, 0]] = wave_of

    def tiles(seg, ids, gi, col):
        """The tiles of a stage, numbered over the plan in group order,
        each inside its wave; returns each group's first slot in its
        wave's scratch."""
        n = np.zeros(len(plan.s1), np.int64)
        np.maximum.at(n, gi, ids + 1)
        base = np.concatenate([[0], np.cumsum(n)[:-1]])
        tile = np.repeat(np.arange(len(seg) - 1), np.diff(seg))
        assert np.array_equal(tile, ids + base[gi])
        first, count = waves[wave[gi], col], waves[wave[gi], col + 1]
        assert ((tile >= first) & (tile < first + count)).all()
        return base - waves[wave, col]

    slot1 = tiles(h["seg1"], plan.s1[:, 8, :][live1], g1, 0)
    slot2 = tiles(h["seg2"], plan.s2[:, 5, :][live2], g2, 2)
    assert waves[:, 1].max() == h["ntmp"] and waves[:, 3].max() == h["nprod"]
    # stage 2's tmp source: its slot in the wave's tmp scratch
    src = plan.s2[:, 4, :][live2] + slot1[g2]
    assert np.array_equal(h["s2"][4], src)
    assert ((src >= 0) & (src < waves[wave[g2], 1])).all()
    # stage 3: every live task once, in its wave's block of its obase
    c = h["core"]
    w3 = wave[g3]
    s3 = plan.s3.transpose(1, 0, 2)[:, live3]
    prod = (s3[0] + slot2[g3]) * T * T
    assert ((prod >= 0) & (prod < waves[w3, 3] * T * T)).all()
    bw = np.searchsorted(h["wave_blocks"], np.arange(len(c["blk"])),
                         "right") - 1
    tb_ = np.repeat(np.arange(len(c["blk"])), np.diff(c["bstart"]))
    got = np.stack([bw[tb_], c["blk"][tb_, 0], c["ts"], c["tc"]])
    want = np.stack([w3, s3[1], prod, plan.coef[live3]])
    order = np.lexsort(want[:2][::-1])
    assert np.array_equal(got, want[:, order])
    assert np.array_equal(c["blk"][tb_, 1:],
                          np.stack([s3[2], np.minimum(s3[3], T),
                                    np.minimum(s3[4], T)], 1)[order])
    for w in range(len(waves)):
        b0, b1 = h["wave_blocks"][w], h["wave_blocks"][w + 1]
        u0, nu = waves[w, 4], waves[w, 5]
        assert (c["units"][u0:u0 + nu, 0] >= b0).all()
        assert (c["units"][u0:u0 + nu, 0] < b1).all()
        sub = dict(c, units=c["units"][u0:u0 + nu])
        prod_pool = np.zeros(max(h["nprod"], 1) * T * T)
        _, writes = gather_emulate(prod_pool, sub, T, np.zeros(plan.ncap))
        check_units(dict(blk=c["blk"][b0:b1]), writes)


@pytest.mark.parametrize("direction", ["left", "right"])
def test_waves_match_jax(chain, monkeypatch, direction):
    """With the scratch budget cut to a few groups' tiles, a plan runs in
    several waves (tile ids global within a wave, output tiles that several
    waves touch added to wave after wave); the tables hold their
    invariants and the result equals the JAX _tiled_blocking_exec's."""
    cfg = (128, 128, 128)
    monkeypatch.setitem(ref_tb._CFG, 16, cfg)
    monkeypatch.setitem(tb._CFG, 16, cfg)
    monkeypatch.setattr(tb, "_WAVE_ELEMS", 300 * 16 * 16)
    ref, port, pool, _ = _plans(chain, BONDS[direction][1], direction, T=16)
    h = tb.tblk_host(port)
    assert len(h["waves"]) > 2
    blk = h["core"]["blk"]
    assert len(np.unique(blk[:, 0])) < len(blk)    # tiles in several waves
    check_k12_tables(port, h)
    want = _jax_out(ref, pool)
    for dtype in (np.float64, np.float32):
        got = tb.execute_tiled_blocking(
            port, interop.slab_pool(pool, "cpu", dtype)).numpy()
        assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("direction", ["left", "right"])
def test_k12_tables_hold_their_invariants(chain, direction):
    """check_k12_tables at every bond of the chain, T=16 and 32, at the
    default scratch budget."""
    for t in BONDS[direction]:
        for T in (16, 32):
            _, port, _, _ = _plans(chain, t, direction, T=T)
            check_k12_tables(port, tb.tblk_host(port))


def test_chains_match_host_blocking():
    for T in (16, 32):
        chain_check(tb.build_tiled_blocking_plan, tb.execute_tiled_blocking,
                    T=T)


def test_refresh_reaches_the_cached_plan():
    refresh_check(tb.build_tiled_blocking_plan, tb.execute_tiled_blocking)


SCHED = dict(bond_dims=[20] * 4, noises=[1e-5] * 3 + [0], thrds=[1e-12],
             n_sweeps=4, tol=0)


@pytest.mark.parametrize("backend", ["resident", "tiled"])
def test_tiled_v1_backends_match_jax(monkeypatch, backend):
    """torch_resident / torch_tiled under B2TPU_STK_ENGINE=tiled_v1 (K12's
    twin blocks every environment) against jax_resident / jax_tiled under
    the same variable, Hubbard-L6, D=20."""
    monkeypatch.setenv("B2TPU_STK_ENGINE", "tiled_v1")
    monkeypatch.setenv("B2TPU_RES_MIN_SIZE", "1")
    monkeypatch.delenv("B2TPU_RES_EDGE_HOST", raising=False)
    drv, mpo = hubbard_driver(L=6)
    sched = (SCHED["bond_dims"], SCHED["noises"], SCHED["thrds"])
    rd = RefDMRG(mpo, drv.get_random_mps(20, seed=7),
                 backend=f"jax_{backend}", iprint=0, dtype=np.float64)
    assert rd.me.stk_engine == "tiled_v1"
    e_ref = rd.solve(*sched, n_sweeps=4, tol=0)
    _kernels.reset_counts()
    s = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(20, seed=7)),
             device="cpu", backend=f"torch_{backend}", iprint=0)
    assert s.me.stk_engine == "tiled_v1"
    assert all(isinstance(p, tb.TiledBlockingPlan)
               for _, p in s.me._stk_plans.values())
    e = s.solve(*sched, n_sweeps=4, tol=0)
    assert abs(e - e_ref) < 1e-8, (e, e_ref)
    assert s.host_redo_count == 0
    assert (s.host_env_materialized == 0) == (backend == "resident")


def test_unknown_engine_and_other_devices_raise(monkeypatch):
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.tblk_exec(x, x, x, {}, 16, True, x)
    monkeypatch.setenv("B2TPU_STK_ENGINE", "tiled_v2")
    drv, mpo = hubbard_driver(L=4)
    with pytest.raises(ValueError, match="unknown stacked engine"):
        DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(10, seed=1)),
             device="cpu")
