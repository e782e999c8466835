"""Mix v2 of the port — kernel K15 (scatter tile mix): the plan of
build_mix_plan field by field against the reference's, K15's plain twin
(what execute_mix runs on CPU tensors) against the reference's _mix_exec
(JAX on the CPU) on the same tables, execute_mix against the reference's
and against the v3/v4 pools (f64: 1e-12 relative to the pool scale;
f32: 1e-5), the LW/RW blocks against the host assembly, and
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
    import jax.numpy as jnp
    r2, pool = _ref_plan(Site(*system, SITES[1]), "rw")
    pool = pool.astype(dtype)
    pool[-1] = 7.0
    out = jnp.zeros(r2.ncap_out + 1, dtype=dtype)
    for li in range(r2.n_launch):
        out = ref_resident._mix_exec(
            out, jnp.asarray(pool), jnp.asarray(r2.s[li]),
            jnp.asarray(r2.coef[li].astype(dtype)), r2.T, r2.ncap_out,
            ref_resident._MIX_SCAN)
    ref = np.asarray(out)
    p2 = interop.mix_plan_v2(r2)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    d = resident.mix_tables(p2, "cpu", tdt)
    got = resident.mix_v2_exec(torch.zeros(p2.ncap_out + 1, dtype=tdt),
                               torch.as_tensor(pool), d).numpy()
    _close(got, ref, 1e-12 if dtype == np.float64 else 1e-5)
    assert got[-1] == 0.0 and ref[-1] == 0.0


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
