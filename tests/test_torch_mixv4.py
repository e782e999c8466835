"""Kernels K3 (mix GEMM) and K4 (window place) of the port: their plain
twins — what execute_mix_v4 runs on CPU tensors — against the
reference's execute_mix_v4 (JAX) on the same reference-built plan, for
the LW and RW pools (f64: atol 1e-12 relative to the pool scale; f32:
1e-5), and against the host assembly of EffectiveHamiltonian2."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops import mixv4

from test_torch_plans import SITES, Site, hubbard_system


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


def _both(site, side, dtype):
    import jax.numpy as jnp
    _, r4, pool = site.ref_plans(side)
    pool = pool.astype(dtype)
    ref = np.asarray(ref_execute_mix(r4, jnp.asarray(pool), dtype=dtype))
    got = mixv4.execute_mix_v4(interop.mix_plan_v4(r4),
                               interop.slab_pool(pool, "cpu", dtype))
    return ref, got.numpy()


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_mix_twins_match_jax_f64(system, t, side):
    ref, got = _both(Site(*system, t), side, np.float64)
    assert got.shape == ref.shape
    assert got[-1] == 0.0                      # zero sentinel kept
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 1e-12 * scale


@pytest.mark.parametrize("side", ["lw", "rw"])
def test_mix_twins_match_jax_f32(system, side):
    ref, got = _both(Site(*system, SITES[1]), side, np.float32)
    assert got.dtype == np.float32
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 1e-5 * scale


def test_mix_matches_host_assembly(system):
    """Every host-assembled LW/RW block equals the port's slab content
    (mirrors test_resident.py::test_mix_matches_host_assembly)."""
    site = Site(*system, SITES[1])
    eff = site.eff
    for side, ops in (("lw", eff.LW), ("rw", eff.RW)):
        _, p4, pool = site.port_plans(side)
        slab = mixv4.execute_mix_v4(p4, torch.as_tensor(pool)).numpy()
        meta = p4.meta_out
        n_checked = 0
        for m, blocks in ops.items():
            gi, j = meta.sym_pos[m]
            for (qb, qk), blk in blocks.items():
                off, db, dk = meta.sectors[gi][qb]
                got = slab[off + j * db * dk:off + (j + 1) * db * dk]
                assert np.allclose(got.reshape(db, dk), blk, atol=1e-12), \
                    (side, m, qb, qk)
                n_checked += 1
        assert n_checked > 0


@pytest.mark.parametrize("side", ["lw", "rw"])
def test_unpacked_reference_kernels_match_k3_k4(system, side):
    """B20: the reference's unpacked-table jits — _mix4_exec (mixv4.py:277)
    and _place4_exec (:101) walked as a chunked sequence of group windows
    (i0, ng), the TPU watchdog chunking — against one call each of K3's and
    K4's twins on the same plan_v4 tables: the same OUT buffer and the same
    slab pool."""
    import jax.numpy as jnp
    from block2_preview_tpu.ops import mixv4 as ref
    _, r4, pool = Site(*system, SITES[1]).ref_plans(side)
    otp = ref._cap_class(r4.out_total + 1)
    out_ref = ref._mix4_exec(
        jnp.asarray(pool), jnp.asarray(r4.wdense.real), jnp.asarray(r4.it),
        jnp.asarray(r4.cum1), jnp.asarray(r4.cum2), jnp.asarray(r4.g1),
        jnp.asarray(r4.g2), jnp.asarray(r4.e1), jnp.asarray(r4.e2),
        jnp.zeros(otp + 1), jnp.asarray(r4.ng_live, jnp.int32), ref._T4,
        ref._B4, ref._NTP4)
    res_ref = jnp.zeros(r4.ncap_out + 1)
    # groups of B = 64 tile tasks (not the plan's 8192, which makes one
    # group here), walked in windows of a third of them
    B = 64
    png = -(-int(r4.pcum[-1]) // B)
    step = max(1, png // 3)
    assert png > step             # at least two windows
    for i0 in range(0, png, step):
        res_ref = ref._place4_exec(
            out_ref[:otp], jnp.asarray(r4.pit), jnp.asarray(r4.pcum),
            res_ref, jnp.asarray(i0, jnp.int32),
            jnp.asarray(min(i0 + step, png), jnp.int32), ref._TP, B)
    p4 = interop.mix_plan_v4(r4)
    d = mixv4.plan_tables(p4, "cpu", torch.float64)
    out = torch.zeros(otp + 1, dtype=torch.float64)
    mixv4.mix_exec(torch.as_tensor(pool), d["wpool"], d, out)
    scale = max(np.abs(np.asarray(out_ref)).max(), 1.0)
    assert np.abs(out.numpy()[:otp] - np.asarray(out_ref)[:otp]).max() \
        <= 1e-12 * scale
    res = torch.zeros(p4.ncap_out + 1, dtype=torch.float64)
    mixv4.place_exec(out[:otp], d, res)
    assert np.abs(res.numpy() - np.asarray(res_ref)).max() <= 1e-12 * scale
