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
