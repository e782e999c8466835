"""The v1 slab matvec of the port — kernel K16 (SlabMatvec): its struct
field by field against the reference's SlabMatvec, K16's plain twin
(what matvec_device runs on CPU tensors) against the reference's
_slab_matvec_impl (JAX on the CPU) on the same struct and pools (f64:
1e-12 relative; f32: 1e-5), and against K1's twin (MatvecV2) on the same
LW/RW pools: both compute H x."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.ops import resident as ref_resident
from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops import resident, tilev2

from test_torch_plans import SITES, Site, _eq, hubbard_system


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


def _setup(site, dtype=np.float64):
    """Reference v4 plans, their LW/RW pools (reference mix) and the
    reference SlabMatvec of the site."""
    import jax.numpy as jnp
    plans, pools = {}, {}
    for side in ("lw", "rw"):
        _, p4, pool = site.ref_plans(side)
        plans[side] = p4
        pools[side] = np.asarray(ref_execute_mix(
            p4, jnp.asarray(pool.astype(dtype)), dtype=dtype))
    eff = site.eff
    ref = ref_resident.SlabMatvec(eff.ket_space, plans["lw"].meta_out,
                                  plans["rw"].meta_out, site.mpo.group,
                                  eff.target, eff.target, dtype=dtype,
                                  bra_space=eff.bra_space)
    return plans, pools, ref


@pytest.mark.parametrize("t", SITES)
def test_struct_equals_the_reference(system, t):
    """SlabMatvec._build on the port's own LW/RW layouts gives the
    reference's struct."""
    site = Site(*system, t)
    plans, _, ref = _setup(site)
    pl, pr = site.port_plans("lw")[1], site.port_plans("rw")[1]
    eff = site.peff
    ex = resident.SlabMatvec(eff.ket_space, pl.meta_out, pr.meta_out,
                             site.pmpo.group, eff.target, eff.target,
                             bra_space=eff.bra_space)
    _eq(ex.struct, ref.struct, "struct")
    assert set(ex.struct) == {"T", "nt1", "nt2", "size_p", "sizb_p",
                              "psi_idx", "sig_idx", "l4", "pa", "s1", "ta",
                              "r4", "s2"}


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twin_matches_jax(system, t, dtype):
    import jax.numpy as jnp
    site = Site(*system, t)
    _, pools, ref = _setup(site, dtype)
    x = np.random.default_rng(5).standard_normal(site.eff.size)
    xp = ref.pad(x)
    want = np.asarray(ref.matvec_device(jnp.asarray(xp),
                                        jnp.asarray(pools["lw"]),
                                        jnp.asarray(pools["rw"])))
    ex = interop.slab_matvec(ref, dtype)
    got = ex.matvec_device(torch.as_tensor(ex.pad(x)),
                           torch.as_tensor(pools["lw"]),
                           torch.as_tensor(pools["rw"])).numpy()
    assert got.dtype == dtype and got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert np.abs(got - want).max() <= tol * scale
    assert np.abs(got[site.eff.size:]).max(initial=0.0) == 0.0


def test_twin_matches_matvec_v2_and_host(system):
    """On the same LW/RW pools K16's twin and K1's twin compute the same
    sigma, which is the host effective Hamiltonian's H x."""
    site = Site(*system, SITES[1])
    plans, pools, ref = _setup(site)
    x = np.random.default_rng(6).standard_normal(site.eff.size)
    lw, rw = (torch.as_tensor(pools[s]) for s in ("lw", "rw"))
    ex = interop.slab_matvec(ref)
    y16 = ex.matvec_device(torch.as_tensor(ex.pad(x)), lw, rw).numpy()
    v2 = interop.matvec_v2(site.ref_matvec(plans["lw"], plans["rw"]))
    s = v2.struct
    y1 = tilev2.mv_exec(torch.as_tensor(v2.pad(x)), lw, rw,
                        v2.to_device("cpu"), s["T"], s["nt2"]).numpy()
    n = site.eff.size
    scale = np.abs(y1[:n]).max()
    assert np.abs(y16[:n] - y1[:n]).max() <= 1e-12 * scale
    assert np.abs(y16[:n] - site.eff.matvec_np(x)).max() <= 1e-10 * scale


def test_tmp_offsets_cover_every_group(system):
    """to_device's toff gives each task group its own run of tmp tiles,
    as many as the group's largest stage-1 target + 1."""
    site = Site(*system, SITES[1])
    _, _, ref = _setup(site)
    ex = interop.slab_matvec(ref)
    d = ex.to_device("cpu")
    s1, nt1 = ex.struct["s1"], ex.struct["nt1"]
    toff = d["toff"].numpy()
    assert len(toff) == s1.shape[0] + 1 and toff[0] == 0
    for g in range(s1.shape[0]):
        live = s1[g][s1[g] < nt1]
        assert toff[g + 1] - toff[g] == (live.max() + 1 if len(live) else 0)
    assert d["ntmp"] == toff[-1]
    assert ex.to_device("cpu") is d            # cached per device
    ex.free()
    assert ex.to_device("cpu") is not d


def test_other_devices_raise():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resident.slab_mv_exec(x, x, x, {}, 16, 1, 1)
