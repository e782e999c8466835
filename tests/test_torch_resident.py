"""Kernel K2 (diagonal) of the port against the reference's execute_diag
(JAX) on the same plan (< 1e-10), the torch Davidson through a thick
restart, and the port's ResidentSite against the host effective
Hamiltonian."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.ops.davidson import davidson as host_davidson
from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix
from block2_preview_tpu.ops.resident import (build_diag_struct as
                                             ref_build_diag_struct,
                                             execute_diag as ref_execute_diag)

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops.device_davidson import davidson
from block2_preview_tpu_torch.ops.resident import ResidentSite, execute_diag

from test_torch_plans import SITES, Site, hubbard_system


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


@pytest.mark.parametrize("t", SITES)
def test_diag_twin_matches_jax(system, t):
    import jax.numpy as jnp
    site = Site(*system, t)
    pools, plans = {}, {}
    for side in ("lw", "rw"):
        _, p4, pool = site.ref_plans(side)
        plans[side] = p4
        pools[side] = np.asarray(ref_execute_mix(p4, jnp.asarray(pool),
                                                 dtype=np.float64))
    ref_ex = site.ref_matvec(plans["lw"], plans["rw"])
    s = ref_ex.struct
    eff = site.eff
    ds = ref_build_diag_struct(eff.ket_space, plans["lw"].meta_out,
                               plans["rw"].meta_out, s["T"], s["nt2"],
                               s["sig_idx"])
    ref = np.asarray(ref_execute_diag(ds, jnp.asarray(pools["lw"]),
                                      jnp.asarray(pools["rw"])))
    got = execute_diag(interop.diag_struct(ds),
                       interop.slab_pool(pools["lw"], "cpu"),
                       interop.slab_pool(pools["rw"], "cpu")).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-10
    assert np.abs(got[:eff.size] - eff.diagonal()).max() < 1e-10


def _padded(A):
    """matvec on padded vectors [n + 1] -> [n], as K1 presents it."""
    At = torch.as_tensor(A)
    return lambda v: At @ v[:-1]


def test_davidson_thick_restart():
    """Convergence through the subspace-compression restart (m > M);
    mirrors test_resident.py::test_device_davidson_thick_restart and
    agrees with the JAX device Davidson on the same inputs."""
    import jax.numpy as jnp
    from block2_preview_tpu.ops.device_davidson import device_davidson
    rng = np.random.RandomState(0)
    n = 64
    A = rng.standard_normal((n, n))
    A = 0.5 * (A + A.T) - 120 * np.eye(n) \
        + np.diag(rng.standard_normal(n) * 5)
    w_true = np.linalg.eigvalsh(A)[0]
    x0 = rng.standard_normal(n)
    x0 /= np.linalg.norm(x0)
    xp = torch.as_tensor(np.append(x0, 0.0))
    dg = torch.as_tensor(np.append(np.diag(A), 0.0))
    th, x, it = davidson(_padded(A), dg, xp, conv_thrd=1e-12,
                         max_iter=200, max_subspace=12)
    assert it > 12                  # must pass at least one restart
    assert abs(th - w_true) < 1e-9
    assert float(x[-1]) == 0.0      # the pad slot stays zero
    v = x[:-1].numpy()
    assert np.linalg.norm(A @ v - th * v) < 1e-5
    Aj = jnp.asarray(A)
    th_j, _, _ = device_davidson(lambda u: Aj @ u,
                                 jnp.asarray(np.diag(A).copy()),
                                 jnp.asarray(x0), conv_thrd=1e-12,
                                 max_iter=200, max_subspace=12)
    assert abs(th - float(th_j)) < 1e-9


def _resident(system, t, dtype=np.float64):
    site = Site(*system, t)
    me, eff = site.eff.me, site.eff
    return site, ResidentSite(me, eff, "cpu", dtype=dtype, caches={})


@pytest.mark.parametrize("t", SITES)
def test_resident_site_ground_state(system, t):
    """ResidentSite (mix -> diag -> Davidson around K1) finds the host
    Davidson's lowest eigenvalue of the same effective Hamiltonian."""
    site, rs = _resident(system, t)
    eff = site.eff
    x0 = np.random.RandomState(2).standard_normal(eff.size)
    x0 /= np.linalg.norm(x0)
    th, xv, nmv = rs.solve_ground_state(x0, conv_thrd=1e-12, max_iter=200)
    w, _, _ = host_davidson(eff.matvec_np, eff.diagonal(), x0[:, None],
                            conv_thrd=1e-12, max_iter=200)
    assert abs(th - float(w[0])) < 1e-9
    assert np.linalg.norm(eff.matvec_np(xv) - th * xv) < 1e-5
    assert nmv > 0


def test_resident_site_host_ops(system):
    """host_ops (the download for the host noise term) returns the host
    assembly's LW/RW blocks."""
    site, rs = _resident(system, SITES[1])
    for which, ops in (("lw", site.eff.LW), ("rw", site.eff.RW)):
        got = rs.host_ops(which)
        for m, blocks in ops.items():
            for key, blk in blocks.items():
                if not blk.any():
                    continue
                assert np.allclose(got[m][key], blk, atol=1e-12), \
                    (which, m, key)


def test_resident_site_f32(system):
    """The float32 path (pools, kernels' twins, Davidson) lands within
    float32 accuracy of the f64 eigenvalue."""
    site, rs = _resident(system, SITES[1], dtype=np.float32)
    assert rs.lw_pool.dtype == torch.float32
    eff = site.eff
    x0 = np.random.RandomState(2).standard_normal(eff.size)
    th, _, _ = rs.solve_ground_state(x0, conv_thrd=1e-8, max_iter=200)
    w, _, _ = host_davidson(eff.matvec_np, eff.diagonal(), x0[:, None],
                            conv_thrd=1e-12, max_iter=200)
    assert abs(th - float(w[0])) < 1e-4
