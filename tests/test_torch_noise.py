"""Perturbative noise of the port (ops/resident.py NoisePlan, kernel K6):
the plan's tables equal the reference's NoisePlan, and the plain twin on
CPU tensors gives the JAX package's ``NoisePlan.rho_device`` and the host
noise density matrix (``_average_rho_forward``/``_backward``) to atol
1e-10, forward (LW) and backward (RW) — mirroring
test_noise_device.py::test_device_noise_forward_backward_parity."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg.sweep import (_apply_noise,
                                           _average_rho_backward,
                                           _average_rho_forward)
from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix
from block2_preview_tpu.ops.resident import NoisePlan as RefNoisePlan

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops import resident

from test_torch_plans import SITES, Site, hubbard_system

NOISE = 1e-3


@pytest.fixture(scope="module")
def center():
    """Site t of Hubbard-L8 with the JAX-mixed LW/RW pools, the reference
    matvec struct and a normalized random psi."""
    import jax.numpy as jnp
    site = Site(*hubbard_system(), SITES[1])
    plans, pools = {}, {}
    for side in ("lw", "rw"):
        _, p4, pool = site.ref_plans(side)
        plans[side] = p4
        pools[side] = np.asarray(ref_execute_mix(p4, jnp.asarray(pool),
                                                 dtype=np.float64))
    ref_ex = site.ref_matvec(plans["lw"], plans["rw"])
    x = np.random.RandomState(5).standard_normal(site.eff.size)
    return site, plans, pools, ref_ex, x / np.linalg.norm(x)


def _plans(center, side):
    site, plans, _, ref_ex, _ = center
    s = ref_ex.struct
    psi_idx = s["psi_idx"] if side == "lw" else None
    ref = RefNoisePlan(site.eff.ket_space, plans[side].meta_out,
                       site.mpo.group, side, s["T"], psi_idx)
    port = resident.NoisePlan(site.peff.ket_space,
                              interop.stacked_meta(plans[side].meta_out),
                              site.pmpo.group, side, s["T"], psi_idx)
    return ref, port


@pytest.mark.parametrize("side", ["lw", "rw"])
def test_noise_plan_tables_match_reference(center, side):
    ref, port = _plans(center, side)
    assert np.array_equal(port.psi_idx, ref.psi_idx)
    assert port.sectors == ref.sectors and port.nrho == ref.nrho
    for k in ("cum1", "cum2"):
        assert np.array_equal(getattr(port, k), getattr(ref, k)), k
    # every item field but tb (here the item's base in one x pool; the
    # reference restarted it per task group)
    cols = [c for c in range(10) if c != 7]
    assert np.array_equal(port.it[:, cols], ref.it[:, cols])
    live = np.diff(port.cum1) > 0
    nx = port.it[:, 4].astype(np.int64) * port.it[:, 6]
    assert np.array_equal(port.it[live, 7],
                          np.concatenate([[0], np.cumsum(nx[live])[:-1]]))
    assert port.n_x == int(nx[live].sum())


@pytest.mark.parametrize("side", ["lw", "rw"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_noise_twin_matches_jax_and_host(center, side, dtype, tol):
    import jax.numpy as jnp
    site, _, pools, ref_ex, x = center
    ref, port = _plans(center, side)
    xp = ref_ex.pad(x)
    want = ref.unpack(np.asarray(ref.rho_device(jnp.asarray(xp),
                                                jnp.asarray(pools[side]))))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rho = resident.noise_exec(torch.as_tensor(xp, dtype=tdt),
                              interop.slab_pool(pools[side], "cpu", dtype),
                              port.tables("cpu"), port.T)
    assert rho.dtype == tdt and rho.shape == (port.nrho + 1, port.T, port.T)
    got = port.unpack(rho.numpy())
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for q in want:
        assert np.abs(got[q] - want[q]).max() <= tol * max(scale, 1.0), q
    if dtype != np.float64:
        return
    # the host noise density matrix of the same psi
    eff = site.eff
    psi = eff.unflatten(x)
    avg = _average_rho_forward if side == "lw" else _average_rho_backward
    host = avg(eff, [psi], [1.0], NOISE)
    dev = _apply_noise(avg(eff, [psi], [1.0], 0.0), got, NOISE)
    assert set(host) == set(dev)
    for q in host:
        assert np.allclose(host[q], dev[q], atol=1e-10), q


def test_resident_site_noise_rho(center):
    """ResidentSite.noise_rho on the port's device chain (CPU tensors)
    equals the host noise density matrix, both sides."""
    from test_torch_resident import _resident
    site, rs = _resident(hubbard_system(), SITES[1])
    x = center[4]
    psi = site.eff.unflatten(x)
    for forward, avg in ((True, _average_rho_forward),
                         (False, _average_rho_backward)):
        host = avg(site.eff, [psi], [1.0], NOISE)
        dev = _apply_noise(avg(site.eff, [psi], [1.0], 0.0),
                           rs.noise_rho(x, forward), NOISE)
        for q in host:
            assert np.allclose(host[q], dev[q], atol=1e-10), q
    assert rs.me.host_ops_downloads == 0
