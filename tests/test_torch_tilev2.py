"""Kernel K1 (sigma matvec) of the port: its plain twin — what the wrapper
runs on CPU tensors — against the reference's MatvecV2.matvec_device
(JAX) on the same reference-built plan, f64, relative error < 1e-12;
including the multi-group case forced by tiny budgets."""

import numpy as np
import pytest
import torch

import block2_preview_tpu.ops.tilev2 as ref_tv2
from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix

import block2_preview_tpu_torch.ops.tilev2 as tv2
from block2_preview_tpu_torch import interop

from test_torch_plans import SITES, Site, hubbard_system

TOL = 1e-12


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


def _ref_pools(site):
    """Reference plans and the JAX-mixed LW/RW pools (numpy)."""
    import jax.numpy as jnp
    out = {}
    for side in ("lw", "rw"):
        _, p4, pool = site.ref_plans(side)
        out[side] = (p4, np.asarray(ref_execute_mix(p4, jnp.asarray(pool),
                                                    dtype=np.float64)))
    return out


def _compare(ref_ex, lw, rw, n_vec=2, seed=3):
    import jax.numpy as jnp
    ex = interop.matvec_v2(ref_ex)
    tl = interop.slab_pool(lw, "cpu")
    tr = interop.slab_pool(rw, "cpu")
    rng = np.random.RandomState(seed)
    for _ in range(n_vec):
        xp = ex.pad(rng.standard_normal(ex.size))
        ref = np.asarray(ref_ex.matvec_device(jnp.asarray(xp),
                                              jnp.asarray(lw),
                                              jnp.asarray(rw)))
        got = ex.matvec_device(torch.as_tensor(xp), tl, tr).numpy()
        assert got.shape == ref.shape
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < TOL, err


@pytest.mark.parametrize("t", SITES)
def test_matvec_twin_matches_jax(system, t):
    site = Site(*system, t)
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    _compare(site.ref_matvec(pl, pr), lw, rw)


@pytest.mark.parametrize("T", [16, 32, 64, 128])
def test_matvec_twin_tile_sizes(system, T):
    """Every tile size the kernel is built for, forced on one site (the
    site's own plan picks one of them)."""
    site = Site(*system, SITES[1])
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    ref_ex = site.ref_matvec(pl, pr, T=T)
    assert ref_ex.struct["T"] == T
    _compare(ref_ex, lw, rw, n_vec=1, seed=T)


def test_matvec_twin_multigroup(monkeypatch):
    """Tiny stage budgets put (almost) every item in its own group, so a
    group-aware engine would have to restart tmp bases per group; the
    port's one-launch form must still agree (mirrors
    test_resident.py::test_matvec_v2_multigroup_parity)."""
    site = Site(*hubbard_system(D=24), SITES[1])
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    ex0 = site.ref_matvec(pl, pr, T=16)
    f = ex0.struct["it"].astype(np.int64)
    na, nk, npp, nn = f[:, 8], f[:, 9], f[:, 10], f[:, 11]
    need = int(max((na * nn * nk).max(), (na * nn * npp).max()))
    cfg = (need, max(int((na * nn).max()), 1))
    monkeypatch.setitem(ref_tv2._CFG, 16, cfg)
    monkeypatch.setitem(tv2._CFG, 16, cfg)
    ref_ex = site.ref_matvec(pl, pr, T=16)
    assert ref_ex.struct["ng_live"] > 2, "budgets did not force groups"
    _compare(ref_ex, lw, rw, n_vec=1, seed=11)
    # the port's own builder gives the same grouping under the budgets
    port = tv2.MatvecV2(site.eff.ket_space, pl.meta_out, pr.meta_out,
                        site.mpo.group, site.eff.target, dtype=np.float64,
                        T=16, bra_space=site.eff.bra_space)
    for k in ("it", "cum1", "cum2", "g1", "g2"):
        assert np.array_equal(port.struct[k], ref_ex.struct[k]), k


def test_matvec_twin_matches_host_operator(system):
    """Port builder + port twin against the host effective Hamiltonian
    (the assembled LW/RW of EffectiveHamiltonian2.matvec_np)."""
    site = Site(*system, SITES[1])
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    eff = site.eff
    ex = tv2.MatvecV2(eff.ket_space, interop.stacked_meta(pl.meta_out),
                      interop.stacked_meta(pr.meta_out), site.mpo.group,
                      eff.target, dtype=np.float64,
                      bra_space=eff.bra_space)
    x = np.random.RandomState(7).standard_normal(eff.size)
    got = ex.matvec_device(torch.as_tensor(ex.pad(x)),
                           interop.slab_pool(lw, "cpu"),
                           interop.slab_pool(rw, "cpu")).numpy()[:eff.size]
    ref = eff.matvec_np(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < TOL


def test_matvec_wrapper_refuses_other_devices():
    """The wrapper runs the twin only for CPU tensors; any other device
    that is not CUDA is refused rather than silently moved."""
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError):
        tv2.mv_exec(x, x, x, {}, 16, 1)


@pytest.mark.parametrize("bad", [
    torch.zeros(4, dtype=torch.float64),            # on the CPU
    torch.zeros(4, 2, dtype=torch.float64).t(),     # not contiguous
])
def test_kernel_call_refuses_bad_tensors(bad):
    """Every kernel call validates its tensors before the library is
    built or loaded: a CPU or non-contiguous tensor never reaches a
    kernel as a pointer."""
    from block2_preview_tpu_torch.ops import _kernels
    with pytest.raises(ValueError, match="contiguous CUDA"):
        _kernels.call("b2t_gather", torch.float64, bad, 4)
    assert _kernels._lib is None
