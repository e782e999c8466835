"""PlanExecutor of the port — the padded-bucket sigma matvec, kernel K18
(block2_preview_tpu_torch/ops/exec_bucket.py) — against the JAX package's
PlanExecutor (exec_jax.py:75-128) on the same Hubbard-L8 center built in
code (D=60, two host sweeps): ``device_buckets`` field by field, K18's
plain twin against the reference's ``_execute_impl`` and both matvecs
(f64 to 1e-12, f32 to 1e-5 relative to the largest entry), and against
the bucketed executor (K8's twin) on the same center; the buckets are
views of two flat pools (``runtime.unpack_views``)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from block2_preview_tpu.ops.exec_jax import PlanExecutor as RefPlanExecutor
from block2_preview_tpu.ops.exec_jax import _execute_impl

from block2_preview_tpu_torch.ops import _kernels, exec_bucket
from block2_preview_tpu_torch.ops.exec_bucket import (BucketExecutor,
                                                      PlanExecutor)

from test_torch_bucket import _state, rel

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(scope="module")
def l8():
    """Both packages' two-site operators at the Hubbard-L8 center."""
    from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian2
    from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

    from block2_preview_tpu_torch import interop
    from block2_preview_tpu_torch.dmrg.effective import (
        EffectiveHamiltonian2 as PortEff)
    from block2_preview_tpu_torch.dmrg.environment import (
        MovingEnvironment as PortME)
    mpo, mps, t = _state("hubbard")
    d = RefDMRG(mpo, mps, backend="numpy", iprint=0)
    for s in range(t):
        d.me.update_left(s)
    pme = PortME(interop.mpo(mpo), interop.mps(mps))
    for s in range(mpo.n_sites - 1, t + 1, -1):
        pme.update_right(s)
    for s in range(t):
        pme.update_left(s)
    return EffectiveHamiltonian2(d.me, t), PortEff(pme, t)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_device_buckets_match_reference(l8, dtype):
    """(A, R, pidx, oidx) per sorted _round_dim key, the batch padded by
    _round_batch, sentinel size_p: equal to the reference's, with its
    types; a padded batch somewhere."""
    reff, peff = l8
    ref = RefPlanExecutor(reff, dtype=dtype)
    ex = PlanExecutor(peff, dtype=dtype, device="cpu")
    assert (ex.size, ex.size_p, ex.VEC_PAD) == (ref.size, ref.size_p,
                                                ref.VEC_PAD)
    assert len(ex.device_buckets) == len(ref.device_buckets) > 1
    padded = False
    for got, want in zip(ex.device_buckets, ref.device_buckets):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g.numpy(), w)
        padded |= bool((np.asarray(want[3]) == ref.size_p).all(
            axis=(1, 2)).any())
    assert padded
    # desc / cum: K18's bucket table
    d = ex.desc.numpy()
    for (A, R, pidx, oidx), row in zip(ex.device_buckets, d):
        assert tuple(row[:4]) == (A.shape[1], A.shape[2], R.shape[2],
                                  R.shape[1])
        assert row[4] == exec_bucket.chain_blocks(A.shape[1], R.shape[1])
    assert ex.n_blocks == int(ex.cum[-1]) == int(
        (d[:, 4] * [b[0].shape[0] for b in ex.device_buckets]).sum())


def test_buckets_are_views_of_two_pools(l8):
    _, peff = l8
    ex = PlanExecutor(peff, device="cpu")
    v0, i0 = ex.vals.data_ptr(), ex.ints.data_ptr()
    vend = v0 + ex.vals.numel() * ex.vals.element_size()
    iend = i0 + ex.ints.numel() * ex.ints.element_size()
    for A, R, pidx, oidx in ex.device_buckets:
        for t in (A, R):
            assert v0 <= t.data_ptr() < vend and t.is_contiguous()
        for t in (pidx, oidx):
            assert i0 <= t.data_ptr() < iend and t.dtype == torch.int32
    assert int(ex.desc[-1, 8]) + ex.device_buckets[-1][3].numel() \
        == ex.ints.numel()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twin_matches_reference_execute(l8, dtype):
    """K18's twin on the port's stacks against _execute_impl on the
    reference's, and both PlanExecutor.matvec (float64 host values)."""
    reff, peff = l8
    ref = RefPlanExecutor(reff, dtype=dtype)
    ex = PlanExecutor(peff, dtype=dtype, device="cpu")
    x = np.random.default_rng(3).standard_normal(ex.size)
    want = np.asarray(_execute_impl(jnp.asarray(x.astype(dtype)),
                                    ref.device_buckets))
    xp = torch.zeros(ex.size_p + 1, dtype=ex.vals.dtype)
    xp[:ex.size] = torch.as_tensor(x)
    sig = exec_bucket.plan_exec(xp, ex)
    assert sig.shape == (ex.size_p + 1,)
    assert rel(sig[:ex.size].numpy(), want[:ex.size]) < TOL[dtype]
    got = ex.matvec(x)
    assert got.dtype == np.float64 and got.shape == (ex.size,)
    assert rel(got, ref.matvec(x)) < TOL[dtype]


def test_matches_bucketed_executor(l8):
    """The padded stacks and K8's true-shape items compute one sigma."""
    _, peff = l8
    x = np.random.default_rng(4).standard_normal(peff.size)
    got = PlanExecutor(peff, device="cpu").matvec(x)
    ref = BucketExecutor(peff, device="cpu").matvec(x)
    assert rel(got, ref) < 1e-12


def test_drop_and_checks(l8):
    """An output index past the end is dropped, as mode="drop"; a wrong
    psi shape, a complex operator and a float16 executor raise; the CPU
    twin launches nothing."""
    _, peff = l8
    ex = PlanExecutor(peff, device="cpu")
    _kernels.reset_counts()
    xp = torch.ones(ex.size_p + 1, dtype=torch.float64)
    A, R, pidx, oidx = ex.device_buckets[0]
    buckets = [(A, R, pidx, torch.full_like(oidx, ex.size_p + 5))]
    sig = exec_bucket.plan_exec_plain(xp, buckets, ex.size_p + 1)
    assert not sig.any()
    assert _kernels.launch_counts()["K18_plan_exec"] == 0
    with pytest.raises(ValueError):
        exec_bucket.plan_exec(xp[:-1], ex)
    with pytest.raises(TypeError):
        PlanExecutor(peff, dtype=np.float16, device="cpu")

    class Cplx:
        dtype = np.complex128
    with pytest.raises(TypeError, match="torch_tiled"):
        PlanExecutor(Cplx(), device="cpu")
