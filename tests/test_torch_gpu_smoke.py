"""The port's chip probes (block2_preview_tpu_torch/utils/gpu_smoke.py,
kernel K19's plain versions on CPU tensors) against the JAX package's
(utils/tpu_smoke.py: the f32 ``dot`` einsum at HIGHEST precision and the
one-launch ``fill``), ``runtime.unpack_views`` against ops/devcache.py's
``_unpack``, the copied exact-diagonalization oracle (utils/ed.py)
against the reference's, and the precision probe's inputs against an
emulated TF32 rounding: the probe must fail where the card's float32
matmul rounded them as TF32 does."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from block2_preview_tpu.core.expr import qc_term_table as ref_qc_term_table
from block2_preview_tpu.core.fcidump import FCIDUMP as RefFCIDUMP
from block2_preview_tpu.ops.devcache import _unpack_jit
from block2_preview_tpu.utils import ed as ref_ed

from block2_preview_tpu_torch.core.expr import qc_term_table
from block2_preview_tpu_torch.core.fcidump import FCIDUMP
from block2_preview_tpu_torch.ops import _kernels
from block2_preview_tpu_torch.runtime import unpack_views
from block2_preview_tpu_torch.utils import ed, gpu_smoke

import test_torch_plans  # noqa: F401  (one torch thread per worker)


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits, round to nearest
    even), the rounding the card's tensor cores apply to float32 matmul
    inputs when TF32 is allowed."""
    i = x.astype(np.float32).view(np.int32).astype(np.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.astype(np.int32).view(np.float32)


def test_dot_twin_matches_reference_dot():
    """K19's dot (plain version) against tpu_smoke.py:33's einsum, on the
    reference probe's data and on this probe's."""
    rng = np.random.RandomState(0)
    a = (1.0 + rng.standard_normal(2048) * 1e-3).astype(np.float32)
    b = (1.0 - rng.standard_normal(2048) * 1e-3).astype(np.float32)
    for x, y in ((a, b), gpu_smoke.precision_inputs()):
        want = float(jnp.einsum("i,i->", jnp.asarray(x), jnp.asarray(y),
                                precision=jax.lax.Precision.HIGHEST))
        got = gpu_smoke.dot(torch.as_tensor(x), torch.as_tensor(y))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-6 * abs(want)


def k19_dot_order(a: np.ndarray, b: np.ndarray, threads: int = 1024):
    """csrc/probe.cu's dot in float32, in the kernel's order: thread t
    accumulates a[i] b[i] for i = t, t + threads, ... (each step rounded
    to float32 once, as fmaf rounds), each warp sums its lanes by the
    shuffle-down tree (offsets 16, 8, 4, 2, 1), and warp 0 sums the warps'
    partials the same way."""
    acc = np.zeros(threads, np.float32)
    for i0 in range(0, len(a), threads):
        x = a[i0:i0 + threads].astype(np.float64) \
            * b[i0:i0 + threads].astype(np.float64)
        acc[:len(x)] = (acc[:len(x)] + x).astype(np.float32)

    def warp_sum(v):
        v = v.copy()
        for s in (16, 8, 4, 2, 1):
            v[:32 - s] = v[:32 - s] + v[s:]
        return v[0]

    part = np.zeros(32, np.float32)
    part[:threads // 32] = [warp_sum(w) for w in acc.reshape(-1, 32)]
    return warp_sum(part)


@pytest.mark.parametrize("inputs", ["reference", "probe"])
def test_dot_kernel_order_matches_reference_dot(inputs):
    """K19's dot returns a 0-d float32 tensor equal to dot_plain (on the
    CPU it is dot_plain), and the kernel's summation order (emulated)
    lies within the same 1e-6 of tpu_smoke.py:33's einsum."""
    rng = np.random.RandomState(0)
    if inputs == "reference":
        a = (1.0 + rng.standard_normal(2048) * 1e-3).astype(np.float32)
        b = (1.0 - rng.standard_normal(2048) * 1e-3).astype(np.float32)
    else:
        a, b = gpu_smoke.precision_inputs()
    want = float(jnp.einsum("i,i->", jnp.asarray(a), jnp.asarray(b),
                            precision=jax.lax.Precision.HIGHEST))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    got = gpu_smoke.dot(ta, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, gpu_smoke.dot_plain(ta, tb))
    order = k19_dot_order(a, b)
    assert order.dtype == np.float32
    assert abs(float(order) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("n", [1 << 12, 1 << 20])
def test_fill_twin_matches_reference_fill(n):
    """K19's fill (plain version) against tpu_smoke.py:50's fill."""
    x = np.linspace(0.5, 1.5, 1024).astype(np.float32)
    big = jnp.zeros((n,), jnp.float32)
    want = float(big.at[:1024].set(jnp.asarray(x) * 2.0).sum())
    got = gpu_smoke.fill(torch.as_tensor(x), n)
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    assert float(gpu_smoke.fill(torch.ones(1024), n)) == 2048.0
    with pytest.raises(ValueError):
        gpu_smoke.fill(torch.ones(8), 4)
    with pytest.raises(TypeError):
        gpu_smoke.fill(torch.ones(8, dtype=torch.float64), 16)


@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_unpack_views_matches_unpack(dtype):
    """The same pieces as devcache._unpack, as views of the one tensor
    (no copy, nothing launched)."""
    shapes = ((3, 4), (5,), (2, 2, 2), (1, 7))
    flat = np.arange(sum(int(np.prod(s)) for s in shapes) + 3).astype(dtype)
    want = _unpack_jit()(jnp.asarray(flat), shapes)
    t = torch.as_tensor(flat)
    _kernels.reset_counts()
    got = unpack_views(t, shapes)
    assert sum(_kernels.launch_counts().values()) == 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.numpy(),
                                                     np.asarray(w))
        assert g._base is t or g.untyped_storage().data_ptr() \
            == t.untyped_storage().data_ptr()
    with pytest.raises(ValueError):
        unpack_views(t[:10], shapes)


def test_precision_inputs_are_exact_in_f32_and_rounded_by_tf32():
    a, b = gpu_smoke.precision_inputs()
    assert a.dtype == b.dtype == np.float32
    k = (a.astype(np.float64) - 1.0) * 2.0 ** 12
    assert np.array_equal(k, np.round(k)) and np.all(np.round(k) % 4 == 1)
    ref = np.dot(a.astype(np.float64), b.astype(np.float64))
    rel_f32 = abs(float(np.dot(a, b)) - ref) / ref
    rel_tf32 = abs(np.dot(tf32(a).astype(np.float64),
                          tf32(b).astype(np.float64)) - ref) / ref
    assert rel_f32 < gpu_smoke.PRECISION_TOL < rel_tf32
    # the reference probe's inputs (1 +- 1e-3 noise) would not catch TF32
    rng = np.random.RandomState(0)
    a0 = (1.0 + rng.standard_normal(2048) * 1e-3).astype(np.float32)
    b0 = (1.0 - rng.standard_normal(2048) * 1e-3).astype(np.float32)
    r0 = np.dot(a0.astype(np.float64), b0.astype(np.float64))
    assert abs(np.dot(tf32(a0).astype(np.float64),
                      tf32(b0).astype(np.float64)) - r0) / r0 \
        < gpu_smoke.PRECISION_TOL


def test_precision_probe_fails_under_emulated_tf32():
    """The probe passes in float32 and fails when its products see the
    inputs rounded as TF32 rounds them, through the dot and the matmul."""
    ok = gpu_smoke.precision_probe("cpu")
    assert ok["ok"] and ok["rel_err"] < 1e-6
    a, b = gpu_smoke.precision_inputs()
    bad = gpu_smoke.precision_probe("cpu", inputs=(tf32(a), tf32(b)))
    assert not bad["ok"]
    assert bad["dot_rel_err"] > gpu_smoke.PRECISION_TOL
    assert bad["matmul_rel_err"] > gpu_smoke.PRECISION_TOL


def test_ed_matches_reference():
    fd, rfd = FCIDUMP.hubbard(4, u=2, t=1), RefFCIDUMP.hubbard(4, u=2, t=1)
    tt, rtt = qc_term_table(fd), ref_qc_term_table(rfd)
    assert (abs(ed.term_table_to_sparse(tt)
                - ref_ed.term_table_to_sparse(rtt)).max() == 0)
    assert np.array_equal(ed.sector_indices(4, 4, 0),
                          ref_ed.sector_indices(4, 4, 0))
    e = ed.ground_state_energy(tt, 4, 0, fd.const_e, k=3)
    assert np.abs(e - ref_ed.ground_state_energy(rtt, 4, 0, rfd.const_e,
                                                  k=3)).max() < 1e-12


def test_run_smoke_on_cpu():
    """Every probe at a small size on the CPU (the twins): all ok; the
    tiled solve lands within its float32 floor of exact
    diagonalization."""
    res = gpu_smoke.run_smoke("cpu", pool_elems=1 << 16, tiled=(4, 20, 4))
    assert res["ok"], res
    assert res["large_pool"]["value"] == 2048.0
    assert res["tiled_solve"]["abs_err"] < 5e-4
    assert res["precision_f32"]["rel_err"] < gpu_smoke.PRECISION_TOL
    assert gpu_smoke.run_smoke.__defaults__[0] == "cuda"
