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

from block2_preview_tpu_torch.ops import _kernels, chain_mv, exec_bucket
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
    # items / slots: each true item at its bucket's batch index, reading
    # A[b] and R[b] at their padded row lengths; padding items are none
    it, sl = ex.items, ex.slots
    assert sl.shape == (len(it), 2)
    esz = ex.vals.element_size()
    for bi, (A, R, pidx, oidx) in enumerate(ex.device_buckets):
        mine = sl[:, 0] == bi
        b = sl[mine, 1]
        n_true = int((np.asarray(oidx.numpy() < ex.size_p).any(axis=(1, 2))
                      ).sum())
        assert np.array_equal(b, np.arange(n_true))
        f = it[mine]
        a0 = (A.data_ptr() - ex.vals.data_ptr()) // esz
        r0 = (R.data_ptr() - ex.vals.data_ptr()) // esz
        assert np.array_equal(f[:, exec_bucket._LOFF],
                              a0 + b * A.shape[1] * A.shape[2])
        assert np.array_equal(f[:, exec_bucket._ROFF],
                              r0 + b * R.shape[1] * R.shape[2])
        assert (f[:, exec_bucket._LDL] == A.shape[2]).all()
        assert (f[:, exec_bucket._LDR] == R.shape[2]).all()


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
    # the last bucket's views end where the pools end
    A, R, _, oidx = ex.device_buckets[-1]
    assert (R.data_ptr() - v0) // ex.vals.element_size() + R.numel() \
        == ex.vals.numel()
    assert (oidx.data_ptr() - i0) // 4 + oidx.numel() == ex.ints.numel()


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


# ---------------------------------------------------------------------------
# K18 on the chain core: the true items, read in place from the padded
# stacks (exec_bucket.plan_chain_tables), walked with chain_mv.chain_plain
# ---------------------------------------------------------------------------

def _true_items(peff, ex):
    """(a, k, psi offset, n, p, sigma offset) of every triple, and the LW
    and RW blocks it multiplies, straight from the operator."""
    out = []
    for (m, lk, pk, rk, ok) in peff.triples:
        lb, rb = peff.LW[m][lk], peff.RW[m][rk]
        out.append(((lb.shape[0], lb.shape[1], int(peff.offsets[pk]),
                     rb.shape[1], rb.shape[0], int(peff.offsets[ok])),
                    lb, rb))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k18_chunk_walk_matches_reference_execute(l8, dtype):
    """K18's chunk tables walked in the kernel's order (chain_plain reading
    A and R in place from ``vals`` at their buckets' padded row lengths)
    against the JAX _execute_impl on the reference's stacks and against
    K8's plain version (bucket_sigma_plain) on the same center."""
    reff, peff = l8
    ref = RefPlanExecutor(reff, dtype=dtype)
    ex = PlanExecutor(peff, dtype=dtype, device="cpu")
    x = np.random.default_rng(6).standard_normal(ex.size).astype(dtype)
    want = np.asarray(_execute_impl(jnp.asarray(x), ref.device_buckets))
    xp = torch.zeros(ex.size_p + 1, dtype=ex.vals.dtype)
    xp[:ex.size] = torch.as_tensor(x)
    d = ex.k18_tables()
    assert ex.k18_tables() is d                       # built once
    assert d["items"].shape[1] == 10 and d["n_chunks"] > 1
    got = chain_mv.chain_plain(xp, ex.vals, ex.vals, d, ex.size_p + 1)
    assert rel(got[:ex.size].numpy(), want[:ex.size]) < TOL[dtype]
    assert not got[ex.size:].any()                    # nothing past size
    bx = BucketExecutor(peff, dtype=dtype, device="cpu")
    k8 = exec_bucket.bucket_sigma_plain(xp, bx.lpool, bx.rpool, bx._dev,
                                        bx.size_p)
    assert rel(got[:ex.size].numpy(), k8[:ex.size].numpy()) < TOL[dtype]


def test_k18_tables_cover_the_true_items_once(l8):
    """Every triple is one chain item, no padded item is one; each item's
    A and R read in place from ``vals`` at its row lengths are its LW and
    RW blocks; the chunks hold every entry of every item exactly once, in
    sigma-block order, and a chunk writes one piece of one sigma block."""
    _, peff = l8
    ex = PlanExecutor(peff, device="cpu")
    tab = ex.chain_tables()
    it = tab["items"].astype(np.int64)
    true = _true_items(peff, ex)
    assert len(it) == len(true) < sum(b[0].shape[0]
                                      for b in ex.device_buckets)
    assert np.all(np.diff(it[:, exec_bucket._OOFF]) >= 0)
    vals = ex.vals.numpy()
    want = {}
    for key, lb, rb in true:
        want.setdefault(key, []).append((lb, rb))
    for f in it:
        a, k, poff, n, roff, p, ooff, ldl, ldr = (
            f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9])
        A = vals[f[0]:f[0] + (a - 1) * ldl + k]
        A = np.stack([A[r * ldl:r * ldl + k] for r in range(a)])
        R = vals[roff:roff + (p - 1) * ldr + n]
        R = np.stack([R[r * ldr:r * ldr + n] for r in range(p)])
        blocks = want[(a, k, poff, n, p, ooff)]
        hit = [i for i, (lb, rb) in enumerate(blocks)
               if np.array_equal(lb, A) and np.array_equal(rb, R)]
        assert hit, "an item that is no triple"
        blocks.pop(hit[0])
        assert (ldl, ldr) in {(A_.shape[2], R_.shape[2])
                              for A_, R_, _, _ in ex.device_buckets}
    assert not any(want.values())                     # every triple once
    e = chain_mv.entries(it[:, :8])
    ent = tab["ent"].astype(np.int64)
    seen = np.zeros((len(it), int(e["ni"].max()) + 1, int(e["ar"].max()) + 1,
                     int(e["pi"].max()) + 1), np.int64)
    for e0, e1, ar, pi in tab["ck"].astype(np.int64):
        f0 = it[ent[e0, 0]]
        for item, ni in ent[e0:e1]:
            assert it[item, exec_bucket._OOFF] == f0[exec_bucket._OOFF]
            seen[item, ni, ar, pi] += 1
    assert seen.sum() == len(e["item"]) and seen.max() == 1
    assert tab["flops"] == int(e["flops"].sum())


@pytest.mark.parametrize("col,what", [
    (exec_bucket._LOFF, "an A block of the value pool"),
    (exec_bucket._ROFF, "an R block of the value pool"),
    (exec_bucket._POFF, "a psi block"),
    (exec_bucket._OOFF, "a sigma block")])
def test_k18_tables_refuse_int32_overflow(l8, col, what):
    """An offset that would take a block past 2^31 elements raises and
    names it, instead of wrapping in the kernel's int32 fields."""
    _, peff = l8
    ex = PlanExecutor(peff, device="cpu")
    items = ex.items.copy()
    items[-1, col] = 2 ** 31 - 2
    with pytest.raises(ValueError, match=what):
        exec_bucket.plan_chain_tables(items)
    exec_bucket.plan_chain_tables(ex.items)          # the real ones pass


# ---------------------------------------------------------------------------
# K22: one rank's share of K18's items (PlanExecutor.rank_part)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3])
def test_k22_rank_items_partition_the_true_items(l8, world):
    """The ranks' item rows partition ``items``: every true item in exactly
    one rank, the one whose contiguous slice of ``ceil(B / world)`` batch
    items of its bucket holds it; each rank's tables are K18's tables of
    its rows (sorted by sigma block, every entry once, cut at K18's FLOP
    band), built once."""
    _, peff = l8
    ex = PlanExecutor(peff, device="cpu")
    seen = np.zeros(len(ex.items), np.int64)
    for r in range(world):
        part = ex.rank_part(r, world)
        assert ex.rank_part(r, world) is part              # built once
        rows = part["rows"]
        seen[rows] += 1
        for i in rows:
            bi, b = ex.slots[i]
            per = -(-ex.device_buckets[bi][0].shape[0] // world)
            assert b // per == r
            assert part["slices"][bi][0] <= b < part["slices"][bi][1]
        tab = part["tables"]
        band = ex.chain_tables()["flops"] / chain_mv.TARGET_CHUNKS
        want = exec_bucket.plan_chain_tables(ex.items[rows], band)
        for k in ("items", "ent", "ck"):
            assert np.array_equal(tab[k], want[k])
        assert np.array_equal(part["chain"]["items"].numpy(), tab["items"])
        assert part["chain"]["n_chunks"] == len(tab["ck"])
        if len(rows):
            e = chain_mv.entries(tab["items"][:, :8])
            ent = tab["ent"].astype(np.int64)
            assert len(ent) == len(e["item"])
            assert tab["flops"] == int(e["flops"].sum())
    assert (seen == 1).all()
    if world > 1:                       # the split is exercised
        assert len(ex.rank_part(1, world)["rows"]) > 0
    with pytest.raises(ValueError, match="outside a world"):
        ex.rank_part(world, world)
