"""The port's bucketed engines against the JAX package's on the same state:
``ops/exec_bucket.py`` (kernel K8) against ``FusedPlanExecutor``
(exec_jax.py) and ``ops/blocking_device.py`` (kernel K9) against
``execute_plan_jax`` (blocking_jax.py), at a Hubbard-L8 and a K=8
quantum-chemistry center built in code: the bucket struct field by field,
the plain versions of K8 and K9 against the JAX kernels (f64 to 1e-12 and
f32 to 1e-5 relative to the largest entry), the kernels' own walks
against the plain versions and the JAX kernel (K8: its items sorted by
sigma block and cut into chunks, ops/chain_mv.py, walked chunk by chunk;
K9: its output groups, (bra, ket) sub-groups with their env blocks summed
first, pieces and chunks, walked in numpy), the device Davidson around
K8 against the JAX ``_dav_jit``, and the wrappers' device and type
checks."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian2 as RefEff
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
from block2_preview_tpu.ops.blocking_jax import execute_plan_jax
from block2_preview_tpu.ops.blocking_plan import build_plan as ref_build_plan
from block2_preview_tpu.ops.exec_jax import FusedPlanExecutor

import chip_smoke
from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.effective import (
    EffectiveHamiltonian2 as PortEff)
from block2_preview_tpu_torch.dmrg.environment import (
    MovingEnvironment as PortME)
from block2_preview_tpu_torch.ops import _kernels, blocking_device
from block2_preview_tpu_torch.ops import chain_mv, exec_bucket
from block2_preview_tpu_torch.ops.blocking_plan import (build_plan,
                                                        execute_plan_numpy)
from block2_preview_tpu_torch.ops.exec_bucket import (BucketExecutor,
                                                      _round_batch,
                                                      reference_struct)

from test_torch_plans import hubbard_driver
from test_torch_tilev2 import check_chunks

CPU = torch.device("cpu")
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def qc_driver(n_orb=8):
    h1e, g2e = chip_smoke.seeded_qc_integrals(n_orb)
    drv = RefDriver()
    drv.initialize_system(n_sites=n_orb, n_elec=n_orb, spin=0)
    return drv, drv.get_qc_mpo(h1e=h1e, g2e=g2e, ecore=0.0)


def _state(kind):
    """(reference MPO, reference MPS after two host sweeps, center)."""
    drv, mpo = hubbard_driver() if kind == "hubbard" else qc_driver()
    mps = drv.get_random_mps(60 if kind == "hubbard" else 40, seed=5)
    RefDMRG(mpo, mps, backend="numpy", iprint=0).solve(
        [mps.info.bond_dim], [1e-4], [1e-8], n_sweeps=2, tol=0)
    return mpo, mps, 3


@pytest.fixture(scope="module", params=["hubbard", "qc"])
def site(request):
    """Host environments of both packages around the center, and both
    packages' two-site operators there."""
    mpo, mps, t = _state(request.param)
    d = RefDMRG(mpo, mps, backend="numpy", iprint=0)
    for s in range(t):
        d.me.update_left(s)
    pme = PortME(interop.mpo(mpo), interop.mps(mps))
    for s in range(mpo.n_sites - 1, t + 1, -1):
        pme.update_right(s)
    for s in range(t):
        pme.update_left(s)
    return request.param, mpo, mps, t, d.me, pme, RefEff(d.me, t), \
        PortEff(pme, t)


def _ref_struct(reff, dtype=np.float64):
    cache = {}
    rx = FusedPlanExecutor(reff, dtype=dtype, cache=cache, cache_key=1)
    return rx, interop.bucket_struct(cache[1][1])


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_struct_matches_reference(site):
    """Every field of the reference struct, rebuilt from the port's
    compact items; the bucket order, and a padded batch somewhere."""
    *_, reff, peff = site
    _, ref = _ref_struct(reff)
    ex = BucketExecutor(peff, device=CPU)
    got = reference_struct(ex.struct)
    assert len(got["buckets"]) == len(ref["buckets"]) > 1
    for b_got, b_ref in zip(got["buckets"], ref["buckets"]):
        assert sorted(b_got) == sorted(b_ref)
        for k in b_ref:
            assert b_got[k].dtype == b_ref[k].dtype, k
            assert np.array_equal(b_got[k], b_ref[k]), k
    for k in ("perm", "seg_ids", "mask"):
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
    n = np.diff(ex.struct["bounds"])
    assert any(_round_batch(int(c)) > c for c in n)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_matches_fused_sigma(site, dtype):
    """K8's plain version against the JAX _fused_sigma (through
    FusedPlanExecutor.matvec_device) on the same padded vector."""
    *_, reff, peff = site
    rx = FusedPlanExecutor(reff, dtype=dtype)
    ex = BucketExecutor(peff, dtype=dtype, device=CPU)
    assert ex.size_p == rx.size_p
    xh = ex.pad(np.random.RandomState(3).standard_normal(peff.size))
    ref = np.asarray(rx.matvec_device(jnp.asarray(xh)))
    got = ex.matvec_device(torch.as_tensor(xh)).numpy()
    assert got.dtype == dtype and got.shape == (ex.size_p,)
    assert ref[ex.size_p] == 0 and not got[peff.size:].any()
    assert rel(got, ref[:ex.size_p]) < TOL[dtype]
    assert rel(ex.matvec(xh[:peff.size]),
               peff.matvec_np(xh[:peff.size])) < TOL[dtype]


def test_k8_tables_reproduce_the_matvec(site):
    """K8's tables: the items sorted by sigma block (stable), every
    entry of every triple in exactly one chunk, a chunk within one sigma
    piece; walked as the kernel walks them, they give the plain matvec."""
    *_, peff = site
    ex = BucketExecutor(peff, device=CPU)
    d = exec_bucket.kernel_tables(ex.struct, CPU)
    it = d["items"].numpy().astype(np.int64)
    assert d["items"].dtype == d["ent"].dtype == d["ck"].dtype == torch.int32
    assert len(it) == len(peff.triples) and d["seconds"] >= 0
    order = np.argsort(ex.struct["items"][:, 7], kind="stable")
    assert np.array_equal(it, ex.struct["items"][order])
    tab = {"ent": d["ent"].numpy(), "ck": d["ck"].numpy()}
    fl = chain_mv.entries(it)["flops"]
    check_chunks(it, tab, max(fl.sum() / chain_mv.TARGET_CHUNKS, 1.0))
    assert d["n_chunks"] == len(tab["ck"])
    xh = torch.as_tensor(ex.pad(np.random.RandomState(4).standard_normal(
        peff.size)))
    got = chain_mv.chain_plain(xh, ex.lpool, ex.rpool, d,
                               ex.size_p + 1).numpy()
    ref = ex.matvec_device(xh).numpy()
    assert not got[peff.size:].any()
    assert rel(got[:ex.size_p], ref) < 1e-12


@pytest.mark.parametrize("cap", [None, 1.0, 1e18])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k8_chunk_walk_matches_fused_sigma(site, dtype, cap):
    """K8's sorted items cut into chunks under the default FLOP cap, one
    entry a chunk (cap 1) and whole sigma pieces (a cap no chunk reaches),
    walked chunk by chunk in ``dtype``, against the JAX _fused_sigma
    (FusedPlanExecutor.matvec_device); items span several 8-row
    fragments."""
    *_, reff, peff = site
    rx = FusedPlanExecutor(reff, dtype=dtype)
    ex = BucketExecutor(peff, dtype=dtype, device=CPU)
    it = ex.struct["items"]
    it = it[np.argsort(it[:, 7], kind="stable")]
    assert (it[:, 1] > 8).any() and (it[:, 6] > 8).any()
    tab = chain_mv.chunk_tables(it, cap=cap)
    if cap is not None:
        check_chunks(it, tab, cap)
    d = chain_mv.device_tables(it, tab, CPU)
    xh = ex.pad(np.random.RandomState(7).standard_normal(peff.size))
    ref = np.asarray(rx.matvec_device(jnp.asarray(xh)))
    got = chain_mv.chain_plain(torch.as_tensor(xh), ex.lpool, ex.rpool, d,
                               ex.size_p + 1).numpy()
    assert got.dtype == dtype
    assert rel(got[:ex.size_p], ref[:ex.size_p]) < TOL[dtype]


def _plans(site, direction):
    """The blocking step next to the center in ``direction``: the
    reference plan on the reference environments, and the port's own plan
    on the port's; with the step's env / bra / ket and output charges."""
    _, mpo, mps, t, rme, pme, *_ = site
    g = mpo.group
    if direction == "left":
        env, penv = rme.left_envs[t], pme.left_envs[t]
        dq_out = mpo.bond_dqs[t + 1]
    else:
        t += 2
        env, penv = rme.right_envs[t + 1], pme.right_envs[t + 1]
        dq_out = [g.sub(mpo.bond_dqs[-1][0], dq) for dq in mpo.bond_dqs[t]]
    args = (mpo.tensors[t], mpo.site_quanta[t], mps.tensors[t],
            mps.tensors[t])
    ref_plan = ref_build_plan(env, *args, dq_out, g, direction)
    pmpo, pmps = interop.mpo(mpo), interop.mps(mps)
    port_plan = build_plan(penv, pmpo.tensors[t], pmpo.site_quanta[t],
                           pmps.tensors[t], pmps.tensors[t], dq_out,
                           pmpo.group, direction)
    return ref_plan, port_plan, env, penv, mps.tensors[t], pmps.tensors[t]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_plain_matches_execute_plan_jax(site, direction, dtype):
    """K9's plain version on the reference's plan (carried over by
    interop.blocking_plan) and on the port's own plan, against the JAX
    execute_plan_jax and the port's execute_plan_numpy, block by block."""
    ref_plan, port_plan, env, penv, T, pT = _plans(site, direction)
    g = interop.group(site[1].group)
    ref = execute_plan_jax(ref_plan, env, T, T, site[1].group, dtype=dtype)
    host = execute_plan_numpy(port_plan, penv, pT, pT, g)
    for plan, e, bt in ((interop.blocking_plan(ref_plan), env, T),
                        (port_plan, penv, pT)):
        moved = {"uploads": 0, "downloads": 0, "bytes_up": 0,
                 "bytes_down": 0}
        got = blocking_device.execute_plan_device(
            plan, e, bt, bt, g, dtype=dtype, device="cpu", transfers=moved)
        assert moved["uploads"] > 3 and moved["downloads"] == 1
        assert sorted(got) == sorted(ref) == sorted(host)
        for sym in ref:
            assert sorted(got[sym].blocks) == sorted(ref[sym].blocks)
            scale = max(np.abs(b).max() for b in ref[sym].blocks.values())
            for k, b in ref[sym].blocks.items():
                assert got[sym].blocks[k].dtype == dtype
                assert np.abs(got[sym].blocks[k] - b).max() \
                    <= TOL[dtype] * max(scale, 1e-300), (sym, k)
                assert np.abs(got[sym].blocks[k]
                              - host[sym].blocks[k]).max() \
                    <= TOL[dtype] * max(scale, 1e-300), (sym, k)


def k9_walk(plan, pools, left, dtype):
    """K9's tables walked in the kernel's order, in numpy and ``dtype``:
    chunk by chunk (one piece of one output block), each sub-group's Ebar
    = sum of coef E over its contributions, then MB^T Ebar MK (left) or MB
    Ebar MK^T (right) on the piece, the piece added into a flat output
    [total_out + 1]."""
    tab = blocking_device.k9_tables(plan)
    ep, bp, kp = (np.asarray(p, dtype) for p in pools)
    cc = tab["cc"].astype(dtype)
    ce = tab["ce"].astype(np.int64)
    out = np.zeros(plan.total_out + 1, dtype)
    P = blocking_device.PIECE
    for s0, s1, ooff, dx, dy, x0, y0, _ in tab["ck"].astype(np.int64):
        acc = np.zeros((min(P, dx - x0), min(P, dy - y0)), dtype)
        for c0, c1, boff, koff, dl, dk in tab["sg"][s0:s1].astype(np.int64):
            eb = np.zeros((dl, dk), dtype)
            for c in range(c0, c1):
                eb += cc[c] * ep[ce[c]:ce[c] + dl * dk].reshape(dl, dk)
            mb = bp[boff:boff + dl * dx]
            mb = mb.reshape(dl, dx) if left else mb.reshape(dx, dl).T
            mk = kp[koff:koff + dk * dy]
            mk = mk.reshape(dk, dy) if left else mk.reshape(dy, dk).T
            acc += (mb.T[x0:x0 + acc.shape[0]]
                    @ (eb @ mk[:, y0:y0 + acc.shape[1]]))
        o = out[ooff:ooff + dx * dy].reshape(dx, dy)
        o[x0:x0 + acc.shape[0], y0:y0 + acc.shape[1]] += acc
    return out


def check_k9_tables(plan):
    """Every contribution lies in exactly one sub-group, in the plan's
    output-group order; a sub-group's contributions share their output
    block, bra and ket blocks (so one shape); the chunks of one piece of
    an output block tile that block's sub-groups exactly, every piece of
    every block is covered, and a chunk is atomic exactly where its piece
    spans chunks.  Returns the tables."""
    nat = plan.native
    tab = blocking_device.k9_tables(plan)
    n = len(nat["dl"])
    order = blocking_device.k9_order(plan)
    assert np.array_equal(np.sort(order), np.arange(n))
    assert "order" not in tab
    for k in ("ce", "sg", "ck"):
        assert tab[k].dtype == np.int32, k
    assert np.array_equal(tab["ce"], nat["eoff"][order])
    assert np.array_equal(tab["cc"], nat["coefs"][order])
    sg = tab["sg"].astype(np.int64)
    assert sg[0, 0] == 0 and sg[-1, 1] == n
    assert np.array_equal(sg[1:, 0], sg[:-1, 1])
    assert (sg[:, 1] > sg[:, 0]).all()
    grp = np.repeat(np.arange(len(nat["grp_starts"]) - 1),
                    np.diff(nat["grp_starts"]))
    sub = np.repeat(np.arange(len(sg)), sg[:, 1] - sg[:, 0])
    for key, want in (("out_off", None), ("boff", 2), ("koff", 3),
                      ("dl", 4), ("dk", 5)):
        v = np.asarray(nat[key])[order]
        first = v[sg[:, 0]]
        assert np.array_equal(v, first[sub]), key
        if want is not None:
            assert np.array_equal(first, sg[:, want]), key
    assert (np.diff(grp[order]) >= 0).all()
    pieces = {}
    for s0, s1, ooff, dx, dy, x0, y0, atom in tab["ck"].astype(np.int64):
        pieces.setdefault((ooff, x0, y0), []).append((s0, s1, atom, dx, dy))
    blocks = {}
    for g in range(len(nat["grp_starts"]) - 1):
        a, b = nat["grp_starts"][g], nat["grp_starts"][g + 1]
        subs = np.unique(sub[np.flatnonzero((grp[order] == g))])
        blocks[int(nat["out_off"][a])] = (subs.min(), subs.max() + 1,
                                          int(nat["dx"][a]),
                                          int(nat["dy"][a]))
        assert b > a
    P = blocking_device.PIECE
    want = {(o, x0, y0) for o, (_, _, dx, dy) in blocks.items()
            for x0 in range(0, dx, P) for y0 in range(0, dy, P)}
    assert set(pieces) == want
    for (ooff, x0, y0), chunks in pieces.items():
        lo, hi, dx, dy = blocks[ooff]
        spans = sorted((s0, s1) for s0, s1, *_ in chunks)
        assert spans[0][0] == lo and spans[-1][1] == hi
        assert all(b0 == a1 for (_, a1), (b0, _) in zip(spans, spans[1:]))
        assert all(atom == (len(chunks) > 1) for _, _, atom, *_ in chunks)
        assert all((cdx, cdy) == (dx, dy) for *_, cdx, cdy in chunks)
    return tab


def _blocks_of(plan, flat):
    """{(sym, qb, qk): block} of a flat blocking output."""
    return {(sym, qb, qk): flat[plan.out_offs[u]:plan.out_offs[u + 1]]
            .reshape(d1, d2)
            for u, (sym, qb, qk, d1, d2) in enumerate(plan.out_meta)}


@pytest.mark.parametrize("direction", ["left", "right"])
def test_k9_tables_reproduce_the_blocking(site, direction):
    """K9's tables (output groups, (bra, ket) sub-groups, pieces, chunks)
    cover every contribution once, and walked as the kernel walks them
    they give the plain version's blocking, under the default FLOP cap
    and cut fine (every sub-group its own chunk, 4 x 4 pieces: atomics
    and blocks of several pieces)."""
    _, port_plan, _, penv, _, pT = _plans(site, direction)
    left = direction == "left"
    from block2_preview_tpu_torch.ops.blocking_plan import _pools
    pools = _pools(port_plan, penv, pT, pT, np.float64)
    out = torch.zeros(port_plan.total_out + 1, dtype=torch.float64)
    ref = blocking_device.bucket_blocking(
        *(torch.as_tensor(p) for p in pools),
        blocking_device.plain_tables(port_plan, CPU, torch.float64), left,
        out).numpy()
    tab = check_k9_tables(port_plan)
    assert len(tab["sg"]) < len(port_plan.native["dl"])   # sums E first
    assert rel(k9_walk(port_plan, pools, left, np.float64), ref) < 1e-12
    d = blocking_device.kernel_tables(port_plan, CPU, torch.float64)
    assert d["n_chunks"] == len(tab["ck"]) and d["cc"].dtype == torch.float64
    n_ck = []
    for piece, target in ((blocking_device.PIECE, 1), (4, 1 << 40)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(blocking_device, "PIECE", piece)
            mp.setattr(blocking_device, "TARGET_CHUNKS", target)
            port_plan.native.pop("k9")
            cut = check_k9_tables(port_plan)
            # one chunk a piece (no atomics), or one a sub-group and piece
            assert cut["ck"][:, 7].any() == (target > 1)
            n_ck.append(len(cut["ck"]))
            assert rel(k9_walk(port_plan, pools, left, np.float64),
                       ref) < 1e-12
    assert n_ck[0] <= len(tab["ck"]) < n_ck[1]
    port_plan.native.pop("k9")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_k9_walk_matches_execute_plan_jax(site, direction, dtype):
    """K9's tables walked in the kernel's order in ``dtype`` (groups ->
    (bra, ket) sub-groups -> Ebar -> chain) against the JAX
    execute_plan_jax (the reference's _blk_exec) on the same step, block
    by block: f64 to 1e-12, f32 to 1e-5 relative to the largest entry."""
    ref_plan, port_plan, env, penv, T, pT = _plans(site, direction)
    from block2_preview_tpu_torch.ops.blocking_plan import _pools
    ref = execute_plan_jax(ref_plan, env, T, T, site[1].group, dtype=dtype)
    pools = _pools(port_plan, penv, pT, pT, np.dtype(dtype))
    got = _blocks_of(port_plan, k9_walk(port_plan, pools,
                                        direction == "left", dtype))
    assert len(got) == sum(len(bm.blocks) for bm in ref.values())
    scale = max(np.abs(b).max() for bm in ref.values()
                for b in bm.blocks.values())
    for sym, bm in ref.items():
        for (qb, qk), b in bm.blocks.items():
            g = got[(sym, qb, qk)]
            assert g.dtype == dtype
            assert np.abs(g - b).max() <= TOL[dtype] * scale, (sym, qb, qk)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_device_davidson_matches_dav_jit(site, dtype, tol):
    """The port's device Davidson around K8's plain version against the
    JAX _dav_jit at one center whose spectrum lies below zero: the port's
    Davidson stops before growing its subspace (ROADMAP queue C), the
    reference's appends one more vector, which gives a spurious Ritz value
    only when the spectrum lies above zero."""
    *_, reff, peff = site
    x0 = peff.flatten(peff.initial_guess())
    x0 /= np.linalg.norm(x0)
    diag = peff.diagonal()
    thrd = 1e-12 if dtype == np.float64 else 1e-8
    th_ref, _, _ = FusedPlanExecutor(reff, dtype=dtype).solve_ground_state(
        x0, diag, conv_thrd=thrd, max_iter=100)
    th, xv, it = BucketExecutor(peff, dtype=dtype, device=CPU) \
        .solve_ground_state(x0, diag, conv_thrd=thrd, max_iter=100)
    assert th < 0 and th_ref < 0
    assert abs(th - th_ref) < tol, (th, th_ref)
    assert it > 0 and abs(np.linalg.norm(xv) - 1.0) < 1e-6


def test_wrappers_take_the_twin_on_cpu_and_check_inputs(site):
    """A CPU tensor runs the plain version and launches nothing; a wrong
    shape or a complex effective Hamiltonian raises."""
    *_, peff = site
    _kernels.reset_counts()
    ex = BucketExecutor(peff, device=CPU)
    y = ex.matvec(np.ones(peff.size))
    assert y.dtype == np.float64 and np.isfinite(y).all()
    assert _kernels.launch_counts()["K8_bucket"] == 0
    with pytest.raises(ValueError, match="expected"):
        exec_bucket.bucket_sigma(torch.zeros(ex.size_p), ex.lpool, ex.rpool,
                                 ex._dev, ex.size_p)
    with pytest.raises(TypeError, match="torch_tiled"):
        BucketExecutor(SimpleNamespace(dtype=np.complex128), device=CPU)
    with pytest.raises(TypeError, match="same_kind"):
        exec_bucket.pack_pool([np.ones((2, 2), complex)], np.float64, CPU)
