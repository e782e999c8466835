"""Kernel K1 (sigma matvec) of the port: its plain twin — what the wrapper
runs on CPU tensors — against the reference's MatvecV2.matvec_device
(JAX) on the same reference-built plan, f64, relative error < 1e-12;
including the multi-group case forced by tiny budgets.  K1's chunk tables
(ops/chain_mv.py, what the kernel walks): every entry of every live item
exactly once, a chunk within one sigma piece, and their plain walk
against the JAX matvec (f64 1e-12, f32 1e-5).  The launch path's checks,
the device check among them, before the library loads."""

import numpy as np
import pytest
import torch

import block2_preview_tpu.ops.tilev2 as ref_tv2
from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix

import block2_preview_tpu_torch.ops.tilev2 as tv2
from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops import chain_mv

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
    port = tv2.MatvecV2(site.peff.ket_space,
                        interop.stacked_meta(pl.meta_out),
                        interop.stacked_meta(pr.meta_out), site.pmpo.group,
                        site.peff.target, dtype=np.float64, T=16,
                        bra_space=site.peff.bra_space)
    for k in ("it", "cum1", "cum2", "g1", "g2"):
        assert np.array_equal(port.struct[k], ref_ex.struct[k]), k


def test_matvec_twin_matches_host_operator(system):
    """Port builder + port twin against the host effective Hamiltonian
    (the assembled LW/RW of EffectiveHamiltonian2.matvec_np)."""
    site = Site(*system, SITES[1])
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    eff, peff = site.eff, site.peff
    ex = tv2.MatvecV2(peff.ket_space, interop.stacked_meta(pl.meta_out),
                      interop.stacked_meta(pr.meta_out), site.pmpo.group,
                      peff.target, dtype=np.float64,
                      bra_space=peff.bra_space)
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


class _SeenAsCuda(torch.Tensor):
    """A CPU tensor that reports itself on CUDA, to reach the launch
    path's type check without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("bad,err,match", [
    (torch.zeros(4, dtype=torch.float64), ValueError,
     "contiguous CUDA"),                            # on the CPU
    (torch.zeros(4, 2, dtype=torch.float64).t(), ValueError,
     "contiguous CUDA"),                            # not contiguous
    (torch.zeros(4, dtype=torch.float32).as_subclass(_SeenAsCuda),
     TypeError, "dtype torch.float32"),             # wrongly typed
])
def test_kernel_call_refuses_bad_tensors(bad, err, match):
    """Every kernel call validates its tensors before the library is
    built or loaded, and before the cached function table or the stream
    is read: a CPU, non-contiguous or wrongly typed tensor never reaches
    a kernel as a pointer."""
    from block2_preview_tpu_torch.ops import _kernels
    with pytest.raises(err, match=match):
        _kernels.call("b2t_gather", torch.float64, bad, 4)
    assert _kernels._lib is None and not _kernels._fns


def test_kernel_call_refuses_missing_instance():
    """An entry called in a type it has no instance of raises before the
    library loads, and nothing enters the cached function table."""
    from block2_preview_tpu_torch.ops import _kernels
    with pytest.raises(TypeError, match="no torch.float64 instance"):
        _kernels.call("b2t_probe_dot", torch.float64, 4)
    assert _kernels._lib is None and not _kernels._fns


class _OnAnotherCard(torch.Tensor):
    """A CPU tensor that reports itself on CUDA device 1, to reach the
    launch path's device check without a card."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 1


def test_kernel_call_refuses_a_tensor_on_another_card(monkeypatch):
    """A tensor on a CUDA device other than the current one is refused
    before the library loads, the function table is filled or the stream
    is read: the kernels launch on the current device, and a pointer of
    another card must never reach them.  The current device is read once
    a call."""
    from block2_preview_tpu_torch.ops import _kernels
    reads = []
    monkeypatch.setattr(_kernels, "current_device",
                        lambda: reads.append(0) or 0)
    monkeypatch.setattr(_kernels, "current_stream_handle", None)
    ok = torch.zeros(4, dtype=torch.float64).as_subclass(_SeenAsCuda)
    monkeypatch.setattr(_SeenAsCuda, "get_device", lambda self: 0,
                        raising=False)
    bad = torch.zeros(4, dtype=torch.float64).as_subclass(_OnAnotherCard)
    with pytest.raises(ValueError, match="cuda:1 but the current CUDA "
                                         "device is cuda:0"):
        _kernels.call("b2t_gather", torch.float64, ok, ok, 4, bad)
    assert reads == [0]
    assert _kernels._lib is None and not _kernels._fns


def check_chunks(items, tab, cap):
    """``tab`` (chain_mv.chunk_tables of ``items`` under FLOP cap ``cap``)
    holds every entry (item, ar, pi, ni) of the items
    exactly once; the chunks' entry ranges tile the entry list; a chunk's
    entries write one sigma piece (one ooff, the chunk's ar and pi), hold at
    most MAX_ENT entries, and those before the last less than ``cap``
    FLOPs; chunks come in decreasing FLOPs.  Returns the chunks' entries."""
    it = np.asarray(items, np.int64)
    e = chain_mv.entries(it)
    fl = {(i, a, p, n): f for i, a, p, n, f in zip(
        e["item"], e["ar"], e["pi"], e["ni"], e["flops"])}
    ent = tab["ent"].astype(np.int64)
    ck = tab["ck"].astype(np.int64)
    assert tab["ent"].dtype == tab["ck"].dtype == np.int32
    spans = sorted((int(a), int(b)) for a, b in ck[:, :2])
    assert spans[0][0] == 0 and spans[-1][1] == len(ent)
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    got, cfl = [], []
    for e0, e1, ar, pi in ck:
        assert 0 < e1 - e0 <= chain_mv.MAX_ENT
        rows = ent[e0:e1]
        assert len(set(it[rows[:, 0], chain_mv.OOFF])) == 1
        keys = [(i, ar, pi, n) for i, n in rows]
        got += keys
        cfl.append(sum(fl[k] for k in keys))
        assert cfl[-1] - fl[keys[-1]] < cap
    assert sorted(got) == sorted(fl)
    assert all(a >= b for a, b in zip(cfl, cfl[1:]))
    return got


def _walk(ex, xp, lw, rw, h, cap, dtype):
    """The plain walk of chunk tables of K1's items built under ``cap``,
    in ``dtype``; checks the tables' cover first."""
    tab = chain_mv.chunk_tables(h["items"], cap=cap)
    check_chunks(h["items"], tab, tab["flops"] / chain_mv.TARGET_CHUNKS
                 if cap is None else cap)
    d = chain_mv.device_tables(h["items"], tab, "cpu")
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return chain_mv.chain_plain(
        torch.as_tensor(xp, dtype=tdt), interop.slab_pool(lw, "cpu").to(tdt),
        interop.slab_pool(rw, "cpu").to(tdt), d,
        ex.struct["sig_idx"].shape[0]).numpy()


@pytest.mark.parametrize("cap", [None, 1.0, 1e18])
@pytest.mark.parametrize("T", [16, 32, 64, 128])
def test_k1_chunk_walk_matches_jax(system, T, cap):
    """K1's items (from plans of every tile size) and chunk tables (cut
    for the core's tile, 64, whatever the plan's), walked as the kernel
    walks them, against the reference's matvec (JAX) in f64 and f32: the
    default FLOP cap, one entry a chunk (cap 1) and whole sigma pieces (a
    cap no chunk reaches, MAX_ENT entries at most).  Items span several
    8-row fragments."""
    import jax.numpy as jnp
    site = Site(*system, SITES[1])
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    ref_ex = site.ref_matvec(pl, pr, T=T)
    ex = interop.matvec_v2(ref_ex)
    h = tv2.k1_host(ex.struct)
    assert len(h["items"]) == len(h["live"]) > 0
    xp = ex.pad(np.random.RandomState(T).standard_normal(ex.size))
    ref = np.asarray(ref_ex.matvec_device(jnp.asarray(xp), jnp.asarray(lw),
                                          jnp.asarray(rw)))
    scale = np.abs(ref).max()
    it = h["items"]
    assert (it[:, chain_mv.A] > 8).any() and (it[:, chain_mv.P] > 8).any()
    for dtype, tol in ((np.float64, TOL), (np.float32, 1e-5)):
        got = _walk(ex, xp, lw, rw, h, cap, dtype)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= tol * scale


def test_k1_items_are_the_plans_live_items(system):
    """k1_items: one row a live item of the plan, its LW/RW offsets and
    dims from ``it``, the flat psi and sigma offsets of its sectors (the
    flat index that psi_idx / sig_idx send to the sector's first tile
    element), the device tables K1 reads; built once per struct."""
    site = Site(*system, SITES[1])
    pools = _ref_pools(site)
    (pl, _), (pr, _) = pools["lw"], pools["rw"]
    ex = interop.matvec_v2(site.ref_matvec(pl, pr, T=16))
    s = ex.struct
    it = s["it"].astype(np.int64)
    h = tv2.k1_host(s)
    assert tv2.k1_host(s) is h and h["seconds"] >= 0
    n = int(np.count_nonzero(np.diff(s["cum1"]) > 0))
    assert np.array_equal(h["live"], np.arange(n))
    f, got = it[:n], h["items"]
    for col, want in ((0, f[:, 0]), (1, f[:, 2]), (2, f[:, 1]),
                      (4, f[:, 4]), (5, f[:, 3]), (6, f[:, 5])):
        assert np.array_equal(got[:, col], want), col
    sp, bs = site.peff.ket_space, site.peff.bra_space
    T = s["T"]

    def offs(space):
        base, out = 0, {}
        for k in space.keys:
            r, c = space.shapes[k]
            out[base] = space.offsets[k]
            base += -(-r // T) * -(-c // T)
        return out

    po, so = offs(sp), offs(bs)
    assert [po[b] for b in f[:, 6]] == list(got[:, 3])
    assert [so[b] for b in f[:, 7]] == list(got[:, 7])
    d = ex.to_device("cpu")["chain"]
    assert d["items"].dtype == torch.int32 and d["n_chunks"] > 0
    assert np.array_equal(d["items"].numpy(), got)
    # the chunks are cut for the core's tile, not the plan's
    check_chunks(got, h, max(chain_mv.entries(got)["flops"].sum()
                             / chain_mv.TARGET_CHUNKS, 1.0))


def test_chunk_tables_of_no_items_and_of_one_piece():
    """A rank that owns no item gets empty tables (K20 then launches
    nothing); entries of one sigma piece are cut at MAX_ENT entries and at
    the FLOP bands of the cap, in segment order, and the chunks come
    largest first."""
    t = chain_mv.chunk_tables(np.zeros((0, 8), np.int64))
    assert t["ent"].shape == (0, 2) and t["ck"].shape == (0, 4)
    n = chain_mv.MAX_ENT + 3
    items = np.tile([0, 8, 4, 0, 8, 0, 8, 100], (n, 1))
    t = chain_mv.chunk_tables(items, cap=1e18)
    assert t["ck"].tolist() == [[0, chain_mv.MAX_ENT, 0, 0],
                                [chain_mv.MAX_ENT, n, 0, 0]]
    assert t["ent"][:, 0].tolist() == list(range(n))
    f = int(chain_mv.entries(items[:1])["flops"][0])
    t = chain_mv.chunk_tables(items[:5], cap=2 * f)
    assert [e1 - e0 for e0, e1, _, _ in t["ck"]] == [2, 2, 1]
    check_chunks(items[:5], t, 2 * f)


def _walk_against_jax(site, ref_ex, lw, rw, seed):
    """K1's chunk tables of ``ref_ex``'s plan (the core's tile), walked,
    against its JAX matvec in f64 and f32."""
    import jax.numpy as jnp
    ex = interop.matvec_v2(ref_ex)
    h = tv2.k1_host(ex.struct)
    xp = ex.pad(np.random.RandomState(seed).standard_normal(ex.size))
    ref = np.asarray(ref_ex.matvec_device(jnp.asarray(xp), jnp.asarray(lw),
                                          jnp.asarray(rw)))
    for dtype, tol in ((np.float64, TOL), (np.float32, 1e-5)):
        got = _walk(ex, xp, lw, rw, h, None, dtype)
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_k1_chunk_walk_matches_jax_on_a_qc_site():
    """The walk of K1's tables against the JAX matvec at the K=8 QC
    center of test_torch_bucket (a dense QC MPO, a two-sweep host state),
    where sectors of one item span several 8-row fragments."""
    from test_torch_bucket import _state
    mpo, mps, t = _state("qc")
    site = Site(mpo, mps, t)
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    ref_ex = site.ref_matvec(pl, pr)
    assert (tv2.k1_items(interop.matvec_v2(ref_ex).struct)[:, 1] > 8).any()
    _walk_against_jax(site, ref_ex, lw, rw, seed=21)


def test_k1_chunk_walk_matches_jax_on_a_multigroup_plan(monkeypatch):
    """A plan that tiny stage budgets split into many task groups: K1's
    tables ignore the groups (one launch covers all), and their walk
    still equals the reference's group-by-group matvec."""
    site = Site(*hubbard_system(D=24), SITES[1])
    pools = _ref_pools(site)
    (pl, lw), (pr, rw) = pools["lw"], pools["rw"]
    f = site.ref_matvec(pl, pr, T=16).struct["it"].astype(np.int64)
    na, nk, npp, nn = f[:, 8], f[:, 9], f[:, 10], f[:, 11]
    cfg = (int(max((na * nn * nk).max(), (na * nn * npp).max())),
           max(int((na * nn).max()), 1))
    monkeypatch.setitem(ref_tv2._CFG, 16, cfg)
    ref_ex = site.ref_matvec(pl, pr, T=16)
    assert ref_ex.struct["ng_live"] > 2
    _walk_against_jax(site, ref_ex, lw, rw, seed=22)
