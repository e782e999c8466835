"""Kernels K3 (mix GEMM) and K4 (window place) of the port: their plain
twins — what execute_mix_v4 runs on CPU tensors — against the
reference's execute_mix_v4 (JAX) on the same reference-built plan, for
the LW and RW pools (f64: atol 1e-12 relative to the pool scale; f32:
1e-5), and against the host assembly of EffectiveHamiltonian2.  K4
assembles each slab chunk from the windows that reach into it, found
through ``wend``/``wbeg``: it rests on the plans' windows being disjoint,
which is checked here, and its chunk walk, emulated in numpy, is held
bitwise against the twin."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops import blockv2 as bv2
from block2_preview_tpu_torch.ops import mixv4

from test_torch_plans import L8, SITES, Site, hubbard_system

L8_CENTERS = L8 - 1     # two-site centers of the test chain


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


@pytest.mark.parametrize("side", ["lw", "rw"])
def test_unpacked_reference_kernels_match_k3_k4(system, side):
    """B20: the reference's unpacked-table jits — _mix4_exec (mixv4.py:277)
    and _place4_exec (:101) walked as a chunked sequence of group windows
    (i0, ng), the TPU watchdog chunking — against one call each of K3's and
    K4's twins on the same plan_v4 tables: the same OUT buffer and the same
    slab pool."""
    import jax.numpy as jnp
    from block2_preview_tpu.ops import mixv4 as ref
    _, r4, pool = Site(*system, SITES[1]).ref_plans(side)
    otp = ref._cap_class(r4.out_total + 1)
    out_ref = ref._mix4_exec(
        jnp.asarray(pool), jnp.asarray(r4.wdense.real), jnp.asarray(r4.it),
        jnp.asarray(r4.cum1), jnp.asarray(r4.cum2), jnp.asarray(r4.g1),
        jnp.asarray(r4.g2), jnp.asarray(r4.e1), jnp.asarray(r4.e2),
        jnp.zeros(otp + 1), jnp.asarray(r4.ng_live, jnp.int32), ref._T4,
        ref._B4, ref._NTP4)
    res_ref = jnp.zeros(r4.ncap_out + 1)
    # groups of B = 64 tile tasks (not the plan's 8192, which makes one
    # group here), walked in windows of a third of them
    B = 64
    png = -(-int(r4.pcum[-1]) // B)
    step = max(1, png // 3)
    assert png > step             # at least two windows
    for i0 in range(0, png, step):
        res_ref = ref._place4_exec(
            out_ref[:otp], jnp.asarray(r4.pit), jnp.asarray(r4.pcum),
            res_ref, jnp.asarray(i0, jnp.int32),
            jnp.asarray(min(i0 + step, png), jnp.int32), ref._TP, B)
    p4 = interop.mix_plan_v4(r4)
    d = mixv4.plan_tables(p4, "cpu", torch.float64)
    out = torch.zeros(otp + 1, dtype=torch.float64)
    mixv4.mix_exec(torch.as_tensor(pool), d["wpool"], d, out)
    scale = max(np.abs(np.asarray(out_ref)).max(), 1.0)
    assert np.abs(out.numpy()[:otp] - np.asarray(out_ref)[:otp]).max() \
        <= 1e-12 * scale
    res = torch.zeros(p4.ncap_out + 1, dtype=torch.float64)
    mixv4.place_exec(out[:otp], d, res)
    assert np.abs(res.numpy() - np.asarray(res_ref)).max() <= 1e-12 * scale


def _windows(pit):
    """(src, dst) element indices of every window of a plan's ``pit``,
    window by window, row by row."""
    w = pit[pit[:, 5] * pit[:, 6] > 0].astype(np.int64)
    n = w[:, 5] * w[:, 6]
    wi = np.repeat(np.arange(len(w)), n)
    o = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    r, c = o // w[wi, 6], o % w[wi, 6]
    return (w[wi, 0] + r * w[wi, 1] + c,
            w[wi, 2] + r * w[wi, 3] + c * w[wi, 4])


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("side", ["lw", "rw"])
def test_place_windows_disjoint_and_ordered(system, t, side):
    """Every plan's windows are disjoint inside the slab (K4 gives each
    slab element one value), the builder emits them in slab order (so
    K4's candidate range per chunk is tight), and plan_tables' ``wend`` /
    ``wbeg`` are the numpy prefix maximum of each window's end and suffix
    minimum of its start, pad rows owning none."""
    _, p4, _ = Site(*system, t).port_plans(side)
    src, dst = _windows(p4.pit)
    assert len(dst) > 0
    assert len(np.unique(dst)) == len(dst)
    assert 0 <= dst.min() and dst.max() < p4.ncap_out     # sentinel free
    assert 0 <= src.min() and src.max() < p4.out_total
    pit = p4.pit.astype(np.int64)
    live = pit[:, 5] * pit[:, 6] > 0
    assert np.all(np.diff(pit[live, 2]) > 0)
    d = mixv4.plan_tables(p4, "cpu", torch.float64)
    end = np.where(live, pit[:, 2] + (pit[:, 5] - 1) * pit[:, 3]
                   + (pit[:, 6] - 1) * pit[:, 4] + 1, 0)
    beg = np.where(live, pit[:, 2], np.iinfo(np.int32).max)
    assert d["wend"].dtype == d["wbeg"].dtype == torch.int32
    assert np.array_equal(d["wend"].numpy(), np.maximum.accumulate(end))
    assert np.array_equal(d["wbeg"].numpy(),
                          np.minimum.accumulate(beg[::-1])[::-1])
    assert int(d["wend"][-1]) == dst.max() + 1


# csrc/place.cu's kChunkBytes and kPlaceThreads (kUnroll groups a thread's
# elements without changing their order, so the walk ignores it)
PLACE_CHUNK_BYTES, PLACE_THREADS = 32768, 256


def _warp_count(arr, n, x):
    """place.cu's warp_count: #{i < n : arr[i] <= x} for a nondecreasing
    arr, by rounds of 32 probes."""
    lo, hi = 0, n
    while hi - lo > 32:
        step = -(-(hi - lo) // 32)
        m = sum(1 for ln in range(32)
                if lo + ln * step < hi and arr[lo + ln * step] <= x)
        if m == 0:
            return lo
        last = lo + (m - 1) * step
        lo, hi = last + 1, min(hi, last + step)
    return lo + sum(1 for ln in range(32)
                    if lo + ln < hi and arr[lo + ln] <= x)


def _place_walk(pit, wend, wbeg, outflat, res, chunk, threads=PLACE_THREADS):
    """K4's blocks on numpy arrays: per chunk [a, a + len) of the slab, a
    buffer of zeros; the candidate windows i0..i1 (_warp_count over wend
    and wbeg), ``threads`` at a time: each one's rows that meet the chunk,
    their element counts scanned into offsets, thread t's elements t, t +
    threads, ... each found by a binary search over the offsets from its
    previous one and written into the buffer if it falls in the chunk;
    the buffer stored whole.  Returns how often each slab element received
    a window value."""
    pit = pit.astype(np.int64)
    n_win, n_res = len(pit), len(res)
    seen = np.zeros(n_res, np.int64)
    for a in range(0, n_res, chunk):
        ln = min(chunk, n_res - a)
        buf = np.zeros(ln, res.dtype)
        if n_win > 0 and a < wend[-1]:
            i0 = _warp_count(wend, n_win, a)
            i1 = _warp_count(wbeg, n_win, a + ln - 1) - 1
            for base in range(i0, i1 + 1, threads):
                cnt = np.zeros(threads, np.int64)
                rows = {}
                for t in range(min(threads, i1 + 1 - base)):
                    src, sst, dst, rs, cs, nb, nk, _ = \
                        (int(x) for x in pit[base + t])
                    if nb <= 0 or nk <= 0:
                        continue
                    r0, r1 = 0, nb - 1
                    if rs > 0 and cs >= 0:
                        lo, hi = a - dst - (nk - 1) * cs, a + ln - 1 - dst
                        if lo > 0:
                            r0 = min(nb, -(-lo // rs))
                        r1 = -1 if hi < 0 else min(nb - 1, hi // rs)
                    if r1 >= r0:
                        cnt[t] = (r1 - r0 + 1) * nk
                        rows[t] = (src + r0 * sst, sst, dst + r0 * rs - a,
                                   rs, cs, nk)
                off = np.concatenate([[0], np.cumsum(cnt)])
                for tid in range(threads):
                    k = 0
                    for e in range(tid, int(off[-1]), threads):
                        h = threads
                        while h - k > 1:
                            m = (k + h) >> 1
                            if off[m] <= e:
                                k = m
                            else:
                                h = m
                        src, sst, pos, rs, cs, nk = rows[k]
                        r, c = divmod(int(e - off[k]), nk)
                        q = pos + r * rs + c * cs
                        if 0 <= q < ln:
                            buf[q] = outflat[src + r * sst + c]
                            seen[a + q] += 1
        res[a:a + ln] = buf
    return seen


@pytest.mark.parametrize("side", ["lw", "rw"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("chunk,threads,must_split", [
    (None, PLACE_THREADS, False),   # the kernel's chunk (32 KB)
    (37, 8, True),                  # chunks that split window rows
])
def test_place_walk_matches_twin(system, side, dtype, chunk, threads,
                                 must_split):
    """K4's chunk walk (a zero buffer a chunk, the candidate windows
    through wend/wbeg, their in-chunk rows laid out flat by a scan, the
    buffer stored whole) gives every live element exactly one value and,
    from a slab of NaNs, place_twin's slab bit for bit, on a random OUT
    buffer; the wrapper does the same on the CPU."""
    _, p4, _ = Site(*system, SITES[1]).port_plans(side)
    d = mixv4.plan_tables(p4, "cpu", torch.float64)
    chunk = chunk or PLACE_CHUNK_BYTES // np.dtype(dtype).itemsize
    _, dst = _windows(p4.pit)
    if must_split:       # some chunk boundary falls inside a window row
        w = p4.pit[p4.pit[:, 5] * p4.pit[:, 6] > 0].astype(np.int64)
        r = np.arange(int(w[:, 5].max()))[:, None]
        first = w[:, 2] + r * w[:, 3]                 # [rows, windows]
        last = first + (w[:, 6] - 1) * w[:, 4]
        assert np.any((r < w[:, 5]) & ((first // chunk + 1) * chunk <= last))
    otp = mixv4._cap_class(p4.out_total + 1)
    outflat = np.random.default_rng(4).standard_normal(otp).astype(dtype)
    res = np.full(p4.ncap_out + 1, np.nan, dtype)
    seen = _place_walk(p4.pit, d["wend"].numpy(), d["wbeg"].numpy(),
                       outflat, res, chunk, threads)
    covered = np.zeros(len(res), bool)
    covered[dst] = True
    assert np.all(seen[covered] == 1) and not seen[~covered].any()
    tdt = torch.from_numpy(res).dtype
    want = mixv4.place_twin(torch.as_tensor(outflat), d,
                            torch.zeros(p4.ncap_out + 1, dtype=tdt))
    assert np.array_equal(res, want.numpy())
    got = mixv4.place_exec(torch.as_tensor(outflat), d,
                           torch.full((p4.ncap_out + 1,), np.nan, dtype=tdt))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K3 (csrc/mix.cu) on its output tiles: mixv4.k3_host_tables walked in the
# kernel's order
# ---------------------------------------------------------------------------

def mix_walk(epool, wpool, h, n, lim=None):
    """K3's CUDA blocks on numpy arrays, in the kernel's order: per tile
    (l0, entries, rows, columns, OUT offset, OUT stride, d0) of
    ``h["kt"]`` an accumulator of its OUT piece, each list entry (W
    offset, W stride, E offset, E stride, depth, mask) in j order and
    each set bit k of its mask adding W[:, 16k:16k + 16] @ E[16k:16k +
    16, d0:], the piece stored once; a zero tile (-1, gaps, first)
    stores zeros over its gaps of ``h["kz"]`` below ``lim`` (the kernel's
    ``zlim``; default ``n``).  Returns OUT [n] (from NaNs), how often each
    element was stored, and whether a GEMM block stored it."""
    KS = mixv4.K3_SLICE
    out = np.full(n, np.nan, epool.dtype)
    seen = np.zeros(n, np.int64)
    by_block = np.zeros(n, bool)
    for l0, cnt, nrow, ncol, ob, ost, d0, _ in h["kt"].astype(np.int64):
        if l0 < 0:
            for s0, ln in h["kz"][nrow:nrow + cnt].astype(np.int64):
                s1 = min(s0 + ln, n if lim is None else lim)
                out[s0:s1] = 0
                seen[s0:s1] += 1
            continue
        r, c = np.arange(nrow)[:, None], np.arange(ncol)[None, :]
        acc = np.zeros((nrow, ncol), epool.dtype)
        for wb, ws, eb, es, depth, lo, hi, _ in \
                h["kl"][l0:l0 + cnt].astype(np.int64):
            m = (hi & 0xffffffff) << 32 | (lo & 0xffffffff)
            for k in (k for k in range(64) if m >> k & 1):
                kk = np.arange(min(KS, depth - k * KS))
                acc += (wpool[wb + r * ws + k * KS + kk[None, :]]
                        @ epool[eb + (k * KS + kk[:, None]) * es + d0 + c])
        idx = ob + r * ost + c
        out[idx] = acc
        seen[idx] += 1
        by_block[idx] = True
    return out, seen, by_block


_K3_TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _k3_hold(got, want, dtype, what):
    scale = max(float(np.abs(want).max()), 1.0)
    assert np.abs(got - want).max() <= _K3_TOL[dtype] * scale, what


@pytest.fixture(scope="module")
def chain_sites(system):
    """Site objects of every two-site center of the test chain, built on
    first use."""
    cache = {}

    def get(t):
        if t not in cache:
            cache[t] = Site(*system, t)
        return cache[t]
    return get


@pytest.fixture(scope="module")
def blk_chain(system):
    """Reference and port host environments over the test chain (the
    port's from the converted MPO/MPS), left ones up to center 4, for
    test_torch_blockv2's v3 plans."""
    from block2_preview_tpu.dmrg.environment import MovingEnvironment as RME
    from block2_preview_tpu_torch.dmrg.environment import MovingEnvironment
    mpo, mps = system
    chain = (RME(mpo, mps),
             MovingEnvironment(interop.mpo(mpo), interop.mps(mps)))
    for me in chain:
        me.init_environments()
        for s in range(4):
            me.update_left(s)
    return chain


@pytest.mark.parametrize("t", range(L8_CENTERS))
@pytest.mark.parametrize("side", ["lw", "rw"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k3_walk_matches_jax_and_twin(chain_sites, t, side, dtype):
    """K3's walk over its host tables, with the all-zero W slices skipped,
    gives the JAX _mix4_exec's and mix_twin's OUT on the reference's and
    the port's plan of every center of the chain; it stores every element
    of OUT once, and every element a K4 window reads by a GEMM block."""
    import jax.numpy as jnp
    from block2_preview_tpu.ops import mixv4 as ref
    site = chain_sites(t)
    _, r4, rpool = site.ref_plans(side)
    _, p4, pool = site.port_plans(side)
    otp = mixv4._cap_class(p4.out_total + 1)
    h = mixv4.plan_host(p4)
    assert mixv4.plan_host(p4) is h               # built once a plan
    ep = pool.astype(dtype)
    d = mixv4.plan_tables(p4, "cpu", torch.from_numpy(ep).dtype)
    lim = int(d["zlim"])
    got, seen, by_block = mix_walk(ep, p4.wdense.real.astype(dtype), h,
                                   otp + 1, lim)
    # every element below the end of K4's reads is stored once, and what
    # K4 reads by a GEMM block; past it only GEMM blocks' elements
    src, _ = _windows(p4.pit)
    assert lim == src.max() + 1 and lim <= p4.out_total
    assert np.all(seen[:lim] == 1) and np.all(seen[lim:] <= 1)
    assert np.array_equal(seen[lim:] == 1, by_block[lim:])
    assert by_block[src].all()
    got = np.where(seen > 0, got, 0)[:otp]
    twin = mixv4.mix_twin(torch.as_tensor(ep), d["wpool"], d, torch.zeros(
        otp + 1, dtype=d["wpool"].dtype)).numpy()[:otp]
    _k3_hold(got, twin, dtype, "twin")
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    want = np.asarray(ref._mix4_exec(
        jnp.asarray(rpool.astype(dtype)),
        jnp.asarray(r4.wdense.real.astype(dtype)), jnp.asarray(r4.it),
        jnp.asarray(r4.cum1), jnp.asarray(r4.cum2), jnp.asarray(r4.g1),
        jnp.asarray(r4.g2), jnp.asarray(r4.e1), jnp.asarray(r4.e2),
        jnp.zeros(otp + 1, jd), jnp.asarray(r4.ng_live, jnp.int32),
        ref._T4, ref._B4, ref._NTP4))[:otp]
    _k3_hold(got, want, dtype, "jax")


@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k3_walk_on_v3_blocking(blk_chain, direction, dtype):
    """K3's walk on a v3 blocking plan's GEMM (gtab, W2) over its ROT
    pool gives the final pool of the JAX execute_blocking_v3 and of
    mix_twin: every element of [0, ncap) stored once, the sectors no spec
    writes and the tail past meta_out.total as zeros."""
    from test_torch_blockv2 import BONDS, _jax_out, _plans
    ref, port, pool = _plans(blk_chain, BONDS[direction][1], direction,
                             True)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rot = bv2.execute_blocking_v2(port.rot, interop.slab_pool(
        pool, "cpu", dtype)).numpy()
    h = bv2.mix_host(port)
    got, seen, by_block = mix_walk(rot, port.wdense.astype(dtype), h,
                                   port.ncap)
    assert np.all(seen == 1) and not by_block[port.meta_out.total:].any()
    assert h["zeros"] >= port.ncap - port.meta_out.total
    d3 = bv2.mix_tables(port, "cpu", tdt)
    twin = mixv4.mix_twin(torch.as_tensor(rot), d3["wpool"], d3,
                          torch.zeros(port.ncap, dtype=tdt)).numpy()
    _k3_hold(got, twin, dtype, "twin")
    _k3_hold(got, _jax_out(ref, pool, True).astype(dtype), dtype, "jax")
    full = bv2.execute_blocking_v3(port, interop.slab_pool(pool, "cpu",
                                                           dtype)).numpy()
    assert np.array_equal(full, twin)


def test_k3_walk_sums_j_chunks():
    """A GEMM block with ns > 1024 splits into j-chunk items that share
    their OUT rows: K3's list holds them in j order, the walk sums them in
    one tile, with the W slices that are all zero skipped; a second block
    beside it; an OUT past the blocks stored as zeros.  Blocks that share
    an element are refused."""
    rng = np.random.default_rng(3)
    nw, ns, width = 70, 1500, 40
    W = rng.standard_normal((nw, ns))
    W[:, 1040:1100] = 0.0          # whole j slices of zeros
    W[:64, 200:232] = 0.0          # zero only in the first 64-row tile
    E = rng.standard_normal((ns, width))
    specs = [(0, ns, nw, ns, 0, width, 0, width, width),
             (0, ns, nw, ns, 0, width, nw * width + 16, width, width)]
    g = mixv4.emit_gemm_items(specs)
    h = mixv4.k3_host_tables(g["it"], W.ravel(), 2 * nw * width + 100)
    assert int(np.count_nonzero(g["it"][:, 2])) == 4     # 2 j-chunks each
    kt = h["kt"][h["kt"][:, 0] >= 0]
    assert len(kt) == 4 and np.all(kt[:, 1] == 2)       # a list: 2 chunks
    # (w tile, j chunk) -> its mask: slice 13 of chunk 0 is zero in W rows
    # [0, 64) only, slices 1-3 of chunk 1 in every row
    m = {(int(nrow != 64), e): int(h["kl"][l0 + e, 5]) & 0xffffffff
         | (int(h["kl"][l0 + e, 6]) & 0xffffffff) << 32
         for l0, _, nrow in kt[:, :3] for e in range(2)}
    full0, full1 = (1 << 64) - 1, (1 << 30) - 1
    assert m[(0, 0)] == full0 & ~(1 << 13) and m[(1, 0)] == full0
    assert m[(0, 1)] == m[(1, 1)] == full1 & ~0b1110
    assert h["steps"] == 2 * (63 + 64 + 27 + 27)
    got, seen, by_block = mix_walk(E.ravel(), W.ravel(), h,
                                   2 * nw * width + 100)
    assert np.all(seen == 1)
    want = W @ E
    assert np.allclose(got[:nw * width].reshape(nw, width), want,
                       rtol=0, atol=1e-11)
    assert np.allclose(got[nw * width + 16:2 * nw * width + 16].reshape(
        nw, width), want, rtol=0, atol=1e-11)
    assert np.all(got[nw * width:nw * width + 16] == 0)
    assert np.all(got[2 * nw * width + 16:] == 0)
    d = {k: torch.as_tensor(g[k]) for k in ("it", "cum1", "cum2")}
    twin = mixv4.mix_twin(torch.as_tensor(E.ravel()),
                          torch.as_tensor(W.ravel()), d,
                          torch.zeros(2 * nw * width + 101,
                                      dtype=torch.float64)).numpy()
    assert np.abs(got - twin[:-1]).max() <= 1e-12 * np.abs(twin).max()
    bad = mixv4.emit_gemm_items(
        [specs[0], (0, ns, nw, ns, 0, width, width * 3, width, width)])
    with pytest.raises(ValueError, match="overlap"):
        mixv4.k3_host_tables(bad["it"], W.ravel(), 4 * nw * width)


def test_k3_wrapper_launches_or_raises(chain_sites):
    """K3's wrapper runs its plain version only on CPU tensors (into an
    OUT it zeroes there) and refuses any other non-CUDA device."""
    _, p4, pool = chain_sites(SITES[1]).port_plans("lw")
    d = mixv4.plan_tables(p4, "cpu", torch.float64)
    otp = mixv4._cap_class(p4.out_total + 1)
    junk = torch.full((otp + 1,), np.nan, dtype=torch.float64)
    got = mixv4.mix_exec(torch.as_tensor(pool), d["wpool"], d, junk)
    want = mixv4.mix_twin(torch.as_tensor(pool), d["wpool"], d,
                          torch.zeros(otp + 1, dtype=torch.float64))
    assert torch.equal(got, want)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mixv4.mix_exec(meta, meta, d, meta)
