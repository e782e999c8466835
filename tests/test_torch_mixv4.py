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
from block2_preview_tpu_torch.ops import mixv4

from test_torch_plans import SITES, Site, hubbard_system


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
