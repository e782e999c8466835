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


# ---------------------------------------------------------------------------
# K6's tables, walked as csrc/noise.cu walks them
# ---------------------------------------------------------------------------

def check_noise_tables(plan, h):
    """K6's tables: ``nw`` holds every item once (sorted stably by rho
    sector) with its W offset, flat psi offset, DK, DN and DB; each CUDA
    block is a run of at most NOISE_RUN items of one sector with one pair
    (a, c) of its strips, every pair of every run once, by decreasing
    FLOPs; the runs' partial matrices (DB^2 elements each) tile the
    partial pool of ``n_part`` elements; each sector row names its first
    run's partial offset, its runs, DB, rho tile base and strips."""
    n = len(plan.pn)
    it = plan.it[:n].astype(np.int64)
    order = np.argsort(it[:, 8], kind="stable")
    nw = h["nw"].astype(np.int64)
    assert np.array_equal(nw, np.stack([it[order, 0], plan.pn[order, 0],
                                        it[order, 9], plan.pn[order, 1],
                                        it[order, 2]], 1))
    sec = {b: (na, d) for b, na, d in plan.sectors.values()}
    runs, fl = {}, []
    S = resident.NOISE_STRIP
    for i0, i1, d, a, c, pb in h["nb"].astype(np.int64):
        ra, rc = min(S, d - a * S), min(S, d - c * S)
        f = nw[i0:i1]
        fl.append(int((f[:, 3] * f[:, 2]).sum()) * (ra + (rc if a != c
                                                          else 0))
                  + int(f[:, 3].sum()) * ra * rc)
        assert 0 < i1 - i0 <= resident.NOISE_RUN
        rbs = set(it[order[i0:i1], 8].tolist())
        assert len(rbs) == 1
        rb = rbs.pop()
        assert sec[rb][1] == d
        runs.setdefault((i0, i1, d, pb, rb), set()).add((a, c))
    ns = -(-np.asarray([k[2] for k in runs]) // resident.NOISE_STRIP)
    for (_, _, d, _, _), m in runs.items():
        k = -(-d // resident.NOISE_STRIP)
        assert m == {(a, c) for c in range(k) for a in range(c + 1)}
    assert len(h["nb"]) == int((ns * (ns + 1) // 2).sum())
    assert (np.diff(fl) <= 0).all()
    keys = sorted(runs)
    held = np.zeros(n, np.int64)
    cover = np.zeros(h["n_part"], np.int64)
    for i0, i1, d, pb, _ in keys:
        held[i0:i1] += 1
        cover[pb:pb + d * d] += 1
    assert (held == 1).all() and (cover == 1).all()
    for p0, nr, d, rb, na in h["ns"].astype(np.int64):
        mine = [k for k in keys if k[4] == rb]
        assert len(mine) == nr and mine[0][3] == p0 and sec[rb] == (na, d)
        assert [k[3] for k in mine] == [p0 + j * d * d for j in range(nr)]


def noise_walk(plan, h, xp, wpool, dtype):
    """K6 in numpy and ``dtype`` in the kernel's order: block by block, item
    by item, psi columns in chunks of 32, x_a
    = W[strip a] psi[:, chunk] (and x_c), the strip's accumulator += x_a
    x_c^T, written into the run's partial; then each sector's partials
    summed in run order into the rho tiles [nrho + 1, T, T] (the strip
    pairs a > c from the (c, a) pairs, transposed)."""
    xp, wpool = np.asarray(xp, dtype), np.asarray(wpool, dtype)
    S = resident.NOISE_STRIP
    part = np.full(h["n_part"], np.nan, dtype)
    nw = h["nw"].astype(np.int64)
    rw = plan.side == "rw"
    for i0, i1, d, a, c, pb in h["nb"].astype(np.int64):
        ra, rc = min(S, d - a * S), min(S, d - c * S)
        N = 32
        acc = np.zeros((ra, rc), dtype)
        for wb, po, dk, dn, db in nw[i0:i1]:
            w = wpool[wb:wb + db * dk].reshape(db, dk)
            p = xp[po:po + dk * dn]
            p = p.reshape(dn, dk).T if rw else p.reshape(dk, dn)
            for n0 in range(0, dn, N):
                xa = w[a * S:a * S + ra] @ p[:, n0:n0 + N]
                xc = w[c * S:c * S + rc] @ p[:, n0:n0 + N]
                acc += xa @ xc.T
        blk = part[pb:pb + d * d].reshape(d, d)
        blk[a * S:a * S + ra, c * S:c * S + rc] = acc
    T = plan.T
    rho = np.zeros((plan.nrho + 1, T, T), dtype)
    st = np.arange(int(h["ns"][:, 2].max())) // S
    for p0, nr, d, rb, na in h["ns"].astype(np.int64):
        full = np.zeros((d, d), dtype)
        for j in range(nr):
            full += part[p0 + j * d * d:p0 + (j + 1) * d * d].reshape(d, d)
        # the strip pairs a > c read the (c, a) pairs transposed
        low = st[:d, None] > st[None, :d]
        full[low] = full.T[low]
        for ar in range(na):
            for ac in range(na):
                t = full[ar * T:(ar + 1) * T, ac * T:(ac + 1) * T]
                rho[rb + ar * na + ac, :t.shape[0], :t.shape[1]] = t
    return rho


@pytest.mark.parametrize("side", ["lw", "rw"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_noise_walk_matches_jax_and_host(center, side, dtype, tol):
    """K6's tables (check_noise_tables) walked in the kernel's order
    (noise_walk) in ``dtype`` against the JAX package's
    NoisePlan.rho_device (atol ``tol`` x its largest entry, f32 to 1e-5)
    and, in f64, the host noise density matrix of the same psi
    (_average_rho_forward / _backward, atol 1e-10); the partial pool is
    far below the plain version's x pool."""
    import jax.numpy as jnp
    site, _, pools, ref_ex, x = center
    ref, port = _plans(center, side)
    h = port.host_tables()
    check_noise_tables(port, h)
    assert port.host_tables() is h and h["seconds"] >= 0
    # runs cut at NOISE_RUN items (the FLOP cap does not bind here)
    assert h["nb"][:, 1].max() - h["nb"][:, 0].min() > 1
    assert h["n_part"] < port.n_x * port.T ** 2
    xp = ref_ex.pad(x)
    want = ref.unpack(np.asarray(ref.rho_device(jnp.asarray(xp),
                                                jnp.asarray(pools[side]))))
    rho = noise_walk(port, h, xp, pools[side], dtype)
    assert rho.dtype == dtype
    got = port.unpack(rho)
    scale = max(np.abs(v).max() for v in want.values())
    for q in want:
        assert np.abs(got[q] - want[q]).max() <= tol * max(scale, 1.0), q
    if dtype != np.float64:
        return
    eff = site.eff
    psi = eff.unflatten(x)
    avg = _average_rho_forward if side == "lw" else _average_rho_backward
    host = avg(eff, [psi], [1.0], NOISE)
    dev = _apply_noise(avg(eff, [psi], [1.0], 0.0), got, NOISE)
    for q in host:
        assert np.allclose(host[q], dev[q], atol=1e-10), q


@pytest.mark.parametrize("cut", ["items", "flops", "budget"])
def test_noise_walk_many_runs_and_strips(center, monkeypatch, cut):
    """Strips of 16 rows, and runs of 2 items ("items") or runs cut by a
    FLOP cap of 1/64 of the plan's ("flops"; with a partial pool budget of
    4000 elements, "budget", the cap doubles until the pool fits or every
    sector is one run): the sectors split into strip pairs (a < c) and,
    but for "budget", into many runs; the tables still check and the walk
    still gives the JAX package's rho, both sides."""
    import jax.numpy as jnp
    if cut == "items":
        monkeypatch.setattr(resident, "NOISE_RUN", 2)
    else:
        monkeypatch.setattr(resident, "NOISE_BLOCKS", 64)
    if cut == "budget":
        monkeypatch.setattr(resident, "NOISE_PART", 4000)
    monkeypatch.setattr(resident, "NOISE_STRIP", 16)
    _, _, pools, ref_ex, x = center
    xp = ref_ex.pad(x)
    for side in ("lw", "rw"):
        ref, port = _plans(center, side)
        h = port.host_tables()
        check_noise_tables(port, h)
        assert (h["nb"][:, 3] < h["nb"][:, 4]).any()
        if cut == "budget":
            assert h["n_part"] <= 4000 or (h["ns"][:, 1] == 1).all()
        else:
            assert (h["ns"][:, 1] > 1).any()
        want = ref.unpack(np.asarray(ref.rho_device(
            jnp.asarray(xp), jnp.asarray(pools[side]))))
        got = port.unpack(noise_walk(port, h, xp, pools[side], np.float64))
        scale = max(np.abs(v).max() for v in want.values())
        for q in want:
            assert np.abs(got[q] - want[q]).max() <= 1e-12 * scale, q


def test_noise_tables_by_device_and_lazy_gather(center):
    """NoisePlan.tables gives the plain version's tables on the CPU and
    K6's (no psi gather) on any other device; the RW side's transposed
    psi gather is built only when the plain version asks for it."""
    ref, port = _plans(center, "rw")
    assert port._psi_idx is None
    d = port.tables("cpu")
    assert port._psi_idx is not None and "psi_idx" in d
    assert np.array_equal(port.psi_idx, ref.psi_idx)
    _, lw = _plans(center, "lw")
    k = lw.tables(torch.device("meta"))
    assert "psi_idx" not in k and k["rw"] == 0
    assert k["n_blocks"] == len(lw.host_tables()["nb"])
    assert k["n_part"] == lw.host_tables()["n_part"]


def test_noise_exec_launches_or_raises(center):
    """noise_exec runs the plain version only on CPU tensors: a tensor on
    any other device is refused, never run on the host."""
    _, port = _plans(center, "lw")
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resident.noise_exec(meta, meta, port.tables("meta"), port.T)
