"""Kernel K2 (diagonal) of the port against the reference's execute_diag
(JAX) on the same plan (< 1e-10), the torch Davidson through a thick
restart, and the port's ResidentSite — on the port's device environment
chain (CPU tensors), built from the converted MPO/MPS — against the host
effective Hamiltonian."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.ops.davidson import davidson as host_davidson
from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix
from block2_preview_tpu.ops.resident import (build_diag_struct as
                                             ref_build_diag_struct,
                                             execute_diag as ref_execute_diag)

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.effective import (
    EffectiveHamiltonian2 as PortEff)
from block2_preview_tpu_torch.dmrg.environment import (
    MovingEnvironment as PortME)
from block2_preview_tpu_torch.ops.device_davidson import davidson
from block2_preview_tpu_torch.ops.resident import ResidentSite, execute_diag

from test_torch_plans import SITES, Site, hubbard_system


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


@pytest.mark.parametrize("t", SITES)
def test_diag_twin_matches_jax(system, t):
    import jax.numpy as jnp
    site = Site(*system, t)
    pools, plans = {}, {}
    for side in ("lw", "rw"):
        _, p4, pool = site.ref_plans(side)
        plans[side] = p4
        pools[side] = np.asarray(ref_execute_mix(p4, jnp.asarray(pool),
                                                 dtype=np.float64))
    ref_ex = site.ref_matvec(plans["lw"], plans["rw"])
    s = ref_ex.struct
    eff = site.eff
    ds = ref_build_diag_struct(eff.ket_space, plans["lw"].meta_out,
                               plans["rw"].meta_out, s["T"], s["nt2"],
                               s["sig_idx"])
    ref = np.asarray(ref_execute_diag(ds, jnp.asarray(pools["lw"]),
                                      jnp.asarray(pools["rw"])))
    got = execute_diag(interop.diag_struct(ds),
                       interop.slab_pool(pools["lw"], "cpu"),
                       interop.slab_pool(pools["rw"], "cpu")).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-10
    assert np.abs(got[:eff.size] - eff.diagonal()).max() < 1e-10


def _padded(A):
    """matvec on padded vectors [n + 1] -> [n], as K1 presents it."""
    At = torch.as_tensor(A)
    return lambda v: At @ v[:-1]


def test_davidson_thick_restart():
    """Convergence through the subspace-compression restart (m > M);
    mirrors test_resident.py::test_device_davidson_thick_restart and
    agrees with the JAX device Davidson on the same inputs."""
    import jax.numpy as jnp
    from block2_preview_tpu.ops.device_davidson import device_davidson
    rng = np.random.RandomState(0)
    n = 64
    A = rng.standard_normal((n, n))
    A = 0.5 * (A + A.T) - 120 * np.eye(n) \
        + np.diag(rng.standard_normal(n) * 5)
    w_true = np.linalg.eigvalsh(A)[0]
    x0 = rng.standard_normal(n)
    x0 /= np.linalg.norm(x0)
    xp = torch.as_tensor(np.append(x0, 0.0))
    dg = torch.as_tensor(np.append(np.diag(A), 0.0))
    th, x, it = davidson(_padded(A), dg, xp, conv_thrd=1e-12,
                         max_iter=200, max_subspace=12)
    assert it > 12                  # must pass at least one restart
    assert abs(th - w_true) < 1e-9
    assert float(x[-1]) == 0.0      # the pad slot stays zero
    v = x[:-1].numpy()
    assert np.linalg.norm(A @ v - th * v) < 1e-5
    Aj = jnp.asarray(A)
    th_j, _, _ = device_davidson(lambda u: Aj @ u,
                                 jnp.asarray(np.diag(A).copy()),
                                 jnp.asarray(x0), conv_thrd=1e-12,
                                 max_iter=200, max_subspace=12)
    assert abs(th - float(th_j)) < 1e-9


def _resident(system, t, dtype=np.float64):
    """Reference Site (host oracle) and the port's ResidentSite at t, its
    environment pools blocked on the device path (CPU tensors)."""
    site = Site(*system, t)
    me = PortME(site.pmpo, site.pmps, device=torch.device("cpu"),
                dtype=dtype)
    me.init_environments()
    for s in range(t):
        me.update_left(s)
    eff = PortEff(me, t, assemble=False)
    return site, ResidentSite(me, eff, "cpu", dtype=dtype, caches={})


@pytest.mark.parametrize("t", SITES)
def test_resident_site_ground_state(system, t):
    """ResidentSite (mix -> diag -> Davidson around K1) finds the host
    Davidson's lowest eigenvalue of the same effective Hamiltonian."""
    site, rs = _resident(system, t)
    eff = site.eff
    x0 = np.random.RandomState(2).standard_normal(eff.size)
    x0 /= np.linalg.norm(x0)
    th, xv, nmv = rs.solve_ground_state(x0, conv_thrd=1e-12, max_iter=200)
    w, _, _ = host_davidson(eff.matvec_np, eff.diagonal(), x0[:, None],
                            conv_thrd=1e-12, max_iter=200)
    assert abs(th - float(w[0])) < 1e-9
    assert np.linalg.norm(eff.matvec_np(xv) - th * xv) < 1e-5
    assert nmv > 0


def test_resident_site_host_ops(system):
    """host_ops (a download of the assembled LW/RW, not on the sweep's
    path) returns the host assembly's LW/RW blocks and counts each
    download."""
    site, rs = _resident(system, SITES[1])
    for n, (which, ops) in enumerate((("lw", site.eff.LW),
                                      ("rw", site.eff.RW))):
        got = rs.host_ops(which)
        assert rs.me.host_ops_downloads == n + 1
        for m, blocks in ops.items():
            for key, blk in blocks.items():
                if not blk.any():
                    continue
                assert np.allclose(got[m][key], blk, atol=1e-12), \
                    (which, m, key)


def test_resident_site_f32(system):
    """The float32 path (pools, kernels' twins, Davidson) lands within
    float32 accuracy of the f64 eigenvalue."""
    site, rs = _resident(system, SITES[1], dtype=np.float32)
    assert rs.lw_pool.dtype == torch.float32
    eff = site.eff
    x0 = np.random.RandomState(2).standard_normal(eff.size)
    th, _, _ = rs.solve_ground_state(x0, conv_thrd=1e-8, max_iter=200)
    w, _, _ = host_davidson(eff.matvec_np, eff.diagonal(), x0[:, None],
                            conv_thrd=1e-12, max_iter=200)
    assert abs(th - float(w[0])) < 1e-4


def diag_walk(lpool, rpool, rows, sym, n, chunk=16):
    """K2's CUDA blocks on numpy arrays, in the kernel's order: per row
    (flat offset, DL, DR, a0, na, b0, nb, LW offset, RW offset) the
    diagonals of its piece staged ``chunk`` symbols at a time and each
    element summed over the symbols in order, stored once; a row with DL
    = 0 stores nb zeros.  Returns the flat diagonal [n] (from NaNs) and
    how often each element was stored."""
    out = np.full(n, np.nan, lpool.dtype)
    seen = np.zeros(n, np.int64)
    for (foff, DL, DR, a0, na, b0, nb, lo, ro) in rows.astype(np.int64):
        if DL == 0:
            out[foff:foff + nb] = 0
            seen[foff:foff + nb] += 1
            continue
        a, b = a0 + np.arange(na), b0 + np.arange(nb)
        acc = np.zeros((na, nb), lpool.dtype)
        for m0 in range(0, len(sym), chunk):
            jl = sym[m0:m0 + chunk, 0].astype(np.int64)[:, None]
            jr = sym[m0:m0 + chunk, 1].astype(np.int64)[:, None]
            L = lpool[lo + jl * DL * DL + a * (DL + 1)]
            R = rpool[ro + jr * DR * DR + b * (DR + 1)]
            for mm in range(len(L)):
                acc += L[mm][:, None] * R[mm][None, :]
        idx = foff + a[:, None] * DR + b[None, :]
        out[idx] = acc
        seen[idx] += 1
    return out, seen


@pytest.mark.parametrize("t", range(7))
def test_diag_walk_matches_jax(system, t):
    """K2's rows (build_diag_struct's ``k2``, ``k2m``), walked as
    csrc/diag.cu walks them, store every element of the flat diagonal
    [sizb_p] once and give the JAX execute_diag's diagonal and the host
    effective Hamiltonian's, the padded tail included, on the port's
    plans and pools at every center of the chain."""
    import jax.numpy as jnp
    from block2_preview_tpu_torch.ops import mixv4, resident, tilev2
    site = Site(*system, t)
    _, rl, rlp = site.ref_plans("lw")
    _, rr, rrp = site.ref_plans("rw")
    _, pl, lpool = site.port_plans("lw")
    _, pr, rpool = site.port_plans("rw")
    ref_ex = site.ref_matvec(rl, rr)
    rs = ref_ex.struct
    rds = ref_build_diag_struct(site.eff.ket_space, rl.meta_out,
                                rr.meta_out, rs["T"], rs["nt2"],
                                rs["sig_idx"])
    ref = np.asarray(ref_execute_diag(
        rds, ref_execute_mix(rl, jnp.asarray(rlp), dtype=np.float64),
        ref_execute_mix(rr, jnp.asarray(rrp), dtype=np.float64)))
    eff = site.peff
    ex = tilev2.MatvecV2(eff.ket_space, pl.meta_out, pr.meta_out,
                         site.pmpo.group, eff.target, dtype=np.float64,
                         bra_space=eff.bra_space)
    s = ex.struct
    ds = resident.build_diag_struct(eff.ket_space, pl.meta_out, pr.meta_out,
                                    s["T"], s["nt2"], s["sig_idx"])
    lw = mixv4.execute_mix_v4(pl, torch.as_tensor(lpool)).numpy()
    rw = mixv4.execute_mix_v4(pr, torch.as_tensor(rpool)).numpy()
    got, seen = diag_walk(lw, rw, ds["k2"], ds["k2m"], len(s["sig_idx"]))
    assert np.all(seen == 1) and got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-10
    assert np.abs(got[:eff.size] - site.eff.diagonal()).max() < 1e-10
    assert np.all(got[eff.size:] == 0)
    rows = ds["k2"].astype(np.int64)
    live = rows[rows[:, 1] > 0]
    assert np.all((live[:, 4] <= resident.K2_PIECE)
                  & (live[:, 6] <= resident.K2_PIECE))
    twin = resident.execute_diag(ds, torch.as_tensor(lw),
                                 torch.as_tensor(rw)).numpy()
    assert np.abs(got - twin).max() < 1e-12


def test_diag_rows_split_wide_sectors():
    """_k2_rows cuts a sector wider or taller than K2_PIECE into pieces of
    at most K2_PIECE x K2_PIECE, zero ranges fill the rest of the flat
    diagonal, and a sig_idx that puts a sector elsewhere is refused."""
    from block2_preview_tpu_torch.ops import resident
    P = resident.K2_PIECE
    T, DL, DR = 16, P + P // 2 + 3, 2 * P + 11
    nr, ncc = -(-DL // T), -(-DR // T)
    a, b = np.divmod(np.arange(DL * DR), DR)
    sig = np.full(2 * DL * DR + 40, 10 ** 6, np.int32)
    sig[32:32 + DL * DR] = ((a // T) * ncc + b // T) * T * T \
        + (a % T) * T + b % T
    rows = resident._k2_rows([(32, DL, DR, 0, 0, (0, nr, ncc))], sig, T)
    live = rows[rows[:, 1] > 0]
    assert len(live) == 6 and sorted(set(live[:, 6])) == [11, P]
    assert sorted(set(live[:, 4])) == [P // 2 + 3, P]
    cover = np.zeros(len(sig), np.int64)
    for (f, dl, dr, a0, na, b0, nb, _, _) in rows:
        if dl == 0:
            cover[f:f + nb] += 1
        else:
            idx = f + (a0 + np.arange(na))[:, None] * dr + b0 + np.arange(nb)
            cover[idx] += 1
    assert np.all(cover == 1)
    sig[40], sig[41] = sig[41], sig[40]
    with pytest.raises(ValueError, match="bra layout"):
        resident._k2_rows([(32, DL, DR, 0, 0, (0, nr, ncc))], sig, T)


def test_diag_tables_cached_and_wrapper_refuses(system):
    """ResidentSite keeps the diag struct and its tables per device in its
    cache (uploaded once), and diag_exec runs its plain version only on
    CPU tensors, refusing any other non-CUDA device."""
    from block2_preview_tpu_torch.ops import resident
    _, rs = _resident(system, SITES[1])
    d1 = rs.diagonal_device()
    sig, ds, dev = rs.caches["diag"][("diag", SITES[1])]
    assert set(dev) == {"cpu"} and "k2" in ds
    tab = dev["cpu"]
    assert torch.equal(rs.diagonal_device(), d1)
    assert rs.caches["diag"][("diag", SITES[1])][2]["cpu"] is tab
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resident.diag_exec(meta, meta, {})
