"""The v1 slab matvec of the port — kernel K16 (SlabMatvec): its struct
field by field against the reference's SlabMatvec, K16's plain twin
(what matvec_device runs on CPU tensors) against the reference's
_slab_matvec_impl (JAX on the CPU) on the same struct and pools (f64:
1e-12 relative; f32: 1e-5), and against K1's twin (MatvecV2) on the same
LW/RW pools: both compute H x.  K16 itself runs the chain core over one
item a triple (``resident.k16_items``): the items against the triples
recomputed from the port's metas, and their chunk tables walked in the
kernel's order (``chain_mv.chain_plain``) against the same oracles."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.ops import resident as ref_resident
from block2_preview_tpu.ops.mixv4 import execute_mix_v4 as ref_execute_mix

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops import chain_mv, resident, tilev2

from test_torch_plans import SITES, Site, _eq, hubbard_system


@pytest.fixture(scope="module")
def system():
    return hubbard_system()


def _setup(site, dtype=np.float64):
    """Reference v4 plans, their LW/RW pools (reference mix) and the
    reference SlabMatvec of the site."""
    import jax.numpy as jnp
    plans, pools = {}, {}
    for side in ("lw", "rw"):
        _, p4, pool = site.ref_plans(side)
        plans[side] = p4
        pools[side] = np.asarray(ref_execute_mix(
            p4, jnp.asarray(pool.astype(dtype)), dtype=dtype))
    eff = site.eff
    ref = ref_resident.SlabMatvec(eff.ket_space, plans["lw"].meta_out,
                                  plans["rw"].meta_out, site.mpo.group,
                                  eff.target, eff.target, dtype=dtype,
                                  bra_space=eff.bra_space)
    return plans, pools, ref


@pytest.mark.parametrize("t", SITES)
def test_struct_equals_the_reference(system, t):
    """SlabMatvec._build on the port's own LW/RW layouts gives the
    reference's struct."""
    site = Site(*system, t)
    plans, _, ref = _setup(site)
    pl, pr = site.port_plans("lw")[1], site.port_plans("rw")[1]
    eff = site.peff
    ex = resident.SlabMatvec(eff.ket_space, pl.meta_out, pr.meta_out,
                             site.pmpo.group, eff.target, eff.target,
                             bra_space=eff.bra_space)
    _eq(ex.struct, ref.struct, "struct")
    assert set(ex.struct) == {"T", "nt1", "nt2", "size_p", "sizb_p",
                              "psi_idx", "sig_idx", "l4", "pa", "s1", "ta",
                              "r4", "s2"}


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twin_matches_jax(system, t, dtype):
    import jax.numpy as jnp
    site = Site(*system, t)
    _, pools, ref = _setup(site, dtype)
    x = np.random.default_rng(5).standard_normal(site.eff.size)
    xp = ref.pad(x)
    want = np.asarray(ref.matvec_device(jnp.asarray(xp),
                                        jnp.asarray(pools["lw"]),
                                        jnp.asarray(pools["rw"])))
    ex = interop.slab_matvec(ref, dtype)
    got = ex.matvec_device(torch.as_tensor(ex.pad(x)),
                           torch.as_tensor(pools["lw"]),
                           torch.as_tensor(pools["rw"])).numpy()
    assert got.dtype == dtype and got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert np.abs(got - want).max() <= tol * scale
    assert np.abs(got[site.eff.size:]).max(initial=0.0) == 0.0


def test_twin_matches_matvec_v2_and_host(system):
    """On the same LW/RW pools K16's twin and K1's twin compute the same
    sigma, which is the host effective Hamiltonian's H x."""
    site = Site(*system, SITES[1])
    plans, pools, ref = _setup(site)
    x = np.random.default_rng(6).standard_normal(site.eff.size)
    lw, rw = (torch.as_tensor(pools[s]) for s in ("lw", "rw"))
    ex = interop.slab_matvec(ref)
    y16 = ex.matvec_device(torch.as_tensor(ex.pad(x)), lw, rw).numpy()
    v2 = interop.matvec_v2(site.ref_matvec(plans["lw"], plans["rw"]))
    s = v2.struct
    y1 = tilev2.mv_exec(torch.as_tensor(v2.pad(x)), lw, rw,
                        v2.to_device("cpu"), s["T"], s["nt2"]).numpy()
    n = site.eff.size
    scale = np.abs(y1[:n]).max()
    assert np.abs(y16[:n] - y1[:n]).max() <= 1e-12 * scale
    assert np.abs(y16[:n] - site.eff.matvec_np(x)).max() <= 1e-10 * scale


def test_tmp_offsets_cover_every_group(system):
    """to_device's toff gives each task group its own run of tmp tiles,
    as many as the group's largest stage-1 target + 1."""
    site = Site(*system, SITES[1])
    _, _, ref = _setup(site)
    ex = interop.slab_matvec(ref)
    d = ex.to_device("cpu")
    s1, nt1 = ex.struct["s1"], ex.struct["nt1"]
    toff = d["toff"].numpy()
    assert len(toff) == s1.shape[0] + 1 and toff[0] == 0
    for g in range(s1.shape[0]):
        live = s1[g][s1[g] < nt1]
        assert toff[g + 1] - toff[g] == (live.max() + 1 if len(live) else 0)
    assert d["ntmp"] == toff[-1]
    assert ex.to_device("cpu") is d            # cached per device
    ex.free()
    assert ex.to_device("cpu") is not d


def test_other_devices_raise():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resident.slab_mv_exec(x, x, x, {}, 16, 1, 1)


# ---------------------------------------------------------------------------
# K16 on the chain core: one item a triple, read from the struct
# ---------------------------------------------------------------------------

def _meta_triples(space, bra_space, meta_lw, meta_rw, g, tb):
    """Every triple of SlabMatvec._build as the chain core's eight fields
    (L offset, DLb, DLk, flat psi offset, DRk, R offset, DRb, flat sigma
    offset), recomputed from the metas and spaces."""
    out = []
    bkeys = set(bra_space.keys)
    for m, (gl, jl) in meta_lw.sym_pos.items():
        if m not in meta_rw.sym_pos:
            continue
        gr, jr = meta_rw.sym_pos[m]
        dq = meta_lw.groups[gl][0]
        for (qlk, qrk) in space.keys:
            qlb = g.add(qlk, dq)
            qrb = g.sub(tb, qlb)
            el = meta_lw.sectors[gl].get(qlb)
            er = meta_rw.sectors[gr].get(qrb)
            if (qlb, qrb) not in bkeys or el is None or er is None:
                continue
            (loff, dlb, dlk), (roff, drb, drk) = el, er
            if (dlk, drk) != tuple(space.shapes[(qlk, qrk)]):
                continue
            out.append((loff + jl * dlb * dlk, dlb, dlk,
                        space.offsets[(qlk, qrk)], drk,
                        roff + jr * drb * drk, drb,
                        bra_space.offsets[(qlb, qrb)]))
    return np.asarray(out, np.int64).reshape(-1, 8)


def _rows(a):
    a = np.asarray(a, np.int64)
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("made", ["port", "interop"])
@pytest.mark.parametrize("t", SITES)
def test_k16_items_are_the_triples_once(system, t, made):
    """k16_items gives every triple of _build exactly once, whether the
    SlabMatvec built its struct (port metas) or wraps the reference's
    (interop.slab_matvec); the host tables are built once and kept off
    the struct, and the device copy holds the same items and chunks."""
    site = Site(*system, t)
    eff = site.peff
    pl, pr = site.port_plans("lw")[1], site.port_plans("rw")[1]
    if made == "port":
        ex = resident.SlabMatvec(eff.ket_space, pl.meta_out, pr.meta_out,
                                 site.pmpo.group, eff.target, eff.target,
                                 bra_space=eff.bra_space)
    else:
        ex = interop.slab_matvec(_setup(site)[2])
    want = _meta_triples(eff.ket_space, eff.bra_space, pl.meta_out,
                         pr.meta_out, site.pmpo.group, eff.target)
    got = resident.k16_items(ex.struct)
    assert got.shape == want.shape and len(got) > 1
    assert len(np.unique(got, axis=0)) == len(got)
    assert np.array_equal(_rows(got), _rows(want))
    h = ex.k16_host()
    assert ex.k16_host() is h and "_k16" not in ex.struct
    assert np.array_equal(h["items"], got[chain_mv.ket_round_robin(got)])
    # that order: by sigma block, its ket blocks taken in turn
    turn, seen, prev = [], {}, None
    for f in h["items"].tolist():
        k = (f[7], f[3])
        turn.append(seen.get(k, 0))
        seen[k] = turn[-1] + 1
        if prev is not None and prev[0] == f[7]:
            assert (prev[1], prev[2]) < (turn[-1], f[3])
        else:
            assert prev is None or prev[0] < f[7]
        prev = (f[7], turn[-1], f[3])
    c = ex.to_device("cpu")["chain"]
    assert np.array_equal(c["items"].numpy(), h["items"])
    assert np.array_equal(c["ck"].numpy(), h["ck"])
    assert h["flops"] == int(chain_mv.entries(got)["flops"].sum())


@pytest.mark.parametrize("t", SITES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k16_chunk_walk_matches_jax_and_k1(system, t, dtype):
    """K16's chunk tables walked in the kernel's order over the slab
    pools against the JAX _slab_matvec_impl (f64 1e-12, f32 1e-5 relative
    to the largest entry) and K1's twin on the same pools; nothing past
    the bra space is written."""
    import jax.numpy as jnp
    site = Site(*system, t)
    plans, pools, ref = _setup(site, dtype)
    x = np.random.default_rng(7).standard_normal(site.eff.size)
    want = np.asarray(ref.matvec_device(jnp.asarray(ref.pad(x)),
                                        jnp.asarray(pools["lw"]),
                                        jnp.asarray(pools["rw"])))
    ex = interop.slab_matvec(ref, dtype)
    lw, rw = (torch.as_tensor(pools[k]) for k in ("lw", "rw"))
    xp = torch.as_tensor(ex.pad(x))
    got = chain_mv.chain_plain(xp, lw, rw, ex.to_device("cpu")["chain"],
                               ex.struct["sizb_p"]).numpy()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-12 if dtype == np.float64 else 1e-5
    n = site.eff.size
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert not got[n:].any()
    v2 = interop.matvec_v2(site.ref_matvec(plans["lw"], plans["rw"]))
    s = v2.struct
    y1 = tilev2.mv_exec(torch.as_tensor(v2.pad(x).astype(dtype)), lw, rw,
                        v2.to_device("cpu"), s["T"], s["nt2"]).numpy()
    assert np.abs(got[:n] - y1[:n]).max() <= tol * np.abs(y1[:n]).max()
