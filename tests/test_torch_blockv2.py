"""Environment blocking of the port (ops/blockv2.py, kernel K5 + K3 for
v3 plans): ``build_blocking_v2`` plans equal the reference's field by
field, and the plain twins on CPU tensors equal the JAX package's
``execute_blocking_v2``/``v3`` on the same plan and pool (rel <= 1e-11)
and the host contraction ``_left_contract``/``_right_contract`` (atol
1e-12), left and right, v2 and v3 — mirroring test_blockv2.py and
test_blockv3.py."""

import numpy as np
import pytest
import torch

import block2_preview_tpu.ops.blockv2 as ref_bv2
from block2_preview_tpu.dmrg.environment import MovingEnvironment as RefME
from block2_preview_tpu.ops.stacked import meta_from_env as ref_meta_from_env

import block2_preview_tpu_torch.ops.blockv2 as bv2
from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.core.blocks import MPSTensor
from block2_preview_tpu_torch.dmrg.environment import MovingEnvironment
from block2_preview_tpu_torch.ops.stacked import env_pool

from test_torch_plans import _eq, hubbard_system

BONDS = {"left": (0, 3, 5), "right": (7, 4, 2)}
_V2_FIELDS = ("T", "B", "nt1", "ntp", "ncap", "left", "it", "ef", "coef",
              "cum1", "cum2", "cum3", "g1", "g2", "g3", "flops")


@pytest.fixture(scope="module")
def chain():
    """Reference and port host environments over one Hubbard-L8 MPS (the
    port's from the converted MPO/MPS), left ones up to the middle."""
    mpo, mps = hubbard_system(D=40)
    rme = RefME(mpo, mps)
    pme = MovingEnvironment(interop.mpo(mpo), interop.mps(mps))
    for me in (rme, pme):
        me.init_environments()
        for s in range(max(BONDS["left"]) + 1):
            me.update_left(s)
    return rme, pme


def _args(me, t, direction):
    """build_blocking_v2 arguments of bond step t, and the source pool."""
    left = direction == "left"
    src = t if left else t + 1
    env = me.left_envs[src] if left else me.right_envs[src]
    mpo = me.mpo
    return ((mpo.tensors[t], mpo.site_quanta[t], me.bra.tensors[t],
             me.ket.tensors[t], mpo.group, direction, mpo.bond_dqs[src],
             mpo.bond_dqs[t + 1 if left else t]), env, src)


def _plans(chain, t, direction, mix, **kw):
    rme, pme = chain
    rargs, renv, src = _args(rme, t, direction)
    pargs, penv, _ = _args(pme, t, direction)
    rmeta = ref_meta_from_env(renv, rme.mpo.bond_dqs[src])
    pmeta, pool = env_pool(penv, pme.mpo.bond_dqs[src], np.float64)
    ref = ref_bv2.build_blocking_v2(rmeta, *rargs, gemm_mix=mix, **kw)
    port = bv2.build_blocking_v2(pmeta, *pargs, gemm_mix=mix, **kw)
    return ref, port, pool


def _same_v2(p, r):
    assert p.meta_out.signature() == hash(
        (tuple((dq, tuple(map(int, ss))) for dq, ss in r.meta_out.groups),
         tuple(tuple(sorted(sec.items())) for sec in r.meta_out.sectors),
         r.meta_out.total))
    for k in _V2_FIELDS:
        _eq(getattr(p, k), getattr(r, k), k)
    for which in ("bra_pool", "ket_pool"):
        (pm, po), (rm, ro) = getattr(p, which), getattr(r, which)
        _eq(po, ro, which)
        _eq(list(pm), list(rm), which)


@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("mix", [True, False], ids=["v3", "v2"])
def test_blocking_plans_equal(chain, direction, mix):
    for t in BONDS[direction]:
        ref, port, _ = _plans(chain, t, direction, mix)
        if mix:
            assert isinstance(port, bv2.BlockingV3Plan)
            _same_v2(port.rot, ref.rot)
            for k in ("ncap", "T", "flops", "rot_total", "gtab", "wdense"):
                _eq(getattr(port, k), getattr(ref, k), k)
        else:
            _same_v2(port, ref)


def _jax_out(ref, pool, mix):
    import jax.numpy as jnp
    run = ref_bv2.execute_blocking_v3 if mix else ref_bv2.execute_blocking_v2
    return np.asarray(run(ref, jnp.asarray(pool), dtype=np.float64))


def _port_out(port, pool, mix, dtype=np.float64):
    run = bv2.execute_blocking_v3 if mix else bv2.execute_blocking_v2
    return run(port, interop.slab_pool(pool, "cpu", dtype)).numpy()


def _check_host(chain, port, out, t, direction):
    """Every host-contracted block appears in the unpacked pool."""
    rme = chain[0]
    host = rme._left_contract(t) if direction == "left" \
        else rme._right_contract(t)
    got = port.meta_out.unpack(out, chain[1].g, None)
    n = 0
    for o, bm in host.items():
        for key, blk in bm.blocks.items():
            g2 = got.get(o)
            g2 = None if g2 is None else g2.blocks.get(key)
            if g2 is None:
                assert np.abs(blk).max() <= 1e-12, (o, key)
                continue
            assert np.abs(g2 - blk).max() <= 1e-12, (o, key)
            n += 1
    assert n > 0


@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("mix", [True, False], ids=["v3", "v2"])
def test_blocking_twin_matches_jax_and_host(chain, direction, mix):
    for t in BONDS[direction]:
        ref, port, pool = _plans(chain, t, direction, mix)
        want = _jax_out(ref, pool, mix)
        got = _port_out(port, pool, mix)
        assert got.shape == want.shape == (port.ncap,)
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()
        # sentinel slots stay exactly zero
        assert not got[port.meta_out.total:].any()
        _check_host(chain, port, got, t, direction)


def test_blocking_twin_chunk_boundary(chain, monkeypatch):
    """The twin processes items in chunks; with a one-task chunk budget
    every item is its own chunk, and with the reference's stage budgets
    cut down the plan splits into many task groups (which K5 does not
    read).  Plans and results stay equal to the JAX package's (mirrors
    test_blockv2.py::test_blockv2_multigroup)."""
    t = BONDS["left"][-1]
    ref0, port0, pool = _plans(chain, t, "left", False, T=16)
    f = port0.it.astype(np.int64)
    nl, nk, nx, ny = f[:, 7], f[:, 8], f[:, 9], f[:, 10]
    nent = np.diff(np.searchsorted(port0.ef[:, 0], np.arange(len(f) + 1)))
    need = int(max((nl * ny * nk).max(), (nx * ny * nl).max(),
                   (nx * ny * nent).max()))
    cfg = (need, int((nl * ny).max()), int((nx * ny).max()))
    monkeypatch.setitem(ref_bv2._CFG, 16, cfg)
    monkeypatch.setitem(bv2._CFG, 16, cfg)
    monkeypatch.setattr(bv2, "_TWIN_TASKS", 1)
    for mix in (False, True):
        ref, port, pool = _plans(chain, t, "left", mix, T=16)
        inner = port.rot if mix else port
        assert len(inner.g1) > 2, "budgets did not force task groups"
        _same_v2(inner, ref.rot if mix else ref)
        want = _jax_out(ref, pool, mix)
        got = _port_out(port, pool, mix)
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


def test_blocking_twin_f32(chain):
    ref, port, pool = _plans(chain, BONDS["right"][1], "right", True)
    want = _jax_out(ref, pool, True)
    got = _port_out(port, pool, True, np.float32)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_device_chain_matches_host_chain():
    """The port's device environment chain (CPU tensors, K5 + K3 twins)
    gives the host chain's environments at every bond, and the cached
    plans take the new site values on a signature hit."""
    mpo, mps = hubbard_system(D=30)
    pmpo, pmps = interop.mpo(mpo), interop.mps(mps)
    dev = MovingEnvironment(pmpo, pmps, device=torch.device("cpu"))
    host = MovingEnvironment(pmpo, pmps)
    for _ in range(2):
        dev.init_environments()
        host.init_environments()
        for b in range(2, mpo.n_sites):
            got = dev.right_envs[b]         # materializes (counted)
            for s, bm in host.right_envs[b].items():
                for key, blk in bm.blocks.items():
                    g2 = got[s].blocks.get(key) if s in got else None
                    if g2 is None:
                        assert np.abs(blk).max() <= 1e-12
                    else:
                        assert np.abs(g2 - blk).max() <= 1e-12
        # new site tensors of the same structure (as a sweep makes them):
        # the next pass hits the plan cache and must refresh the values
        pmps.tensors = [MPSTensor(T.group, {k: 0.5 * b for k, b in
                                            T.blocks.items()})
                        for T in pmps.tensors]
    assert dev.host_env_materialized == 2 * (mpo.n_sites - 2)
    assert dev.max_rot_pool > 0


def test_blocking_refuses_complex_plans(chain):
    """A complex plan is refused rather than run with its imaginary parts
    dropped (the reference's f64 cast of a complex pool did that)."""
    _, port, pool = _plans(chain, BONDS["left"][1], "left", True)
    port.wdense = port.wdense.astype(np.complex128)
    with pytest.raises(TypeError, match="complex"):
        bv2.execute_blocking_v3(port, interop.slab_pool(pool, "cpu"))
    _, port, pool = _plans(chain, BONDS["left"][1], "left", False)
    port.coef = port.coef.astype(np.complex128)
    with pytest.raises(TypeError, match="complex"):
        bv2.execute_blocking_v2(port, interop.slab_pool(pool, "cpu"))
