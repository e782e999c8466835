"""The port's tiled engine (block2_preview_tpu_torch/ops/tiled.py, kernel
K7) against the JAX package's TiledExecutor on the same effective
Hamiltonians (Hubbard-L6, built in code): the port's copy of the
reference's tiled struct field by field and its tiled matvec against the
JAX ``_tiled_matvec_impl`` and the host ``matvec_np``; K7's plain version
(the items and flat pools the card reads) against ``_tiled_matvec_impl``
in f64/f32 and, on the complex environments of a state after one
real-time TDVP step, in c128/c64; K7's chunk tables walked in the
kernel's order (``chain_mv.chain_plain``) against its plain version; the
struct cache; the device Davidson; and ``backend="torch_tiled"`` DMRG
against exact diagonalization and the JAX package's jax_tiled (the bars
of tests/test_tiled.py and tests/test_tiled_complex.py)."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.core.blocks import MPSTensor as RefMPSTensor
from block2_preview_tpu.core.expr import qc_term_table
from block2_preview_tpu.core.fcidump import FCIDUMP
from block2_preview_tpu.dmrg.effective import EffectiveHamiltonian2 as RefEff
from block2_preview_tpu.dmrg.environment import MovingEnvironment as RefME
from block2_preview_tpu.dmrg.mps import MPS as RefMPS
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG
from block2_preview_tpu.dmrg.tdvp import TimeEvolution as RefTE
from block2_preview_tpu.ops.davidson import davidson as ref_davidson
from block2_preview_tpu.ops.tiled import TiledExecutor as RefEx
from block2_preview_tpu.ops.tiled import _pack_tiled as ref_pack_tiled
from block2_preview_tpu.utils.ed import ground_state_energy

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg.effective import (
    EffectiveHamiltonian2 as PortEff)
from block2_preview_tpu_torch.dmrg.environment import (
    MovingEnvironment as PortME)
from block2_preview_tpu_torch.dmrg.sweep import DMRG
from block2_preview_tpu_torch.ops import _kernels, chain_mv, exec_bucket
from block2_preview_tpu_torch.runtime import torch_dtype
from block2_preview_tpu_torch.ops.tiled import (TiledExecutor, pack_tiled,
                                                tile_struct, tile_tables,
                                                tiled_matvec_plain)

from test_torch_plans import hubbard_driver

L6 = 6
CPU = torch.device("cpu")


def copy_mps(m):
    return RefMPS(m.info, [RefMPSTensor(t.group, {k: v.copy() for k, v in
                                                  t.blocks.items()})
                           for t in m.tensors], m.center)


def port_eff(mpo, mps, t):
    """The port's host environments and two-site operator at center t of
    a reference MPS."""
    me = PortME(interop.mpo(mpo), interop.mps(mps))
    for s in range(mpo.n_sites - 1, t + 1, -1):
        me.update_right(s)
    for s in range(t):
        me.update_left(s)
    return PortEff(me, t)


@pytest.fixture(scope="module")
def real_site():
    """Center 2 of a Hubbard-L6 MPS after two host steps (the site of
    test_tiled.py::test_tiled_matvec_matches_reference)."""
    drv, mpo = hubbard_driver(L6)
    d = RefDMRG(mpo, drv.get_random_mps(60, seed=5), backend="numpy",
                iprint=0)
    d.update_two_dot(0, True, 60, 0.0, 1e-9)
    d.update_two_dot(1, True, 60, 0.0, 1e-9)
    return RefEff(d.me, 2), port_eff(mpo, d.mps, 2)


@pytest.fixture(scope="module")
def complex_site():
    """Center 2 of the Hubbard-L6 state after one real-time TDVP step
    (dt 0.05): complex site tensors, so complex environments."""
    drv, mpo = hubbard_driver(L6)
    mps = drv.get_random_mps(60, seed=5)
    RefTE(mpo, mps, imaginary=False, iprint=0).solve(1, 0.05, 60)
    me = RefME(mpo, mps)
    me.init_environments()
    for s in range(2):
        me.update_left(s)
    reff = RefEff(me, 2)
    assert reff.dtype == np.complex128
    return reff, port_eff(mpo, mps, 2)


def tile_copy(peff, dtype, T=None):
    """The port's copy of the reference's tiled struct of ``peff`` and its
    LW/RW tile pools on the CPU."""
    s = tile_struct(peff, T)
    _, _, lw, rw = exec_bucket.operator_mats(peff)
    lpool, lb = pack_tiled(lw, s["T"], dtype, CPU)
    rpool, rb = pack_tiled(rw, s["T"], dtype, CPU)
    assert np.array_equal(lb, s["lbases"]) and np.array_equal(rb,
                                                              s["rbases"])
    return s, lpool, rpool


@pytest.mark.parametrize("T", [16, 32])
def test_struct_matches_reference(real_site, T):
    """The host struct and the packed LW/RW tile pools."""
    reff, peff = real_site
    rx = RefEx(reff, dtype=np.float64, T=T)
    got, lpool, rpool = tile_copy(peff, np.float64, T)
    for mine, theirs in ((lpool, rx.lpool), (rpool, rx.rpool)):
        assert mine.dtype == torch.float64
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    ref = interop.tiled_struct(rx)
    assert sorted(ref) == sorted(got)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128,
                                   np.complex64])
@pytest.mark.parametrize("T", [16, 32])
def test_pack_matches_reference(complex_site, dtype, T, monkeypatch):
    """pack_tiled (device gathers, here of 5 tiles each) against the
    reference's _pack_tiled on the same LW and RW matrices (their real
    parts for the real types: a complex matrix into a real pool raises)."""
    from block2_preview_tpu_torch.ops import tiled
    monkeypatch.setattr(tiled, "_PACK_CHUNK", 5 * T * T)
    _, peff = complex_site
    for ops in (peff.LW, peff.RW):
        mats = [mat for _, d in sorted(ops.items())
                for _, mat in sorted(d.items())]
        if np.dtype(dtype).kind == "f":
            with pytest.raises(TypeError, match="same_kind"):
                pack_tiled(mats, T, dtype, CPU)
            mats = [m.real for m in mats]
        pool, bases = pack_tiled(mats, T, dtype, CPU)
        ref_pool, ref_bases = ref_pack_tiled(mats, T, dtype)
        assert np.array_equal(bases, ref_bases)
        assert pool.numpy().dtype == ref_pool.dtype
        assert np.array_equal(pool.numpy(), ref_pool)


def _matvecs(reff, peff, dtype, x, T=None):
    """(the port's copy of the tiled matvec, JAX _tiled_matvec_impl, host
    matvec_np)."""
    s, lpool, rpool = tile_copy(peff, dtype, T)
    xp = np.zeros(s["size_p"] + 1, dtype=dtype)
    xp[:peff.size] = x
    got = tiled_matvec_plain(torch.as_tensor(xp), lpool, rpool,
                             tile_tables(s, CPU), s["nt1"], s["nt2"],
                             s["T"]).numpy()[:peff.size]
    host_dt = np.complex128 if np.dtype(dtype).kind == "c" else np.float64
    jax_ = RefEx(reff, dtype=dtype, T=T).matvec(x)
    return got.astype(host_dt), jax_, peff.matvec_np(x)


@pytest.mark.parametrize("T", [16, 32])
def test_plain_matches_reference_f64(real_site, T):
    reff, peff = real_site
    x = np.random.RandomState(3).standard_normal(peff.size)
    got, jax_, host = _matvecs(reff, peff, np.float64, x, T)
    assert np.max(np.abs(host - reff.matvec_np(x))) < 1e-12
    assert np.max(np.abs(got - host)) < 1e-10
    assert np.max(np.abs(got - jax_)) < 1e-10


def test_plain_matches_reference_f32(real_site):
    reff, peff = real_site
    x = np.random.RandomState(3).standard_normal(peff.size)
    got, jax_, host = _matvecs(reff, peff, np.float32, x)
    scale = np.max(np.abs(host)) + 1.0
    assert np.max(np.abs(got - host)) / scale < 1e-5
    assert np.max(np.abs(got - jax_)) / scale < 1e-5


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-10),
                                       (np.complex64, 1e-5)],
                         ids=["c128", "c64"])
def test_plain_matches_reference_complex(complex_site, dtype, tol):
    reff, peff = complex_site
    assert peff.dtype == np.complex128
    rng = np.random.RandomState(3)
    x = rng.standard_normal(peff.size) + 1j * rng.standard_normal(peff.size)
    got, jax_, host = _matvecs(reff, peff, dtype, x)
    scale = max(np.abs(host).max(), 1.0)
    assert np.max(np.abs(host - reff.matvec_np(x))) < 1e-12
    assert np.max(np.abs(got - host)) / scale < tol
    assert np.max(np.abs(got - jax_)) / scale < tol


def _seeded(peff, dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(peff.size)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(peff.size)
    return x


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5),
                                       (np.complex128, 1e-12),
                                       (np.complex64, 1e-5)],
                         ids=["f64", "f32", "c128", "c64"])
def test_k7_items_match_tiled_matvec_impl(real_site, complex_site, dtype,
                                          tol):
    """K7's plain version on the CPU — the items, flat LW/RW pools and
    flat psi the card reads (exec_bucket.bucket_sigma_plain) — against the
    JAX _tiled_matvec_impl on the same site and seeded vector (the real
    types at the real site, the complex ones on complex environments),
    relative to the largest entry."""
    reff, peff = real_site if np.dtype(dtype).kind == "f" else complex_site
    x = _seeded(peff, dtype, 3)
    ex = TiledExecutor(peff, dtype=dtype, device=CPU)
    assert ex.lpool.dim() == ex.rpool.dim() == 1
    assert ex.lpool.dtype == ex.rpool.dtype == torch_dtype(dtype,
                                                           complex_ok=True)
    xp = torch.as_tensor(ex.pad(x))
    got = ex.matvec_device(xp).numpy()
    assert got.dtype == dtype and got.shape == (ex.size_p,)
    assert not got[peff.size:].any()
    ref = RefEx(reff, dtype=dtype).matvec(x)
    scale = np.abs(ref).max()
    assert np.abs(got[:peff.size] - ref).max() <= tol * scale
    assert np.abs(ex.matvec(x) - ref).max() <= tol * scale


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_k7_chunk_walk_matches_plain(real_site, complex_site, dtype):
    """K7's tables (the items sorted by sigma block, cut into chunks of one
    64 x 64 sigma piece), walked chunk by chunk as the kernel walks them
    (chain_mv.chain_plain), give its plain version's sigma, real and
    complex; the tables are built once per struct."""
    _, peff = real_site if dtype == np.float64 else complex_site
    ex = TiledExecutor(peff, dtype=dtype, device=CPU)
    d = exec_bucket.kernel_tables(ex.struct, CPU)
    assert ex.struct["_chain"]["items"] is exec_bucket.chain_tables(
        ex.struct)["items"]
    assert d["n_chunks"] == len(d["ck"]) > 1
    xp = torch.as_tensor(ex.pad(_seeded(peff, dtype, 4)))
    got = chain_mv.chain_plain(xp, ex.lpool, ex.rpool, d, ex.size_p + 1)
    ref = ex.matvec_device(xp)
    assert got.dtype == ref.dtype
    assert not got[peff.size:].any()
    assert torch.allclose(got[:ex.size_p], ref, rtol=0,
                          atol=1e-12 * float(ref.abs().max()))


def test_structure_cache_reuse(real_site):
    _, peff = real_site
    cache = {}
    ex1 = TiledExecutor(peff, dtype=np.float64, cache=cache, cache_key=1,
                        device=CPU)
    ex2 = TiledExecutor(peff, dtype=np.float64, cache=cache, cache_key=1,
                        device=CPU)
    assert ex1.struct is ex2.struct
    x = np.random.RandomState(0).standard_normal(peff.size)
    assert np.allclose(ex1.matvec(x), ex2.matvec(x))


def test_solve_ground_state_matches_host_davidson(real_site):
    _, peff = real_site
    x0 = peff.flatten(peff.initial_guess())
    x0 /= np.linalg.norm(x0)
    diag = peff.diagonal()
    ex = TiledExecutor(peff, dtype=np.float64, device=CPU)
    th, xv, it = ex.solve_ground_state(x0, diag, conv_thrd=1e-12,
                                       max_iter=100)
    w, v, _ = ref_davidson(peff.matvec_np, diag, x0[:, None], n_roots=1,
                           conv_thrd=1e-12)
    assert abs(th - w[0]) < 1e-8
    assert it > 0 and abs(np.linalg.norm(xv) - 1.0) < 1e-10
    with pytest.raises(TypeError, match="real only"):
        TiledExecutor(peff, dtype=np.complex128, device=CPU) \
            .solve_ground_state(x0, diag)


def test_torch_tiled_dmrg_energy_parity():
    """Hubbard-L6, D=80, 6 sweeps (noise 1e-5 on the first two): the
    port's torch_tiled backend against exact diagonalization and against
    the JAX package's jax_tiled, both to 1e-8 Ha."""
    drv, mpo = hubbard_driver(L6)
    fd = FCIDUMP.hubbard(L6, u=2, t=1)
    eref = ground_state_energy(qc_term_table(fd), fd.n_elec,
                               fd.twos)[0] + fd.const_e

    def run(dmrg):
        e = None
        for sw in range(6):
            res = dmrg.sweep(sw % 2 == 0, bond_dim=80,
                             noise=1e-5 if sw < 2 else 0.0, dav_thrd=1e-9)
            e = float(np.min([np.min(x) for x in res.energies]))
        return e

    e_jax = run(RefDMRG(mpo, drv.get_random_mps(80, seed=5),
                        backend="jax_tiled", iprint=0, dtype=np.float64))
    _kernels.reset_counts()
    port = DMRG(interop.mpo(mpo), interop.mps(drv.get_random_mps(80, seed=5)),
                backend="torch_tiled", device="cpu", iprint=0)
    e = run(port)
    assert abs(e - eref) < 1e-8, (e, eref)
    assert abs(e - e_jax) < 1e-8, (e, e_jax)
    assert port.host_redo_count == 0
    # CPU tensors run the plain version, which launches nothing
    assert _kernels.launch_counts()["K7_tiled"] == 0
