"""The port's spin-adapted engine (block2_preview_tpu_torch/dmrg/
su2_fermion.py) against the JAX package's SU2FermionDMRG and exact
diagonalization: ``_SU2EffAdapter`` with kernel K7's plain version
against the JAX ``TiledExecutor`` at one centre; Hubbard-L6 sweep by
sweep on ``backend="torch_tiled"``/``device="cpu"`` (K5's and K7's twins
at every step) against the JAX ``jax_tiled`` and ``numpy`` engines (over
four sweeps, so the cached blocking plans are hit with new site values);
singlet embedding and two
roots on the device path (the patterns of tests/test_su2_multiroot.py:84
and :103, on an in-code Hubbard-L6, whose deck is not in the
repository)."""

import numpy as np
import pytest
import torch

from block2_preview_tpu.core.expr import qc_term_table as ref_qc_tt
from block2_preview_tpu.core.fcidump import FCIDUMP as RefFCIDUMP
from block2_preview_tpu.dmrg.su2_fermion import \
    SU2FermionDMRG as RefSU2
from block2_preview_tpu.dmrg.su2_fermion import \
    _SU2EffAdapter as RefAdapter
from block2_preview_tpu.dmrg.su2_fermion import \
    hubbard_su2_entries as ref_hub_entries
from block2_preview_tpu.dmrg.su2_qc import \
    compile_su2_entries as ref_compile
from block2_preview_tpu.dmrg.su2_qc import \
    qc_su2_term_table as ref_tt
from block2_preview_tpu.ops.tiled import TiledExecutor as RefTiled
from block2_preview_tpu.utils.ed import sector_indices, term_table_to_sparse

from block2_preview_tpu_torch.dmrg.su2_fermion import (
    SU2FermionDMRG, SU2OverlapEnvs, _SU2EffAdapter, hubbard_su2_dmrg,
    hubbard_su2_entries, su2_one_electron_entries)
from block2_preview_tpu_torch.ops import _kernels
from block2_preview_tpu_torch.ops.tiled import TiledExecutor

from test_torch_su2_core import seeded_qc

E_TOL = 1e-8       # Ha, per sweep against the JAX engines and ED
SIGMA_TOL = 1e-12  # relative, K7's twin against the JAX TiledExecutor
SCHED = dict(noises=[1e-4, 1e-5, 0], dav_thrds=[1e-12])


def hubbard_mpo(L=6):
    """The SU(2) QC MPO of the in-code Hubbard chain (t=1, U=2)."""
    fd = RefFCIDUMP.hubbard(L, t=1.0, u=2.0)
    return fd, ref_compile(ref_tt(fd.h1e, fd.g2e, fd.const_e))


def hubbard_ed(L=6, n_elec=6, twos=0):
    """Lowest eigenvalue of the (N, 2Sz = 2S) sector."""
    fd = RefFCIDUMP(n_sites=L, n_elec=n_elec, twos=0,
                    orb_sym=np.zeros(L, dtype=np.int64),
                    h1e=RefFCIDUMP.hubbard(L, t=1.0, u=2.0).h1e,
                    g2e=RefFCIDUMP.hubbard(L, t=1.0, u=2.0).g2e)
    h = term_table_to_sparse(ref_qc_tt(fd))
    ix = sector_indices(L, n_elec, twos)
    return float(np.linalg.eigvalsh(h[np.ix_(ix, ix)].toarray())[0])


def _eng(cls, mpo, L=6, target=(6, 0, 0), D=100, **kw):
    ents, ns, dn, rk, reg = mpo
    return cls(L, ents, ns, dn, target=target, bond_dim=D, iprint=0,
               ops=reg, ranks=rk, **kw)


def _sweeps(eng, n):
    out = []
    for i in range(n):
        out.append(eng.sweep(eng._forward_next, dav_thrd=1e-12,
                             noise=SCHED["noises"][min(i, 2)]))
    return np.array(out)


@pytest.fixture(scope="module")
def hub6():
    _, mpo = hubbard_mpo(6)
    return mpo, hubbard_ed(6)


def test_hubbard_torch_tiled_sweeps_match_jax_and_ed(hub6):
    """Per sweep, four sweeps: the port's device path (twins) against
    the JAX jax_tiled engine and the JAX host engine; the last against
    ED.  Every blocking step launched K5's path, every sigma product
    K7's, none on the host."""
    mpo, e_ed = hub6
    port = _eng(SU2FermionDMRG, mpo, device="cpu")
    jt = _eng(RefSU2, mpo, backend="jax_tiled")
    jt.exec_threshold = 256
    host = _eng(RefSU2, mpo)
    e_port, e_jt, e_host = (_sweeps(x, 4) for x in (port, jt, host))
    assert np.abs(e_port - e_jt).max() <= E_TOL, (e_port, e_jt)
    assert np.abs(e_port - e_host).max() <= E_TOL, (e_port, e_host)
    assert abs(e_port[-1] - e_ed) <= E_TOL
    assert port.host_matvec_count == 0 and port.n_matvec > 0
    assert port.n_blocking > 0 and port.n_blocking_empty == 0
    assert len(port.sweep_log) == 4
    assert sum(s["matvecs"] for s in port.sweep_log) == port.n_matvec
    # the later sweeps ran on cached plans with refreshed site values
    assert port.n_blocking > port.n_plan_builds >= port.L - 2


def test_numpy_backend_matches_jax_host_engine(hub6):
    mpo, _ = hub6
    port = _eng(SU2FermionDMRG, mpo, backend="numpy")
    ref = _eng(RefSU2, mpo)
    e_port, e_ref = _sweeps(port, 3), _sweeps(ref, 3)
    assert np.abs(e_port - e_ref).max() <= 1e-10
    assert port.host_matvec_count == port.n_matvec > 0
    assert port.n_blocking == 0 and port.device is None


def test_adapter_k7_twin_matches_jax_tiled_executor():
    """One centre of a converged seeded K=6 QC state: the recoupling
    factors folded into the LW copies, K7's plain version over them
    against the JAX TiledExecutor on the JAX adapter, and the host GEMM
    matvec."""
    h1e, g2e = seeded_qc(6, seed=5)
    mpo = ref_compile(ref_tt(h1e, g2e, 0.0))
    eng = _eng(SU2FermionDMRG, mpo, target=(6, 2, 0), D=40,
               backend="numpy")
    eng.solve(n_sweeps=2, noises=[1e-4], dav_thrds=[1e-10])
    t = 2
    for u in range(eng.L - 1, t + 1, -1):
        if eng.renvs[u] is None:
            eng.renvs[u] = eng._right_contract(u)
    for u in range(t):
        if eng.lenvs[u + 1] is None:
            eng.lenvs[u + 1] = eng._left_contract(u)
    keys, dims, offsets, size, fl, fr, matvec, diag = eng._effective(t)
    LW, RW, ranks = eng._last_ops
    ad = _SU2EffAdapter(keys, dims, offsets, size, LW, RW, ranks, eng.dn)
    rad = RefAdapter(keys, dims, offsets, size, LW, RW, ranks, eng.dn)
    assert ad.triples == rad.triples and ad.triples
    for k in rad.LW:
        assert np.array_equal(ad.LW[k][0], rad.LW[k][0])
    x = np.random.RandomState(9).standard_normal(size)
    ex = TiledExecutor(ad, device="cpu")
    got = ex.matvec(x)
    ref = RefTiled(rad, dtype=np.float64).matvec(x)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= SIGMA_TOL * scale
    assert np.abs(got - matvec(x)).max() <= SIGMA_TOL * scale
    ex32 = TiledExecutor(ad, dtype=np.float32, device="cpu")
    assert np.abs(ex32.matvec(x) - ref).max() <= 1e-5 * scale


def test_singlet_embedding_matches_direct_target(hub6):
    """tests/test_su2_multiroot.py:84 on the in-code Hubbard-L6: the
    fictitious boundary multiplet (2, 2, 0) with target (8, 0, 0) against
    the direct (6, 2, 0) target, both on the device path (twins), and the
    JAX host engine's direct energy."""
    mpo, _ = hub6
    kw = dict(tol=1e-10, n_sweeps=10, **SCHED)
    e_dir = _eng(SU2FermionDMRG, mpo, target=(6, 2, 0), D=120,
                 device="cpu").solve(**kw)
    e_emb = _eng(SU2FermionDMRG, mpo, target=(8, 0, 0), D=120,
                 device="cpu", left_vacuum=(2, 2, 0)).solve(**kw)
    e_ref = _eng(RefSU2, mpo, target=(6, 2, 0), D=120).solve(**kw)
    assert abs(e_dir - e_emb) <= 1e-9
    assert abs(e_dir - e_ref) <= E_TOL
    assert abs(e_dir - hubbard_ed(6, 6, 2)) <= E_TOL


def test_two_roots_on_the_device_path(hub6):
    """tests/test_su2_multiroot.py:103 on the in-code Hubbard-L6: two
    state-averaged roots, the host Davidson around K7's matvec at every
    centre, against the JAX engine's roots; then the statespecific
    refinement of root 1 projected against root 0."""
    mpo, _ = hub6
    kw = dict(tol=1e-10, n_sweeps=10, **SCHED)
    port = _eng(SU2FermionDMRG, mpo, D=120, n_roots=2, device="cpu")
    ref = _eng(RefSU2, mpo, D=120, n_roots=2)
    e, er = port.solve(**kw), ref.solve(**kw)
    assert np.abs(np.asarray(e) - np.asarray(er)).max() <= 1e-7
    assert port.host_matvec_count == 0
    e0 = _eng(SU2FermionDMRG, mpo, D=120, device="cpu",
              init_tensors=port.extract_root(0))
    ee0 = e0.solve(n_sweeps=8, tol=1e-11, noises=[1e-5, 0],
                   dav_thrds=[1e-10])
    e1 = _eng(SU2FermionDMRG, mpo, D=120, device="cpu",
              init_tensors=port.extract_root(1), proj_tensors=[e0.tensors])
    ee1 = e1.solve(n_sweeps=10, tol=1e-11, noises=[1e-5, 0],
                   dav_thrds=[1e-10])
    assert abs(ee0 - er[0]) <= 1e-8 and abs(ee1 - er[1]) <= 1e-7
    ov = SU2OverlapEnvs(e0, e1.tensors).ensure_ro(0)
    assert abs(ov.get((0, 0, 0), np.zeros((1, 1)))[0, 0]) < 1e-5


def test_hubbard_entries_and_one_electron_entries_equal_reference():
    assert hubbard_su2_entries(1.0, 2.0) == ref_hub_entries(1.0, 2.0)
    from block2_preview_tpu.dmrg.su2_fermion import \
        su2_one_electron_entries as ref_one
    tmat = np.random.RandomState(2).standard_normal((5, 5))
    tmat = tmat + tmat.T
    eps = np.linspace(-1, 1, 5)
    assert su2_one_electron_entries(tmat, 1.5, eps) == \
        ref_one(tmat, 1.5, eps)


def test_hubbard_su2_dmrg_and_launch_counts():
    """hubbard_su2_dmrg on the twins: the Hubbard-L6 energy of ED, and no
    kernel counted on CPU tensors (the counts are K5's and K7's launches
    on the card only)."""
    _kernels.reset_counts()
    d = hubbard_su2_dmrg(6, 1.0, 2.0, n_elec=6, twos=0, bond_dim=100,
                         device="cpu")
    e = d.solve(n_sweeps=6, tol=1e-10, **SCHED)
    assert abs(e - hubbard_ed(6)) <= E_TOL
    assert _kernels.launch_counts()["K5_block"] == 0
    assert _kernels.launch_counts()["K7_tiled"] == 0


def test_backends_and_device_refusals():
    ents, ns, dn = hubbard_su2_entries(1.0, 2.0)
    for bad in ("torch_resident", "torch", "torch_device", "torch_stacked",
                "jax_tiled"):
        with pytest.raises(ValueError, match="spin-adapted"):
            SU2FermionDMRG(4, ents, ns, dn, target=(4, 0), backend=bad,
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SU2FermionDMRG(4, ents, ns, dn, target=(4, 0))
