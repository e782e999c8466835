"""The port's SU(2) bookkeeping and blocking against the JAX package:
recoupling coefficients (block2_preview_tpu_torch/core/clebsch_gordan.py,
dmrg/su2_spin.coupled_factor) over a grid of doubled spins, multiplet
fusion (core/su2.py), the spin-adapted QC term table and its compiled MPO
entries (dmrg/su2_qc.py) on seeded integrals, and their ground states in
several (N, 2S) sectors against ED, and the SU(2) blocking plans
(ops/su2blk.py) with kernel K5's plain version on them against the JAX
``build_su2_blocking`` and ``execute_blocking_v2``; the cached-plan
refresh that keeps later sweeps off stale rotation matrices."""

import itertools

import numpy as np
import pytest
import torch

from block2_preview_tpu.core import clebsch_gordan as ref_cg
from block2_preview_tpu.core.expr import qc_term_table as ref_qc_tt
from block2_preview_tpu.core.fcidump import FCIDUMP as RefFCIDUMP
from block2_preview_tpu.core import su2 as ref_su2
from block2_preview_tpu.dmrg import su2_qc as ref_qc
from block2_preview_tpu.dmrg.su2_fermion import \
    SU2FermionDMRG as RefSU2
from block2_preview_tpu.dmrg.su2_spin import \
    coupled_factor as ref_coupled
from block2_preview_tpu.ops import su2blk as ref_blk
from block2_preview_tpu.ops.blockv2 import \
    execute_blocking_v2 as ref_exec_v2
from block2_preview_tpu.utils.ed import sector_indices, term_table_to_sparse

from block2_preview_tpu_torch.core import clebsch_gordan as cg
from block2_preview_tpu_torch.core import su2
from block2_preview_tpu_torch.dmrg import su2_qc
from block2_preview_tpu_torch.dmrg.su2_qc import su2_qc_dmrg
from block2_preview_tpu_torch.dmrg.su2_fermion import SU2FermionDMRG
from block2_preview_tpu_torch.dmrg.su2_spin import coupled_factor
from block2_preview_tpu_torch.ops import su2blk
from block2_preview_tpu_torch.ops.blockv2 import execute_blocking_v2

import test_torch_plans  # noqa: F401  (pins torch to one thread)

EXACT = 1e-14
E_TOL = 1e-8       # Ha, the compiled MPO on the device path against ED
K5_TOL = {np.float64: 1e-12, np.float32: 1e-5}
TJ = range(0, 5)      # doubled spins 0 .. 2


def seeded_qc(K, seed=7):
    """Dense symmetric integrals from a numpy seed (the pattern of
    tests/test_su2_qc.py:_random_system)."""
    rng = np.random.RandomState(seed)
    h1e = rng.standard_normal((K, K))
    h1e = (h1e + h1e.T) / 2
    g2e = rng.standard_normal((K, K, K, K)) * 0.2
    g2e = g2e + g2e.transpose(1, 0, 2, 3)
    g2e = g2e + g2e.transpose(0, 1, 3, 2)
    g2e = g2e + g2e.transpose(2, 3, 0, 1)
    return h1e, g2e


def _triads():
    return [(a, b, c) for a, b, c in itertools.product(TJ, TJ, TJ)
            if c <= a + b and c >= abs(a - b) and (a + b + c) % 2 == 0]


def _ms(tj):
    return range(-tj, tj + 1, 2)


@pytest.mark.parametrize("fn", ["wigner_3j", "clebsch_gordan"])
def test_cg_and_3j_equal_reference(fn):
    n = 0
    for a, b, c in _triads():
        for ma, mb, mc in itertools.product(_ms(a), _ms(b), _ms(c)):
            got = getattr(cg, fn)(a, b, c, ma, mb, mc)
            ref = getattr(ref_cg, fn)(a, b, c, ma, mb, mc)
            assert abs(got - ref) <= EXACT, (fn, a, b, c, ma, mb, mc)
            n += 1
    assert n > 100


def test_6j_racah_transpose_equal_reference():
    for args in itertools.product(TJ, repeat=6):
        assert abs(cg.wigner_6j(*args) - ref_cg.wigner_6j(*args)) <= EXACT
        assert abs(cg.racah(*args) - ref_cg.racah(*args)) <= EXACT
    for args in itertools.product(TJ, repeat=3):
        assert abs(cg.transpose_cg(*args)
                   - ref_cg.transpose_cg(*args)) <= EXACT


def test_9j_and_coupled_factor_equal_reference():
    """Every 9j / coupled factor the engine asks for: bond spins 0..4,
    site multiplets 0/1, operator ranks 0/1/2."""
    n = 0
    for ja, jb, jap, jbp in itertools.product(range(5), (0, 1), range(5),
                                              (0, 1)):
        for k1, k2 in itertools.product((0, 1, 2), (0, 1)):
            for j, k, jp in itertools.product(range(6), (0, 1, 2), range(6)):
                args = (ja, jb, j, k1, k2, k, jap, jbp, jp)
                r9 = ref_cg.wigner_9j(*args)
                assert abs(cg.wigner_9j(*args) - r9) <= EXACT, args
                assert abs(coupled_factor(*args)
                           - ref_coupled(*args)) <= EXACT, args
                n += r9 != 0.0
    assert n > 150


def test_fusion_and_site_quanta_equal_reference():
    for a, b in itertools.product([(1, 1, 0), (2, 0, 1), (3, 3, 2)],
                                  [(0, 0, 0), (1, 1, 1), (2, 2, 0)]):
        assert su2.su2_fuse(a, b) == ref_su2.su2_fuse(a, b)
    assert su2.su2_site_basis_quanta(3) == ref_su2.su2_site_basis_quanta(3)
    x = su2.su2_tensor_product(su2.su2_site_info(1), su2.su2_site_info(2))
    y = ref_su2.su2_tensor_product(ref_su2.su2_site_info(1),
                                   ref_su2.su2_site_info(2))
    assert dict(x.items()) == dict(y.items())
    for n in range(1, 9):
        assert su2.count_spin_multiplets(n) == \
            ref_su2.count_spin_multiplets(n)


def test_pattern_factors_equal_reference():
    for pattern, nr in ((((0,), (1,)), 2), (((0, 1),), 2),
                        (((0,), (1,), (2,), (3,)), 4),
                        (((0, 3), (1, 2)), 4), (((0,), (1, 2), (3,)), 4)):
        got = su2_qc._pattern_chains(pattern, nr)
        ref = ref_qc._pattern_chains(pattern, nr)
        assert [g[:2] for g in got] == [r[:2] for r in ref]
        assert np.abs(np.array([g[2] for g in got])
                      - np.array([r[2] for r in ref])).max() <= EXACT


@pytest.mark.parametrize("K", [4, 6])
def test_compile_su2_entries_equal_reference(K):
    """Seeded K=6 integrals: the same term table, then the same entries,
    symbols, dN, ranks and reduced-operator registry."""
    h1e, g2e = seeded_qc(K)
    tt = su2_qc.qc_su2_term_table(h1e, g2e, 0.25)
    rt = ref_qc.qc_su2_term_table(h1e, g2e, 0.25)
    o, c = tt.finalize()
    ro, rc = rt.finalize()
    assert np.array_equal(o, ro) and np.array_equal(c, rc)
    got = su2_qc.compile_su2_entries(tt)
    ref = ref_qc.compile_su2_entries(rt)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert got[2] == ref[2] and got[3] == ref[3]
    assert set(got[4]) == set(ref[4])
    for name, (red, k, dn) in ref[4].items():
        g = got[4][name]
        assert g[1:] == (k, dn) and np.abs(g[0] - red).max() <= EXACT


@pytest.fixture(scope="module")
def qc6():
    """Seeded K=6 integrals and their many-body Hamiltonian (every
    sector)."""
    K = 6
    h1e, g2e = seeded_qc(K, seed=3)
    fd = RefFCIDUMP(n_sites=K, n_elec=K, twos=0,
                    orb_sym=np.zeros(K, dtype=np.int64), h1e=h1e, g2e=g2e)
    return h1e, g2e, term_table_to_sparse(ref_qc_tt(fd))


@pytest.mark.parametrize("sector", [(6, 0), (5, 1), (6, 2), (7, 3)])
def test_seeded_qc_sectors_match_ed(qc6, sector):
    """Seeded K=6 integrals in several (N, 2S) sectors on the device path
    (twins; D=40 multiplets, above the widest FCI bond of 35) against ED
    in the (N, 2Sz = 2S) sector, whose lowest state has S = Sz here."""
    ne, tj = sector
    h1e, g2e, h = qc6
    ix = sector_indices(6, ne, tj)
    e_ed = float(np.linalg.eigvalsh(h[np.ix_(ix, ix)].toarray())[0])
    d = su2_qc_dmrg(h1e, g2e, 0.11, n_elec=ne, twos=tj, bond_dim=40,
                    device="cpu")
    e = d.solve(n_sweeps=8, tol=1e-10, noises=[1e-5, 0], dav_thrds=[1e-11])
    assert abs(e - (e_ed + 0.11)) <= E_TOL, (sector, e, e_ed)
    assert d.host_matvec_count == 0


# ---------------------------------------------------------------------------
# blocking plans and K5's plain version on them
# ---------------------------------------------------------------------------

def engines(K=6, n_elec=6, twos=2, D=40):
    """The port's and the JAX package's host engines on the same seeded
    system: the same random start, so the same site tensors."""
    h1e, g2e = seeded_qc(K, seed=5)
    tt = ref_qc.qc_su2_term_table(h1e, g2e, 0.0)
    ents, ns, dn, rk, reg = ref_qc.compile_su2_entries(tt)
    kw = dict(target=(n_elec, twos), bond_dim=D, ops=reg, ranks=rk)
    port = SU2FermionDMRG(K, ents, ns, dn, backend="numpy", **kw)
    ref = RefSU2(K, ents, ns, dn, backend="numpy", **kw)
    return port, ref


@pytest.fixture(scope="module")
def solved():
    """The pair after three sweeps each (real rotation matrices), then
    every left and right environment filled in."""
    port, ref = engines()
    for eng in (port, ref):
        eng.solve(n_sweeps=3, tol=0, noises=[1e-4, 0], dav_thrds=[1e-12])
        for u in range(eng.L - 1, 1, -1):
            if eng.renvs[u] is None:
                eng.renvs[u] = eng._right_contract(u)
        for u in range(eng.L - 1):
            if eng.lenvs[u + 1] is None:
                eng.lenvs[u + 1] = eng._left_contract(u)
    return port, ref


def _bond_envs(eng, t, direction):
    """The environment a blocking step at (t, direction) reads, or None
    where the last sweep left it stale."""
    return eng.lenvs[t] if direction == "left" else eng.renvs[t + 1]


PLAN_FIELDS = ("it", "ef", "coef", "cum1", "cum2", "cum3", "g1", "g2",
               "g3")


@pytest.mark.parametrize("direction", ["left", "right"])
def test_build_su2_blocking_equals_reference(solved, direction):
    port, ref = solved
    n = 0
    for t in range(1, port.L - 1):
        env = _bond_envs(ref, t, direction)
        if env is None:
            continue
        got = su2blk.build_su2_blocking(port, t, direction, env)
        exp = ref_blk.build_su2_blocking(ref, t, direction, env)
        assert (got is None) == (exp is None)
        if got is None:
            continue
        p, pin, pout = got
        r, rin, rout = exp
        for f in PLAN_FIELDS:
            assert np.array_equal(getattr(p, f), getattr(r, f)), (t, f)
        assert (p.T, p.B, p.nt1, p.ntp, p.ncap, p.left) == \
            (r.T, r.B, r.nt1, r.ntp, r.ncap, r.left)
        assert np.array_equal(p.bra_pool[1], r.bra_pool[1])
        for a, b in zip(p.bra_pool[0], r.bra_pool[0]):
            assert np.array_equal(a, b)
        assert pin.layout == rin.layout and pin.total == rin.total
        assert pout == rout
        assert p._dev == {}
        n += 1
    assert n >= 3


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("direction", ["left", "right"])
def test_k5_twin_on_su2_plans_matches_reference(solved, direction, dtype):
    """K5's plain version (the CPU tensor path of execute_blocking_v2) on
    SU(2) plans against the JAX execute_blocking_v2 on the reference's
    plans, the same packed pools, and the host contraction."""
    import jax.numpy as jnp
    port, ref = solved
    n = 0
    for t in range(1, port.L - 1):
        env = _bond_envs(ref, t, direction)
        if env is None:
            continue
        got = su2blk.build_su2_blocking(port, t, direction, env)
        if got is None:
            continue
        p, pin, pout = got
        r, rin, _ = ref_blk.build_su2_blocking(ref, t, direction, env)
        pool = pin.pack(env, dtype=dtype)
        out = execute_blocking_v2(p, torch.as_tensor(pool)).numpy()
        exp = np.asarray(ref_exec_v2(r, jnp.asarray(pool), dtype=dtype))
        scale = max(np.abs(exp).max(), 1.0)
        assert out.dtype == dtype and out.shape == exp.shape
        assert np.abs(out - exp).max() <= K5_TOL[dtype] * scale, t
        assert not out[p.ncap - 1]       # the zero sentinel stays zero
        n += 1
        if dtype is np.float64:
            envs = su2blk.unpack_env(out, pout)
            for s, blocks in _host_contract(ref, t, direction).items():
                for k, b in blocks.items():
                    g = envs.get(s, {}).get(k, np.zeros_like(b))
                    assert np.abs(g - b).max() <= 1e-12 * scale
    assert n >= 3


def _host_contract(eng, t, direction):
    """The reference engine's interpreted contraction at (t, direction)
    from the environment the plan read."""
    if direction == "left":
        return eng._left_contract(t)
    return eng._right_contract(t)


def test_refresh_drops_stale_site_pools(solved):
    """A cached plan given new site values must launch on them: the
    refreshed plan equals a plan built afresh, and the old uploaded pools
    are gone (without the drop every later sweep contracts with the
    first sweep's rotation matrices)."""
    port, _ = solved
    t = 2
    env = port.lenvs[t]
    plan, pin, pout = su2blk.build_su2_blocking(port, t, "left", env)
    pool = torch.as_tensor(pin.pack(env))
    first = execute_blocking_v2(plan, pool).clone()
    assert any(k[0] == "pools" for k in plan._dev if isinstance(k, tuple))
    rng = np.random.RandomState(3)
    A = {k: b + 0.1 * rng.standard_normal(b.shape)
         for k, b in port.tensors[t].items()}
    saved = port.tensors[t]
    try:
        su2blk.refresh_su2_sites(plan, A)
        assert not any(k[0] == "pools" for k in plan._dev
                       if isinstance(k, tuple))
        again = execute_blocking_v2(plan, pool)
        port.tensors[t] = A
        fresh, _, _ = su2blk.build_su2_blocking(port, t, "left", env)
        want = execute_blocking_v2(fresh, pool)
    finally:
        port.tensors[t] = saved
    assert (again - first).abs().max() > 1e-3
    assert (again - want).abs().max() <= 1e-12 * want.abs().max()
    bad = dict(A)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError):
        su2blk.refresh_su2_sites(plan, bad)


def test_su2_env_meta_roundtrip(solved):
    port, _ = solved
    env = port.lenvs[3]
    meta = su2blk.SU2EnvMeta(env)
    rmeta = ref_blk.SU2EnvMeta(env)
    assert meta.layout == rmeta.layout
    pool = meta.pack(env)
    assert np.array_equal(pool, rmeta.pack(env))
    back = meta.unpack(pool)
    for s, blocks in env.items():
        for k, b in blocks.items():
            if b.any():
                assert np.array_equal(back[s][k], b)
