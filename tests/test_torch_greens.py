"""Green's functions of the port (block2_preview_tpu_torch/dmrg/greens.py:
correction-vector sweeps, every local matvec on the tiled engine, kernel
K7 — its plain version on CPU tensors — or on the host with
backend="numpy") against the JAX package's GreensFunction and
GreensFunctionSquared on an in-code Hubbard-L6 chain at exact bond
dimension (the pattern of tests/test_td_gf.py, whose decks are not in the
repository): the same right-hand side |b> = d_0|gs>, fitted once by the
JAX Linear and carried over with ``interop.mps``, and the same seeded
start; |dG| <= 1e-8 (float32 squared form 1e-4), each form against exact
diagonalization to 1e-7, the local solver family and harmonic
projection, no host matvec on the device backend, and the driver's
defaults."""

import inspect

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg.greens import GreensFunction as RefGF
from block2_preview_tpu.dmrg.greens import GreensFunctionSquared as RefGF2
from block2_preview_tpu.dmrg.linear import Linear as RefLinear
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.core.expr import (build_term_table,
                                                qc_term_table)
from block2_preview_tpu_torch.core.fcidump import FCIDUMP
from block2_preview_tpu_torch.dmrg.greens import (GreensFunction,
                                                  GreensFunctionSquared)
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu_torch.ops import _kernels
from block2_preview_tpu_torch.ops.local_ops import DES_A
from block2_preview_tpu_torch.utils.ed import (sector_indices,
                                               term_table_to_sparse)

from test_torch_plans import hubbard_driver

# a 6-site chain at D=80 and, where K7's plain version runs many matvecs
# (the squared form's CG ~8x the complex form's, ~50x with harmonic
# projection; LSQR) or the JAX jax_tiled reference compiles, a 4-site
# chain at D=16, so that each test stays within seconds; both bond
# dimensions are exact
L6, D6, L4, D4, NSW = 6, 80, 4, 16, 4
OMEGA, ETA = -0.4, 0.05
G_TOL = 1e-8
ED_TOL = 1e-7


def gf_case(L, D):
    """Hubbard-L ground state at bond dimension D (Davidson |r|^2 <
    1e-16: at L=6 omega sits 0.009 Ha below the lowest N-1 state, where G
    moves by ~1e-6 for a ground state converged to |r|^2 < 1e-10),
    |b> = d_0|gs> by the JAX Linear, the seeded correction-vector start's
    maker, and G by exact diagonalization in the N and N-1 sectors."""
    drv, mpo = hubbard_driver(L)
    gs = drv.get_random_mps(D, seed=2)
    e0 = RefDMRG(mpo, gs, iprint=0).solve([D], [1e-4, 1e-5, 0], [1e-16],
                                          n_sweeps=8, tol=0)
    tb = (L - 1, -1, 0)
    b = drv.get_random_mps(D, target=tb, seed=11)
    RefLinear(b, [(drv.get_site_mpo("d", 0), gs)]).solve(D, n_sweeps=NSW)

    def x0():
        return drv.get_random_mps(D, target=tb, seed=13)

    fd = FCIDUMP.hubbard(L, u=2, t=1)
    h = term_table_to_sparse(qc_term_table(fd))
    ixn = sector_indices(L, L, 0)
    ixm = sector_indices(L, L - 1, -1)
    hn = h[np.ix_(ixn, ixn)].toarray() + fd.const_e * np.eye(len(ixn))
    hm = h[np.ix_(ixm, ixm)].toarray() + fd.const_e * np.eye(len(ixm))
    w, v = np.linalg.eigh(hn)
    assert abs(w[0] - e0) < 1e-9
    d0 = term_table_to_sparse(build_term_table(L, [(1.0, [(0, DES_A)])]))
    bvec = d0[np.ix_(ixm, ixn)] @ v[:, 0]
    z = e0 + OMEGA + 1j * ETA
    g_ed = complex(bvec.conj() @ np.linalg.solve(
        z * np.eye(len(ixm)) - hm, bvec))
    return dict(drv=drv, mpo=mpo, gs=gs, e0=e0, b=b, x0=x0, D=D,
                g_ed=g_ed)


@pytest.fixture(scope="module")
def gf6():
    return gf_case(L6, D6)


@pytest.fixture(scope="module")
def gf4():
    return gf_case(L4, D4)


def port_gf(case, cls=GreensFunction, **kw):
    gf = cls(interop.mpo(case["mpo"]), interop.mps(case["b"]),
             interop.mps(case["x0"]()), **kw)
    return gf, gf.solve(case["e0"] + OMEGA, ETA, case["D"], n_sweeps=NSW)


def ref_gf(case, cls=RefGF, **kw):
    return cls(case["mpo"], case["b"], case["x0"](), **kw).solve(
        case["e0"] + OMEGA, ETA, case["D"], n_sweeps=NSW)


@pytest.mark.parametrize("case,ref_kw", [
    ("gf6", {}), ("gf4", {"backend": "jax_tiled", "device_min_size": 0})],
    ids=["L6_ref_numpy", "L4_ref_jax_tiled"])
def test_greens_function_matches_reference(request, case, ref_kw):
    """The complex form on the port's K7 plain version and on its host
    backend against the JAX package's, and against ED."""
    c = request.getfixturevalue(case)
    g_ref = ref_gf(c, **ref_kw)
    _kernels.reset_counts()
    dev, g_dev = port_gf(c, device="cpu")
    host, g_host = port_gf(c, backend="numpy")
    assert abs(g_dev - g_ref) <= G_TOL and abs(g_host - g_ref) <= G_TOL
    assert abs(g_dev - c["g_ed"]) <= ED_TOL, (g_dev, c["g_ed"])
    assert dev.host_matvec_count == 0 and dev.n_matvec > 0
    assert host.host_matvec_count == host.n_matvec > 0
    log = dev.sweep_log
    assert 1 <= len(log) <= NSW and sum(r["matvecs"] for r in log) == \
        dev.n_matvec
    assert all(sum(r["site_matvecs"]) == r["matvecs"] for r in log)
    assert all(len(r["site_matvecs"]) == c["mpo"].n_sites - 1
               for r in log)
    assert all(r["k7_launches"] == 0 for r in log)   # plain version only
    assert abs(log[-1]["value"] - g_dev) == 0


@pytest.mark.parametrize("dtype,tol", [(np.float64, G_TOL),
                                       (np.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_greens_function_squared_matches_reference(gf4, dtype, tol):
    """The real squared form on K7's plain version in float64 and float32
    against the JAX package's (numpy) and against ED."""
    g_ref = ref_gf(gf4, cls=RefGF2)
    gf, g = port_gf(gf4, cls=GreensFunctionSquared, device="cpu",
                    dtype=dtype)
    assert abs(g - g_ref) <= tol, (g, g_ref)
    assert gf.host_matvec_count == 0 and gf.n_matvec > 0
    _, g_host = port_gf(gf4, cls=GreensFunctionSquared, backend="numpy")
    assert abs(g_host - g_ref) <= G_TOL
    if dtype == np.float64:
        assert abs(g - gf4["g_ed"]) <= ED_TOL


@pytest.mark.parametrize("solver", ["gmres", "gcrotmk", "idrs", "lsqr"])
def test_local_solver_family(gf4, solver):
    """Every local solver of the complex form against the JAX package's
    with the same solver (test_td_gf.py:123-139's pattern) and ED."""
    g_ref = ref_gf(gf4, solver=solver)
    gf, g = port_gf(gf4, solver=solver, device="cpu")
    assert abs(g - gf4["g_ed"]) <= ED_TOL
    assert abs(g - g_ref) <= G_TOL, (solver, g, g_ref)
    assert gf.host_matvec_count == 0


def test_harmonic_projection(gf4):
    """n_harmonic_projection=2: harmonic Davidson + deflated CG on the
    squared operator, against the JAX package's and ED."""
    g_ref = ref_gf(gf4, cls=RefGF2, n_harmonic_projection=2)
    gf, g = port_gf(gf4, cls=GreensFunctionSquared, device="cpu",
                    n_harmonic_projection=2)
    assert abs(g - g_ref) <= G_TOL
    assert abs(g - gf4["g_ed"]) <= ED_TOL
    assert gf.host_matvec_count == 0


@pytest.mark.parametrize("squared", [False, True],
                         ids=["complex", "squared"])
def test_driver_greens_function(gf4, squared):
    """DMRGDriver.greens_function (Linear fit of d_0|gs>, then the sweeps)
    against the JAX driver's, complex and squared."""
    drv, mpo, gs, e0, D = (gf4[k] for k in ("drv", "mpo", "gs", "e0", "D"))
    port = DMRGDriver()
    port.initialize_system(n_sites=L4, n_elec=L4, spin=0)
    g_ref = drv.greens_function(mpo, gs, e0, "d", 0, OMEGA, ETA, D,
                                n_sweeps=NSW, squared=squared)
    g = port.greens_function(interop.mpo(mpo), interop.mps(gs), e0, "d", 0,
                             OMEGA, ETA, D, n_sweeps=NSW, squared=squared,
                             device="cpu")
    assert abs(g - g_ref) <= G_TOL
    assert port._last_gf.host_matvec_count == 0


def test_greens_function_defaults_to_cuda(gf4):
    """greens_function and both forms pick "cuda" and the tiled engine
    unless asked otherwise; without a card that raises (no fallback).
    device_min_size is not carried."""
    for fn in (DMRGDriver.greens_function, GreensFunction.__init__,
               GreensFunctionSquared.__init__):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["backend"].default == "torch_tiled"
        assert "device_min_size" not in params
    args = (interop.mpo(gf4["mpo"]), interop.mps(gf4["b"]),
            interop.mps(gf4["x0"]()))
    with pytest.raises(ValueError, match="unknown local solver"):
        GreensFunction(*args, solver="bicg", device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GreensFunction(*args)
