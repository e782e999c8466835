"""Density matrices of the port (block2_preview_tpu_torch/dmrg/expect.py,
npdm.py, npdm_scheme.py and the driver's get_npdm family) against the JAX
package's on the same states, carried by ``interop.mps``: the string
engine (pdm1, pdm2_spatial, pdm3_spatial, the orbital entropies), the
determinant engine (npdm_spatial orders 1-4), and the pooled engine
whose class closes run through kernel K17's plain twin
(``pooled_gram(device="cpu", device_min_flop=0)``) against the
reference's device closes (``device=True``), all to 1e-12; transition
densities, a complex state, the driver's dispatch for each ``algo``, and
the energy from the 1PDM and 2PDM (tests/test_pdm.py's convention).
Hamiltonians are built in code (Hubbard-L6 and -L4, U=2, t=1)."""

import inspect

import numpy as np
import pytest
import torch

from block2_preview_tpu.dmrg import expect as ref_expect
from block2_preview_tpu.dmrg import npdm as ref_npdm
from block2_preview_tpu.dmrg import npdm_scheme as ref_scheme
from block2_preview_tpu.dmrg.mps import MPS as RefMPS
from block2_preview_tpu.dmrg.mps import MPSTensor as RefMPSTensor
from block2_preview_tpu.dmrg.sweep import DMRG as RefDMRG

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.dmrg import expect, npdm, npdm_scheme
from block2_preview_tpu_torch.driver.core import DMRGDriver
from block2_preview_tpu_torch.ops import npdm_gemm

from test_torch_plans import hubbard_driver

TOL = 1e-12


def _solved(L, D, seed, n_sweeps=4):
    """A reference Hubbard-L state: D, seed, sweeps as
    tests/test_npdm_poly.py's _solved_mps; with the reference MPO."""
    drv, mpo = hubbard_driver(L)
    mps = drv.get_random_mps(D, seed=seed)
    RefDMRG(mpo, mps, iprint=0).solve([D] * n_sweeps,
                                      [1e-4] * (n_sweeps - 1) + [0], [1e-9],
                                      n_sweeps=n_sweeps, tol=0)
    return mpo, mps


@pytest.fixture(scope="module")
def l6():
    """Hubbard-L6 ket (D=40, 4 sweeps) and bra (D=30, 2 sweeps, another
    seed), reference MPSs."""
    mpo, ket = _solved(6, 40, 1)
    _, bra = _solved(6, 30, 7, n_sweeps=2)
    return mpo, ket, bra


@pytest.fixture(scope="module")
def l4():
    return _solved(4, 20, 1)


def port_driver(L):
    drv = DMRGDriver()
    drv.initialize_system(n_sites=L, n_elec=L, spin=0)
    return drv


def test_string_engine_matches_reference(l6, l4):
    """pdm1 (also the transition 1PDM), pdm2_spatial with and without the
    singlet shortcut (also transition), and pdm3_spatial (L4)."""
    _, ket, bra = l6
    k, b = interop.mps(ket), interop.mps(bra)
    pairs = [(expect.pdm1(k), ref_expect.pdm1(ket)),
             (expect.pdm1(k, bra=b), ref_expect.pdm1(ket, bra=bra)),
             (expect.pdm2_spatial(k), ref_expect.pdm2_spatial(ket)),
             (expect.pdm2_spatial(k, assume_singlet=False),
              ref_expect.pdm2_spatial(ket, assume_singlet=False)),
             (expect.pdm2_spatial(k, assume_singlet=False, bra=b),
              ref_expect.pdm2_spatial(ket, assume_singlet=False, bra=bra)),
             (expect.pdm3_spatial(interop.mps(l4[1])),
              ref_expect.pdm3_spatial(l4[1]))]
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < TOL


def test_orbital_entropies_match_reference(l6):
    _, ket, _ = l6
    k = interop.mps(ket)
    assert np.abs(expect.orbital_entropy_1site(k)
                  - ref_expect.orbital_entropy_1site(ket)).max() < TOL
    s2, mi = expect.orbital_entropy_2site(k)
    s2r, mir = ref_expect.orbital_entropy_2site(ket)
    assert np.abs(s2 - s2r).max() < TOL and np.abs(mi - mir).max() < TOL
    drv = port_driver(6)
    assert np.abs(drv.get_orbital_entropies(k, ij_symm=2) - s2r).max() < TOL
    assert np.abs(drv.get_orbital_interaction_matrix(k) - mir).max() < TOL


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_determinant_engine_matches_reference(l6, order):
    _, ket, bra = l6
    k, b = interop.mps(ket), interop.mps(bra)
    assert np.abs(npdm.npdm_spatial(k, order)
                  - ref_npdm.npdm_spatial(ket, order)).max() < TOL
    if order <= 2:
        assert np.abs(npdm.npdm_spatial(k, order, bra=b)
                      - ref_npdm.npdm_spatial(ket, order, bra=bra)
                      ).max() < TOL


@pytest.mark.parametrize("order", [1, 2, 3])
def test_pooled_gram_matches_reference_device_closes(l6, order):
    """Every class close through K17's twin against the reference's jit
    closes; the host-BLAS variant (device=None) against device=False;
    the stats split covers the whole run."""
    _, ket, _ = l6
    k = interop.mps(ket)
    G_ref, c_ref = ref_scheme.pooled_gram(ket, order, device=True,
                                          device_min_flop=0)
    st = {}
    G, c = npdm_scheme.pooled_gram(k, order, device="cpu",
                                   device_min_flop=0, stats=st)
    assert np.array_equal(c, c_ref) and G.dtype == np.float64
    assert np.abs(G - G_ref).max() < TOL
    assert st["closes"] and all(cl[5] for cl in st["closes"])
    assert abs(st["pools"] + st["close"] + st["scatter"] - st["total"]) \
        < 1e-9
    G_h, _ = npdm_scheme.pooled_gram(k, order, device=None)
    assert np.abs(G_h - ref_scheme.pooled_gram(ket, order)[0]).max() < TOL


def test_transition_gram_matches_reference(l6):
    _, ket, bra = l6
    k, b = interop.mps(ket), interop.mps(bra)
    G_ref, _ = ref_scheme.pooled_gram(ket, 2, bra=bra, device=True,
                                      device_min_flop=0)
    G, _ = npdm_scheme.pooled_gram(k, 2, bra=b, device="cpu",
                                   device_min_flop=0)
    assert np.abs(G - G_ref).max() < TOL
    got = npdm_scheme.npdm_spatial_poly(k, 2, bra=b, device="cpu")
    assert np.abs(got - npdm.npdm_spatial(k, 2, bra=b)).max() < 1e-10


def test_complex_state_is_carried(l4):
    """A complex state (each site's blocks times a phase) in complex128:
    equal to the reference's device closes; a lower type raises."""
    _, ket = l4
    rng = np.random.RandomState(0)
    cm = RefMPS(ket.info, [RefMPSTensor(t.group, {
        q: v * np.exp(1j * rng.uniform(0, 2 * np.pi))
        for q, v in t.blocks.items()}) for t in ket.tensors], ket.center)
    G_ref, _ = ref_scheme.pooled_gram(cm, 2, dtype=np.complex128,
                                      device=True, device_min_flop=0)
    G, _ = npdm_scheme.pooled_gram(interop.mps(cm), 2, dtype=np.complex128,
                                   device="cpu", device_min_flop=0)
    assert G.dtype == np.complex128 and np.abs(G_ref.imag).max() > 1e-3
    assert np.abs(G - G_ref).max() < TOL
    with pytest.raises(TypeError, match="float64 or complex128"):
        npdm_scheme.pooled_gram(interop.mps(ket), 2, dtype=np.float32,
                                device="cpu")


@pytest.mark.parametrize("order,algo", [(1, "auto"), (2, "auto"),
                                        (3, "auto"), (3, "det"),
                                        (3, "poly"), (4, "auto"),
                                        (4, "poly"), (5, "poly")])
def test_driver_dispatch_matches_reference(l4, order, algo):
    """get_npdm's routing kept exactly (each order and algo on the
    reference's engine), on the L4 state."""
    from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
    _, ket = l4
    ref = RefDriver()
    ref.initialize_system(n_sites=4, n_elec=4, spin=0)
    want = ref.get_npdm(ket, pdm_type=order, algo=algo)
    got = port_driver(4).get_npdm(interop.mps(ket), pdm_type=order,
                                  algo=algo, device="cpu")
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


def test_driver_fronts_and_transitions(l6):
    from block2_preview_tpu.driver.core import DMRGDriver as RefDriver
    _, ket, bra = l6
    k, b = interop.mps(ket), interop.mps(bra)
    ref = RefDriver()
    ref.initialize_system(n_sites=6, n_elec=6, spin=0)
    drv = port_driver(6)
    for got, want in (
            (drv.get_1pdm(k), ref.get_1pdm(ket)),
            (drv.get_2pdm(k), ref.get_2pdm(ket)),
            (drv.get_conventional_1pdm(k), ref.get_conventional_1pdm(ket)),
            (drv.get_trans_1pdm(b, k), ref.get_trans_1pdm(bra, ket)),
            (drv.get_trans_2pdm(b, k), ref.get_trans_2pdm(bra, ket)),
            (drv.get_conventional_trans_2pdm(b, k),
             ref.get_conventional_trans_2pdm(bra, ket)),
            (drv.get_trans_3pdm(b, k, device="cpu"),
             ref.get_trans_3pdm(bra, ket))):
        assert np.abs(got - want).max() < TOL


def test_energy_from_rdms_matches_expectation(l6):
    """E = sum h dm1 + 1/2 sum (ij|kl) dm2[i,k,l,j] (tests/test_pdm.py:63)
    against drv.expectation and the reference's expectation."""
    from block2_preview_tpu.core.fcidump import FCIDUMP
    mpo, ket, _ = l6
    fd = FCIDUMP.hubbard(6, u=2, t=1)
    k = interop.mps(ket)
    drv = port_driver(6)
    dm1 = drv.get_1pdm(k).sum(axis=0)
    dm2 = npdm_scheme.npdm_spatial_poly(k, 2, device="cpu")
    e = fd.const_e + np.einsum("ij,ij->", fd.h1e, dm1) \
        + 0.5 * np.einsum("ijkl,iklj->", fd.g2e, dm2)
    e_mpo = drv.expectation(k, interop.mpo(mpo), k)
    assert abs(e_mpo - ref_expect.mpo_expectation(mpo, ket)) < TOL
    assert abs(e - e_mpo) < 1e-10


def test_refusals_and_defaults(l4):
    """A state that is neither an SZ MPS nor a solved SU2MPSSpec (SU(2)
    states expand to SZ since A6b.3, tests/test_torch_su2_pdm.py) raises,
    and so does a device that is neither a torch device nor a DeviceMesh
    (a mesh closes on row slices since A10, tests/test_torch_shard.py);
    the entry points default to the card."""
    _, ket = l4
    k = interop.mps(ket)
    with pytest.raises(TypeError, match="SU2MPSSpec"):
        port_driver(4).get_npdm(object(), 3, algo="poly")
    with pytest.raises(TypeError, match="DeviceMesh"):
        npdm_scheme.pooled_gram(k, 2, device=object())
    for fn in (npdm_scheme.pooled_gram, npdm_scheme.npdm_spatial_poly,
               DMRGDriver.get_npdm, DMRGDriver.get_4pdm):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            npdm_scheme.pooled_gram(k, 2)


EDGE_N = (1, 4, 8, npdm_gemm.SKINNY_ROWS, npdm_gemm.SKINNY_ROWS + 1, 100,
          200)
EDGE_X = (5, 257, 19545)
EDGE_M = (1, 7, 1542)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_npdm_gemm_twin_and_split(dtype):
    g = torch.Generator().manual_seed(3)
    M = torch.randn(5, 70, generator=g, dtype=torch.float64).to(dtype)
    V = torch.randn(70, 9, generator=g, dtype=torch.float64).to(dtype)
    assert torch.equal(npdm_gemm.npdm_gemm(M, V), M @ V)
    with pytest.raises(TypeError):
        npdm_gemm.npdm_gemm(M.to(torch.complex64 if dtype.is_complex
                                 else torch.float32),
                            V.to(torch.complex64 if dtype.is_complex
                                 else torch.float32))
    with pytest.raises(ValueError):
        npdm_gemm.npdm_gemm(M, V.T)
    cpx = dtype.is_complex
    per16 = 1 if cpx else 2
    for n in EDGE_N:
        for X in EDGE_X:
            for m in EDGE_M:
                p = npdm_gemm.plan(n, X, m, 132, cpx)
                # the regime and its tile, as csrc/npdm_gemm.cu picks them
                if n <= npdm_gemm.SKINNY_ROWS:
                    assert (p.regime, p.cols) == ("skinny", 128 * per16)
                    assert n <= p.rows < 2 * n
                else:
                    assert (p.regime, p.cols) == ("tall", 64 * per16)
                    assert p.rows == (32 if n <= 32 else 64
                                      if n <= 64 or cpx else 128)
                # the tiles cover n x m, the slices X exactly
                rt, ct = -(-n // p.rows), -(-m // p.cols)
                assert p.tiles == rt * ct
                assert (rt - 1) * p.rows < n <= rt * p.rows
                assert (ct - 1) * p.cols < m <= ct * p.cols
                assert p.chunk % 16 == 0
                assert p.ks * p.chunk >= X > (p.ks - 1) * p.chunk
                assert p.ks == 1 or p.chunk >= 256
                assert p.scratch == p.ks * n * m


def _split_sum(M, V, p):
    """K17's arithmetic order over X: each slice's partial, then the sum of
    the slices in a fixed order (slice 0 first), as the second pass adds."""
    parts = [M[:, k * p.chunk:(k + 1) * p.chunk]
             @ V[k * p.chunk:(k + 1) * p.chunk] for k in range(p.ks)]
    out = parts[0].clone()
    for q in parts[1:]:
        out += q
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n", EDGE_N)
def test_npdm_gemm_split_matches_jax_close(n, dtype):
    """The split sum of :func:`_split_sum` over K17's slices (the kernel's
    order of summation) and K17's twin against the reference's device
    close (``_device_gemm``, jnp.matmul at Precision.HIGHEST) on seeded
    values, at the edge shapes small enough for the CPU, to 1e-12 of the
    largest element (the orders of summation differ)."""
    close = ref_scheme._device_gemm()
    rng = np.random.default_rng(n)
    for X in EDGE_X:
        for m in EDGE_M:
            if n * X * m > 2e7:
                continue
            M = rng.standard_normal((n, X))
            V = rng.standard_normal((X, m))
            if dtype == np.complex128:
                M = M + 1j * rng.standard_normal((n, X))
                V = V + 1j * rng.standard_normal((X, m))
            ref = close((0, 0), (X, m), M, V)
            p = npdm_gemm.plan(n, X, m, 132, dtype == np.complex128)
            tM, tV = torch.as_tensor(M), torch.as_tensor(V)
            scale = max(np.abs(ref).max(), 1.0)
            for got in (_split_sum(tM, tV, p), npdm_gemm.npdm_gemm(tM, tV)):
                assert got.shape == ref.shape
                assert np.abs(got.numpy() - ref).max() <= TOL * scale


def test_chip_smoke_k17_edges_on_cpu(capsys, monkeypatch):
    """chip_smoke.py's K17 edge phase at two small shapes on the CPU (the
    twin against itself), and its two gates: a result off the twin fails,
    and so do two launches on the same inputs that differ by one
    rounding."""
    import chip_smoke
    dev = torch.device("cpu")
    chip_smoke.phase_k17_edges(dev, shapes=[(1, 5, 1), (17, 300, 7)])
    assert ("[3 kernels] K17 edges: 2 shapes + 2 on an unaligned V"
            in capsys.readouterr().out)
    real = npdm_gemm.npdm_gemm
    monkeypatch.setattr(npdm_gemm, "npdm_gemm",
                        lambda M, V: real(M, V) * (1 + 1e-9))
    with pytest.raises(SystemExit):
        chip_smoke.phase_k17_edges(dev, shapes=[(4, 257, 7)])
    calls = []

    def drifting(M, V):
        calls.append(1)
        return real(M, V) * (1 + 1e-15 * (len(calls) % 2))

    monkeypatch.setattr(npdm_gemm, "npdm_gemm", drifting)
    with pytest.raises(SystemExit):
        chip_smoke.phase_k17_edges(dev, shapes=[(4, 257, 7)])
    assert "two launches on the same inputs differ" in \
        capsys.readouterr().out
