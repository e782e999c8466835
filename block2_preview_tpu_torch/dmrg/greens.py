"""Dynamical Green's functions via correction-vector (DDMRG++) sweeps.

Copied from block2_preview_tpu/dmrg/greens.py:31-274 (reference
src/dmrg/sweep_algorithm.hpp:3239 Linear in EquationTypes::GreensFunction
and GreensFunctionSquared mode, src/dmrg/effective_functions.hpp:40
greens_function and :292 greens_function_squared, the local solvers of
iterative_matrix_functions.hpp; the pyblock2 driver's greens_function,
core.py:6923).

``GreensFunction`` computes X(z) = <b| (z - H)^{-1} |b> by optimizing a
complex correction-vector MPS |x> two sites at a time with a local linear
solve of (z - H_eff) x_loc = b_loc; ``GreensFunctionSquared`` solves the
real, positive-definite (A^2 + eta^2) u = b with A = H - omega instead and
forms X from u and A u, optionally deflating interior eigenvectors of the
squared operator (harmonic Davidson + deflated CG).

Two backends, as ``dmrg/tdvp.py``'s time evolution:

* ``backend="torch_tiled"`` (default) on ``device`` (default "cuda"; the
  CPU only when asked for): host environments and host LW/RW, and every
  matvec of the local solves on the tiled engine
  (``ops/tiled.TiledExecutor``, kernel K7), keyed ``(type, t)`` in a
  struct cache and freed after each site: complex128 for
  ``GreensFunction``, the ``dtype`` argument (float64 or float32) for the
  squared form.  ``host_matvec_count`` stays 0.  The reference sends
  centers under ``device_min_size`` = 4096 unknowns to the host matvec;
  that is the TPU's dispatch economics and is not carried: every center
  runs on K7.
* ``backend="numpy"``: every matvec on the host (``matvec_np``), the
  oracle.

The environments stay host maps on both: ``me_h`` carries the complex
correction vector against the Hamiltonian, ``me_b`` the complex |x>
against the real |b> through the identity MPO.  ``n_matvec`` counts the
local operator's matvecs; ``sweep_log`` keeps, a sweep, the K7 launches,
the matvecs (and each site's), the wall time and its split: host
environment blocking, LW/RW assembly, struct, pool packing + upload,
index tables, the local solve (matvecs included) and decimation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Dict, List

import numpy as np

from ..ops import _kernels
from ..ops.davidson import harmonic_davidson
from ..ops.krylov import cg_solve, gmres_solve
from ..ops.solvers import deflated_cg, gcrotmk, idrs, lsqr
from .effective import EffectiveHamiltonian2
from .environment import MovingEnvironment
from .linear import identity_mpo
from .mpo import MPO
from .mps import MPS
from .sweep import split_backward_update, split_forward_update

_SOLVERS = ("gmres", "gcrotmk", "idrs", "lsqr")


@dataclass
class GFTimings:
    """Wall-clock seconds per part of a Green's-function sweep."""
    blk: float = 0.0       # host environment blocking
    asm: float = 0.0       # host LW/RW assembly (effective operators)
    struct: float = 0.0    # tiled task struct (build or cache lookup)
    pack: float = 0.0      # LW/RW pool packing + upload
    tables: float = 0.0    # struct index tables: derivation + upload
    solve: float = 0.0     # local linear solve, matvecs included
    dm: float = 0.0        # decimation

    def snapshot(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class _CorrectionVector:
    """What both Green's-function forms share: the two moving
    environments, the backend's matvec, the decimation of a site and the
    sweep loop."""

    TAG = "gf"

    def __init__(self, h_mpo: MPO, b: MPS, x: MPS, iprint: int,
                 backend: str, device, dtype):
        if backend not in ("torch_tiled", "numpy"):
            raise ValueError(f"unknown backend '{backend}' "
                             "(torch_tiled | numpy)")
        self.h_mpo = h_mpo
        self.b = b
        self.x = x
        self.iprint = iprint
        self.backend = backend
        self.dtype = np.dtype(dtype)
        if backend == "numpy":
            self.device = None
        else:
            from ..runtime import resolve_device
            self.device = resolve_device(device)
        self._tiled_cache: Dict = {}
        self.timings = GFTimings()
        self.n_matvec = 0
        self.host_matvec_count = 0
        self.sweep_log: List[Dict] = []
        t0 = time.perf_counter()
        self.me_h = MovingEnvironment(h_mpo, x)
        self.me_h.init_environments()
        self.me_b = MovingEnvironment(identity_mpo(h_mpo), b, bra=x)
        self.me_b.init_environments()
        self.timings.blk += time.perf_counter() - t0

    def _effs(self, t: int):
        t0 = time.perf_counter()
        eff_h = EffectiveHamiltonian2(self.me_h, t)
        eff_b = EffectiveHamiltonian2(self.me_b, t)
        self.timings.asm += time.perf_counter() - t0
        return eff_h, eff_b

    def _matvec_for(self, eff, t):
        """(matvec, executor or None) of the local Hamiltonian: K7 in the
        solver's type on the device backend, ``matvec_np`` on the host.
        Both count into ``n_matvec``."""
        if self.device is None:
            def mv(v):
                self.n_matvec += 1
                self.host_matvec_count += 1
                return eff.matvec_np(v)
            return mv, None
        from ..ops.tiled import TiledExecutor
        ex = TiledExecutor(eff, dtype=self.dtype, cache=self._tiled_cache,
                           cache_key=(type(eff).__name__, t),
                           device=self.device)
        self.timings.struct += ex.t_struct
        self.timings.pack += ex.t_pack
        self.timings.tables += ex.t_tables

        def mv(v):
            self.n_matvec += 1
            return ex.matvec(v)
        return mv, ex

    def _split(self, t: int, forward: bool, eff_h, psis, weights,
               bond_dim: int) -> None:
        """Decimate the site's wavefunctions into |x> and move both
        environments past it."""
        tm = self.timings
        t0 = time.perf_counter()
        if forward:
            a_t, centers, _ = split_forward_update(
                eff_h, psis, weights, 0.0, bond_dim)
            self.x.tensors[t] = a_t
            self.x.tensors[t + 1] = centers[0]
        else:
            b_t, centers, _ = split_backward_update(
                eff_h, psis, weights, 0.0, bond_dim)
            self.x.tensors[t + 1] = b_t
            self.x.tensors[t] = centers[0]
        t1 = time.perf_counter()
        tm.dm += t1 - t0
        for me in (self.me_h, self.me_b):
            if forward:
                me.update_left(t)
                me.invalidate_right(t + 1)
            else:
                me.update_right(t + 1)
                me.invalidate_left(t)
        tm.blk += time.perf_counter() - t1

    def _sweep(self, forward: bool, update) -> complex:
        """One pass over the chain; ``update(t, forward)`` returns the
        site's value of X."""
        before = self.timings.snapshot()
        k7 = _kernels.KERNELS["K7_tiled"].launches
        nmv0 = self.n_matvec
        t_pass = time.perf_counter()
        L = self.h_mpo.n_sites
        per_site = []
        val = 0.0j
        for t in (range(L - 1) if forward else range(L - 2, -1, -1)):
            n0 = self.n_matvec
            val = update(t, forward)
            per_site.append(self.n_matvec - n0)
        after = self.timings.snapshot()
        self.sweep_log.append(dict(
            {k: after[k] - before[k] for k in after},
            forward=forward, wall=time.perf_counter() - t_pass,
            k7_launches=_kernels.KERNELS["K7_tiled"].launches - k7,
            matvecs=self.n_matvec - nmv0, site_matvecs=per_site,
            value=val))
        return val

    def _solve(self, update, n_sweeps: int, tol: float) -> complex:
        """Sweeps until X moves less than ``tol`` (relative)."""
        forward = True
        last = None
        val = 0.0j
        for isw in range(n_sweeps):
            val = self._sweep(forward, update)
            if self.iprint >= 1:
                print(f"{self.TAG} sweep {isw:3d} {'F' if forward else 'B'} "
                      f"G = {val.real:+.10f} {val.imag:+.10f}i")
            if last is not None and abs(val - last) < tol * max(abs(val),
                                                                 1.0):
                break
            last = val
            forward = not forward
        return val


class GreensFunction(_CorrectionVector):
    """X(z) = <b|(z - H)^{-1}|b> with a complex correction vector."""

    TAG = "gf"

    def __init__(self, h_mpo: MPO, b: MPS, x: MPS, iprint: int = 0,
                 solver: str = "gmres", backend: str = "torch_tiled",
                 device="cuda"):
        """h_mpo: Hamiltonian MPO (const_e included in the solve);
        b: right-hand-side MPS (e.g. c_j|gs> from a site-MPO multiply);
        x: initial correction-vector MPS (same target as b);
        solver: local linear solver — gmres | gcrotmk | idrs | lsqr
        (the reference cycles GCROT(m,k)/IDR(s)/LSQR,
        sweep_algorithm.hpp Linear solver_type)."""
        if solver not in _SOLVERS:
            raise ValueError(f"unknown local solver '{solver}' "
                             f"({' | '.join(_SOLVERS)})")
        self.solver = solver
        super().__init__(h_mpo, b, x, iprint, backend, device,
                         np.complex128)

    def update_two_dot(self, t: int, forward: bool, z: complex,
                       bond_dim: int, solve_tol: float) -> complex:
        eff_h, eff_b = self._effs(t)
        rhs_blocks = eff_b.matvec_blocks(eff_b.initial_guess())
        rhs = eff_h.ket_space.flatten(rhs_blocks, dtype=np.complex128)
        const = self.h_mpo.const_e
        base_mv, ex = self._matvec_for(eff_h, t)

        def amat(v):
            return z * v - (base_mv(v) + const * v)

        x0 = eff_h.flatten(eff_h.initial_guess()).astype(np.complex128)
        t0 = time.perf_counter()
        if self.solver == "gcrotmk":
            sol, _ = gcrotmk(amat, rhs, x0=x0, tol=solve_tol)
        elif self.solver == "idrs":
            sol, _ = idrs(amat, rhs, x0=x0, tol=solve_tol)
        elif self.solver == "lsqr":
            zc = np.conj(z) - const

            def amat_h(v):
                return zc * v - base_mv(v)

            sol, _ = lsqr(amat, amat_h, rhs, tol=solve_tol)
        else:
            sol, _ = gmres_solve(amat, rhs, x0=x0, tol=solve_tol)
        self.timings.solve += time.perf_counter() - t0
        if ex is not None:
            ex.free()
        val = complex(np.vdot(rhs, sol))
        self._split(t, forward, eff_h, [eff_h.unflatten(sol)], [1.0],
                    bond_dim)
        return val

    def solve(self, omega: float, eta: float, bond_dim: int,
              n_sweeps: int = 6, tol: float = 1e-8,
              solve_tol: float = 1e-10) -> complex:
        """X(omega + i*eta) = <b|(omega + i*eta - H)^{-1}|b>."""
        z = omega + 1j * eta
        return self._solve(
            lambda t, fw: self.update_two_dot(t, fw, z, bond_dim, solve_tol),
            n_sweeps, tol)


class GreensFunctionSquared(_CorrectionVector):
    """Real-arithmetic Green's function via the squared operator
    (reference src/dmrg/effective_functions.hpp:292
    EffectiveFunctions::greens_function_squared, used by Linear in
    EquationTypes::GreensFunctionSquared mode, sweep_algorithm.hpp:3239).

    With A = H - omega (H including const_e),
        (omega + i*eta - H)^{-1} = -(A + i*eta) / (A^2 + eta^2),
    so a single positive-definite REAL solve
        (A^2 + eta^2) u = b
    yields X = -<b|A u> - i*eta*<b|u>.  Everything stays in a real type:
    K7 runs in ``dtype`` (float64 or float32).

    n_harmonic_projection > 0 deflates that many interior eigenvectors
    of the squared operator (harmonic Davidson) before a deflated-CG
    solve (reference :355-382).
    """

    TAG = "gf2"

    def __init__(self, h_mpo: MPO, b: MPS, x: MPS, iprint: int = 0,
                 n_harmonic_projection: int = 0,
                 backend: str = "torch_tiled", dtype=np.float64,
                 device="cuda"):
        if np.dtype(dtype).kind != "f":
            raise TypeError(f"the squared form is real (got {dtype})")
        self.nhp = n_harmonic_projection
        super().__init__(h_mpo, b, x, iprint, backend, device, dtype)

    def update_two_dot(self, t: int, forward: bool, omega: float,
                       eta: float, bond_dim: int, solve_tol: float
                       ) -> complex:
        eff_h, eff_b = self._effs(t)
        rhs = eff_h.ket_space.flatten(
            eff_b.matvec_blocks(eff_b.initial_guess()))
        shift = self.h_mpo.const_e - omega
        base_mv, ex = self._matvec_for(eff_h, t)

        def amat(v):
            return base_mv(v) + shift * v

        def op(v):
            return amat(amat(v)) + (eta * eta) * v

        aa = eff_h.diagonal() + shift
        aa = aa * aa + eta * eta
        x0 = eff_h.flatten(eff_h.initial_guess())
        nx = np.linalg.norm(x0)
        x0 = None if nx < 1e-14 else x0 / max(nx, 1e-14)
        t0 = time.perf_counter()
        if self.nhp > 0:
            rng = np.random.RandomState(7)
            hx0 = rng.standard_normal((rhs.shape[0],
                                       min(self.nhp, rhs.shape[0])))
            _, ws, _ = harmonic_davidson(op, aa, hx0, 0.0,
                                         n_roots=hx0.shape[1],
                                         conv_thrd=1e-4, max_iter=200)
            u, _ = deflated_cg(op, rhs, ws, x0=x0, tol=solve_tol)
        else:
            u, _ = cg_solve(op, rhs, x0=x0, tol=solve_tol,
                            maxiter=5000, diag=aa)
        au = amat(u)
        self.timings.solve += time.perf_counter() - t0
        if ex is not None:
            ex.free()
        val = complex(-np.dot(rhs, au), -eta * np.dot(rhs, u))
        # the correction-vector MPS carries the imaginary part -eta*u;
        # the real part A*u enters the density matrix so the truncated
        # basis supports both (reference Linear keeps real_bra alongside
        # the imag bra, sweep_algorithm.hpp GreensFunctionSquared mode)
        psis = [eff_h.unflatten(-eta * u), eff_h.unflatten(au)]
        self._split(t, forward, eff_h, psis, [0.5, 0.5], bond_dim)
        return val

    def solve(self, omega: float, eta: float, bond_dim: int,
              n_sweeps: int = 6, tol: float = 1e-8,
              solve_tol: float = 1e-10) -> complex:
        """X(omega + i*eta) = <b|(omega + i*eta - H)^{-1}|b> (same
        convention as GreensFunction.solve)."""
        return self._solve(
            lambda t, fw: self.update_two_dot(t, fw, omega, eta, bond_dim,
                                              solve_tol),
            n_sweeps, tol)
