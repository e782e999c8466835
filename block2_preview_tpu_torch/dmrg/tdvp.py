"""Time evolution: two-site TDVP with Krylov exponentials.

Copied from block2_preview_tpu/dmrg/tdvp.py:29-152 (reference
src/dmrg/sweep_algorithm_td.hpp:794: 1/2-site TDVP with per-site
EffectiveHamiltonian::expo_apply -> iterative_matrix_functions.hpp:1571
expo_krylov), imaginary time (f64) and real time (complex128).

Second-order symmetric integrator: a forward pass evolves each two-site block
by dt/2 with a -dt/2 one-site back-evolution between blocks, the backward
pass mirrors it, so one (F,B) sweep pair advances the state by dt.

Two backends:

* ``backend="torch_tiled"`` (default) on ``device`` (default "cuda"; the
  CPU only when asked for): host environments and host LW/RW, and every
  Krylov matvec — two-site steps, one-site back-evolutions and the
  per-step energy at the left edge — on the tiled engine
  (``ops/tiled.TiledExecutor``, kernel K7): complex128 in real time, f64
  in imaginary time.  ``host_matvec_count`` stays 0.
* ``backend="numpy"``: every matvec on the host (``matvec_np``), the
  oracle.

``initial`` holds (energy, |psi|) at t = 0, measured when ``solve`` first
runs; ``discarded_weight`` sums the discarded weights of every decimation
(the reference drops them); ``timings`` splits the wall time into host
environment blocking, LW/RW assembly, struct build, pool packing +
upload, index tables, Krylov (matvecs included) and decimation, and
``sweep_log`` keeps
that split, the K7 launches and the matvecs of each pass.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Dict, List

import numpy as np

from ..ops import _kernels
from ..ops.krylov import expmv
from .effective import EffectiveHamiltonian1, EffectiveHamiltonian2
from .environment import MovingEnvironment
from .mpo import MPO
from .mps import MPS
from .sweep import split_backward_update, split_forward_update


@dataclass
class TDVPTimings:
    """Wall-clock seconds per part of a time step."""
    blk: float = 0.0       # host environment blocking
    asm: float = 0.0       # host LW/RW assembly (effective Hamiltonians)
    struct: float = 0.0    # tiled task struct (build or cache lookup)
    pack: float = 0.0      # LW/RW tile packing + upload
    tables: float = 0.0    # struct index tables: derivation + upload
    krylov: float = 0.0    # Lanczos exponentials, matvecs included
    dm: float = 0.0        # decimation

    def snapshot(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class TimeEvolution:
    def __init__(self, mpo: MPO, mps: MPS, imaginary: bool = False,
                 normalize=None, iprint: int = 0,
                 backend: str = "torch_tiled", device="cuda"):
        if backend not in ("torch_tiled", "numpy"):
            raise ValueError(f"unknown backend '{backend}' "
                             "(torch_tiled | numpy)")
        self.mpo = mpo
        self.mps = mps
        self.imaginary = imaginary
        self.normalize = imaginary if normalize is None else normalize
        self.iprint = iprint
        self.backend = backend
        if backend == "numpy":
            self.device = None
        else:
            from ..runtime import resolve_device
            self.device = resolve_device(device)
        self._tiled_cache: Dict = {}
        self.timings = TDVPTimings()
        t0 = time.perf_counter()
        self.me = MovingEnvironment(mpo, mps)
        self.me.init_environments()
        self.timings.blk += time.perf_counter() - t0
        self.initial = None
        self.energies: List[float] = []
        self.norms: List[float] = []
        self.n_matvec = 0
        self.host_matvec_count = 0
        self.discarded_weight = 0.0
        self.sweep_log: List[Dict] = []

    def _scale(self, dt: float) -> complex:
        return -dt if self.imaginary else -1j * dt

    def _eff2(self, t):
        t0 = time.perf_counter()
        eff = EffectiveHamiltonian2(self.me, t)
        self.timings.asm += time.perf_counter() - t0
        return eff

    def _expmv(self, eff, t, v, scale):
        mv, ex = self._matvec_for(eff, t)
        t0 = time.perf_counter()
        out, nmv = expmv(mv, v, scale)
        self.timings.krylov += time.perf_counter() - t0
        if ex is not None:
            ex.free()
        self.n_matvec += nmv
        if self.normalize:
            out = out / np.linalg.norm(out)
        return out

    def sweep(self, forward: bool, dt: float, bond_dim: int) -> None:
        """One pass; evolves the state by dt/2 (second-order splitting)."""
        tm = self.timings
        before = tm.snapshot()
        k7 = _kernels.KERNELS["K7_tiled"].launches
        nmv0 = self.n_matvec
        dw_sum = 0.0
        t_pass = time.perf_counter()
        L = self.mpo.n_sites
        half = self._scale(dt) / 2.0
        rng = range(L - 1) if forward else range(L - 2, -1, -1)
        for t in rng:
            eff = self._eff2(t)
            psi1 = self._expmv(eff, t, eff.flatten(eff.initial_guess()),
                               half)
            blocks = eff.unflatten(psi1)
            last = (t == L - 2) if forward else (t == 0)
            t0 = time.perf_counter()
            if forward:
                a_t, centers, dw = split_forward_update(
                    eff, [blocks], [1.0], 0.0, bond_dim)
                tm.dm += time.perf_counter() - t0
                self.mps.tensors[t] = a_t
                self.mps.tensors[t + 1] = centers[0]
                t0 = time.perf_counter()
                self.me.update_left(t)
                self.me.invalidate_right(t + 1)
                tm.blk += time.perf_counter() - t0
                s = t + 1
            else:
                b_t, centers, dw = split_backward_update(
                    eff, [blocks], [1.0], 0.0, bond_dim)
                tm.dm += time.perf_counter() - t0
                self.mps.tensors[t + 1] = b_t
                self.mps.tensors[t] = centers[0]
                t0 = time.perf_counter()
                self.me.update_right(t + 1)
                self.me.invalidate_left(t)
                tm.blk += time.perf_counter() - t0
                s = t
            dw_sum += dw
            if not last:
                t0 = time.perf_counter()
                eff1 = EffectiveHamiltonian1(self.me, s)
                tm.asm += time.perf_counter() - t0
                v1 = self._expmv(eff1, s,
                                 eff1.tensor_to_vec(self.mps.tensors[s]),
                                 -half)
                self.mps.tensors[s] = eff1.vec_to_tensor(v1)
        self.discarded_weight += dw_sum
        after = tm.snapshot()
        self.sweep_log.append(dict(
            {k: after[k] - before[k] for k in after},
            forward=forward, wall=time.perf_counter() - t_pass,
            k7_launches=_kernels.KERNELS["K7_tiled"].launches - k7,
            matvecs=self.n_matvec - nmv0, discarded=dw_sum))

    def _matvec_for(self, eff, t):
        """(matvec, executor or None) of one effective Hamiltonian: the
        tiled engine on the device backend, ``matvec_np`` on the host."""
        if self.device is None:
            def mv(x):
                self.host_matvec_count += 1
                return eff.matvec_np(x)
            return mv, None
        from ..ops.tiled import TiledExecutor
        dt_ = np.float64 if self.imaginary else np.complex128
        ex = TiledExecutor(eff, dtype=dt_, cache=self._tiled_cache,
                           cache_key=(type(eff).__name__, t),
                           device=self.device)
        self.timings.struct += ex.t_struct
        self.timings.pack += ex.t_pack
        self.timings.tables += ex.t_tables
        return ex.matvec, ex

    def measure(self):
        """(energy, |psi|) of the two-site center at the left edge, with
        the matvec on the backend's engine."""
        eff = self._eff2(0)
        psi = eff.flatten(eff.initial_guess())
        nrm = np.linalg.norm(psi)
        mv, ex = self._matvec_for(eff, 0)
        sig = mv(psi)
        if ex is not None:
            ex.free()
        e = (np.vdot(psi, sig).real / max(nrm * nrm, 1e-300)
             + self.mpo.const_e)
        return float(e), float(nrm)

    def solve(self, n_steps: int, dt: float, bond_dim: int) -> float:
        """n_steps steps of length dt; returns the final energy expectation
        (reference sweep_algorithm_td.hpp TimeEvolution::solve)."""
        if self.initial is None:
            self.initial = self.measure()
        for istep in range(n_steps):
            self.sweep(True, dt, bond_dim)
            self.sweep(False, dt, bond_dim)
            if not self.imaginary and self.mpo.const_e != 0.0:
                # the MPO constant (nuclear repulsion) contributes a
                # global phase e^{-i E_const dt} that the local
                # effective-H exponentials never see
                ph = np.exp(self._scale(dt) * self.mpo.const_e)
                T0 = self.mps.tensors[0]
                for k in list(T0.blocks):
                    T0.blocks[k] = T0.blocks[k] * ph
            # energy/norm measurement at the left edge
            e, nrm = self.measure()
            self.energies.append(e)
            self.norms.append(nrm)
            if self.iprint >= 1:
                print(f"te step {istep:4d} t = {dt * (istep + 1):8.3f} "
                      f"E = {e:.12f}  |psi| = {nrm:.10f}")
        return self.energies[-1] if self.energies else np.nan
