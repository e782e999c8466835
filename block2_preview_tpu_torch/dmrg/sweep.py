"""DMRG sweeps of the port: ground states, state-averaged roots,
state-specific excited states and one-site sweeps.

Copied from block2_preview_tpu/dmrg/sweep.py (reference
src/dmrg/sweep_algorithm.hpp:71: update_two_dot at :811, update_one_dot
:183, sweep :2551, solve :3032) and cut to SZ Hermitian sweeps.
``n_roots`` > 1 averages the density matrix over the roots with
``weights`` (equal by default); ``proj_mpss`` projects previously
converged MPSs out of every local solve, or with ``proj_weights`` adds
the penalty w_i |phi_i><phi_i| (``dmrg/projection.py``; the reference's
sweep.py:382-457, 595-708).
One class, six paths:

* ``backend="numpy"``: the reference's host path unchanged — host
  environment maps, host LW/RW assembly, the host Davidson and the host
  noise term.  It is the oracle the device paths are held to.
* ``backend="torch_resident"`` (default) on ``device`` (default "cuda";
  the CPU only when asked for): every two-site step runs through
  :class:`ResidentSite` — environment pools and blocking (K5 + K3), LW/RW
  mix (K3 + K4), diagonal (K2), sigma matvec (K1) inside the device
  Davidson, and the perturbative-noise density matrix (K6).  Only the
  center wavefunction, the initial guess, the small noise density matrix
  and scalars cross between host and device: the reference's jax_resident
  contract (ops/resident.py:1166-1170).  ``host_env_materialized`` and
  ``host_ops_downloads`` count the device-to-host unpacks of environments
  and of LW/RW; both stay 0 on this path.  One root and no projection,
  as the reference's ``use_res`` (sweep.py:721-722); anything else raises.
* ``backend="torch"`` and ``backend="torch_device"`` on ``device``: the
  reference's ``jax`` and ``jax_device`` (sweep.py:463-464, 685-705) —
  host LW/RW and host noise, and the local solve as the host Davidson
  (``n_roots``, projection) around the bucketed sigma matvec
  (``BucketExecutor.matvec``, kernel K8).  ``torch_device`` also blocks
  every environment on the device (kernel K9; the environments stay host
  maps between steps) and, in float32 with one root and no projection,
  runs the whole Davidson on the device around K8 (the reference's
  ``_dav_jit``).  Every site goes through K8: the reference's small-site
  host shortcut (``eff.size < 4096``, sweep.py:655-659) is not copied, so
  K8's launches equal the matvecs (in float32 the Ritz guard below adds
  one per root and site).  Real types only.
* ``backend="torch_stacked"`` on ``device``: the reference's jax_stacked
  (sweep.py:465-467, 696-705) — stacked environment pools on the device,
  blocked by the bucket engine (``ops/stacked.py``, kernels K10 + K11),
  unpacked to host maps for the host LW/RW assembly (counted in
  ``host_env_materialized``), and the local solve as ``backend="torch"``
  does it: the host Davidson (roots, projection) around K8.  Real types
  only.
* ``backend="torch_tiled"`` on ``device``: the reference's jax_tiled
  (sweep.py:465-471, 660-684) — for a real MPO and state, stacked
  environment pools on the device blocked by ``B2TPU_STK_ENGINE``
  ("tiled" by default: K5 + K3; "tiled_v1": K12; "bucket": K10 + K11) and
  unpacked for the host LW/RW; for a complex one (decided when the solver
  is built, as the reference's pools fall back there, environment.py:
  448-456) host environment maps.  Host noise; one root without
  projection solves with the device Davidson around the tiled matvec
  (``TiledExecutor.solve_ground_state``, kernel K7), more roots or a
  projection with the host Davidson around ``TiledExecutor.matvec`` — at
  every site (no small-site host shortcut).

``torch_resident`` honours ``B2TPU_STK_ENGINE`` the same way (the
reference's jax_resident, sweep.py:468-471), and ``B2TPU_MIX`` as
jax_resident does: its LW/RW mix runs on mix v4 (default, K3 + K4; v3
where a plan has no v4 form), v3 (``B2TPU_MIX=3``, K13 + K14) or v2
(``B2TPU_MIX=2``, K15).  ``sweep_log``'s ``mix_plan`` is the host time
spent building mix plans, a part of Teff.

Guards carried from the reference (sweep.py:752-790): in float32 a Ritz
pair whose residual ``||Hx - th x||`` exceeds 1.0 Ha is rejected, as is a
site energy below B2TPU_E_FLOOR when that is set.  On a CUDA device a
rejected pair raises, naming the site, theta and the failed check.  Only
on CPU tensors is the site redone by the host solver in float64; each
such redo adds one to ``host_redo_count``.

Density-matrix decimation with perturbative noise follows the reference
(moving_environment.hpp density_matrix / split_density_matrix;
effective_hamiltonian.hpp:253 perturbative_noise).

One-site sweeps (``solve(..., twodot_to_onedot=n)``: sweeps n, n+1, ...
update one site at a time; ``last_site_1site=True``: the last site of
each two-site sweep gets a one-site update; the reference's sweep.py:
391-418, 893-1160) take one root without projection.  A forward step
solves on ``EffectiveHamiltonian1``, a backward one on the right-fused
``EffectiveHamiltonian1R``, routed as the two-site step: "numpy" on the
host, "torch_tiled" on the tiled executor (K7), "torch", "torch_device"
and "torch_stacked" on the bucketed one (K8), keyed (kind, site).
"torch_resident" has no one-site engine (the reference's jax_resident
falls through to the host Davidson there) and raises.  The one-site
noise is the density-matrix term on the host LW/RW; the SVD
decimation waits for ``decomp_type`` (ROADMAP).

Operator sharding (``mesh``, a 1-D ``torch.distributed`` DeviceMesh, the
reference's ``DMRG(mesh=...)``, sweep.py:386, 477-482; ``torch_resident``
only): every rank runs this sweep on its own device
(``runtime.rank_device``); the v2/v3 blocking and the sigma matvec run
each rank's share of their task groups (K21, K20) and sum the partials
with ``all_reduce``.  The kernels that do not shard (K2, K3/K4, K6), and
the card's dense algebra, round differently on each rank, so the ranks
take rank 0's basis vector for every matvec, its stop decisions and its
eigenpair inside the Davidson (``ResidentSite.solve_ground_state``), and
rank 0's decimated site tensors, energies and discarded weight after each
site: they stay in lockstep and hold bitwise-equal states and energies.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.symmetry import QN
from ..ops.davidson import davidson
from .effective import (EffectiveHamiltonian1, EffectiveHamiltonian1R,
                        EffectiveHamiltonian2, Key2)
from .environment import MovingEnvironment
from .mpo import MPO
from .mps import MPS, MPSTensor

# f32 Ritz guard: a spurious f32 Ritz pair has a residual at least its
# eigenvalue error (Ha-scale); a true one sits at the f32 convergence floor
_GUARD_HA = 1.0
# density-matrix eigenvalues at or below this share of the trace are
# dropped (the reference's default trunc_cutoff)
_TRUNC_CUTOFF = 1e-16


@dataclass
class SweepTimings:
    """Per-phase wall-clock accumulators (reference sweep_algorithm.hpp
    teig/teff/tdm/tblk counters printed at :3128-3180)."""
    teff: float = 0.0       # effective-H set-up (spaces, plans, LW/RW, diag)
    teig: float = 0.0       # Davidson / eigensolver
    tdm: float = 0.0        # density matrix (noise term) + decimation
    tblk: float = 0.0       # environment move (blocking)

    def reset(self):
        self.teff = self.teig = self.tdm = self.tblk = 0.0

    def line(self) -> str:
        return (f"Teff = {self.teff:8.2f} | Teig = {self.teig:8.2f} | "
                f"Tdm = {self.tdm:8.2f} | Tblk = {self.tblk:8.2f}")


def _apply_noise(rho: Dict[QN, np.ndarray], rho_n: Dict,
                 noise: float) -> Dict[QN, np.ndarray]:
    """Add the trace-normalized noise density matrix (reference
    moving_environment.hpp density-matrix + noise scaling)."""
    tr = sum(np.trace(v).real for v in rho_n.values())
    if tr > 1e-30:
        for q, v in rho_n.items():
            blk = rho.get(q)
            add = (noise / tr) * v
            rho[q] = add if blk is None else blk + add
    return rho


def _average_rho_forward(eff: EffectiveHamiltonian2,
                         psis: Sequence[Dict[Key2, np.ndarray]],
                         weights: Sequence[float],
                         noise: float,
                         rho_noise: Optional[Dict] = None
                         ) -> Dict[QN, np.ndarray]:
    g, target = eff.g, eff.target
    rho: Dict[QN, np.ndarray] = {}
    for w_r, psi in zip(weights, psis):
        for (qL, qR), b in psi.items():
            acc = rho.get(qL)
            contrib = w_r * (b @ b.conj().T)
            rho[qL] = contrib if acc is None else acc + contrib
    if noise > 0 and rho_noise is not None:
        # device-computed sum_m (W_m psi)(W_m psi)^T (kernel K6)
        return _apply_noise(rho, rho_noise, noise)
    if noise > 0:
        rho_n: Dict[QN, np.ndarray] = {}
        for w_r, psi in zip(weights, psis):
            for m, lw in eff.LW.items():
                xs: Dict[Tuple[QN, QN], np.ndarray] = {}
                for (qLb, qLk), blk in lw.items():
                    pk = (qLk, g.sub(target, qLk))
                    if pk not in psi:
                        continue
                    x = blk @ psi[pk]
                    key = (qLb, pk[1])
                    xs[key] = xs.get(key, 0) + x
                for (qLb, _), x in xs.items():
                    acc = rho_n.get(qLb)
                    contrib = w_r * (x @ x.conj().T)
                    rho_n[qLb] = contrib if acc is None else acc + contrib
        rho = _apply_noise(rho, rho_n, noise)
    return rho


def _average_rho_backward(eff: EffectiveHamiltonian2,
                          psis: Sequence[Dict[Key2, np.ndarray]],
                          weights: Sequence[float],
                          noise: float,
                          rho_noise: Optional[Dict] = None
                          ) -> Dict[QN, np.ndarray]:
    g, target = eff.g, eff.target
    rho: Dict[QN, np.ndarray] = {}
    for w_r, psi in zip(weights, psis):
        for (qL, qR), b in psi.items():
            acc = rho.get(qR)
            contrib = w_r * (b.T @ b.conj())
            rho[qR] = contrib if acc is None else acc + contrib
    if noise > 0 and rho_noise is not None:
        return _apply_noise(rho, rho_noise, noise)
    if noise > 0:
        rho_n: Dict[QN, np.ndarray] = {}
        for w_r, psi in zip(weights, psis):
            for m, rw in eff.RW.items():
                xs: Dict[Tuple[QN, QN], np.ndarray] = {}
                for (qRb, qRk), blk in rw.items():
                    pk = (g.sub(target, qRk), qRk)
                    if pk not in psi:
                        continue
                    x = psi[pk] @ blk.T
                    key = (pk[0], qRb)
                    xs[key] = xs.get(key, 0) + x
                for (_, qRb), x in xs.items():
                    acc = rho_n.get(qRb)
                    contrib = w_r * (x.T @ x.conj())
                    rho_n[qRb] = contrib if acc is None else acc + contrib
        rho = _apply_noise(rho, rho_n, noise)
    return rho


def _decimate(rho: Dict[QN, np.ndarray], bond_dim: int
              ) -> Tuple[Dict[QN, np.ndarray], float]:
    eigs: List[Tuple[float, QN, int]] = []
    vecs: Dict[QN, np.ndarray] = {}
    for q, r in rho.items():
        w, v = np.linalg.eigh(0.5 * (r + r.conj().T))
        vecs[q] = v
        for i, x in enumerate(w):
            eigs.append((float(x.real), q, i))
    eigs.sort(key=lambda z: -z[0])
    total = sum(max(x, 0.0) for x, _, _ in eigs)
    kept: Dict[QN, List[int]] = {}
    kept_w = 0.0
    for (x, q, i) in eigs[:bond_dim]:
        if x <= max(_TRUNC_CUTOFF * max(total, 1e-300), 0.0):
            break
        kept.setdefault(q, []).append(i)
        kept_w += x
    rot: Dict[QN, np.ndarray] = {}
    for q, idxs in kept.items():
        rot[q] = vecs[q][:, idxs]
    dw = max(0.0, (total - kept_w) / max(total, 1e-300))
    return rot, dw


def split_forward_update(eff, psis, weights, noise, bond_dim,
                         rho_noise=None):
    """Decimate psis into a left-canonical site tensor + per-root center
    tensors at t+1.  Returns (A_tensor, center_tensors, dw)."""
    g, target = eff.g, eff.target
    rho = _average_rho_forward(eff, psis, weights, noise,
                               rho_noise=rho_noise)
    rot, dw = _decimate(rho, bond_dim)
    a_blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = {}
    for qL, vmat in rot.items():
        for (ql, qp, off, dl, dp) in eff.fl.maps[qL]:
            a_blocks[(ql, qp, qL)] = vmat[off:off + dl * dp, :] \
                .reshape(dl, dp, -1)
    centers = []
    for psi in psis:
        c_blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = {}
        for qL, vmat in rot.items():
            qR = g.sub(target, qL)
            pk = (qL, qR)
            if pk not in psi:
                continue
            mmat = vmat.conj().T @ psi[pk]
            for (qp, qc2, off, dp, db) in eff.fr.maps[qR]:
                qr2 = g.sub(target, qc2)
                blk = mmat[:, off:off + dp * db].reshape(-1, dp, db)
                key = (qL, qp, qr2)
                c_blocks[key] = c_blocks.get(key, 0) + blk
        centers.append(MPSTensor(g, c_blocks))
    return MPSTensor(g, a_blocks), centers, dw


def split_backward_update(eff, psis, weights, noise, bond_dim,
                          rho_noise=None):
    """Decimate psis into a right-canonical site tensor at t+1 + per-root
    center tensors at t.  Returns (B_tensor, center_tensors, dw)."""
    g, target = eff.g, eff.target
    rho = _average_rho_backward(eff, psis, weights, noise,
                                rho_noise=rho_noise)
    rot, dw = _decimate(rho, bond_dim)
    b_blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = {}
    for qR, vmat in rot.items():
        ql_new = g.sub(target, qR)
        for (qp, qc2, off, dp, db) in eff.fr.maps[qR]:
            qr2 = g.sub(target, qc2)
            b_blocks[(ql_new, qp, qr2)] = vmat[off:off + dp * db, :] \
                .T.reshape(-1, dp, db)
    centers = []
    for psi in psis:
        c_blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = {}
        for qR, vmat in rot.items():
            qL = g.sub(target, qR)
            pk = (qL, qR)
            if pk not in psi:
                continue
            mmat = psi[pk] @ vmat.conj()
            for (ql, qp, off, dl, dp) in eff.fl.maps[qL]:
                blk = mmat[off:off + dl * dp, :].reshape(dl, dp, -1)
                key = (ql, qp, qL)
                c_blocks[key] = c_blocks.get(key, 0) + blk
        centers.append(MPSTensor(g, c_blocks))
    return MPSTensor(g, b_blocks), centers, dw


@dataclass
class SweepResults:
    energies: List[np.ndarray] = field(default_factory=list)
    discarded: List[float] = field(default_factory=list)
    n_matvec: int = 0
    n_flop: float = 0.0      # true (unpadded) sigma-matvec FLOPs


def _eff_flops(eff) -> float:
    """True FLOPs of one host sigma matvec (reference
    BatchGEMMSeq::cumulative_nflop, sweep_algorithm.hpp:3128)."""
    fl = 0
    for (m, lk, pk, rk, ok) in eff.triples:
        a, k = eff.LW[m][lk].shape
        p, n = eff.RW[m][rk].shape
        fl += 2 * a * k * n + 2 * a * n * p
    return float(fl)


class _DeviceEigenRejected(Exception):
    """An eigenpair of CPU tensors failed a guard; the site is redone by
    the host solver."""


_BACKENDS = ("torch_resident", "torch", "torch_device", "torch_stacked",
             "torch_tiled", "numpy")


def _is_real(mpo: MPO, mps: MPS, dtype) -> bool:
    """True when the run's dtype, the MPO's entries and the state's blocks
    are all real."""
    return np.dtype(dtype).kind == "f" and not any(
        np.iscomplexobj(w) for ent in mpo.tensors for w in ent.values()) \
        and not any(np.iscomplexobj(b) for T in mps.tensors
                    for b in T.blocks.values())


class DMRG:
    """SZ two-site DMRG: ground state, state-averaged roots and
    state-specific excited states (reference sweep_algorithm.hpp:71)."""

    def __init__(self, mpo: MPO, mps: MPS, device="cuda",
                 backend: str = "torch_resident", dtype=np.float64,
                 iprint: int = 1, dav_max_iter: int = 200,
                 n_roots: int = 1, weights: Optional[Sequence[float]] = None,
                 proj_mpss: Optional[Sequence[MPS]] = None,
                 proj_weights: Optional[Sequence[float]] = None,
                 mesh=None, mesh_axis: str = "op",
                 last_site_1site: bool = False):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend '{backend}' "
                             f"({' | '.join(_BACKENDS)})")
        self.mpo = mpo
        self.mps = mps
        self.backend = backend
        self.dtype = dtype
        self.iprint = iprint
        self.dav_max_iter = dav_max_iter
        self.n_roots = n_roots
        self.weights = list(weights) if weights is not None \
            else [1.0 / n_roots] * n_roots
        if proj_mpss:
            from .projection import OverlapEnvs
            self._proj = [OverlapEnvs(mps, phi, 1.0) for phi in proj_mpss]
            self._proj_weights = list(proj_weights) if proj_weights \
                else None
            if self._proj_weights is not None and \
                    len(self._proj_weights) != len(self._proj):
                raise ValueError("one proj_weight per proj_mps")
        else:
            self._proj = []
            self._proj_weights = None
        if backend == "torch_resident" and (n_roots != 1 or self._proj):
            raise ValueError("backend='torch_resident' solves one root "
                             "without projection; use backend='torch' or "
                             "'torch_device' for n_roots > 1 or proj_mpss")
        # big-site specialization (reference sweep.py:391, 414-418): in a
        # two-site sweep the last site gets a one-site update
        self.last_site_1site = last_site_1site
        if last_site_1site:
            self._one_site_check()
        if mesh is not None and backend != "torch_resident":
            raise NotImplementedError(
                f"a device mesh shards backend='torch_resident' only (got "
                f"'{backend}'; sharding under the stacked and tiled "
                "backends is roadmap item A)")
        self._group = None
        if mesh is not None:
            from ..parallel.multihost import axis_info
            self._group = axis_info(mesh, mesh_axis)[0]
        # matvecs of sites where this rank owned no unit of the sharded
        # matvec (K20 then does not launch)
        self.idle_matvecs = 0
        self.host_redo_count = 0
        # one dict per sweep: lowest energy, per-root energies, wall s,
        # teff/teig/tdm/tblk, matvecs, kernel launches, blocking transfers,
        # device blocking's plan / exec split, environment unpacks
        self.sweep_log: List[Dict] = []
        if backend == "numpy":
            self.device = None
            self.me = MovingEnvironment(mpo, mps)
        else:
            from ..runtime import rank_device, torch_dtype
            torch_dtype(dtype)
            self.device = rank_device(mesh, device)
            engine = "bucket" if backend == "torch_stacked" else \
                os.environ.get("B2TPU_STK_ENGINE", "tiled")
            real = _is_real(mpo, mps, dtype)
            if backend == "torch_stacked" and not real:
                raise TypeError("backend='torch_stacked' takes real types "
                                "only; backend='torch_tiled' keeps complex "
                                "environments on the host")
            # struct caches keyed (kind, site), as the reference's
            # _res_caches / _tiled_cache / _exec_cache
            self._res_caches: Dict = {}
            self._exec_cache: Dict = {}
            if backend in ("torch_resident", "torch_stacked") or \
                    (backend == "torch_tiled" and real):
                self.me = MovingEnvironment(mpo, mps, device=self.device,
                                            dtype=dtype, stk_engine=engine)
                self.me.mesh, self.me.mesh_axis = mesh, mesh_axis
            else:
                self.me = MovingEnvironment(
                    mpo, mps, blocking_device=(
                        self.device if backend == "torch_device" else None))
        self.me.init_environments()
        self.energies: List[np.ndarray] = []
        self.discarded_weights: List[float] = []
        self.timings = SweepTimings()
        # host time building resident mix plans (part of Teff)
        self.mix_plan_time = 0.0
        # per-root center wavefunction tensors; None means "use the MPS
        # center tensor" (cold start)
        self._center_tensors: Optional[List[MPSTensor]] = None
        self._center_pos = -1

    @property
    def host_env_materialized(self) -> int:
        """Device environment pools unpacked to host maps (downloads)."""
        return self.me.host_env_materialized

    @property
    def host_ops_downloads(self) -> int:
        """Assembled LW/RW pools downloaded to the host."""
        return self.me.host_ops_downloads

    # ------------------------------------------------------------------
    def _initial_guesses(self, eff: EffectiveHamiltonian2, t: int
                         ) -> np.ndarray:
        """One column per root: the center tensors carried from the last
        step (the MPS center at a cold start), random columns from
        RandomState(7) for the roots beyond them (reference
        sweep.py:595-619)."""
        guesses = []
        if self._center_tensors is not None and \
                self._center_pos in (t, t + 1):
            for ct in self._center_tensors:
                g0 = (eff.initial_guess(tensor_l=ct) if self._center_pos == t
                      else eff.initial_guess(tensor_r=ct))
                guesses.append(eff.flatten(g0))
        else:
            guesses.append(eff.flatten(eff.initial_guess()))
        x0 = np.stack(guesses, axis=1)
        rng = np.random.RandomState(7)
        while x0.shape[1] < self.n_roots:
            x0 = np.concatenate(
                [x0, rng.standard_normal((eff.size, 1))], axis=1)
        for r in range(x0.shape[1]):
            nrm = np.linalg.norm(x0[:, r])
            if nrm < 1e-14:
                x0[:, r] = rng.standard_normal(eff.size)
                nrm = np.linalg.norm(x0[:, r])
            x0[:, r] /= nrm
        return x0

    def _proj_vecs(self, eff) -> Optional[list]:
        """Local images of the projector MPSs (not normalized: the
        reference's ors semantics)."""
        if not self._proj:
            return None
        return [p.two_dot_vector(eff) for p in self._proj]

    def _host_davidson(self, matvec, diag, x0, dav_thrd, proj_vecs):
        """The host Davidson (n_roots, projection) around ``matvec``."""
        pv = dict(ortho=proj_vecs, proj_weights=self._proj_weights) \
            if proj_vecs else {}
        return davidson(matvec, diag, x0, n_roots=self.n_roots,
                        conv_thrd=dav_thrd, max_iter=self.dav_max_iter, **pv)

    def _guard(self, matvec, th: float, xv: np.ndarray, t: int):
        """Check the eigenpair of site t against the f32 Ritz-residual
        guard (``matvec``: the device operator on host vectors) and the
        variational floor.  A failure raises RuntimeError on a CUDA device
        and _DeviceEigenRejected on CPU tensors."""
        why = None
        if np.dtype(self.dtype) == np.float32:
            resid = float(np.linalg.norm(matvec(xv) - th * xv))
            if resid > _GUARD_HA:
                why = (f"Ritz residual {resid:.3e} > {_GUARD_HA} Ha "
                       f"(theta {th:.10f})")
        floor = os.environ.get("B2TPU_E_FLOOR")
        if why is None and floor is not None \
                and th + self.mpo.const_e < float(floor):
            why = (f"energy {th + self.mpo.const_e:.10f} below "
                   f"B2TPU_E_FLOOR {float(floor):.10f} (theta {th:.10f})")
        if why is None:
            return
        msg = f"eigenpair of site {t} rejected: {why}"
        if self.device.type != "cpu":
            raise RuntimeError(f"{msg} on {self.device}")
        if self.iprint >= 2:
            print(f"      [guard] {msg}; redoing on the host in f64",
                  flush=True)
        raise _DeviceEigenRejected(msg)

    def _eigen_host(self, t: int, dav_thrd: float):
        """Host path of one site: assembled eff, host Davidson."""
        eff = EffectiveHamiltonian2(self.me, t)
        x0 = self._initial_guesses(eff, t)
        diag = eff.diagonal()
        t1 = time.time()
        w, v, nmv = self._host_davidson(eff.matvec_np, diag, x0, dav_thrd,
                                        self._proj_vecs(eff))
        self._last_flop = _eff_flops(eff) * nmv
        return eff, t1, w, v, nmv, None

    def _eigen_device(self, t: int, noise: float, forward: bool,
                      dav_thrd: float):
        """Device path of one site: ResidentSite, device Davidson, and the
        device noise density matrix when noise > 0."""
        from ..ops.resident import ResidentSite
        eff = EffectiveHamiltonian2(self.me, t, assemble=False)
        rs = ResidentSite(self.me, eff, self.device, dtype=self.dtype,
                          caches=self._res_caches)
        self.mix_plan_time += rs.t_plan
        x0 = self._initial_guesses(eff, t)
        t1 = time.time()
        th, xv, nmv = rs.solve_ground_state(
            x0[:, 0], conv_thrd=dav_thrd,
            max_iter=self.dav_max_iter)
        if rs.shard_units == 0:
            self.idle_matvecs += nmv
        try:
            self._guard(rs.matvec, th, xv, t)
        except _DeviceEigenRejected:
            return self._redo_host(eff, x0, t1, dav_thrd)
        self._last_flop = float(rs.ex.struct["flops"]) * nmv
        return eff, t1, np.array([th]), xv[:, None], nmv, rs

    def _redo_host(self, eff, x0, t1, dav_thrd):
        """CPU tensors only: the host solver redoes a rejected site in
        f64."""
        self.host_redo_count += 1
        eff.ensure_assembled()
        w, v, nmv = self._host_davidson(eff.matvec_np, eff.diagonal(), x0,
                                        dav_thrd, self._proj_vecs(eff))
        self._last_flop = _eff_flops(eff) * nmv
        return eff, t1, w, v, nmv, None

    def _eigen_executor(self, t: int, dav_thrd: float):
        """Bucketed (K8: torch, torch_device, torch_stacked) or tiled (K7:
        torch_tiled) path of one two-site step: host LW/RW and
        :meth:`_executor_solve`."""
        eff = EffectiveHamiltonian2(self.me, t)
        x0 = self._initial_guesses(eff, t)
        diag = eff.diagonal()
        pv = self._proj_vecs(eff)
        t1 = time.time()
        try:
            w, v, nmv = self._executor_solve(eff, t, x0, diag, dav_thrd, pv)
        except _DeviceEigenRejected:
            return self._redo_host(eff, x0, t1, dav_thrd)
        self._last_flop = _eff_flops(eff) * nmv
        return eff, t1, w, v, nmv, None

    def _executor_solve(self, eff, t: int, x0, diag, dav_thrd: float, pv):
        """The executor's matvec on the device inside the host Davidson, or
        the device Davidson around it for one float32 root without
        projection (torch_device) and for one root without projection
        (torch_tiled); the executor is keyed (kind, site) and freed after.
        Returns (energies, vectors, matvecs); a rejected eigenpair of CPU
        tensors raises _DeviceEigenRejected."""
        key = (type(eff).__name__, t)
        if self.backend == "torch_tiled":
            from ..ops.tiled import TiledExecutor
            ex = TiledExecutor(eff, dtype=self.dtype, cache=self._exec_cache,
                               cache_key=key, device=self.device)
            on_device = self.n_roots == 1 and not pv
        else:
            from ..ops.exec_bucket import BucketExecutor
            ex = BucketExecutor(eff, dtype=self.dtype, cache=self._exec_cache,
                                cache_key=key, device=self.device)
            on_device = (self.backend == "torch_device" and self.n_roots == 1
                         and not pv and np.dtype(self.dtype) == np.float32)
        try:
            if on_device:
                th, xv, nmv = ex.solve_ground_state(
                    x0[:, 0], diag, conv_thrd=dav_thrd,
                    max_iter=self.dav_max_iter)
                w, v = np.array([th]), xv[:, None]
            else:
                w, v, nmv = self._host_davidson(ex.matvec, diag, x0,
                                                dav_thrd, pv)
            for r in range(self.n_roots):
                self._guard(ex.matvec, float(w[r]), v[:, r], t)
        finally:
            ex.free()
        return w, v, nmv

    def update_two_dot(self, t: int, forward: bool, bond_dim: int,
                       noise: float, dav_thrd: float):
        tm = self.timings
        t0 = time.time()
        if self.backend == "numpy":
            eff, t1, w, v, nmv, rs = self._eigen_host(t, dav_thrd)
        elif self.backend == "torch_resident":
            eff, t1, w, v, nmv, rs = self._eigen_device(t, noise, forward,
                                                        dav_thrd)
        else:
            eff, t1, w, v, nmv, rs = self._eigen_executor(t, dav_thrd)
        tm.teff += t1 - t0
        t2 = time.time()
        tm.teig += t2 - t1
        # the noise term: on the device from the converged psi (K6); the
        # host paths (and a host redo) form it from the host LW/RW
        rho_noise = (rs.noise_rho(v[:, 0], forward)
                     if rs is not None and noise > 0 else None)
        energies = w[:self.n_roots] + self.mpo.const_e
        psis = [eff.unflatten(v[:, r]) for r in range(self.n_roots)]
        if forward:
            a_tensor, centers, dw = split_forward_update(
                eff, psis, self.weights, noise, bond_dim,
                rho_noise=rho_noise)
            a_tensor, centers, dw, energies = self._rank0(
                a_tensor, centers, dw, energies)
            t3 = time.time()
            tm.tdm += t3 - t2
            self.mps.tensors[t] = a_tensor
            self.mps.tensors[t + 1] = centers[0]
            self._center_tensors = centers
            self._center_pos = t + 1
            self.me.update_left(t)
            self.me.invalidate_right(t + 1)
            # the consumed right pool is dead for this sweep
            self.me.free_pool("r", t + 2)
        else:
            b_tensor, centers, dw = split_backward_update(
                eff, psis, self.weights, noise, bond_dim,
                rho_noise=rho_noise)
            b_tensor, centers, dw, energies = self._rank0(
                b_tensor, centers, dw, energies)
            t3 = time.time()
            tm.tdm += t3 - t2
            self.mps.tensors[t + 1] = b_tensor
            self.mps.tensors[t] = centers[0]
            self._center_tensors = centers
            self._center_pos = t
            self.me.update_right(t + 1)
            self.me.invalidate_left(t)
            self.me.free_pool("l", t)
        for p in self._proj:
            p.dirty(t, t + 1)
        if self.device is not None and self.device.type == "cuda":
            # blocking only enqueues K5/K3: wait for them, so that Tblk
            # holds their device time rather than the next site's Teff
            import torch
            torch.cuda.synchronize(self.device)
        tm.tblk += time.time() - t3
        return energies, dw, nmv

    def _one_site_check(self) -> None:
        """One-site steps take one root without projection, and a backend
        with a one-site engine."""
        if self.backend == "torch_resident":
            raise NotImplementedError(
                "backend='torch_resident' has no one-site engine (still "
                "to port, ROADMAP); one-site sweeps run on "
                "backend='torch_tiled' (K7) or the bucketed backends (K8)")
        if self.n_roots != 1 or self._proj:
            raise NotImplementedError("one-site sweeps take one root "
                                      "without projection")

    def _one_site_solve(self, eff, t: int, x0, diag, dav_thrd: float):
        """The local solve of a one-site step on the backend's engine."""
        if self.backend == "numpy":
            return self._host_davidson(eff.matvec_np, diag, x0, dav_thrd,
                                       None)
        try:
            return self._executor_solve(eff, t, x0, diag, dav_thrd, None)
        except _DeviceEigenRejected:
            self.host_redo_count += 1
            return self._host_davidson(eff.matvec_np, diag, x0, dav_thrd,
                                       None)

    def update_one_dot(self, t: int, forward: bool, bond_dim: int,
                       noise: float, dav_thrd: float):
        """One-site update with the center at site t (reference
        sweep_algorithm.hpp:183 update_one_dot; the JAX package's
        sweep.py:893-1060): EffectiveHamiltonian1 going forward,
        EffectiveHamiltonian1R going backward; the residual of the
        decimation is absorbed into the next site."""
        tm = self.timings
        t0 = time.time()
        g = self.mpo.group
        L = self.mpo.n_sites
        target = self.mps.info.target
        eff = (EffectiveHamiltonian1 if forward
               else EffectiveHamiltonian1R)(self.me, t)
        x0 = eff.tensor_to_vec(self.mps.tensors[t])
        if np.linalg.norm(x0) < 1e-14:
            x0 = np.random.RandomState(42).standard_normal(eff.size)
        x0 = x0 / np.linalg.norm(x0)
        diag = eff.diagonal()
        t1 = time.time()
        tm.teff += t1 - t0
        w, v, nmv = self._one_site_solve(eff, t, x0[:, None], diag, dav_thrd)
        self._last_flop = _eff_flops(eff) * nmv
        t2 = time.time()
        tm.teig += t2 - t1
        energy = np.array([float(w[0]) + self.mpo.const_e])
        psi = {}
        for k in eff.keys:
            dl, dr = eff.shapes[k]
            off = eff.offsets[k]
            psi[k] = v[off:off + dl * dr, 0].reshape(dl, dr)
        if (t == L - 1) if forward else (t == 0):
            self.mps.tensors[t] = eff.vec_to_tensor(v[:, 0])
            self._center_tensors = [self.mps.tensors[t]]
            self._center_pos = t
            tm.tdm += time.time() - t2
            return energy, 0.0, nmv
        if forward:
            # rho over the fused (bond x site) rows
            rho: Dict[QN, np.ndarray] = {}
            for (qL, qc), b in psi.items():
                acc = rho.get(qL)
                rho[qL] = b @ b.conj().T if acc is None \
                    else acc + b @ b.conj().T
            if noise > 0:
                rho_n: Dict[QN, np.ndarray] = {}
                for m, lw in eff.LW.items():
                    for (qLb, qLk), blk in lw.items():
                        pk = (qLk, g.sub(target, qLk))
                        if pk not in psi:
                            continue
                        x = blk @ psi[pk]
                        acc = rho_n.get(qLb)
                        rho_n[qLb] = x @ x.conj().T if acc is None \
                            else acc + x @ x.conj().T
                rho = _apply_noise(rho, rho_n, noise)
            rot, dw = _decimate(rho, bond_dim)
            a_blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = {}
            for qL, vmat in rot.items():
                for (ql, qp, off, dl, dp) in eff.fl.maps[qL]:
                    a_blocks[(ql, qp, qL)] = vmat[off:off + dl * dp, :] \
                        .reshape(dl, dp, -1)
            self.mps.tensors[t] = MPSTensor(g, a_blocks)
            # absorb the residual into site t+1
            t_old = self.mps.tensors[t + 1]
            nb = {}
            for qL, vmat in rot.items():
                pk = (qL, g.sub(target, qL))
                if pk not in psi:
                    continue
                mmat = vmat.conj().T @ psi[pk]   # (k, d_old)
                for (ql2, qp2, qr2), b in t_old.blocks.items():
                    if ql2 == qL:
                        nb[(ql2, qp2, qr2)] = np.einsum(
                            "kd,dpr->kpr", mmat, b, optimize=True)
            self.mps.tensors[t + 1] = MPSTensor(g, nb)
            self._center_tensors = [self.mps.tensors[t + 1]]
            self._center_pos = t + 1
            t3 = time.time()
            tm.tdm += t3 - t2
            self.me.update_left(t)
            self.me.invalidate_right(t + 1)
        else:
            rho = {}
            for (qb, qRf), b in psi.items():
                acc = rho.get(qRf)
                rho[qRf] = b.T @ b.conj() if acc is None \
                    else acc + b.T @ b.conj()
            if noise > 0:
                rho_n = {}
                for m, rw in eff.RW.items():
                    for (qRb, qRk), blk in rw.items():
                        pk = (g.sub(target, qRk), qRk)
                        if pk not in psi:
                            continue
                        x = psi[pk] @ blk.T
                        acc = rho_n.get(qRb)
                        rho_n[qRb] = x.T @ x.conj() if acc is None \
                            else acc + x.T @ x.conj()
                rho = _apply_noise(rho, rho_n, noise)
            rot, dw = _decimate(rho, bond_dim)
            b_blocks: Dict[Tuple[QN, QN, QN], np.ndarray] = {}
            for qRf, vmat in rot.items():
                ql_new = g.sub(target, qRf)
                for (qp, qc2, off, dp, db) in eff.fr.maps[qRf]:
                    qr2 = g.sub(target, qc2)
                    b_blocks[(ql_new, qp, qr2)] = \
                        vmat[off:off + dp * db, :].T.reshape(-1, dp, db)
            self.mps.tensors[t] = MPSTensor(g, b_blocks)
            t_old = self.mps.tensors[t - 1]
            nb = {}
            for qRf, vmat in rot.items():
                qb = g.sub(target, qRf)
                pk = (qb, qRf)
                if pk not in psi:
                    continue
                mmat = psi[pk] @ vmat.conj()   # (d_old, k)
                for (ql2, qp2, qr2), b in t_old.blocks.items():
                    if qr2 == qb:
                        nb[(ql2, qp2, qr2)] = np.einsum(
                            "lpd,dk->lpk", b, mmat, optimize=True)
            self.mps.tensors[t - 1] = MPSTensor(g, nb)
            self._center_tensors = [self.mps.tensors[t - 1]]
            self._center_pos = t - 1
            t3 = time.time()
            tm.tdm += t3 - t2
            self.me.update_right(t)
            self.me.invalidate_left(t - 1)
        if self.device is not None and self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        tm.tblk += time.time() - t3
        return energy, dw, nmv

    def _rank0(self, *site):
        """Under a mesh, rank 0's decimated site tensors, energies and
        discarded weight on every rank (the noise (K6) and the mix rounded
        differently on each rank); without one, ``site`` as it is."""
        if self._group is None:
            return site
        from ..parallel.multihost import broadcast_object
        return broadcast_object(site, self._group, self.device)

    # ------------------------------------------------------------------
    def sweep(self, forward: bool, bond_dim: int, noise: float,
              dav_thrd: float, dot: int = 2) -> SweepResults:
        """One pass: two-site steps (``dot=2``; with ``last_site_1site``
        the last site's step is a one-site one) or one-site steps."""
        from ..ops import _kernels
        from ..parallel.multihost import stats as coll
        L = self.mpo.n_sites
        res = SweepResults()
        tm = self.timings
        before = (tm.teff, tm.teig, tm.tdm, tm.tblk)
        launches = _kernels.launch_counts()
        units = _kernels.unit_counts()
        coll0 = dict(coll)
        idle = self.idle_matvecs
        moved = dict(self.me.blk_transfers)
        blk = dict(self.me.blk_time)
        mat = self.me.host_env_materialized
        mix_plan = self.mix_plan_time
        t0 = time.time()
        ls1 = self.last_site_1site and dot == 2
        if dot == 1:
            rng = range(L) if forward else range(L - 1, -1, -1)
        elif ls1:
            rng = range(L - 2) if forward else range(L - 3, -1, -1)
        else:
            rng = range(L - 1) if forward else range(L - 2, -1, -1)

        def site(t, one_dot):
            tsite = time.time()
            step = self.update_one_dot if one_dot else self.update_two_dot
            e, dw, nmv = step(t, forward, bond_dim, noise, dav_thrd)
            res.energies.append(e)
            res.discarded.append(dw)
            res.n_matvec += nmv
            res.n_flop += self._last_flop
            if self.iprint >= 2:
                estr = " ".join(f"{x:.12f}" for x in e)
                print(f"   {'-->' if forward else '<--'} site {t:3d} "
                      f"E = {estr}  dw = {dw:.2e}  nmv = {nmv}  "
                      f"t = {time.time() - tsite:.2f}s", flush=True)

        if ls1 and not forward:
            # the backward sweep opens with the one-site update of the last
            # site; its decimation moves the center onto site L-2
            site(L - 1, True)
        for t in rng:
            site(t, dot == 1)
        if ls1 and forward:
            # move the center from the last two-site window onto the last
            # site (canonicalization only), then a one-site update there
            self.mps.left_canonicalize_site(L - 2)
            self.me.invalidate_right(L - 1)
            self.me.update_left(L - 2)
            self._center_tensors = [self.mps.tensors[L - 1]]
            self._center_pos = L - 1
            site(L - 1, True)
        earr = np.stack(res.energies)
        self.sweep_log.append(dict(
            energy=float(earr.min()), energies=earr.min(axis=0),
            wall=time.time() - t0, matvecs=res.n_matvec,
            **{k: a - b for k, a, b in zip(
                ("teff", "teig", "tdm", "tblk"),
                (tm.teff, tm.teig, tm.tdm, tm.tblk), before)},
            launches={k: n - launches[k]
                      for k, n in _kernels.launch_counts().items()},
            units={k: n - units[k]
                   for k, n in _kernels.unit_counts().items()},
            all_reduce=coll["all_reduce"] - coll0["all_reduce"],
            all_reduce_s=coll["all_reduce_s"] - coll0["all_reduce_s"],
            idle_matvecs=self.idle_matvecs - idle,
            **{k: n - moved[k] for k, n in self.me.blk_transfers.items()},
            blk_plan=self.me.blk_time["plan"] - blk["plan"],
            blk_exec=self.me.blk_time["exec"] - blk["exec"],
            mix_plan=self.mix_plan_time - mix_plan,
            materialized=self.me.host_env_materialized - mat))
        return res

    def solve(self, bond_dims: List[int], noises: List[float],
              dav_thrds: List[float], n_sweeps: int = 20,
              tol: float = 1e-8, twodot_to_onedot: Optional[int] = None):
        """Sweeps until the energies move less than ``tol`` on a sweep
        without noise; from sweep ``twodot_to_onedot`` on, one-site
        sweeps.  Returns the lowest root's energy (a float) with one root,
        else every root's energy (an array), as the reference."""
        def sched(lst, i):
            return lst[min(i, len(lst) - 1)]

        if twodot_to_onedot is not None and twodot_to_onedot < n_sweeps:
            self._one_site_check()

        # start away from the current center: a previous solve() that
        # converged on a forward sweep leaves the center at the right end
        forward = self._center_pos <= 0
        last_e = np.full(self.n_roots, np.inf)
        for isw in range(n_sweeps):
            bd = sched(bond_dims, isw)
            ns = sched(noises, isw)
            dt = sched(dav_thrds, isw)
            dot = 2 if (twodot_to_onedot is None
                        or isw < twodot_to_onedot) else 1
            res = self.sweep(forward, bd, ns, dt, dot=dot)
            e = np.stack(res.energies).min(axis=0)
            dw = max(res.discarded) if res.discarded else 0.0
            self.energies.append(e)
            self.discarded_weights.append(dw)
            if self.iprint >= 1:
                estr = " ".join(f"{x:.12f}" for x in e)
                gfs = res.n_flop / max(self.timings.teig, 1e-9) / 1e9
                print(f"sweep {isw:3d} {'F' if forward else 'B'} D={bd:5d} "
                      f"noise={ns:.1e}  E = {estr}  "
                      f"dE = {np.max(np.abs(e - last_e)):+.3e} "
                      f" dw = {dw:.2e}  nmv = {res.n_matvec}  "
                      f"FLOP/SWP = {res.n_flop:.3e} ({gfs:.1f} GF/s)")
                if self.iprint >= 2:
                    print("    " + self.timings.line(), flush=True)
                self.timings.reset()
            if np.max(np.abs(e - last_e)) < tol and ns == 0:
                break
            last_e = e
            forward = not forward
        final = self.energies[-1] if self.energies else \
            np.full(self.n_roots, np.nan)
        return float(final[0]) if self.n_roots == 1 else final
