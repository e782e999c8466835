"""Davidson eigensolver (host-driven outer loop, device-friendly matvec).

Counterpart of block2's IterativeMatrixFunctions::harmonic_davidson
in its DavidsonTypes::Normal mode (reference
src/core/iterative_matrix_functions.hpp:1181) with Olsen/diagonal
preconditioning.  The matvec is an opaque callable (the host path's
EffectiveHamiltonian2.matvec_np); orthogonalization and the small
Rayleigh-Ritz problem stay on host in float64.  This is the host solver
of backend="numpy" and of the CPU-only host redo.

Copied from block2_preview_tpu/ops/davidson.py (the port keeps its own copy):
``davidson`` and ``harmonic_davidson`` (:158-249, the interior eigenpairs
that deflate the squared Green's-function solve, ``dmrg/greens.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.linalg as sla


def davidson(matvec: Callable[[np.ndarray], np.ndarray],
             diag: np.ndarray,
             x0: np.ndarray,
             n_roots: int = 1,
             conv_thrd: float = 1e-8,
             max_iter: int = 200,
             max_subspace: int = 30,
             deflation_min_size: int = 2,
             iprint: bool = False,
             ortho: Optional[List[np.ndarray]] = None,
             proj_weights: Optional[List[float]] = None,
             ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Lowest eigenpairs of a symmetric operator.

    conv_thrd is on |r|^2, matching block2's davidson_conv_thrd semantics
    (reference src/dmrg/sweep_algorithm.hpp:96-133).

    ortho: external states (state-specific DMRG: previously converged
    roots compressed into the local space).  Without proj_weights they
    are projected OUT of every basis vector; with proj_weights w_j the
    operator gains level-shift penalties w_j |o_j><o_j| instead
    (reference iterative_matrix_functions.hpp:519-630 `ors` +
    `projection_weights` semantics: ors Gram-Schmidt'd among themselves,
    unnormalized).
    Returns (eigenvalues [n_roots], eigenvectors [n, n_roots], n_matvec).
    """
    n = diag.shape[0]
    x0 = x0.reshape(-1, 1) if x0.ndim == 1 else x0
    nroots = min(n_roots, n)
    max_sub = min(max(max_subspace, nroots * 4), n)

    dtype = np.result_type(np.float64, x0.dtype, diag.dtype)

    ors: List[np.ndarray] = []
    or_nsq: List[float] = []
    penalty = proj_weights is not None and len(proj_weights) > 0
    if ortho:
        # pairwise orthogonalization, no normalization (reference :563)
        for o in ortho:
            v = np.asarray(o, dtype=dtype).copy()
            for oj, nsq in zip(ors, or_nsq):
                if nsq > 1e-24:
                    v -= (np.vdot(oj, v) / nsq) * oj
            ors.append(v)
            or_nsq.append(float(np.real(np.vdot(v, v))))
        if penalty:
            assert len(proj_weights) == len(ors)
            base_mv = matvec

            def matvec(x, _mv=base_mv):
                y = np.asarray(_mv(x)).astype(dtype, copy=True)
                for oj, wj in zip(ors, proj_weights):
                    y += (wj * np.vdot(oj, x)) * oj
                return y

    def _project_out(v):
        if ors and not penalty:
            for oj, nsq in zip(ors, or_nsq):
                if nsq > 1e-24:
                    v -= (np.vdot(oj, v) / nsq) * oj
        return v

    basis: List[np.ndarray] = []
    sigmas: List[np.ndarray] = []
    for i in range(min(x0.shape[1], nroots)):
        v = _project_out(x0[:, i].astype(dtype))
        for b in basis:
            v -= np.vdot(b, v) * b
        nv = np.linalg.norm(v)
        if nv > 1e-12:
            basis.append(v / nv)
    while len(basis) < nroots:
        v = _project_out(np.random.RandomState(len(basis))
                         .standard_normal(n).astype(dtype))
        for b in basis:
            v -= np.vdot(b, v) * b
        basis.append(v / np.linalg.norm(v))

    nmv = 0
    theta = np.zeros(nroots)
    ritz = None
    for it in range(max_iter):
        while len(sigmas) < len(basis):
            sigmas.append(np.asarray(matvec(basis[len(sigmas)])))
            nmv += 1
        m = len(basis)
        B = np.stack(basis, axis=1)
        S = np.stack(sigmas, axis=1)
        h = B.conj().T @ S
        h = 0.5 * (h + h.conj().T)
        w, c = np.linalg.eigh(h)
        theta = w[:nroots].real
        ritz = B @ c[:, :nroots]
        rvecs = S @ c[:, :nroots] - ritz * theta[None, :]
        rnorms2 = (np.abs(rvecs) ** 2).sum(axis=0)
        if iprint:
            print(f"  dav it {it:3d} m {m:3d} e {theta[0]:.12f} "
                  f"|r|^2 {rnorms2.max():.3e}")
        if rnorms2.max() < conv_thrd:
            return theta, ritz, nmv
        # restart if subspace full
        if m + nroots > max_sub:
            basis = [ritz[:, i] / np.linalg.norm(ritz[:, i])
                     for i in range(nroots)]
            # re-orthonormalize
            for i in range(1, len(basis)):
                for j in range(i):
                    basis[i] -= np.vdot(basis[j], basis[i]) * basis[j]
                basis[i] /= np.linalg.norm(basis[i])
            sigmas = []
            continue
        # expand with preconditioned residuals (Olsen-style denominator)
        added = False
        for i in range(nroots):
            if rnorms2[i] < conv_thrd * 0.1:
                continue
            denom = diag - theta[i]
            denom = np.where(np.abs(denom) < 1e-12,
                             np.sign(denom + 1e-30) * 1e-12, denom)
            v = _project_out(rvecs[:, i] / denom)
            for b in basis:
                v -= np.vdot(b, v) * b
            nv = np.linalg.norm(v)
            if nv > 1e-10:
                basis.append(v / nv)
                added = True
        if not added:
            # stuck: random expansion
            v = _project_out(np.random.RandomState(1000 + it)
                             .standard_normal(n).astype(dtype))
            for b in basis:
                v -= np.vdot(b, v) * b
            nv = np.linalg.norm(v)
            if nv < 1e-12:
                break
            basis.append(v / nv)
    return theta, ritz, nmv


def harmonic_davidson(matvec: Callable[[np.ndarray], np.ndarray],
                      diag: np.ndarray, x0: np.ndarray, shift: float,
                      n_roots: int = 1, conv_thrd: float = 1e-8,
                      max_iter: int = 200, max_subspace: int = 30,
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Interior eigenpairs closest to `shift` via the harmonic Ritz
    projection (reference iterative_matrix_functions.hpp:1181
    harmonic_davidson, DavidsonTypes::Harmonic|CloseTo).

    Solves the projected problem  (W^H W) c = (W^H V) c (theta - shift)
    with W = (A - shift) V; eigenvalues returned as shift + harmonic
    Ritz values, sorted by |theta - shift|.

    Interior convergence degrades sharply across subspace restarts (the
    harmonic subspace cannot be summarized by a few Ritz vectors), so
    max_subspace should be chosen large enough that the run converges
    before the first restart — matching the reference's usage, which runs
    harmonic Davidson with large deflation spaces
    (iterative_matrix_functions.hpp:1181)."""
    n = diag.shape[0]
    x0 = x0.reshape(-1, 1) if x0.ndim == 1 else x0
    nroots = min(n_roots, n)
    max_sub = min(max(max_subspace, nroots * 4), n)
    dtype = np.result_type(np.float64, x0.dtype, diag.dtype)
    basis: List[np.ndarray] = []
    for i in range(x0.shape[1]):
        v = x0[:, i].astype(dtype)
        for b in basis:
            v -= np.vdot(b, v) * b
        nv = np.linalg.norm(v)
        if nv > 1e-12:
            basis.append(v / nv)
    while len(basis) < nroots:
        v = np.random.RandomState(len(basis)).standard_normal(n)
        v = v.astype(dtype)
        for b in basis:
            v -= np.vdot(b, v) * b
        basis.append(v / np.linalg.norm(v))
    sigmas: List[np.ndarray] = []
    nmv = 0
    for it in range(max_iter):
        while len(sigmas) < len(basis):
            sigmas.append(np.asarray(matvec(basis[len(sigmas)]))
                          - shift * basis[len(sigmas)])
            nmv += 1
        B = np.stack(basis, axis=1)
        W = np.stack(sigmas, axis=1)
        # harmonic Ritz pencil: (W^H W) c = (theta - shift) (W^H V) c
        mu, c = sla.eig(W.conj().T @ W, W.conj().T @ B)
        order = np.argsort(np.abs(mu))
        thetas = shift + mu[order].real
        c = c[:, order]
        theta = thetas[:nroots]
        ritz = B @ c[:, :nroots]
        for i in range(nroots):
            ritz[:, i] /= np.linalg.norm(ritz[:, i])
        rvecs = np.stack([np.asarray(matvec(ritz[:, i]))
                          - theta[i] * ritz[:, i]
                          for i in range(nroots)], axis=1)
        nmv += nroots
        rn2 = (np.abs(rvecs) ** 2).sum(axis=0)
        if rn2.max() < conv_thrd:
            return theta.real, ritz, nmv
        if len(basis) + nroots > max_sub:
            # thick restart: keep several harmonic Ritz vectors — a
            # nroots-only restart discards the interior subspace and stalls
            keep = min(2 * nroots + 4, len(basis))
            rv = B @ c[:, :keep]
            basis = []
            for i in range(keep):
                v = rv[:, i].copy()
                for b in basis:
                    v -= np.vdot(b, v) * b
                nv = np.linalg.norm(v)
                if nv > 1e-10:
                    basis.append(v / nv)
            sigmas = []
            continue
        for i in range(nroots):
            denom = diag - theta[i].real
            denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            v = rvecs[:, i] / denom
            for b in basis:
                v -= np.vdot(b, v) * b
            nv = np.linalg.norm(v)
            if nv > 1e-10:
                basis.append(v / nv)
        sigmas = sigmas[:len(basis)]
    return theta.real, ritz, nmv
