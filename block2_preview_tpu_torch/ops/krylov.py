"""Krylov-subspace exponential exp(scale * H) v and the GMRES / CG linear
solvers (host Krylov loops around an opaque matvec).

Copied from block2_preview_tpu/ops/krylov.py:20-103 (reference
src/core/iterative_matrix_functions.hpp:1571 expo_krylov, :1985 conjugate
gradient): Lanczos with full reorthogonalization on the host around the
device matvec of the tiled engine (kernel K7) in time evolution, and the
small tridiagonal exponential by scipy; ``gmres_solve`` and ``cg_solve``
wrap scipy's GMRES and CG around the same kind of matvec, the local
solvers of the Green's-function sweeps (``dmrg/greens.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse.linalg as spla


def expmv(matvec: Callable[[np.ndarray], np.ndarray], v: np.ndarray,
          scale: complex, m: int = 30, tol: float = 1e-12
          ) -> Tuple[np.ndarray, int]:
    """exp(scale * H) @ v for Hermitian H via Lanczos
    (reference iterative_matrix_functions.hpp:1571 expo_krylov).
    Returns (result, n_matvec)."""
    nrm0 = np.linalg.norm(v)
    if nrm0 == 0:
        return v, 0
    dtype = np.result_type(v.dtype, np.asarray(scale).dtype)
    vs = [v / nrm0]
    alphas, betas = [], []
    nmv = 0
    for j in range(m):
        w = np.asarray(matvec(vs[j]))
        nmv += 1
        a = np.vdot(vs[j], w).real
        alphas.append(a)
        w = w - a * vs[j]
        if j > 0:
            w = w - betas[-1] * vs[j - 1]
        # full reorthogonalization (stability)
        for u in vs:
            w = w - np.vdot(u, w) * u
        b = np.linalg.norm(w)
        # convergence estimate from the tridiagonal exponential
        T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
        eT = sla.expm(scale * T)
        if j > 1:
            err = abs(b * eT[j, 0] * (abs(scale) / (j + 1)))
            if err < tol or b < 1e-13:
                break
        if b < 1e-13:
            break
        betas.append(b)
        vs.append(w / b)
    T = np.diag(alphas) + np.diag(betas[:len(alphas) - 1], 1) \
        + np.diag(betas[:len(alphas) - 1], -1)
    eT = sla.expm(scale * T)
    V = np.stack(vs[:len(alphas)], axis=1)
    out = nrm0 * (V @ eT[:, 0].astype(np.result_type(dtype, eT.dtype)))
    return out, nmv


def gmres_solve(matvec: Callable[[np.ndarray], np.ndarray],
                rhs: np.ndarray, x0: Optional[np.ndarray] = None,
                tol: float = 1e-10, maxiter: int = 200,
                dtype=np.complex128) -> Tuple[np.ndarray, int]:
    """GMRES on an implicitly-defined operator (the local solver of the
    correction-vector / Green's-function sweeps; plays the role of the
    reference's GCROT(m,k)/IDR(s)/LSQR family).  Returns (x, n_matvec)."""
    n = rhs.shape[0]
    count = [0]

    def mv(x):
        count[0] += 1
        return matvec(x.astype(dtype))

    op = spla.LinearOperator((n, n), matvec=mv, dtype=dtype)
    x, _info = spla.gmres(op, rhs.astype(dtype),
                          x0=None if x0 is None else x0.astype(dtype),
                          rtol=tol, maxiter=maxiter)
    return x, count[0]


def cg_solve(matvec, rhs, x0=None, tol=1e-10, maxiter=200, diag=None):
    """Conjugate gradient for positive-definite operators (reference
    iterative_matrix_functions.hpp:1985).  diag: Jacobi preconditioner
    (the reference's `aa` diagonal).  Returns (x, n_matvec)."""
    n = rhs.shape[0]
    count = [0]

    def mv(x):
        count[0] += 1
        return matvec(x)

    op = spla.LinearOperator((n, n), matvec=mv, dtype=rhs.dtype)
    M = None
    if diag is not None:
        d = np.where(np.abs(diag) < 1e-12, 1.0, diag)
        M = spla.LinearOperator((n, n), matvec=lambda x: x / d,
                                dtype=rhs.dtype)
    x, _info = spla.cg(op, rhs, x0=x0, rtol=tol, maxiter=maxiter, M=M)
    return x, count[0]
