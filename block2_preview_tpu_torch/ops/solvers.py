"""Iterative linear solvers for response / Green's-function sweeps.

Copied from block2_preview_tpu/ops/solvers.py:25-236, the linear-solver
half (reference src/core/iterative_matrix_functions.hpp: conjugate
gradient and deflated CG :1985, MinRes :2165, GCROT(m,k) :2303, IDR(s)
:2554, LSQR :2988, the Chebyshev solver :3357).  Every solver drives an
opaque matvec — the host ``matvec_np`` or the device matvec of the tiled
engine (kernel K7) — and keeps its vector work on the host, beside the
matvec.  IDR(s), the Chebyshev solver and deflated CG are written out;
MinRes, GCROT(m,k) and LSQR wrap scipy's behind the same (x, n_matvec)
interface.  The SVD half of the reference module (expo_pade,
constrained_svd, sparse_constrained_svd, disjoint_svd) comes with the SVD
MPO builder that calls it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse.linalg as spla

MatVec = Callable[[np.ndarray], np.ndarray]


def _wrap(matvec: MatVec, n: int, dtype):
    count = [0]

    def mv(x):
        count[0] += 1
        return matvec(x.astype(dtype, copy=False))

    return spla.LinearOperator((n, n), matvec=mv, dtype=dtype), count


def minres(matvec: MatVec, rhs: np.ndarray, x0=None, tol: float = 1e-10,
           maxiter: int = 500) -> Tuple[np.ndarray, int]:
    """MinRes for symmetric (possibly indefinite) real operators
    (reference iterative_matrix_functions.hpp:2165)."""
    op, count = _wrap(matvec, rhs.shape[0], rhs.dtype)
    x, _info = spla.minres(op, rhs, x0=x0, rtol=tol, maxiter=maxiter)
    return x, count[0]


def gcrotmk(matvec: MatVec, rhs: np.ndarray, x0=None, tol: float = 1e-10,
            maxiter: int = 500, m: int = 20, k: Optional[int] = None
            ) -> Tuple[np.ndarray, int]:
    """GCROT(m,k) for general (non-Hermitian, complex) operators — the
    reference's default Green's-function solver
    (iterative_matrix_functions.hpp:2303)."""
    op, count = _wrap(matvec, rhs.shape[0], rhs.dtype)
    x, _info = spla.gcrotmk(op, rhs, x0=x0, rtol=tol, maxiter=maxiter,
                            m=m, k=k)
    return x, count[0]


def lsqr(matvec: MatVec, rmatvec: MatVec, rhs: np.ndarray,
         tol: float = 1e-10, maxiter: int = 1000) -> Tuple[np.ndarray, int]:
    """LSQR on an operator given with its adjoint
    (reference iterative_matrix_functions.hpp:2988)."""
    n = rhs.shape[0]
    count = [0]

    def mv(x):
        count[0] += 1
        return matvec(x)

    def rmv(x):
        count[0] += 1
        return rmatvec(x)

    op = spla.LinearOperator((n, n), matvec=mv, rmatvec=rmv,
                             dtype=rhs.dtype)
    res = spla.lsqr(op, rhs, atol=tol, btol=tol, iter_lim=maxiter)
    return res[0], count[0]


def idrs(matvec: MatVec, rhs: np.ndarray, x0=None, s: int = 4,
         tol: float = 1e-10, maxiter: int = 500, seed: int = 7
         ) -> Tuple[np.ndarray, int]:
    """IDR(s) — induced dimension reduction (van Gijzen & Sonneveld,
    ACM TOMS 38 (2011); reference iterative_matrix_functions.hpp:2554).
    Handles general complex non-Hermitian operators with short recurrences.
    """
    n = rhs.shape[0]
    dtype = np.result_type(rhs.dtype, np.float64)
    x = np.zeros(n, dtype=dtype) if x0 is None else x0.astype(dtype)
    nmv = 0
    r = rhs.astype(dtype)
    if x0 is not None:
        r = r - matvec(x)
        nmv += 1
    normb = np.linalg.norm(rhs)
    if normb == 0:
        return x, nmv
    tolb = tol * normb
    rng = np.random.RandomState(seed)
    P = rng.standard_normal((s, n)).astype(dtype)
    if np.iscomplexobj(np.zeros(1, dtype=dtype)):
        P = P + 1j * rng.standard_normal((s, n))
    # orthonormalize the shadow space
    P = np.linalg.qr(P.conj().T)[0].conj().T
    G = np.zeros((s, n), dtype=dtype)
    U = np.zeros((s, n), dtype=dtype)
    M = np.eye(s, dtype=dtype)
    om = 1.0 + 0j if np.iscomplexobj(P) else 1.0
    it = 0
    while np.linalg.norm(r) > tolb and it < maxiter:
        f = P.conj() @ r
        for kk in range(s):
            # solve the lower-triangular sub-system M[kk:, kk:] c = f[kk:]
            c = np.linalg.solve(M[kk:, kk:], f[kk:])
            v = r - G[kk:].T @ c
            u = U[kk:].T @ c + om * v
            g = matvec(u)
            nmv += 1
            it += 1
            # bi-orthogonalize against the first kk shadow directions
            for i in range(kk):
                alpha = (P[i].conj() @ g) / M[i, i]
                g = g - alpha * G[i]
                u = u - alpha * U[i]
            G[kk] = g
            U[kk] = u
            M[kk:, kk] = P[kk:].conj() @ g
            if M[kk, kk] == 0:
                return x, nmv
            beta = f[kk] / M[kk, kk]
            x = x + beta * u
            r = r - beta * g
            if np.linalg.norm(r) <= tolb or it >= maxiter:
                break
            if kk + 1 < s:
                f[kk + 1:] = f[kk + 1:] - beta * M[kk + 1:, kk]
        if np.linalg.norm(r) <= tolb or it >= maxiter:
            break
        # dimension-reduction step
        v = r
        t = matvec(v)
        nmv += 1
        it += 1
        om = (t.conj() @ r) / (t.conj() @ t)
        # Maintaining-convergence strategy (van Gijzen & Sonneveld)
        rho = abs((t.conj() @ r)) / (np.linalg.norm(t) * np.linalg.norm(r))
        kappa = 0.7
        if rho < kappa:
            om = om * kappa / rho
        x = x + om * v
        r = r - om * t
    return x, nmv


def cheby_solve(matvec: MatVec, rhs: np.ndarray, lmin: float, lmax: float,
                tol: float = 1e-10, maxiter: int = 2000
                ) -> Tuple[np.ndarray, int]:
    """Chebyshev semi-iteration for Hermitian positive-definite operators
    with spectrum in [lmin, lmax] (reference
    iterative_matrix_functions.hpp:3357 cheby).  Matvec-rich but
    inner-product-free — the communication-free solver of the family."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    x = np.zeros_like(rhs)
    r = rhs.copy()
    nmv = 0
    normb = np.linalg.norm(rhs)
    if normb == 0:
        return x, 0
    p = None
    alpha = 0.0
    for k in range(maxiter):
        if k == 0:
            p = r.copy()
            alpha = 1.0 / theta
        elif k == 1:
            beta = 0.5 * (delta * alpha) ** 2
            alpha = 1.0 / (theta - beta / alpha)
            p = r + beta * p
        else:
            beta = (delta * alpha / 2.0) ** 2
            alpha = 1.0 / (theta - beta / alpha)
            p = r + beta * p
        x = x + alpha * p
        r = r - alpha * matvec(p)
        nmv += 1
        if np.linalg.norm(r) < tol * normb:
            break
    return x, nmv


def deflated_cg(matvec: MatVec, rhs: np.ndarray, ws: Optional[np.ndarray],
                x0=None, tol: float = 1e-10, maxiter: int = 500
                ) -> Tuple[np.ndarray, int]:
    """Deflated CG (Saad/Nicolaides scheme, reference
    iterative_matrix_functions.hpp:1985 deflated_conjugate_gradient):
    the solution component in span(ws) is solved exactly through the
    small (W^H A W) system; CG runs in the A-orthogonal complement with
    every search direction re-projected (works for arbitrary deflation
    spaces, not just invariant ones)."""
    n = rhs.shape[0]
    if ws is None or ws.size == 0:
        op, count = _wrap(matvec, n, rhs.dtype)
        x, _ = spla.cg(op, rhs, x0=x0, rtol=tol, maxiter=maxiter)
        return x, count[0]
    W = np.linalg.qr(ws.reshape(n, -1))[0]
    k = W.shape[1]
    AW = np.stack([matvec(W[:, i]) for i in range(k)], axis=1)
    nmv = k
    WAW = W.conj().T @ AW
    WAW_inv = np.linalg.inv(WAW)

    def dproj(v):
        # remove the A-projection onto span(W): W^H A (dproj v) = 0
        return v - W @ (WAW_inv @ (AW.conj().T @ v))

    x = W @ (WAW_inv @ (W.conj().T @ rhs))
    if x0 is not None:
        x = x + dproj(np.asarray(x0))
    r = rhs - matvec(x)
    nmv += 1
    bnorm = np.linalg.norm(rhs)
    if bnorm < 1e-300:
        return x, nmv
    p = dproj(r)
    rs_old = np.vdot(r, r).real
    for _ in range(maxiter):
        if np.sqrt(rs_old) <= tol * bnorm:
            break
        ap = matvec(p)
        nmv += 1
        alpha = rs_old / np.vdot(p, ap).real
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = np.vdot(r, r).real
        p = dproj(r + (rs_new / rs_old) * p)
        rs_old = rs_new
    return x, nmv
