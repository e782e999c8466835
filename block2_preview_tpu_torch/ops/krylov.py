"""Krylov-subspace exponential exp(scale * H) v (host Lanczos).

Copied from block2_preview_tpu/ops/krylov.py:20-61 (reference
src/core/iterative_matrix_functions.hpp:1571 expo_krylov): Lanczos with
full reorthogonalization on the host around an opaque matvec — the
device matvec of the tiled engine (kernel K7) in time evolution — and the
small tridiagonal exponential by scipy.  The linear solvers of Green's
functions (``gmres_solve``/``cg_solve``) come with that slice.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import scipy.linalg as sla


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
