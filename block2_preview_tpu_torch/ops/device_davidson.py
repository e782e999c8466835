"""On-device Davidson around the sigma matvec (torch).

Port of block2_preview_tpu/ops/device_davidson.py:23-185 and the
resident driver around it (resident.py:714-789, ``_v2_dav``): the lowest
eigenpair of a symmetric operator with an M=20 masked subspace, Olsen /
diagonal preconditioning, two modified Gram-Schmidt passes, the basis-
collapse test ``|V t| > 1e-4`` and a K=4 thick restart.

One solve is one call.  The reference chained bounded launches only to
stay under a TPU worker watchdog; here the loop runs on the host and the
subspace stays on the device.  Each iteration reads three scalars
(residual norm, overlap, norm) back in one transfer to take its branch.
The subspace products and the M x M ``eigh`` are dense glue
(``torch.matmul`` / ``torch.linalg.eigh``); the matvec is kernel K1.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def masked_eigh(h, mask, M: int):
    """eigh of the active block of h, with masked rows/cols pushed above
    the spectrum by a Gershgorin-scaled sentinel.  A huge constant (1e30)
    is not safe: eigensolvers lose the small eigenvalues at that dynamic
    range, so the sentinel stays within a few orders of magnitude of the
    real spectrum."""
    mask2 = mask[:, None] & mask[None, :]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h = torch.where(mask2, h, zero)
    bound = h.abs().sum(dim=1).max() + 1.0
    eye = torch.eye(M, dtype=torch.bool, device=h.device)
    ar = torch.arange(M, dtype=h.dtype, device=h.device)
    h = torch.where(mask2, h, torch.where(eye, bound * (1.0 + ar), zero))
    return torch.linalg.eigh(h)


def davidson(matvec: Callable, diag, x0, conv_thrd: float = 1e-8,
             max_iter: int = 100, max_subspace: int = 20,
             n_keep: int = 4) -> Tuple[float, torch.Tensor, int]:
    """Smallest eigenpair, subspace on the device of ``x0``.

    matvec: padded vector [n] -> sigma [n - 1] (the pad slot stays 0)
    diag:   [n] preconditioner diagonal
    x0:     [n] initial guess (pad slot 0)
    Returns (theta, x [n], n_iter)."""
    n = x0.shape[0]
    M = max_subspace
    K = min(n_keep, M - 2)
    dev, dt = x0.device, x0.dtype
    V = torch.zeros((M, n), dtype=dt, device=dev)
    S = torch.zeros((M, n), dtype=dt, device=dev)
    V[0] = x0 / torch.linalg.norm(x0)
    ar = torch.arange(M, device=dev)
    m, it = 1, 0
    while True:
        S[m - 1, :n - 1] = matvec(V[m - 1])
        S[m - 1, n - 1] = 0
        mask = ar < m
        Vm = V * mask[:, None]
        Sm = S * mask[:, None]
        h = Vm @ Sm.T
        h = 0.5 * (h + h.T)
        w, c = masked_eigh(h, mask, M)
        y = c[:, 0]
        theta = w[0]
        r = y @ Sm - theta * (y @ Vm)
        rn2_d = torch.sum(r * r)
        # precondition + orthogonalize (two MGS passes)
        denom = diag - theta
        denom = torch.where(denom.abs() < 1e-8,
                            torch.sign(denom + 1e-30) * 1e-8, denom)
        t = r / denom
        t = t - (Vm @ t) @ Vm
        t = t - (Vm @ t) @ Vm
        tn = torch.linalg.norm(t)
        t = t / torch.clamp(tn, min=1e-30)
        # basis collapse: when the preconditioned residual lies (to
        # working precision) inside the current span, the normalized
        # remainder is roundoff and no longer orthogonal to V; growing V
        # with it gives spurious Ritz values.  Two-pass MGS leaves ~1e-6
        # in f32, so 1e-4 is two decades of headroom on both sides.
        ov = torch.linalg.norm(Vm @ t)
        rn2, ov_h, tn_h = torch.stack([rn2_d, ov, tn]).tolist()
        it += 1
        # stop BEFORE growing: the reference appends t on its last
        # iteration too, and its finalize then diagonalizes a subspace
        # whose newest vector has no sigma row (zero diagonal, halved
        # couplings) — a spurious low Ritz value whenever the spectrum
        # lies above zero
        if ov_h > 1e-4 or tn_h <= 1e-30 or it >= max_iter \
                or rn2 <= conv_thrd:
            break
        if m + 1 > M:
            # thick restart: keep the K lowest Ritz pairs (orthonormal by
            # construction) and append t
            ck = c[:, :K]
            Vk, Sk = ck.T @ Vm, ck.T @ Sm
            V.zero_()
            S.zero_()
            V[:K], S[:K], V[K] = Vk, Sk, t
            m = K + 1
        else:
            V[m] = t
            m += 1
    mask = ar < m
    Vm = V * mask[:, None]
    Sm = S * mask[:, None]
    h = Vm @ Sm.T
    w, c = masked_eigh(0.5 * (h + h.T), mask, M)
    x = c[:, 0] @ Vm
    return float(w[0]), x / torch.linalg.norm(x), it
