"""The pooled N-PDM engine's class close — kernel K17.

Counterpart of block2_preview_tpu/dmrg/npdm_scheme.py:357-412
``_device_gemm`` and its jit ``_mm`` (:376): ``out = M @ V`` for a flat
right-pool matrix M [n, X] and a batch of flattened left environments V
[X, m], float64 or complex128 (the engine's two types; a lower precision
breaks PDM parity).  ``dmrg/npdm_scheme.py`` calls :func:`npdm_gemm` for
every close at or above its ``device_min_flop``.

:func:`npdm_gemm` launches K17 (``csrc/npdm_gemm.cu``) on CUDA tensors and
runs :func:`npdm_gemm_plain` on CPU tensors.  K17 splits X over blocks
when the (n x m) tiles alone would leave most SMs idle (:func:`k_split`).
"""

from __future__ import annotations

import torch

from . import _kernels

_BM, _BN, _BK = 64, 64, 16  # K17's tile (csrc/npdm_gemm.cu)
_MIN_CHUNK = 256            # least depth of X one block walks
_TYPES = (torch.float64, torch.complex128)


def k_split(n: int, X: int, m: int, sms: int):
    """(slices, depth of each) of K17's split of X on a card of ``sms``
    streaming multiprocessors: about four blocks per SM over the (n x m)
    tiles, each slice at least 256 deep (a multiple of K17's chunk of
    16)."""
    tiles = -(-n // _BM) * -(-m // _BN)
    ks = max(1, min(-(-4 * sms // tiles), -(-X // _MIN_CHUNK)))
    chunk = -(-X // ks)
    chunk = -(-chunk // _BK) * _BK
    return -(-X // chunk), chunk


def _check(M: torch.Tensor, V: torch.Tensor):
    if M.dim() != 2 or V.dim() != 2 or M.shape[1] != V.shape[0]:
        raise ValueError(f"npdm_gemm: M {tuple(M.shape)} @ V "
                         f"{tuple(V.shape)} is not a matrix product")
    if M.dtype != V.dtype or M.dtype not in _TYPES:
        raise TypeError(f"npdm_gemm takes float64 or complex128 (got "
                        f"{M.dtype} @ {V.dtype})")
    if M.device != V.device:
        raise ValueError(f"npdm_gemm: M on {M.device}, V on {V.device}")


def npdm_gemm_plain(M: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K17: ``M @ V``."""
    _check(M, V)
    return M @ V


def npdm_gemm(M: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``M @ V`` [n, m] (kernel K17) for M [n, X], V [X, m] on one
    device.  CPU tensors run :func:`npdm_gemm_plain`; CUDA tensors launch
    K17 or raise."""
    _check(M, V)
    if M.device.type == "cpu":
        return npdm_gemm_plain(M, V)
    if not M.is_cuda:
        raise ValueError(f"unsupported device {M.device}")
    n, X = M.shape
    m = V.shape[1]
    out = M.new_zeros((n, m))
    if n == 0 or m == 0 or X == 0:
        return out
    ks, chunk = k_split(
        n, X, m, torch.cuda.get_device_properties(M.device)
        .multi_processor_count)
    _kernels.launch("K17_npdm_gemm", "b2t_npdm_gemm", M.dtype,
                    M.contiguous(), V.contiguous(), out, n, X, m, ks, chunk)
    return out
