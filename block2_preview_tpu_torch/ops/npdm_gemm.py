"""The pooled N-PDM engine's class close — kernel K17.

Counterpart of block2_preview_tpu/dmrg/npdm_scheme.py:357-412
``_device_gemm`` and its jit ``_mm`` (:376): ``out = M @ V`` for a flat
right-pool matrix M [n, X] and a batch of flattened left environments V
[X, m], float64 or complex128 (the engine's two types; a lower precision
breaks PDM parity).  ``dmrg/npdm_scheme.py`` calls :func:`npdm_gemm` for
every close at or above its ``device_min_flop``.

:func:`npdm_gemm` launches K17 (``csrc/npdm_gemm.cu``) on CUDA tensors and
runs :func:`npdm_gemm_plain` on CPU tensors.  :func:`plan` mirrors the
kernel's choice: a skinny M (n <= 16) streams V once past CUDA-core sums,
a tall one runs on the f64 tensor cores; either splits X over blocks when
its (n x m) tiles alone would leave SMs idle, and the slices' partials are
summed in a fixed order (the same bits on every launch).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _kernels

SKINNY_ROWS = 16     # n at or below: the skinny regime (csrc/npdm_gemm.cu)
# columns of out a block owns, in c128 (twice as many f64): skinny, 128
# threads of 16 bytes of every V row; tall, 4 warps of 2 (f64: 4) n8 tiles
_SK_COLS, _TALL_COLS = 128, 64
_SLICE_UNIT = 16     # a slice of X is a multiple of 16 rows of V
_MIN_CHUNK = 256     # least depth of X one block walks
_TYPES = (torch.float64, torch.complex128)


@dataclass(frozen=True)
class Split:
    """K17's launch for one close: the regime, its (rows x cols) tiles of
    out, and the split of X into ``ks`` slices of ``chunk`` rows (the last
    shorter).  ``scratch`` elements of the buffer the kernel writes:
    [ks, n, m], the sum in slice 0."""
    regime: str
    rows: int
    cols: int
    tiles: int
    ks: int
    chunk: int
    scratch: int


def plan(n: int, X: int, m: int, sms: int, is_complex: bool = False) -> Split:
    """K17's tiles and split of X for M [n, X] @ V [X, m] on a card of
    ``sms`` streaming multiprocessors: skinny (n <= 16) tiles of NR rows
    (the power of two at or above n) by 256 f64 / 128 c128 columns, tall
    tiles of 32, 64 or (f64) 128 rows (n <= 32, <= 64, above) by 128 f64
    / 64 c128 columns.  X is split into the most slices, each at least 256
    deep and a multiple of 16, that keep the tiles x slices within one
    wave of the blocks the card holds at once (two a SM; one for the f64
    128-row and c128 64-row tiles): a second, partial wave would idle most
    SMs."""
    per16 = 1 if is_complex else 2       # elements in 16 bytes
    if n <= SKINNY_ROWS:
        regime, rows = "skinny", 1 << max(0, n - 1).bit_length()
        cols, per_sm = _SK_COLS * per16, 2
    else:
        regime = "tall"
        rows = 32 if n <= 32 else 64 if n <= 64 or is_complex else 128
        # the f64 128-row and c128 64-row blocks hold an SM alone
        alone = rows == (64 if is_complex else 128)
        cols, per_sm = _TALL_COLS * per16, 1 if alone else 2
    tiles = -(-n // rows) * -(-m // cols)
    ks = max(1, min(per_sm * sms // tiles, X // _MIN_CHUNK))
    chunk = -(-X // ks)
    chunk = -(-chunk // _SLICE_UNIT) * _SLICE_UNIT
    ks = -(-X // chunk)
    return Split(regime, rows, cols, tiles, ks, chunk, ks * n * m)


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
    if n == 0 or m == 0 or X == 0:
        return M.new_zeros((n, m))
    p = plan(n, X, m, torch.cuda.get_device_properties(M.device)
             .multi_processor_count, M.is_complex())
    # every slice is written whole; the sum lands in slice 0 (a view that
    # keeps the ks slices alive, as long as the caller keeps it)
    buf = M.new_empty((p.ks, n, m))
    _kernels.launch("K17_npdm_gemm", "b2t_npdm_gemm", M.dtype,
                    M.contiguous(), V.contiguous(), buf, n, X, m, p.ks,
                    p.chunk)
    return buf[0]
