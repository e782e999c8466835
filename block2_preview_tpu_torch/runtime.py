"""Device and dtype policy of the port.

Nothing in the port picks a device on its own: every entry point takes a
``device`` argument and resolves it here.  Matmuls in float32 run in full
float32 (TF32 off) — the analog of the reference's ``Precision.HIGHEST``
pin (block2_preview_tpu/ops/tiled.py:94-97): reduced-precision products
break Davidson convergence.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.float64): torch.float64,
                 np.dtype(np.float32): torch.float32}


def set_precision_policy() -> None:
    """Full-precision float32 products everywhere (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; None is refused (no implicit pick).
    A CUDA device must exist: there is no fallback to the CPU."""
    if device is None:
        raise ValueError("an explicit device is required "
                         "(e.g. device='cuda' or device='cpu')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    set_precision_policy()
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """numpy float64/float32 -> torch dtype; other types are refused."""
    dt = np.dtype(dtype)
    if dt not in _TORCH_DTYPES:
        raise TypeError(f"unsupported dtype {dt} (float64 | float32)")
    return _TORCH_DTYPES[dt]
