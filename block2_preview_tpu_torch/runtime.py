"""Device and dtype policy of the port.

Every entry point takes a ``device`` argument, "cuda" unless the caller
asks for the CPU, and resolves it here: a CUDA device must exist, there is
no fallback to the CPU.  Matmuls in float32 run in full
float32 (TF32 off) — the analog of the reference's ``Precision.HIGHEST``
pin (block2_preview_tpu/ops/tiled.py:94-97): reduced-precision products
break Davidson convergence.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.float64): torch.float64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.complex128): torch.complex128,
                 np.dtype(np.complex64): torch.complex64}


def set_precision_policy() -> None:
    """Full-precision float32 products everywhere (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; None is refused.  A CUDA device must
    exist: there is no fallback to the CPU."""
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


def local_cuda_device(rank: int) -> torch.device:
    """cuda:(local_rank % device count) for a process of the given global
    ``rank``; the local rank is ``LOCAL_RANK`` where a launcher sets it,
    else the rank.  Several ranks on one card all share cuda:0."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank device was requested but CUDA is "
                           "not available")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def rank_device(mesh, device) -> torch.device:
    """This rank's device.  Without a mesh, :func:`resolve_device`.  With a
    ``DeviceMesh``, the type of ``device`` (the mesh's device type when
    ``device`` is None): a CUDA rank takes :func:`local_cuda_device` of its
    global rank and raises where CUDA is absent; a CPU rank the CPU."""
    if mesh is None:
        return resolve_device(device)
    kind = torch.device(device).type if device is not None \
        else mesh.device_type
    dev = resolve_device(kind)
    if dev.type == "cpu":
        return dev
    import torch.distributed as dist
    return local_cuda_device(dist.get_rank())


def torch_dtype(dtype, complex_ok: bool = False) -> torch.dtype:
    """numpy float64/float32 (and complex128/complex64 where the caller
    takes them, the tiled engine of time evolution) -> torch dtype; other
    types are refused."""
    dt = np.dtype(dtype)
    if dt not in _TORCH_DTYPES or (dt.kind == "c" and not complex_ok):
        ok = " | complex128 | complex64" if complex_ok else ""
        raise TypeError(f"unsupported dtype {dt} (float64 | float32{ok})")
    return _TORCH_DTYPES[dt]


def unpack_views(flat, shapes):
    """Consecutive pieces of the flat tensor ``flat`` as views of the given
    ``shapes`` (a tuple of tensors, in order).  Counterpart of
    block2_preview_tpu/ops/devcache.py:144 ``_unpack``, which split one
    upload into its arrays with a device launch; a slice and a reshape of
    a torch tensor move no data, so nothing launches here."""
    sizes = [int(np.prod(shape, dtype=np.int64)) for shape in shapes]
    if sum(sizes) > flat.numel():
        raise ValueError(f"unpack_views: shapes need {sum(sizes)} elements, "
                         f"the flat tensor holds {flat.numel()}")
    out, o = [], 0
    for shape, n in zip(shapes, sizes):
        out.append(flat[o:o + n].view(tuple(int(s) for s in shape)))
        o += n
    return tuple(out)
