"""Build, bind and count the port's CUDA kernels.

The sources under ``block2_preview_tpu_torch/csrc/`` are compiled at first
use by ``nvcc`` for ``sm_90a`` into ONE shared library with a plain C
interface (``build/kernels/`` beside the package; the file name carries
a hash of the sources and flags, so an edit rebuilds).  The library is
loaded with ``ctypes``.  Nothing is built or loaded at import: the CPU
tests import every module on a machine without ``nvcc``.

Every wrapper that launches a kernel calls :func:`launch`, which checks
the tensors, passes their pointers and the current stream, raises if the
C side reports a CUDA
error (a refused launch never runs, and a later synchronise would not
report it), and adds one to that kernel's launch count.  The counts are
how a run shows that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class KernelInfo:
    route: str        # "cuda"
    source: str       # path in the repository
    replaces: str     # file:line of the JAX kernel it replaces
    launches: int = 0


KERNELS: Dict[str, KernelInfo] = {
    "K1_matvec": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/matvec.cu",
        "block2_preview_tpu/ops/tilev2.py:101 _mv_scan (+ :168 "
        "_tile_gather)"),
    "K2_diag": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/diag.cu",
        "block2_preview_tpu/ops/resident.py:316 _slab_diag_impl (+ :331 "
        "_dl_build)"),
    "K3_mix": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/mix.cu",
        "block2_preview_tpu/ops/mixv4.py:136 _mix4_scan"),
    "K4_place": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/place.cu",
        "block2_preview_tpu/ops/mixv4.py:65 _place4_exec_packed"),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (all return int = cudaError_t)
_SIGS = {
    "b2t_matvec": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _P, _P),
    "b2t_gather": (_P, _P, _L, _P, _P),
    "b2t_dl_build": (_P, _P, _I, _I, _P, _P),
    "b2t_diag": (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    "b2t_mix": (_P, _P, _P, _P, _I, _L, _P, _P),
    "b2t_place": (_P, _P, _P, _I, _L, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found (no CUDA toolkit)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libb2t_kernels_{h.hexdigest()[:12]}.so"


def build() -> float:
    """Compile the kernel library if it is missing; returns the seconds
    spent compiling (0.0 when an up-to-date library exists)."""
    global build_log
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.time() - t0
    build_log = proc.stdout + proc.stderr
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + build_log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return dt


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        build()
        cdll = ctypes.CDLL(str(library_path()))
        for name, args in _SIGS.items():
            for sfx in ("_f64", "_f32"):
                fn = getattr(cdll, name + sfx)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
        cdll.b2t_error_string.argtypes = [ctypes.c_int]
        cdll.b2t_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def call(entry: str, dtype, *args) -> None:
    """Call C entry ``entry`` (``_f64``/``_f32`` picked from ``dtype``, a
    torch dtype) with ``args`` followed by the current CUDA stream; raise
    on a CUDA error.  Tensor arguments are validated (contiguous CUDA
    tensors of ``dtype`` or int32, the only types the kernels take) and
    passed as device pointers."""
    import torch
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_cuda or not a.is_contiguous():
                raise ValueError("kernel inputs must be contiguous CUDA "
                                 f"tensors (got {a.device}, contiguous="
                                 f"{a.is_contiguous()})")
            if a.dtype not in (dtype, torch.int32):
                raise TypeError(f"kernel input of dtype {a.dtype} "
                                f"(expected {dtype} or int32)")
            a = a.data_ptr()
        cargs.append(a)
    sfx = "_f64" if dtype == torch.float64 else "_f32"
    fn = getattr(lib(), entry + sfx)
    err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib().b2t_error_string(err).decode()
        raise RuntimeError(f"{entry}{sfx} failed: CUDA error {err} ({msg})")


def launch(kernel: str, entry: str, dtype, *args) -> None:
    """:func:`call` for the main launch of ``kernel``, counted once."""
    call(entry, dtype, *args)
    KERNELS[kernel].launches += 1


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
