"""Build, bind and count the port's CUDA kernels.

The sources under ``block2_preview_tpu_torch/csrc/`` are compiled at first
use by ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all started
together — and linked into ONE shared library with a plain C interface
(``build/kernels/`` beside the package; the file name carries a hash of
the sources and flags, so an edit rebuilds).  The library is
loaded with ``ctypes``.  Nothing is built or loaded at import: the CPU
tests import every module on a machine without ``nvcc``.

Every wrapper that launches a kernel calls :func:`launch`, which checks
the tensors (type, layout, and that they lie on the current CUDA device,
where the C entries launch), passes their pointers and the current
stream, raises if the C side reports a CUDA error (a refused launch never
runs, and a later synchronise would not report it), and adds one to that
kernel's launch count.  The counts are how a run shows that its main path
went through the kernels.

The launch path is the host's share of every kernel: at a few
microseconds of device work (K19's dot) the card waits on it.  So each
(entry, dtype) function is resolved once and cached, and the stream is the
current device's current raw handle, read without building a
``torch.cuda.Stream``; the checks stay ahead of both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class KernelInfo:
    route: str        # "cuda"
    source: str       # path in the repository
    replaces: str     # file:line of the JAX kernel it replaces
    launches: int = 0
    units: int = 0    # work of the launches where the caller counts
                      # it: K20's stage-1 units, K5's, K21's and K22's
                      # CUDA blocks


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
        "block2_preview_tpu/ops/mixv4.py:67 _place4_exec_packed (jit :65; "
        "+ :101 _place4_exec)"),
    "K5_block": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/blocking.cu",
        "block2_preview_tpu/ops/blockv2.py:60 _blk_scan (jits :177 "
        "_blk_exec_chunkp, :157 _blk_exec_chunk)"),
    "K6_noise": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/noise.cu",
        "block2_preview_tpu/ops/resident.py:862 _noise_exec"),
    "K7_tiled": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/tiled.cu",
        "block2_preview_tpu/ops/tiled.py:86 _tiled_matvec_impl (+ :391 "
        "_tiled_dav)"),
    "K8_bucket": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/bucket.cu",
        "block2_preview_tpu/ops/exec_jax.py:136 _fused_sigma_impl (jit "
        ":150 _fused_sigma; + :347 _dav_jit)"),
    "K9_bucket_blocking": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/bucket_blocking.cu",
        "block2_preview_tpu/ops/blocking_jax.py:87 _blk_exec"),
    "K10_slab": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/slab.cu",
        "block2_preview_tpu/ops/stacked.py:163 _slab_exec"),
    "K11_stk_mix": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/stk_mix.cu",
        "block2_preview_tpu/ops/stacked.py:205 _mix_scatter"),
    "K12_tiled_blocking": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/tiled_blocking.cu",
        "block2_preview_tpu/ops/tiled_blocking.py:64 _tiled_blocking_exec"),
    "K13_env_gemm": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/env_gemm.cu",
        "block2_preview_tpu/ops/mixv3.py:62 _env_gemm (+ :88 "
        "_env_gemm_chunk)"),
    "K14_place_v3": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/place_v3.cu",
        "block2_preview_tpu/ops/mixv3.py:143 _place (+ :109 _place_chunk)"),
    "K15_mix_v2": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/mix_v2.cu",
        "block2_preview_tpu/ops/resident.py:71 _mix_exec"),
    "K16_slab_matvec": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/slab_matvec.cu",
        "block2_preview_tpu/ops/resident.py:288 _slab_matvec_impl"),
    "K17_npdm_gemm": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/npdm_gemm.cu",
        "block2_preview_tpu/dmrg/npdm_scheme.py:376 _mm (in :357 "
        "_device_gemm)"),
    "K18_plan_exec": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/plan_exec.cu",
        "block2_preview_tpu/ops/exec_jax.py:36 _execute_impl (jit :48 "
        "_execute; + :55 _bucket_exec, :64 _pad_one)"),
    "K19_probe": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/probe.cu",
        "block2_preview_tpu/utils/tpu_smoke.py:33 dot (+ :50 fill)"),
    "K20_matvec_shard": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/matvec_shard.cu",
        "block2_preview_tpu/ops/tilev2.py:197 _mv_exec_sharded (local "
        "_mv_scan :101; in ops/resident.py:792 _v2_dav_sharded_chunk)"),
    "K21_block_shard": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/blocking_shard.cu",
        "block2_preview_tpu/ops/blockv2.py:193 _blk_exec_sharded (local "
        "_blk_scan :60)"),
    "K22_plan_exec_shard": KernelInfo(
        "cuda", "block2_preview_tpu_torch/csrc/plan_exec_shard.cu",
        "block2_preview_tpu/parallel/shard.py:30 _partial_sigma (jit :78, "
        "ShardedPlanExecutor :41)"),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (all return int = cudaError_t)
_SIGS = {
    "b2t_matvec": (_P, _P, _P, _P, _P, _P, _L, _I, _P, _P),
    "b2t_matvec_units": (_P, _P, _P, _P, _P, _P, _L, _I, _P, _P),
    "b2t_gather": (_P, _P, _L, _P, _P),
    "b2t_diag": (_P, _P, _P, _P, _I, _I, _P, _P),
    "b2t_mix": (_P, _P, _P, _P, _P, _P, _I, _P, _P),
    "b2t_place": (_P, _P, _P, _P, _I, _L, _P, _P),
    "b2t_block": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _L, _I,
                  _I, _I, _P, _P),
    "b2t_block_units": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P,
                        _L, _I, _I, _I, _P, _P),
    "b2t_noise": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                  _P),
    "b2t_tiled": (_P, _P, _P, _P, _P, _P, _L, _I, _P, _P),
    "b2t_bucket": (_P, _P, _P, _P, _P, _P, _L, _I, _P, _P),
    "b2t_bucket_blk": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P),
    "b2t_slab": (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    "b2t_stk_mix": (_P, _P, _I, _P, _P, _P, _P, _P, _P),
    "b2t_tblk": (_P, _P, _P, _P, _L, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _P, _P, _P, _P),
    "b2t_env_gemm": (_P, _P, _P, _P, _P, _P, _I, _P, _P),
    "b2t_place_v3": (_P,) * 15 + (_I, _I, _I, _I, _I, _L, _P, _P),
    "b2t_mix_v2": (_P, _P, _I, _P, _P, _P, _P, _P, _P),
    "b2t_slab_mv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                    _I, _I, _P, _P, _P),
    "b2t_npdm_gemm": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "b2t_plan_exec": (_P, _P, _P, _P, _P, _L, _I, _P, _P),
    "b2t_plan_exec_part": (_P, _L, _P, _P, _P, _P, _P, _I, _L, _L, _P, _P),
    "b2t_probe_dot": (_P, _P, _I, _P, _P),
    "b2t_probe_fill": (_P, _I, _P, _L, _I, _P, _P),
}
# entry-point suffix per value type; each entry has the float64 and
# float32 instances unless _TYPES lists its own
_SUFFIX = {"float64": "_f64", "float32": "_f32", "complex128": "_c128",
           "complex64": "_c64"}
_TYPES = {"b2t_tiled": ("_f64", "_f32", "_c128", "_c64"),
          "b2t_npdm_gemm": ("_f64", "_c128"),
          "b2t_probe_dot": ("_f32",), "b2t_probe_fill": ("_f32",)}


def _types(entry: str):
    return _TYPES.get(entry, ("_f64", "_f32"))

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
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.time()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, obj, proc in jobs:
        logs.append(" ".join(cmd) + "\n" + proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{obj.name}: nvcc exit {proc.returncode}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link: nvcc exit {proc.returncode}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    dt = time.time() - t0
    build_log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(build_log)
    if failed:
        raise RuntimeError(f"nvcc failed ({'; '.join(failed)}):\n"
                           f"{build_log}")
    os.replace(tmp, out)
    return dt


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        build()
        cdll = ctypes.CDLL(str(library_path()))
        for name, args in _SIGS.items():
            for sfx in _types(name):
                fn = getattr(cdll, name + sfx)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
        cdll.b2t_error_string.argtypes = [ctypes.c_int]
        cdll.b2t_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


_INTS = (torch.int32, torch.int64)
# (entry, torch dtype) -> its C function, resolved once (see _bind)
_fns: Dict[Tuple[str, torch.dtype], Callable] = {}


def _bind(entry: str, dtype) -> Callable:
    """The C function of ``entry`` for ``dtype`` (loading the library on
    first use), cached for every later call."""
    sfx = _SUFFIX.get(str(dtype).rsplit(".", 1)[-1])
    if sfx not in _types(entry):
        raise TypeError(f"{entry} has no {dtype} instance (it takes "
                        f"{', '.join(t[1:] for t in _types(entry))})")
    fn = _fns[(entry, dtype)] = getattr(lib(), entry + sfx)
    return fn


def current_device() -> int:
    """The index of the current CUDA device, read through PyTorch's own
    getter (what ``torch.cuda.current_device()`` returns once CUDA is
    initialised)."""
    return torch._C._cuda_getDevice()


def current_stream_handle(device: Optional[int] = None) -> int:
    """The raw handle of the current CUDA stream of ``device`` (default:
    the current device) — what ``torch.cuda.current_stream().cuda_stream``
    gives, read through PyTorch's own getter without building a Stream
    object."""
    return torch._C._cuda_getCurrentRawStream(
        current_device() if device is None else device)


def call(entry: str, dtype, *args) -> None:
    """Call C entry ``entry`` (``_f64``/``_f32``/``_c128``/``_c64`` picked
    from ``dtype``, a torch dtype) with ``args`` followed by the current
    CUDA stream; raise on a CUDA error.  Tensor arguments are validated
    (contiguous CUDA tensors of ``dtype``, int32 or int64, the only types
    the kernels take, on the current CUDA device, where the C entries
    launch) and passed as device pointers.  A tensor on another card is
    refused, not moved: the caller picks the device
    (``torch.cuda.device``)."""
    cargs = []
    dev = None
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_cuda or not a.is_contiguous():
                raise ValueError("kernel inputs must be contiguous CUDA "
                                 f"tensors (got {a.device}, contiguous="
                                 f"{a.is_contiguous()})")
            if a.dtype != dtype and a.dtype not in _INTS:
                raise TypeError(f"kernel input of dtype {a.dtype} "
                                f"(expected {dtype}, int32 or int64)")
            if dev is None:
                dev = current_device()
            if a.get_device() != dev:
                raise ValueError(f"kernel input on cuda:{a.get_device()} "
                                 f"but the current CUDA device is cuda:"
                                 f"{dev}, where the kernels launch")
            a = a.data_ptr()
        cargs.append(a)
    fn = _fns.get((entry, dtype)) or _bind(entry, dtype)
    err = fn(*cargs, current_stream_handle(dev))
    if err != 0:
        msg = lib().b2t_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err} ({msg})")


def launch(kernel: str, entry: str, dtype, *args, units: int = 0) -> None:
    """:func:`call` for the main launch of ``kernel``, counted once;
    ``units``, the CUDA blocks of the launch, are summed where the caller
    gives them (the sharded kernels: one rank's share of a plan)."""
    call(entry, dtype, *args)
    KERNELS[kernel].launches += 1
    KERNELS[kernel].units += units


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.units = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def unit_counts() -> Dict[str, int]:
    return {name: k.units for name, k in KERNELS.items()}
