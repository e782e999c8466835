"""Native (C++/OpenMP) host executors of the numpy path, built on demand
with g++ and bound with ctypes.

Copied from block2_preview_tpu/native/__init__.py: ``sandwich.cpp`` runs the
host blocking plans (``ops/blocking_plan.execute_plan_native``) and the
host LW/RW assembly (``ops/blocking.assemble_fused_ops``) of the host
environments, in float64 and (``_z`` entries, real coefficients)
complex128, where numpy overhead over millions of tiny quantum-number
blocks would otherwise dominate.  The library is built into ``build/native/`` beside the
package (git-ignored; the file name carries a hash of the source), never at
import.  Without g++ the callers fall back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "sandwich.cpp"
BUILD_DIR = _SRC.parents[2] / "build" / "native"
# -fcx-limited-range: plain complex products (no C99 inf/nan recovery)
_CMD = ["g++", "-O3", "-march=native", "-fopenmp", "-fcx-limited-range",
        "-shared", "-fPIC"]

_LIB = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    h = hashlib.sha1(" ".join(_CMD).encode() + _SRC.read_bytes())
    so = BUILD_DIR / f"libsandwich_{h.hexdigest()[:12]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(_CMD + [str(_SRC), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    asm_args = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    sw_args = [
        ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    # the _z entries take complex128 pools through the same double
    # pointers (interleaved re, im)
    for name, args in (("assemble_exec", asm_args),
                       ("sandwich_exec", sw_args)):
        for fn in (getattr(lib, name), getattr(lib, name + "_z")):
            fn.restype = None
            fn.argtypes = args
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build_and_load()
    return _LIB
