"""block2_preview_tpu_torch — the PyTorch + CUDA port of block2_preview_tpu.

The JAX package (``block2_preview_tpu``) stays the reference.  This package
runs the same SZ two-site ground-state DMRG step on an NVIDIA Hopper card:
the effective-Hamiltonian step (LW/RW mix, diagonal, sigma matvec,
Davidson) runs on the device through hand-written CUDA kernels
(``csrc/*.cu``), built with ``nvcc`` for ``sm_90a`` at first use.

It never imports JAX.  It reuses the reference's jax-free host modules
(``core``, ``dmrg.mpo_builder``/``mps``/``environment``/``effective``/
``sweep``, ``driver.core``, ``ops.davidson``, ``ops.blocking``) unchanged,
and carries copies of the host plan builders that live in jax-importing
reference files (``ops/stacked``, ``tiled``, ``tilev2``, ``mixv3``,
``mixv4``, ``resident``), so every kernel can be compared with its JAX
counterpart on the same plan.

Layer map:
  runtime.py       device + dtype policy (explicit device, TF32 off)
  interop.py       reference host objects -> port device structs
  ops/             plan builders (numpy), kernel wrappers + plain twins,
                   on-device Davidson, the per-site ResidentSite
  csrc/            CUDA C++ kernels K1-K4 (plain C interface, ctypes)
  dmrg/sweep.py    DMRG driver class (host blocking, host noise term)
  driver/core.py   DMRGDriver.dmrg(..., device=...) entry point
"""

__version__ = "0.1.0"
