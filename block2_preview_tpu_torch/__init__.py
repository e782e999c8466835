"""block2_preview_tpu_torch — the PyTorch + CUDA port of block2_preview_tpu.

The JAX package (``block2_preview_tpu``) stays the reference.  This package
runs the same SZ two-site ground-state DMRG on an NVIDIA Hopper card:
environment blocking, the LW/RW mix, the diagonal, the sigma matvec inside
the Davidson solver and the perturbative-noise density matrix run on the
device through hand-written CUDA kernels (``csrc/*.cu``, K1-K6), built with
``nvcc`` for ``sm_90a`` at first use.  Only the center wavefunction, the
initial guess, the small noise density matrix and scalars cross between
host and device; decimation stays on the host.

It imports neither JAX nor the JAX package: it keeps its own copies of the
host modules it needs (``core``, ``dmrg``, ``driver``, ``ops`` plan
builders, the native host executor), so every kernel can be compared with
its JAX counterpart on the same plan (``tests/test_torch_*.py``).

Layer map:
  runtime.py       device + dtype policy (default "cuda", TF32 off)
  interop.py       reference objects (MPO, MPS, plans) -> port classes
  core/            symmetry, state info, block matrices, FCIDUMP, terms
  dmrg/            MPO/MPS, environments (host maps or device pools),
                   effective-Hamiltonian spaces, the DMRG sweeps, TDVP,
                   expectation values and N-particle density matrices
  ops/             plan builders (numpy), kernel wrappers + plain twins,
                   on-device Davidson, the per-site ResidentSite
  csrc/            CUDA C++ kernels K1-K19 (plain C interface, ctypes)
  utils/           the chip probes (gpu_smoke) and the exact-
                   diagonalization oracle (ed)
  native/          C++ host executor of the numpy path (g++, ctypes)
  driver/core.py   DMRGDriver.dmrg(...) entry point
"""

__version__ = "0.1.0"
