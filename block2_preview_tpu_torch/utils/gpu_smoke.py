"""Chip probes of the port — kernel K19 and the tiled-solve probe.

Counterpart of block2_preview_tpu/utils/tpu_smoke.py: three behaviours of
the card that no CPU test sees, one probe each, on a given torch device.

* ``precision_f32``: a float32 product must run in full float32.  On this
  card the hazard is TF32 (10 mantissa bits) in the float32 matmul, not
  the TPU's bf16 passes, so the inputs are chosen to be exact in float32
  and visibly rounded by TF32: entries 1 + (4 r + 1) 2^-12 lose their last
  bit (2.4e-4 relative each).  The probe runs the product through K19's
  float32 dot (``dot``) and through the port's float32 matmul glue
  (``torch.matmul``, under ``runtime.set_precision_policy()``); both must
  agree with float64 to 1e-4.
* ``large_pool``: one launch of K19's ``fill`` writes a 2^27-element
  float32 pool (2 x at its head, zeros after) and reduces it to 2048.
* ``tiled_solve``: a float32 DMRG on ``torch_tiled`` (Hubbard-L8, D=120,
  6 sweeps; built in code, ``FCIDUMP.hubbard``) within 5e-4 Ha of exact
  diagonalization (``utils/ed.py``).

``dot`` and ``fill`` launch K19 (``csrc/probe.cu``) on CUDA tensors and
run their plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import _kernels

PRECISION_TOL = 1e-4     # relative; TF32 rounding of the inputs errs ~5e-4
POOL_ELEMS = 1 << 27     # the large-pool probe's pool


def _f32(*ts):
    for t in ts:
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"the probes take 1-D float32 tensors (got "
                            f"{t.dtype}, {t.dim()}-D)")


def dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K19's dot: sum a b in float32."""
    _f32(a, b)
    return (a * b).sum(dtype=torch.float32)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a[i] b[i] in float32 with float32 accumulation (kernel K19
    on CUDA tensors, :func:`dot_plain` on CPU tensors); a 0-d tensor."""
    _f32(a, b)
    dev = a.device
    if a.shape != b.shape or dev != b.device:
        raise ValueError(f"dot: {tuple(a.shape)} on {dev} and "
                         f"{tuple(b.shape)} on {b.device}")
    if dev.type == "cpu":
        return dot_plain(a, b)
    # the kernel stores the sum: no fill.  At 2048 values the card waits
    # on this wrapper (PERF.md), so it reads the device once.
    out = torch.empty((), dtype=torch.float32, device=dev)
    _kernels.launch("K19_probe", "b2t_probe_dot", torch.float32,
                    a.contiguous(), b.contiguous(), a.numel(), out)
    return out


def fill_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K19's fill: a zero pool of n float32 elements with
    2 x at its head, summed."""
    _f32(x)
    pool = x.new_zeros(n)
    pool[:x.numel()] = 2.0 * x
    return pool.sum()


def fill(x: torch.Tensor, n: int = POOL_ELEMS) -> torch.Tensor:
    """Write a pool of n float32 elements (2 x at its head, zeros after)
    and reduce it, in one launch of kernel K19 on a CUDA tensor
    (:func:`fill_plain` on a CPU tensor); the sum as a 0-d tensor."""
    _f32(x)
    if x.numel() > n:
        raise ValueError(f"fill: {x.numel()} values into a pool of {n}")
    if x.device.type == "cpu":
        return fill_plain(x, n)
    pool = x.new_empty(n)
    out = x.new_zeros(1)
    # grid-stride blocks, four per SM
    blocks = 4 * torch.cuda.get_device_properties(x.device) \
        .multi_processor_count
    _kernels.launch("K19_probe", "b2t_probe_fill", torch.float32,
                    x.contiguous(), x.numel(), pool, n, blocks, out)
    return out[0]


def precision_inputs(n: int = 2048, seed: int = 0):
    """(a, b) float32 vectors of entries 1 + (4 r + 1) 2^-12, r in
    [0, 60): exact in float32, each rounded by TF32 to 1 + r 2^-10."""
    rng = np.random.RandomState(seed)
    a, b = ((1.0 + (4 * rng.randint(0, 60, n) + 1) * 2.0 ** -12)
            .astype(np.float32) for _ in range(2))
    return a, b


def precision_probe(device, rows: int = 256, inputs=None) -> Dict:
    """The float32 product of :func:`precision_inputs` through K19's dot
    and through a float32 matmul ([rows, n] @ [n, rows], every entry the
    same dot) on ``device``, against float64.  It does not set the
    precision policy: the caller runs it under the one it checks.
    ``inputs`` (a, b), when given, go into the products in place of the
    probe's own (the reference stays theirs): the tests hand in copies
    rounded as TF32 rounds, which the probe must catch."""
    a, b = precision_inputs()
    ref = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    if inputs is not None:
        a, b = inputs
    ta = torch.as_tensor(a, device=device)
    tb = torch.as_tensor(b, device=device)
    got = float(dot(ta, tb))
    mm = ta.expand(rows, -1).contiguous() @ tb[:, None].expand(-1, rows)
    if mm.is_cuda:
        torch.cuda.synchronize(mm.device)
    mm = mm.double().cpu().numpy()
    rel_dot = abs(got - ref) / abs(ref)
    rel_mm = float(np.abs(mm - ref).max()) / abs(ref)
    rel = max(rel_dot, rel_mm)
    return {"ok": bool(rel < PRECISION_TOL), "rel_err": rel,
            "dot_rel_err": rel_dot, "matmul_rel_err": rel_mm}


def large_pool_probe(device, n_elems: int = POOL_ELEMS) -> Dict:
    """One launch writing an n_elems float32 output pool, reduced to
    2 x 1024 = 2048."""
    val = float(fill(torch.ones(1024, dtype=torch.float32, device=device),
                     n_elems))
    return {"ok": abs(val - 2048.0) < 1e-3, "value": val}


def tiled_solve_probe(device, L: int = 8, D: int = 120,
                      n_sweeps: int = 6) -> Dict:
    """One float32 torch_tiled DMRG solve of Hubbard-L (U=2, t=1, half
    filling) on ``device``: within the float32 floor (5e-4 Ha) of the
    exact energy."""
    from ..core.expr import qc_term_table
    from ..core.fcidump import FCIDUMP
    from ..dmrg.mpo_builder import build_mpo
    from ..dmrg.mps import MPS, MPSInfo
    from ..dmrg.sweep import DMRG
    from .ed import ground_state_energy

    fd = FCIDUMP.hubbard(L, u=2, t=1)
    tt = qc_term_table(fd)
    mpo = build_mpo(tt, site_pgs=fd.orb_sym, const_e=fd.const_e)
    info = MPSInfo(mpo.group, mpo.site_quanta,
                   (fd.n_elec, fd.twos, fd.ipg), D)
    mps = MPS.random(info, seed=1)
    d = DMRG(mpo, mps, device=device, backend="torch_tiled",
             dtype=np.float32, iprint=0)
    e = d.solve([D], [1e-4, 1e-5, 0], [1e-7], n_sweeps=n_sweeps, tol=1e-9)
    e_ref = ground_state_energy(tt, fd.n_elec, fd.twos, fd.const_e)[0]
    err = float(abs(float(np.atleast_1d(e)[0]) - e_ref))
    return {"ok": bool(err < 5e-4), "abs_err": err, "energy": float(
        np.atleast_1d(e)[0]), "exact": float(e_ref)}


def run_smoke(device="cuda", pool_elems: int = POOL_ELEMS,
              tiled=(8, 120, 6)) -> Dict:
    """Run all probes on ``device`` ("cuda" by default, no fallback) under
    the port's precision policy.  ``pool_elems`` and ``tiled`` (L, D,
    sweeps) size the second and third probe."""
    from ..runtime import resolve_device, set_precision_policy
    dev = resolve_device(device)
    set_precision_policy()
    out: Dict = {"device": str(dev) if dev.type == "cpu"
                 else torch.cuda.get_device_name(dev)}
    for name, fn in (("precision_f32", lambda: precision_probe(dev)),
                     ("large_pool", lambda: large_pool_probe(dev,
                                                             pool_elems)),
                     ("tiled_solve", lambda: tiled_solve_probe(dev,
                                                               *tiled))):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"ok": False, "error": repr(e)[:200]}
    out["ok"] = all(v.get("ok") for k, v in out.items()
                    if isinstance(v, dict))
    return out
