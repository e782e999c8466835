"""Reference host objects -> the port's structures.

The JAX package's plan builders and the port's copies produce the same
tables; these helpers take a plan built by the reference and hand it to
the port's executors, so one plan can run through a JAX kernel and the
matching port kernel side by side.  Only attributes are read: nothing
here imports JAX.  The MPO and MPS are the reference's host objects and
need no conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.mixv4 import MixPlanV4
from .ops.stacked import StackedMeta
from .ops.tilev2 import MatvecV2
from .runtime import torch_dtype


def stacked_meta(ref_meta) -> StackedMeta:
    """Port StackedMeta with the reference meta's groups and sectors."""
    return StackedMeta(ref_meta.groups, ref_meta.sectors, ref_meta.total)


def mix_plan_v4(ref_plan) -> MixPlanV4:
    """Port MixPlanV4 from a reference MixPlanV4 (host fields only; the
    reference's packed upload is not carried)."""
    p = MixPlanV4()
    for k in MixPlanV4.__slots__:
        setattr(p, k, getattr(ref_plan, k))
    p.meta_out = stacked_meta(ref_plan.meta_out)
    return p


def matvec_v2(ref_ex, dtype=np.float64) -> MatvecV2:
    """Port MatvecV2 around a reference MatvecV2's host struct."""
    ex = MatvecV2.__new__(MatvecV2)
    ex.dtype = dtype
    ex.space, ex.bra_space = ref_ex.space, ref_ex.bra_space
    ex.size, ex.out_size = ref_ex.size, ref_ex.out_size
    ex.struct = {k: v for k, v in ref_ex.struct.items()
                 if not k.startswith("_")}
    ex._dev = None
    return ex


def diag_struct(ref_ds) -> dict:
    """Port diag struct from the reference's build_diag_struct output."""
    return {k: v for k, v in ref_ds.items() if not k.startswith("_")}


def slab_pool(pool, device, dtype=np.float64) -> torch.Tensor:
    """A host (numpy) slab pool as a device tensor in the working dtype."""
    return torch.tensor(np.asarray(pool), dtype=torch_dtype(dtype),
                        device=device)
