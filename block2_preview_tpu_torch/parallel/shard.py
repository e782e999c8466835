"""Operator sharding of the padded-bucket sigma matvec — kernel K22.

Counterpart of block2_preview_tpu/parallel/shard.py (``_partial_sigma``
:30, jit :78; ``ShardedPlanExecutor`` :41; ``default_mesh``): block2's
distributed-operator parallelism as owner-computes plus an allreduce of
the partial sigma vectors (reference src/core/parallel_tensor_functions.hpp
allreduce_sum).  Every (LW block x psi block x RW block) triple adds into
sigma independently, so splitting each padded bucket's batch over the ranks
and summing the partial sigmas is exact up to the order of the sums.

Each rank holds the whole ``PlanExecutor`` (every pool replicated, the
reference's ``P()``), runs its contiguous slice of every bucket's batch on
K22 (``ops/exec_bucket.py::plan_exec_part``, K18's kernel over the true
items of the slice) and sums with ``torch.distributed.all_reduce``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.exec_bucket import PlanExecutor, plan_exec_part
from ..runtime import rank_device
from .multihost import (all_reduce_, axis_info, ensure_distributed,
                        global_mesh, process_info)


class ShardedPlanExecutor:
    """Operator-sharded sigma-vector executor over a mesh axis."""

    def __init__(self, eff, mesh, axis: str = "op", dtype=np.float64,
                 device=None):
        """``device`` is this rank's (``runtime.rank_device``: the mesh's
        device type when None)."""
        self.size = eff.size
        self.dtype = np.dtype(dtype)
        self.mesh = mesh
        self.axis = axis
        self.device = rank_device(mesh, device)
        self.group, rank, world = axis_info(mesh, axis)
        self.base = PlanExecutor(eff, dtype=dtype, device=self.device)
        self.size_p = self.base.size_p
        self.part = self.base.rank_part(rank, world)

    def matvec_device(self, xp: torch.Tensor) -> torch.Tensor:
        """Padded replicated psi [size_p + 1] (zero last slot) in, padded
        replicated sigma [size_p + 1] out, on this rank's device: the
        rank's share on K22, then ``all_reduce``."""
        return all_reduce_(plan_exec_part(xp, self.base, self.part),
                           self.group)

    def pad_device(self, x: np.ndarray) -> torch.Tensor:
        xp = np.zeros(self.size_p + 1, dtype=self.dtype)
        xp[:self.size] = x
        return torch.as_tensor(xp, device=self.device)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """H x for a host vector x [size] (float64 host values)."""
        sig = self.matvec_device(self.pad_device(x))
        return sig.cpu().numpy().astype(np.float64)[:self.size]


def default_mesh(n_devices: Optional[int] = None, axis: str = "op",
                 device_type: str = "cuda"):
    """The 1-D mesh over every rank (:func:`multihost.global_mesh`); it
    raises unless the world has ``n_devices`` ranks, where given."""
    if n_devices is not None:
        ensure_distributed()
        world = process_info()[1]
        if world != n_devices:
            raise ValueError(f"need {n_devices} ranks, the world has "
                             f"{world}")
    return global_mesh(axis, device_type)
