"""Process setup, the 1-D device mesh and the collectives of the sharded
engines.

Counterpart of block2_preview_tpu/parallel/multihost.py:1-90 on
``torch.distributed``.  Every process runs the same program; a process
group joins them and a 1-D ``DeviceMesh`` over the whole world, its one
dimension named ``axis`` ("op"), plays the part of the reference's global
``jax.sharding.Mesh``.  Block2's distributed-operator parallelism follows:
owners compute, an ``all_reduce`` sums the partials.

Environment contract (the reference's ``B2TPU_*`` names; torchrun's names
in place of JAX's):
  B2TPU_COORDINATOR  host:port of process 0 (or MASTER_ADDR + MASTER_PORT)
  B2TPU_NUM_PROCS    total process count      (or WORLD_SIZE)
  B2TPU_PROC_ID      this process's rank      (or RANK)

With none of these set, :func:`ensure_distributed` is a no-op and
:func:`global_mesh` is a mesh of world size 1 in this process.  Every
process group gets a timeout, so a rank whose partner never joins a
collective fails instead of waiting forever.  Nothing falls back: a
backend that cannot be created, or a collective that fails, raises.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(seconds=600)

# collectives issued by this process, read per sweep by DMRG.sweep_log;
# their wall time only while timing is on (time_collectives), as that
# synchronises the device around each collective
stats = {"all_reduce": 0, "all_reduce_s": 0.0}
_timed = False


def time_collectives(on: bool = True) -> None:
    """Turn the timing of :func:`all_reduce_` into ``stats`` on or off.
    While on, every collective synchronises the device before and after,
    so that no kernel's time is counted in it; off (the default), the
    collective is issued on the stream with no host synchronisation."""
    global _timed
    _timed = bool(on)


def distributed_spec() -> Optional[Tuple[str, int, int]]:
    """(coordinator host:port, number of processes, this process's rank)
    from the environment, or None when running single-process."""
    coord = os.environ.get("B2TPU_COORDINATOR")
    if not coord and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
    if not coord:
        return None
    nproc = int(os.environ.get("B2TPU_NUM_PROCS")
                or os.environ.get("WORLD_SIZE") or 1)
    pid = int(os.environ.get("B2TPU_PROC_ID")
              or os.environ.get("RANK") or 0)
    return coord, nproc, pid


def default_backend(device_type: str) -> str:
    """NCCL between CUDA devices, gloo between CPU processes."""
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_distributed(backend: Optional[str] = None,
                       timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group once when a multi-process spec is present;
    returns True when running multi-process.  ``backend`` defaults to
    NCCL where CUDA is available and gloo otherwise."""
    spec = distributed_spec()
    if spec is None:
        return False
    if not dist.is_initialized():
        coord, nproc, pid = spec
        dist.init_process_group(
            backend or default_backend(
                "cuda" if torch.cuda.is_available() else "cpu"),
            init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
            timeout=timeout)
    return True


def _mesh(device_type: str, axis: str):
    """The 1-D mesh over the whole world of the initialised group; a CUDA
    rank first selects its device (runtime.rank_device's rule)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..runtime import local_cuda_device
    if device_type == "cuda":
        torch.cuda.set_device(local_cuda_device(dist.get_rank()))
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def _check_device_type(device_type: str):
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was requested but CUDA is not "
                           "available")


def global_mesh(axis: str = "op", device_type: str = "cuda",
                backend: Optional[str] = None,
                timeout: timedelta = DEFAULT_TIMEOUT):
    """1-D mesh over every rank of every process (after
    :func:`ensure_distributed`); single-process, a mesh of world size 1
    whose group lives in this process (an in-process store, no socket)."""
    _check_device_type(device_type)
    backend = backend or default_backend(device_type)
    ensure_distributed(backend, timeout)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return _mesh(device_type, axis)


def init_mesh(init_method: str, world_size: int, rank: int,
              device_type: str = "cuda", backend: Optional[str] = None,
              axis: str = "op", timeout: timedelta = DEFAULT_TIMEOUT):
    """Join a group of ``world_size`` ranks at ``init_method``
    (``file://...`` or ``tcp://host:port``) as ``rank`` and return its 1-D
    mesh: what a launcher that does not set the environment contract (a
    test's spawned ranks) calls in each rank."""
    _check_device_type(device_type)
    dist.init_process_group(backend or default_backend(device_type),
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)
    return _mesh(device_type, axis)


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_local_slice(n: int) -> slice:
    """Contiguous slice of n work items owned by this process (for
    host-side plan building ahead of a mesh step)."""
    pid, np_ = process_info()
    per = -(-n // np_)
    return slice(pid * per, min((pid + 1) * per, n))


# ---------------------------------------------------------------------------
# the mesh axis and its collectives
# ---------------------------------------------------------------------------

def axis_info(mesh, axis: str = "op"):
    """(process group, this rank's index, size) of ``mesh``'s ``axis``."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (the reference's psum) and return
    it.  Counted in :data:`stats`, and timed there under
    :func:`time_collectives`."""
    stats["all_reduce"] += 1
    if not _timed:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t
    _sync(t)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _sync(t)
    stats["all_reduce_s"] += time.perf_counter() - t0
    return t


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of the group's first rank, in place on every rank."""
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


def broadcast_object(obj, group, device: torch.device):
    """The picklable ``obj`` of the group's first rank, on every rank.
    NCCL moves the bytes through ``device``; gloo through the host."""
    dev = device if dist.get_backend(group) == "nccl" else None
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group, device=dev)
    return box[0]


def all_gather_rows(part: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped row blocks ``part``, stacked in rank order
    (the reference's gather of a row-sharded result)."""
    world = dist.get_world_size(group)
    out = [torch.empty_like(part) for _ in range(world)]
    dist.all_gather(out, part.contiguous(), group=group)
    return torch.cat(out, 0)
