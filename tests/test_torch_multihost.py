"""The port's process contract (block2_preview_tpu_torch/parallel/
multihost.py; mirrors tests/test_multihost.py): the single-process no-op,
the B2TPU_* and torchrun spec parsing, a real join through the contract
on localhost, and global_mesh() driving the sharded blocking with the
reference's parity."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from block2_preview_tpu_torch import interop
from block2_preview_tpu_torch.ops import blockv2 as bv2
from block2_preview_tpu_torch.parallel.multihost import (distributed_spec,
                                                         ensure_distributed,
                                                         global_mesh,
                                                         host_local_slice,
                                                         process_info)
from block2_preview_tpu_torch.runtime import rank_device

from test_torch_blockv2 import BONDS, _jax_out, _plans, chain  # noqa: F401

_VARS = ("B2TPU_COORDINATOR", "B2TPU_NUM_PROCS", "B2TPU_PROC_ID",
         "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_single_process_fallback(clean_env):
    assert distributed_spec() is None
    assert ensure_distributed() is False
    assert not dist.is_initialized()
    assert process_info() == (0, 1)
    assert host_local_slice(10) == slice(0, 10)


def test_spec_parsing(clean_env):
    clean_env.setenv("B2TPU_COORDINATOR", "10.0.0.1:1234")
    clean_env.setenv("B2TPU_NUM_PROCS", "4")
    clean_env.setenv("B2TPU_PROC_ID", "2")
    assert distributed_spec() == ("10.0.0.1:1234", 4, 2)
    # torchrun's names stand in for JAX's; the B2TPU_* names win
    clean_env.setenv("MASTER_ADDR", "10.0.0.9")
    clean_env.setenv("MASTER_PORT", "29511")
    clean_env.setenv("WORLD_SIZE", "3")
    clean_env.setenv("RANK", "1")
    assert distributed_spec() == ("10.0.0.1:1234", 4, 2)
    for k in ("B2TPU_COORDINATOR", "B2TPU_NUM_PROCS", "B2TPU_PROC_ID"):
        clean_env.delenv(k)
    assert distributed_spec() == ("10.0.0.9:29511", 3, 1)


def test_ensure_distributed_joins_through_the_contract(clean_env):
    """A one-process world joined through B2TPU_* over a localhost TCP
    store (gloo): process_info, host_local_slice and the mesh follow."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    clean_env.setenv("B2TPU_COORDINATOR", f"127.0.0.1:{port}")
    clean_env.setenv("B2TPU_NUM_PROCS", "1")
    clean_env.setenv("B2TPU_PROC_ID", "0")
    try:
        assert ensure_distributed(backend="gloo") is True
        assert dist.get_backend() == "gloo"
        assert process_info() == (0, 1)
        assert host_local_slice(7) == slice(0, 7)
        mesh = global_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("op",) and mesh.size() == 1
        assert rank_device(mesh, None) == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_rank_device_refuses_a_missing_card(clean_env):
    """A CUDA rank device raises where there is no CUDA (no fallback to
    the CPU), and global_mesh refuses a CUDA mesh there."""
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        global_mesh(device_type="cuda")
    assert not dist.is_initialized()
    mesh = global_mesh(device_type="cpu")
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rank_device(mesh, "cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mix", [False, True], ids=["v2", "v3"])
def test_global_mesh_drives_sharded_blocking(chain, clean_env,  # noqa
                                             mix):
    """global_mesh() (single process: a world of one) plugs straight into
    the sharded blocking (K21's twin + all_reduce) with the reference's
    parity bar, against the unsharded blocking and the JAX package's."""
    mesh = global_mesh(device_type="cpu")
    try:
        assert mesh.size() == 1
        for t in BONDS["left"]:
            ref, port, pool = _plans(chain, t, "left", mix)
            run = bv2.execute_blocking_v3 if mix else \
                bv2.execute_blocking_v2
            tp = interop.slab_pool(pool, "cpu")
            out1 = run(port, tp).numpy()
            out_m = run(port, tp, mesh=mesh).numpy()
            scale = np.abs(out1).max()
            assert np.abs(out1 - out_m).max() < 1e-11 * scale
            assert np.abs(out_m - _jax_out(ref, pool, mix)).max() \
                < 1e-11 * scale
    finally:
        dist.destroy_process_group()


def test_all_reduce_is_timed_only_when_asked(clean_env):
    """all_reduce_ counts every collective; it adds wall time to the stats
    only under time_collectives() (off by default, so the production path
    issues the collective without synchronising the device)."""
    from block2_preview_tpu_torch.parallel import multihost
    mesh = global_mesh(device_type="cpu")
    try:
        group = mesh.get_group("op")
        n0, s0 = multihost.stats["all_reduce"], multihost.stats[
            "all_reduce_s"]
        t = torch.ones(4, dtype=torch.float64)
        multihost.all_reduce_(t, group)
        assert multihost.stats["all_reduce"] == n0 + 1
        assert multihost.stats["all_reduce_s"] == s0
        multihost.time_collectives()
        try:
            multihost.all_reduce_(t, group)
        finally:
            multihost.time_collectives(False)
        assert multihost.stats["all_reduce"] == n0 + 2
        assert multihost.stats["all_reduce_s"] > s0
        assert torch.equal(t, torch.ones(4, dtype=torch.float64))
    finally:
        dist.destroy_process_group()
