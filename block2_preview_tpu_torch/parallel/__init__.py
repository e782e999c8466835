"""Operator-sharded execution over ``torch.distributed``.

Counterpart of ``block2_preview_tpu/parallel/``: ``multihost`` (the process
contract, the 1-D device mesh and the collectives) and ``shard``
(``ShardedPlanExecutor``, ``default_mesh``).  A mesh here is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` whose one dimension is named
by ``axis`` ("op" by default), in place of ``jax.sharding.Mesh``.

Under ``torch.distributed`` every rank runs the whole program (SPMD), not
one controller driving every device.  So every rank issues the same
collectives in the same order: each holds every pool replicated, runs its
share of the task groups or batch items on its own device, and sums the
partials with ``all_reduce`` — the counterpart of the reference's
``psum``.  Not carried yet: ``multi_center`` (two-level nesting over
sub-meshes) and ``sum_mpo`` (ROADMAP queue A).
"""
