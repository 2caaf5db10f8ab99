"""Elastic scaling, ported from `repro.distributed.elastic`: re-lay a
training state out on another mesh.

The sharding rules are functions of the mesh, so elasticity is: load the
state, compute the new mesh's layout, place each leaf.  The port runs on
one device (`launch.mesh`), so placing is moving every leaf to the
mesh's device (`sharding.place`), values kept.  Batches keep their step
addressing (data/pipeline.py): training resumes where it left off with
another data-parallel width.
"""

from __future__ import annotations

from repro_torch.distributed import sharding


def reshard_state(state, new_mesh):
    """Every leaf of `state` on the one-device `new_mesh`, values kept."""
    return sharding.place(state, new_mesh)


def rebalance_batch(global_batch: int, new_mesh) -> int:
    """Per-host batch after an elastic resize (global batch preserved when
    divisible; otherwise the largest divisible batch <= requested)."""
    dp = 1
    for a in sharding.dp_axes(new_mesh):
        dp *= new_mesh.shape[a]
    return (global_batch // dp) * dp
