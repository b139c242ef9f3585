"""Parallel layer: slices sharded over member devices, cross-member reduces.

The port's counterpart of ``pilosa_tpu/parallel``: the slice->node
map/reduce of the reference (executor.go:1131-1283) inside one host,
over the member devices of ``ops/bitplane.participating_devices`` — the
cards of a host, or a list of logical members a caller set — and across
processes over ``torch.distributed`` (``parallel/multihost.py``).
"""

from pilosa_tpu_torch.parallel.mesh import (
    AXIS_ROWS,
    AXIS_SLICES,
    Mesh,
    Sharded,
    ShardedTable,
    distributed_count,
    distributed_topn,
    query_step,
    shard,
    shard_planes,
    slice_mesh,
)

__all__ = [
    "AXIS_SLICES",
    "AXIS_ROWS",
    "Mesh",
    "Sharded",
    "ShardedTable",
    "slice_mesh",
    "shard",
    "shard_planes",
    "distributed_count",
    "distributed_topn",
    "query_step",
]
