"""Multi-host meshes over ``torch.distributed``.

The port's counterpart of ``pilosa_tpu/parallel/multihost.py``.  Two
distribution regimes compose, as in the JAX package:

1. **HTTP+protobuf across clusters of independent hosts** — the
   reference-compatible path (``net/``, ``cluster/``): each node owns
   slices, queries fan out, reduces merge on the coordinator.
2. **One process group across hosts** — every process of a run joins
   one ``torch.distributed`` group; each keeps its own slices on its
   local members (``ops/bitplane.participating_devices``), and the
   cross-process reduce of ``parallel/mesh``'s distributed Count and
   TopN is one ``all_reduce(SUM)`` of int64 totals over the group (NCCL
   for CUDA members, gloo for CPU ones) — the counterpart of the JAX
   package's psum over ICI/DCN.

:func:`initialize` reads the JAX package's own variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so one launcher drives either package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitplane as bp


def _backend() -> str:
    members = bp.participating_devices()
    return "nccl" if members and members[0].type == "cuda" else "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join this process to a multi-host process group.

    Gates on ``JAX_COORDINATOR_ADDRESS`` (or the explicit argument,
    ``host:port``); ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` give the
    world size and this process's rank (torch has no cluster
    auto-detection, so they default to 1 and 0).  The backend is NCCL
    when the local members are CUDA devices, gloo otherwise; the group
    initializes over ``tcp://``.  A CUDA process binds its rank's card
    (``cuda:<rank mod visible>``) first, as NCCL wants one card a rank.
    No-ops when unconfigured (single-host deployments) or when the
    process group already exists."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    if dist.is_initialized():
        return
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None:
        num_processes = int(env_np) if env_np is not None else 1
    if process_id is None:
        process_id = int(env_pid) if env_pid is not None else 0
    backend = backend or _backend()
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )


def is_multihost() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def group():
    """The process group a mesh reduces over, or None outside a
    multi-host run."""
    import torch.distributed as dist

    return dist.group.WORLD if is_multihost() else None


def global_device_count() -> int:
    """Every member device of the run: this process's local members,
    summed over the process group."""
    n = len(bp.local_members())
    if not is_multihost():
        return n
    return int(all_reduce_sum(np.asarray([n], dtype=np.int64))[0])


def all_reduce_sum(values: np.ndarray, pg=None) -> np.ndarray:
    """The element-wise int64 sum of ``values`` over the process group:
    one ``all_reduce(SUM)`` (NCCL's collective on a CUDA group, gloo's
    on a CPU one)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64))
    if dist.get_backend(pg) == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=pg)
    return t.cpu().numpy()
