"""Migration planner — the slice-ownership diff between two rings.

Placement is pure in (index, slice, ring), so the plan is computed
identically on any node from the transition's old/new host lists: for
every slice of every index, owners on the old ring vs owners on the new
ring; slices whose owner SET changes become one :class:`SliceMove`
(copy to the hosts gaining it, release from the hosts losing it).
Order-only changes (same owner set, different primary) need no data
movement — the commit re-routes them with the data already in place.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SliceMove:
    """One slice's migration: stream from a ``source`` replica to every
    ``target``, then release from every ``release`` host."""

    index: str
    slice: int
    sources: tuple[str, ...]  # old-ring owners (serve reads during copy)
    targets: tuple[str, ...]  # new-ring owners that lack the slice
    releases: tuple[str, ...]  # old-ring owners not in the new ring

    @property
    def key(self) -> str:
        return f"{self.index}/{self.slice}"


def compute_plan(cluster, index_max_slices: dict[str, int]) -> list[SliceMove]:
    """Per-fragment migration plan for the cluster's ACTIVE transition.

    ``index_max_slices`` maps each index to the max slice to consider —
    callers pass ``max(max_slice, max_inverse_slice)`` since standard
    and inverse fragments of slice *i* share one placement.  Slices
    already flipped still appear in the plan (the coordinator skips
    them from its persisted per-slice state on resume)."""
    t = cluster.transition
    if t is None:
        return []
    old_ring = [cluster.node_by_host(h) or _node(h) for h in t.old_hosts]
    new_by_host = {n.host: n for n in t.new_nodes}
    new_ring = [new_by_host[h] for h in t.new_hosts]
    moves: list[SliceMove] = []
    for index in sorted(index_max_slices):
        for s in range(index_max_slices[index] + 1):
            pid = cluster.partition(index, s)
            old = [n.host for n in cluster.partition_nodes_over(pid, old_ring)]
            new = [n.host for n in cluster.partition_nodes_over(pid, new_ring)]
            if set(old) == set(new):
                continue
            moves.append(
                SliceMove(
                    index=index,
                    slice=s,
                    sources=tuple(old),
                    targets=tuple(h for h in new if h not in old),
                    releases=tuple(h for h in old if h not in new),
                )
            )
    return moves


def _node(host: str):
    from pilosa_tpu_torch.cluster.topology import NODE_STATE_UP, Node

    return Node(host=host, state=NODE_STATE_UP)
