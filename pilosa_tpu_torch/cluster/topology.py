"""Cluster topology: slice -> partition -> node placement.

The counterpart of ``pilosa_tpu.cluster.topology`` (``:36-488``), and
hash-identical to it and to the reference (reference:
cluster.go:200-281), so that a mixed cluster of JAX and port nodes
places every slice on the same owners:

* ``partition(index, slice) = fnv64a(index || slice_be8) % PartitionN``
* the primary owner is the jump consistent hash (Lamping-Veach) of the
  partition id over the sorted node list; replicas are the next
  ``ReplicaN - 1`` nodes around the ring.

The node list is fixed once the cluster is configured.  Each node
carries a ``degraded`` flag (its card quarantined), versioned by
``health_version`` so routing caches see it flip.  The versioned
topology of the JAX package (epochs, rebalance transitions, the
write ring of a resize) is not ported yet: the write owners of a slice
are its read owners.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

# reference: cluster.go:22-31
DEFAULT_PARTITION_N = 256
DEFAULT_REPLICA_N = 1

# reference: cluster.go:33-37
NODE_STATE_UP = "UP"
NODE_STATE_DOWN = "DOWN"

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv64a(data: bytes) -> int:
    """64-bit FNV-1a (matches Go's hash/fnv)."""
    h = _FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & _MASK64
    return h


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash (Lamping & Veach 2014): ``key`` to a bucket
    in [0, n), with the reference's constants and float arithmetic
    (reference: cluster.go:268-281)."""
    b, j = -1, 0
    key &= _MASK64
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


@dataclass
class Node:
    """One cluster member (reference: cluster.go:40-45)."""

    host: str
    internal_host: str = ""
    state: str = NODE_STATE_DOWN
    # The node is up but its card is quarantined (device/health.py): it
    # answers correctly from its host planes, slower.  Coordinators
    # prefer a replica that is not degraded (executor._slices_by_node).
    degraded: bool = False

    def to_dict(self) -> dict:
        return {"host": self.host, "internalHost": self.internal_host}


class Cluster:
    """Node list + placement functions (reference: cluster.go:122-258)."""

    def __init__(
        self,
        nodes: list[Node] | None = None,
        partition_n: int = DEFAULT_PARTITION_N,
        replica_n: int = DEFAULT_REPLICA_N,
    ):
        self.nodes: list[Node] = sorted(nodes or [], key=lambda n: n.host)
        self.partition_n = partition_n
        self.replica_n = replica_n
        self._mu = threading.Lock()
        self._health_version = 0

    # --- membership ---

    def node_by_host(self, host: str) -> Node | None:
        for n in self.nodes:
            if n.host == host:
                return n
        return None

    def add_node(self, host: str, internal_host: str = "") -> Node:
        """Idempotently register a host, keeping the list sorted so that
        every member computes the same ring (reference:
        cluster.go:176-187).  A known host gains an internal host it
        lacked."""
        with self._mu:
            n = self.node_by_host(host)
            if n is None:
                n = Node(host=host, internal_host=internal_host)
                self.nodes = sorted(self.nodes + [n], key=lambda x: x.host)
            elif internal_host and not n.internal_host:
                n.internal_host = internal_host
            return n

    def node_states(self) -> dict[str, str]:
        """A static or http cluster has no failure detector: every
        configured node counts as UP (reference: cluster.go:62-86)."""
        out = {}
        for n in self.nodes:
            n.state = NODE_STATE_UP
            out[n.host] = n.state
        return out

    def hosts(self) -> list[str]:
        return [n.host for n in self.nodes]

    @property
    def health_version(self) -> int:
        """Replica-health version: bumped whenever a node's degraded flag
        flips — a key of the slice->node routing cache (JAX
        ``topology.py:160``)."""
        return self._health_version

    def note_degraded(self, host: str, degraded: bool) -> bool:
        """Record a node's degraded flag (from its health manager's state
        changes; the JAX package's gossip piggyback is not ported).  True
        when the flag flipped and the health version bumped; an unknown
        host is ignored."""
        node = self.node_by_host(host)
        if node is None or node.degraded == bool(degraded):
            return False
        with self._mu:
            node.degraded = bool(degraded)
            self._health_version += 1
        return True

    # --- placement (reference: cluster.go:200-258) ---

    def partition(self, index: str, slice_i: int) -> int:
        data = index.encode() + slice_i.to_bytes(8, "big")
        return fnv64a(data) % self.partition_n

    def partition_nodes(self, partition_id: int) -> list[Node]:
        nodes = self.nodes
        if not nodes:
            return []
        replica_n = self.replica_n
        if replica_n > len(nodes):
            replica_n = len(nodes)
        elif replica_n == 0:
            replica_n = 1
        node_index = jump_hash(partition_id, len(nodes))
        return [nodes[(node_index + i) % len(nodes)] for i in range(replica_n)]

    def fragment_nodes(self, index: str, slice_i: int) -> list[Node]:
        """Owners of a slice, primary first."""
        return self.partition_nodes(self.partition(index, slice_i))

    def owns_fragment(self, host: str, index: str, slice_i: int) -> bool:
        return any(n.host == host for n in self.fragment_nodes(index, slice_i))

    def is_write_owner(self, host: str, index: str, slice_i: int) -> bool:
        """Ownership guard of the write and import paths: with no
        rebalance transition the write owners are the owners."""
        return self.owns_fragment(host, index, slice_i)

    def split_by_owner(
        self, index: str, slices, hosts: set[str]
    ) -> tuple[list[int], list[int]]:
        """Partition ``slices`` into (placeable, lost) against a
        surviving host set: which of a dead node's slices still have a
        replica, and which are gone."""
        placeable: list[int] = []
        lost: list[int] = []
        for s in slices:
            owners = {n.host for n in self.fragment_nodes(index, s)}
            (placeable if owners & hosts else lost).append(s)
        return placeable, lost

    def owns_slices(self, index: str, max_slice: int, host: str) -> list[int]:
        """Slices whose PRIMARY owner is ``host`` (reference:
        cluster.go:246-258)."""
        out = []
        for i in range(max_slice + 1):
            owners = self.fragment_nodes(index, i)
            if owners and owners[0].host == host:
                out.append(i)
        return out

    def status_dict(self) -> dict:
        self.node_states()
        return {
            "nodes": [
                {"host": n.host, "internalHost": n.internal_host, "state": n.state}
                for n in self.nodes
            ],
        }


def new_cluster(n: int) -> Cluster:
    """Test helper mirroring the reference's fixture: n fake ``host%d:0``
    nodes (reference: cluster_test.go:146-176)."""
    c = Cluster()
    for i in range(n):
        c.add_node(f"host{i}:0")
    return c
