"""Cluster topology: slice -> partition -> node placement.

The counterpart of ``pilosa_tpu.cluster.topology`` (``:36-488``), and
hash-identical to it and to the reference (reference:
cluster.go:200-281), so that a mixed cluster of JAX and port nodes
places every slice on the same owners:

* ``partition(index, slice) = fnv64a(index || slice_be8) % PartitionN``
* the primary owner is the jump consistent hash (Lamping-Veach) of the
  partition id over the sorted node list; replicas are the next
  ``ReplicaN - 1`` nodes around the ring.

Membership is versioned as in the JAX package (``topology.py:125-300,
352-452``): every ring mutation bumps ``epoch``, and a rebalance
transition (``begin_transition`` .. ``commit_transition`` or
``abort_transition``) keeps the old ring for reads until each slice is
flipped to the new one, while writes go to both rings' owners
(``write_nodes``).  Per-slice flips bump ``routing_version``, the key of
the executor's routing cache; a query that sees the epoch move under it
fails with :class:`MixedEpochError`.  Each node also carries a
``degraded`` flag (its card quarantined), versioned by
``health_version``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

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


class TopologyError(RuntimeError):
    """A membership change outside the versioned-transition API, or
    transitions that conflict."""


class MixedEpochError(TopologyError):
    """A query saw two topology epochs while routing: the ring changed
    under it, and it fails rather than reduce over a half-old,
    half-new placement."""

    def __init__(self, expected: int, actual: int):
        super().__init__(
            f"query observed a mixed-epoch route: routing started at "
            f"topology epoch {expected}, cluster is now at {actual}; "
            "retry the query"
        )
        self.expected = expected
        self.actual = actual


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

    def set_state(self, s: str) -> None:
        self.state = s


@dataclass
class Transition:
    """A topology change in flight: the old ring (``Cluster.nodes``) and
    the new one coexist; reads route on the old ring until a slice is
    flipped, writes go to both rings' owners, and ``moved`` holds the
    slices already cut over."""

    epoch: int
    old_hosts: list[str]
    new_hosts: list[str]
    new_nodes: list[Node]
    moved: set = field(default_factory=set)  # {(index, slice)}


class Cluster:
    """Node list + placement functions (reference: cluster.go:122-258),
    with the JAX package's versioned membership."""

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
        self._epoch = 0
        self._routing_version = 0
        self._health_version = 0
        self._transition: Transition | None = None
        # The membership backend (cluster/gossip.py's GossipNodeSet), set
        # by the server; None for the static and http types.
        self.node_set = None
        # Seconds past which a query is logged as slow ([cluster]
        # long-query-time; 0: never), read by the handler.
        self.long_query_time = 0.0

    # --- versioned topology ---

    @property
    def epoch(self) -> int:
        """Ring version: bumped by every node-list mutation (a new node,
        a transition's begin, commit and abort)."""
        return self._epoch

    @property
    def routing_version(self) -> int:
        """Placement version: bumped with ``epoch`` and by every
        per-slice flip — the key of slice->node routing caches."""
        return self._routing_version

    @property
    def transition(self) -> Transition | None:
        return self._transition

    def begin_transition(self, new_hosts: list[str], epoch: int | None = None) -> Transition:
        """Install a transition to ``new_hosts``; the current nodes stay
        the read ring.  ``epoch`` is the coordinator's transition token;
        applying the same transition again is a no-op."""
        new_hosts = sorted(dict.fromkeys(new_hosts))
        if not new_hosts:
            raise TopologyError("transition needs at least one host")
        with self._mu:
            t = self._transition
            if t is not None:
                if t.new_hosts == new_hosts:
                    return t
                raise TopologyError(
                    f"transition to {t.new_hosts} already in flight "
                    f"(epoch {t.epoch}); abort it before starting another"
                )
            e = epoch if epoch is not None else self._epoch + 1
            by_host = {n.host: n for n in self.nodes}
            new_nodes = [by_host.get(h) or Node(host=h, state=NODE_STATE_UP) for h in new_hosts]
            t = Transition(epoch=e, old_hosts=[n.host for n in self.nodes],
                           new_hosts=new_hosts, new_nodes=new_nodes)
            self._transition = t
            self._epoch = max(self._epoch + 1, e)
            self._routing_version += 1
            return t

    def flip_slice(self, index: str, slice_i: int, epoch: int) -> bool:
        """Cut one slice's reads over to the new ring; False (a no-op)
        when no transition of ``epoch`` is active."""
        with self._mu:
            t = self._transition
            if t is None or t.epoch != epoch:
                return False
            t.moved.add((index, slice_i))
            self._routing_version += 1
            return True

    def unflip_slice(self, index: str, slice_i: int, epoch: int) -> bool:
        """Reverse one slice's cutover (the abort path)."""
        with self._mu:
            t = self._transition
            if t is None or t.epoch != epoch:
                return False
            t.moved.discard((index, slice_i))
            self._routing_version += 1
            return True

    def commit_transition(self, epoch: int) -> None:
        """The new ring becomes the ring; the transition ends."""
        with self._mu:
            t = self._transition
            if t is None:
                return
            if t.epoch != epoch:
                raise TopologyError(f"commit for epoch {epoch} but transition is {t.epoch}")
            self.nodes = sorted(t.new_nodes, key=lambda n: n.host)
            self._transition = None
            self._epoch = max(self._epoch + 1, epoch + 1)
            self._routing_version += 1

    def abort_transition(self, epoch: int | None = None) -> None:
        """Drop the transition and keep the old ring; refused while
        slices are flipped (they must be migrated back first)."""
        with self._mu:
            t = self._transition
            if t is None or (epoch is not None and t.epoch != epoch):
                return
            if t.moved:
                raise TopologyError(
                    f"cannot abort transition {t.epoch}: "
                    f"{len(t.moved)} slice(s) already flipped to the new "
                    "ring; reverse-migrate them first"
                )
            self._transition = None
            self._epoch += 1
            self._routing_version += 1

    def transition_snapshot(self) -> dict | None:
        """The transition as JSON, persisted so that a node that
        restarts mid-transition comes back with both rings."""
        with self._mu:
            t = self._transition
            if t is None:
                return None
            return {
                "epoch": t.epoch,
                "old": list(t.old_hosts),
                "new": list(t.new_hosts),
                "moved": sorted([i, s] for i, s in t.moved),
            }

    def restore_transition(self, snap: dict) -> None:
        self.begin_transition(list(snap["new"]), epoch=int(snap["epoch"]))
        for idx, s in snap.get("moved", []):
            self.flip_slice(str(idx), int(s), int(snap["epoch"]))

    # --- membership ---

    def node_by_host(self, host: str) -> Node | None:
        for n in self.nodes:
            if n.host == host:
                return n
        return None

    def add_node(self, host: str, internal_host: str = "") -> Node:
        """Idempotently register a host, keeping the list sorted so that
        every member computes the same ring (reference:
        cluster.go:176-187).  A new host bumps the epoch and is refused
        while a transition is in flight; a known host gains an internal
        host it lacked."""
        with self._mu:
            n = self.node_by_host(host)
            if n is not None:
                if internal_host and not n.internal_host:
                    n.internal_host = internal_host
                return n
            if self._transition is not None:
                raise TopologyError(
                    f"cannot add node {host!r}: rebalance transition "
                    f"(epoch {self._transition.epoch}) in flight — "
                    "membership changes go through /cluster/resize"
                )
            n = Node(host=host, internal_host=internal_host)
            self.nodes = sorted(self.nodes + [n], key=lambda x: x.host)
            self._epoch += 1
            self._routing_version += 1
            return n

    def node_states(self) -> dict[str, str]:
        """Node states from the membership backend: a node is UP while the
        node set sees it (reference: cluster.go:149-173).  A static or
        http cluster has no failure detector, and every configured node
        counts as UP (reference: cluster.go:62-86)."""
        if self.node_set is not None:
            up = {n if isinstance(n, str) else n.host for n in self.node_set.nodes()}
        else:
            up = {n.host for n in self.nodes}
        out = {}
        for n in self.nodes:
            n.state = NODE_STATE_UP if n.host in up else NODE_STATE_DOWN
            out[n.host] = n.state
        return out

    def hosts(self) -> list[str]:
        return [n.host for n in self.nodes]

    def route_nodes(self) -> list[Node]:
        """Every node a query may route to now: the read ring and,
        during a transition, the new ring's other nodes (flipped slices
        already route to them)."""
        t = self._transition
        if t is None:
            return list(self.nodes)
        seen = {n.host for n in self.nodes}
        return list(self.nodes) + [n for n in t.new_nodes if n.host not in seen]

    @property
    def health_version(self) -> int:
        """Replica-health version: bumped whenever a node's degraded flag
        flips — a key of the slice->node routing cache (JAX
        ``topology.py:160``)."""
        return self._health_version

    def note_degraded(self, host: str, degraded: bool) -> bool:
        """Record a node's degraded flag, from its own health manager's
        state changes or from a gossip peer's piggybacked flag
        (``cluster/gossip.py``'s ``on_peer_health``).  True when the flag
        flipped and the health version bumped; an unknown host is
        ignored."""
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

    def partition_nodes_over(self, partition_id: int, nodes: list[Node]) -> list[Node]:
        """Owners of a partition over an explicit ring: the placement
        both rings of a transition share."""
        if not nodes:
            return []
        replica_n = self.replica_n
        if replica_n > len(nodes):
            replica_n = len(nodes)
        elif replica_n == 0:
            replica_n = 1
        node_index = jump_hash(partition_id, len(nodes))
        return [nodes[(node_index + i) % len(nodes)] for i in range(replica_n)]

    def partition_nodes(self, partition_id: int) -> list[Node]:
        return self.partition_nodes_over(partition_id, self.nodes)

    def fragment_nodes(self, index: str, slice_i: int) -> list[Node]:
        """READ owners of a slice, primary first: the old ring until the
        slice flips, the new ring after."""
        t = self._transition
        ring = self.nodes
        if t is not None and (index, slice_i) in t.moved:
            ring = t.new_nodes
        return self.partition_nodes_over(self.partition(index, slice_i), ring)

    def new_ring_nodes(self, index: str, slice_i: int) -> list[Node]:
        """Owners of a slice on the transition's new ring ([] with no
        transition)."""
        t = self._transition
        if t is None:
            return []
        return self.partition_nodes_over(self.partition(index, slice_i), t.new_nodes)

    def write_nodes(self, index: str, slice_i: int) -> list[Node]:
        """WRITE owners of a slice: the read owners and, during a
        transition, the new ring's owners too, so that no write is lost
        whichever ring serves the slice in the end."""
        t = self._transition
        out = self.fragment_nodes(index, slice_i)
        if t is None:
            return out
        seen = {n.host for n in out}
        for n in self.partition_nodes_over(self.partition(index, slice_i), t.new_nodes):
            if n.host not in seen:
                seen.add(n.host)
                out = out + [n]
        return out

    def owns_fragment(self, host: str, index: str, slice_i: int) -> bool:
        return any(n.host == host for n in self.fragment_nodes(index, slice_i))

    def is_write_owner(self, host: str, index: str, slice_i: int) -> bool:
        """Ownership guard of the write and import paths: during a
        transition the new ring's owners accept writes too."""
        return any(n.host == host for n in self.write_nodes(index, slice_i))

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
        cluster.go:246-258), a flipped slice's from the new ring."""
        out = []
        for i in range(max_slice + 1):
            owners = self.fragment_nodes(index, i)
            if owners and owners[0].host == host:
                out.append(i)
        return out

    def status_dict(self) -> dict:
        self.node_states()
        out = {
            "nodes": [
                {"host": n.host, "internalHost": n.internal_host, "state": n.state}
                for n in self.nodes
            ],
            "epoch": self._epoch,
        }
        t = self._transition
        if t is not None:
            out["transition"] = {
                "epoch": t.epoch,
                "newHosts": list(t.new_hosts),
                "movedSlices": len(t.moved),
            }
        return out


def new_cluster(n: int) -> Cluster:
    """Test helper mirroring the reference's fixture: n fake ``host%d:0``
    nodes (reference: cluster_test.go:146-176)."""
    c = Cluster()
    for i in range(n):
        c.add_node(f"host{i}:0")
    return c
