"""HolderSyncer / FragmentSyncer — active anti-entropy.

The holder syncer walks the entire local schema and, for every index,
frame, view, and owned fragment, converges state with the other
replicas (reference: holder.go:357-556):

  1. column attrs  — exchange SHA1 block checksums, pull differing
     blocks from each peer, merge locally (last-writer-merge at the
     attribute-map level, reference: holder.go:432-475);
  2. row attrs     — same per frame (reference: holder.go:477-522);
  3. fragments     — per owned (frame, view, slice): compare per-block
     checksums across replicas, fetch differing blocks' bit dumps,
     majority-consensus merge, apply local diffs, and push each
     remote's diff back as generated SetBit/ClearBit PQL
     (reference: fragment.go:1317-1498).

Checksum computation is the heavy step: the fragment's ``blocks()``
hashes each 100-row block's set positions from the host planes (cached
per block until a write dirties it).  Merged writes queue for the
mirrors, and the next read applies them.
"""

from __future__ import annotations

import threading

from pilosa_tpu_torch import stream as stream_mod
from pilosa_tpu_torch.core.fragment import PairSet
from pilosa_tpu_torch.core.view import VIEW_STANDARD, is_inverse_view
from pilosa_tpu_torch.net.client import ClientError, InternalClient
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH

# Repair writes pushed per request: far enough under the server's
# max-writes-per-request default (5000) to leave headroom, and keeps a
# badly diverged block from assembling one huge PQL string in memory.
REPAIR_BATCH = 1000


class HolderSyncer:
    """reference: holder.go:357-556

    With ``replication`` wired (``replicate/``), anti-entropy is
    the BACKSTOP rather than the mechanism: a slice whose per-slice
    write versions already agree across every replica skips the block
    checksum walk entirely (``sync.skippedInSync``), and repairs that
    do run are attributed by cause — ``cause:missed-hint`` when the
    versions disagreed (writes a replica provably missed, i.e. hints
    that overflowed or never replayed) vs ``cause:drift`` when versions
    agreed but content diverged anyway.  ``full=True`` disables the
    skip (the server forces it every Nth tick against the equal-but-
    wrong version edge cases)."""

    def __init__(
        self, holder, host: str, cluster, closing=None, client_factory=None,
        replication=None, full: bool = False,
    ):
        self.holder = holder
        self.host = host
        self.cluster = cluster
        self.closing = closing or threading.Event()
        self.client_factory = client_factory or (lambda h: InternalClient(h, timeout=30.0))
        self.replication = replication
        self.full = full
        # host -> {slice: version} fetched once per (peer, index).
        self._peer_versions: dict[tuple[str, str], dict[int, int] | None] = {}

    def is_closing(self) -> bool:
        return self.closing.is_set()

    def _peers(self):
        return [n for n in self.cluster.nodes if n.host != self.host]

    def _versions_of(self, host: str, index: str, max_slice: int):
        """One peer's slice versions for an index, fetched once per
        sweep; None = unreachable (treat as disagreeing)."""
        key = (host, index)
        if key not in self._peer_versions:
            try:
                self._peer_versions[key] = self.client_factory(
                    host
                ).replicate_versions(index, range(max_slice + 1))
            except Exception:  # noqa: BLE001 — peer may be down/old
                self._peer_versions[key] = None
        return self._peer_versions[key]

    def slice_cause(self, index: str, slice_i: int, max_slice: int) -> str | None:
        """The sync decision for one slice: None = versions agree on
        every replica (skip the checksum walk), ``"missed-hint"`` =
        some replica's version lags (it provably missed writes),
        ``"drift"`` = versions unavailable/equal-but-unproven (full
        sweep, no replication, unreachable peer)."""
        if self.replication is None or self.full:
            return "drift"
        local = self.replication.versions.get(index, slice_i)
        if local <= 0:
            return "drift"  # nothing observed yet: not provably in sync
        for node in self.cluster.fragment_nodes(index, slice_i):
            if node.host == self.host:
                continue
            versions = self._versions_of(node.host, index, max_slice)
            if versions is None:
                return "drift"
            if versions.get(slice_i, 0) != local:
                return "missed-hint"
        return None

    def sync_holder(self) -> None:
        """reference: holder.go:379-430"""
        for index_name, idx in sorted(self.holder.indexes().items()):
            if self.is_closing():
                return
            # Per-(index, slice) sync decision, shared by every view of
            # the slice: versions-agree slices skip their checksum walk.
            causes: dict[int, str | None] = {}
            index_max = max(idx.max_slice(), idx.max_inverse_slice())
            self.sync_index(index_name)
            for frame_name, frame in sorted(idx.frames().items()):
                if self.is_closing():
                    return
                self.sync_frame(index_name, frame_name)
                for view_name, view in sorted(frame.views().items()):
                    # Every view's fragments sync, like the reference's
                    # holder walk (reference: holder.go:403-425).  The
                    # standard view repairs remotes via PQL push (which
                    # fans out to derived views); inverse/time views
                    # exchange and repair their OWN block data through
                    # the view-scoped import path, so divergence
                    # introduced directly in a derived view converges
                    # too (the reference only ever merges standard
                    # data, fragment.go:1443).
                    max_slice = (
                        idx.max_inverse_slice()
                        if is_inverse_view(view_name)
                        else idx.max_slice()
                    )
                    for slice_i in range(max_slice + 1):
                        if self.is_closing():
                            return
                        if not self.cluster.owns_fragment(
                            self.host, index_name, slice_i
                        ):
                            continue
                        if slice_i not in causes:
                            causes[slice_i] = self.slice_cause(
                                index_name, slice_i, index_max
                            )
                            if causes[slice_i] is None:
                                self.holder.stats.count("sync.skippedInSync")
                        if causes[slice_i] is None:
                            continue  # replica versions agree: backstop only
                        # Create locally-absent fragments so data that
                        # exists only on peers is pulled (reference:
                        # holder.go:533-546 CreateFragmentIfNotExists).
                        view.create_fragment_if_not_exists(slice_i)
                        self.sync_fragment(
                            index_name, frame_name, view_name, slice_i,
                            cause=causes[slice_i],
                        )

    def sync_index(self, index: str) -> None:
        """Column-attr convergence (reference: holder.go:432-475)."""
        idx = self.holder.index(index)
        if idx is None:
            return
        blocks = idx.column_attr_store.blocks()
        for node in self._peers():
            try:
                m = self.client_factory(node.host).column_attr_diff(index, blocks)
            except ClientError:
                continue
            if not m:
                continue
            idx.column_attr_store.set_bulk_attrs(m)
            blocks = idx.column_attr_store.blocks()

    def sync_frame(self, index: str, name: str) -> None:
        """Row-attr convergence (reference: holder.go:477-522)."""
        f = self.holder.frame(index, name)
        if f is None:
            return
        blocks = f.row_attr_store.blocks()
        for node in self._peers():
            try:
                m = self.client_factory(node.host).row_attr_diff(index, name, blocks)
            except ClientError as e:
                if e.status == 404:
                    continue  # frame not created remotely yet
                continue
            if not m:
                continue
            f.row_attr_store.set_bulk_attrs(m)
            blocks = f.row_attr_store.blocks()

    def sync_fragment(
        self, index: str, frame: str, view: str, slice_i: int,
        cause: str = "drift",
    ) -> None:
        f = self.holder.fragment(index, frame, view, slice_i)
        if f is None:
            return
        FragmentSyncer(
            fragment=f,
            host=self.host,
            cluster=self.cluster,
            closing=self.closing,
            client_factory=self.client_factory,
            cause=cause,
            holder_stats=self.holder.stats,
        ).sync_fragment()


class FragmentSyncer:
    """reference: fragment.go:1317-1498

    ``cause`` attributes this sync's repairs: "missed-hint" = the
    replica versions disagreed before the walk (writes a replica
    provably missed — overflowed or never-replayed hints), "drift" =
    versions agreed/unknown but checksums diverged anyway.  Rendered as
    ``sync.repairBits[cause:*]`` on the holder stats."""

    def __init__(
        self, fragment, host: str, cluster, closing=None, client_factory=None,
        cause: str = "drift", holder_stats=None,
    ):
        self.fragment = fragment
        self.host = host
        self.cluster = cluster
        self.closing = closing or threading.Event()
        self.client_factory = client_factory or (lambda h: InternalClient(h, timeout=30.0))
        self.cause = cause
        self.holder_stats = holder_stats

    def _count_repair_bits(self, n: int) -> None:
        self.fragment.stats.count("repairBits", n)
        if self.holder_stats is not None:
            self.holder_stats.count_with_custom_tags(
                "sync.repairBits", n, [f"cause:{self.cause}"]
            )

    def is_closing(self) -> bool:
        return self.closing.is_set()

    def sync_fragment(self) -> None:
        """reference: fragment.go:1339-1418"""
        f = self.fragment
        nodes = self.cluster.fragment_nodes(f.index, f.slice)
        if len(nodes) == 1:
            return
        if not any(n.host == self.host for n in nodes):
            return

        # Collect per-replica block checksums (local + each peer).
        blocks_sets: list[dict[int, bytes]] = [dict(f.blocks())]
        for node in nodes:
            if node.host == self.host:
                continue
            if self.is_closing():
                return
            try:
                remote = self.client_factory(node.host).fragment_blocks(
                    f.index, f.frame, f.view, f.slice
                )
            except ClientError as e:
                if e.status == 404:
                    remote = []  # fragment not created remotely yet
                else:
                    raise
            blocks_sets.append(dict(remote))

        # A block needs syncing when any replica's checksum differs.
        block_ids = sorted(set().union(*[set(b) for b in blocks_sets]))
        for block_id in block_ids:
            checksums = {b.get(block_id) for b in blocks_sets}
            if len(checksums) <= 1:
                continue
            if self.is_closing():
                return
            self.sync_block(block_id)
            f.stats.count("BlockRepair")  # reference: fragment.go:1412

    def sync_block(self, block_id: int) -> None:
        """reference: fragment.go:1420-1498"""
        f = self.fragment
        pair_sets: list[PairSet] = []
        hosts: list[str] = []
        for node in self.cluster.fragment_nodes(f.index, f.slice):
            if node.host == self.host:
                continue
            if self.is_closing():
                return
            client = self.client_factory(node.host)
            # Each view exchanges its OWN block data (a 404 means the
            # peer hasn't materialized this derived view yet — treat as
            # empty so the consensus can still pull/push).
            try:
                row_ids, column_ids = client.block_data(
                    f.index, f.frame, f.view, f.slice, block_id
                )
            except ClientError as e:
                if e.status != 404:
                    raise
                row_ids, column_ids = [], []
            pair_sets.append(PairSet(row_ids=row_ids, column_ids=column_ids))
            hosts.append(node.host)

        if self.is_closing():
            return
        sets, clears = f.merge_block(block_id, pair_sets)

        base = f.slice * SLICE_WIDTH
        for host, set_ps, clear_ps in zip(hosts, sets, clears):
            if not set_ps.column_ids and not clear_ps.column_ids:
                continue
            if self.is_closing():
                return
            if f.view == VIEW_STANDARD:
                # Standard diffs push back as generated PQL, which fans
                # out through the remote's whole write path (all views,
                # caches, op-log) — reference: fragment.go:1465-1492.
                # Batched so a badly diverged block never assembles one
                # huge request (or trips max-writes-per-request).
                def _lines(set_ps=set_ps, clear_ps=clear_ps):
                    for r, c in zip(set_ps.row_ids, set_ps.column_ids):
                        yield (
                            f'SetBit(frame="{f.frame}", rowID={r},'
                            f" columnID={base + c})"
                        )
                    for r, c in zip(clear_ps.row_ids, clear_ps.column_ids):
                        yield (
                            f'ClearBit(frame="{f.frame}", rowID={r},'
                            f" columnID={base + c})"
                        )

                client = self.client_factory(host)
                for batch in stream_mod.batched(_lines(), REPAIR_BATCH):
                    if self.is_closing():
                        return
                    client.execute_query(f.index, "\n".join(batch), remote=False)
                    # reference: fragment.go:1412 counts repairs; per
                    # batch here so dashboards see push progress.
                    f.stats.count("repairBatch")
                    self._count_repair_bits(len(batch))
            else:
                # Derived views repair via the view-scoped raw write
                # path: PQL cannot target an individual inverse/time
                # view.
                self.client_factory(host).import_view_bits(
                    f.index,
                    f.frame,
                    f.view,
                    f.slice,
                    (set_ps.row_ids, [base + c for c in set_ps.column_ids]),
                    (clear_ps.row_ids, [base + c for c in clear_ps.column_ids]),
                )
                f.stats.count("repairBatch")
                self._count_repair_bits(
                    len(set_ps.column_ids) + len(clear_ps.column_ids)
                )
