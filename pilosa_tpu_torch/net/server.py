"""Server — one node: holder + executor + HTTP front end + cluster.

``Server(data_dir, host, device=...)`` opens the data directory (the
layout of ``pilosa_tpu.net.server``'s), serves the API of
net/handler.py on a ThreadingHTTPServer, and keeps every fragment's
device mirror on ``device`` — the CUDA card unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.

The cluster settings are those of the JAX package's ``[cluster]``
section (``pilosa_tpu/cli/ctl.py:45-100``):

* ``cluster_type`` ``"static"`` (a fixed node list, no messages) or
  ``"http"`` (schema changes and new max slices are POSTed to every
  peer's internal listener, bound at ``internal_port``); ``"gossip"``
  is not ported yet and raises;
* ``hosts``, the nodes' HTTP addresses, and ``internal_hosts``, their
  internal listeners (by default each host's name with
  ``internal_port``);
* ``replicas``, the owners of each slice;
* ``polling_interval``, seconds between polls of the peers' max slices
  and max inverse slices (``tick_max_slices``), so every node knows how
  far an index reaches, also where it owns no slice.

``plane_format`` (``"auto"`` or ``"dense"``) sets the sparse tier's
container policy (``bitplane.configure_plane_format``, process-wide as
in the JAX package's ``[device] plane-format``; the per-row byte caps
keep their 64 KiB defaults).

Residency and durability, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:58-111``, ``[device]`` and ``[ingest]``):

* ``hbm_budget_bytes`` — the device-memory budget of the process-wide
  residency pool (``device/pool.py``), 0 for the default: the
  ``PILOSA_DEVICE_HBM_BUDGET_BYTES`` environment variable, else 0.8 of
  the card's memory, unbounded on the CPU.  Every ``Server`` of a
  process shares the one pool, and the last one opened sets its budget;
* ``device_prefetch`` — upload a query's cold mirrors in the background
  (``device/prefetch.py``);
* ``ingest_wal`` — log every changed bit to its fragment's WAL and
  answer a ``SetBit``/``ClearBit`` only after its fsync
  (``ingest/wal.py``), with ``ingest_group_commit_ms`` /
  ``ingest_group_commit_max`` the group-commit window and
  ``ingest_wal_segment_bytes`` the size past which a segment rolls over
  into a snapshot.  ``ingest_wal=False`` writes each op to the data file
  without an fsync, as the port did before.

Query execution, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:53,69-73``, ``[exec]``):

* ``coalesce`` — Count and Bitmap trees go through the cross-query
  scheduler (``exec/coalesce.py``), which gives concurrent queries one
  launch; ``coalesce_max_batch`` queries at most per launch,
  ``coalesce_max_wait_us`` an optional wait for company (0: none);
* ``fuse`` — a drain of distinct trees runs as one interpreter launch
  (K3), at most ``fuse_max_programs`` programs;
* ``prewarm`` — build every kernel and launch each once at open, in the
  background (``exec/warmup.py``).

The scheduler starts at open and closes before the holder.

Observability, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:51-121``, ``[metrics]`` and ``[obs]``):

* ``stats`` — a stats client (``obs/stats.py``: Nop, Expvar, StatsD,
  Multi), the root of the holder's tag chain, shared with the pool, the
  WAL and the coalescer; None emits nothing (``/debug/vars`` and
  ``/metrics`` then carry only the scrape-time gauges);
* ``trace_ring`` — finished query traces kept for ``GET /debug/traces``
  (every query is traced, Dapper style), ``slow_query_ms`` the threshold
  of the structured slow-query log (0: off);
* ``latency_buckets_ms``, ``slo_ms``, ``slo_objective`` — the native
  latency histograms and SLO burn gauges of ``/metrics``;
* ``floor_probe`` — at open, measure the card's stream floor with K11
  (``device/floorprobe.py``, cached in ``floorprobe.json`` under the data
  dir) as the denominator of ``/debug/perf``'s ``floorPct``.  A probe
  that cannot build or launch K11 raises here.

Device health, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:62-65``, ``[device]``): one
``device/health.py`` breaker, shared with the executor and shown at ``GET
/debug/health`` and on ``/metrics``.  ``quarantine_threshold``
consecutive launch failures (or one hang) quarantine the card, and the
node answers from its host planes (``exec/hosteval.py``) until, after
``quarantine_open_ms``, a half-open probe launch succeeds
``quarantine_probe_successes`` times; ``launch_watchdog_ms`` bounds a
cross-device launch.  A quarantine sets the node's ``degraded`` flag in
its cluster (coordinators prefer a healthy replica), and a heal clears it
and stages the mirrors again.  A ``PILOSA_FAULTS`` plan
(``testing/faults.py``) is announced at open.

``stream_chunk_bytes`` (the JAX package's ``[net] stream-chunk-bytes``, 0
for its 64 KiB default) is the write size of the streamed bodies: CSV
exports and fragment archives.

At open the node stages, in the background, the mirrors of its previous
run (``.residency.json``, written at close), then the largest that fit
the budget, and answers meanwhile (``staging_job``).  ``GET /debug/hbm``
and ``GET /debug/ingest`` report the pool and the WAL.

The node registers itself in the cluster on open.  Nodes that bind port
0 learn each other after they are open: ``add_peer(host,
internal_host)``.  Anti-entropy, replication quorums, resize and the
other background loops of the JAX server are not ported yet.
"""

from __future__ import annotations

import sys
import threading

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster.topology import Cluster
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.device import health as health_mod
from pilosa_tpu_torch.core.view import is_inverse_view
from pilosa_tpu_torch.exec import coalesce as coalesce_mod
from pilosa_tpu_torch.exec import warmup
from pilosa_tpu_torch.exec.executor import DEFAULT_MAX_WRITES_PER_REQUEST, Executor
from pilosa_tpu_torch.ingest import wal
from pilosa_tpu_torch.net import wire
from pilosa_tpu_torch.net.client import TRANSPORT_ERRORS, ClientError, InternalClient
from pilosa_tpu_torch.net.handler import Handler, make_http_server
from pilosa_tpu_torch.obs import perf as perf_mod
from pilosa_tpu_torch.obs.trace import Tracer
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.testing import faults

CLUSTER_TYPES = ("static", "http")
# reference: server.go / config.go defaults
DEFAULT_POLLING_INTERVAL = 60.0
DEFAULT_INTERNAL_PORT = 14000
# Socket timeout of a map leg or a poll to a peer.
REMOTE_TIMEOUT_S = 60.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


class Server:
    def __init__(
        self,
        data_dir: str,
        host: str = "127.0.0.1:0",
        device: torch.device | str | None = None,
        max_writes_per_request: int = DEFAULT_MAX_WRITES_PER_REQUEST,
        cluster_type: str = "static",
        hosts: list[str] | None = None,
        internal_hosts: list[str] | None = None,
        replicas: int = 1,
        internal_port: int = DEFAULT_INTERNAL_PORT,
        polling_interval: float = DEFAULT_POLLING_INTERVAL,
        plane_format: str = "auto",
        hbm_budget_bytes: int = 0,
        device_prefetch: bool = True,
        ingest_wal: bool = True,
        ingest_group_commit_ms: float = 2.0,
        ingest_group_commit_max: int = 128,
        ingest_wal_segment_bytes: int = 4 << 20,
        coalesce: bool = True,
        coalesce_max_batch: int = coalesce_mod.DEFAULT_MAX_BATCH,
        coalesce_max_wait_us: int = coalesce_mod.DEFAULT_MAX_WAIT_US,
        fuse: bool = True,
        fuse_max_programs: int = coalesce_mod.DEFAULT_FUSE_MAX_PROGRAMS,
        prewarm: bool = False,
        stats=None,
        slow_query_ms: float = 0.0,
        trace_ring: int = 64,
        latency_buckets_ms=None,
        slo_ms: float = 0.0,
        slo_objective: float = 0.999,
        floor_probe: bool = True,
        stream_chunk_bytes: int = 0,
        launch_watchdog_ms: float = health_mod.DEFAULT_WATCHDOG_MS,
        quarantine_threshold: int = health_mod.DEFAULT_QUARANTINE_THRESHOLD,
        quarantine_open_ms: float = health_mod.DEFAULT_OPEN_MS,
        quarantine_probe_successes: int = health_mod.DEFAULT_PROBE_SUCCESSES,
        mesh_devices: int = 0,
    ):
        if cluster_type == "gossip":
            raise ValueError("cluster type 'gossip' is not supported by this port yet")
        if cluster_type not in CLUSTER_TYPES:
            raise ValueError(f"unknown cluster type: {cluster_type!r}")
        hosts = list(hosts or [])
        if internal_hosts is None:
            internal_hosts = [f"{h.rpartition(':')[0]}:{internal_port}" for h in hosts]
        if len(internal_hosts) != len(hosts):
            raise ValueError("internal_hosts must list one listener per host")
        if plane_format not in ("auto", "dense"):
            raise ValueError(f"unknown plane-format {plane_format!r}")
        self.device = device_mod.resolve(device)
        self.host = host
        # [device] mesh-devices (JAX server.py:57): applied at open, before
        # any fragment is placed; 0 leaves the process-wide setting.  A
        # node pinned to one card (``cuda:N``) keeps every slice there.
        self.mesh_devices = int(mesh_devices)
        if self.mesh_devices > 1 and device_mod.placed(device).index is not None:
            raise ValueError(f"device {self.device} pins the node to one card; "
                             f"mesh-devices {self.mesh_devices} needs the bare 'cuda'")
        # The sparse tier's container policy (bitplane.encode_row):
        # process-wide, as in the JAX package, applied at open().
        self.plane_format = plane_format
        self.hbm_budget_bytes = hbm_budget_bytes
        self.device_prefetch = device_prefetch
        self.staging_job = None
        self.ingest_wal = ingest_wal
        self.ingest_group_commit_ms = ingest_group_commit_ms
        self.ingest_group_commit_max = ingest_group_commit_max
        self.ingest_wal_segment_bytes = ingest_wal_segment_bytes
        self.ingest: wal.IngestManager | None = None
        self.coalesce = coalesce
        self.coalesce_max_batch = coalesce_max_batch
        self.coalesce_max_wait_us = coalesce_max_wait_us
        self.fuse = fuse
        self.fuse_max_programs = fuse_max_programs
        self.coalescer: coalesce_mod.CoalesceScheduler | None = None
        self.prewarm = prewarm
        self.data_dir = data_dir
        self.cluster_type = cluster_type
        self.polling_interval = polling_interval
        self.cluster = Cluster(replica_n=replicas)
        for h, ih in zip(hosts, internal_hosts):
            self.cluster.add_node(h, ih)
        if cluster_type == "http":
            bind_host = host.rpartition(":")[0] or "127.0.0.1"
            self.broadcaster = bc.HTTPBroadcaster(timeout=REMOTE_TIMEOUT_S)
            self.receiver = bc.HTTPBroadcastReceiver(bind_host, internal_port)
        else:
            self.broadcaster = bc.NopBroadcaster()
            self.receiver = None
        self.stats = stats
        self.tracer = Tracer(capacity=trace_ring)
        self.floor_probe = floor_probe
        self.holder = Holder(data_dir, device=device)
        self.holder.on_create_slice = self._on_create_slice
        if stats is not None:
            # Root of the tag chain: indexes opened from disk, and all
            # their frames, views and fragments, get tagged children.
            self.holder.stats = stats
        # The card's breaker (JAX server.py:169-186), shared with the
        # executor; its quarantines and heals reach
        # _on_device_health_change.
        self.device_health = health_mod.DeviceHealth(
            quarantine_threshold=quarantine_threshold,
            open_ms=quarantine_open_ms,
            probe_successes=quarantine_probe_successes,
            watchdog_ms=launch_watchdog_ms,
            stats=stats,
            logger=_log,
            on_state_change=self._on_device_health_change,
            device=self.holder.placed,
        )
        self.executor = Executor(
            self.holder,
            max_writes_per_request=max_writes_per_request,
            cluster=self.cluster,
            host=host,
            client_factory=self._client,
            tracer=self.tracer,
            device_health=self.device_health,
        )
        self.handler = Handler(
            self.holder, self.executor, self.broadcaster,
            stats=stats,
            tracer=self.tracer,
            slow_query_ms=slow_query_ms,
            latency_buckets_ms=latency_buckets_ms,
            slo_ms=slo_ms,
            slo_objective=slo_objective,
            stream_chunk_bytes=stream_chunk_bytes,
        )
        # /debug/profile tars its traces under the data dir.
        self.handler.profile_dir = data_dir
        self._http = None
        self._http_thread: threading.Thread | None = None
        self._closing = threading.Event()
        self._poll_thread: threading.Thread | None = None

    @property
    def internal_host(self) -> str:
        return self.receiver.bound_host if self.receiver is not None else ""

    def _client(self, node) -> InternalClient:
        host = node if isinstance(node, str) else node.host
        return InternalClient(host, timeout=REMOTE_TIMEOUT_S, device=self.device)

    # --- lifecycle (reference: server.go:99-198) ---

    def open(self) -> None:
        # A chaos plan (testing/faults.py) is announced loudly: a run under
        # injected faults must be unmistakable.
        plan = faults.active()
        if plan is not None and plan.rules:
            _log(f"FAULT INJECTION ACTIVE: {len(plan.rules)} rule(s): "
                 + "; ".join(f"{r.stage}/{r.kind or r.mode}" for r in plan.rules))
        bp.configure_plane_format(mode=self.plane_format)
        if self.mesh_devices:
            bp.configure_mesh_devices(self.mesh_devices)
        members = bp.placement(self.holder.placed)
        if len(members) > 1:
            _log(f"data plane: mesh-sharded over {len(members)} devices "
                 f"({', '.join(str(d) for d in members)})")
        # The pool's budget and the WAL manager before any fragment
        # opens: mirrors register at their first upload, and fragments
        # replay their segments and attach writers as they open.
        device_mod.pool().configure(
            budget_bytes=self.hbm_budget_bytes, stats=self.stats, tracer=self.tracer
        )
        # The stream floor of /debug/perf (JAX server.py:405-422): cached
        # per process and under the data dir; a K11 build or launch
        # failure raises here rather than leave the floor at 0.
        if self.floor_probe:
            from pilosa_tpu_torch.device import floorprobe

            fp = floorprobe.probe(
                artifact_dir=self.data_dir,
                stats=self.stats,
                logger=lambda m: print(m, file=sys.stderr),
                device=self.device,
            )
            perf_mod.registry().set_floor(fp["mean_gbps"])
        if self.ingest_wal:
            self.ingest = wal.IngestManager(
                self.data_dir,
                group_commit_ms=self.ingest_group_commit_ms,
                group_commit_max=self.ingest_group_commit_max,
                wal_segment_bytes=self.ingest_wal_segment_bytes,
                logger=lambda m: print(m, file=sys.stderr),
                stats=self.stats,
            )
            wal.register_manager(self.ingest)
        self.holder.open()
        if self.coalesce:
            self.coalescer = coalesce_mod.CoalesceScheduler(
                max_batch=self.coalesce_max_batch,
                max_wait_us=self.coalesce_max_wait_us,
                fuse=self.fuse,
                fuse_max_programs=self.fuse_max_programs,
                stats=self.stats,
                health=self.device_health,
            )
        self.executor.coalescer = self.coalescer
        if self.prewarm:
            warmup.prewarm_async(self.holder.placed, logger=lambda m: print(m, file=sys.stderr))
        self.executor.prefetcher = device_mod.prefetcher() if self.device_prefetch else None
        self.executor.ingest = self.ingest
        self.handler.ingest = self.ingest
        self.handler.prefetcher = device_mod.prefetcher()
        # Serving starts now; the mirrors of the previous run (its
        # .residency.json, then the largest that fit the budget) stream in
        # behind it, and a query's own prefetch jumps them.
        self.staging_job = self.holder.stage_device_mirrors(
            device_mod.prefetcher(), tracer=self.tracer
        )
        bind_host, _, bind_port = self.host.rpartition(":")
        port = int(bind_port or 0)
        self._http = make_http_server(self.handler, bind_host or "127.0.0.1", port)
        if port == 0:
            addr = self._http.server_address
            self.host = f"{bind_host or addr[0]}:{addr[1]}"
        self.executor.host = self.host
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True, name=f"http:{self.host}"
        )
        self._http_thread.start()
        if self.receiver is not None:
            self.receiver.start(self)
        # Self-register (reference: server.go:117-125).  A configured ring
        # that lacks this host would place slices without it: refuse.
        if self.cluster.nodes and self.cluster.node_by_host(self.host) is None:
            self.close()
            raise ValueError(f"host {self.host} is not among the cluster hosts")
        self.cluster.add_node(self.host, self.internal_host)
        self._sync_broadcast_targets()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, daemon=True, name=f"max-slices:{self.host}"
        )
        self._poll_thread.start()

    def add_peer(self, host: str, internal_host: str = "") -> None:
        """Add another node to the ring (nodes that bound port 0 learn
        each other once all are open).  Every node must end with the same
        node list: placement is a function of it."""
        self.cluster.add_node(host, internal_host)
        self._sync_broadcast_targets()

    def _sync_broadcast_targets(self) -> None:
        if isinstance(self.broadcaster, bc.HTTPBroadcaster):
            self.broadcaster.internal_hosts = [
                n.internal_host
                for n in self.cluster.nodes
                if n.host != self.host and n.internal_host
            ]

    def close(self) -> None:
        self._closing.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=10)
            self._poll_thread = None
        if self.receiver is not None:
            self.receiver.close()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
            self._http_thread = None
        self.executor.close()
        if self.coalescer is not None:
            # After the executor, before the holder: a query still in
            # flight launches directly when submit() raises CoalesceClosed.
            self.coalescer.close()
            self.executor.coalescer = self.coalescer = None
        self.holder.close()
        self.device_health.close()
        # After the holder: each fragment's close made its final commit;
        # now the committer stops, and a later server on this directory
        # attaches afresh.
        if self.ingest is not None:
            wal.unregister_manager(self.ingest)
            self.ingest.close()
            self.ingest = None
        # Stats transports (the StatsD socket) last: the close path above
        # may still emit.
        close = getattr(self.stats, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close()

    def _on_device_health_change(self, path: str, state: str) -> None:
        """A quarantine or heal of the card's breaker (JAX
        ``server.py:883``): the node's degraded flag follows it in the
        cluster, and the heal of a ``device:`` path stages the mirrors
        again through the prefetcher's staging lane (``staging_job``);
        queued writes apply at the first read after it."""
        try:
            self.cluster.note_degraded(self.host, self.device_health.degraded())
        except Exception as e:  # noqa: BLE001 — advisory path
            _log(f"degraded-flag routing update error: {e}")
        if state != health_mod.STATE_HEALTHY or not path.startswith("device:"):
            return
        try:
            self.staging_job = self.holder.stage_device_mirrors(
                device_mod.prefetcher(), tracer=self.tracer
            )
            if self.staging_job.total:
                _log(f"device health: {path} healed — staging "
                     f"{self.staging_job.total} fragment mirrors")
        except Exception as e:  # noqa: BLE001 — staging is best-effort
            _log(f"post-heal staging error: {e}")

    # --- background: max-slice polling (JAX server.py:822-847) ---

    def _poll_loop(self) -> None:
        while not self._closing.wait(self.polling_interval):
            self.tick_max_slices()

    def tick_max_slices(self) -> None:
        """Poll every peer's max slices so that slices held only
        elsewhere are queried too (reference: server.go:238-274).  A peer
        that does not answer is skipped until the next tick."""
        for node in list(self.cluster.nodes):
            if node.host == self.host:
                continue
            client = InternalClient(node.host, timeout=REMOTE_TIMEOUT_S)
            try:
                ms = client.max_slice_by_index()
                inv = client.max_slice_by_index(inverse=True)
            except TRANSPORT_ERRORS + (ClientError, ValueError):
                continue
            for index_name, max_slice in ms.items():
                idx = self.holder.index(index_name)
                if idx is not None:
                    idx.set_remote_max_slice(max_slice)
            for index_name, max_slice in inv.items():
                idx = self.holder.index(index_name)
                if idx is not None:
                    idx.set_remote_max_inverse_slice(max_slice)

    # --- broadcast (reference: server.go:277-325) ---

    def _on_create_slice(self, index: str, view_name: str, slice_i: int) -> None:
        self.broadcaster.send_async(
            wire.CreateSliceMessage(
                Index=index, Slice=slice_i, IsInverse=is_inverse_view(view_name)
            )
        )

    def receive_message(self, msg) -> None:
        """Apply a schema message from a peer."""
        if isinstance(msg, wire.CreateSliceMessage):
            idx = self.holder.index(msg.Index)
            if idx is None:
                raise RuntimeError("index not found")
            if msg.IsInverse:
                idx.set_remote_max_inverse_slice(msg.Slice)
            else:
                idx.set_remote_max_slice(msg.Slice)
        elif isinstance(msg, wire.CreateIndexMessage):
            meta = msg.Meta or wire.IndexMeta()
            opts = {}
            if meta.ColumnLabel:
                opts["column_label"] = meta.ColumnLabel
            if meta.TimeQuantum:
                opts["time_quantum"] = meta.TimeQuantum
            self.holder.create_index_if_not_exists(msg.Index, **opts)
        elif isinstance(msg, wire.DeleteIndexMessage):
            self.holder.delete_index(msg.Index)
        elif isinstance(msg, wire.CreateFrameMessage):
            idx = self.holder.index(msg.Index)
            if idx is None:
                raise RuntimeError("index not found")
            meta = msg.Meta or wire.FrameMeta()
            opts = {}
            if meta.RowLabel:
                opts["row_label"] = meta.RowLabel
            if meta.InverseEnabled:
                opts["inverse_enabled"] = True
            if meta.CacheType:
                opts["cache_type"] = meta.CacheType
            if meta.CacheSize:
                opts["cache_size"] = meta.CacheSize
            if meta.TimeQuantum:
                opts["time_quantum"] = meta.TimeQuantum
            idx.create_frame_if_not_exists(msg.Frame, **opts)
        elif isinstance(msg, wire.DeleteFrameMessage):
            idx = self.holder.index(msg.Index)
            if idx is not None:
                idx.delete_frame(msg.Frame)
        else:
            raise ValueError(f"unknown message type: {type(msg).__name__}")
