"""Server — one node: holder + executor + HTTP front end + cluster.

``Server(data_dir, host, device=...)`` opens the data directory (the
layout of ``pilosa_tpu.net.server``'s), serves the API of
net/handler.py on a ThreadingHTTPServer, and keeps every fragment's
device mirror on ``device`` — the CUDA card unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.

The cluster settings are those of the JAX package's ``[cluster]``
section (``pilosa_tpu/cli/ctl.py:45-100``):

* ``cluster_type`` ``"static"`` (a fixed node list, no messages),
  ``"http"`` (schema changes and new max slices are POSTed to every
  peer's internal listener, bound at ``internal_port``) or ``"gossip"``
  (``cluster/gossip.py``: a UDP membership that is the node set, the
  broadcaster and the receiver, as JAX ``cli/ctl.py:83-96`` builds it;
  ``gossip_seed`` a member's gossip address to join through,
  ``gossip_bind`` the UDP listener (default all interfaces on the HTTP
  port + 1000), ``gossip_interval`` / ``gossip_suspect_after`` its
  timers and ``gossip_ack_timeout_ms`` / ``gossip_stream_timeout_ms``
  the JAX ``[gossip]`` keys).  Gossip carries the node's schema (its
  ``local_status``, also served at ``GET /state``), its hot slices, which
  a restarting peer stages first, and its card's degraded flag; hosts it
  announces outside the ring are the rebalancer's join candidates;
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

Replica agreement, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:46, 74-94``, ``[net]`` and ``[cluster]``):

* ``query_timeout_ms`` — a query's default deadline (``X-Deadline-Ms``
  overrides it); ``broadcast_timeout_ms`` the socket timeout of the
  max-slice poll; ``retry_attempts`` / ``retry_backoff_ms`` the retry of
  idempotent calls to peers; ``breaker_failure_threshold`` /
  ``breaker_open_ms`` each peer's circuit breaker (``net/resilience.py``,
  shared by every client the node makes, shown at ``/debug/health``);
* ``write_consistency`` (``"quorum"``) and ``read_consistency``
  (``"one"``) — the W of a write and the R of a version-checked read
  (``replicate/``); ``hint_cap`` bits of hints per replica and slice,
  replayed when the replica's breaker half-opens, at most
  ``hint_replay_throttle_mbps`` (0: no limit);
* ``rebalance_throttle_mbps``, ``rebalance_verify_rounds``,
  ``rebalance_delta_cap`` and ``rebalance_release_delay_ms`` — the live
  resize (``rebalance/``, ``POST /cluster/resize``);
  ``rebalance_on_join`` admits the hosts gossip announces by a resize;
* ``anti_entropy_interval`` — seconds between anti-entropy sweeps
  (``sync/syncer.py``): slices whose replica versions agree are skipped,
  and every ``FULL_SYNC_EVERY``-th sweep walks every block
  (``tick_anti_entropy``).

The cold tier, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:95-100``, ``[tier]``): ``tier_store`` is the
shared object store (``http://host:port``, ``file:///path`` or a path;
"" for none); at open the node restores the schema from it and registers
every stored fragment it lacks as cold, hydrated at its first touch
(``tier/manager.py``), at most ``tier_hydrate_throttle_mbps``; every
``tier_sweep_interval_s`` a sweep ages time views past
``tier_retention_age_s`` to the store, deletes those past
``tier_retention_delete_s`` and demotes the least recently used
fragments past ``tier_disk_budget_bytes`` (0: no budget).

Standing queries, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:101-106``, ``[subscribe]``):
``subscribe_enabled``, ``subscribe_max_subscriptions``,
``subscribe_queue_cap`` (updates kept per subscription),
``subscribe_delta_cap`` (bits per slice between notifications before a
full re-run), ``subscribe_coalesce_ms`` and ``subscribe_refresh_ms``
(``subscribe/engine.py``).

Admission and tenant QoS, with the JAX package's names and defaults
(``pilosa_tpu/net/server.py:80-116``, ``[net]``): ``admission`` turns on
the per-class gates of ``net/admission.py`` (``point``, ``heavy``,
``write``, ``internal``, ``subscribe``), each
``admission_<class>_concurrency`` wide with a bounded queue of
``admission_queue_depth`` a tenant (the internal lane's as deep as it is
wide).  A request the node cannot serve within its deadline answers
429 with ``Retry-After`` before the executor, the coalescer or the card
see it.  ``tenants`` (``"name:weight[:qps[:bytes_per_s]]"``),
``tenant_keys`` (``"apikey:tenant"``), ``tenant_default`` and
``tenant_internal_token`` configure the ``TenantRegistry``, built even
with admission off; the token rides every ``InternalClient`` the node
makes, and the standing-query notifier takes a ``subscribe`` slot a
batch.

The rest of the JAX ``Server``'s knobs: ``logger`` (``log-path``,
stderr by default), ``long_query_time`` (``[cluster] long-query-time``:
seconds past which a query's text is logged; 0 never), ``device_stage`` / ``stage_throttle_ms`` (the
background staging at open and after a heal, and its sleep between
uploads), ``plane_sparse_max_bytes`` / ``plane_rle_max_bytes`` (the
sparse tier's per-row caps) and ``ingest_scatter`` (off: a write drops
the mirror instead of queuing its bits for K7).  ``cli/main.py``'s
``build_server`` maps a ``config.Config`` onto these keywords.

The node registers itself in the cluster on open, unless a ring is
configured without it: then it is a joining node, which gets slices only
through a resize.  Nodes that bind port 0 learn each other after they are
open: ``add_peer(host, internal_host)``.  At open the rebalancer restores
a transition persisted mid-resize, and the write listeners of the
rebalancer's delta log and of the replication's versions are
registered.
"""

from __future__ import annotations

import sys
import threading
import time

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.cluster import broadcast as bc
from pilosa_tpu_torch.cluster.topology import Cluster
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.device import health as health_mod
from pilosa_tpu_torch.core.view import is_inverse_view
from pilosa_tpu_torch.exec import coalesce as coalesce_mod
from pilosa_tpu_torch.exec import warmup
from pilosa_tpu_torch.core import fragment as fragment_mod
from pilosa_tpu_torch.exec.executor import DEFAULT_MAX_WRITES_PER_REQUEST, Executor
from pilosa_tpu_torch.ingest import scatter, wal
from pilosa_tpu_torch.net import admission as adm
from pilosa_tpu_torch.net import resilience as rz
from pilosa_tpu_torch.net import wire
from pilosa_tpu_torch.net.client import InternalClient
from pilosa_tpu_torch.net.handler import Handler, make_http_server
from pilosa_tpu_torch.obs import perf as perf_mod
from pilosa_tpu_torch.obs.trace import Tracer
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.rebalance import Rebalancer
from pilosa_tpu_torch.replicate import Replication
from pilosa_tpu_torch.sync.syncer import HolderSyncer
from pilosa_tpu_torch.testing import faults

CLUSTER_TYPES = ("static", "http", "gossip")
# reference: server.go / config.go defaults
DEFAULT_POLLING_INTERVAL = 60.0
DEFAULT_ANTI_ENTROPY_INTERVAL = 600.0
DEFAULT_INTERNAL_PORT = 14000
# Socket timeout of a map leg or a poll to a peer.
REMOTE_TIMEOUT_S = 60.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def _index_options(meta) -> dict:
    """An ``IndexMeta``'s set fields as ``create_index`` options."""
    meta = meta or wire.IndexMeta()
    opts = {}
    if meta.ColumnLabel:
        opts["column_label"] = meta.ColumnLabel
    if meta.TimeQuantum:
        opts["time_quantum"] = meta.TimeQuantum
    return opts


def _frame_options(meta) -> dict:
    """A ``FrameMeta``'s set fields as ``create_frame`` options."""
    meta = meta or wire.FrameMeta()
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
    return opts


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
        anti_entropy_interval: float = DEFAULT_ANTI_ENTROPY_INTERVAL,
        query_timeout_ms: float = 60_000.0,
        broadcast_timeout_ms: float = 5_000.0,
        retry_attempts: int = 3,
        retry_backoff_ms: float = 100.0,
        breaker_failure_threshold: int = 5,
        breaker_open_ms: float = 10_000.0,
        rebalance_throttle_mbps: float = 0.0,
        rebalance_verify_rounds: int = 3,
        rebalance_delta_cap: int = 50_000,
        rebalance_release_delay_ms: float = 200.0,
        rebalance_on_join: bool = False,
        write_consistency: str = "quorum",
        read_consistency: str = "one",
        hint_cap: int = 10_000,
        hint_replay_throttle_mbps: float = 0.0,
        tier_store: str = "",
        tier_hydrate_throttle_mbps: float = 0.0,
        tier_disk_budget_bytes: int = 0,
        tier_retention_age_s: float = 0.0,
        tier_retention_delete_s: float = 0.0,
        tier_sweep_interval_s: float = 60.0,
        subscribe_enabled: bool = True,
        subscribe_max_subscriptions: int = 10_000,
        subscribe_queue_cap: int = 256,
        subscribe_delta_cap: int = 50_000,
        subscribe_coalesce_ms: float = 5.0,
        subscribe_refresh_ms: float = 500.0,
        gossip_seed: str = "",
        gossip_bind: str = "",
        gossip_interval: float = 1.0,
        gossip_suspect_after: float = 5.0,
        gossip_ack_timeout_ms: float = 250.0,
        gossip_stream_timeout_ms: float = 10_000.0,
        logger=None,
        long_query_time: float = 0.0,
        device_stage: bool = True,
        stage_throttle_ms: float = 0.0,
        plane_sparse_max_bytes: int = 65536,
        plane_rle_max_bytes: int = 65536,
        ingest_scatter: bool = True,
        admission: bool = True,
        admission_point_concurrency: int = 32,
        admission_heavy_concurrency: int = 8,
        admission_write_concurrency: int = 16,
        admission_internal_concurrency: int = 128,
        admission_queue_depth: int = 64,
        admission_subscribe_concurrency: int = 4,
        tenants=None,
        tenant_keys=None,
        tenant_default: str = "default",
        tenant_internal_token: str = "",
    ):
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
        self.logger = logger or _log
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
        self.plane_sparse_max_bytes = plane_sparse_max_bytes
        self.plane_rle_max_bytes = plane_rle_max_bytes
        self.hbm_budget_bytes = hbm_budget_bytes
        self.device_prefetch = device_prefetch
        self.device_stage = device_stage
        self.stage_throttle_ms = stage_throttle_ms
        self.staging_job = None
        self.ingest_scatter = ingest_scatter
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
        self.cluster.long_query_time = long_query_time
        for h, ih in zip(hosts, internal_hosts):
            self.cluster.add_node(h, ih)
        if cluster_type == "http":
            bind_host = host.rpartition(":")[0] or "127.0.0.1"
            self.broadcaster = bc.HTTPBroadcaster(timeout=REMOTE_TIMEOUT_S)
            self.receiver = bc.HTTPBroadcastReceiver(bind_host, internal_port)
        else:
            # A gossip node set replaces it at open, once the node's HTTP
            # identity is known.
            self.broadcaster = bc.NopBroadcaster()
            self.receiver = None
        self.gossip_seed = gossip_seed
        self.gossip_bind = gossip_bind
        self.gossip_interval = gossip_interval
        self.gossip_suspect_after = gossip_suspect_after
        self.gossip_ack_timeout_ms = gossip_ack_timeout_ms
        self.gossip_stream_timeout_ms = gossip_stream_timeout_ms
        self.node_set = None
        self.tier_store = tier_store
        self.tier_hydrate_throttle_mbps = tier_hydrate_throttle_mbps
        self.tier_disk_budget_bytes = tier_disk_budget_bytes
        self.tier_retention_age_s = tier_retention_age_s
        self.tier_retention_delete_s = tier_retention_delete_s
        self.tier_sweep_interval_s = tier_sweep_interval_s
        self.tier = None
        self.subscribe_enabled = subscribe_enabled
        self.subscribe_max_subscriptions = subscribe_max_subscriptions
        self.subscribe_queue_cap = subscribe_queue_cap
        self.subscribe_delta_cap = subscribe_delta_cap
        self.subscribe_coalesce_ms = subscribe_coalesce_ms
        self.subscribe_refresh_ms = subscribe_refresh_ms
        self.subscribe = None
        self.stats = stats
        self.tracer = Tracer(capacity=trace_ring)
        self.floor_probe = floor_probe
        self.stream_chunk_bytes = stream_chunk_bytes
        self.anti_entropy_interval = anti_entropy_interval
        self._ae_ticks = 0
        # Deadlines, retries and per-peer breakers (JAX server.py:197-215),
        # shared by every client this node makes.
        self.broadcast_timeout_ms = broadcast_timeout_ms
        self.resilience = rz.Resilience(
            retry=rz.RetryPolicy(attempts=retry_attempts, backoff=retry_backoff_ms / 1000.0,
                                 stats=stats),
            breakers=rz.BreakerRegistry(failure_threshold=breaker_failure_threshold,
                                        open_s=breaker_open_ms / 1000.0, stats=stats),
            query_timeout_ms=query_timeout_ms,
        )
        # Tenant QoS (JAX server.py:216-250): API-key resolution, WFQ
        # weights and quota buckets, built even with admission off so
        # that the internal lane's token check and /debug/tenants work;
        # the controller's gates answer 429 before the executor, the
        # coalescer or the card see a request.
        self.tenants = adm.TenantRegistry(
            tenants=tenants,
            keys=tenant_keys,
            default_tenant=tenant_default,
            internal_token=tenant_internal_token,
            stats=stats,
        )
        self.admission = None
        if admission:
            self.admission = adm.AdmissionController(
                point_concurrency=admission_point_concurrency,
                heavy_concurrency=admission_heavy_concurrency,
                write_concurrency=admission_write_concurrency,
                internal_concurrency=admission_internal_concurrency,
                subscribe_concurrency=admission_subscribe_concurrency,
                queue_depth=admission_queue_depth,
                stats=stats,
                tenants=self.tenants,
            )
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
            logger=self.logger,
            on_state_change=self._on_device_health_change,
            device=self.holder.placed,
        )
        # The live resize (JAX server.py:251-265): topology events on
        # every node, slice migration on the node a resize is sent to.
        self.rebalance_throttle_mbps = rebalance_throttle_mbps
        self.rebalance_verify_rounds = rebalance_verify_rounds
        self.rebalance_delta_cap = rebalance_delta_cap
        self.rebalance_release_delay_ms = rebalance_release_delay_ms
        self.rebalance_on_join = rebalance_on_join
        self.rebalance = Rebalancer(self)
        # Quorum replication (JAX server.py:266-290): slice versions, W-of-N
        # writes with hints, version-checked reads with read repair; its
        # repairs ride the rebalancer's delta actions.
        self.replication = Replication(
            host=host,
            cluster=self.cluster,
            holder=self.holder,
            client_factory=self._client,
            rebalancer=self.rebalance,
            tracer=self.tracer,
            stats=self.holder.stats,
            logger=self.logger,
            data_dir=data_dir,
            write_consistency=write_consistency,
            read_consistency=read_consistency,
            hint_cap=hint_cap,
            hint_replay_throttle_mbps=hint_replay_throttle_mbps,
        )
        self.executor = Executor(
            self.holder,
            max_writes_per_request=max_writes_per_request,
            cluster=self.cluster,
            host=host,
            client_factory=self._client,
            tracer=self.tracer,
            device_health=self.device_health,
            replication=self.replication,
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
            logger=self.logger,
            admission=self.admission,
            tenants=self.tenants,
        )
        # /debug/profile tars its traces under the data dir.
        self.handler.profile_dir = data_dir
        self.handler.resilience = self.resilience
        self.handler.replication = self.replication
        self.handler.rebalance = self.rebalance
        self._http = None
        self._http_thread: threading.Thread | None = None
        self._closing = threading.Event()
        self._loops: list[threading.Thread] = []

    @property
    def internal_host(self) -> str:
        return self.receiver.bound_host if self.receiver is not None else ""

    def _client(self, node) -> InternalClient:
        """A client of a peer with this node's retry policy, breakers and
        internal-lane token (and, through the deadline's context
        variable, the current query's remaining budget)."""
        host = node if isinstance(node, str) else node.host
        return InternalClient(host, timeout=REMOTE_TIMEOUT_S, device=self.device,
                              retry=self.resilience.retry,
                              breakers=self.resilience.breakers,
                              internal_token=self.tenants.internal_token)

    # --- lifecycle (reference: server.go:99-198) ---

    def open(self) -> None:
        # A chaos plan (testing/faults.py) is announced loudly: a run under
        # injected faults must be unmistakable.
        plan = faults.active()
        if plan is not None and plan.rules:
            self.logger(f"FAULT INJECTION ACTIVE: {len(plan.rules)} rule(s): "
                 + "; ".join(f"{r.stage}/{r.kind or r.mode}" for r in plan.rules))
        bp.configure_plane_format(mode=self.plane_format,
                                  sparse_max_bytes=self.plane_sparse_max_bytes,
                                  rle_max_bytes=self.plane_rle_max_bytes)
        # Process-wide, as in the JAX package: off, a write drops the
        # mirror instead of queuing its bits for K7.
        scatter.ENABLED = bool(self.ingest_scatter)
        if self.mesh_devices:
            bp.configure_mesh_devices(self.mesh_devices)
        members = bp.placement(self.holder.placed)
        if len(members) > 1:
            self.logger(f"data plane: mesh-sharded over {len(members)} devices "
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
                logger=self.logger,
                device=self.device,
            )
            perf_mod.registry().set_floor(fp["mean_gbps"])
        if self.ingest_wal:
            self.ingest = wal.IngestManager(
                self.data_dir,
                group_commit_ms=self.ingest_group_commit_ms,
                group_commit_max=self.ingest_group_commit_max,
                wal_segment_bytes=self.ingest_wal_segment_bytes,
                logger=self.logger,
                stats=self.stats,
                versions=self.replication.versions,
            )
            wal.register_manager(self.ingest)
        self.holder.open()
        # The cold tier (JAX server.py:478-510): the store client shares
        # the node's retry and breakers; the bootstrap restores the schema
        # and registers the stored fragments this node lacks as cold
        # before the first query routes.
        if self.tier_store:
            from pilosa_tpu_torch.tier import TierManager, open_store

            store = open_store(self.tier_store, stats=self.stats,
                               retry=self.resilience.retry, breakers=self.resilience.breakers)
            self.tier = TierManager(
                holder=self.holder,
                store=store,
                prefetcher=device_mod.prefetcher(),
                stats=self.stats,
                tracer=self.tracer,
                logger=self.logger,
                hydrate_throttle_mbps=self.tier_hydrate_throttle_mbps,
                disk_budget_bytes=self.tier_disk_budget_bytes,
                retention_age_s=self.tier_retention_age_s,
                retention_delete_s=self.tier_retention_delete_s,
            )
            boot = self.tier.bootstrap()
            self.logger(f"tier: cold store {store.url} attached ({boot['cold']} cold fragment(s) "
                 f"registered, {boot['frames']} frame(s) restored from schema)")
            self.handler.tier = self.tier
        # The delta log records every write to a migrating slice; the
        # replication's listener moves slice versions and feeds the quorum
        # coordinator's hint capture (JAX server.py:555-571).
        fragment_mod.register_write_listener(self.rebalance.delta_log.record)
        if self.stats is not None:
            self.replication.stats = self.holder.stats
            self.replication.versions.stats = self.holder.stats
            self.replication.hints.stats = self.holder.stats
        fragment_mod.register_write_listener(self.replication.on_local_write)
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
            warmup.prewarm_async(self.holder.placed, logger=self.logger)
        self.executor.prefetcher = device_mod.prefetcher() if self.device_prefetch else None
        self.executor.ingest = self.ingest
        self.handler.ingest = self.ingest
        self.handler.prefetcher = device_mod.prefetcher()
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
        # One provider feeds /state and gossip's piggybacked state, so the
        # digest gossip advertises is that of the blob /state serves.
        self.handler.state_provider = lambda: self.local_status().encode()
        if self.receiver is not None:
            self.receiver.start(self)
        # Self-register (reference: server.go:117-125), unless a ring is
        # configured without this host: a joining node, which takes
        # slices only through a resize (POST /cluster/resize).
        if self.cluster.nodes and self.cluster.node_by_host(self.host) is None:
            self.logger(f"host {self.host} is not in the configured ring "
                 f"({len(self.cluster.nodes)} nodes); joining — slice "
                 "ownership arrives via /cluster/resize")
        else:
            self.cluster.add_node(self.host, self.internal_host)
        self._sync_broadcast_targets()
        if self.cluster_type == "gossip":
            self._open_gossip()
        # A transition persisted mid-resize comes back (both rings and the
        # flipped slices) before the first query routes.
        self.rebalance.resume_from_disk()
        # The node's identity is final now (a ":0" port resolved): the
        # persisted versions load and the hint replayer starts.
        self.replication.host = self.host
        self.replication.open()
        # Standing queries (JAX server.py:667-689): the manager registers
        # its own fragment write and close listeners and runs its
        # notifier; a full re-run pulls through the executor.
        if self.subscribe_enabled:
            from pilosa_tpu_torch.subscribe import SubscriptionManager

            self.subscribe = SubscriptionManager(
                executor=self.executor,
                cluster=self.cluster,
                stats=self.stats,
                tracer=self.tracer,
                admission=self.admission,
                data_dir=self.data_dir,
                logger=self.logger,
                max_subscriptions=self.subscribe_max_subscriptions,
                queue_cap=self.subscribe_queue_cap,
                delta_cap=self.subscribe_delta_cap,
                coalesce_ms=self.subscribe_coalesce_ms,
                refresh_interval_ms=self.subscribe_refresh_ms,
            )
            self.subscribe.open()
            self.handler.subscribe = self.subscribe
        # Serving has started; the mirrors stream in behind it: the slices
        # gossip peers report hot, then the previous run's .residency.json,
        # then the largest that fit the budget.  A query's own prefetch
        # jumps them.
        if self.device_stage:
            self.staging_job = self.holder.stage_device_mirrors(
                device_mod.prefetcher(), hot_slices=self._gossip_hot_slices(),
                throttle_s=self.stage_throttle_ms / 1000.0, tracer=self.tracer,
            )
        loops = [
            ("max-slices", self.tick_max_slices, self.polling_interval),
            ("anti-entropy", self.tick_anti_entropy, self.anti_entropy_interval),
        ]
        if self.tier is not None:
            # Retention aging and deletion, then the disk budget's demotions.
            loops.append(("tier-sweep", self.tier.sweep, self.tier_sweep_interval_s))
        for name, fn, interval in loops:
            t = threading.Thread(target=self._loop, args=(fn, interval), daemon=True,
                                 name=f"{name}:{self.host}")
            t.start()
            self._loops.append(t)

    def _open_gossip(self) -> None:
        """Build and open the gossip node set with the node's final HTTP
        identity (JAX ``cli/ctl.py:83-96``, ``net/server.py:612-640``) and
        wire it as the cluster's node set, the broadcaster and the
        receiver.  A node that joins through a seed waits a few gossip
        intervals for its peers' hot slices, which its staging puts
        first."""
        from pilosa_tpu_torch.cluster.gossip import GossipNodeSet

        ns = GossipNodeSet(
            host=self.host,
            bind=self.gossip_bind,
            seed=self.gossip_seed,
            gossip_interval=self.gossip_interval,
            suspect_after=self.gossip_suspect_after,
            state_provider=self.handler.state_provider,
            state_merger=lambda blob: self.handle_remote_status(wire.NodeStatus.decode(blob)),
            hot_provider=self.holder.hot_slices,
            health_provider=self.device_health.degraded,
            logger=self.logger,
            stats=self.stats,
            ack_timeout=self.gossip_ack_timeout_ms / 1000.0,
            stream_timeout=self.gossip_stream_timeout_ms / 1000.0,
        )
        ns.on_peer_health = self.cluster.note_degraded
        ns.on_membership_change = self._on_membership_change
        self.node_set = self.cluster.node_set = ns
        self.broadcaster = self.handler.broadcaster = ns
        ns.start(self)
        ns.open()
        if self.gossip_seed:
            deadline = time.monotonic() + min(2.0, 10 * self.gossip_interval)
            while not ns.remote_hot_slices() and time.monotonic() < deadline:
                self._closing.wait(self.gossip_interval / 2)

    def _gossip_hot_slices(self) -> dict[str, list[int]]:
        """The peers' fresh hot-slice announcements (their union) when the
        node gossips; {} otherwise."""
        if self.node_set is None:
            return {}
        try:
            return self.node_set.remote_hot_slices()
        except Exception:  # noqa: BLE001 — the staging order is best-effort
            return {}

    def _on_membership_change(self, items) -> None:
        """Gossip membership into node states (JAX ``server.py:933``): the
        ring itself never changes on liveness (placement moves only by a
        resize); a host outside the ring is a join candidate."""
        for host, state in items:
            node = self.cluster.node_by_host(host)
            if node is not None:
                node.set_state(state)
            else:
                try:
                    self.rebalance.note_membership(host, state)
                except Exception as e:  # noqa: BLE001 — advisory path
                    self.logger(f"join-candidate tracking error: {e}")

    def local_status(self) -> wire.NodeStatus:
        """This node's schema and max slices, the state gossip carries
        (JAX ``server.py:1010``)."""
        pb = wire.NodeStatus(Host=self.host, State="UP")
        for idx in self.holder.indexes().values():
            pb_idx = wire.Index(
                Name=idx.name,
                Meta=wire.IndexMeta(ColumnLabel=idx.column_label, TimeQuantum=idx.time_quantum),
                MaxSlice=idx.max_slice(),
            )
            for f in idx.frames().values():
                pb_idx.Frames.append(wire.Frame(
                    Name=f.name,
                    Meta=wire.FrameMeta(
                        RowLabel=f.row_label,
                        InverseEnabled=f.inverse_enabled,
                        CacheType=f.cache_type,
                        CacheSize=f.cache_size,
                        TimeQuantum=f.time_quantum,
                    ),
                ))
            pb.Indexes.append(pb_idx)
        return pb

    def handle_remote_status(self, status: wire.NodeStatus) -> None:
        """Merge a peer's schema into this node's: missing indexes and
        frames are created and remote max slices adopted (reference:
        server.go:382-412)."""
        for pb_idx in status.Indexes:
            idx = self.holder.create_index_if_not_exists(pb_idx.Name, **_index_options(pb_idx.Meta))
            idx.set_remote_max_slice(pb_idx.MaxSlice)
            for pb_f in pb_idx.Frames:
                idx.create_frame_if_not_exists(pb_f.Name, **_frame_options(pb_f.Meta))

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
        # Push delivery stops first: the notifier must not evaluate
        # against a holder that is being torn down.
        if self.subscribe is not None:
            self.subscribe.close()
            self.subscribe = self.handler.subscribe = None
        for t in self._loops:
            t.join(timeout=10)
        self._loops = []
        if self.node_set is not None:
            self.node_set.close()
        self.rebalance.close()
        # Stops the hint replayer and persists the slice versions
        # (.replication.json), so that a clean restart compares.
        self.replication.close()
        fragment_mod.unregister_write_listener(self.rebalance.delta_log.record)
        fragment_mod.unregister_write_listener(self.replication.on_local_write)
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
            self.logger(f"degraded-flag routing update error: {e}")
        if (state != health_mod.STATE_HEALTHY or not path.startswith("device:")
                or not self.device_stage):
            return
        try:
            self.staging_job = self.holder.stage_device_mirrors(
                device_mod.prefetcher(), throttle_s=self.stage_throttle_ms / 1000.0,
                tracer=self.tracer,
            )
            if self.staging_job.total:
                self.logger(f"device health: {path} healed — staging "
                     f"{self.staging_job.total} fragment mirrors")
        except Exception as e:  # noqa: BLE001 — staging is best-effort
            self.logger(f"post-heal staging error: {e}")

    # --- background loops (JAX server.py:797-847) ---

    def _loop(self, fn, interval: float) -> None:
        while not self._closing.wait(interval):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — a loop must survive
                self.logger(f"background loop error: {e}")

    # Every Nth anti-entropy sweep ignores the version-agreement fast path
    # and walks every block's checksum: the backstop for versions that
    # agree while the content does not (a crash reset).
    FULL_SYNC_EVERY = 4

    def tick_anti_entropy(self) -> None:
        """One anti-entropy sweep over every owned fragment (JAX
        ``server.py:809-820``): attributes, then each fragment whose
        replica versions disagree (every ``FULL_SYNC_EVERY``-th sweep:
        each one) has its blocks compared and merged.  Merged writes
        queue for the mirrors; the next read applies them (K7)."""
        self._ae_ticks += 1
        HolderSyncer(
            holder=self.holder,
            host=self.host,
            cluster=self.cluster,
            closing=self._closing,
            client_factory=self._client,
            replication=self.replication,
            full=(self._ae_ticks % self.FULL_SYNC_EVERY == 0),
        ).sync_holder()

    def tick_max_slices(self) -> None:
        """Poll every peer's max slices so that slices held only
        elsewhere are queried too (reference: server.go:238-274), with
        ``broadcast_timeout_ms`` and the node's retry and breakers.  A
        peer that does not answer is skipped until the next tick."""
        for node in self.cluster.route_nodes():
            if node.host == self.host:
                continue
            client = self._client(node.host)
            client.timeout = self.broadcast_timeout_ms / 1000.0
            try:
                ms = client.max_slice_by_index()
                inv = client.max_slice_by_index(inverse=True)
            except Exception:  # noqa: BLE001 — a peer may be down
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
            self.holder.create_index_if_not_exists(msg.Index, **_index_options(msg.Meta))
        elif isinstance(msg, wire.DeleteIndexMessage):
            self.holder.delete_index(msg.Index)
        elif isinstance(msg, wire.CreateFrameMessage):
            idx = self.holder.index(msg.Index)
            if idx is None:
                raise RuntimeError("index not found")
            idx.create_frame_if_not_exists(msg.Frame, **_frame_options(msg.Meta))
        elif isinstance(msg, wire.DeleteFrameMessage):
            idx = self.holder.index(msg.Index)
            if idx is not None:
                idx.delete_frame(msg.Frame)
        else:
            raise ValueError(f"unknown message type: {type(msg).__name__}")
