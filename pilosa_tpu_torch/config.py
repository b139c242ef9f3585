"""Configuration — TOML file + environment + flag layering.

The port's own copy of ``pilosa_tpu/config.py``: the same keys, defaults,
environment variables and validation messages, so one ``pilosa.toml``
opens in both packages to equal settings, and ``to_toml()`` (the
``generate-config`` and ``config`` output) is the JAX package's text
byte for byte.

Schema matches the reference's TOML config (reference: config.go:19-90):
data-dir, host, cluster{replicas, type, hosts, internal-hosts,
polling-interval, internal-port, long-query-time}, anti-entropy.interval,
max-writes-per-request, log-path, metrics{service, host}, plus the JAX
package's additions.  Precedence is flag > env (PILOSA_*) > file >
default (reference: cmd/root.go:85-150), and unknown keys in the file
are rejected (reference: cmd/root.go:113-118).

The ``[tpu]`` section keeps its name, so a file of either package opens
in the other.  In the port:

* ``mesh-shape`` sets ``PILOSA_TPU_MESH_SHAPE``, which the port's
  ``ops/bitplane.py`` reads as the member count of its data plane;
* ``compilation-cache-dir`` has no effect: the port has no compiled
  query programs to cache.  Its kernels are built once per source, at
  their first launch, into the git-ignored ``build/torch_kernels/``
  (``ops/_build.py``), which every later process reuses.  The key is
  accepted, validated and printed, and not passed to the ``Server``;
* ``prewarm`` builds every kernel and launches each once at open, in
  the background (``exec/warmup.prewarm_async``);
* ``use-pallas`` is accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: the shim package
    import tomli as tomllib
from dataclasses import dataclass, field

# reference: server.go:33-36, config.go:19-58
DEFAULT_HOST = "localhost:10101"
DEFAULT_INTERNAL_PORT = 14000
DEFAULT_DATA_DIR = "~/.pilosa_tpu"
DEFAULT_ANTI_ENTROPY_INTERVAL = 600
DEFAULT_POLLING_INTERVAL = 60
DEFAULT_MAX_WRITES = 5000

CLUSTER_TYPES = ("static", "http", "gossip")

_KNOWN_KEYS = {
    "data-dir",
    "host",
    "log-path",
    "max-writes-per-request",
    "cluster",
    "cluster.replicas",
    "cluster.type",
    "cluster.hosts",
    "cluster.internal-hosts",
    "cluster.polling-interval",
    "cluster.internal-port",
    "cluster.gossip-seed",
    "cluster.long-query-time",
    "cluster.rebalance-throttle-mbps",
    "cluster.rebalance-verify-rounds",
    "cluster.rebalance-delta-cap",
    "cluster.rebalance-release-delay-ms",
    "cluster.rebalance-on-join",
    "cluster.write-consistency",
    "cluster.read-consistency",
    "cluster.hint-cap",
    "cluster.hint-replay-throttle-mbps",
    "anti-entropy",
    "anti-entropy.interval",
    "metrics",
    "metrics.service",
    "metrics.host",
    "obs",
    "obs.slow-query-ms",
    "obs.trace-ring",
    "obs.latency-buckets-ms",
    "obs.slo-ms",
    "obs.slo-objective",
    "obs.floor-probe",
    "net",
    "net.stream-chunk-bytes",
    "net.query-timeout-ms",
    "net.broadcast-timeout-ms",
    "net.retry-attempts",
    "net.retry-backoff-ms",
    "net.breaker-failure-threshold",
    "net.breaker-open-ms",
    "net.admission",
    "net.admission-point-concurrency",
    "net.admission-heavy-concurrency",
    "net.admission-write-concurrency",
    "net.admission-internal-concurrency",
    "net.admission-queue-depth",
    "net.admission-subscribe-concurrency",
    "net.tenants",
    "net.tenant-keys",
    "net.tenant-default",
    "net.tenant-internal-token",
    "subscribe",
    "subscribe.enabled",
    "subscribe.max-subscriptions",
    "subscribe.queue-cap",
    "subscribe.delta-cap",
    "subscribe.coalesce-ms",
    "subscribe.refresh-interval-ms",
    "ingest",
    "ingest.wal",
    "ingest.group-commit-ms",
    "ingest.group-commit-max",
    "ingest.scatter",
    "ingest.wal-segment-bytes",
    "gossip",
    "gossip.ack-timeout-ms",
    "gossip.stream-timeout-ms",
    "device",
    "device.mesh-devices",
    "device.hbm-budget-bytes",
    "device.prefetch",
    "device.stage",
    "device.stage-throttle-ms",
    "device.launch-watchdog-ms",
    "device.quarantine-threshold",
    "device.quarantine-open-ms",
    "device.quarantine-probe-successes",
    "device.plane-format",
    "device.plane-sparse-max-bytes",
    "device.plane-rle-max-bytes",
    "tier",
    "tier.store",
    "tier.hydrate-throttle-mbps",
    "tier.disk-budget-bytes",
    "tier.retention-age-s",
    "tier.retention-delete-s",
    "tier.sweep-interval-s",
    "exec",
    "exec.coalesce",
    "exec.coalesce-max-batch",
    "exec.coalesce-max-wait-us",
    "exec.fuse",
    "exec.fuse-max-programs",
    "tpu",
    "tpu.mesh-shape",
    "tpu.compilation-cache-dir",
    "tpu.prewarm",
    # Accepted and ignored, as in the JAX package: files generated by
    # its earlier releases carry the key and must not be rejected.
    "tpu.use-pallas",
}


class ConfigError(ValueError):
    pass


@dataclass
class ClusterConfig:
    replicas: int = 1
    type: str = "static"
    hosts: list[str] = field(default_factory=list)
    internal_hosts: list[str] = field(default_factory=list)
    polling_interval: int = DEFAULT_POLLING_INTERVAL
    internal_port: int = DEFAULT_INTERNAL_PORT
    gossip_seed: str = ""
    long_query_time: float = 0.0
    # Elastic rebalancing (pilosa_tpu_torch/rebalance): bandwidth ceiling for
    # bulk slice migration in megabits/s (0 = unthrottled), checksum
    # replay-verify rounds per copy attempt, the per-slice delta-log
    # bit cap (overflow => recopy), how long a source waits after a
    # slice's cutover before dropping its data (lets in-flight old-ring
    # reads drain), and whether a gossip-announced non-member
    # auto-triggers the admitting resize.
    rebalance_throttle_mbps: float = 0.0
    rebalance_verify_rounds: int = 3
    rebalance_delta_cap: int = 50_000
    rebalance_release_delay_ms: float = 200.0
    rebalance_on_join: bool = False
    # Quorum replication (pilosa_tpu_torch/replicate): default write/read
    # consistency levels (one | quorum | all; per-request override via
    # X-Write-Consistency / X-Read-Consistency), the per-(replica,
    # slice) hinted-handoff bit cap (overflow drops the slice's hints
    # -- anti-entropy/read-repair then own convergence), and the hint
    # replay bandwidth ceiling in megabits/s (0 = unthrottled).
    write_consistency: str = "quorum"
    read_consistency: str = "one"
    hint_cap: int = 10_000
    hint_replay_throttle_mbps: float = 0.0


@dataclass
class MetricsConfig:
    service: str = "nop"  # nop | expvar | statsd
    host: str = ""


@dataclass
class ObsConfig:
    """Query-path observability (tracing + slow-query log)."""

    # Structured slow-query log threshold in milliseconds; queries whose
    # trace exceeds it emit one JSON log line with a per-stage time
    # breakdown.  0 disables.  (cluster.long-query-time remains the
    # reference-parity plain-text log.)
    slow_query_ms: float = 0.0
    # Finished query traces retained in the ring buffer served by
    # GET /debug/traces.
    trace_ring: int = 64
    # Fixed upper bounds (ms) for the native Prometheus latency
    # histogram families on /metrics (query latency per admission class
    # and HTTP latency per endpoint).  Empty = the built-in 1ms..10s
    # log-ish ladder (obs/perf.py DEFAULT_BUCKETS_MS).
    latency_buckets_ms: list = field(default_factory=list)
    # Query-latency SLO threshold in ms; > 0 enables the per-class SLO
    # error-rate and burn-rate gauges on /metrics.  0 disables.
    slo_ms: float = 0.0
    # SLO objective (fraction of queries that must land under slo-ms);
    # burn rate = windowed error rate / (1 - objective).
    slo_objective: float = 0.999
    # One-shot per-device stream-floor probe at server open — anchors
    # the /debug/perf roofline percentages.  Cached under the data dir,
    # so restarts skip the measurement.
    floor_probe: bool = True


@dataclass
class NetConfig:
    """HTTP data-plane tuning + cluster resilience (net/resilience.py)."""

    # Chunk size for streamed bodies (CSV export, fragment tar
    # backup/restore): every socket write and client read moves this
    # many bytes.  0 = the built-in default (stream.DEFAULT_CHUNK_BYTES).
    stream_chunk_bytes: int = 0
    # Default per-query deadline in milliseconds; overridable per
    # request via the X-Deadline-Ms header.  Every remote leg, retry
    # sleep, and coalesce wait derives its timeout from the remaining
    # budget; an expired deadline answers HTTP 504.  0 disables.
    query_timeout_ms: float = 60_000.0
    # Socket timeout for the node-status polling loop's unary GETs
    # (was hardcoded 5.0 s in Server._tick_max_slices).
    broadcast_timeout_ms: float = 5_000.0
    # Capped jittered-exponential retry for idempotent unary RPCs
    # (query map legs, schema reads, fragment/block reads, attr diffs):
    # total attempts, and the first backoff (doubling, jittered).
    retry_attempts: int = 3
    retry_backoff_ms: float = 100.0
    # Per-host circuit breaker: consecutive transport failures that trip
    # it open, and how long it stays open before a half-open probe.
    breaker_failure_threshold: int = 5
    breaker_open_ms: float = 10_000.0
    # Admission control (net/admission.py): per-cost-class concurrency
    # gates + bounded queues in front of the executor.  A request whose
    # predicted queue wait exceeds its remaining X-Deadline-Ms budget
    # (or whose class queue is full) is answered 429 + Retry-After
    # before any executor/coalescer/device work.  Classes: point
    # (Count/Bitmap algebra), heavy (TopN/Sum/Min/Max/Range), write
    # (PQL writes + imports), internal (remote map legs — a separate
    # higher-priority lane so a saturated cluster cannot livelock).
    admission: bool = True
    admission_point_concurrency: int = 32
    admission_heavy_concurrency: int = 8
    admission_write_concurrency: int = 16
    admission_internal_concurrency: int = 128
    # Bounded queue depth per client class (internal sizes its own).
    admission_queue_depth: int = 64
    # The standing-query notification lane (pilosa_tpu_torch/subscribe):
    # narrow by design — push freshness degrades under load, pull
    # latency doesn't.
    admission_subscribe_concurrency: int = 4
    # Multi-tenant QoS (net/admission.py TenantRegistry).  Each entry
    # is "name:weight[:qps[:bytes_per_s]]" — weight is the WFQ share
    # inside each cost class; qps/bytes_per_s are token-bucket quotas
    # (0 / omitted = unlimited).  Empty = single default tenant, QoS
    # inert.
    tenants: list = field(default_factory=list)
    # API-key -> tenant bindings, "apikey:tenant".  Requests present
    # X-Api-Key; unmatched keys (and untagged traffic) ride
    # tenant-default.
    tenant_keys: list = field(default_factory=list)
    # Tenant charged for untagged traffic.
    tenant_default: str = "default"
    # Shared secret for the internal lane.  When set, X-Internal-Lane
    # and the Remote query flag are honored only with a matching
    # X-Internal-Token header (intra-cluster clients attach it), so
    # tenants cannot spoof their way past QoS.  Empty = trusted network
    # (every pre-tenant deployment).
    tenant_internal_token: str = ""


@dataclass
class GossipConfig:
    """UDP gossip membership tuning (cluster/gossip.py).  Values were
    magic constants (ack_timeout = 0.25, _STREAM_TIMEOUT_S = 10.0);
    defaults preserve them."""

    # First send_sync ACK wait in milliseconds (doubles per retry).
    ack_timeout_ms: float = 250.0
    # Timeout for the HTTP state-stream fallback (GET /state).
    stream_timeout_ms: float = 10_000.0


@dataclass
class DeviceConfig:
    """Device-memory residency manager (device/pool.py) + mesh data plane."""

    # Devices participating in slice placement and the mesh-sharded
    # data plane (ops/bitplane.participating_devices): 0 = all visible
    # devices (the default — with >1 visible, sharded execution engages
    # automatically), 1 = force the single-device data plane, N caps
    # the mesh at N devices.
    mesh_devices: int = 0
    # Per-device budget in bytes for pool-registered device memory
    # (fragment mirrors, paged sparse rows, executor caches).  0 = auto:
    # a safe fraction of the detected device memory, unbounded when the
    # backend reports none (the CPU backend).
    hbm_budget_bytes: int = 0
    # Async prefetch of a query's cold leaf mirrors (device/prefetch.py).
    prefetch: bool = True
    # Lazy overlapped cold staging: after (re)start the node serves
    # immediately while fragment mirrors stream onto the card in the
    # background — gossip-announced hot slices first, then the
    # pre-restart residency table persisted at shutdown.  False = no
    # background staging; queries still stage their own planes on
    # first touch.
    stage: bool = True
    # Sleep between background stage uploads in milliseconds (0 = full
    # speed) — keeps bulk staging from saturating the host->device
    # link while the node is already serving.
    stage_throttle_ms: float = 0.0
    # Device-fault tolerance (device/health.py).  launch-watchdog-ms
    # bounds a collective (mesh psum) dispatch+fetch: past it the
    # launch is declared HUNG, its waiters fail over to the host
    # evaluator, and the mesh path quarantines (0 disables the
    # watchdog).  quarantine-threshold consecutive classified launch
    # failures quarantine a device path (a hang quarantines
    # immediately); after quarantine-open-ms one half-open probe launch
    # is admitted, and quarantine-probe-successes successful probes
    # heal the path.
    launch_watchdog_ms: float = 60_000.0
    quarantine_threshold: int = 3
    quarantine_open_ms: float = 10_000.0
    quarantine_probe_successes: int = 1
    # Per-row device plane container format (ops/bitplane.encode_row):
    # "auto" picks the cheapest of dense words / packed-position sparse /
    # RLE runs per row by encoded size; "dense" forces full dense words
    # everywhere (compression off — also disables the anchored
    # position-domain count route).
    plane_format: str = "auto"
    # Ceilings on the encoded payload size a row may take in each
    # compressed format before it falls back to dense words.  The
    # defaults (64 KiB = half a dense row) bound worst-case device
    # scratch for payload expansion.
    plane_sparse_max_bytes: int = 65536
    plane_rle_max_bytes: int = 65536


@dataclass
class TierConfig:
    """Tiered storage: the shared object-store cold tier below the
    RAM/disk residency hierarchy (pilosa_tpu_torch/tier)."""

    # Object-store location; "" disables the tier.  "http://host:port"
    # = the S3-style HTTP backend (retry + breaker via net/resilience);
    # "file:///path" or a bare path = the local-filesystem backend.
    store: str = ""
    # Token throttle on hydration reads in megabits/s (0 = unthrottled)
    # — bulk hydration must not saturate the store link while serving.
    hydrate_throttle_mbps: float = 0.0
    # Local-disk budget for HOT fragment bytes (roaring file + TopN
    # cache — what the page cache carries for the mmap'd opens); past
    # it, least-recently-touched fragments demote back to tar-only in
    # the store.  0 = unbounded.
    disk_budget_bytes: int = 0
    # Default time-quantum retention: seconds past a sub-view's
    # quantum end before it AGES to the store, and before it DELETES
    # outright.  0 disables each; per-frame overrides live in frame
    # meta (retentionAgeS / retentionDeleteS).
    retention_age_s: float = 0.0
    retention_delete_s: float = 0.0
    # Background sweep cadence (retention + disk-budget enforcement).
    sweep_interval_s: float = 60.0


@dataclass
class SubscribeConfig:
    """Standing queries (pilosa_tpu_torch/subscribe): push-based PQL
    subscriptions with incremental delta evaluation."""

    # Master switch for POST /subscribe and the notifier thread.
    enabled: bool = True
    # Most concurrently registered subscriptions per node; past it,
    # registration answers 400.
    max_subscriptions: int = 10_000
    # Per-subscription retained-update ring: a slow consumer loses the
    # oldest updates (at-least-once with absolute values, so nothing
    # is unrecoverable — the next update carries the full state).
    queue_cap: int = 256
    # Per-(index, slice) pending-bit budget between notification
    # batches; past it, affected subscriptions re-evaluate from the
    # authoritative planes instead of applying deltas.
    delta_cap: int = 50_000
    # Notification coalescing window in milliseconds: writes landing
    # within it collapse into one evaluation batch per subscription.
    coalesce_ms: float = 5.0
    # Multi-node refresh cadence in milliseconds: remote writes fire
    # no local listener, so clustered subscriptions re-pull on this
    # interval (also the topology-epoch check cadence).
    refresh_interval_ms: float = 500.0


@dataclass
class IngestConfig:
    """Durable ingest (pilosa_tpu_torch/ingest): per-fragment WAL with group
    commit, crash recovery, and device delta-scatter."""

    # Per-fragment write-ahead log: every changed bit appends a
    # checksummed record BEFORE the write acks, and the ack blocks on
    # the group-commit fsync.  Off restores the historical durability
    # (ops buffered up to 64 KiB, lost on crash).
    wal: bool = True
    # Group-commit window in milliseconds: concurrent writers landing
    # within it share ONE fsync.  Bounds write ack p99 from below at
    # roughly window + fsync time; raise for throughput, lower for
    # latency.
    group_commit_ms: float = 2.0
    # Ops that force an early commit before the window elapses.
    group_commit_max: int = 128
    # Device delta-scatter: point writes apply to the resident device
    # mirror as one tiny fused launch instead of invalidating it (off
    # = invalidate per write, re-staging the whole plane on next read).
    scatter: bool = True
    # WAL segment size that triggers a truncating snapshot (rollover).
    wal_segment_bytes: int = 4 << 20


@dataclass
class ExecConfig:
    """Query-execution scheduler (exec/coalesce.py)."""

    # Cross-query coalescing: concurrent queries whose plans share a
    # compile key ride ONE fused device launch (continuous batching).
    coalesce: bool = True
    # Most queries one coalesced launch may carry.
    coalesce_max_batch: int = 64
    # Optional accumulation backstop in MICROSECONDS: how long an idle
    # dispatcher may linger for same-key company before launching.  0
    # (default) dispatches immediately — accumulation then happens only
    # while a launch is in flight, so a lone query never waits.
    coalesce_max_wait_us: int = 0
    # Plane-major multi-query fusion: DISTINCT concurrent query trees
    # sharing a program key (reduce kind, word geometry, device) lower
    # into one opcode table and evaluate in ONE interpreter pass over
    # the union leaf set (requires coalesce = true to have any effect).
    fuse: bool = True
    # Most distinct expression programs one fused launch may carry;
    # < 2 disables fusion.
    fuse_max_programs: int = 16


@dataclass
class TPUConfig:
    """The JAX package's ``[tpu]`` section (no reference counterpart);
    what each key does in the port is in the module docstring."""

    mesh_shape: str = ""  # e.g. "8" or "4x2"; empty = all local devices
    # No effect in the port (its kernels build once into build/).
    compilation_cache_dir: str = ""
    # Build every kernel and launch each once in the background at
    # server open, so the first queries do not pay the build.
    prewarm: bool = True


@dataclass
class Config:
    data_dir: str = DEFAULT_DATA_DIR
    host: str = DEFAULT_HOST
    log_path: str = ""
    max_writes_per_request: int = DEFAULT_MAX_WRITES
    anti_entropy_interval: int = DEFAULT_ANTI_ENTROPY_INTERVAL
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    net: NetConfig = field(default_factory=NetConfig)
    gossip: GossipConfig = field(default_factory=GossipConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    tier: TierConfig = field(default_factory=TierConfig)
    subscribe: SubscribeConfig = field(default_factory=SubscribeConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    # ``exec`` is a plain identifier in Python 3, so the attribute can
    # match the TOML table name (the dotted env/flag paths rely on it).
    exec: ExecConfig = field(default_factory=ExecConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)

    def validate(self) -> None:
        if self.cluster.type not in CLUSTER_TYPES:
            raise ConfigError(f"invalid cluster type: {self.cluster.type!r}")
        if self.cluster.replicas < 1:
            raise ConfigError("cluster replicas must be >= 1")
        if self.net.stream_chunk_bytes < 0:
            raise ConfigError("net stream-chunk-bytes must be >= 0")
        if self.net.query_timeout_ms < 0:
            raise ConfigError("net query-timeout-ms must be >= 0")
        if self.net.broadcast_timeout_ms <= 0:
            raise ConfigError("net broadcast-timeout-ms must be > 0")
        if self.net.retry_attempts < 1:
            raise ConfigError("net retry-attempts must be >= 1")
        if self.net.retry_backoff_ms < 0:
            raise ConfigError("net retry-backoff-ms must be >= 0")
        if self.net.breaker_failure_threshold < 1:
            raise ConfigError("net breaker-failure-threshold must be >= 1")
        if self.net.breaker_open_ms <= 0:
            raise ConfigError("net breaker-open-ms must be > 0")
        for knob, value in (
            ("admission-point-concurrency", self.net.admission_point_concurrency),
            ("admission-heavy-concurrency", self.net.admission_heavy_concurrency),
            ("admission-write-concurrency", self.net.admission_write_concurrency),
            (
                "admission-internal-concurrency",
                self.net.admission_internal_concurrency,
            ),
            (
                "admission-subscribe-concurrency",
                self.net.admission_subscribe_concurrency,
            ),
        ):
            if value < 1:
                raise ConfigError(f"net {knob} must be >= 1")
        if self.net.admission_queue_depth < 0:
            raise ConfigError("net admission-queue-depth must be >= 0")
        from pilosa_tpu_torch.net.admission import Tenant

        tenant_names = set()
        for spec in self.net.tenants:
            try:
                tenant_names.add(Tenant.parse(str(spec)).name)
            except ValueError as e:
                raise ConfigError(f"net tenants: {e}") from e
        for pair in self.net.tenant_keys:
            key, sep, tname = str(pair).partition(":")
            if not sep or not key or not tname:
                raise ConfigError(
                    f"net tenant-keys entry {pair!r} must be apikey:tenant"
                )
            if tname not in tenant_names and tname != self.net.tenant_default:
                raise ConfigError(
                    f"net tenant-keys entry {pair!r} names an "
                    f"unconfigured tenant"
                )
        if not self.net.tenant_default:
            raise ConfigError("net tenant-default must be non-empty")
        if self.cluster.rebalance_throttle_mbps < 0:
            raise ConfigError("cluster rebalance-throttle-mbps must be >= 0")
        if self.cluster.rebalance_verify_rounds < 1:
            raise ConfigError("cluster rebalance-verify-rounds must be >= 1")
        if self.cluster.rebalance_delta_cap < 1:
            raise ConfigError("cluster rebalance-delta-cap must be >= 1")
        if self.cluster.rebalance_release_delay_ms < 0:
            raise ConfigError("cluster rebalance-release-delay-ms must be >= 0")
        for knob, level in (
            ("write-consistency", self.cluster.write_consistency),
            ("read-consistency", self.cluster.read_consistency),
        ):
            if level not in ("one", "quorum", "all"):
                raise ConfigError(
                    f"cluster {knob} must be one|quorum|all, got {level!r}"
                )
        if self.cluster.hint_cap < 1:
            raise ConfigError("cluster hint-cap must be >= 1")
        if self.cluster.hint_replay_throttle_mbps < 0:
            raise ConfigError(
                "cluster hint-replay-throttle-mbps must be >= 0"
            )
        if self.gossip.ack_timeout_ms <= 0:
            raise ConfigError("gossip ack-timeout-ms must be > 0")
        if self.gossip.stream_timeout_ms <= 0:
            raise ConfigError("gossip stream-timeout-ms must be > 0")
        if self.obs.slow_query_ms < 0:
            raise ConfigError("obs slow-query-ms must be >= 0")
        if self.obs.trace_ring < 1:
            raise ConfigError("obs trace-ring must be >= 1")
        buckets = list(self.obs.latency_buckets_ms)
        if any(b <= 0 for b in buckets):
            raise ConfigError("obs latency-buckets-ms must all be > 0")
        if buckets != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ConfigError(
                "obs latency-buckets-ms must be strictly increasing"
            )
        if self.obs.slo_ms < 0:
            raise ConfigError("obs slo-ms must be >= 0")
        if not (0.0 < self.obs.slo_objective < 1.0):
            raise ConfigError(
                "obs slo-objective must be in (0, 1) exclusive"
            )
        if self.device.mesh_devices < 0:
            raise ConfigError("device mesh-devices must be >= 0")
        if self.device.hbm_budget_bytes < 0:
            raise ConfigError("device hbm-budget-bytes must be >= 0")
        if self.device.stage_throttle_ms < 0:
            raise ConfigError("device stage-throttle-ms must be >= 0")
        if self.device.launch_watchdog_ms < 0:
            raise ConfigError("device launch-watchdog-ms must be >= 0")
        if self.device.quarantine_threshold < 1:
            raise ConfigError("device quarantine-threshold must be >= 1")
        if self.device.quarantine_open_ms <= 0:
            raise ConfigError("device quarantine-open-ms must be > 0")
        if self.device.quarantine_probe_successes < 1:
            raise ConfigError(
                "device quarantine-probe-successes must be >= 1"
            )
        if self.device.plane_format not in ("auto", "dense"):
            raise ConfigError(
                "device plane-format must be 'auto' or 'dense'"
            )
        if self.device.plane_sparse_max_bytes < 0:
            raise ConfigError("device plane-sparse-max-bytes must be >= 0")
        if self.device.plane_rle_max_bytes < 0:
            raise ConfigError("device plane-rle-max-bytes must be >= 0")
        if self.tier.hydrate_throttle_mbps < 0:
            raise ConfigError("tier hydrate-throttle-mbps must be >= 0")
        if self.tier.disk_budget_bytes < 0:
            raise ConfigError("tier disk-budget-bytes must be >= 0")
        if self.tier.retention_age_s < 0:
            raise ConfigError("tier retention-age-s must be >= 0")
        if self.tier.retention_delete_s < 0:
            raise ConfigError("tier retention-delete-s must be >= 0")
        if (
            self.tier.retention_age_s > 0
            and self.tier.retention_delete_s > 0
            and self.tier.retention_delete_s < self.tier.retention_age_s
        ):
            raise ConfigError(
                "tier retention-delete-s must be >= retention-age-s"
            )
        if self.tier.sweep_interval_s <= 0:
            raise ConfigError("tier sweep-interval-s must be > 0")
        if self.tier.retention_delete_s > 0 and not self.tier.store:
            raise ConfigError(
                "tier retention-delete-s requires a configured tier store"
            )
        if self.subscribe.max_subscriptions < 1:
            raise ConfigError("subscribe max-subscriptions must be >= 1")
        if self.subscribe.queue_cap < 1:
            raise ConfigError("subscribe queue-cap must be >= 1")
        if self.subscribe.delta_cap < 1:
            raise ConfigError("subscribe delta-cap must be >= 1")
        if self.subscribe.coalesce_ms < 0:
            raise ConfigError("subscribe coalesce-ms must be >= 0")
        if self.subscribe.refresh_interval_ms <= 0:
            raise ConfigError("subscribe refresh-interval-ms must be > 0")
        if self.ingest.group_commit_ms < 0:
            raise ConfigError("ingest group-commit-ms must be >= 0")
        if self.ingest.group_commit_max < 1:
            raise ConfigError("ingest group-commit-max must be >= 1")
        if self.ingest.wal_segment_bytes < 1:
            raise ConfigError("ingest wal-segment-bytes must be >= 1")
        if self.exec.coalesce_max_batch < 1:
            raise ConfigError("exec coalesce-max-batch must be >= 1")
        if self.exec.coalesce_max_wait_us < 0:
            raise ConfigError("exec coalesce-max-wait-us must be >= 0")
        if self.exec.fuse_max_programs < 1:
            raise ConfigError("exec fuse-max-programs must be >= 1")

    def to_toml(self) -> str:
        """Canonical TOML rendering (generate-config parity,
        reference: ctl/generate_config.go)."""
        lines = [
            f'data-dir = "{self.data_dir}"',
            f'host = "{self.host}"',
            f'log-path = "{self.log_path}"',
            f"max-writes-per-request = {self.max_writes_per_request}",
            "",
            "[cluster]",
            f"  replicas = {self.cluster.replicas}",
            f'  type = "{self.cluster.type}"',
            f"  hosts = {_toml_list(self.cluster.hosts)}",
            f"  internal-hosts = {_toml_list(self.cluster.internal_hosts)}",
            f"  polling-interval = {self.cluster.polling_interval}",
            f"  internal-port = {self.cluster.internal_port}",
            f'  gossip-seed = "{self.cluster.gossip_seed}"',
            f"  long-query-time = {self.cluster.long_query_time}",
            f"  rebalance-throttle-mbps = {self.cluster.rebalance_throttle_mbps}",
            f"  rebalance-verify-rounds = {self.cluster.rebalance_verify_rounds}",
            f"  rebalance-delta-cap = {self.cluster.rebalance_delta_cap}",
            f"  rebalance-release-delay-ms = {self.cluster.rebalance_release_delay_ms}",
            f"  rebalance-on-join = {str(self.cluster.rebalance_on_join).lower()}",
            f'  write-consistency = "{self.cluster.write_consistency}"',
            f'  read-consistency = "{self.cluster.read_consistency}"',
            f"  hint-cap = {self.cluster.hint_cap}",
            f"  hint-replay-throttle-mbps = {self.cluster.hint_replay_throttle_mbps}",
            "",
            "[anti-entropy]",
            f"  interval = {self.anti_entropy_interval}",
            "",
            "[metrics]",
            f'  service = "{self.metrics.service}"',
            f'  host = "{self.metrics.host}"',
            "",
            "[obs]",
            f"  slow-query-ms = {self.obs.slow_query_ms}",
            f"  trace-ring = {self.obs.trace_ring}",
            "  latency-buckets-ms = ["
            + ", ".join(str(float(b)) for b in self.obs.latency_buckets_ms)
            + "]",
            f"  slo-ms = {self.obs.slo_ms}",
            f"  slo-objective = {self.obs.slo_objective}",
            f"  floor-probe = {str(self.obs.floor_probe).lower()}",
            "",
            "[net]",
            f"  stream-chunk-bytes = {self.net.stream_chunk_bytes}",
            f"  query-timeout-ms = {self.net.query_timeout_ms}",
            f"  broadcast-timeout-ms = {self.net.broadcast_timeout_ms}",
            f"  retry-attempts = {self.net.retry_attempts}",
            f"  retry-backoff-ms = {self.net.retry_backoff_ms}",
            f"  breaker-failure-threshold = {self.net.breaker_failure_threshold}",
            f"  breaker-open-ms = {self.net.breaker_open_ms}",
            f"  admission = {str(self.net.admission).lower()}",
            f"  admission-point-concurrency = {self.net.admission_point_concurrency}",
            f"  admission-heavy-concurrency = {self.net.admission_heavy_concurrency}",
            f"  admission-write-concurrency = {self.net.admission_write_concurrency}",
            f"  admission-internal-concurrency = {self.net.admission_internal_concurrency}",
            f"  admission-queue-depth = {self.net.admission_queue_depth}",
            f"  admission-subscribe-concurrency = {self.net.admission_subscribe_concurrency}",
            "  tenants = ["
            + ", ".join(f'"{t}"' for t in self.net.tenants)
            + "]",
            "  tenant-keys = ["
            + ", ".join(f'"{k}"' for k in self.net.tenant_keys)
            + "]",
            f'  tenant-default = "{self.net.tenant_default}"',
            f'  tenant-internal-token = "{self.net.tenant_internal_token}"',
            "",
            "[gossip]",
            f"  ack-timeout-ms = {self.gossip.ack_timeout_ms}",
            f"  stream-timeout-ms = {self.gossip.stream_timeout_ms}",
            "",
            "[device]",
            f"  mesh-devices = {self.device.mesh_devices}",
            f"  hbm-budget-bytes = {self.device.hbm_budget_bytes}",
            f"  prefetch = {str(self.device.prefetch).lower()}",
            f"  stage = {str(self.device.stage).lower()}",
            f"  stage-throttle-ms = {self.device.stage_throttle_ms}",
            f"  launch-watchdog-ms = {self.device.launch_watchdog_ms}",
            f"  quarantine-threshold = {self.device.quarantine_threshold}",
            f"  quarantine-open-ms = {self.device.quarantine_open_ms}",
            f"  quarantine-probe-successes = {self.device.quarantine_probe_successes}",
            f'  plane-format = "{self.device.plane_format}"',
            f"  plane-sparse-max-bytes = {self.device.plane_sparse_max_bytes}",
            f"  plane-rle-max-bytes = {self.device.plane_rle_max_bytes}",
            "",
            "[tier]",
            f'  store = "{self.tier.store}"',
            f"  hydrate-throttle-mbps = {self.tier.hydrate_throttle_mbps}",
            f"  disk-budget-bytes = {self.tier.disk_budget_bytes}",
            f"  retention-age-s = {self.tier.retention_age_s}",
            f"  retention-delete-s = {self.tier.retention_delete_s}",
            f"  sweep-interval-s = {self.tier.sweep_interval_s}",
            "",
            "[subscribe]",
            f"  enabled = {str(self.subscribe.enabled).lower()}",
            f"  max-subscriptions = {self.subscribe.max_subscriptions}",
            f"  queue-cap = {self.subscribe.queue_cap}",
            f"  delta-cap = {self.subscribe.delta_cap}",
            f"  coalesce-ms = {self.subscribe.coalesce_ms}",
            f"  refresh-interval-ms = {self.subscribe.refresh_interval_ms}",
            "",
            "[ingest]",
            f"  wal = {str(self.ingest.wal).lower()}",
            f"  group-commit-ms = {self.ingest.group_commit_ms}",
            f"  group-commit-max = {self.ingest.group_commit_max}",
            f"  scatter = {str(self.ingest.scatter).lower()}",
            f"  wal-segment-bytes = {self.ingest.wal_segment_bytes}",
            "",
            "[exec]",
            f"  coalesce = {str(self.exec.coalesce).lower()}",
            f"  coalesce-max-batch = {self.exec.coalesce_max_batch}",
            f"  coalesce-max-wait-us = {self.exec.coalesce_max_wait_us}",
            f"  fuse = {str(self.exec.fuse).lower()}",
            f"  fuse-max-programs = {self.exec.fuse_max_programs}",
            "",
            "[tpu]",
            f'  mesh-shape = "{self.tpu.mesh_shape}"',
            f'  compilation-cache-dir = "{self.tpu.compilation_cache_dir}"',
            f"  prewarm = {str(self.tpu.prewarm).lower()}",
        ]
        return "\n".join(lines) + "\n"


def _toml_list(items: list[str]) -> str:
    return "[" + ", ".join(f'"{i}"' for i in items) + "]"


def _reject_unknown(doc: dict, prefix: str = "") -> None:
    for key, value in doc.items():
        dotted = f"{prefix}{key}"
        if dotted not in _KNOWN_KEYS:
            raise ConfigError(f"unknown config key: {dotted!r}")
        if isinstance(value, dict):
            _reject_unknown(value, prefix=dotted + ".")


def from_toml(text: str) -> Config:
    try:
        doc = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise ConfigError(str(e)) from e
    _reject_unknown(doc)
    cfg = Config()
    cfg.data_dir = doc.get("data-dir", cfg.data_dir)
    cfg.host = doc.get("host", cfg.host)
    cfg.log_path = doc.get("log-path", cfg.log_path)
    cfg.max_writes_per_request = doc.get(
        "max-writes-per-request", cfg.max_writes_per_request
    )
    cl = doc.get("cluster", {})
    cfg.cluster.replicas = cl.get("replicas", cfg.cluster.replicas)
    cfg.cluster.type = cl.get("type", cfg.cluster.type)
    cfg.cluster.hosts = list(cl.get("hosts", cfg.cluster.hosts))
    cfg.cluster.internal_hosts = list(
        cl.get("internal-hosts", cfg.cluster.internal_hosts)
    )
    cfg.cluster.polling_interval = cl.get(
        "polling-interval", cfg.cluster.polling_interval
    )
    cfg.cluster.internal_port = cl.get("internal-port", cfg.cluster.internal_port)
    cfg.cluster.gossip_seed = cl.get("gossip-seed", cfg.cluster.gossip_seed)
    cfg.cluster.long_query_time = cl.get(
        "long-query-time", cfg.cluster.long_query_time
    )
    cfg.cluster.rebalance_throttle_mbps = float(
        cl.get("rebalance-throttle-mbps", cfg.cluster.rebalance_throttle_mbps)
    )
    cfg.cluster.rebalance_verify_rounds = cl.get(
        "rebalance-verify-rounds", cfg.cluster.rebalance_verify_rounds
    )
    cfg.cluster.rebalance_delta_cap = cl.get(
        "rebalance-delta-cap", cfg.cluster.rebalance_delta_cap
    )
    cfg.cluster.rebalance_release_delay_ms = float(
        cl.get(
            "rebalance-release-delay-ms",
            cfg.cluster.rebalance_release_delay_ms,
        )
    )
    cfg.cluster.rebalance_on_join = cl.get(
        "rebalance-on-join", cfg.cluster.rebalance_on_join
    )
    cfg.cluster.write_consistency = cl.get(
        "write-consistency", cfg.cluster.write_consistency
    )
    cfg.cluster.read_consistency = cl.get(
        "read-consistency", cfg.cluster.read_consistency
    )
    cfg.cluster.hint_cap = cl.get("hint-cap", cfg.cluster.hint_cap)
    cfg.cluster.hint_replay_throttle_mbps = float(
        cl.get(
            "hint-replay-throttle-mbps",
            cfg.cluster.hint_replay_throttle_mbps,
        )
    )
    ae = doc.get("anti-entropy", {})
    cfg.anti_entropy_interval = ae.get("interval", cfg.anti_entropy_interval)
    mt = doc.get("metrics", {})
    cfg.metrics.service = mt.get("service", cfg.metrics.service)
    cfg.metrics.host = mt.get("host", cfg.metrics.host)
    ob = doc.get("obs", {})
    cfg.obs.slow_query_ms = float(ob.get("slow-query-ms", cfg.obs.slow_query_ms))
    cfg.obs.trace_ring = ob.get("trace-ring", cfg.obs.trace_ring)
    cfg.obs.latency_buckets_ms = [
        float(b)
        for b in ob.get("latency-buckets-ms", cfg.obs.latency_buckets_ms)
    ]
    cfg.obs.slo_ms = float(ob.get("slo-ms", cfg.obs.slo_ms))
    cfg.obs.slo_objective = float(
        ob.get("slo-objective", cfg.obs.slo_objective)
    )
    cfg.obs.floor_probe = ob.get("floor-probe", cfg.obs.floor_probe)
    nt = doc.get("net", {})
    cfg.net.stream_chunk_bytes = nt.get(
        "stream-chunk-bytes", cfg.net.stream_chunk_bytes
    )
    cfg.net.query_timeout_ms = float(
        nt.get("query-timeout-ms", cfg.net.query_timeout_ms)
    )
    cfg.net.broadcast_timeout_ms = float(
        nt.get("broadcast-timeout-ms", cfg.net.broadcast_timeout_ms)
    )
    cfg.net.retry_attempts = nt.get("retry-attempts", cfg.net.retry_attempts)
    cfg.net.retry_backoff_ms = float(
        nt.get("retry-backoff-ms", cfg.net.retry_backoff_ms)
    )
    cfg.net.breaker_failure_threshold = nt.get(
        "breaker-failure-threshold", cfg.net.breaker_failure_threshold
    )
    cfg.net.breaker_open_ms = float(
        nt.get("breaker-open-ms", cfg.net.breaker_open_ms)
    )
    cfg.net.admission = nt.get("admission", cfg.net.admission)
    cfg.net.admission_point_concurrency = nt.get(
        "admission-point-concurrency", cfg.net.admission_point_concurrency
    )
    cfg.net.admission_heavy_concurrency = nt.get(
        "admission-heavy-concurrency", cfg.net.admission_heavy_concurrency
    )
    cfg.net.admission_write_concurrency = nt.get(
        "admission-write-concurrency", cfg.net.admission_write_concurrency
    )
    cfg.net.admission_internal_concurrency = nt.get(
        "admission-internal-concurrency",
        cfg.net.admission_internal_concurrency,
    )
    cfg.net.admission_queue_depth = nt.get(
        "admission-queue-depth", cfg.net.admission_queue_depth
    )
    cfg.net.admission_subscribe_concurrency = nt.get(
        "admission-subscribe-concurrency",
        cfg.net.admission_subscribe_concurrency,
    )
    cfg.net.tenants = [str(t) for t in nt.get("tenants", cfg.net.tenants)]
    cfg.net.tenant_keys = [
        str(k) for k in nt.get("tenant-keys", cfg.net.tenant_keys)
    ]
    cfg.net.tenant_default = nt.get("tenant-default", cfg.net.tenant_default)
    cfg.net.tenant_internal_token = nt.get(
        "tenant-internal-token", cfg.net.tenant_internal_token
    )
    sb = doc.get("subscribe", {})
    cfg.subscribe.enabled = sb.get("enabled", cfg.subscribe.enabled)
    cfg.subscribe.max_subscriptions = sb.get(
        "max-subscriptions", cfg.subscribe.max_subscriptions
    )
    cfg.subscribe.queue_cap = sb.get("queue-cap", cfg.subscribe.queue_cap)
    cfg.subscribe.delta_cap = sb.get("delta-cap", cfg.subscribe.delta_cap)
    cfg.subscribe.coalesce_ms = float(
        sb.get("coalesce-ms", cfg.subscribe.coalesce_ms)
    )
    cfg.subscribe.refresh_interval_ms = float(
        sb.get("refresh-interval-ms", cfg.subscribe.refresh_interval_ms)
    )
    ig = doc.get("ingest", {})
    cfg.ingest.wal = ig.get("wal", cfg.ingest.wal)
    cfg.ingest.group_commit_ms = float(
        ig.get("group-commit-ms", cfg.ingest.group_commit_ms)
    )
    cfg.ingest.group_commit_max = ig.get(
        "group-commit-max", cfg.ingest.group_commit_max
    )
    cfg.ingest.scatter = ig.get("scatter", cfg.ingest.scatter)
    cfg.ingest.wal_segment_bytes = ig.get(
        "wal-segment-bytes", cfg.ingest.wal_segment_bytes
    )
    gs = doc.get("gossip", {})
    cfg.gossip.ack_timeout_ms = float(
        gs.get("ack-timeout-ms", cfg.gossip.ack_timeout_ms)
    )
    cfg.gossip.stream_timeout_ms = float(
        gs.get("stream-timeout-ms", cfg.gossip.stream_timeout_ms)
    )
    dv = doc.get("device", {})
    cfg.device.mesh_devices = dv.get("mesh-devices", cfg.device.mesh_devices)
    cfg.device.hbm_budget_bytes = dv.get(
        "hbm-budget-bytes", cfg.device.hbm_budget_bytes
    )
    cfg.device.prefetch = dv.get("prefetch", cfg.device.prefetch)
    cfg.device.stage = dv.get("stage", cfg.device.stage)
    cfg.device.stage_throttle_ms = float(
        dv.get("stage-throttle-ms", cfg.device.stage_throttle_ms)
    )
    cfg.device.launch_watchdog_ms = float(
        dv.get("launch-watchdog-ms", cfg.device.launch_watchdog_ms)
    )
    cfg.device.quarantine_threshold = dv.get(
        "quarantine-threshold", cfg.device.quarantine_threshold
    )
    cfg.device.quarantine_open_ms = float(
        dv.get("quarantine-open-ms", cfg.device.quarantine_open_ms)
    )
    cfg.device.plane_format = dv.get("plane-format", cfg.device.plane_format)
    cfg.device.plane_sparse_max_bytes = dv.get(
        "plane-sparse-max-bytes", cfg.device.plane_sparse_max_bytes
    )
    cfg.device.plane_rle_max_bytes = dv.get(
        "plane-rle-max-bytes", cfg.device.plane_rle_max_bytes
    )
    cfg.device.quarantine_probe_successes = dv.get(
        "quarantine-probe-successes", cfg.device.quarantine_probe_successes
    )
    tr = doc.get("tier", {})
    cfg.tier.store = tr.get("store", cfg.tier.store)
    cfg.tier.hydrate_throttle_mbps = float(
        tr.get("hydrate-throttle-mbps", cfg.tier.hydrate_throttle_mbps)
    )
    cfg.tier.disk_budget_bytes = tr.get(
        "disk-budget-bytes", cfg.tier.disk_budget_bytes
    )
    cfg.tier.retention_age_s = float(
        tr.get("retention-age-s", cfg.tier.retention_age_s)
    )
    cfg.tier.retention_delete_s = float(
        tr.get("retention-delete-s", cfg.tier.retention_delete_s)
    )
    cfg.tier.sweep_interval_s = float(
        tr.get("sweep-interval-s", cfg.tier.sweep_interval_s)
    )
    xc = doc.get("exec", {})
    cfg.exec.coalesce = xc.get("coalesce", cfg.exec.coalesce)
    cfg.exec.coalesce_max_batch = xc.get(
        "coalesce-max-batch", cfg.exec.coalesce_max_batch
    )
    cfg.exec.coalesce_max_wait_us = xc.get(
        "coalesce-max-wait-us", cfg.exec.coalesce_max_wait_us
    )
    cfg.exec.fuse = xc.get("fuse", cfg.exec.fuse)
    cfg.exec.fuse_max_programs = xc.get(
        "fuse-max-programs", cfg.exec.fuse_max_programs
    )
    tp = doc.get("tpu", {})
    cfg.tpu.mesh_shape = tp.get("mesh-shape", cfg.tpu.mesh_shape)
    cfg.tpu.compilation_cache_dir = tp.get(
        "compilation-cache-dir", cfg.tpu.compilation_cache_dir
    )
    cfg.tpu.prewarm = tp.get("prewarm", cfg.tpu.prewarm)
    return cfg


_ENV_MAP = {
    "PILOSA_DATA_DIR": ("data_dir", str),
    "PILOSA_HOST": ("host", str),
    "PILOSA_LOG_PATH": ("log_path", str),
    "PILOSA_MAX_WRITES_PER_REQUEST": ("max_writes_per_request", int),
    "PILOSA_CLUSTER_REPLICAS": ("cluster.replicas", int),
    "PILOSA_CLUSTER_TYPE": ("cluster.type", str),
    "PILOSA_CLUSTER_HOSTS": ("cluster.hosts", "csv"),
    "PILOSA_CLUSTER_INTERNAL_HOSTS": ("cluster.internal_hosts", "csv"),
    "PILOSA_CLUSTER_POLLING_INTERVAL": ("cluster.polling_interval", int),
    "PILOSA_CLUSTER_INTERNAL_PORT": ("cluster.internal_port", int),
    "PILOSA_CLUSTER_GOSSIP_SEED": ("cluster.gossip_seed", str),
    "PILOSA_CLUSTER_LONG_QUERY_TIME": ("cluster.long_query_time", float),
    "PILOSA_CLUSTER_REBALANCE_THROTTLE_MBPS": (
        "cluster.rebalance_throttle_mbps",
        float,
    ),
    "PILOSA_CLUSTER_REBALANCE_VERIFY_ROUNDS": (
        "cluster.rebalance_verify_rounds",
        int,
    ),
    "PILOSA_CLUSTER_REBALANCE_DELTA_CAP": ("cluster.rebalance_delta_cap", int),
    "PILOSA_CLUSTER_REBALANCE_RELEASE_DELAY_MS": (
        "cluster.rebalance_release_delay_ms",
        float,
    ),
    "PILOSA_CLUSTER_REBALANCE_ON_JOIN": ("cluster.rebalance_on_join", "bool"),
    "PILOSA_CLUSTER_WRITE_CONSISTENCY": ("cluster.write_consistency", str),
    "PILOSA_CLUSTER_READ_CONSISTENCY": ("cluster.read_consistency", str),
    "PILOSA_CLUSTER_HINT_CAP": ("cluster.hint_cap", int),
    "PILOSA_CLUSTER_HINT_REPLAY_THROTTLE_MBPS": (
        "cluster.hint_replay_throttle_mbps",
        float,
    ),
    "PILOSA_ANTI_ENTROPY_INTERVAL": ("anti_entropy_interval", int),
    "PILOSA_METRICS_SERVICE": ("metrics.service", str),
    "PILOSA_METRICS_HOST": ("metrics.host", str),
    "PILOSA_OBS_SLOW_QUERY_MS": ("obs.slow_query_ms", float),
    "PILOSA_OBS_TRACE_RING": ("obs.trace_ring", int),
    "PILOSA_OBS_LATENCY_BUCKETS_MS": (
        "obs.latency_buckets_ms",
        lambda raw: [float(s) for s in raw.split(",") if s.strip()],
    ),
    "PILOSA_OBS_SLO_MS": ("obs.slo_ms", float),
    "PILOSA_OBS_SLO_OBJECTIVE": ("obs.slo_objective", float),
    "PILOSA_OBS_FLOOR_PROBE": ("obs.floor_probe", "bool"),
    "PILOSA_NET_STREAM_CHUNK_BYTES": ("net.stream_chunk_bytes", int),
    "PILOSA_NET_QUERY_TIMEOUT_MS": ("net.query_timeout_ms", float),
    "PILOSA_NET_BROADCAST_TIMEOUT_MS": ("net.broadcast_timeout_ms", float),
    "PILOSA_NET_RETRY_ATTEMPTS": ("net.retry_attempts", int),
    "PILOSA_NET_RETRY_BACKOFF_MS": ("net.retry_backoff_ms", float),
    "PILOSA_NET_BREAKER_FAILURE_THRESHOLD": (
        "net.breaker_failure_threshold",
        int,
    ),
    "PILOSA_NET_BREAKER_OPEN_MS": ("net.breaker_open_ms", float),
    "PILOSA_NET_ADMISSION": ("net.admission", "bool"),
    "PILOSA_NET_ADMISSION_POINT_CONCURRENCY": (
        "net.admission_point_concurrency",
        int,
    ),
    "PILOSA_NET_ADMISSION_HEAVY_CONCURRENCY": (
        "net.admission_heavy_concurrency",
        int,
    ),
    "PILOSA_NET_ADMISSION_WRITE_CONCURRENCY": (
        "net.admission_write_concurrency",
        int,
    ),
    "PILOSA_NET_ADMISSION_INTERNAL_CONCURRENCY": (
        "net.admission_internal_concurrency",
        int,
    ),
    "PILOSA_NET_ADMISSION_QUEUE_DEPTH": ("net.admission_queue_depth", int),
    "PILOSA_NET_ADMISSION_SUBSCRIBE_CONCURRENCY": (
        "net.admission_subscribe_concurrency",
        int,
    ),
    "PILOSA_NET_TENANTS": (
        "net.tenants",
        lambda raw: [s.strip() for s in raw.split(",") if s.strip()],
    ),
    "PILOSA_NET_TENANT_KEYS": (
        "net.tenant_keys",
        lambda raw: [s.strip() for s in raw.split(",") if s.strip()],
    ),
    "PILOSA_NET_TENANT_DEFAULT": ("net.tenant_default", str),
    "PILOSA_NET_TENANT_INTERNAL_TOKEN": (
        "net.tenant_internal_token",
        str,
    ),
    "PILOSA_SUBSCRIBE_ENABLED": ("subscribe.enabled", "bool"),
    "PILOSA_SUBSCRIBE_MAX_SUBSCRIPTIONS": (
        "subscribe.max_subscriptions",
        int,
    ),
    "PILOSA_SUBSCRIBE_QUEUE_CAP": ("subscribe.queue_cap", int),
    "PILOSA_SUBSCRIBE_DELTA_CAP": ("subscribe.delta_cap", int),
    "PILOSA_SUBSCRIBE_COALESCE_MS": ("subscribe.coalesce_ms", float),
    "PILOSA_SUBSCRIBE_REFRESH_INTERVAL_MS": (
        "subscribe.refresh_interval_ms",
        float,
    ),
    "PILOSA_INGEST_WAL": ("ingest.wal", "bool"),
    "PILOSA_INGEST_GROUP_COMMIT_MS": ("ingest.group_commit_ms", float),
    "PILOSA_INGEST_GROUP_COMMIT_MAX": ("ingest.group_commit_max", int),
    "PILOSA_INGEST_SCATTER": ("ingest.scatter", "bool"),
    "PILOSA_INGEST_WAL_SEGMENT_BYTES": ("ingest.wal_segment_bytes", int),
    "PILOSA_GOSSIP_ACK_TIMEOUT_MS": ("gossip.ack_timeout_ms", float),
    "PILOSA_GOSSIP_STREAM_TIMEOUT_MS": ("gossip.stream_timeout_ms", float),
    "PILOSA_DEVICE_MESH_DEVICES": ("device.mesh_devices", int),
    "PILOSA_DEVICE_HBM_BUDGET_BYTES": ("device.hbm_budget_bytes", int),
    "PILOSA_DEVICE_PREFETCH": ("device.prefetch", "bool"),
    "PILOSA_DEVICE_STAGE": ("device.stage", "bool"),
    "PILOSA_DEVICE_STAGE_THROTTLE_MS": ("device.stage_throttle_ms", float),
    "PILOSA_DEVICE_LAUNCH_WATCHDOG_MS": ("device.launch_watchdog_ms", float),
    "PILOSA_DEVICE_QUARANTINE_THRESHOLD": (
        "device.quarantine_threshold",
        int,
    ),
    "PILOSA_DEVICE_QUARANTINE_OPEN_MS": ("device.quarantine_open_ms", float),
    "PILOSA_DEVICE_PLANE_FORMAT": ("device.plane_format", str),
    "PILOSA_DEVICE_PLANE_SPARSE_MAX_BYTES": (
        "device.plane_sparse_max_bytes",
        int,
    ),
    "PILOSA_DEVICE_PLANE_RLE_MAX_BYTES": ("device.plane_rle_max_bytes", int),
    "PILOSA_DEVICE_QUARANTINE_PROBE_SUCCESSES": (
        "device.quarantine_probe_successes",
        int,
    ),
    "PILOSA_TIER_STORE": ("tier.store", str),
    "PILOSA_TIER_HYDRATE_THROTTLE_MBPS": ("tier.hydrate_throttle_mbps", float),
    "PILOSA_TIER_DISK_BUDGET_BYTES": ("tier.disk_budget_bytes", int),
    "PILOSA_TIER_RETENTION_AGE_S": ("tier.retention_age_s", float),
    "PILOSA_TIER_RETENTION_DELETE_S": ("tier.retention_delete_s", float),
    "PILOSA_TIER_SWEEP_INTERVAL_S": ("tier.sweep_interval_s", float),
    "PILOSA_EXEC_COALESCE": ("exec.coalesce", "bool"),
    "PILOSA_EXEC_COALESCE_MAX_BATCH": ("exec.coalesce_max_batch", int),
    "PILOSA_EXEC_COALESCE_MAX_WAIT_US": ("exec.coalesce_max_wait_us", int),
    "PILOSA_EXEC_FUSE": ("exec.fuse", "bool"),
    "PILOSA_EXEC_FUSE_MAX_PROGRAMS": ("exec.fuse_max_programs", int),
    "PILOSA_TPU_MESH_SHAPE": ("tpu.mesh_shape", str),
    "PILOSA_TPU_COMPILATION_CACHE_DIR": ("tpu.compilation_cache_dir", str),
    "PILOSA_TPU_PREWARM": ("tpu.prewarm", "bool"),
}


def _set_dotted(cfg: Config, dotted: str, value) -> None:
    obj = cfg
    *parents, leaf = dotted.split(".")
    for p in parents:
        obj = getattr(obj, p)
    setattr(obj, leaf, value)


def apply_env(cfg: Config, environ=None) -> Config:
    """PILOSA_* environment overlay (reference: cmd/root.go:85-112 uses
    viper's PILOSA prefix)."""
    environ = environ if environ is not None else os.environ
    for env_key, (dotted, typ) in _ENV_MAP.items():
        raw = environ.get(env_key)
        if raw is None:
            continue
        if typ == "csv":
            value = [s.strip() for s in raw.split(",") if s.strip()]
        elif typ == "bool":
            value = raw.lower() in ("1", "true", "yes", "on")
        else:
            value = typ(raw)
        _set_dotted(cfg, dotted, value)
    return cfg


def load(path: str | None = None, environ=None, overrides: dict | None = None) -> Config:
    """flag > env > file > default."""
    if path:
        with open(path, "rb") as f:
            cfg = from_toml(f.read().decode())
    else:
        cfg = Config()
    apply_env(cfg, environ)
    for dotted, value in (overrides or {}).items():
        if value is not None:
            _set_dotted(cfg, dotted, value)
    cfg.validate()
    return cfg
