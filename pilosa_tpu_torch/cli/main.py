"""CLI entry point (reference: cmd/).

    python -m pilosa_tpu_torch.cli server [-c pilosa.toml] [-d DIR] [--bind H:P]
        [--device cuda|cuda:N|cpu] [--dry-run] [--cpuprofile PATH --cputime S]
        [--gossip-bind IP:PORT] [--<key> VALUE ...]
    python -m pilosa_tpu_torch.cli warm [-c pilosa.toml] [--device cuda]
    python -m pilosa_tpu_torch.cli config [-c pilosa.toml]
    python -m pilosa_tpu_torch.cli generate-config

``server`` runs one node until SIGINT/SIGTERM, both of which run its
close path.  Its settings are the JAX package's configuration
(``config.py``, its own copy here): the TOML file of ``-c``, under the
``PILOSA_*`` environment, under the flags — ``flag > env > file >
default`` (JAX ``config.load``) — so every flag but the port's own
defaults to "not given".  ``-d`` / ``--data-dir`` and ``--bind`` name
``data-dir`` and ``host``; every other flag is one key of the file, named
in its help (``SERVER_FLAGS``: ``--hosts`` is ``[cluster] hosts``,
``--coalesce`` ``[exec] coalesce``, ``--admission-point-concurrency``
``[net] admission-point-concurrency``, ...).  ``build_server`` hands every
key to the ``Server``, except ``[tpu] compilation-cache-dir``: the port
has no compile cache (its kernels build once into ``build/``), so the key
is read, validated and printed, and has no effect; ``[tpu] prewarm``
builds every kernel and launches each once at open, and ``[tpu]
mesh-shape`` caps the data plane's members (``PILOSA_TPU_MESH_SHAPE``).
The port's own flags: ``--device`` (the card unless ``cpu`` is asked
for; the file has no device key) and ``--gossip-bind``.  ``--dry-run``
builds the node and exits 0 before serving; ``--cpuprofile`` writes the
``/debug/pprof/profile`` sampler's folded stacks of the first
``--cputime`` seconds (0: until shutdown) at close.  On a host with
several cards the node shards its slices over all of them (slice ``s`` on
card ``s mod n``); ``[device] mesh-devices`` caps them, 1 forcing one
card.  A launcher that sets ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` joins the node to a
``torch.distributed`` process group before it opens
(``parallel/multihost.py``).

``warm`` builds every kernel and launches each query-path kernel once
(``exec/warmup.prewarm``) and prints the launches and the seconds; the
builds stay in ``build/torch_kernels/`` for every later process.
``config`` validates a file (with the environment) and prints it,
``generate-config`` prints the defaults: both byte for byte the JAX
CLI's text.  A configuration error prints ``error: ...`` and exits 1.

    python -m pilosa_tpu_torch.cli import --host H:P -i INDEX -f FRAME FILE.csv ...

reads ``row,col[,timestamp]`` records (timestamps as
``YYYY-MM-DDTHH:MM``, UTC) and sends them to the owners of each slice
through ``/import`` (the counterpart of ``pilosa_tpu/cli/ctl.py:400-500``).
With ``--field NAME`` the records are ``column,value`` (signed integers)
for the frame's BSI field, sent through ``/import-value`` (the JAX CLI's
``--value``, ``pilosa_tpu/cli/ctl.py:334-390``).

The operator commands of the JAX CLI (``pilosa_tpu/cli/ctl.py:526-841``),
with its flags, output and exit codes:

    export  --host H:P -i INDEX -f FRAME [-v VIEW] [-o FILE]
    backup  --host H:P -i INDEX -f FRAME [-v VIEW] [-o FILE]
    backup  --host H:P -i INDEX --store URL [-f FRAME] [-v VIEW | -v '']
    restore --host H:P -i INDEX -f FRAME [-v VIEW] -d FILE
    restore --host H:P -i INDEX --store URL [-f FRAME] [-v VIEW | -v '']
    check PATH...      inspect PATH...      sort PATH
    bench   --host H:P -i INDEX -f FRAME [-o set-bit|intersect-count|topn] [-n N]
    resize  --host H:P --hosts H1:P1,H2:P2,... [--wait] | --status | --abort

``export`` writes every slice's CSV (each from an owner of the slice);
``backup`` writes a view as a tar of per-slice fragment archives and
``restore`` posts each back; with ``--store`` (``http://host:port``,
``file:///path`` or a path; JAX ``cli/ctl.py:557-647``) ``backup``
uploads ``schema.json`` and every fragment archive of the index (all
frames unless ``-f``, all views with ``-v ''``) in the cold tier's
layout, so a node with only ``tier_store`` set cold-boots from it, and
``restore`` posts every matching archive of the store to the node; ``check`` and ``inspect`` read data files
offline; ``sort`` orders a CSV by slice for import; ``resize`` starts a
live resize to the complete target host list (``POST /cluster/resize``),
prints the migration's state (``--status``), aborts it (``--abort``) or
waits for it (``--wait``, JAX ``cli/ctl.py:768``).  An error prints
``error: ...`` and exits 1.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
import signal
import sys
import threading
import time
from datetime import datetime, timezone

import numpy as np

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch import config as config_mod
from pilosa_tpu_torch.ops import roaring
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH
from pilosa_tpu_torch.pql.parser import TIME_FORMAT


class CommandError(RuntimeError):
    pass


def _hosts(value: str) -> list[str]:
    return [h.strip() for h in value.split(",") if h.strip()]


def _bool(value: str) -> bool:
    v = value.strip().lower()
    if v in ("true", "1", "yes", "on"):
        return True
    if v in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {value!r}")


def _floats(value: str) -> list[float]:
    return [float(v) for v in value.split(",") if v.strip()]


# The server's flags: each overrides one key of the configuration file
# (flag > env > file > default, ``config.load``), so each defaults to None.
SERVER_FLAGS = (
    (("-d", "--data-dir"), "data_dir", str, "data directory"),
    (("--bind",), "host", str, "host:port to bind"),
    (("--mesh-devices",), "device.mesh_devices", int,
     "cards the slices shard over (0: all visible, 1: one card)"),
    (("--cluster-type",), "cluster.type", str, "static, http or gossip"),
    (("--hosts",), "cluster.hosts", _hosts, "H:P,H:P,... of every node"),
    (("--internal-hosts",), "cluster.internal_hosts", _hosts,
     "internal listeners of the hosts, in order (default: each host with --internal-port)"),
    (("--replicas",), "cluster.replicas", int, "owners of each slice"),
    (("--internal-port",), "cluster.internal_port", int, "the internal listener's port"),
    (("--polling-interval",), "cluster.polling_interval", float,
     "seconds between polls of the peers' max slices"),
    (("--long-query-time",), "cluster.long_query_time", float,
     "log the text of queries slower than this many seconds (0: off)"),
    (("--max-writes-per-request",), "max_writes_per_request", int, "writes at most a request"),
    (("--log-path",), "log_path", str, "append the log to this file (default stderr)"),
    (("--plane-format",), "device.plane_format", str, "the sparse tier's policy: auto or dense"),
    (("--hbm-budget-bytes",), "device.hbm_budget_bytes", int,
     "device-memory budget of the residency pool (0: $PILOSA_DEVICE_HBM_BUDGET_BYTES, "
     "else 0.8 of the card)"),
    (("--prefetch",), "device.prefetch", _bool, "upload a query's cold mirrors in the background"),
    (("--wal",), "ingest.wal", _bool, "answer writes after their WAL fsync"),
    (("--group-commit-ms",), "ingest.group_commit_ms", float, "the WAL's group-commit window"),
    (("--group-commit-max",), "ingest.group_commit_max", int, "ops that commit a group early"),
    (("--wal-segment-bytes",), "ingest.wal_segment_bytes", int, "WAL size that rolls a snapshot"),
    (("--coalesce",), "exec.coalesce", _bool,
     "give concurrent Count/Bitmap queries one launch"),
    (("--coalesce-max-batch",), "exec.coalesce_max_batch", int,
     "queries at most in one coalesced launch"),
    (("--coalesce-max-wait-us",), "exec.coalesce_max_wait_us", int,
     "wait at most this long for company before a launch"),
    (("--fuse",), "exec.fuse", _bool, "run a mix of distinct trees in one interpreter launch"),
    (("--fuse-max-programs",), "exec.fuse_max_programs", int,
     "distinct trees at most in one interpreter launch"),
    (("--prewarm",), "tpu.prewarm", _bool, "build every kernel and launch each once at open"),
    (("--metrics-service",), "metrics.service", str, "stats client: nop, expvar or statsd"),
    (("--metrics-host",), "metrics.host", str, "statsd host:port"),
    (("--slow-query-ms",), "obs.slow_query_ms", float,
     "log one structured line per query slower than this (0: off)"),
    (("--trace-ring",), "obs.trace_ring", int, "finished query traces kept for /debug/traces"),
    (("--latency-buckets-ms",), "obs.latency_buckets_ms", _floats,
     "upper bounds of the /metrics latency histograms, ms"),
    (("--slo-ms",), "obs.slo_ms", float, "query-latency SLO; > 0 adds the SLO burn gauges"),
    (("--slo-objective",), "obs.slo_objective", float, "share of queries under the SLO"),
    (("--floor-probe",), "obs.floor_probe", _bool,
     "measure the stream floor of /debug/perf at open"),
    (("--stream-chunk-bytes",), "net.stream_chunk_bytes", int,
     "write size of streamed bodies (0: 64 KiB)"),
    (("--anti-entropy-interval",), "anti_entropy_interval", float,
     "seconds between anti-entropy sweeps"),
    (("--query-timeout-ms",), "net.query_timeout_ms", float, "a query's default deadline (0: none)"),
    (("--broadcast-timeout-ms",), "net.broadcast_timeout_ms", float,
     "socket timeout of the max-slice poll"),
    (("--retry-attempts",), "net.retry_attempts", int, "tries of an idempotent call to a peer"),
    (("--retry-backoff-ms",), "net.retry_backoff_ms", float, "the first retry's backoff"),
    (("--breaker-failure-threshold",), "net.breaker_failure_threshold", int,
     "consecutive failures that open a peer's breaker"),
    (("--breaker-open-ms",), "net.breaker_open_ms", float,
     "time an open breaker waits before its half-open probe"),
    (("--admission",), "net.admission", _bool, "gate requests by cost class (429 when shed)"),
    (("--admission-point-concurrency",), "net.admission_point_concurrency", int,
     "Count/Bitmap queries served at once"),
    (("--admission-heavy-concurrency",), "net.admission_heavy_concurrency", int,
     "TopN/Sum/Min/Max/Range queries served at once"),
    (("--admission-write-concurrency",), "net.admission_write_concurrency", int,
     "writes and imports served at once"),
    (("--admission-internal-concurrency",), "net.admission_internal_concurrency", int,
     "peers' map legs and repairs served at once"),
    (("--admission-subscribe-concurrency",), "net.admission_subscribe_concurrency", int,
     "standing-query evaluations at once"),
    (("--admission-queue-depth",), "net.admission_queue_depth", int,
     "requests a tenant may queue in a client class"),
    (("--tenants",), "net.tenants", _hosts, "name:weight[:qps[:bytes_per_s]],..."),
    (("--tenant-keys",), "net.tenant_keys", _hosts, "apikey:tenant,..."),
    (("--tenant-default",), "net.tenant_default", str, "the tenant of untagged requests"),
    (("--tenant-internal-token",), "net.tenant_internal_token", str,
     "the token that proves the internal lane"),
    (("--write-consistency",), "cluster.write_consistency", str,
     "acknowledgements a write needs: one, quorum or all"),
    (("--read-consistency",), "cluster.read_consistency", str,
     "replicas whose versions a read checks: one, quorum or all"),
    (("--hint-cap",), "cluster.hint_cap", int, "bits of hints kept per replica and slice"),
    (("--hint-replay-throttle-mbps",), "cluster.hint_replay_throttle_mbps", float,
     "the hint replay's rate (0: no limit)"),
    (("--rebalance-throttle-mbps",), "cluster.rebalance_throttle_mbps", float,
     "a resize's copy rate (0: no limit)"),
    (("--rebalance-verify-rounds",), "cluster.rebalance_verify_rounds", int,
     "checksum rounds of a slice's copy"),
    (("--rebalance-delta-cap",), "cluster.rebalance_delta_cap", int,
     "bits a migrating slice's delta log holds"),
    (("--rebalance-release-delay-ms",), "cluster.rebalance_release_delay_ms", float,
     "wait before a moved slice's source drops it"),
    (("--rebalance-on-join",), "cluster.rebalance_on_join", _bool,
     "admit the hosts gossip announces by a resize"),
    (("--gossip-seed",), "cluster.gossip_seed", str, "gossip address (IP:PORT) to join through"),
    (("--gossip-ack-timeout-ms",), "gossip.ack_timeout_ms", float, "the first ACK wait"),
    (("--gossip-stream-timeout-ms",), "gossip.stream_timeout_ms", float,
     "timeout of the state stream over HTTP"),
    (("--tier-store",), "tier.store", str,
     "cold-tier object store (http://H:P, file:///path or a path)"),
    (("--tier-hydrate-throttle-mbps",), "tier.hydrate_throttle_mbps", float,
     "hydration's read rate (0: no limit)"),
    (("--tier-disk-budget-bytes",), "tier.disk_budget_bytes", int,
     "local bytes of hot fragments (0: no budget)"),
    (("--tier-retention-age-s",), "tier.retention_age_s", float,
     "age a time view to the store this long past its quantum (0: never)"),
    (("--tier-retention-delete-s",), "tier.retention_delete_s", float,
     "delete a time view this long past its quantum (0: never)"),
    (("--tier-sweep-interval-s",), "tier.sweep_interval_s", float, "seconds between sweeps"),
    (("--subscribe",), "subscribe.enabled", _bool, "serve standing queries"),
    (("--subscribe-max-subscriptions",), "subscribe.max_subscriptions", int,
     "standing queries at most"),
    (("--subscribe-queue-cap",), "subscribe.queue_cap", int, "updates kept per subscription"),
    (("--subscribe-delta-cap",), "subscribe.delta_cap", int,
     "bits per slice between notifications before a full re-run"),
    (("--subscribe-coalesce-ms",), "subscribe.coalesce_ms", float, "the notify window"),
    (("--subscribe-refresh-ms",), "subscribe.refresh_interval_ms", float,
     "a cluster subscription's re-pull interval"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("server", help="run a node")
    srv.add_argument("-c", "--config", default="", help="TOML config file")
    srv.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    srv.add_argument("--dry-run", action="store_true", help="stop before serving")
    srv.add_argument("--cpuprofile", default="", metavar="PATH",
                     help="write a folded-stack CPU profile of the first --cputime "
                     "seconds to PATH")
    srv.add_argument("--cputime", type=int, default=30, metavar="SECONDS",
                     help="with --cpuprofile: sampling duration (0 = until shutdown)")
    srv.add_argument("--gossip-bind", default="",
                     help="UDP listener (default all interfaces on the HTTP port + 1000)")
    for flags, key, typ, text in SERVER_FLAGS:
        srv.add_argument(*flags, type=typ, default=None, help=f"{text} [{key}]")
    warm = sub.add_parser("warm", help="build every kernel and launch each once")
    warm.add_argument("-c", "--config", default="", help="TOML config file")
    warm.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    cfg = sub.add_parser("config", help="validate and print a config file")
    cfg.add_argument("-c", "--config", default="", help="TOML config file")
    sub.add_parser("generate-config", help="print the default config")
    imp = sub.add_parser("import", help="bulk-import CSV bits (row,col[,timestamp])")
    imp.add_argument("--host", default="localhost:10101", help="host:port of a node")
    imp.add_argument("-i", "--index", required=True)
    imp.add_argument("-f", "--frame", required=True)
    imp.add_argument(
        "-s", "--buffer-size", type=int, default=10_000_000,
        help="records to read before sending them",
    )
    imp.add_argument(
        "--field", default="",
        help="import column,value records into this integer (BSI) field",
    )
    imp.add_argument("paths", nargs="+", help="CSV files ('-' = stdin)")

    def host(sp):
        sp.add_argument("--host", default="localhost:10101", help="host:port of the server")

    sp = sub.add_parser("export", help="export a frame as CSV")
    host(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--frame", required=True)
    sp.add_argument("-v", "--view", default="standard")
    sp.add_argument("-o", "--output-file", default="", help="default stdout")
    sp = sub.add_parser("backup", help="backup a view to a tar archive, or the whole index "
                        "into a tier object store (--store)")
    host(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--frame", default="",
                    help="frame to back up (with --store: default every frame)")
    sp.add_argument("-v", "--view", default="standard",
                    help="view to back up; with --store pass '' for every view")
    sp.add_argument("-o", "--output-file", default="", help="default stdout")
    sp.add_argument("--store", default="", metavar="URL",
                    help="tier object-store target (http://host:port, file:///path or a "
                    "path): schema.json and per-fragment tars in the tier's layout")
    sp = sub.add_parser("restore", help="restore a view from a tar archive, or fragments from "
                        "a tier object store (--store)")
    host(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--frame", default="",
                    help="frame to restore (with --store: default every frame)")
    sp.add_argument("-v", "--view", default="standard",
                    help="view to restore; with --store pass '' for every view")
    sp.add_argument("-d", "--input-file", default="")
    sp.add_argument("--store", default="", metavar="URL",
                    help="tier object-store source (see backup --store)")
    sp = sub.add_parser("check", help="offline consistency check of data files")
    sp.add_argument("paths", nargs="+")
    sp = sub.add_parser("inspect", help="dump container stats of a data file")
    sp.add_argument("paths", nargs="+")
    sp = sub.add_parser("sort", help="sort a CSV file by slice for import")
    sp.add_argument("path", help="CSV file ('-' = stdin)")
    sp = sub.add_parser("bench", help="benchmark operations against a server")
    host(sp)
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-f", "--frame", required=True)
    sp.add_argument("-o", "--operation", default="set-bit",
                    choices=["set-bit", "intersect-count", "topn"],
                    help="set-bit: random writes; intersect-count / topn: one read "
                    "query against existing data")
    sp.add_argument("-n", "--num", type=int, default=0, help="operations to run")
    sp.add_argument("--row1", type=int, default=1, help="intersect-count row A")
    sp.add_argument("--row2", type=int, default=2, help="intersect-count row B")
    sp.add_argument("--topn-n", type=int, default=100, help="topn result size")
    sp = sub.add_parser("resize", help="live cluster resize (--hosts: the complete "
                        "target host list)")
    host(sp)
    sp.add_argument("--hosts", default="", help="comma-separated target host list")
    sp.add_argument("--abort", action="store_true", help="abort the resize in flight")
    sp.add_argument("--status", action="store_true",
                    help="print the /debug/rebalance document and exit")
    sp.add_argument("--wait", action="store_true", help="wait until the migration ends")
    return p


def build_server(cfg: config_mod.Config, device="cuda", **extra):
    """A ``config.Config`` as the port's ``Server`` (JAX ``cli/ctl.py:46-
    178``): every key of the file reaches a keyword, except ``[tpu]
    compilation-cache-dir``, which has no counterpart in the port (its
    kernels build once into ``build/``) and is not passed.  ``device``
    and ``extra`` (``gossip_bind``) are the port's own flags; the file
    has no device key."""
    from pilosa_tpu_torch.net import server as server_mod
    from pilosa_tpu_torch.obs.stats import new_stats_client

    if cfg.tpu.mesh_shape:
        os.environ["PILOSA_TPU_MESH_SHAPE"] = cfg.tpu.mesh_shape
    # The log: log-path, else stderr (reference: server/server.go:125-133).
    if cfg.log_path:
        log_file = open(os.path.expanduser(cfg.log_path), "a", buffering=1)

        def logger(msg: str) -> None:
            log_file.write(msg.rstrip() + "\n")
    else:

        def logger(msg: str) -> None:
            print(msg, file=sys.stderr)

    hosts = list(cfg.cluster.hosts)
    internal_hosts = list(cfg.cluster.internal_hosts) or None
    if internal_hosts is not None and len(internal_hosts) != len(hosts):
        raise config_mod.ConfigError(
            "cluster internal-hosts must name one listener per host, in the hosts' order")
    return server_mod.Server(
        data_dir=os.path.expanduser(cfg.data_dir),
        host=cfg.host,
        device=device,
        max_writes_per_request=cfg.max_writes_per_request,
        cluster_type=cfg.cluster.type,
        hosts=hosts,
        internal_hosts=internal_hosts,
        replicas=cfg.cluster.replicas,
        internal_port=cfg.cluster.internal_port,
        polling_interval=cfg.cluster.polling_interval,
        long_query_time=cfg.cluster.long_query_time,
        gossip_seed=cfg.cluster.gossip_seed,
        rebalance_throttle_mbps=cfg.cluster.rebalance_throttle_mbps,
        rebalance_verify_rounds=cfg.cluster.rebalance_verify_rounds,
        rebalance_delta_cap=cfg.cluster.rebalance_delta_cap,
        rebalance_release_delay_ms=cfg.cluster.rebalance_release_delay_ms,
        rebalance_on_join=cfg.cluster.rebalance_on_join,
        write_consistency=cfg.cluster.write_consistency,
        read_consistency=cfg.cluster.read_consistency,
        hint_cap=cfg.cluster.hint_cap,
        hint_replay_throttle_mbps=cfg.cluster.hint_replay_throttle_mbps,
        anti_entropy_interval=cfg.anti_entropy_interval,
        logger=logger,
        stats=new_stats_client(cfg.metrics.service, cfg.metrics.host),
        slow_query_ms=cfg.obs.slow_query_ms,
        trace_ring=cfg.obs.trace_ring,
        latency_buckets_ms=(cfg.obs.latency_buckets_ms or None),
        slo_ms=cfg.obs.slo_ms,
        slo_objective=cfg.obs.slo_objective,
        floor_probe=cfg.obs.floor_probe,
        stream_chunk_bytes=cfg.net.stream_chunk_bytes,
        query_timeout_ms=cfg.net.query_timeout_ms,
        broadcast_timeout_ms=cfg.net.broadcast_timeout_ms,
        retry_attempts=cfg.net.retry_attempts,
        retry_backoff_ms=cfg.net.retry_backoff_ms,
        breaker_failure_threshold=cfg.net.breaker_failure_threshold,
        breaker_open_ms=cfg.net.breaker_open_ms,
        admission=cfg.net.admission,
        admission_point_concurrency=cfg.net.admission_point_concurrency,
        admission_heavy_concurrency=cfg.net.admission_heavy_concurrency,
        admission_write_concurrency=cfg.net.admission_write_concurrency,
        admission_internal_concurrency=cfg.net.admission_internal_concurrency,
        admission_queue_depth=cfg.net.admission_queue_depth,
        admission_subscribe_concurrency=cfg.net.admission_subscribe_concurrency,
        tenants=cfg.net.tenants,
        tenant_keys=cfg.net.tenant_keys,
        tenant_default=cfg.net.tenant_default,
        tenant_internal_token=cfg.net.tenant_internal_token,
        gossip_ack_timeout_ms=cfg.gossip.ack_timeout_ms,
        gossip_stream_timeout_ms=cfg.gossip.stream_timeout_ms,
        mesh_devices=cfg.device.mesh_devices,
        hbm_budget_bytes=cfg.device.hbm_budget_bytes,
        device_prefetch=cfg.device.prefetch,
        device_stage=cfg.device.stage,
        stage_throttle_ms=cfg.device.stage_throttle_ms,
        launch_watchdog_ms=cfg.device.launch_watchdog_ms,
        quarantine_threshold=cfg.device.quarantine_threshold,
        quarantine_open_ms=cfg.device.quarantine_open_ms,
        quarantine_probe_successes=cfg.device.quarantine_probe_successes,
        plane_format=cfg.device.plane_format,
        plane_sparse_max_bytes=cfg.device.plane_sparse_max_bytes,
        plane_rle_max_bytes=cfg.device.plane_rle_max_bytes,
        tier_store=cfg.tier.store,
        tier_hydrate_throttle_mbps=cfg.tier.hydrate_throttle_mbps,
        tier_disk_budget_bytes=cfg.tier.disk_budget_bytes,
        tier_retention_age_s=cfg.tier.retention_age_s,
        tier_retention_delete_s=cfg.tier.retention_delete_s,
        tier_sweep_interval_s=cfg.tier.sweep_interval_s,
        subscribe_enabled=cfg.subscribe.enabled,
        subscribe_max_subscriptions=cfg.subscribe.max_subscriptions,
        subscribe_queue_cap=cfg.subscribe.queue_cap,
        subscribe_delta_cap=cfg.subscribe.delta_cap,
        subscribe_coalesce_ms=cfg.subscribe.coalesce_ms,
        subscribe_refresh_ms=cfg.subscribe.refresh_interval_ms,
        ingest_wal=cfg.ingest.wal,
        ingest_group_commit_ms=cfg.ingest.group_commit_ms,
        ingest_group_commit_max=cfg.ingest.group_commit_max,
        ingest_scatter=cfg.ingest.scatter,
        ingest_wal_segment_bytes=cfg.ingest.wal_segment_bytes,
        coalesce=cfg.exec.coalesce,
        coalesce_max_batch=cfg.exec.coalesce_max_batch,
        coalesce_max_wait_us=cfg.exec.coalesce_max_wait_us,
        fuse=cfg.exec.fuse,
        fuse_max_programs=cfg.exec.fuse_max_programs,
        prewarm=cfg.tpu.prewarm,
        **extra,
    )


def load_config(args) -> config_mod.Config:
    """The ``server`` command's configuration: its flags over the
    ``PILOSA_*`` environment over the file (``-c``) over the defaults."""
    overrides = {key: getattr(args, flags[-1].lstrip("-").replace("-", "_"))
                 for flags, key, _, _ in SERVER_FLAGS}
    return config_mod.load(args.config or None, overrides=overrides)


def run_server(args) -> int:
    cfg = load_config(args)
    srv = build_server(cfg, device=args.device, gossip_bind=args.gossip_bind)
    if args.dry_run:
        print("dry-run: config ok", file=sys.stderr)
        return 0
    # Join a multi-host process group when the launcher configured one
    # (JAX ``cli/ctl.py:203-208``); it waits until every peer connects.
    from pilosa_tpu_torch.parallel import multihost

    multihost.initialize()
    srv.open()
    print(f"pilosa_tpu_torch listening on http://{srv.host} ({srv.device})", file=sys.stderr)
    stop_profile = _start_cpu_profile(args.cpuprofile, args.cputime)
    # SIGINT and SIGTERM run the close path (listeners, caches, the WAL's
    # last commit, the profile's file) instead of killing the process.
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        # A second signal during the close kills the process instead.
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, signal.SIG_DFL)
        stop_profile()
        srv.close()
    return 0


def _start_cpu_profile(path: str, seconds: int):
    """``--cpuprofile`` / ``--cputime`` (reference: server/server.go:56-57;
    JAX ``cli/ctl.py:238-295``): the ``/debug/pprof/profile`` sampler on a
    daemon thread, its folded stacks written to ``path`` when sampling
    ends (after ``seconds``, or at shutdown for 0).  Returns the call that
    stops it and writes the file (a no-op without ``path``)."""
    if not path:
        return lambda: None
    from pilosa_tpu_torch.net import handler as handler_mod

    stop = threading.Event()
    counts: dict[str, int] = {}  # filled in place by the sampler

    def write() -> None:
        with open(path, "w") as f:
            f.write(handler_mod._fold_counts(dict(counts)))
        print(f"cpu profile written to {path}", file=sys.stderr)

    def run() -> None:
        if seconds > 0:
            handler_mod._sample_cpu_counts(seconds, stop=stop, counts=counts)
        else:
            while not stop.is_set():
                handler_mod._sample_cpu_counts(3600, stop=stop, counts=counts)
        write()

    t = threading.Thread(target=run, daemon=True, name="cpuprofile")
    t.start()

    def finish() -> None:
        stop.set()
        t.join(timeout=30)
        if t.is_alive():
            print("warning: cpu profiler did not stop; writing snapshot", file=sys.stderr)
            try:
                write()
            except OSError as e:  # never abort the close path
                print(f"warning: cpu profile write failed: {e}", file=sys.stderr)

    return finish


def run_warm(args) -> int:
    """Build every kernel and launch each query-path kernel once
    (``exec/warmup.prewarm``), then print how many launches and how long.
    The counterpart of the JAX ``warm``, which filled an XLA compile
    cache: the port's kernels build once into ``build/torch_kernels/``,
    which every later process on the checkout reuses."""
    from pilosa_tpu_torch.exec import warmup

    cfg = config_mod.load(args.config or None)
    if cfg.tpu.mesh_shape:
        os.environ["PILOSA_TPU_MESH_SHAPE"] = cfg.tpu.mesh_shape
    t0 = time.monotonic()
    n = warmup.prewarm(args.device)
    print(f"warmed {n} kernel launches in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    return 0


def run_config(args) -> int:
    """Validate a configuration (file, environment) and print it."""
    sys.stdout.write(config_mod.load(args.config or None).to_toml())
    return 0


def run_generate_config(args) -> int:
    """Print the default configuration."""
    sys.stdout.write(config_mod.Config().to_toml())
    return 0


def read_bits(f):
    """Yield ``(row, col, unix_ns)`` per CSV record (reference:
    ctl/import.go:120-170); a record without a timestamp has 0."""
    for rnum, record in enumerate(csv.reader(f), start=1):
        if not record or record[0] == "":
            continue
        if len(record) < 2:
            raise CommandError(f"bad column count on row {rnum}")
        try:
            row_id = int(record[0])
        except ValueError:
            raise CommandError(f"invalid row id on row {rnum}: {record[0]!r}") from None
        try:
            col_id = int(record[1])
        except ValueError:
            raise CommandError(f"invalid column id on row {rnum}: {record[1]!r}") from None
        ts = 0
        if len(record) > 2 and record[2]:
            try:
                dt = datetime.strptime(record[2], TIME_FORMAT)
            except ValueError:
                raise CommandError(f"invalid timestamp on row {rnum}: {record[2]!r}") from None
            # The wire carries unix nanoseconds (reference: ctl/import.go:157).
            ts = int(dt.replace(tzinfo=timezone.utc).timestamp()) * 1_000_000_000
        yield row_id, col_id, ts


def _send(client, args, buf: list[tuple[int, int, int]]) -> None:
    if not buf:
        return
    a = np.asarray(buf, dtype=object)
    ts = np.asarray(a[:, 2], dtype=np.int64)
    sent = client.import_bits(
        args.index, args.frame, a[:, 0], a[:, 1], ts if ts.any() else None
    )
    for s in sent:
        print(f"imported slice: {s}", file=sys.stderr)


def read_values(f):
    """Yield ``(col, value)`` per CSV record of a field import."""
    for rnum, record in enumerate(csv.reader(f), start=1):
        if not record or record[0] == "":
            continue
        if len(record) < 2:
            raise CommandError(f"bad column count on row {rnum}")
        try:
            col_id = int(record[0])
        except ValueError:
            raise CommandError(f"invalid column id on row {rnum}: {record[0]!r}") from None
        try:
            value = int(record[1])
        except ValueError:
            raise CommandError(f"invalid value on row {rnum}: {record[1]!r}") from None
        yield col_id, value


def _send_values(client, args, buf: list[tuple[int, int]]) -> None:
    if not buf:
        return
    cols, vals = zip(*buf)
    for s in client.import_values(args.index, args.frame, args.field, cols, vals):
        print(f"imported values: slice={s}", file=sys.stderr)


# The native CSV path reads a file in blocks of this many bytes, so memory
# stays bounded whatever the file's size (JAX cli/ctl.py:396).
_CSV_BLOCK = 64 << 20


def _import_native(client, args, path: str) -> bool:
    """Import a plain ``row,col`` file through the native parser, a block
    at a time (split at its last newline), sending ``buffer_size`` records
    at a time as the Python path does; False when the parser is missing
    or refuses a block (timestamps, quoting, anything malformed), and the
    caller reads the file with Python's csv.  Starting over after a part
    was sent is safe: an import sets bits, and setting one twice is a
    no-op (JAX ``cli/ctl.py:404-444``)."""
    from pilosa_tpu_torch import native

    if args.field or path == "-" or not native.available():
        return False
    with open(path, "rb") as fb:
        carry = b""
        while True:
            block = fb.read(_CSV_BLOCK)
            if not block:
                break
            block = carry + block
            cut = block.rfind(b"\n") + 1
            carry, block = (b"", block) if cut == 0 else (block[cut:], block[:cut])
            if not _import_block(client, args, block):
                return False
        if carry and not _import_block(client, args, carry):
            return False
    return True


def _import_block(client, args, block: bytes) -> bool:
    from pilosa_tpu_torch import native

    if not block:
        return True
    parsed = native.parse_csv(block)
    if parsed is None:
        return False
    rows, cols = parsed
    for lo in range(0, len(rows), args.buffer_size):
        hi = lo + args.buffer_size
        for s in client.import_bits(args.index, args.frame, rows[lo:hi], cols[lo:hi]):
            print(f"imported slice: {s}", file=sys.stderr)
    return True


def run_import(args) -> int:
    from pilosa_tpu_torch.net.client import InternalClient

    client = InternalClient(args.host)
    read, send = (read_values, _send_values) if args.field else (read_bits, _send)
    for path in args.paths:
        if _import_native(client, args, path):
            continue
        with (open(path, newline="") if path != "-" else sys.stdin) as f:
            buf: list[tuple] = []
            for record in read(f):
                buf.append(record)
                if len(buf) >= args.buffer_size:
                    send(client, args, buf)
                    buf.clear()
            send(client, args, buf)
    return 0


# --- export, backup, restore (JAX ctl.py:526-644; reference: ctl/export.go,
# backup.go, restore.go) ---


def _client(host: str):
    from pilosa_tpu_torch.net.client import InternalClient

    return InternalClient(host, timeout=60.0)


def _out(args):
    path = args.output_file or ""
    return open(path, "wb") if path else sys.stdout.buffer


def run_export(args) -> int:
    client = _client(args.host)
    w = _out(args)
    try:
        max_slices = client.max_slice_by_index()
        for slice_i in range(max_slices.get(args.index, 0) + 1):
            client.export_to(w, args.index, args.frame, args.view, slice_i)
    finally:
        if w is not sys.stdout.buffer:
            w.close()
    return 0


def run_backup(args) -> int:
    client = _client(args.host)
    if args.store:
        return _backup_to_store(client, args)
    if not args.frame:
        raise CommandError("--frame required (unless backing up --store)")
    w = _out(args)
    try:
        client.backup_to(w, args.index, args.frame, args.view)
    finally:
        if w is not sys.stdout.buffer:
            w.close()
    return 0


def run_restore(args) -> int:
    client = _client(args.host)
    if args.store:
        return _restore_from_store(client, args)
    if not args.input_file:
        raise CommandError("--input-file (or --store) required")
    if not args.frame:
        raise CommandError("--frame required (unless restoring --store)")
    with open(args.input_file, "rb") as r:
        client.restore_from(r, args.index, args.frame, args.view)
    return 0


def _backup_to_store(client, args) -> int:
    """``backup --store URL``: the server's schema and every fragment
    archive of the index into the store, in the tier's layout
    (``schema.json``, ``fragments/<index>/<frame>/<view>/<slice>.tar``),
    so that a node with only ``tier_store`` set cold-boots from it."""
    from pilosa_tpu_torch.tier import fragment_store_key, open_store
    from pilosa_tpu_torch.tier.manager import SCHEMA_KEY

    store = open_store(args.store)
    if store is None:
        raise CommandError("--store must name a store location")
    schema = client.schema()
    store.put(SCHEMA_KEY, json.dumps({"indexes": schema}).encode())
    frames = [args.frame] if args.frame else [
        f["name"] for idx in schema if idx["name"] == args.index for f in idx.get("frames", [])
    ]
    n = 0
    for frame in frames:
        for view in [args.view] if args.view else client.frame_views(args.index, frame):
            max_slices = client.max_slice_by_index(inverse=view.startswith("inverse"))
            for slice_i in range(max_slices.get(args.index, 0) + 1):
                payload = client.backup_slice(args.index, frame, view, slice_i)
                if payload is None:
                    continue
                store.put(fragment_store_key(args.index, frame, view, slice_i), payload)
                n += 1
    print(f"backed up {n} fragment(s) to {store.url}", file=sys.stderr)
    return 0


def _restore_from_store(client, args) -> int:
    """``restore --store URL``: post every matching fragment archive of
    the store to the server, whose restore verifies the archive's
    checksums before it installs anything."""
    import io

    from pilosa_tpu_torch.tier import open_store, parse_fragment_store_key
    from pilosa_tpu_torch.tier.manager import FRAGMENT_PREFIX

    store = open_store(args.store)
    if store is None:
        raise CommandError("--store must name a store location")
    prefix = f"{FRAGMENT_PREFIX}{args.index}/"
    if args.frame:
        prefix += f"{args.frame}/"
        if args.view:
            prefix += f"{args.view}/"
    n = 0
    for meta in store.list(prefix):
        parsed = parse_fragment_store_key(meta.key)
        if parsed is None:
            continue
        index, frame, view, slice_i = parsed
        client.restore_slice_from(index, frame, view, slice_i, io.BytesIO(store.get(meta.key)))
        n += 1
    if n == 0:
        raise CommandError(f"store holds no fragments under {prefix!r}")
    print(f"restored {n} fragment(s) from {store.url}", file=sys.stderr)
    return 0


# --- check, inspect, sort (JAX ctl.py:646-695, 806-824) ---


def _map_or_read(f):
    """The data file mapped read-only (an empty file, which cannot be
    mapped, read)."""
    import mmap

    try:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (ValueError, OSError):
        return f.read()


def run_check(args) -> int:
    """Offline consistency check of roaring data files; ``.cache`` and
    ``.snapshotting`` files are skipped, as the reference does."""
    ok = True
    for path in args.paths:
        if path.endswith(".cache") or path.endswith(".snapshotting"):
            print(f"skipping: {path}", file=sys.stderr)
            continue
        with open(path, "rb") as f:
            data = _map_or_read(f)
        try:
            problems = roaring.check(data)
        except roaring.CorruptError as e:
            problems = [str(e)]
        if problems:
            ok = False
            for p in problems:
                print(f"{path}: {p}")
        else:
            print(f"{path}: ok", file=sys.stderr)
    return 0 if ok else 1


def run_inspect(args) -> int:
    for path in args.paths:
        with open(path, "rb") as f:
            data = _map_or_read(f)
        bi = roaring.info(data)
        print(f"{path}:")
        print(f"  containers: {len(bi.containers)}")
        print(f"  bits: {sum(c.n for c in bi.containers)}")
        print(f"  ops: {bi.ops}")
        for c in bi.containers:
            print(f"  container key={c.key} type={c.type} n={c.n}")
    return 0


def run_sort(args) -> int:
    if args.path == "-":
        rows = list(csv.reader(sys.stdin))
    else:
        with open(args.path, newline="") as f:
            rows = list(csv.reader(f))
    rows = [r for r in rows if r and r[0] != ""]
    try:
        rows.sort(key=lambda r: (int(r[1]) // SLICE_WIDTH, int(r[0]), int(r[1])))
    except (ValueError, IndexError) as e:
        raise CommandError(f"bad csv row: {e}") from e
    csv.writer(sys.stdout).writerows(rows)
    return 0


# --- bench (JAX ctl.py:697-762; reference: ctl/bench.go:52-102) ---


def run_bench(args) -> int:
    client = _client(args.host)
    if args.operation == "set-bit":
        n = args.num
        if n <= 0:
            raise CommandError("--num must be > 0")
        # The reference's random writes: rows in [0, 1000), columns in
        # [0, 100000), 1,000 a request.
        t0 = time.monotonic()
        batch = []
        for _ in range(n):
            row, col = random.randrange(1000), random.randrange(100000)
            batch.append(f'SetBit(frame="{args.frame}", rowID={row}, columnID={col})')
            if len(batch) == 1000:
                client.execute_query(args.index, "\n".join(batch))
                batch.clear()
        if batch:
            client.execute_query(args.index, "\n".join(batch))
        elapsed = time.monotonic() - t0
        print(f"executed {n} operations in {elapsed:.3f}s ({n / elapsed:.0f} op/sec)")
        return 0
    if args.operation == "intersect-count":
        pql = (f'Count(Intersect(Bitmap(frame="{args.frame}", rowID={args.row1}),'
               f' Bitmap(frame="{args.frame}", rowID={args.row2})))')
    else:
        pql = f'TopN(frame="{args.frame}", n={args.topn_n})'
    iters = args.num if args.num > 0 else 20
    result = _first_result(client, args.index, pql)  # warms the caches
    lat = []
    for _ in range(iters):
        t0 = time.monotonic()
        result = _first_result(client, args.index, pql)
        lat.append(time.monotonic() - t0)
    lat.sort()
    p50 = lat[len(lat) // 2]
    p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
    shown = result if isinstance(result, int) else f"{len(result)} pairs"
    print(f"{args.operation}: {iters} queries, p50 {p50 * 1e3:.2f} ms,"
          f" p95 {p95 * 1e3:.2f} ms (result: {shown})")
    return 0


def _first_result(client, index: str, pql: str):
    from pilosa_tpu_torch.net.client import ClientError

    results = client.execute_query(index, pql)
    if not results:
        raise ClientError(200, "empty response")
    return results[0]


def run_resize(args) -> int:
    """A live resize (JAX ``cli/ctl.py:768-812``): ``POST /cluster/resize``
    with the complete target host list, then, with ``--wait``, poll
    ``GET /debug/rebalance`` until the migration ends."""
    client = _client(args.host)

    def status() -> dict:
        st, data = client._request("GET", "/debug/rebalance")
        return json.loads(client._check(st, data))

    if args.status:
        print(json.dumps(status(), indent=2, sort_keys=True))
        return 0
    if args.abort:
        st, data = client._request("POST", "/cluster/resize/abort")
        client._check(st, data)
        print("resize aborted", file=sys.stderr)
        return 0
    hosts = [h.strip() for h in (args.hosts or "").split(",") if h.strip()]
    if not hosts:
        raise CommandError("--hosts required (the complete target host list)")
    st, data = client._request("POST", "/cluster/resize",
                               body=json.dumps({"hosts": hosts}).encode())
    client._check(st, data)
    print(f"resize to {hosts} started", file=sys.stderr)
    if not args.wait:
        print("poll with: pilosa_tpu_torch resize --status", file=sys.stderr)
        return 0
    while True:
        snap = status()
        if not snap.get("running"):
            coord = snap.get("coordinator") or {}
            if coord.get("error") or snap.get("lastError"):
                raise CommandError(
                    f"migration stopped: {coord.get('error') or snap['lastError']}")
            if snap.get("transition") is None:
                print("resize complete", file=sys.stderr)
                return 0
        states = (snap.get("coordinator") or {}).get("sliceStates", {})
        print(f"migrating: {states}", file=sys.stderr)
        time.sleep(1.0)


COMMANDS = {
    "server": run_server,
    "warm": run_warm,
    "config": run_config,
    "generate-config": run_generate_config,
    "import": run_import,
    "export": run_export,
    "backup": run_backup,
    "restore": run_restore,
    "check": run_check,
    "inspect": run_inspect,
    "sort": run_sort,
    "bench": run_bench,
    "resize": run_resize,
}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from pilosa_tpu_torch.net.client import ClientError

    try:
        return COMMANDS[args.cmd](args) or 0
    except (CommandError, config_mod.ConfigError, ClientError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130
