"""CLI entry point (reference: cmd/).

    python -m pilosa_tpu_torch.cli server --data-dir D --bind H:P [--device cuda]
        [--mesh-devices N]
        [--cluster-type static|http|gossip --hosts H1:P1,H2:P2 [--internal-hosts ...]
         --replicas N --internal-port P --polling-interval S]
        [--gossip-seed IP:PORT --gossip-bind IP:PORT --gossip-ack-timeout-ms MS
         --gossip-stream-timeout-ms MS]
        [--tier-store URL --tier-hydrate-throttle-mbps F --tier-disk-budget-bytes N
         --tier-retention-age-s S --tier-retention-delete-s S --tier-sweep-interval-s S]
        [--subscribe true|false --subscribe-max-subscriptions N --subscribe-queue-cap N
         --subscribe-delta-cap N --subscribe-coalesce-ms MS --subscribe-refresh-ms MS]
        [--plane-format auto|dense] [--hbm-budget-bytes N] [--prefetch true|false]
        [--wal true|false --group-commit-ms MS --group-commit-max N
         --wal-segment-bytes N]
        [--coalesce true|false --coalesce-max-batch N --coalesce-max-wait-us US
         --fuse true|false --fuse-max-programs N] [--prewarm true|false]
        [--metrics-service nop|expvar|statsd --metrics-host H:P]
        [--slow-query-ms MS --trace-ring N --latency-buckets-ms 1,5,10
         --slo-ms MS --slo-objective F --floor-probe true|false]
        [--anti-entropy-interval S --query-timeout-ms MS --broadcast-timeout-ms MS
         --retry-attempts N --retry-backoff-ms MS --breaker-failure-threshold N
         --breaker-open-ms MS --write-consistency one|quorum|all
         --read-consistency one|quorum|all --hint-cap N
         --hint-replay-throttle-mbps F --rebalance-throttle-mbps F
         --rebalance-verify-rounds N --rebalance-delta-cap N
         --rebalance-release-delay-ms MS]

runs one node until SIGINT/SIGTERM.  The device defaults to the CUDA
card; ``--device cpu`` runs on the CPU.  On a host with several cards
the node shards its slices over all of them (slice ``s`` on card ``s mod
n``); ``--mesh-devices N`` (the JAX package's ``[device] mesh-devices``,
else ``$PILOSA_DEVICE_MESH_DEVICES``) caps them, 1 forcing one card.  A
launcher that sets ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID`` joins the node to a ``torch.distributed`` process
group before it opens (``parallel/multihost.py``).  The last flags name the JAX
package's ``[device]``, ``[ingest]`` and ``[exec]`` keys
(``plane-format``, ``hbm-budget-bytes``, ``prefetch``, ``wal``,
``group-commit-ms``, ``group-commit-max``, ``wal-segment-bytes``,
``coalesce``, ``coalesce-max-batch``, ``coalesce-max-wait-us``,
``fuse``, ``fuse-max-programs``), ``[tpu] prewarm``, ``[metrics]
service`` / ``host`` and the ``[obs]`` keys (``slow-query-ms``,
``trace-ring``, ``latency-buckets-ms``, ``slo-ms``, ``slo-objective``,
``floor-probe``), and the ``[net]`` / ``[cluster]`` keys of replica
agreement (``anti-entropy-interval``, ``query-timeout-ms``,
``broadcast-timeout-ms``, ``retry-attempts``, ``retry-backoff-ms``,
``breaker-failure-threshold``, ``breaker-open-ms``,
``write-consistency``, ``read-consistency``, ``hint-cap``,
``hint-replay-throttle-mbps`` and the ``rebalance-*`` keys), the
``[tier]``, ``[gossip]`` and ``[subscribe]`` keys (``--tier-*``,
``--gossip-*`` with ``[cluster] gossip-seed``, ``--subscribe*``), with
their defaults.  (The configuration file itself waits for the port of
``config.py``.)  ``--metrics-service expvar``
fills ``/debug/vars`` and ``/metrics``; ``statsd`` sends dogstatsd
datagrams to ``--metrics-host`` (default 127.0.0.1:8125).

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
``error: ...`` and exits 1.  Not ported yet: ``warm``, ``config`` and
``generate-config`` (they wait for ``config.py``).
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("server", help="run a node")
    srv.add_argument("--data-dir", default=os.path.expanduser("~/.pilosa"))
    srv.add_argument("--bind", default="127.0.0.1:10101")
    srv.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    srv.add_argument("--mesh-devices", type=int, default=0,
                     help="cards the slices shard over (0: all visible, 1: one card)")
    srv.add_argument("--cluster-type", default="static",
                     help="static (default), http or gossip")
    srv.add_argument("--hosts", type=_hosts, default=[], help="H:P,H:P,... of every node")
    srv.add_argument(
        "--internal-hosts", type=_hosts, default=None,
        help="internal listeners of the hosts, in order (default: each host with "
        "--internal-port)",
    )
    srv.add_argument("--replicas", type=int, default=1)
    srv.add_argument("--internal-port", type=int, default=14000)
    srv.add_argument("--polling-interval", type=float, default=60.0)
    srv.add_argument("--plane-format", default="auto", choices=("auto", "dense"),
                     help="the sparse tier's container policy")
    srv.add_argument("--hbm-budget-bytes", type=int, default=0,
                     help="device-memory budget of the residency pool (0: "
                     "$PILOSA_DEVICE_HBM_BUDGET_BYTES, else 0.8 of the card)")
    srv.add_argument("--prefetch", type=_bool, default=True,
                     help="upload a query's cold mirrors in the background")
    srv.add_argument("--wal", type=_bool, default=True,
                     help="answer writes after their WAL fsync")
    srv.add_argument("--group-commit-ms", type=float, default=2.0)
    srv.add_argument("--group-commit-max", type=int, default=128)
    srv.add_argument("--wal-segment-bytes", type=int, default=4 << 20)
    # The JAX package's [exec] settings and [tpu] prewarm.
    srv.add_argument("--coalesce", type=_bool, default=True,
                     help="give concurrent Count/Bitmap queries one launch")
    srv.add_argument("--coalesce-max-batch", type=int, default=64,
                     help="queries at most in one coalesced launch")
    srv.add_argument("--coalesce-max-wait-us", type=int, default=0,
                     help="wait at most this long for company before a launch")
    srv.add_argument("--fuse", type=_bool, default=True,
                     help="run a mix of distinct trees in one interpreter launch")
    srv.add_argument("--fuse-max-programs", type=int, default=16,
                     help="distinct trees at most in one interpreter launch")
    srv.add_argument("--prewarm", type=_bool, default=False,
                     help="build every kernel and launch each once at open")
    # The JAX package's [metrics] and [obs] settings.
    srv.add_argument("--metrics-service", default="nop", choices=("nop", "expvar", "statsd"),
                     help="stats client: nop (default), expvar, statsd")
    srv.add_argument("--metrics-host", default="", help="statsd host:port")
    srv.add_argument("--slow-query-ms", type=float, default=0.0,
                     help="log one structured line per query slower than this (0: off)")
    srv.add_argument("--trace-ring", type=int, default=64,
                     help="finished query traces kept for /debug/traces")
    srv.add_argument("--latency-buckets-ms", type=_floats, default=None,
                     help="upper bounds of the /metrics latency histograms, ms")
    srv.add_argument("--slo-ms", type=float, default=0.0,
                     help="query-latency SLO; > 0 adds the SLO burn gauges")
    srv.add_argument("--slo-objective", type=float, default=0.999)
    srv.add_argument("--floor-probe", type=_bool, default=True,
                     help="measure the stream floor of /debug/perf at open")
    srv.add_argument("--stream-chunk-bytes", type=int, default=0,
                     help="write size of streamed bodies (0: 64 KiB)")
    # The JAX package's [net] and [cluster] settings of replica agreement.
    srv.add_argument("--anti-entropy-interval", type=float, default=600.0,
                     help="seconds between anti-entropy sweeps")
    srv.add_argument("--query-timeout-ms", type=float, default=60_000.0,
                     help="a query's default deadline (0: none)")
    srv.add_argument("--broadcast-timeout-ms", type=float, default=5_000.0,
                     help="socket timeout of the max-slice poll")
    srv.add_argument("--retry-attempts", type=int, default=3,
                     help="tries of an idempotent call to a peer")
    srv.add_argument("--retry-backoff-ms", type=float, default=100.0)
    srv.add_argument("--breaker-failure-threshold", type=int, default=5,
                     help="consecutive failures that open a peer's breaker")
    srv.add_argument("--breaker-open-ms", type=float, default=10_000.0,
                     help="time an open breaker waits before its half-open probe")
    srv.add_argument("--write-consistency", default="quorum",
                     choices=("one", "quorum", "all"), help="acknowledgements a write needs")
    srv.add_argument("--read-consistency", default="one",
                     choices=("one", "quorum", "all"),
                     help="replicas whose versions a read checks")
    srv.add_argument("--hint-cap", type=int, default=10_000,
                     help="bits of hints kept per replica and slice")
    srv.add_argument("--hint-replay-throttle-mbps", type=float, default=0.0)
    srv.add_argument("--rebalance-throttle-mbps", type=float, default=0.0)
    srv.add_argument("--rebalance-verify-rounds", type=int, default=3)
    srv.add_argument("--rebalance-delta-cap", type=int, default=50_000)
    srv.add_argument("--rebalance-release-delay-ms", type=float, default=200.0)
    srv.add_argument("--rebalance-on-join", type=_bool, default=False,
                     help="admit hosts gossip announces by a resize")
    # The JAX package's [cluster] gossip-seed and [gossip] keys.
    srv.add_argument("--gossip-seed", default="", help="gossip address (IP:PORT) to join through")
    srv.add_argument("--gossip-bind", default="",
                     help="UDP listener (default all interfaces on the HTTP port + 1000)")
    srv.add_argument("--gossip-ack-timeout-ms", type=float, default=250.0)
    srv.add_argument("--gossip-stream-timeout-ms", type=float, default=10_000.0)
    # The JAX package's [tier] keys.
    srv.add_argument("--tier-store", default="",
                     help="cold-tier object store (http://H:P, file:///path or a path)")
    srv.add_argument("--tier-hydrate-throttle-mbps", type=float, default=0.0)
    srv.add_argument("--tier-disk-budget-bytes", type=int, default=0)
    srv.add_argument("--tier-retention-age-s", type=float, default=0.0)
    srv.add_argument("--tier-retention-delete-s", type=float, default=0.0)
    srv.add_argument("--tier-sweep-interval-s", type=float, default=60.0)
    # The JAX package's [subscribe] keys.
    srv.add_argument("--subscribe", type=_bool, default=True, help="serve standing queries")
    srv.add_argument("--subscribe-max-subscriptions", type=int, default=10_000)
    srv.add_argument("--subscribe-queue-cap", type=int, default=256)
    srv.add_argument("--subscribe-delta-cap", type=int, default=50_000)
    srv.add_argument("--subscribe-coalesce-ms", type=float, default=5.0)
    srv.add_argument("--subscribe-refresh-ms", type=float, default=500.0)
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


def run_server(args) -> int:
    from pilosa_tpu_torch.net.server import Server
    from pilosa_tpu_torch.obs.stats import new_stats_client

    srv = Server(
        args.data_dir,
        host=args.bind,
        device=args.device,
        cluster_type=args.cluster_type,
        hosts=args.hosts,
        internal_hosts=args.internal_hosts,
        replicas=args.replicas,
        internal_port=args.internal_port,
        polling_interval=args.polling_interval,
        plane_format=args.plane_format,
        hbm_budget_bytes=args.hbm_budget_bytes,
        device_prefetch=args.prefetch,
        ingest_wal=args.wal,
        ingest_group_commit_ms=args.group_commit_ms,
        ingest_group_commit_max=args.group_commit_max,
        ingest_wal_segment_bytes=args.wal_segment_bytes,
        coalesce=args.coalesce,
        coalesce_max_batch=args.coalesce_max_batch,
        coalesce_max_wait_us=args.coalesce_max_wait_us,
        fuse=args.fuse,
        fuse_max_programs=args.fuse_max_programs,
        prewarm=args.prewarm,
        stats=new_stats_client(args.metrics_service, args.metrics_host),
        slow_query_ms=args.slow_query_ms,
        trace_ring=args.trace_ring,
        latency_buckets_ms=args.latency_buckets_ms,
        slo_ms=args.slo_ms,
        slo_objective=args.slo_objective,
        floor_probe=args.floor_probe,
        stream_chunk_bytes=args.stream_chunk_bytes,
        mesh_devices=args.mesh_devices,
        anti_entropy_interval=args.anti_entropy_interval,
        query_timeout_ms=args.query_timeout_ms,
        broadcast_timeout_ms=args.broadcast_timeout_ms,
        retry_attempts=args.retry_attempts,
        retry_backoff_ms=args.retry_backoff_ms,
        breaker_failure_threshold=args.breaker_failure_threshold,
        breaker_open_ms=args.breaker_open_ms,
        write_consistency=args.write_consistency,
        read_consistency=args.read_consistency,
        hint_cap=args.hint_cap,
        hint_replay_throttle_mbps=args.hint_replay_throttle_mbps,
        rebalance_throttle_mbps=args.rebalance_throttle_mbps,
        rebalance_verify_rounds=args.rebalance_verify_rounds,
        rebalance_delta_cap=args.rebalance_delta_cap,
        rebalance_release_delay_ms=args.rebalance_release_delay_ms,
        rebalance_on_join=args.rebalance_on_join,
        gossip_seed=args.gossip_seed,
        gossip_bind=args.gossip_bind,
        gossip_ack_timeout_ms=args.gossip_ack_timeout_ms,
        gossip_stream_timeout_ms=args.gossip_stream_timeout_ms,
        tier_store=args.tier_store,
        tier_hydrate_throttle_mbps=args.tier_hydrate_throttle_mbps,
        tier_disk_budget_bytes=args.tier_disk_budget_bytes,
        tier_retention_age_s=args.tier_retention_age_s,
        tier_retention_delete_s=args.tier_retention_delete_s,
        tier_sweep_interval_s=args.tier_sweep_interval_s,
        subscribe_enabled=args.subscribe,
        subscribe_max_subscriptions=args.subscribe_max_subscriptions,
        subscribe_queue_cap=args.subscribe_queue_cap,
        subscribe_delta_cap=args.subscribe_delta_cap,
        subscribe_coalesce_ms=args.subscribe_coalesce_ms,
        subscribe_refresh_ms=args.subscribe_refresh_ms,
    )
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    # Join a multi-host process group when the launcher configured one
    # (JAX ``cli/ctl.py:203-208``); it waits until every peer connects.
    from pilosa_tpu_torch.parallel import multihost

    multihost.initialize()
    srv.open()
    print(f"pilosa_tpu_torch listening on http://{srv.host} ({srv.device})", file=sys.stderr)
    try:
        stop.wait()
    finally:
        srv.close()
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
    if args.cmd == "server":
        return run_server(args)
    from pilosa_tpu_torch.net.client import ClientError

    try:
        return COMMANDS[args.cmd](args)
    except (CommandError, ClientError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130
