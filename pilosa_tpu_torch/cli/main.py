"""CLI entry point (reference: cmd/).

    python -m pilosa_tpu_torch.cli server --data-dir D --bind H:P [--device cuda]
        [--cluster-type static|http --hosts H1:P1,H2:P2 [--internal-hosts ...]
         --replicas N --internal-port P --polling-interval S]
        [--plane-format auto|dense] [--hbm-budget-bytes N] [--prefetch true|false]
        [--wal true|false --group-commit-ms MS --group-commit-max N
         --wal-segment-bytes N]

runs one node until SIGINT/SIGTERM.  The device defaults to the CUDA
card; ``--device cpu`` runs on the CPU.  The last flags name the JAX
package's ``[device]`` and ``[ingest]`` keys (``plane-format``,
``hbm-budget-bytes``, ``prefetch``, ``wal``, ``group-commit-ms``,
``group-commit-max``, ``wal-segment-bytes``) with their defaults.

    python -m pilosa_tpu_torch.cli import --host H:P -i INDEX -f FRAME FILE.csv ...

reads ``row,col[,timestamp]`` records (timestamps as
``YYYY-MM-DDTHH:MM``, UTC) and sends them to the owners of each slice
through ``/import`` (the counterpart of ``pilosa_tpu/cli/ctl.py:400-500``).
With ``--field NAME`` the records are ``column,value`` (signed integers)
for the frame's BSI field, sent through ``/import-value`` (the JAX CLI's
``--value``, ``pilosa_tpu/cli/ctl.py:334-390``).
"""

from __future__ import annotations

import argparse
import csv
import os
import signal
import sys
import threading
from datetime import datetime, timezone

import numpy as np

from pilosa_tpu_torch import __version__
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("server", help="run a node")
    srv.add_argument("--data-dir", default=os.path.expanduser("~/.pilosa"))
    srv.add_argument("--bind", default="127.0.0.1:10101")
    srv.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    srv.add_argument("--cluster-type", default="static", help="static (default) or http")
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
    return p


def run_server(args) -> int:
    from pilosa_tpu_torch.net.server import Server

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
    )
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
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


def run_import(args) -> int:
    from pilosa_tpu_torch.net.client import InternalClient

    client = InternalClient(args.host)
    read, send = (read_values, _send_values) if args.field else (read_bits, _send)
    for path in args.paths:
        with (open(path, newline="") if path != "-" else sys.stdin) as f:
            buf: list[tuple] = []
            for record in read(f):
                buf.append(record)
                if len(buf) >= args.buffer_size:
                    send(client, args, buf)
                    buf.clear()
            send(client, args, buf)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "server":
        return run_server(args)
    if args.cmd == "import":
        from pilosa_tpu_torch.net.client import ClientError

        try:
            return run_import(args)
        except (CommandError, ClientError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    return 2
