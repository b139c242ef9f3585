"""CLI entry point (reference: cmd/).

    python -m pilosa_tpu_torch.cli server --data-dir D --bind H:P [--device cuda]

runs one node until SIGINT/SIGTERM.  The device defaults to the CUDA
card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from pilosa_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pilosa_tpu_torch")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("server", help="run a node")
    srv.add_argument("--data-dir", default=os.path.expanduser("~/.pilosa"))
    srv.add_argument("--bind", default="127.0.0.1:10101")
    srv.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    return p


def run_server(args) -> int:
    from pilosa_tpu_torch.net.server import Server

    srv = Server(args.data_dir, host=args.bind, device=args.device)
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


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "server":
        return run_server(args)
    return 2
