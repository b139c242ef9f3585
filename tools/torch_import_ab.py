#!/usr/bin/env python3
"""Import costs of the PyTorch/CUDA port on one CUDA card, for A/B runs.

    python3 tools/torch_import_ab.py [--tree DIR] [--label NAME]

Imports ``pilosa_tpu_torch`` from ``DIR`` (default: this checkout), so
that one call on the card can time two versions in turns (A, B, B, A),
and runs on one node on the card, from a fixed seed:

1. the main path's index: 954 slices x 8 rows of random words (1B
   columns), read once so that every mirror is resident, then one
   protobuf ``/import`` of 2^20 bits (one request a slice), then the
   first ``Count(Bitmap)`` after it;
2. a tall fragment: 65,536 plane rows of one bit each (an 8 GiB plane
   tier, as at the default dense budget), read once, then
   ``TALL_IMPORTS`` ``/import`` requests of 5,000 bits each into it, each
   timed, and the first ``Count`` after them.

Prints one JSON line: the card's name and power limit, the tree, the
times, and the fused-popcount (K1) and delta-scatter (K7) launches of
each import and first read.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SLICES = 954
ROWS = 8
IMPORT_BITS = 1 << 20
TALL_ROWS = 1 << 16
TALL_IMPORTS = 4
TALL_BITS = 5000


def count(host: str, index: str, row: int) -> tuple[int, float]:
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://{host}/index/{index}/query", method="POST",
                                 data=f"Count(Bitmap(frame=f, rowID={row}))".encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        n = json.loads(resp.read())["results"][0]
    return n, (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_import_ab: no CUDA card", file=sys.stderr)
        return 1
    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.net.client import InternalClient
    from pilosa_tpu_torch.net.server import Server
    from pilosa_tpu_torch.ops import _build
    from pilosa_tpu_torch.ops import delta_scatter as ds
    from pilosa_tpu_torch.ops import fused_popcount as fp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    rng = np.random.default_rng(7)
    out: dict = {"card": card, "tree": args.label or args.tree}
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-ab-") as data_dir:
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda")
        srv.open()
        try:
            client = InternalClient(srv.host, timeout=600)
            planes = rng.integers(0, 2**32, size=(N_SLICES, ROWS, 32768), dtype=np.uint32)
            convert.load_planes(srv.holder, "i", "f", "standard",
                                {s: planes[s] for s in range(N_SLICES)})
            count(srv.host, "i", 0)
            rows = rng.integers(0, ROWS, IMPORT_BITS)
            cols = rng.integers(0, N_SLICES << 20, IMPORT_BITS)
            fp.launches = ds.launches = 0
            t0 = time.perf_counter()
            client.import_bits("i", "f", rows, cols)
            torch.cuda.synchronize()
            out["import_s"] = time.perf_counter() - t0
            out["import_launches"] = {"k1": fp.launches, "k7": ds.launches}
            fp.launches = ds.launches = 0
            _, out["first_count_ms"] = count(srv.host, "i", 0)
            out["first_count_launches"] = {"k1": fp.launches, "k7": ds.launches}
            out["count_ms"] = sorted(count(srv.host, "i", 0)[1] for _ in range(5))[2]
            del planes

            tall = np.zeros((TALL_ROWS, 32768), dtype=np.uint32)
            tall[np.arange(TALL_ROWS), np.arange(TALL_ROWS) % 32768] = 1
            t0 = time.perf_counter()
            convert.load_planes(srv.holder, "t", "f", "standard", {0: tall})
            out["tall_load_s"] = time.perf_counter() - t0
            del tall
            count(srv.host, "t", 1)
            times, launches = [], []
            for _ in range(TALL_IMPORTS):
                rows = rng.integers(0, TALL_ROWS, TALL_BITS)
                cols = rng.integers(0, 1 << 20, TALL_BITS)
                fp.launches = ds.launches = 0
                t0 = time.perf_counter()
                client.import_bits("t", "f", rows, cols)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                launches.append({"k1": fp.launches, "k7": ds.launches})
            out["tall_import_s"] = times
            out["tall_import_launches"] = launches
            fp.launches = ds.launches = 0
            _, out["tall_first_count_ms"] = count(srv.host, "t", 1)
            out["tall_first_count_launches"] = {"k1": fp.launches, "k7": ds.launches}
        finally:
            srv.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
