#!/usr/bin/env python3
"""The served Count path of one tree on one CUDA card, for A/B runs of the
observability's cost.

    python3 tools/torch_obs_ab.py [--tree DIR] [--label NAME] [--stats expvar|none]

Imports ``pilosa_tpu_torch`` from ``DIR`` (default: this checkout), so
that one call on the card can serve two versions in turns (A, B, B, A).
Opens a ``Server(device="cuda")`` over ``chip_smoke.py``'s phase-5 index
(954 slices x 8 seeded random rows, loaded with ``convert.load_planes``),
then: 20 serial Count(Intersect(Bitmap(0), Bitmap(1))) hits (p50 of the
HTTP round trip), and a storm of 64 client threads x 10 requests drawn
from the 16 phase-14 trees as Count over every slice, with coalescing on
(requests/s, p50, p99).  With ``--stats expvar`` (where the tree's
``Server`` takes ``stats``) the node keeps an Expvar stats client, as
``chip_smoke.py``'s phase-5 node does.  Prints one JSON line: the card's
name and power limit, the tree, the label and the numbers.  Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIAL = 20
THREADS = 64
REQUESTS = 10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="change")
    ap.add_argument("--stats", default="none", choices=("expvar", "none"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_obs_ab: no CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.net.server import Server

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    kw = {}
    if args.stats == "expvar" and "stats" in inspect.signature(Server).parameters:
        from pilosa_tpu_torch.obs.stats import ExpvarStatsClient

        kw["stats"] = ExpvarStatsClient()
    out = {"card": cs.card_line(), "tree": tree, "label": args.label,
           "stats": "expvar" if kw else "none"}
    with tempfile.TemporaryDirectory(prefix="pilosa-obs-ab-") as data_dir:
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda", **kw)
        srv.open()
        try:
            rng = np.random.default_rng(cs.SEED)
            planes = rng.integers(0, 2**32, size=(cs.N_SLICES, cs.ROWS, 32768), dtype=np.uint32)
            convert.load_planes(srv.holder, "i", "f", "standard",
                                {s: planes[s] for s in range(cs.N_SLICES)})
            torch.cuda.synchronize()
            h = srv.host
            q = "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))"
            want = int(np.bitwise_count(planes[:, 0] & planes[:, 1]).sum())
            lat = []
            for k in range(1 + SERIAL):
                t0 = time.perf_counter()
                status, body = cs.http(h, "POST", "/index/i/query", q.encode())
                if k:
                    lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200 or body["results"] != [want]:
                    raise AssertionError(f"{q}: {status} {body} != {want}")
            out["serial_hit_p50_ms"] = statistics.median(lat)
            queries = []
            for e in cs.storm_exprs():
                pql = f"Count({cs.expr_pql(e)})"
                n = int(np.bitwise_count(cs.expr_np(e, planes)).sum())
                status, body = cs.http(h, "POST", "/index/i/query", pql.encode())
                if status != 200 or body["results"] != [n]:
                    raise AssertionError(f"{pql}: {status} {body} != {n}")
                queries.append((pql, n))
            reqs = [[queries[int(i)] for i in rng.integers(0, len(queries), REQUESTS)]
                    for _ in range(THREADS)]
            start = threading.Barrier(THREADS)

            def client(rs):
                start.wait(timeout=600)
                times = []
                for pql, n in rs:
                    t0 = time.perf_counter()
                    status, body = cs.http(h, "POST", "/index/i/query", pql.encode())
                    times.append((time.perf_counter() - t0) * 1e3)
                    if status != 200 or body["results"] != [n]:
                        raise AssertionError(f"storm {pql}: {status}")
                return times

            t0 = time.perf_counter()
            with ThreadPoolExecutor(THREADS) as pool:
                storm = sorted(x for f in [pool.submit(client, r) for r in reqs]
                               for x in f.result(timeout=1200))
            wall = time.perf_counter() - t0
            out["storm"] = {"requests": len(storm), "rps": len(storm) / wall,
                            "p50_ms": storm[len(storm) // 2],
                            "p99_ms": storm[int(len(storm) * 0.99)]}
        finally:
            srv.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
