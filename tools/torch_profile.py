#!/usr/bin/env python3
"""Where a served query's time goes on the CUDA card (pilosa_tpu_torch).

    python3 tools/torch_profile.py [--out chiprun_out/torch_profile]

Starts ``Server(device="cuda")`` with chip_smoke.py's index (954 slices x
8 dense rows of seeded random words, 1B columns), warms each query, then
records ``torch.profiler`` over ``REPS`` HTTP requests of each query
class and prints, per class, one JSON line: the host wall time per
request, the device busy time per request (the union of kernel, memcpy
and memset intervals in the trace), the device idle share, and the
kernels by total device time.  The Chrome traces go under ``--out``.
Device numbers come only from the trace; when it holds no device
activity the line says so instead of printing a number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QUERIES = {
    "count_intersect": "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))",
    "count_union3": "Count(Union(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1), "
    "Bitmap(frame=f, rowID=2)))",
    "topn": "TopN(frame=f, n=5)",
    "topn_src": "TopN(Bitmap(frame=f, rowID=0), frame=f, n=5)",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REPS = 5


def device_busy_us(trace_path: str) -> tuple[float, dict[str, list[float]]]:
    """(union of device activity intervals in us, {kernel: [total us, n]})
    from a Chrome trace written by torch.profiler."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = []
    by_kernel: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((ts, ts + dur))
        if ev["cat"] == "kernel":
            agg = by_kernel.setdefault(ev["name"][:80], [0.0, 0])
            agg[0] += dur
            agg[1] += 1
    busy = 0.0
    end = float("-inf")
    for s, e in sorted(spans):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, by_kernel


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "torch_profile"))
    args = ap.parse_args(argv)

    from chip_smoke import N_SLICES, ROWS, SEED, card_line, http
    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.net.server import Server

    print(card_line(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-profile-") as data_dir:
        srv = Server(data_dir, device="cuda")
        srv.open()
        try:
            for path in ("/index/i", "/index/i/frame/f"):
                http(srv.host, "POST", path)
            planes = rng.integers(0, 2**32, size=(N_SLICES, ROWS, 32768), dtype=np.uint32)
            convert.load_planes(
                srv.holder, "i", "f", "standard", {s: planes[s] for s in range(N_SLICES)}
            )
            del planes
            activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            for name, pql in QUERIES.items():
                for _ in range(2):  # warm-up
                    http(srv.host, "POST", "/index/i/query", pql.encode())
                torch.cuda.synchronize()
                walls = []
                with profile(activities=activities) as prof:
                    for _ in range(REPS):
                        t0 = time.perf_counter()
                        status, _ = http(srv.host, "POST", "/index/i/query", pql.encode())
                        walls.append(time.perf_counter() - t0)
                        if status != 200:
                            raise RuntimeError(f"{name}: HTTP {status}")
                trace = os.path.join(args.out, f"{name}.json")
                prof.export_chrome_trace(trace)
                busy_us, kernels = device_busy_us(trace)
                wall_ms = 1e3 * sum(walls) / len(walls)
                line = {
                    "query": name,
                    "slices": N_SLICES,
                    "reps": REPS,
                    "wall_ms_per_request": wall_ms,
                    "wall_ms_p50": 1e3 * float(np.median(walls)),
                }
                if busy_us > 0:
                    busy_ms = busy_us / 1e3 / REPS
                    line["device_busy_ms_per_request"] = busy_ms
                    line["device_idle_share"] = 1.0 - busy_ms / wall_ms
                    line["kernels"] = {
                        k: {"us_per_request": v[0] / REPS, "launches_per_request": v[1] / REPS}
                        for k, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
                    }
                else:
                    line["device_busy_ms_per_request"] = "not measured (no device activity in the trace)"
                print(json.dumps(line), flush=True)
        finally:
            srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
