#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pilosa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing its final line:

1. the card's ``name, power.limit`` (nvidia-smi);
2. build every kernel from the sources in this checkout (one nvcc per
   source, started together);
3. hold each kernel against its plain PyTorch version on the card, on
   adversarial and seeded random planes, every op and shape listed —
   the results must be exactly equal (integers);
4. time each kernel at the main path's shape (CUDA events around runs
   of back-to-back calls, median of 21 runs), beside its bound and its
   plain version's time;
5. serve a 1B-column index — 954 slices x 8 dense rows, seeded random
   words, about 1 GiB on the card — with ``Server(device="cuda")`` and
   answer Count/Bitmap/TopN/SetBit over HTTP, every answer checked
   against a numpy oracle over the same planes, with the kernels'
   launch counts reset just before and read just after;
6. print the ``kernels`` JSON line, then the final JSON line.

Exits non-zero when ``torch.cuda.is_available()`` is false, and when the
port's package is not beside this file.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np

SEED = 7
N_SLICES = 954  # ceil(1e9 / 2^20): 1B columns
ROWS = 8
REPS = 5

# Peak rates used for the bound, from NVIDIA's data sheets: device memory
# 3.35 TB/s on an H100 SXM (2.0 on the PCIe part, 3.9 on the NVL part,
# 4.8 on an H200).  The int32 bitwise/popcount/add work is held against
# the 67 TFLOP/s non-tensor float32 rate of an H100 SXM; it is far below
# the byte bound either way.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}
SCALAR_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name:
            return HBM_BYTES_PER_S[key]
    raise RuntimeError(f"no memory rate known for card {name!r}")


def k1_bound_ms(rows: int, with_b: bool, broadcast: bool, hbm: float) -> tuple[float, str]:
    """Least time for one fused popcount over [rows, 32768]: each input
    byte read once, each output written once; 3 int ops per word."""
    row_bytes = 32768 * 4
    nbytes = rows * row_bytes + rows * 4
    if with_b:
        nbytes += row_bytes if broadcast else rows * row_bytes
    t_bytes = nbytes / hbm
    t_ops = rows * 32768 * 3 / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_cuda(fn, runs: int = 21, per_run: int = 10, warmup: int = 3) -> float:
    """Median over ``runs`` of the milliseconds per call of ``fn()``,
    each run timed by CUDA events around ``per_run`` back-to-back calls
    on the current stream: the host enqueues ahead of the device, so the
    number is the device's time per call rather than the host's
    dispatch gap between calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def adversarial_planes(rows: int) -> tuple[np.ndarray, np.ndarray]:
    """uint32 [rows, 32768] pairs cycling through all-zero, all-ones,
    sign-bit-only words and a single bit at word 32767."""
    pats = []
    for kind in range(4):
        p = np.zeros(32768, dtype=np.uint32)
        if kind == 1:
            p[:] = 0xFFFFFFFF
        elif kind == 2:
            p[:] = 0x80000000
        elif kind == 3:
            p[32767] = 0x80000000
        pats.append(p)
    a = np.stack([pats[r % 4] for r in range(rows)])
    b = np.stack([pats[(r + 1) % 4] for r in range(rows)])
    return a, b


def check_k1(fp, bp, rng) -> float:
    """Every op, R in {1, 7, 8, 13, 954}, b full and broadcast, on
    adversarial and random planes: kernel == plain version exactly.
    Returns the largest absolute difference seen (0)."""
    import torch

    worst = 0
    n_checks = 0
    for rows in (1, 7, 8, 13, N_SLICES):
        adv = adversarial_planes(rows)
        rnd = (
            rng.integers(0, 2**32, size=(rows, 32768), dtype=np.uint32),
            rng.integers(0, 2**32, size=(rows, 32768), dtype=np.uint32),
        )
        for a_np, b_np in (adv, rnd):
            a = bp.to_device(a_np, "cuda")
            b = bp.to_device(b_np, "cuda")
            for op in fp.OPS:
                bs = [None] if op == "none" else [b, b[-1:]]
                for bb in bs:
                    got = fp.row_popcounts(a, bb, op)
                    torch.cuda.synchronize()
                    want = fp.plain_row_popcounts(a, bb, op)
                    torch.cuda.synchronize()
                    diff = int((got.long() - want.long()).abs().max())
                    worst = max(worst, diff)
                    n_checks += 1
                    if diff != 0 or got.dtype != want.dtype or got.shape != want.shape:
                        raise AssertionError(
                            f"fused_popcount != plain: rows={rows} op={op} "
                            f"broadcast={bb is not None and bb.shape[0] == 1} diff={diff}"
                        )
    log(f"phase 3: fused_popcount == plain on {n_checks} cases (max_abs_err {worst})")
    return float(worst)


def http(host: str, method: str, path: str, body: bytes = b"") -> tuple[int, object]:
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def topn_oracle(scores: np.ndarray, n: int) -> list[dict]:
    """The two-phase TopN protocol over per-slice scores [slices, rows]:
    per-slice winners (count desc, id asc, count > 0, first n), their
    union, exact summed counts, sorted and trimmed to n."""
    winners = set()
    for row in scores:
        ids = [r for r in np.lexsort((np.arange(len(row)), -row)) if row[r] > 0]
        winners.update(int(r) for r in ids[:n])
    pairs = [(int(r), int(scores[:, r].sum())) for r in sorted(winners)]
    pairs = [p for p in pairs if p[1] > 0]
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return [{"id": i, "count": c} for i, c in pairs[:n]]


def serve_and_check(fp, bp, convert, Server, rng) -> dict:
    import torch

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-smoke-") as data_dir:
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda")
        srv.open()
        try:
            h = srv.host
            for path in ("/index/i", "/index/i/frame/f", "/index/i/frame/g"):
                status, body = http(h, "POST", path)
                if status != 200:
                    raise AssertionError(f"POST {path}: {status} {body}")

            t0 = time.perf_counter()
            planes = rng.integers(0, 2**32, size=(N_SLICES, ROWS, 32768), dtype=np.uint32)
            t1 = time.perf_counter()
            convert.load_planes(
                srv.holder, "i", "f", "standard", {s: planes[s] for s in range(N_SLICES)}
            )
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            log(
                f"phase 5: {N_SLICES} slices x {ROWS} rows generated in {t1 - t0:.3f}s, "
                f"loaded (mirror upload + recount + snapshot) in {t2 - t1:.3f}s; "
                f"device memory allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB"
            )

            # Sparse frame g, written point by point over HTTP.
            g_bits = sorted(
                {(int(r), int(c)) for r, c in zip(
                    rng.integers(0, 4, 64), rng.integers(0, N_SLICES << 20, 64))}
            )
            for r, c in g_bits:
                status, body = http(
                    h, "POST", "/index/i/query",
                    f"SetBit(frame=g, rowID={r}, columnID={c})".encode(),
                )
                if status != 200 or body["results"] != [True]:
                    raise AssertionError(f"SetBit g {r} {c}: {status} {body}")
            g_row1 = sorted(c for r, c in g_bits if r == 1)

            def pc(x):
                return int(np.bitwise_count(x).sum())

            p0, p1, p2, p3 = (planes[:, r] for r in range(4))
            row_totals = np.bitwise_count(planes).sum(axis=-1, dtype=np.int64)
            src_scores = np.bitwise_count(planes & planes[:, :1]).sum(axis=-1, dtype=np.int64)
            queries = [
                ("count_bitmap", "Count(Bitmap(frame=f, rowID=0))", pc(p0), 1),
                ("count_intersect",
                 "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))",
                 pc(p0 & p1), 1),
                ("count_union3",
                 "Count(Union(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1), "
                 "Bitmap(frame=f, rowID=2)))",
                 pc(p0 | p1 | p2), 1),
                ("count_difference",
                 "Count(Difference(Bitmap(frame=f, rowID=2), Bitmap(frame=f, rowID=3)))",
                 pc(p2 & ~p3), 1),
                ("count_xor",
                 "Count(Xor(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=3)))",
                 pc(p1 ^ p3), 1),
                ("bitmap_g", "Bitmap(frame=g, rowID=1)", {"attrs": {}, "bits": g_row1}, 0),
                ("topn", "TopN(frame=f, n=5)", topn_oracle(row_totals, 5), 0),
                ("topn_src", "TopN(Bitmap(frame=f, rowID=0), frame=f, n=5)",
                 topn_oracle(src_scores, 5), 2 * N_SLICES),
            ]

            fp.launches = 0  # the main path starts here
            expected_launches = 0
            latencies: dict[str, float] = {}
            for name, pql, want, per_query in queries:
                times = []
                for _ in range(REPS):
                    q0 = time.perf_counter()
                    status, body = http(h, "POST", "/index/i/query", pql.encode())
                    times.append(time.perf_counter() - q0)
                    if status != 200 or body["results"] != [want]:
                        raise AssertionError(f"{name}: {status} {str(body)[:300]} != {want}")
                latencies[name] = statistics.median(times) * 1e3
                expected_launches += REPS * per_query

            # A write, then the count that must see it.
            col = next(c for c in range(N_SLICES << 20)
                       if not (int(p0[c >> 20, (c & 0xFFFFF) >> 5]) >> (c & 31)) & 1)
            status, body = http(
                h, "POST", "/index/i/query", f"SetBit(frame=f, rowID=0, columnID={col})".encode()
            )
            if status != 200 or body["results"] != [True]:
                raise AssertionError(f"SetBit f: {status} {body}")
            status, body = http(
                h, "POST", "/index/i/query", b"Count(Bitmap(frame=f, rowID=0))"
            )
            if status != 200 or body["results"] != [pc(p0) + 1]:
                raise AssertionError(f"re-Count after SetBit: {status} {body}")
            expected_launches += 1
            launches = fp.launches  # the main path ends here
            if launches != expected_launches:
                raise AssertionError(
                    f"fused_popcount launches {launches} != expected {expected_launches}"
                )
            out["launches"] = launches
            for name, ms in latencies.items():
                log(f"phase 5: {name} p50 {ms:.3f} ms over {REPS} requests")
            log(f"phase 5: answers == numpy oracle; fused_popcount launches {launches} "
                f"(expected {expected_launches})")

            # Leaf-stack assembly apart from the kernel: the Count(Intersect)
            # leaves, stacked from the 954 fragments' mirrors.
            from pilosa_tpu_torch.exec import plan
            from pilosa_tpu_torch.pql import parse_string

            child = parse_string(queries[1][1]).calls[0].children[0]
            _, leaves = plan.decompose(child)
            slices = list(range(N_SLICES))
            asm = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                a0 = time.perf_counter()
                srv.executor.leaf_stacks("i", leaves, slices)
                torch.cuda.synchronize()
                asm.append((time.perf_counter() - a0) * 1e3)
            out["assembly_ms"] = statistics.median(asm)
            log(f"phase 5: leaf-stack assembly for Count(Intersect) p50 "
                f"{out['assembly_ms']:.3f} ms (2 leaves x {N_SLICES} slice-rows)")
            out["latencies_ms"] = latencies
        finally:
            srv.close()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.net.server import Server
    from pilosa_tpu_torch.ops import _build
    from pilosa_tpu_torch.ops import bitplane as bp
    from pilosa_tpu_torch.ops import fused_popcount as fp

    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    hbm = hbm_rate(name)
    log(f"phase 1: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"memory rate for the bound {hbm / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.3f}s {built}")

    rng = np.random.default_rng(SEED)
    max_err = check_k1(fp, bp, rng)

    a = bp.to_device(rng.integers(0, 2**32, size=(N_SLICES, 32768), dtype=np.uint32), "cuda")
    b = bp.to_device(rng.integers(0, 2**32, size=(N_SLICES, 32768), dtype=np.uint32), "cuda")
    k_ms = time_cuda(lambda: fp.row_popcounts(a, b, "and"))
    plain_ms = time_cuda(lambda: fp.plain_row_popcounts(a, b, "and"))
    bound_ms, bound_by = k1_bound_ms(N_SLICES, True, False, hbm)
    log(f"phase 4: fused_popcount [{N_SLICES}, 32768] and: {k_ms:.4f} ms "
        f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / k_ms:.1%} of it), "
        f"plain {plain_ms:.4f} ms")
    del a, b

    served = serve_and_check(fp, bp, convert, Server, rng)

    kernels = [{
        "name": fp.NAME,
        "route": "cuda",
        "source": fp.SOURCE,
        "replaces": fp.REPLACES,
        "launches": served["launches"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "checked": max_err == 0.0,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
