#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pilosa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing its final line:

1. the card's ``name, power.limit`` (nvidia-smi);
2. build every kernel from the sources in this checkout (one nvcc per
   source, started together);
3. hold each kernel against its plain PyTorch version on the card, on
   adversarial and seeded random inputs, every case listed — the
   results must be exactly equal (integers); for the BSI ripple kernels
   (K8) depths 1, 7, 8, 9, 31 and 62, 1, 3 and 954 slices, every
   comparison at the window's edges, 0 and +-1, empty betweens, slices
   with no value, one sign only, one value, absent planes and no
   fragment, Sum/Min/Max with and without a filter; for the TopN scorer
   (K4) 1, 3 and 954 fragments with mirrors of 1, 8, 64 and 65 rows mixed
   in one launch, candidate lists of 1 to every row with -1 pads,
   self-src and row-src, all-zero and all-ones src rows; for the payload
   expansion (K6) 1, 7 and 954 rows of mixed formats and 954 of each
   format in one launch, also against numpy; for the anchored count (K5)
   1, 7 and 954 slices x 4 leaves of every format and absent rows in one
   launch, anchors of 32,768, 1 and 0 positions and up to 2^20 - 1, six
   trees (one nested 11 masks deep); for the delta-scatter (K7) the
   one-plane interface on edge queues and 1 to 8,192 entries, and
   batches of one launch each: one bit set and cleared within and across
   queues, mirrors of 8, 16 and 65,536 rows in one launch, empty queues,
   one mirror twice, and 954 mirrors at once;
4. time each kernel at the main path's shapes (CUDA events around runs
   of back-to-back calls, median of 21 runs), beside its bound and its
   plain version's time; for the delta-scatter kernel (K7) one, 954 and
   1,908 mirrors in one launch, with the time of an empty kernel launch,
   the floor that bounds the small batch, the host's part of the batched
   apply, and the two rates that set a queue's limit; and each kernel's
   own device time per launch from a torch.profiler trace; K8 at [954
   slices, depth 31]; K4 at [954 fragments, 8 candidates] and [954, 64],
   and K1 at the per-fragment TopN shape it served before K4 ([8, 32768]
   and [64, 32768] against a broadcast src row); K6 over 954 payloads of
   each format (with ``Tensor.scatter_add_`` as the library yardstick of
   the positions form); K5 at [954 slices, 32,768-position anchors, a
   dense, a sparse and an RLE leaf];
5. serve a 1B-column index — 954 slices x 8 dense rows, seeded random
   words, about 1 GiB on the card — with ``Server(device="cuda")`` and
   answer Count/Bitmap/TopN/SetBit over HTTP, every answer checked
   against a numpy oracle over the same planes, with the kernels'
   launch counts reset just before and read just after (TopN(src): one
   K4 launch per request, no K1); the SetBits' p50, each answered after
   its WAL group commit;
6. a cluster on the one card: three ``Server(device="cuda")`` nodes of
   an http cluster with 2 replicas; the schema created on one node
   reaches the others by broadcast; each node loads the phase-5 planes
   of the slices it owns (~2 GiB of mirrors); then a protobuf
   ``/import`` of 2^20 seeded bits (~1,100 per fragment), which must
   launch nothing on the card (the bits queue on the host), and the
   first Count after it, which applies the queues of every fragment a
   node reads with one delta-scatter launch per node leg;
   Count/TopN queries to every node in protobuf
   and JSON checked against the numpy oracle (TopN(src): one K4 launch
   per node leg and round); a BSI field created on one
   node (its fan-out reaches the others), ``/import-value`` to every
   owner of 64 slices, Count(Range)/Sum/Min/Max from every node; a
   second import into new rows (the counted fallback to a mirror
   re-upload), and the Counts and the BSI queries again with one node
   closed (replica failover); launch counts reset just before and read
   just after;
7. on the phase-5 node, a signed 32-bit integer field over the 954
   slices (~4.13 GB of planes, seeded word by word): Count(Range) for
   every comparison and between, a Range inside Intersect, Sum/Min/Max
   with and without a filter, checked against a numpy oracle that
   decodes every column's value; then an ``/import-value`` of 2^16
   values over every slice, which launches nothing, and the first read
   after it, which applies all 954 queues (with and-not entries) in ONE
   delta-scatter launch; one import past a queue's limit on one slice
   (the counted fallback); the queries again after each;
8. on the phase-5 node, a time-quantum frame (YMD) over 16 slices:
   SetBits with timestamps and a protobuf ``/import`` of 2^16 bits over
   40 days, then Range(start, end) counts inside a month, across the
   month boundary and over the year, plain and inside Intersect,
   against numpy over the written triples;
9. on the phase-5 node, a TopN frame of 64 rows per fragment over the 954
   slices (1B columns, 8 GiB of mirrors), row k at density
   0.5 * 2^(-k/8), generated on the card slice by slice: TopN without a
   src, self-src, row-src (a tree over phase 5's frame), with threshold,
   tanimotoThreshold and ids, against a numpy oracle of per-slice scores;
10. on a node of its own at the JAX package's defaults (dense budget
    65,536, plane-format auto, 64 KiB caps), the two tutorials of
    docs/tutorials.md loaded through ``/import``: the star trace (index
    ``repository``, 2^18 stargazers in a random permutation, Zipf stars,
    1% of them starring a run of repositories, 2 slices: two tall
    fragments with 8 GiB plane tiers; 64 languages) and the chemical
    similarity (index ``mole``, 2^18 molecules x 1,024 positions, ~48
    bits each, frame ``fingerprint`` with inverse storage: a tall inverse
    fragment); Counts through K5, Union/Bitmap/TopN srcs through K6, TopN
    over both tiers, a SetBit into a sparse row, ``Bitmap(molecule_id=m)``
    and the tanimoto TopN on the inverse view, every answer against a
    numpy oracle over the written pairs, the launches of K1, K4, K5 and
    K6 counted around each query class;
11. recovery on the card: a port node's data directory with a torn
    op-log tail and a WAL segment of a JAX node's (written with the
    port's encoder) reopens with the oracle's answers, restarts the
    segment at its checkpoint snapshot, applies a later write with one
    delta-scatter launch, and replays nothing twice;
12. residency under a budget: every other node closed, phase 10's
    directory reopens with ``hbm_budget_bytes`` of 12 GiB (three 8 GiB
    plane tiers; staging from its ``.residency.json`` in the
    background), and phase 10's query classes alternate between the two
    indexes, each answer against the oracle; after every query the
    pool's resident and high-water bytes, evictions, skipped evictions,
    over-budget admissions, restaged bytes and the allocator's
    ``memory_allocated()`` / ``memory_reserved()`` are printed and
    checked (within the budget outside pinned saturation; evictions > 0;
    a query pinning both 8 GiB star mirrors saturates and answers
    right); the time to the first answer, the staging job's end and one
    eviction-driven 8 GiB re-upload are timed;
13. durability: on a node of its own with the WAL on, 8 threads send 500
    SetBits each over HTTP across 16 slices; the data directory copied
    while the node is open opens in a second node with every
    acknowledged bit; ``/debug/ingest`` shows fewer fsyncs than appends;
    serial SetBit p50 / p99 with the WAL on and off, in turns;
14. print the ``kernels`` JSON line, then the final JSON line.

Exits non-zero when ``torch.cuda.is_available()`` is false, and when the
port's package is not beside this file.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta, timezone

import numpy as np

SEED = 7
N_SLICES = 954  # ceil(1e9 / 2^20): 1B columns
ROWS = 8
REPS = 5
# Phase 6: requests per (query, node, format), bits per import.
CLUSTER_REPS = 3
IMPORT_BITS = 1 << 20
FALLBACK_IMPORT_BITS = 1 << 16
# Phase 6's BSI leg: values over the first slices.
CLUSTER_BSI_SLICES = 64
CLUSTER_BSI_VALUES = 1 << 14
# Phase 7: the first /import-value (every slice, the K7 path with clears); the
# second goes past its queue's limit on one slice (the counted fallback).
BSI_IMPORT_VALUES = 1 << 16
# Phase 8: the time-quantum frame.
TIME_SLICES = 16
TIME_ROWS = 4
TIME_BITS = 1 << 16
TIME_DAYS = 40
# Phase 9: the TopN frame: rows per fragment over all slices, n, the row-src
# threshold and the explicit ids.
TOPN_ROWS = 64
TOPN_N = 10
TOPN_THRESHOLD = 2000
TOPN_IDS = (0, 5, 17, 33, 63, 99)
LOAD_THREADS = 6
# Phase 3: the delta-scatter entry counts held through the one-plane interface.
K7_NS = (1, 31, 1100, 4096, 8192)

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


def device_ms(fn, kernel: str, launches: int = 50) -> float | None:
    """Mean device time of the kernels named ``kernel`` over ``launches``
    calls of ``fn()``, read from a torch.profiler trace of the card
    (None when the trace holds no such kernel): the kernel's own time,
    apart from the host's pace of launching it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh).get("traceEvents", [])
    durs = [float(ev.get("dur", 0.0)) for ev in events
            if ev.get("ph") == "X" and ev.get("cat") == "kernel" and kernel in ev.get("name", "")]
    return sum(durs) / len(durs) / 1e3 if durs else None


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

def k7_bound_ms(jobs: int, n: int, hbm: float) -> tuple[float, str]:
    """Least time for a batch of n delta-scatter records over ``jobs``
    planes: each record (16 bytes) and each plane's address (8 bytes)
    read once, and per touched word one 32-byte sector read and one
    written (the card moves sectors, not words); two bitwise ops per
    record, far below the byte time."""
    t_bytes = (jobs * 8 + n * (16 + 32 + 32)) / hbm
    t_ops = n * 2 / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def random_entries(rng, rows: int, n: int):
    """n unique (slot, word) entries with random or/andnot masks."""
    keys = rng.choice(rows * 32768, size=n, replace=False)
    return (
        (keys // 32768).astype(np.int32),
        (keys % 32768).astype(np.int32),
        rng.integers(0, 2**32, size=n, dtype=np.uint32),
        rng.integers(0, 2**32, size=n, dtype=np.uint32),
    )


def k7_edge_queues(rows: int) -> dict:
    """(slot, word, mask, op) queues for ingest.scatter.fold: bit 0 and
    bit 31 of a word, word 32767, a set and a clear of one bit in one
    queue (both orders), the last slot, and the empty queue."""
    last = rows - 1
    return {
        "bit0_bit31": [(0, 5, 1, 1), (0, 6, 1 << 31, 1), (1, 5, 1, 0), (1, 6, 1 << 31, 0)],
        "word32767": [(2, 32767, 1 << 31, 1), (3, 32767, 1, 0), (3, 32767, 1 << 30, 1)],
        "set_clear_same_bit": [(0, 7, 1 << 9, 1), (0, 7, 1 << 9, 0),
                               (1, 7, 1 << 9, 0), (1, 7, 1 << 9, 1)],
        "last_slot": [(last, 0, 1, 1), (last, 32767, 1 << 31, 0), (last, 100, 0xF0, 1)],
        "empty": [],
    }


def k7_codes(scatter, rng, rows: int, n: int, words: int = 0) -> np.ndarray:
    """n queue codes (scatter.codes) into ``rows`` rows, sets and clears
    in turn; with ``words`` they crowd onto that many words of each row
    (bits set and cleared again), else they spread over the row."""
    offs = (rng.integers(0, words, n) * 32 + rng.integers(0, 32, n) if words
            else rng.integers(0, 1 << 20, n))
    return scatter.codes(rng.integers(0, rows, n), offs, 0) | rng.integers(0, 2, n)


def k7_batches(scatter, rng) -> dict:
    """Phase 3's batches: {name: (mirror rows per job, queue per job)}.
    Mixed sets and clears of one bit within a queue and across queues,
    jobs of 8, 16 and 65,536 rows in one launch (the last word of the
    tall mirror's last row), empty queues among full ones, one mirror
    twice (merged in order), and every slice's queue at once."""
    one_bit = scatter.codes([1], [(1 << 20) - 1], 0)
    tall_last = scatter.codes([(1 << 16) - 1], [(1 << 20) - 1], 0)
    return {
        "one_bit_across_queues": (
            [8, 8, 16],
            [np.concatenate([k7_codes(scatter, rng, 8, 300, 4), one_bit | 1, one_bit]),
             np.concatenate([one_bit, k7_codes(scatter, rng, 8, 300, 4), one_bit | 1]),
             np.concatenate([one_bit | 1, one_bit, one_bit | 1])]),
        "rows_8_16_65536": (
            [8, 1 << 16, 16, 1 << 16],
            [k7_codes(scatter, rng, 8, 1100),
             np.concatenate([k7_codes(scatter, rng, 1 << 16, 20000), tall_last | 1]),
             k7_codes(scatter, rng, 16, 4096, 64),
             np.concatenate([tall_last | 1, tall_last, k7_codes(scatter, rng, 1 << 16, 3000)])]),
        "empty_queues": (
            [8, 8, 8, 8],
            [np.empty(0, np.int64), k7_codes(scatter, rng, 8, 31), np.empty(0, np.int64),
             k7_codes(scatter, rng, 8, 1)]),
        "same_mirror_twice": ([8, "same"], [k7_codes(scatter, rng, 8, 900, 16),
                                             k7_codes(scatter, rng, 8, 900, 16)]),
        f"{N_SLICES}_jobs_1100": ([8] * N_SLICES, [k7_codes(scatter, rng, 8, 1100)
                                                  for _ in range(N_SLICES)]),
    }


def k7_diff(a, b) -> int:
    """The largest absolute difference of two int32 tensors, without an
    int64 copy of an 8 GiB mirror where they are equal."""
    if a.equal(b):
        return 0
    ne = a != b
    return int((a[ne].long() - b[ne].long()).abs().max())


def check_k7(ds, scatter, rng) -> float:
    """K7 against its plain version, exactly: every edge queue and n in
    K7_NS random entries into [8, 32768] and [16, 32768] mirrors through
    the one-plane interface (the one-job case of the kernel), also
    against numpy; then every batch of ``k7_batches`` through
    ``scatter.apply_many`` — ONE launch a batch — against the plain
    version on the same folded entries.  Returns the largest absolute
    difference seen (0)."""
    import torch

    worst = 0
    n_checks = 0
    for rows in (8, 16):
        base = rng.integers(0, 2**32, size=(rows, 32768), dtype=np.uint32)
        base[0, :8] = (0, 0xFFFFFFFF, 0x80000000, 1, 0, 0xFFFFFFFF, 0, 0x7FFFFFFF)
        cases = {name: scatter.fold(q) for name, q in k7_edge_queues(rows).items()}
        for n in K7_NS:
            cases[f"n={n}"] = random_entries(rng, rows, n)
        for name, entries in cases.items():
            n = len(entries[0])
            kernel_plane = torch.from_numpy(base.view(np.int32).copy()).to("cuda")
            plain_plane = kernel_plane.clone()
            before = ds.launches
            ds.delta_scatter(kernel_plane, *entries)
            torch.cuda.synchronize()
            if ds.launches != before + (1 if n else 0):
                raise AssertionError(f"delta_scatter {name}: {ds.launches - before} launches")
            ds.plain_delta_scatter(plain_plane, *entries)
            torch.cuda.synchronize()
            want = base.copy()
            s, w, o, a = entries
            want[s, w] = (want[s, w] & ~a) | o
            diff = int((kernel_plane.long() - plain_plane.long()).abs().max())
            worst = max(worst, diff)
            n_checks += 1
            if diff or not np.array_equal(plain_plane.cpu().numpy().view(np.uint32), want):
                raise AssertionError(
                    f"delta_scatter != plain/numpy: rows={rows} {name} diff={diff}")
    n_numpy = n_checks
    for name, (shapes, queues) in k7_batches(scatter, rng).items():
        mirrors = []
        for r in shapes:
            mirrors.append(mirrors[-1] if r == "same" else torch.randint(
                -2**31, 2**31 - 1, (r, 32768), dtype=torch.int32, device="cuda"))
        plain = {id(m): m.clone() for m in mirrors}
        before = ds.launches
        scatter.apply_many(list(zip(mirrors, queues)))
        torch.cuda.synchronize()
        if ds.launches != before + 1:
            raise AssertionError(f"delta_scatter batch {name}: {ds.launches - before} launches")
        # The plain version on the fold of the same batch (one mirror
        # twice is one job with both queues, in order).
        merged: dict = {}
        for m, q in zip(mirrors, queues):
            merged.setdefault(id(m), []).append(q)
        ds.plain_delta_scatter_many(list(plain.values()), *scatter.fold_many(
            [np.concatenate(merged[k]) for k in plain]))
        torch.cuda.synchronize()
        diff = max(k7_diff(m, plain[id(m)]) for m in mirrors)
        worst = max(worst, diff)
        n_checks += 1
        if diff:
            raise AssertionError(f"delta_scatter batch {name} != plain: diff={diff}")
        del mirrors, plain
    torch.cuda.empty_cache()
    log(f"phase 3: delta_scatter == plain on {n_checks} cases ({n_numpy} through the "
        f"one-plane interface, also == numpy; {n_checks - n_numpy} batches of one launch "
        f"each) (max_abs_err {worst})")
    return float(worst)


# Phase 4: K7's timed shapes, (jobs, records a job) into [8, 32768] mirrors:
# one fragment's import, phase 7's flush of every slice, phase 6's flush of
# both replicas of every slice at half the records.
K7_SHAPES = ((1, 1100), (N_SLICES, 1100), (2 * N_SLICES, 550))


def time_k7(ds, scatter, bp, rng, hbm: float) -> dict:
    """Per shape of K7_SHAPES: the kernel alone (its buffer already on
    the card) back to back and by device time, the empty-launch floor,
    the bound and the share of it, the plain version, and the host's
    part of ``scatter.apply_many`` — fold, check and upload — beside
    the whole call.  Then the two rates behind the queue limit
    (``scatter.ENTRY_COST_BYTES``): a mirror's re-upload in bytes per
    second, and ``apply_many``'s host seconds per record at N_SLICES
    jobs."""
    import torch

    dev = torch.device("cuda")
    noop_ms = time_cuda(lambda: ds.noop_launch(dev))
    noop_dev = device_ms(lambda: ds.noop_launch(dev), "noop_kernel")
    out: dict = {}
    for jobs, per in K7_SHAPES:
        planes = [torch.randint(-2**31, 2**31 - 1, (ROWS, 32768), dtype=torch.int32, device=dev)
                  for _ in range(jobs)]
        queues = [k7_codes(scatter, rng, ROWS, per) for _ in range(jobs)]
        folded = scatter.fold_many(queues)
        n = len(folded[0])
        buf = ds.upload(ds.pack(planes, *folded), dev)
        k_ms = time_cuda(lambda: ds.launch_many(buf, jobs, n))
        k_dev = device_ms(lambda: ds.launch_many(buf, jobs, n), "delta_scatter_kernel")
        plain_ms = time_cuda(lambda: ds.plain_delta_scatter_many(planes, *folded),
                             runs=3, per_run=1, warmup=1)
        host: dict = {"fold": [], "check_upload": [], "apply_many": []}
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = scatter.fold_many(queues)
            t1 = time.perf_counter()
            ds.upload(ds.pack(planes, *f), dev)
            t2 = time.perf_counter()
            scatter.apply_many(list(zip(planes, queues)))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            host["fold"].append((t1 - t0) * 1e3)
            host["check_upload"].append((t2 - t1) * 1e3)
            host["apply_many"].append((t3 - t2) * 1e3)
        host = {k: statistics.median(v) for k, v in host.items()}
        bound_ms, bound_by = k7_bound_ms(jobs, n, hbm)
        share = bound_ms / k_dev if k_dev else None
        out[(jobs, per)] = {
            "jobs": jobs, "records": n, "ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms,
            "noop_ms": noop_ms, "noop_device_ms": noop_dev, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": share, "host_fold_ms": host["fold"],
            "host_check_upload_ms": host["check_upload"], "apply_many_ms": host["apply_many"]}
        log(f"phase 4: delta_scatter {jobs} jobs x {per} records ({n} after the fold) into "
            f"[{ROWS}, 32768] mirrors: kernel {k_ms:.4f} ms back to back, {k_dev} ms device "
            f"time per launch (empty kernel {noop_dev} ms, empty launch {noop_ms:.4f} ms); "
            f"bound {bound_ms:.6f} ms by {bound_by}"
            + (f", {share:.1%} of it" if share else "")
            + f"; plain {plain_ms:.4f} ms; apply_many on the host: fold {host['fold']:.3f} ms, "
            f"check + upload {host['check_upload']:.3f} ms; the whole call with its launch "
            f"and a sync {host['apply_many']:.3f} ms")
        del planes, buf
    # The two costs the queue limit weighs: a re-upload, fit as a fixed
    # cost plus bytes over a rate from mirrors of 8 and 64 rows; one
    # record of apply_many at the largest batch, in bytes of that rate.
    took = {}
    for rows in (8, 64):
        plane = rng.integers(0, 2**32, size=(rows, 32768), dtype=np.uint32)
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = bp.to_device(plane, dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del m
        took[rows] = statistics.median(times)
    rate = 56 * 32768 * 4 / (took[64] - took[8])
    fixed_s = took[8] - 8 * 32768 * 4 / rate
    big = out[K7_SHAPES[1]]
    per_record_s = big["apply_many_ms"] / 1e3 / big["records"]
    limits = {r: scatter.pending_limit(r) for r in (8, 64, 1 << 16)}
    out["limit"] = {"upload_s_8_rows": took[8], "upload_s_64_rows": took[64],
                    "upload_bytes_per_s": rate, "upload_fixed_bytes": fixed_s * rate,
                    "apply_many_s_per_record": per_record_s,
                    "entry_cost_bytes": per_record_s * rate,
                    "in_use": {"ENTRY_COST_BYTES": scatter.ENTRY_COST_BYTES,
                               "UPLOAD_FIXED_BYTES": scatter.UPLOAD_FIXED_BYTES,
                               "pending_limit": limits}}
    log(f"phase 4: a mirror re-upload takes {took[8] * 1e3:.4f} ms at 8 rows, "
        f"{took[64] * 1e3:.4f} ms at 64 rows: {rate / 1e9:.3f} GB/s after a fixed "
        f"{fixed_s * 1e6:.1f} us ({fixed_s * rate:.0f} bytes); apply_many takes "
        f"{per_record_s * 1e9:.1f} ns a record at {big['jobs']} jobs ({per_record_s * rate:.0f} "
        f"bytes); in use: ENTRY_COST_BYTES {scatter.ENTRY_COST_BYTES}, UPLOAD_FIXED_BYTES "
        f"{scatter.UPLOAD_FIXED_BYTES}, pending_limit {limits}")
    return out


# Phase 3/4: the ripple kernel K8.  (depth, slices) of the checked fields;
# each small field runs once per group of slice kinds; the last is the main
# path's size and is also timed.
K8_FIELDS = ((1, 1), (1, 3), (7, 3), (8, 3), (9, 3), (31, 1), (31, 3), (62, 3))
K8_KINDS = ("random", "no_exists", "positive", "negative", "all_equal", "absent_planes",
            "no_fragment")
K8_GROUPS = {1: [("random",), ("no_exists",), ("all_equal",)],
             3: [("random", "no_exists", "positive"), ("negative", "all_equal", "absent_planes"),
                 ("no_fragment", "random", "all_equal")]}
K8_CMP_OPS = ("lt", "le", "eq", "ne", "ge", "gt")
K8_DEPTH = 31  # a signed 32-bit field: 31 magnitude planes


def k8_field(br, bsi, depth: int, kinds, seed: int):
    """A seeded field on the card: ``(FieldPlanes, filter rows)``.  Each
    slice's exists, sign and magnitude planes (values masked to exists,
    zero stored with sign 0) live in its own mirror in a shuffled row
    order with a spare row; ``absent_planes`` drops the sign row and
    every third bit row (slot -1), ``no_fragment`` has no mirror."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n = len(kinds)

    def rnd(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev, generator=g)

    planes = rnd(n, 2 + depth, 32768)
    rng = np.random.default_rng(seed)
    for s, kind in enumerate(kinds):
        if kind == "no_exists":
            planes[s, 0] = 0
        elif kind == "positive":
            planes[s, 1] = 0
        elif kind == "negative":
            planes[s, 1] = -1
        elif kind == "all_equal":
            v = int(rng.integers(1, 1 << depth)) * (-1 if s % 2 else 1)
            for k in range(depth):
                planes[s, 2 + k] = -1 if (abs(v) >> k) & 1 else 0
            planes[s, 1] = -1 if v < 0 else 0
    ex = planes[:, 0:1]
    planes[:, 2:] &= ex
    nonzero = planes[:, 2]
    for k in range(1, depth):
        nonzero = nonzero | planes[:, 2 + k]
    planes[:, 1] &= planes[:, 0] & nonzero
    slots = np.stack([rng.permutation(3 + depth)[: 2 + depth] for _ in range(n)]).astype(np.int64)
    store = torch.zeros(n, 3 + depth, 32768, dtype=torch.int32, device=dev)
    store[torch.arange(n, device=dev)[:, None], torch.from_numpy(slots).to(dev)] = planes
    del planes
    mirrors = []
    for s, kind in enumerate(kinds):
        if kind == "absent_planes":
            slots[s, [1] + list(range(2, 2 + depth, 3))] = -1
        if kind == "no_fragment":
            slots[s] = -1
            mirrors.append(None)
        else:
            mirrors.append(store[s])
    fp = br.FieldPlanes(mirrors, slots, bsi.pad_depth(depth), dev)
    return fp, rnd(n, 32768)


def k8_cases(bsi, depth: int, full: bool, rng):
    """(kernel, args) pairs: every op at +-(2^depth - 1), 0, +-1 and both
    out-of-range sides (clamped as the executor clamps them) and six
    betweens, an empty one included, in row and count mode; Sum, Min and
    Max with and without the filter.  ``full=False`` keeps 0, -1 and one
    drawn value, and three betweens."""
    hi = (1 << depth) - 1
    drawn = int(rng.integers(-hi, hi + 1))
    raw = [hi, -hi, 0, 1, -1, hi + 1, -hi - 1] if full else [0, -1, drawn]
    pairs = [(-hi, hi), (-1, 1), (0, 0), (5, 2), (-hi - 9, hi + 9), (drawn, hi)]
    if not full:
        pairs = [(-1, 1), (5, 2), (drawn, hi)]
    out = []
    for count in (False, True):
        for op0 in K8_CMP_OPS:
            for v in raw:
                op, pv = bsi.clamp_predicate(op0, v, depth)
                out.append(("bsi_cmp", (op, pv, None, count)))
        for a, b in pairs:
            out.append(("bsi_cmp", ("between", *bsi.clamp_between(a, b, depth), count)))
    for filtered in (False, True):
        out.append(("bsi_sum", (filtered,)))
        out.append(("bsi_minmax", ("min", filtered)))
        out.append(("bsi_minmax", ("max", filtered)))
    return out


def run_k8(br, fp, filt, kernel: str, args, plain: bool):
    if kernel == "bsi_cmp":
        op, lo, hi, count = args
        f = br.plain_bsi_cmp if plain else br.bsi_cmp
        return f(fp, op, lo, hi, count)
    if kernel == "bsi_sum":
        f = br.plain_bsi_sum if plain else br.bsi_sum
        return f(fp, filt if args[0] else None)
    f = br.plain_bsi_minmax if plain else br.bsi_minmax
    return f(fp, args[0], filt if args[1] else None)


def check_k8(br, bsi, rng) -> dict:
    """Every K8 kernel against its plain version on the card, on every
    case of :func:`k8_cases` for each field of K8_FIELDS and slice-kind
    group, then at the main path's size ([954 slices, depth 31], the slice
    kinds cycled).  Exact: returns ``{kernel: max_abs_err}``."""
    import torch

    worst = dict.fromkeys(br.KERNELS, 0)
    n_checks = dict.fromkeys(br.KERNELS, 0)
    fields = [(d, kinds) for d, n in K8_FIELDS for kinds in K8_GROUPS[n]]
    fields.append((K8_DEPTH, tuple(K8_KINDS[s % len(K8_KINDS)] for s in range(N_SLICES))))
    for i, (depth, kinds) in enumerate(fields):
        fp, filt = k8_field(br, bsi, depth, kinds, SEED + 10 + i)
        full = len(kinds) <= 3
        for kernel, args in k8_cases(bsi, depth, full, rng):
            before = br.launches[kernel]
            got = run_k8(br, fp, filt, kernel, args, plain=False)
            torch.cuda.synchronize()
            if br.launches[kernel] != before + 1:
                raise AssertionError(f"{kernel} {args}: {br.launches[kernel] - before} launches")
            want = run_k8(br, fp, filt, kernel, args, plain=True)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(
                    f"{kernel} depth={depth} {args}: shape/dtype {tuple(got.shape)} "
                    f"{got.dtype} != {tuple(want.shape)} {want.dtype}")
            diff = int((got.long() - want.long()).abs().max())
            worst[kernel] = max(worst[kernel], diff)
            n_checks[kernel] += 1
            if diff:
                raise AssertionError(f"{kernel} != plain: depth={depth} slices={len(kinds)} "
                                     f"kinds={kinds[:7]} {args} diff={diff}")
        del fp, filt
    for kernel in br.KERNELS:
        log(f"phase 3: {kernel} == plain on {n_checks[kernel]} cases (max_abs_err "
            f"{worst[kernel]}): depths {sorted({d for d, _ in fields})}, slices 1, 3 and "
            f"{N_SLICES}, slice kinds {', '.join(K8_KINDS)}")
    return {k: float(v) for k, v in worst.items()}


def k8_bound_ms(present: int, bucket: int, slices: int, kernel: str, hbm: float,
                row_mode: bool = False) -> tuple[float, str]:
    """Least time for one K8 launch: each of the ``present`` plane rows
    the field holds read once (absent rows cost nothing), the outputs
    written once (a 128 KiB row per slice in row mode, else the small
    vectors); about 5 integer operations per word and plane, far below
    the byte time."""
    row = 32768 * 4
    out = {"bsi_cmp": slices * (row if row_mode else 4),
           "bsi_sum": slices * 4 * (2 * bucket + 1),
           "bsi_minmax": slices * 4 * (bucket + 2)}[kernel]
    t_bytes = (present * row + out) / hbm
    t_ops = present * 32768 * 5 / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_k8(br, bsi, hbm: float) -> dict:
    """Each K8 kernel on a seeded field of the main path's shape, [954
    slices, depth 31] with every plane present: CUDA events around runs
    of back-to-back launches, device time per launch from the profiler,
    the plain version's time, and the byte bound."""
    fp, _ = k8_field(br, bsi, K8_DEPTH, ("random",) * N_SLICES, SEED + 5)
    cases = {
        "bsi_cmp": (lambda plain: (br.plain_bsi_cmp if plain else br.bsi_cmp)(
            fp, "gt", 12345, None, True), "bsi_cmp_kernel", {}),
        "bsi_cmp_row": (lambda plain: (br.plain_bsi_cmp if plain else br.bsi_cmp)(
            fp, "between", -100000, 100000, False), "bsi_cmp_kernel", {"row_mode": True}),
        "bsi_sum": (lambda plain: (br.plain_bsi_sum if plain else br.bsi_sum)(fp),
                    "bsi_sum_kernel", {}),
        "bsi_minmax": (lambda plain: (br.plain_bsi_minmax if plain else br.bsi_minmax)(
            fp, "max"), "bsi_minmax_kernel", {}),
    }
    out = {}
    for name, (fn, kname, extra) in cases.items():
        kernel = "bsi_cmp" if name.startswith("bsi_cmp") else name
        k_ms = time_cuda(lambda: fn(False), runs=11, per_run=10)
        plain_ms = time_cuda(lambda: fn(True), runs=3, per_run=2, warmup=1)
        k_dev = device_ms(lambda: fn(False), kname, launches=20)
        bound_ms, bound_by = k8_bound_ms(int((fp.slots >= 0).sum()), fp.bucket, fp.n, kernel,
                                         hbm, **extra)
        out[name] = {"ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        share = bound_ms / k_dev if k_dev else float("nan")
        log(f"phase 4: {name} [{fp.n}, depth {fp.depth}]: {k_ms:.4f} ms back to back, device "
            f"time per launch from the profiler {k_dev} ms ({share:.1%} of the bound), bound "
            f"{bound_ms:.4f} ms by {bound_by}, plain {plain_ms:.4f} ms")
    return out


# Phase 3/4: the cross-fragment TopN scorer K4.  Mirror row counts checked
# (cycled over the fragments of a launch) and the shapes timed: phase 5's
# TopN(src) ([954 fragments, 8 candidates]) and phase 9's ([954, 64]).
K4_ROWS = (1, 8, 64, 65)
K4_TIMED = (8, TOPN_ROWS)


def k4_mirrors(rows: list[int], seed: int) -> list:
    """Seeded mirrors on the card, fragment f with ``rows[f]`` rows of
    random words, row 1 all-zero and row 2 all-ones where they exist."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = []
    for r in rows:
        p = torch.randint(-2**31, 2**31, (r, 32768), dtype=torch.int32,
                          device="cuda", generator=g)
        if p.shape[0] > 1:
            p[1] = 0
        if p.shape[0] > 2:
            p[2] = -1
        out.append(p)
    return out


def k4_slot_tables(rows: list[int], rng) -> dict:
    """Candidate slot tables (int64 [F, R], -1 pads): one candidate each,
    every row, ragged lists of 1, 13 and 17 rows (past a tile of 8, not a
    multiple of it) and every row, and every row with pads past every list."""
    n, width = len(rows), max(rows)
    one = np.array([[rng.integers(0, r)] for r in rows], dtype=np.int64)
    every = np.full((n, width), -1, np.int64)
    ragged = np.full((n, width), -1, np.int64)
    for f, r in enumerate(rows):
        every[f, :r] = rng.permutation(r)
        k = min((1, 13, 17, r)[f % 4], r)
        ragged[f, :k] = rng.choice(r, size=k, replace=False)
    padded = np.concatenate([every, np.full((n, 5), -1, np.int64)], axis=1)
    return {"one": one, "every": every, "ragged": ragged, "padded": padded}


def k4_srcs(mirrors: list, rng) -> dict:
    """Src rows: a row of each fragment's own mirror (self-src, the
    all-ones row where there is one too), and rows of a separate tensor —
    random, all-zero and all-ones."""
    import torch

    n = len(mirrors)
    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(0, 2**31)))
    rnd = torch.randint(-2**31, 2**31, (n, 32768), dtype=torch.int32, device="cuda", generator=g)
    zero = torch.zeros(n, 32768, dtype=torch.int32, device="cuda")
    ones = torch.full((n, 32768), -1, dtype=torch.int32, device="cuda")
    return {
        "self": [m[int(rng.integers(0, m.shape[0]))] for m in mirrors],
        "self_ones": [m[min(2, m.shape[0] - 1)] for m in mirrors],
        "row": list(rnd), "row_zero": list(zero), "row_ones": list(ones),
    }


def check_k4(sp, rng) -> float:
    """K4 against its plain version on the card, exactly: 1, 3 and 954
    fragments; mirrors of 1, 8, 64 and 65 rows, unequal in one launch;
    every slot table of :func:`k4_slot_tables` and every src of
    :func:`k4_srcs`.  Returns the largest absolute difference (0)."""
    import torch

    groups = [(r,) for r in K4_ROWS] + [(8, 64, 65), (65, 1, 8)]
    groups.append(tuple(K4_ROWS[f % len(K4_ROWS)] for f in range(N_SLICES)))
    worst, n_checks = 0, 0
    for gi, rows in enumerate(groups):
        mirrors = k4_mirrors(list(rows), SEED + 20 + gi)
        srcs = k4_srcs(mirrors, rng)
        for tname, slots in k4_slot_tables(list(rows), rng).items():
            for sname, src in srcs.items():
                before = sp.launches
                got = sp.score_planes(mirrors, slots, src)
                torch.cuda.synchronize()
                if sp.launches != before + 1:
                    raise AssertionError(f"score_planes {tname}/{sname}: "
                                         f"{sp.launches - before} launches")
                want = sp.plain_score_planes(mirrors, slots, src)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"score_planes shape/dtype {tuple(got.shape)} {got.dtype}")
                diff = int((got.long() - want.long()).abs().max())
                worst = max(worst, diff)
                n_checks += 1
                if diff:
                    raise AssertionError(f"score_planes != plain: fragments={len(rows)} "
                                         f"rows={rows[:4]} slots={tname} src={sname} diff={diff}")
        del mirrors, srcs
    log(f"phase 3: score_planes == plain on {n_checks} cases (max_abs_err {worst}): 1, 3 and "
        f"{N_SLICES} fragments, mirror rows {K4_ROWS} mixed in one launch, candidate lists "
        "1, 13, 17 and every row with -1 pads, self-src and row-src, all-zero and all-ones src")
    return float(worst)


def k4_bound_ms(n: int, cands: int, src_in_cands: bool, hbm: float) -> tuple[float, str]:
    """Least time for one K4 launch over n fragments of ``cands`` real
    candidates: each distinct row read once, 128 KiB apiece — the
    candidates, and the src row unless it is one of them (self-src on a
    candidate row) — the table of addresses and slots read once, 4 bytes
    written per score; 3 int ops per word."""
    rows = n * (cands + (0 if src_in_cands else 1))
    nbytes = rows * 32768 * 4 + n * (2 + cands) * 8 + n * cands * 4
    t_bytes = nbytes / hbm
    t_ops = n * cands * 32768 * 3 / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_k4(sp, fp, hbm: float) -> dict:
    """K4 at [954 fragments, R candidates] for R in K4_TIMED — every row of
    R-row mirrors against each mirror's row 0 (self-src, as in
    TopN(Bitmap(frame=f, rowID=0), frame=f)) — back to back, by profiler
    device time, its plain version and its bound; and K1 at the shape it
    had on TopN until now, one launch per fragment ([R, 32768] against a
    broadcast src row)."""
    out = {}
    for cands in K4_TIMED:
        mirrors = k4_mirrors([cands] * N_SLICES, SEED + 30 + cands)
        slots = np.tile(np.arange(cands, dtype=np.int64), (N_SLICES, 1))
        srcs = [m[0] for m in mirrors]
        k_ms = time_cuda(lambda: sp.score_planes(mirrors, slots, srcs), runs=11, per_run=10)
        k_dev = device_ms(lambda: sp.score_planes(mirrors, slots, srcs), "score_planes_kernel",
                          launches=20)
        plain_ms = time_cuda(lambda: sp.plain_score_planes(mirrors, slots, srcs), runs=3,
                             per_run=2, warmup=1)
        bound_ms, bound_by = k4_bound_ms(N_SLICES, cands, True, hbm)  # src = candidate 0
        m0 = mirrors[0]
        k1_ms = time_cuda(lambda: fp.row_popcounts(m0, m0[:1], "and"))
        k1_dev = device_ms(lambda: fp.row_popcounts(m0, m0[:1], "and"), "fused_popcount_kernel")
        k1_bound, k1_by = k1_bound_ms(cands, True, True, hbm)
        out[cands] = {"ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "k1_ms": k1_ms, "k1_device_ms": k1_dev, "k1_bound_ms": k1_bound,
                      "k1_bound_by": k1_by}
        share = bound_ms / k_dev if k_dev else float("nan")
        log(f"phase 4: score_planes [{N_SLICES}, {cands}] self-src: {k_ms:.4f} ms back to back, "
            f"device time per launch from the profiler {k_dev} ms ({share:.1%} of the bound), "
            f"bound {bound_ms:.4f} ms by {bound_by}, plain {plain_ms:.4f} ms")
        log(f"phase 4: fused_popcount at the per-fragment TopN shape [{cands}, 32768] against a "
            f"broadcast src: {k1_ms:.4f} ms back to back, device {k1_dev} ms, bound "
            f"{k1_bound:.6f} ms by {k1_by} (x {N_SLICES} launches and host syncs per phase)")
        del mirrors, srcs
    return out


# --- K5 and K6: the anchored count and the payload expansion -------------------

K56_SLICES = (1, 7, N_SLICES)
# Phase 4's K6 payloads: 954 rows of each format at these sizes.
K6_SPARSE_POSITIONS = 4096
K6_RLE_RUNS = 1024
# Phase 4's K5: an anchor of 32,768 positions (a dense-format leaf's bits), a
# sparse leaf of 16,384 positions and an RLE leaf of 8,192 runs per slice.
K5_ANCHOR = 32768
K5_SPARSE = 16384
K5_RUNS = 8192


def k56_row(bp, rng, kind: int) -> np.ndarray:
    """Sorted in-slice positions of one test row; ``kind`` cycles through
    scattered (positions format), clustered runs (RLE), a row past the
    sparse cap (dense format), the edges 0 / 31 / 32 / 2^20 - 1, a run
    ending at 2^20, one position, and the empty row."""
    sw = bp.SLICE_WIDTH
    k = kind % 7
    if k == 0:
        offs = rng.choice(sw, size=int(rng.integers(1, 4000)), replace=False)
    elif k == 1:
        starts = np.sort(rng.choice(sw // 64, size=int(rng.integers(1, 900)), replace=False)) * 64
        offs = (starts[:, None] + np.arange(int(rng.integers(1, 60)))[None, :]).ravel()
    elif k == 2:
        offs = rng.choice(sw, size=40_000, replace=False)
    elif k == 3:
        offs = np.array([0, 31, 32, sw - 1])
    elif k == 4:
        offs = np.arange(sw - int(rng.integers(1, 3000)), sw)
    elif k == 5:
        offs = np.array([int(rng.integers(0, sw))])
    else:
        offs = np.array([], np.int64)
    return np.unique(offs).astype(np.uint32)


def k56_payload(bp, offs: np.ndarray, fmt: int | None = None):
    """(fmt, int32 device payload of real entries) of a row, in its
    encode_row format or in ``fmt``."""
    if fmt is None:
        fmt, payload, _ = bp.encode_row(offs)
        real = bp.payload_entries(fmt, payload)
    elif fmt == bp.FMT_SPARSE:
        real = offs
    elif fmt == bp.FMT_RLE:
        real = bp.np_positions_to_runs(offs)
    else:
        real = bp.np_columns_to_row(offs)
    return fmt, bp.to_device(np.ascontiguousarray(real, dtype=np.uint32), "cuda")


def check_k6(ep, bp, rng) -> float:
    """K6 against its plain version on the card, exactly: 1, 7 and 954
    rows and 954 rows of each format in one launch, every kind of
    :func:`k56_row` (the edges, a run ending at 2^20, empty payloads),
    each row also forced into the other two formats; and the dense rows
    equal to numpy's.  Returns the largest absolute difference (0)."""
    import torch

    worst, n_checks = 0, 0
    groups = [[(k, None) for k in range(n)] for n in K56_SLICES]
    groups += [[(k, f) for k in range(N_SLICES)] for f in (bp.FMT_DENSE, bp.FMT_SPARSE, bp.FMT_RLE)]
    for group in groups:
        offs = [k56_row(bp, rng, k) for k, _ in group]
        jobs_in = [k56_payload(bp, o, f) for o, (_, f) in zip(offs, group)]
        got = torch.full((len(group), 32768), -1, dtype=torch.int32, device="cuda")
        want = torch.full_like(got, 5)
        before = ep.launches
        ep.expand_payloads([(f, p, got[i]) for i, (f, p) in enumerate(jobs_in)])
        torch.cuda.synchronize()
        if ep.launches != before + 1:
            raise AssertionError(f"expand_payload: {ep.launches - before} launches for one call")
        ep.plain_expand([(f, p, want[i]) for i, (f, p) in enumerate(jobs_in)])
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        worst = max(worst, diff)
        host = bp.to_host(got)
        for i, o in enumerate(offs):
            if not np.array_equal(host[i], bp.np_columns_to_row(o)):
                raise AssertionError(f"expand_payload row {i} != numpy ({len(o)} positions)")
        n_checks += 1
        if diff:
            raise AssertionError(f"expand_payload != plain: {len(group)} rows, diff {diff}")
    log(f"phase 3: expand_payload == plain and numpy on {n_checks} launches (max_abs_err "
        f"{worst}): 1, 7 and {N_SLICES} rows of mixed formats, {N_SLICES} rows of each format; "
        "edges 0/31/32/2^20-1, runs ending at 2^20, empty payloads")
    return float(worst)


def k5_deep_tree(levels: int) -> tuple:
    """Union(l0, Intersect(l1, Xor(l2, Difference(l3, Union(l0, ...))))):
    each level keeps one more mask on K5's stack."""
    ops = ("Union", "Intersect", "Xor", "Difference")
    expr = ("leaf", levels % 4)
    for k in reversed(range(levels)):
        expr = (ops[k % 4], ("leaf", k % 4), expr)
    return expr


K5_TREES = (
    ("Intersect", ("leaf", 0), ("leaf", 1), ("leaf", 2)),
    ("Difference", ("leaf", 0), ("Union", ("leaf", 1), ("leaf", 2), ("leaf", 3))),
    ("Intersect", ("leaf", 0), ("Xor", ("leaf", 1), ("leaf", 3))),
    ("Intersect", ("leaf", 2), ("Union",)),
    ("Difference", ("leaf", 3)),
    ("Intersect", ("leaf", 1), k5_deep_tree(9)),  # 11 masks deep
)


def check_k5(ac, bp, plan, rng) -> float:
    """K5 against its plain version on the card, exactly: 1, 7 and 954
    slices; 4 leaves a slice drawn from every kind of :func:`k56_row` in
    its own format (dense words, positions, runs; the edges; empty
    payloads) and absent rows, so every format mix meets in one launch;
    anchors of 32,768 positions, 1 position, none, and the last 300
    positions up to 2^20 - 1; six trees, one 11 masks deep.  Returns the
    largest absolute difference (0)."""
    import torch

    sw = bp.SLICE_WIDTH
    worst, n_checks = 0, 0
    for n in K56_SLICES:
        leaves, anchors = [], []
        for s in range(n):
            row = []
            for i in range(4):
                k = int(rng.integers(0, 8))
                row.append(None if k == 7 else k56_payload(bp, k56_row(bp, rng, k)))
            leaves.append(row)
            a = s % 4
            anchors.append(np.sort(rng.choice(sw, size=K5_ANCHOR, replace=False)) if a == 0
                           else np.array([sw - 1]) if a == 1 else np.array([], np.int64)
                           if a == 2 else np.arange(sw - 300, sw))
        offsets = np.zeros(n + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([len(a) for a in anchors])
        positions = np.concatenate(anchors).astype(np.uint32)
        if not len(positions):  # one slice, empty anchor: give it one position
            positions, offsets[-1] = np.array([0], np.uint32), 1
        for expr in K5_TREES:
            before = ac.launches
            got = plan.anchored_count(expr, positions, offsets, leaves, "cuda")
            torch.cuda.synchronize()
            if ac.launches != before + 1:
                raise AssertionError(f"anchored_count: {ac.launches - before} launches")
            want = ac.plain_anchored_count(plan.compile_program(expr), positions, offsets,
                                           leaves, "cuda")
            torch.cuda.synchronize()
            diff = int((got.long() - want.long()).abs().max())
            worst = max(worst, diff)
            n_checks += 1
            if diff:
                raise AssertionError(f"anchored_count != plain: {n} slices, {expr}, diff {diff}")
    log(f"phase 3: anchored_count == plain on {n_checks} launches (max_abs_err {worst}): 1, 7 "
        f"and {N_SLICES} slices x 4 leaves of every format and absent rows mixed in one launch, "
        "anchors of 32,768, 1 and 0 positions and up to 2^20 - 1, six trees (one 11 deep)")
    return float(worst)


def k6_bound_ms(payload_bytes: int, rows: int, hbm: float) -> tuple[float, str]:
    """Least time for one K6 launch: the payloads and the table read once,
    128 KiB written per row."""
    nbytes = payload_bytes + rows * 32 + rows * 32768 * 4
    return nbytes / hbm * 1e3, "bytes"


def k5_bound_ms(positions: int, leaf_bytes: int, slices: int, leaves: int,
                hbm: float) -> tuple[float, str]:
    """Least time for one K5 launch, as the JAX package's eff_bytes counts
    it: the anchor (4 B a position) and every leaf's encoded bytes read
    once, plus the table, 4 B out per slice."""
    nbytes = 4 * positions + leaf_bytes + slices * (8 + 24 * leaves) + 4 * slices
    return nbytes / hbm * 1e3, "bytes"


def time_k6(ep, bp, rng, hbm: float) -> dict:
    """K6 over 954 payloads of each format — positions (K6_SPARSE_POSITIONS
    each), runs (K6_RLE_RUNS each) and dense words — back to back, by
    profiler device time, its plain version, its bound, and for the
    positions format the library call ``Tensor.scatter_add_`` of the
    one-bit masks into a zero plane."""
    import torch

    sw = bp.SLICE_WIDTH
    forms = {}
    sp = np.sort(np.stack([rng.choice(sw, size=K6_SPARSE_POSITIONS, replace=False)
                           for _ in range(N_SLICES)]), axis=1).astype(np.uint32)
    forms["sparse"] = [(bp.FMT_SPARSE, bp.to_device(sp[i], "cuda")) for i in range(N_SLICES)]
    runs = []
    for _ in range(N_SLICES):
        starts = np.sort(rng.choice(sw // 512, size=K6_RLE_RUNS, replace=False)) * 512
        ends = starts + rng.integers(1, 500, K6_RLE_RUNS)
        runs.append(np.stack([starts, ends], 1).astype(np.uint32))
    forms["rle"] = [(bp.FMT_RLE, bp.to_device(r, "cuda")) for r in runs]
    dense = bp.to_device(rng.integers(0, 2**32, size=(N_SLICES, 32768), dtype=np.uint32), "cuda")
    forms["dense"] = [(bp.FMT_DENSE, dense[i]) for i in range(N_SLICES)]
    out_rows = torch.empty(N_SLICES, 32768, dtype=torch.int32, device="cuda")
    out = {}
    for name, items in forms.items():
        jobs = [(f, p, out_rows[i]) for i, (f, p) in enumerate(items)]
        k_ms = time_cuda(lambda: ep.expand_payloads(jobs), runs=11, per_run=10)
        k_dev = device_ms(lambda: ep.expand_payloads(jobs), "expand_payload_kernel", launches=20)
        plain_ms = time_cuda(lambda: ep.plain_expand(jobs), runs=3, per_run=2, warmup=1)
        nbytes = sum(p.numel() * 4 for _, p in items)
        bound_ms, bound_by = k6_bound_ms(nbytes, N_SLICES, hbm)
        lib_ms = None
        if name == "sparse":
            flat = torch.from_numpy((np.arange(N_SLICES)[:, None] * 32768
                                     + (sp >> 5)).ravel().astype(np.int64)).cuda()
            masks = torch.from_numpy((np.int64(1) << (sp & 31).astype(np.int64)).ravel()).cuda()
            zero = torch.zeros(N_SLICES * 32768, dtype=torch.int64, device="cuda")
            lib_ms = time_cuda(lambda: zero.clone().scatter_add_(0, flat, masks), runs=11,
                               per_run=10)
        out[name] = {"ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms, "payload_bytes": nbytes}
        share = bound_ms / k_dev if k_dev else float("nan")
        log(f"phase 4: expand_payload {N_SLICES} x {name}: {k_ms:.4f} ms back to back, device "
            f"{k_dev} ms ({share:.1%} of the bound), bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes} payload bytes in, {N_SLICES} x 128 KiB out), plain {plain_ms:.4f} ms"
            + (f", scatter_add_ {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return out


def time_k5(ac, bp, plan, rng, hbm: float) -> dict:
    """K5 at [954 slices, 32,768-position anchors, three leaves: dense,
    sparse, RLE]: the dense leaf a row of a 954-row mirror (read in
    place, as a plane row is), whose 32,768 bits are the anchor; a
    K5_SPARSE-position leaf and a K5_RUNS-run leaf; back to back, device
    time, plain version, bound."""
    import torch

    sw = bp.SLICE_WIDTH
    anchors = np.sort(np.stack([rng.choice(sw, size=K5_ANCHOR, replace=False)
                                for _ in range(N_SLICES)]), axis=1).astype(np.uint32)
    mirror = np.zeros((N_SLICES, 32768), np.uint32)
    for s in range(N_SLICES):
        np.bitwise_or.at(mirror[s], anchors[s] >> 5,
                         (np.uint32(1) << (anchors[s] & 31)).astype(np.uint32))
    dev_mirror = bp.to_device(mirror, "cuda")
    sparse = np.sort(np.stack([rng.choice(sw, size=K5_SPARSE, replace=False)
                               for _ in range(N_SLICES)]), axis=1).astype(np.uint32)
    leaves = []
    for s in range(N_SLICES):
        starts = np.sort(rng.choice(sw // 128, size=K5_RUNS, replace=False)) * 128
        runs = np.stack([starts, starts + rng.integers(1, 100, K5_RUNS)], 1).astype(np.uint32)
        leaves.append([(bp.FMT_DENSE, dev_mirror[s]),
                       (bp.FMT_SPARSE, bp.to_device(sparse[s], "cuda")),
                       (bp.FMT_RLE, bp.to_device(runs, "cuda"))])
    offsets = np.arange(N_SLICES + 1, dtype=np.int64) * K5_ANCHOR
    positions = anchors.ravel()
    expr = K5_TREES[0]
    program = plan.compile_program(expr)
    k_ms = time_cuda(lambda: ac.anchored_count(program, positions, offsets, leaves, "cuda"),
                     runs=11, per_run=5)
    k_dev = device_ms(lambda: ac.anchored_count(program, positions, offsets, leaves, "cuda"),
                      "anchored_count_kernel", launches=20)
    plain_ms = time_cuda(lambda: ac.plain_anchored_count(program, positions, offsets, leaves,
                                                         "cuda"), runs=3, per_run=1, warmup=1)
    # Encoded bytes as the JAX package's eff_bytes counts them: a dense row
    # 128 KiB, positions and runs at their bucketed payload sizes.
    leaf_bytes = N_SLICES * (32768 * 4 + 4 * bp.payload_bucket(K5_SPARSE)
                             + 8 * bp.payload_bucket(K5_RUNS))
    bound_ms, bound_by = k5_bound_ms(len(positions), leaf_bytes, N_SLICES, 3, hbm)
    share = bound_ms / k_dev if k_dev else float("nan")
    log(f"phase 4: anchored_count [{N_SLICES} slices, {K5_ANCHOR}-position anchors, leaves "
        f"dense / {K5_SPARSE} positions / {K5_RUNS} runs]: {k_ms:.4f} ms back to back, device "
        f"{k_dev} ms ({share:.1%} of the bound), bound {bound_ms:.4f} ms by {bound_by}, "
        f"plain {plain_ms:.4f} ms")
    return {"ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def http(host: str, method: str, path: str, body: bytes = b"") -> tuple[int, object]:
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def topn_oracle(scores: np.ndarray, n: int, totals: np.ndarray | None = None,
                threshold: int = 1, tanimoto: int = 0, src_counts: np.ndarray | None = None,
                ids=None) -> list[dict]:
    """The TopN protocol over per-slice scores [slices, rows] (``totals``:
    each row's count, the ranked cache's; the scores themselves without
    a src): a (slice, row) is eligible where the row's count passes the
    candidate filter (>= threshold, or inside the tanimoto window of the
    slice's src count) and its score does (> 0 and >= threshold, or a
    tanimoto score above the threshold); each slice's winners are its n
    best eligible rows (count desc, id asc); a winner's count is the sum
    of its eligible scores, sorted and trimmed to n.  With ``ids`` the
    winners are those ids, untrimmed."""
    totals = scores if totals is None else totals
    if tanimoto:
        sc = src_counts.astype(np.int64)[:, None]
        cand = ((totals > 0) & (totals > sc * tanimoto / 100)
                & (totals < sc * 100 / tanimoto))
        with np.errstate(divide="ignore", invalid="ignore"):
            tan = np.ceil(scores * 100.0 / (totals + sc - scores))
        keep = cand & (scores > 0) & (tan > tanimoto)
    else:
        keep = (totals > 0) & (totals >= threshold) & (scores > 0) & (scores >= threshold)
    if ids is not None:
        winners = {int(r) for r in ids if r < scores.shape[1]}
    else:
        winners = set()
        for row, ok in zip(scores, keep):
            order = [r for r in np.lexsort((np.arange(len(row)), -row)) if ok[r]]
            winners.update(int(r) for r in order[:n])
    pairs = [(r, int(scores[keep[:, r], r].sum())) for r in sorted(winners)]
    pairs = [p for p in pairs if p[1] > 0]
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return [{"id": i, "count": c} for i, c in (pairs if ids is not None else pairs[:n])]


def serve_and_check(fp, ds, sp, bp, convert, srv, rng) -> dict:
    """Phase 5 on ``srv``, an open one-node ``Server`` on the card, which
    stays open for phases 7-8."""
    import torch

    out: dict = {}
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
    set_times = []
    for r, c in g_bits:
        q0 = time.perf_counter()
        status, body = http(
            h, "POST", "/index/i/query",
            f"SetBit(frame=g, rowID={r}, columnID={c})".encode(),
        )
        set_times.append(time.perf_counter() - q0)
        if status != 200 or body["results"] != [True]:
            raise AssertionError(f"SetBit g {r} {c}: {status} {body}")
    g_row1 = sorted(c for r, c in g_bits if r == 1)
    out["setbit_p50_ms"] = statistics.median(set_times) * 1e3
    log(f"phase 5: SetBit p50 {out['setbit_p50_ms']:.3f} ms over {len(g_bits)} requests, each "
        "answered after its WAL group commit (2 ms window); PR 6 wrote no WAL and timed none")

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
        # The folded TopN: one K4 launch scores every fragment, no K1.
        ("topn_src", "TopN(Bitmap(frame=f, rowID=0), frame=f, n=5)",
         topn_oracle(src_scores, 5), 0),
    ]
    k4_per_query = {"topn_src": 1}

    fp.launches = ds.launches = sp.launches = 0  # the main path starts here
    expected_launches = expected_k4 = 0
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
        expected_k4 += REPS * k4_per_query.get(name, 0)

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
    k7_launches = ds.launches
    k4_launches = sp.launches
    if k4_launches != expected_k4:
        raise AssertionError(f"score_planes launches {k4_launches} != expected {expected_k4}")
    if launches != expected_launches:
        raise AssertionError(
            f"fused_popcount launches {launches} != expected {expected_launches}"
        )
    # The SetBit queued its delta; the Count applied it with one K7.
    if k7_launches != 1:
        raise AssertionError(f"delta_scatter launches {k7_launches} != expected 1")
    out["launches"] = launches
    out["k7_launches"] = k7_launches
    out["k4_launches"] = k4_launches
    for name, ms in latencies.items():
        log(f"phase 5: {name} p50 {ms:.3f} ms over {REPS} requests")
    log(f"phase 5: answers == numpy oracle; fused_popcount launches {launches} "
        f"(expected {expected_launches}); delta_scatter launches {k7_launches} "
        "(the SetBit's delta, applied by the next Count); score_planes launches "
        f"{k4_launches} (one per TopN(src) request)")

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
    out["planes"] = planes
    return out


def set_bits(truth: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> None:
    """OR (row, column) bits into the oracle planes [slices, rows, words]."""
    offs = cols & 0xFFFFF
    masks = (np.uint32(1) << (offs & 31).astype(np.uint32)).astype(np.uint32)
    np.bitwise_or.at(truth, (cols >> 20, rows, offs >> 5), masks)


def cluster_and_check(fp, ds, br, sp, scatter, convert, Server, InternalClient, planes,
                      rng) -> dict:
    """Phase 6: three nodes, two replicas, import + queries + fallback +
    failover, and the BSI leg (a field created on one node, values to
    every owner, aggregates and comparisons from every node, again with a
    node closed), every answer against the numpy oracle."""
    import torch

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-cluster-") as data_dir:
        nodes = [
            Server(f"{data_dir}/n{i}", host="127.0.0.1:0", device="cuda",
                   cluster_type="http", replicas=2, internal_port=0)
            for i in range(3)
        ]
        opened = []
        try:
            for srv in nodes:
                srv.open()
                opened.append(srv)
            for srv in nodes:
                for other in nodes:
                    if other is not srv:
                        srv.add_peer(other.host, other.internal_host)
            h0 = nodes[0].host
            for path in ("/index/i", "/index/i/frame/f"):
                status, body = http(h0, "POST", path)
                if status != 200:
                    raise AssertionError(f"POST {path}: {status} {body}")
            for srv in nodes:  # the broadcast is synchronous
                if srv.holder.frame("i", "f") is None:
                    raise AssertionError(f"schema did not reach {srv.host}")

            cluster = nodes[0].cluster
            owned: dict[str, dict] = {srv.host: {} for srv in nodes}
            for sl in range(N_SLICES):
                for owner in cluster.fragment_nodes("i", sl):
                    owned[owner.host][sl] = planes[sl]
            t0 = time.perf_counter()
            for srv in nodes:
                convert.load_planes(srv.holder, "i", "f", "standard", owned[srv.host])
            torch.cuda.synchronize()
            for srv in nodes:
                srv.tick_max_slices()
                if srv.holder.index("i").max_slice() != N_SLICES - 1:
                    raise AssertionError(f"{srv.host} does not know the max slice")
            log(f"phase 6: 3 nodes, 2 replicas: {sum(len(v) for v in owned.values())} "
                f"fragments loaded in {time.perf_counter() - t0:.3f}s "
                f"({', '.join(str(len(v)) for v in owned.values())} per node); device "
                f"memory allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")

            truth = planes.copy()
            rows = rng.integers(0, ROWS, IMPORT_BITS)
            cols = rng.integers(0, N_SLICES << 20, IMPORT_BITS)
            set_bits(truth, rows, cols)
            touched = 2 * len(np.unique(cols >> 20))  # fragment replicas

            fp.launches = ds.launches = sp.launches = 0  # the main path starts here
            br.launches = dict.fromkeys(br.KERNELS, 0)
            fb0 = scatter.counters()["fallbackInvalidations"]
            client = InternalClient(h0, timeout=600)
            t0 = time.perf_counter()
            client.import_bits("i", "f", rows, cols)
            torch.cuda.synchronize()
            import_s = time.perf_counter() - t0
            k7_import, k1_import = ds.launches, fp.launches
            fb_import = scatter.counters()["fallbackInvalidations"] - fb0
            pending = sum(1 for srv in nodes for sl in range(N_SLICES)
                          if (fr := srv.holder.fragment("i", "f", "standard", sl)) is not None
                          and fr._pending_n)
            # The write path stays off the card: the bits queue on the host.
            if k7_import or k1_import or fb_import or pending != touched:
                raise AssertionError(
                    f"import 1: delta_scatter launches {k7_import}, fused_popcount launches "
                    f"{k1_import}, fallbacks {fb_import} (want 0, 0, 0); {pending} fragment "
                    f"replicas with queued bits (want {touched})")
            out["import_s"] = import_s
            log(f"phase 6: import of {IMPORT_BITS} bits ({IMPORT_BITS / N_SLICES:.0f} per "
                f"slice) over protobuf /import in {import_s:.3f}s: delta_scatter launches "
                f"{k7_import}, fused_popcount launches {k1_import}, fallbacks {fb_import}; "
                f"{pending} fragment replicas queued their bits")

            def pc(x):
                return int(np.bitwise_count(x).sum())

            t_rows = [truth[:, r] for r in range(3)]
            row_totals = np.bitwise_count(truth).sum(axis=-1, dtype=np.int64)
            src_scores = np.bitwise_count(truth & truth[:, :1]).sum(axis=-1, dtype=np.int64)
            b = "Bitmap(frame=f, rowID={})"
            counts = [
                ("count_bitmap", f"Count({b.format(0)})", pc(t_rows[0])),
                ("count_intersect", f"Count(Intersect({b.format(0)}, {b.format(1)}))",
                 pc(t_rows[0] & t_rows[1])),
                ("count_union3", f"Count(Union({b.format(0)}, {b.format(1)}, {b.format(2)}))",
                 pc(t_rows[0] | t_rows[1] | t_rows[2])),
            ]
            topns = [
                ("topn", "TopN(frame=f, n=5)", topn_oracle(row_totals, 5)),
                ("topn_src", f"TopN({b.format(0)}, frame=f, n=5)", topn_oracle(src_scores, 5)),
            ]

            def ask(host: str, fmt: str, pql: str):
                if fmt == "json":
                    status, body = http(host, "POST", "/index/i/query", pql.encode())
                    if status != 200:
                        raise AssertionError(f"{pql} at {host}: {status} {body}")
                    return body["results"][0]
                (res,) = InternalClient(host, timeout=600).execute_query("i", pql)
                if isinstance(res, list) and pql.startswith(("Sum(", "Min(", "Max(")):
                    # A ValCount rides one Pair: the value u64-wrapped.
                    (p,) = res
                    return {"value": p.id - (1 << 64) if p.id >= 1 << 63 else p.id,
                            "count": p.count}
                if isinstance(res, list):
                    return [{"id": p.id, "count": p.count} for p in res]
                return res

            def run(queries, hosts, reps) -> dict[str, float]:
                p50 = {}
                for name, pql, want in queries:
                    times = []
                    for host in hosts:
                        for fmt in ("protobuf", "json"):
                            for _ in range(reps):
                                q0 = time.perf_counter()
                                got = ask(host, fmt, pql)
                                times.append(time.perf_counter() - q0)
                                if got != want:
                                    raise AssertionError(
                                        f"{name} at {host} ({fmt}): {str(got)[:300]} != {want}")
                    p50[name] = statistics.median(times) * 1e3
                return p50

            hosts = [srv.host for srv in nodes]
            # The first read after the import: each node's leg applies the
            # queues of the fragments it reads in one K7 launch.
            legs = len(nodes[0].executor._slices_by_node(cluster.nodes, "i",
                                                          list(range(N_SLICES))))
            t0 = time.perf_counter()
            got = ask(h0, "json", counts[0][1])
            out["first_count_ms"] = (time.perf_counter() - t0) * 1e3
            if got != counts[0][2] or not 1 <= ds.launches <= legs:
                raise AssertionError(f"first Count after import 1: {got} (want {counts[0][2]}), "
                                     f"delta_scatter launches {ds.launches} (want 1..{legs})")
            log(f"phase 6: the first Count after the import {out['first_count_ms']:.3f} ms: "
                f"delta_scatter launches {ds.launches} (at most one per node leg: {legs} legs)")
            k4_before = sp.launches
            latencies = run(counts + topns, hosts, CLUSTER_REPS)
            # TopN(src) from any node: the two rounds of the map/reduce, each
            # leg one K4 launch over the node's fragments.
            want_k4 = 3 * 2 * CLUSTER_REPS * 2 * legs
            if sp.launches - k4_before != want_k4:
                raise AssertionError(f"phase 6 TopN(src): score_planes launches "
                                     f"{sp.launches - k4_before} != {want_k4} (2 rounds x "
                                     f"{legs} node legs x {3 * 2 * CLUSTER_REPS} requests)")
            out["k4_legs"] = legs
            for name, ms in latencies.items():
                log(f"phase 6: {name} p50 {ms:.3f} ms over {3 * 2 * CLUSTER_REPS} requests "
                    "(3 nodes x protobuf and JSON)")

            # The BSI leg: a range-enabled frame and a field created on node
            # 0 reach the others (the field by its HTTP fan-out); values go
            # to every owner of the first CLUSTER_BSI_SLICES slices.
            for path, body in (("/index/i/frame/n", b'{"options": {"rangeEnabled": true}}'),
                               ("/index/i/frame/n/field/w", b'{"min": -1000, "max": 1000}')):
                status, resp = http(h0, "POST", path, body)
                if status != 200:
                    raise AssertionError(f"POST {path}: {status} {resp}")
            want_fields = [{"name": "w", "type": "int", "min": -1000, "max": 1000}]
            for srv in nodes:
                if InternalClient(srv.host, timeout=600).frame_fields("i", "n") != want_fields:
                    raise AssertionError(f"field w did not reach {srv.host}")
            wcols = rng.choice(CLUSTER_BSI_SLICES << 20, CLUSTER_BSI_VALUES, replace=False)
            wvals = rng.integers(-1000, 1001, CLUSTER_BSI_VALUES)
            wvals[:3] = -1000, 1000, 0
            t0 = time.perf_counter()
            sent = client.import_values("i", "n", "w", wcols, wvals)
            wimport_s = time.perf_counter() - t0
            if sent != list(range(CLUSTER_BSI_SLICES)):
                raise AssertionError(f"/import-value sent slices {sent}")
            log(f"phase 6: /import-value of {CLUSTER_BSI_VALUES} values over "
                f"{CLUSTER_BSI_SLICES} slices to every owner in {wimport_s:.3f}s")
            f1 = (t_rows[1][wcols >> 20, (wcols & 0xFFFFF) >> 5] >> (wcols & 31)) & 1 == 1

            def vc(vals, pick):
                v = int(pick(vals))
                return {"value": v, "count": int((vals == v).sum())}

            bsi_counts = [
                ("count_range_gt", "Count(Range(frame=n, w > 17))", int((wvals > 17).sum())),
                ("count_range_between", "Count(Range(frame=n, w >< [-250, 250]))",
                 int(((wvals >= -250) & (wvals <= 250)).sum())),
                ("count_intersect_range", f"Count(Intersect({b.format(1)}, Range(frame=n, w < 0)))",
                 int((f1 & (wvals < 0)).sum())),
            ]
            bsi_aggs = [
                ("sum", "Sum(frame=n, field=w)", {"value": int(wvals.sum()), "count": len(wvals)}),
                ("min", "Min(frame=n, field=w)", vc(wvals, np.min)),
                ("max", "Max(frame=n, field=w)", vc(wvals, np.max)),
                ("max_filtered", f"Max({b.format(1)}, frame=n, field=w)", vc(wvals[f1], np.max)),
            ]
            bsi_lat = run(bsi_counts + bsi_aggs, hosts, CLUSTER_REPS)
            latencies.update(bsi_lat)
            for name, ms in bsi_lat.items():
                log(f"phase 6: {name} p50 {ms:.3f} ms over {3 * 2 * CLUSTER_REPS} requests "
                    "(3 nodes x protobuf and JSON)")

            # Bits in new rows: every touched plane grows past its padded
            # rows, so each fragment replica drops its mirror (counted).
            rows2 = rng.integers(ROWS, 2 * ROWS, FALLBACK_IMPORT_BITS)
            cols2 = rng.integers(0, N_SLICES << 20, FALLBACK_IMPORT_BITS)
            touched2 = 2 * len(np.unique(cols2 >> 20))
            k7_before = ds.launches
            t0 = time.perf_counter()
            client.import_bits("i", "f", rows2, cols2)
            torch.cuda.synchronize()
            import2_s = time.perf_counter() - t0
            fb2 = scatter.counters()["fallbackInvalidations"] - fb0
            if fb2 != touched2 or ds.launches != k7_before:
                raise AssertionError(
                    f"import 2: fallbacks {fb2} (want {touched2}), delta_scatter launches "
                    f"{ds.launches - k7_before} (want 0)")
            log(f"phase 6: import of {FALLBACK_IMPORT_BITS} bits into new rows "
                f"{ROWS}-{2 * ROWS - 1} in {import2_s:.3f}s: fallbacks {fb2} (one per "
                "fragment replica), no delta_scatter launch")
            new_r = np.unique(cols2[rows2 == ROWS])
            in_r0 = (t_rows[0][new_r >> 20, (new_r & 0xFFFFF) >> 5] >> (new_r & 31)) & 1
            counts.append((f"count_row{ROWS}", f"Count({b.format(ROWS)})", len(new_r)))
            counts.append((
                f"count_union_0_{ROWS}", f"Count(Union({b.format(0)}, {b.format(ROWS)}))",
                pc(t_rows[0]) + len(new_r) - int(in_r0.sum())))
            run(counts[-2:], hosts, 1)

            # Failover: close one node; the others answer from the replicas.
            nodes[2].close()
            failover = run(counts + bsi_counts + bsi_aggs, hosts[:2], 1)
            for name, ms in failover.items():
                log(f"phase 6: {name} with {hosts[2]} closed p50 {ms:.3f} ms "
                    "(2 nodes x protobuf and JSON)")
            out["launches"] = fp.launches  # the main path ends here
            out["k7_launches"] = ds.launches
            out["k8_launches"] = dict(br.launches)
            out["k4_launches"] = sp.launches
            if out["k4_launches"] != want_k4:
                raise AssertionError(f"phase 6: score_planes launches {out['k4_launches']} "
                                     f"!= {want_k4}")
            if not out["k7_launches"]:
                raise AssertionError("phase 6 launched no delta_scatter")
            if not all(out["k8_launches"].values()):
                raise AssertionError(f"phase 6 left a K8 kernel unlaunched: {out['k8_launches']}")
            log(f"phase 6: answers == numpy oracle; fused_popcount launches "
                f"{out['launches']}, delta_scatter launches {out['k7_launches']}, "
                f"bsi_ripple launches {out['k8_launches']}, score_planes launches "
                f"{out['k4_launches']} (one per node leg and round: {legs} legs)")
            out["latencies_ms"] = latencies
        finally:
            for srv in opened:
                srv.close()
    return out


def bsi_planes(rng, n_slices: int) -> np.ndarray:
    """uint32 [n_slices, 2 + 31, 32768] planes of a signed 32-bit field,
    generated word by word: ~50% of columns valued, magnitudes masked to
    exists, the sign cleared where the magnitude is zero."""
    planes = rng.integers(0, 2**32, size=(n_slices, 2 + K8_DEPTH, 32768), dtype=np.uint32)
    planes[:, 2:] &= planes[:, :1]
    planes[:, 1] &= planes[:, 0] & np.bitwise_or.reduce(planes[:, 2:], axis=1)
    return planes


def unpack(words: np.ndarray) -> np.ndarray:
    """uint32 words -> one bool per bit, column order."""
    return np.unpackbits(words.view(np.uint8), bitorder="little").view(bool)


def decode_values(planes_s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One slice's field planes -> (valued bool [2^20], values int64
    [2^20]): each column's bits gathered byte by byte with numpy, no
    ripple arithmetic."""
    bits = np.unpackbits(planes_s.view(np.uint8), axis=1, bitorder="little")
    depth = planes_s.shape[0] - 2
    groups = []
    for g in range(0, depth, 8):
        acc = np.zeros(bits.shape[1], dtype=np.uint8)
        for k in range(g, min(g + 8, depth)):
            acc |= bits[2 + k] << np.uint8(k - g)
        groups.append(acc)
    while len(groups) < 4:
        groups.append(np.zeros(bits.shape[1], dtype=np.uint8))
    mag = np.stack(groups, axis=1).view(np.uint32).ravel().astype(np.int64)
    return bits[0].view(bool), np.where(bits[1].view(bool), -mag, mag)


class ValueOracle:
    """Phase 7's numpy oracle: the truth planes of the field (updated with
    every import), each slice decoded column by column, and per slice the
    sorted values overall and under the two filter rows."""

    def __init__(self, planes: np.ndarray, filters: dict):
        self.planes = planes
        self.filters = filters
        self.parts: list = [None] * planes.shape[0]
        self.refresh(range(planes.shape[0]))

    def _slice(self, s: int) -> dict:
        ex, v = decode_values(self.planes[s])
        out = {"all": np.sort(v[ex])}
        for name, rows in self.filters.items():
            out[name] = np.sort(v[ex & unpack(rows[s])])
        return out

    def refresh(self, slices) -> None:
        slices = list(slices)
        with ThreadPoolExecutor(max_workers=8) as pool:
            for s, part in zip(slices, pool.map(self._slice, slices)):
                self.parts[s] = part

    def set_values(self, cols: np.ndarray, vals: np.ndarray) -> list[int]:
        """Write (unique) columns' values into the truth planes; returns
        the touched slices."""
        sl, off = cols >> 20, cols & 0xFFFFF
        word, bit = off >> 5, (np.uint32(1) << (off & 31).astype(np.uint32)).astype(np.uint32)
        mag = np.abs(vals)
        rows = [np.ones(len(cols), bool), vals < 0] + [
            ((mag >> k) & 1).astype(bool) for k in range(K8_DEPTH)]
        for j, on in enumerate(rows):
            np.bitwise_or.at(self.planes, (sl[on], j, word[on]), bit[on])
            np.bitwise_and.at(self.planes, (sl[~on], j, word[~on]), ~bit[~on])
        touched = sorted({int(x) for x in np.unique(sl)})
        self.refresh(touched)
        return touched

    def count(self, op: str, p: int, part: str = "all") -> int:
        n = 0
        for sp in self.parts:
            a = sp[part]
            lo, hi = np.searchsorted(a, p, "left"), np.searchsorted(a, p, "right")
            n += {"<": lo, "<=": hi, "==": hi - lo, "!=": len(a) - (hi - lo),
                  ">=": len(a) - lo, ">": len(a) - hi}[op]
        return int(n)

    def between(self, a: int, b: int, part: str = "all") -> int:
        if a > b:
            return 0
        return int(sum(np.searchsorted(sp[part], b, "right") - np.searchsorted(sp[part], a, "left")
                       for sp in self.parts))

    def agg(self, name: str, part: str = "all"):
        arrs = [sp[part] for sp in self.parts if len(sp[part])]
        if name == "Sum":
            return {"value": int(sum(int(a.sum()) for a in arrs)),
                    "count": int(sum(len(a) for a in arrs))}
        if not arrs:
            return None
        v = min(int(a[0]) for a in arrs) if name == "Min" else max(int(a[-1]) for a in arrs)
        return {"value": v, "count": int(sum(np.searchsorted(a, v, "right")
                                             - np.searchsorted(a, v, "left") for a in arrs))}


def bsi_and_check(fp, ds, br, scatter, convert, InternalClient, srv, f_planes, rng) -> dict:
    """Phase 7 on the phase-5 server: a signed 32-bit field over 954
    slices (~4.13 GB of planes), every comparison, composed counts and
    Sum/Min/Max with and without a filter against the numpy oracle; then
    an /import-value over every slice (the K7 path with and-not entries)
    and one past its queue's limit on one slice (the counted fallback),
    the queries asked again after each."""
    import torch

    from pilosa_tpu_torch.exec import plan as plan_mod

    out: dict = {"launches": {}, "latencies_ms": {}}
    h = srv.host
    for path, body in (("/index/i/frame/n", b'{"options": {"rangeEnabled": true}}'),
                       ("/index/i/frame/n/field/v",
                        b'{"min": -2147483647, "max": 2147483647}')):
        status, resp = http(h, "POST", path, body)
        if status != 200:
            raise AssertionError(f"POST {path}: {status} {resp}")
    t0 = time.perf_counter()
    planes = bsi_planes(rng, N_SLICES)
    t1 = time.perf_counter()
    convert.load_planes(srv.holder, "i", "n", "field_v", {s: planes[s] for s in range(N_SLICES)})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    oracle = ValueOracle(planes, {"f1": f_planes[:, 1], "f2": f_planes[:, 2]})
    t3 = time.perf_counter()
    log(f"phase 7: field v (depth {K8_DEPTH}) over {N_SLICES} slices: planes generated in "
        f"{t1 - t0:.3f}s ({planes.nbytes / 1e9:.3f} GB), loaded in {t2 - t1:.3f}s, oracle "
        f"decoded in {t3 - t2:.3f}s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    hi = (1 << K8_DEPTH) - 1
    drawn = [int(x) for x in rng.integers(-hi, hi + 1, 3)]
    preds = [-hi, hi, 0, 1, -1, -hi - 1, hi + 1, drawn[0]]
    pairs = [(-hi, hi), (-1, 1), (0, 0), (5, 2), (-(1 << 40), 1 << 40), tuple(sorted(drawn[1:]))]
    ops = ("<", "<=", "==", "!=", ">=", ">")
    a, b = sorted(drawn[1:])
    f1, f2 = "Bitmap(frame=f, rowID=1)", "Bitmap(frame=f, rowID=2)"

    def queries():
        """(name, pql, expected, {kernel: launches}) from the oracle now."""
        q = []
        for op in ops:
            for p in preds:
                q.append((f"count v {op} {p}", f"Count(Range(frame=n, v {op} {p}))",
                          oracle.count(op, p), {"bsi_cmp": 1}))
        for lo, up in pairs:
            q.append((f"count v >< [{lo}, {up}]", f"Count(Range(frame=n, v >< [{lo}, {up}]))",
                      oracle.between(lo, up), {"bsi_cmp": 1}))
        q.append(("count_intersect", f"Count(Intersect({f1}, Range(frame=n, v >< [{a}, {b}])))",
                  oracle.between(a, b, "f1"), {"bsi_cmp": 1, "k1": 1}))
        for agg in ("Sum", "Min", "Max"):
            q.append((agg.lower(), f"{agg}(frame=n, field=v)", oracle.agg(agg),
                      {"bsi_sum" if agg == "Sum" else "bsi_minmax": 1}))
            q.append((f"{agg.lower()}_filtered", f"{agg}({f2}, frame=n, field=v)",
                      oracle.agg(agg, "f2"), {"bsi_sum" if agg == "Sum" else "bsi_minmax": 1}))
        return q

    timed = {"count v > %d" % drawn[0], f"count v >< [{a}, {b}]", "count_intersect",
             "sum", "min", "max", "sum_filtered"}

    def ask_all(stage: str) -> None:
        want_k = {"bsi_cmp": 0, "bsi_sum": 0, "bsi_minmax": 0, "k1": 0}
        fp.launches = 0
        br.launches = dict.fromkeys(br.KERNELS, 0)
        for name, pql, want, launches in queries():
            reps = REPS if name in timed and stage == "loaded" else 1
            times = []
            for _ in range(reps):
                q0 = time.perf_counter()
                status, body = http(h, "POST", "/index/i/query", pql.encode())
                times.append(time.perf_counter() - q0)
                if status != 200 or body["results"] != [want]:
                    raise AssertionError(f"phase 7 {stage} {name}: {status} {str(body)[:300]} "
                                         f"!= {want}")
            for k, n in launches.items():
                want_k[k] += n * reps
            if reps > 1:
                out["latencies_ms"][name] = statistics.median(times) * 1e3
        got_k = dict(br.launches, k1=fp.launches)
        if got_k != want_k:
            raise AssertionError(f"phase 7 {stage}: launches {got_k} != expected {want_k}")
        for k, n in br.launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        out["launches"]["k1"] = out["launches"].get("k1", 0) + fp.launches
        log(f"phase 7 {stage}: {len(queries())} queries == numpy oracle; launches {got_k}")

    ask_all("loaded")
    for name, ms in out["latencies_ms"].items():
        log(f"phase 7: {name} p50 {ms:.3f} ms over {REPS} requests")

    # K7 with clears: a spy on the plan's batched scatter counts, per
    # launch, the jobs whose folded entries carry and-not masks.
    real_apply = plan_mod.scatter_apply_many
    andnot_jobs: list[int] = []

    def spy(planes, job, word, or_m, andnot_m):
        andnot_jobs.append(len(np.unique(np.asarray(job)[np.asarray(andnot_m) != 0])))
        return real_apply(planes, job, word, or_m, andnot_m)

    client = InternalClient(h, timeout=600)
    plan_mod.scatter_apply_many = spy
    try:
        cols = rng.choice(N_SLICES << 20, BSI_IMPORT_VALUES, replace=False)
        vals = rng.integers(-hi, hi + 1, BSI_IMPORT_VALUES)
        vals[:256] = 0  # zero stores sign 0, over whatever was there
        ds.launches = fp.launches = 0
        fb0 = scatter.counters()["fallbackInvalidations"]
        t0 = time.perf_counter()
        client.import_values("i", "n", "v", cols, vals)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        fb = scatter.counters()["fallbackInvalidations"] - fb0
        frags = [srv.holder.fragment("i", "n", "field_v", sl) for sl in range(N_SLICES)]
        pending = sum(1 for fr in frags if fr._pending_n)
        # The write path stays off the card: every slice's bits queue.
        if ds.launches or fp.launches or fb or pending != N_SLICES:
            raise AssertionError(f"/import-value 1: delta_scatter launches {ds.launches}, "
                                 f"fused_popcount launches {fp.launches}, fallbacks {fb} (want "
                                 f"0, 0, 0); {pending} fragments queued (want {N_SLICES})")
        oracle.set_values(cols, vals)
        log(f"phase 7: /import-value of {BSI_IMPORT_VALUES} values "
            f"(~{BSI_IMPORT_VALUES * (2 + K8_DEPTH) // N_SLICES} entries per fragment) in "
            f"{import_s:.3f}s: no delta_scatter or fused_popcount launch, fallbacks {fb}; "
            f"{pending} fragments queued their bits")
        # The first read after it applies all of them in one launch.
        first = queries()[0]
        br.launches = dict.fromkeys(br.KERNELS, 0)
        t0 = time.perf_counter()
        status, body = http(h, "POST", "/index/i/query", first[1].encode())
        out["first_count_ms"] = (time.perf_counter() - t0) * 1e3
        k7, k7_andnot = ds.launches, sum(andnot_jobs)
        if status != 200 or body["results"] != [first[2]]:
            raise AssertionError(f"phase 7 first read after import 1: {status} {body}")
        if k7 != 1 or andnot_jobs != [N_SLICES] or any(fr._pending_n for fr in frags):
            raise AssertionError(f"phase 7 first read after import 1: delta_scatter launches "
                                 f"{k7} (want 1), jobs with and-not entries {andnot_jobs} "
                                 f"(want [{N_SLICES}])")
        for k, n in br.launches.items():
            out["launches"][k] += n
        log(f"phase 7: the first Count after the import {out['first_count_ms']:.3f} ms: "
            f"delta_scatter launches {k7}, one batch of {N_SLICES} jobs, {k7_andnot} of them "
            "with and-not entries")
        ask_all("after import 1")
        if ds.launches != k7:
            raise AssertionError(f"phase 7: delta_scatter launches {ds.launches - k7} after "
                                 "the first read (want 0)")

        # One slice past its queue's limit: the mirror is dropped instead.
        mirror_rows = frags[0]._mirror.shape[0]
        n2 = scatter.pending_limit(mirror_rows) // (2 + K8_DEPTH) + 1
        cols2 = rng.choice(1 << 20, n2, replace=False)  # all in slice 0
        vals2 = rng.integers(-hi, hi + 1, n2)
        vals2[:2] = -hi, hi
        ds.launches = 0
        fb0 = scatter.counters()["fallbackInvalidations"]
        client.import_values("i", "n", "v", cols2, vals2)
        torch.cuda.synchronize()
        fb = scatter.counters()["fallbackInvalidations"] - fb0
        if fb != 1 or ds.launches:
            raise AssertionError(f"/import-value 2: fallbacks {fb} (want 1), delta_scatter "
                                 f"launches {ds.launches} (want 0)")
        oracle.set_values(cols2, vals2)
        log(f"phase 7: /import-value of {n2} values into slice 0 ({n2 * (2 + K8_DEPTH)} "
            f"entries > scatter.pending_limit({mirror_rows}) = "
            f"{scatter.pending_limit(mirror_rows)}): fallbacks {fb}, no delta_scatter launch")
        ask_all("after import 2")
    finally:
        plan_mod.scatter_apply_many = real_apply
    out["k7_launches"] = k7
    out["import_s"] = import_s
    return out


def time_and_check(fp, InternalClient, srv, f_planes, rng) -> dict:
    """Phase 8 on the phase-5 server: a frame with time quantum YMD over
    TIME_SLICES slices x TIME_ROWS rows; SetBits with timestamps and a
    protobuf /import of TIME_BITS bits spread over TIME_DAYS days across
    two months; Range(start, end) counts, plain and inside Intersect,
    against numpy over the written (row, column, time) triples."""
    import torch

    h = srv.host
    status, resp = http(h, "POST", "/index/i/frame/t", b'{"options": {"timeQuantum": "YMD"}}')
    if status != 200:
        raise AssertionError(f"POST frame t: {status} {resp}")
    base = datetime(2017, 2, 10)
    rows = rng.integers(0, TIME_ROWS, TIME_BITS)
    cols = rng.integers(0, TIME_SLICES << 20, TIME_BITS)
    minutes = rng.integers(0, TIME_DAYS * 24 * 60, TIME_BITS)
    for i in range(16):
        ts = (base + timedelta(minutes=int(minutes[i]))).strftime("%Y-%m-%dT%H:%M")
        pql = f'SetBit(frame=t, rowID={rows[i]}, columnID={cols[i]}, timestamp="{ts}")'
        status, body = http(h, "POST", "/index/i/query", pql.encode())
        if status != 200:
            raise AssertionError(f"{pql}: {status} {body}")
    epoch = int(base.replace(tzinfo=timezone.utc).timestamp())
    ns = (epoch + minutes.astype(np.int64) * 60) * 1_000_000_000
    t0 = time.perf_counter()
    InternalClient(h, timeout=600).import_bits("i", "t", rows[16:], cols[16:], ns[16:])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    views = srv.holder.frame("i", "t").views()
    n_frags = sum(len(v.fragment_slices()) for v in views.values())
    log(f"phase 8: {TIME_BITS} bits with timestamps over {TIME_DAYS} days imported in "
        f"{import_s:.3f}s: {len(views)} views, {n_frags} fragments")

    f1 = (f_planes[cols >> 20, 1, (cols & 0xFFFFF) >> 5] >> (cols & 31)) & 1 == 1
    spans = [("2017-02-12T00:00", "2017-02-20T00:00"),  # inside one month
             ("2017-02-25T00:00", "2017-03-06T00:00"),  # across the month boundary
             ("2017-01-01T00:00", "2018-01-01T00:00")]  # the whole year
    fp.launches = 0
    n_queries = 0
    latencies = {}
    for a, b in spans:
        lo = int((datetime.strptime(a, "%Y-%m-%dT%H:%M") - base).total_seconds() // 60)
        up = int((datetime.strptime(b, "%Y-%m-%dT%H:%M") - base).total_seconds() // 60)
        inside = (minutes >= lo) & (minutes < up)
        for r in (0, TIME_ROWS - 1):
            rt = f'Range(frame=t, rowID={r}, start="{a}", end="{b}")'
            sel = inside & (rows == r)
            for name, pql, want in (
                (f"range {a[:10]}..{b[:10]} row {r}", f"Count({rt})",
                 len(np.unique(cols[sel]))),
                (f"range {a[:10]}..{b[:10]} row {r} & f1",
                 f"Count(Intersect({rt}, Bitmap(frame=f, rowID=1)))",
                 len(np.unique(cols[sel & f1]))),
            ):
                times = []
                for _ in range(REPS):
                    q0 = time.perf_counter()
                    status, body = http(h, "POST", "/index/i/query", pql.encode())
                    times.append(time.perf_counter() - q0)
                    if status != 200 or body["results"] != [want]:
                        raise AssertionError(f"phase 8 {name}: {status} {body} != {want}")
                n_queries += REPS
                latencies[name] = statistics.median(times) * 1e3
    if fp.launches != n_queries:
        raise AssertionError(f"phase 8: fused_popcount launches {fp.launches} != {n_queries}")
    for name, ms in latencies.items():
        log(f"phase 8: {name} p50 {ms:.3f} ms over {REPS} requests")
    log(f"phase 8: answers == numpy oracle; fused_popcount launches {fp.launches}")
    return {"launches": fp.launches, "import_s": import_s, "latencies_ms": latencies}


def topn_and_check(sp, fp, convert, srv, f_planes) -> dict:
    """Phase 9 on the phase-5 server: frame r with TOPN_ROWS rows per
    fragment over all 954 slices (1B columns, 8 GiB of mirrors), row k at
    density 0.5 * 2^(-k/8), generated on the card slice by slice from the
    seed and loaded one slice at a time; the numpy oracle keeps the
    per-slice scores (int64 [954, 64]) of every src asked.  TopN without
    a src, with a src row of the same frame (self-src), with a src tree
    over frame f (row-src), with threshold, tanimotoThreshold and ids —
    every answer against the oracle, p50 over REPS requests, launches
    counted."""
    import torch

    h = srv.host
    status, body = http(h, "POST", "/index/i/frame/r")
    if status != 200:
        raise AssertionError(f"POST frame r: {status} {body}")
    dev = srv.holder.device  # the card: the planes are made where they are served
    dens = torch.tensor([0.5 * 2 ** (-k / 8) for k in range(TOPN_ROWS)], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    totals = np.empty((N_SLICES, TOPN_ROWS), np.int64)
    self_sc = np.empty_like(totals)
    row_sc = np.empty_like(totals)
    row_src_n = np.empty(N_SLICES, np.int64)
    t_gen = t_oracle = 0.0
    t_start = time.perf_counter()
    # Each slice is loaded by a worker thread (the fragments are independent
    # and their snapshots mostly wait on the disk) while the next is made.
    with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
        pending = []
        for s in range(N_SLICES):
            t0 = time.perf_counter()
            bits = torch.rand((TOPN_ROWS, 1 << 20), device=dev, generator=g) < dens[:, None]
            words = (bits.view(TOPN_ROWS, 32768, 32).to(torch.int64) << shifts).sum(-1)
            plane = words.cpu().numpy().astype(np.uint32)
            t1 = time.perf_counter()
            src = f_planes[s, 1] & f_planes[s, 2]
            totals[s] = np.bitwise_count(plane).sum(axis=1)
            self_sc[s] = np.bitwise_count(plane & plane[0]).sum(axis=1)
            row_sc[s] = np.bitwise_count(plane & src).sum(axis=1)
            row_src_n[s] = np.bitwise_count(src).sum()
            t_gen, t_oracle = t_gen + t1 - t0, t_oracle + time.perf_counter() - t1
            pending.append(pool.submit(convert.load_planes, srv.holder, "i", "r", "standard",
                                       {s: plane}))
            if len(pending) >= 2 * LOAD_THREADS:
                pending.pop(0).result()
        for fut in pending:
            fut.result()
    torch.cuda.synchronize()
    del bits, words
    log(f"phase 9: frame r, {TOPN_ROWS} rows x {N_SLICES} slices made and loaded (mirror "
        f"upload + recount + snapshot, {LOAD_THREADS} loader threads) in "
        f"{time.perf_counter() - t_start:.3f}s: generated on the card and fetched in "
        f"{t_gen:.3f}s, oracle scores in {t_oracle:.3f}s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    n = TOPN_N
    r0 = "Bitmap(frame=r, rowID=0)"
    rsrc = "Intersect(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2))"
    ids = ", ".join(str(i) for i in TOPN_IDS)
    # (name, pql, expected, K4 launches, K1 launches) per request
    queries = [
        ("topn", f"TopN(frame=r, n={n})", topn_oracle(totals, n), 0, 0),
        ("topn_self_src", f"TopN({r0}, frame=r, n={n})", topn_oracle(self_sc, n, totals), 1, 0),
        ("topn_row_src", f"TopN({rsrc}, frame=r, n={n})", topn_oracle(row_sc, n, totals), 1, 0),
        ("topn_row_src_threshold", f"TopN({rsrc}, frame=r, n={n}, threshold={TOPN_THRESHOLD})",
         topn_oracle(row_sc, n, totals, threshold=TOPN_THRESHOLD), 1, 0),
        # A tanimoto window needs each slice's src count: one K1 launch.
        ("topn_row_src_tanimoto", f"TopN({rsrc}, frame=r, n={n}, tanimotoThreshold=50)",
         topn_oracle(row_sc, n, totals, tanimoto=50, src_counts=row_src_n), 1, 1),
        ("topn_self_src_tanimoto", f"TopN({r0}, frame=r, n={n}, tanimotoThreshold=50)",
         topn_oracle(self_sc, n, totals, tanimoto=50, src_counts=totals[:, 0]), 1, 1),
        ("topn_row_src_ids", f"TopN({rsrc}, frame=r, n={n}, ids=[{ids}])",
         topn_oracle(row_sc, n, totals, ids=TOPN_IDS), 1, 0),
    ]
    out: dict = {"latencies_ms": {}, "answers": {}}
    fp.launches = sp.launches = 0  # the main path starts here
    want_k4 = want_k1 = 0
    for name, pql, want, k4, k1 in queries:
        times = []
        for _ in range(REPS):
            q0 = time.perf_counter()
            status, body = http(h, "POST", "/index/i/query", pql.encode())
            times.append(time.perf_counter() - q0)
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 9 {name}: {status} {str(body)[:300]} != {want}")
        want_k4 += REPS * k4
        want_k1 += REPS * k1
        out["latencies_ms"][name] = statistics.median(times) * 1e3
        out["answers"][name] = len(want)
    out["k4_launches"], out["launches"] = sp.launches, fp.launches  # the main path ends here
    if (out["k4_launches"], out["launches"]) != (want_k4, want_k1):
        raise AssertionError(f"phase 9: score_planes / fused_popcount launches "
                             f"{out['k4_launches']} / {out['launches']} != {want_k4} / {want_k1}")
    for name, ms in out["latencies_ms"].items():
        log(f"phase 9: {name} p50 {ms:.3f} ms over {REPS} requests "
            f"({out['answers'][name]} pairs)")
    log(f"phase 9: answers == numpy oracle; score_planes launches {out['k4_launches']}, "
        f"fused_popcount launches {out['launches']}")
    return out


# --- Phase 10: the two tutorials (docs/tutorials.md) at the JAX defaults -------

# Star trace (tutorials.md section 1): 2^18 stargazer ids in a random
# permutation, Zipf stars per user, 1% of users starring a contiguous run of
# repository ids, over 2 slices of repositories; 64 languages, one per
# repository.
STAR_USERS = 1 << 18
STAR_SLICES = 2
STAR_ZIPF = 2.0
STAR_MAX = 50_000
STAR_RUN_SHARE = 0.01
STAR_RUN_LEN = (100, 5000)
STAR_LANGUAGES = 64
# Chemical similarity (section 2): molecules x fingerprint positions, about
# FP_BITS bits each; FP_NEIGHBORS near-copies of molecule FP_QUERY (half
# with ids inside the dense budget, half past it) with up to FP_FLIPS bits
# changed, so the tanimoto query has answers on both tiers.
MOLECULES = 1 << 18
FP_POSITIONS = 1024
FP_BITS = 48
FP_QUERY = 42
FP_QUERY_BITS = 120
FP_NEIGHBORS = 64
FP_FLIPS = 30
P10_CACHE = 50_000  # the ranked cache's size: each slice's TopN candidates
# Phase 12: the residency pool's budget over phase 10's directory (three
# 8 GiB plane tiers), the rounds of its alternating queries, and the slack
# over the budget that memory_allocated() may show outside saturation (the
# queries' own outputs are below 1 MiB).
RESIDENCY_BUDGET = 12 << 30
RESIDENCY_ROUNDS = 1
RESIDENCY_SLACK = 256 << 20
# Phase 13: writer threads x SetBits each over slices, and the serial
# SetBits of each WAL setting, in turns.
DURABLE_THREADS = 8
DURABLE_WRITES = 500
DURABLE_SLICES = 16
DURABLE_ROWS = 8
SERIAL_WRITES = 100


def star_data(rng):
    """(stargazer ids, repository ids) of every star, unique, sorted by
    (stargazer, repository); and each repository's language."""
    n_repos = STAR_SLICES << 20
    perm = rng.permutation(STAR_USERS)
    k = np.minimum(rng.zipf(STAR_ZIPF, STAR_USERS), STAR_MAX)
    users = np.repeat(np.arange(STAR_USERS), k)
    repos = rng.integers(0, n_repos, len(users))
    run_users = rng.choice(STAR_USERS, size=int(STAR_USERS * STAR_RUN_SHARE), replace=False)
    lens = rng.integers(*STAR_RUN_LEN, len(run_users))
    starts = rng.integers(0, n_repos - lens)
    users = np.concatenate([users, np.repeat(run_users, lens)])
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    repos = np.concatenate([repos, np.repeat(starts, lens) + within])
    key = np.unique(perm[users].astype(np.int64) * n_repos + repos)
    lang = rng.integers(0, STAR_LANGUAGES, n_repos)
    return key // n_repos, key % n_repos, lang


def fingerprint_data(rng, budget: int):
    """(molecule ids, positions) of every fingerprint bit, unique, sorted by
    (molecule, position); the near-copies of FP_QUERY have ids on both
    sides of the dense ``budget``."""
    k = rng.binomial(FP_POSITIONS, FP_BITS / FP_POSITIONS, MOLECULES)
    mols = np.repeat(np.arange(MOLECULES), k)
    pos = rng.integers(0, FP_POSITIONS, len(mols))
    query = np.sort(rng.choice(FP_POSITIONS, size=FP_QUERY_BITS, replace=False))
    near = np.concatenate([
        rng.choice(np.arange(FP_QUERY + 1, budget), FP_NEIGHBORS // 2, replace=False),
        rng.choice(np.arange(budget, MOLECULES), FP_NEIGHBORS // 2, replace=False)])
    extra_m, extra_p = [np.full(FP_QUERY_BITS, FP_QUERY)], [query]
    for m in near:
        drop = rng.integers(0, FP_FLIPS + 1)
        keep = rng.choice(query, size=FP_QUERY_BITS - drop, replace=False)
        add = rng.choice(FP_POSITIONS, size=int(rng.integers(0, FP_FLIPS + 1)))
        p = np.union1d(keep, add)
        extra_m.append(np.full(len(p), m))
        extra_p.append(p)
    planted = np.isin(mols, np.concatenate([[FP_QUERY], near]))
    mols = np.concatenate([mols[~planted]] + extra_m)
    pos = np.concatenate([pos[~planted]] + extra_p)
    key = np.unique(mols.astype(np.int64) * FP_POSITIONS + pos)
    return key // FP_POSITIONS, key % FP_POSITIONS


def row_of(ids: np.ndarray, vals: np.ndarray, i: int) -> np.ndarray:
    """The sorted values of id ``i`` in arrays sorted by (id, value)."""
    lo, hi = np.searchsorted(ids, [i, i + 1])
    return vals[lo:hi]


def tutorial_topn(scores: np.ndarray, totals: np.ndarray, n: int) -> list[dict]:
    """The TopN protocol over per-slice scores [slices, rows]: each slice's
    candidates are its P10_CACHE rows of highest count (``totals``; count
    desc, id asc — the ranked cache); its winners the n best candidates by
    score (> 0); a winner's count is its score summed over the slices
    where it has bits; sorted (count desc, id asc) and trimmed to n."""
    winners = set()
    for sc, tot in zip(scores, totals):
        ids = np.arange(len(tot))
        cand = np.lexsort((ids, -tot))[:P10_CACHE]
        cand = cand[tot[cand] > 0]
        cand = cand[sc[cand] > 0]
        order = cand[np.lexsort((cand, -sc[cand]))]
        winners.update(int(r) for r in order[:n])
    pairs = [(r, int(scores[totals[:, r] > 0, r].sum())) for r in sorted(winners)]
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return [{"id": i, "count": c} for i, c in pairs[:n] if c > 0]


def tutorial_queries(users, repos, lang, rows: dict, mole: dict) -> list:
    """Phase 10's query classes with their oracle answers over the stars
    ``(users, repos)`` (sorted by (user, repo)) and the fingerprint rows
    in ``mole``: ``(name, index, pql, expected, launches per request by
    kernel)``."""
    a, b, c, d, r = (rows[k] for k in "abcdr")
    slice_of = repos >> 20
    counts = np.stack([np.bincount(users[slice_of == s], minlength=STAR_USERS)
                       for s in range(STAR_SLICES)])
    ra, rb, rc, rd, rr = (row_of(users, repos, u) for u in (a, b, c, d, r))
    lang_counts = np.stack([np.bincount(lang[s << 20:(s + 1) << 20], minlength=STAR_LANGUAGES)
                            for s in range(STAR_SLICES)])
    a_lang = np.stack([np.bincount(lang[ra[(ra >> 20) == s]], minlength=STAR_LANGUAGES)
                       for s in range(STAR_SLICES)])
    in_l3 = lang[repos] == 3
    l3_scores = np.stack([np.bincount(users[(slice_of == s) & in_l3], minlength=STAR_USERS)
                          for s in range(STAR_SLICES)])
    fm1, fm2 = mole["fm1"], mole["fm2"]
    B = "Bitmap(frame=stargazer, stargazer_id={})"
    return [
        ("count_sparse_sparse", "repository", f"Count(Intersect({B.format(a)}, {B.format(b)}))",
         len(np.intersect1d(ra, rb)), {"k5": 1}),
        ("count_sparse_dense", "repository", f"Count(Intersect({B.format(a)}, {B.format(d)}))",
         len(np.intersect1d(ra, rd)), {"k5": 1}),
        ("count_rle_difference", "repository",
         f"Count(Difference({B.format(r)}, {B.format(a)}))", len(np.setdiff1d(rr, ra)),
         {"k5": 1}),
        ("count_nested", "repository",
         f"Count(Intersect({B.format(r)}, Union({B.format(a)}, {B.format(b)})))",
         len(np.intersect1d(rr, np.union1d(ra, rb))), {"k5": 1}),
        ("count_union_sparse", "repository",
         f"Count(Union({B.format(a)}, {B.format(b)}, {B.format(c)}))",
         len(np.union1d(np.union1d(ra, rb), rc)), {"k6": 1, "k1": 1}),
        ("bitmap_sparse", "repository", B.format(a),
         {"attrs": {}, "bits": [int(v) for v in ra]}, {"k6": 1}),
        ("topn_language", "repository", f"TopN({B.format(a)}, frame=language, n=5)",
         tutorial_topn(a_lang, lang_counts, 5), {"k6": 1, "k4": 1}),
        ("topn_stargazer", "repository", "TopN(frame=stargazer, n=10)",
         tutorial_topn(counts, counts, 10), {}),
        ("topn_stargazer_src", "repository",
         "TopN(Bitmap(frame=language, language_id=3), frame=stargazer, n=10)",
         tutorial_topn(l3_scores, counts, 10), {"k4": 1}),
        ("bitmap_molecule", "mole", mole["pql_m1"],
         {"attrs": {}, "bits": [int(v) for v in fm1]}, {"k6": 1}),
        ("count_molecules", "mole", f"Count(Intersect({mole['pql_m1']}, {mole['pql_m2']}))",
         len(np.intersect1d(fm1, fm2)), {"k5": 1}),
        ("topn_tanimoto", "mole",
         f"TopN(Bitmap(frame=fingerprint, molecule_id={FP_QUERY}), frame=fingerprint, "
         "inverse=true, n=100, tanimotoThreshold=70)", mole["tani_want"], {"k1": 1, "k4": 1}),
    ]


def tutorials_and_check(ac, ep, fp, sp, bp, InternalClient, srv, rng) -> dict:
    """Phase 10 on ``srv``, a fresh one-node ``Server`` on the card at the
    JAX package's defaults (dense budget 65,536, plane-format auto, 64 KiB
    caps): the star trace and the chemical-similarity tutorials loaded
    through ``/import``, then every query class of the slice, each
    answer against a numpy oracle over the written pairs, the launches of
    K1, K4, K5 and K6 counted around each class."""
    import torch

    from pilosa_tpu_torch.core import fragment as fragment_mod

    h = srv.host
    client = InternalClient(h, timeout=600)
    for path, opts in (
        ("/index/repository", {"columnLabel": "repo_id"}),
        ("/index/repository/frame/stargazer", {"rowLabel": "stargazer_id"}),
        ("/index/repository/frame/language", {"rowLabel": "language_id"}),
        ("/index/mole", {"columnLabel": "molecule_id"}),
        ("/index/mole/frame/fingerprint", {"rowLabel": "position", "inverseEnabled": True}),
    ):
        status, body = http(h, "POST", path, json.dumps({"options": opts}).encode())
        if status != 200:
            raise AssertionError(f"POST {path}: {status} {body}")
    budget = fragment_mod.DENSE_ROW_BUDGET
    M = "Bitmap(frame=fingerprint, molecule_id={})"
    t0 = time.perf_counter()
    users, repos, lang = star_data(rng)
    mols, fpos = fingerprint_data(rng, budget)
    t1 = time.perf_counter()
    client.import_bits("repository", "stargazer", users, repos)
    t2 = time.perf_counter()
    client.import_bits("repository", "language", lang, np.arange(len(lang)))
    t3 = time.perf_counter()
    client.import_bits("mole", "fingerprint", fpos, mols)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    stars = [srv.holder.fragment("repository", "stargazer", "standard", s)
             for s in range(STAR_SLICES)]
    inv = srv.holder.fragment("mole", "fingerprint", "inverse", 0)
    tiers = {f"stargazer/{s}": (len(f._slot_of), len(f._sparse)) for s, f in enumerate(stars)}
    tiers["fingerprint/inverse/0"] = (len(inv._slot_of), len(inv._sparse))
    log(f"phase 10: star trace {len(users)} stars of {STAR_USERS} stargazers over "
        f"{STAR_SLICES} slices and {STAR_LANGUAGES} languages, fingerprints {len(mols)} bits of "
        f"{MOLECULES} molecules, made in {t1 - t0:.3f}s; /import of the stars {t2 - t1:.3f}s, "
        f"languages {t3 - t2:.3f}s, fingerprints (with the inverse view) {t4 - t3:.3f}s; "
        f"(plane rows, sparse rows) per tall fragment {tiers} at a dense budget of {budget}; "
        f"device memory allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    for name, (dense, sparse) in tiers.items():
        if dense != budget or sparse == 0:
            raise AssertionError(f"phase 10: {name} is not tall: {dense} plane rows, "
                                 f"{sparse} sparse rows")

    # The rows asked about, picked by tier.
    slice_of = repos >> 20
    counts = np.stack([np.bincount(users[slice_of == s], minlength=STAR_USERS)
                       for s in range(STAR_SLICES)])
    total = counts.sum(0)

    def fmt_in(frag, u):
        hp = frag.host_payload(int(u))
        return None if hp is None else hp[0]

    def pick(pred, k=1):
        """The k stargazers of most stars that satisfy ``pred`` in every slice."""
        out = []
        for u in np.argsort(-total, kind="stable"):
            if all(pred(f, int(u), counts[s, u]) for s, f in enumerate(stars)):
                out.append(int(u))
                if len(out) == k:
                    return out
        raise AssertionError("phase 10: no stargazer fits")

    def sparse_fmt(f, u, n):
        return u in f._sparse and n > 0 and fmt_in(f, u) == bp.FMT_SPARSE

    a, b, c = pick(sparse_fmt, 3)
    d = pick(lambda f, u, n: u in f._slot_of and n > 0)[0]
    # A run's stargazer: RLE where its run lies, never a plane row.
    r = next(int(u) for u in np.argsort(-total, kind="stable")
             if all(int(u) not in f._slot_of for f in stars)
             and any(fmt_in(f, u) == bp.FMT_RLE for f in stars))
    # The write: a repository of b's that a has not starred.
    x = int(np.setdiff1d(row_of(users, repos, b), row_of(users, repos, a))[0])

    fp_q = row_of(mols, fpos, FP_QUERY)
    fp_counts = np.bincount(mols, minlength=MOLECULES)
    src_n = len(fp_q)
    lo_t, hi_t = float(src_n * 70) / 100, float(src_n * 100) / 70
    window = np.flatnonzero((fp_counts > lo_t) & (fp_counts < hi_t))
    tani = []
    for m in window:
        sc = len(np.intersect1d(row_of(mols, fpos, m), fp_q))
        if sc > 0 and np.ceil(sc * 100.0 / (fp_counts[m] + src_n - sc)) > 70:
            tani.append((int(m), sc))
    tani.sort(key=lambda p: (-p[1], p[0]))
    if not any(m < budget for m, _ in tani) or not any(m >= budget for m, _ in tani):
        raise AssertionError(f"phase 10: the tanimoto answer misses a tier: {tani[:5]}")
    # Two molecules of the sparse tier near the query: they share bits.
    m1, m2 = [m for m, _ in tani if int(m) in inv._sparse][:2]
    rows = {"a": a, "b": b, "c": c, "d": d, "r": r}
    mole = {"m1": m1, "fm1": row_of(mols, fpos, m1), "fm2": row_of(mols, fpos, m2),
            "tani_want": [{"id": m, "count": sc} for m, sc in tani[:100]],
            "pql_m1": M.format(m1), "pql_m2": M.format(m2)}
    inv_rows = {"q": FP_QUERY, "m1": m1, "m2": m2}
    queries = tutorial_queries(users, repos, lang, rows, mole)
    kernels = {"k1": fp, "k4": sp, "k5": ac, "k6": ep}
    out: dict = {"latencies_ms": {}, "launches": {}, "rows": {"a": a, "b": b, "c": c, "d": d,
                                                             "r": r, **inv_rows}}

    def run(name, index, pql, want, per_request, reps=REPS):
        for k in kernels.values():
            k.launches = 0  # the main path starts here
        times = []
        for _ in range(reps):
            q0 = time.perf_counter()
            status, body = http(h, "POST", f"/index/{index}/query", pql.encode())
            times.append(time.perf_counter() - q0)
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 10 {name}: {status} {str(body)[:300]} != "
                                     f"{str(want)[:300]}")
        got = {k: m.launches for k, m in kernels.items()}  # the main path ends here
        expect = {k: reps * per_request.get(k, 0) for k in kernels}
        if got != expect:
            raise AssertionError(f"phase 10 {name}: launches {got} != {expect}")
        out["latencies_ms"][name] = statistics.median(times) * 1e3
        out["launches"][name] = got

    for q in queries:
        run(*q)
    # A write into a sparse row, then the Count that must see it.
    status, body = http(h, "POST", "/index/repository/query",
                        f"SetBit(frame=stargazer, stargazer_id={a}, repo_id={x})".encode())
    if status != 200 or body["results"] != [True]:
        raise AssertionError(f"phase 10 SetBit: {status} {body}")
    if a not in stars[x >> 20]._sparse:
        raise AssertionError("phase 10: the written row left the sparse tier")
    run("count_after_setbit", "repository", queries[0][2], queries[0][3] + 1, {"k5": 1})
    # The oracle with the written star, for phase 12 on this directory.
    n_repos = STAR_SLICES << 20
    key = np.union1d(users * n_repos + repos, [a * n_repos + x])
    out["stars"] = (key // n_repos, key % n_repos)
    out["queries"] = tutorial_queries(*out["stars"], lang, rows, mole)
    for name, ms in out["latencies_ms"].items():
        log(f"phase 10: {name} p50 {ms:.3f} ms over {REPS} requests, launches "
            f"{out['launches'][name]}")
    totals = {k: sum(v[k] for v in out["launches"].values()) for k in kernels}
    out["totals"] = totals
    log(f"phase 10: answers == numpy oracle; launches by kernel {totals} (rows {out['rows']})")
    return out


def recovery_and_check(Server, ds) -> dict:
    """Phase 11, recovery on the card: a port node writes three bits and
    closes; a JAX node's WAL segment for the fragment is written with
    the port's own encoder (its first ops those of the op-log, then two
    acknowledged writes the op-log lacks); the op-log's last record is
    torn (3 bytes cut); the node reopens on the card and must answer the
    oracle — the op-log's whole records plus the WAL's later ops —
    count one repair and two replayed ops, restart the segment at its
    checkpoint snapshot (the JAX package's behaviour), apply a later write
    with one K7 launch, and answer the same after a second reopen (no op
    replayed twice)."""
    from pilosa_tpu_torch.core import fragment as fragment_mod
    from pilosa_tpu_torch.ingest import wal
    from pilosa_tpu_torch.ops import roaring

    sw = 1 << 20
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-recovery-") as data_dir:
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda")
        srv.open()
        try:
            for path in ("/index/r", "/index/r/frame/f"):
                status, body = http(srv.host, "POST", path)
                if status != 200:
                    raise AssertionError(f"POST {path}: {status} {body}")
            for c in (3, 4, 5):
                status, body = http(srv.host, "POST", "/index/r/query",
                                    f"SetBit(frame=f, rowID=1, columnID={c})".encode())
                if status != 200 or body["results"] != [True]:
                    raise AssertionError(f"phase 11 SetBit {c}: {status} {body}")
            path = srv.holder.fragment("r", "f", "standard", 0).path
        finally:
            srv.close()
        if os.path.getsize(path) != 8 + 3 * roaring.OP_SIZE:
            raise AssertionError(f"phase 11: fragment file of {os.path.getsize(path)} bytes")
        ops = [roaring.encode_op(roaring.OP_ADD, p) for p in (sw + 3, sw + 4, sw + 9, 2 * sw + 7)]
        with open(wal.wal_path(path), "wb") as fh:
            fh.write(wal.encode_header(0, 8) + wal.encode_frame(b"".join(ops[:2]), 2, 2)
                     + wal.encode_frame(b"".join(ops[2:]), 2, 4))
        with open(path, "r+b") as fh:
            fh.truncate(8 + 3 * roaring.OP_SIZE - 3)
        queries = [
            ("count_row1", "Count(Bitmap(frame=f, rowID=1))", 3),
            ("count_row2", "Count(Bitmap(frame=f, rowID=2))", 1),
            ("bitmap_row1", "Bitmap(frame=f, rowID=1)", {"attrs": {}, "bits": [3, 4, 9]}),
            ("count_union", "Count(Union(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2)))",
             4),
        ]

        def check(stage: str, srv) -> None:
            for name, pql, want in queries:
                status, body = http(srv.host, "POST", "/index/r/query", pql.encode())
                if status != 200 or body["results"] != [want]:
                    raise AssertionError(f"phase 11 {stage} {name}: {status} {body} != {want}")

        c0 = fragment_mod.counters()
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda")
        srv.open()
        try:
            c1 = fragment_mod.counters()
            repaired = c1["oplogRepair"] - c0["oplogRepair"]
            replayed = c1["walReplayedOps"] - c0["walReplayedOps"]
            seg = wal.load_segment(wal.wal_path(path))
            if (repaired, replayed) != (1, 2) or seg is None or seg.n_ops != 0 \
                    or seg.snap_size != os.path.getsize(path):
                raise AssertionError(f"phase 11: repairs {repaired}, replayed ops {replayed} "
                                     "(want 1, 2), or the segment was not restarted at the "
                                     "checkpoint snapshot")
            check("reopened", srv)
            ds.launches = 0
            status, body = http(srv.host, "POST", "/index/r/query",
                                b"SetBit(frame=f, rowID=2, columnID=11)")
            if status != 200 or body["results"] != [True]:
                raise AssertionError(f"phase 11 SetBit after recovery: {status} {body}")
            queries[1] = ("count_row2", queries[1][1], 2)
            queries[3] = ("count_union", queries[3][1], 5)
            check("after a write", srv)
            if ds.launches != 1:
                raise AssertionError(f"phase 11: delta_scatter launches {ds.launches} (want 1)")
        finally:
            srv.close()
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda")
        srv.open()
        try:
            check("reopened again", srv)
            if fragment_mod.counters()["walReplayedOps"] != c1["walReplayedOps"]:
                raise AssertionError("phase 11: ops replayed a second time")
        finally:
            srv.close()
    log("phase 11: a torn op-log tail repaired and 2 WAL ops replayed on the card; answers == "
        "oracle after reopening, after a write (1 delta_scatter launch) and after a second "
        "reopen (nothing replayed twice)")
    return {"repaired": repaired, "replayed": replayed, "k7_launches": 1}


def sparse_after_reopen(srv, users, repos) -> list:
    """Two queries over the two stargazers of most stars whose rows are
    compressed positions in both star fragments of ``srv`` (phase 10's
    rows a and b may be plane rows after a reopen, which puts each
    fragment's densest rows in the plane): their Count(Intersect) (K5)
    and the first one's Bitmap (K6), with the oracle of ``(users,
    repos)``."""
    from pilosa_tpu_torch.ops import bitplane as bp

    stars = [srv.holder.fragment("repository", "stargazer", "standard", s)
             for s in range(STAR_SLICES)]
    counts = np.stack([np.bincount(users[(repos >> 20) == s], minlength=STAR_USERS)
                       for s in range(STAR_SLICES)])
    picked = []
    for u in np.argsort(-counts.sum(0), kind="stable"):
        u = int(u)
        if all(counts[s, u] > 0 and u in f._sparse and f.host_payload(u)[0] == bp.FMT_SPARSE
               for s, f in enumerate(stars)):
            picked.append(u)
            if len(picked) == 2:
                break
    u, v = picked
    ru, rv = row_of(users, repos, u), row_of(users, repos, v)
    B = "Bitmap(frame=stargazer, stargazer_id={})"
    return [
        ("count_sparse_after_reopen", "repository",
         f"Count(Intersect({B.format(u)}, {B.format(v)}))", len(np.intersect1d(ru, rv)),
         {"k5": 1}),
        ("bitmap_sparse_after_reopen", "repository", B.format(u),
         {"attrs": {}, "bits": [int(x) for x in ru]}, {"k6": 1}),
    ]


def residency_and_check(Server, data_dir: str, tutorials: dict, kernels: dict) -> dict:
    """Phase 12, residency under a budget: every other node is closed;
    phase 10's directory reopens with ``hbm_budget_bytes`` =
    RESIDENCY_BUDGET, restarting from its ``.residency.json`` (staging
    runs in the background); phase 10's query classes alternate between
    ``repository`` and ``mole``, each answer against the oracle with the
    written star, and after every query the pool's and the allocator's
    numbers are printed and checked: resident bytes within the budget
    outside pinned saturation, ``memory_allocated()`` within the budget
    plus RESIDENCY_SLACK, once the query is answered and the prefetcher
    idle (a saturation ends with the lease or upload that caused it);
    evictions > 0; a query that pins both 8 GiB star mirrors saturates
    (``overBudget`` grows) and still answers right.
    Then one eviction-driven re-upload of an 8 GiB mirror is timed."""
    import torch

    from pilosa_tpu_torch import device as device_mod

    pool = device_mod.pool()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    c0 = pool.counters()
    for k in kernels.values():
        k.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    srv = Server(data_dir, host="127.0.0.1:0", device="cuda", hbm_budget_bytes=RESIDENCY_BUDGET)
    srv.open()
    t_open = time.perf_counter() - t0
    out: dict = {"open_s": t_open, "queries": []}
    try:
        job = srv.staging_job
        staged_at = {}

        def watch():
            job.wait()
            staged_at["s"] = time.perf_counter() - t0

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        queries = tutorials["queries"] + sparse_after_reopen(srv, *tutorials["stars"])
        repo_q = [q for q in queries if q[1] == "repository"]
        mole_q = [q for q in queries if q[1] == "mole"]
        order = []
        for _ in range(RESIDENCY_ROUNDS):
            for i, q in enumerate(repo_q):
                order += [q, mole_q[i % len(mole_q)]]
        dev = srv.device
        saturated_both = []
        for n, (name, index, pql, want, _) in enumerate(order):
            cb = pool.counters()
            q0 = time.perf_counter()
            status, body = http(srv.host, "POST", f"/index/{index}/query", pql.encode())
            q1 = time.perf_counter()
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 12 {name}: {status} {str(body)[:300]} != "
                                     f"{str(want)[:300]}")
            if n == 0:
                out["first_answer_s"] = q1 - t0
            srv.executor.prefetcher.wait_idle(600)
            torch.cuda.synchronize()
            c = pool.counters()
            resident, high = pool.resident_bytes(dev), pool.max_resident_bytes(dev)
            alloc = torch.cuda.memory_allocated() - base
            reserved = torch.cuda.memory_reserved()
            saturated = c["overBudget"] > cb["overBudget"]
            row = {"name": name, "ms": (q1 - q0) * 1e3, "resident": resident, "high": high,
                   "alloc": alloc, "reserved": reserved, "saturated": saturated,
                   **{k: c[k] - c0[k] for k in ("evictions", "evictSkipped", "overBudget",
                                                "restageBytes")}}
            out["queries"].append(row)
            log(f"phase 12: {name} on {index} {row['ms']:.3f} ms; resident "
                f"{resident / 2**30:.3f} GiB (high {high / 2**30:.3f}), evictions "
                f"{row['evictions']}, skipped {row['evictSkipped']}, over budget "
                f"{row['overBudget']}, restaged {row['restageBytes'] / 2**30:.3f} GiB; "
                f"memory_allocated {alloc / 2**30:.3f} GiB over the base, reserved "
                f"{reserved / 2**30:.3f} GiB")
            if saturated and index == "repository":
                saturated_both.append(name)
            # Between queries nothing is pinned or uploading: the pool has
            # evicted back to the budget, and the allocator holds no more.
            if resident > RESIDENCY_BUDGET:
                raise AssertionError(f"phase 12 {name}: {resident} bytes resident over the "
                                     f"budget {RESIDENCY_BUDGET} after the query")
            if alloc > RESIDENCY_BUDGET + RESIDENCY_SLACK:
                raise AssertionError(f"phase 12 {name}: {alloc} bytes allocated over the "
                                     f"budget {RESIDENCY_BUDGET}")
        c = pool.counters()
        out.update({k: c[k] - c0[k] for k in c})
        out["launches"] = {k: m.launches for k, m in kernels.items()}  # the main path ends here
        if out["evictions"] <= 0:
            raise AssertionError("phase 12: nothing was evicted under the budget")
        if not saturated_both:
            raise AssertionError("phase 12: no query pinned both star mirrors into saturation")
        missing = [k for k, v in out["launches"].items() if v == 0]
        if missing:
            raise AssertionError(f"phase 12 launched no {missing}")
        if not job.wait(600):
            raise AssertionError("phase 12: staging did not finish")
        watcher.join(10)
        out["staged_s"] = staged_at.get("s")
        out["staging"] = job.snapshot()
        # One eviction-driven re-upload: a mole query evicted the star
        # mirrors; the upload's admission evicts the mole mirror.
        star = srv.holder.fragment("repository", "stargazer", "standard", 0)
        status, _ = http(srv.host, "POST", "/index/mole/query", mole_q[-1][2].encode())
        srv.executor.prefetcher.wait_idle(600)
        ev = pool.counters()["evictions"]
        if star._mirror is not None or status != 200:
            raise AssertionError("phase 12: the star mirror stayed resident after a mole query")
        torch.cuda.synchronize()
        u0 = time.perf_counter()
        star.device_plane()
        torch.cuda.synchronize()
        out["reupload_s"] = time.perf_counter() - u0
        out["reupload_bytes"] = star.plane_nbytes
        out["reupload_evictions"] = pool.counters()["evictions"] - ev
    finally:
        srv.close()
    log(f"phase 12: opened in {out['open_s']:.3f} s; first answer {out['first_answer_s']:.3f} s "
        f"after open began; staging {out['staging']} done {out['staged_s']:.3f} s after; "
        f"evictions {out['evictions']}, skipped {out['evictSkipped']}, over budget "
        f"{out['overBudget']} (saturating queries {saturated_both}), restaged "
        f"{out['restageBytes'] / 2**30:.3f} GiB in {out['restageUploads']} uploads; "
        f"prefetch hits {out['prefetchHit']}, misses {out['prefetchMiss']}; launches "
        f"{out['launches']}")
    log(f"phase 12: an eviction-driven re-upload of {out['reupload_bytes'] / 2**30:.3f} GiB took "
        f"{out['reupload_s']:.3f} s ({out['reupload_bytes'] / out['reupload_s'] / 1e9:.2f} GB/s; "
        f"{out['reupload_evictions']} eviction(s) made its room); PR 6 measured re-uploads at "
        "10.4 GB/s, which predicts ~0.8 s")
    return out


def durability_and_check(Server, kernels: dict) -> dict:
    """Phase 13, durability: on a node of its own with the WAL on (the
    default), DURABLE_THREADS threads each send DURABLE_WRITES SetBits
    over HTTP across DURABLE_SLICES slices; the data directory is copied
    while the node is open and a second port node opens the copy, which
    must hold every acknowledged bit; ``/debug/ingest`` must show fewer
    fsyncs than appends (the group commit); then serial SetBit p50/p99
    with the WAL on and off, in turns on the same card."""
    import shutil

    rng = np.random.default_rng(SEED + 13)
    out: dict = {}
    for k in kernels.values():
        k.launches = 0  # the main path starts here
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-durable-") as root:
        live, copy = os.path.join(root, "live"), os.path.join(root, "copy")
        srv = Server(live, host="127.0.0.1:0", device="cuda")
        srv.open()
        try:
            for path in ("/index/d", "/index/d/frame/f"):
                status, body = http(srv.host, "POST", path)
                if status != 200:
                    raise AssertionError(f"POST {path}: {status} {body}")
            n = DURABLE_THREADS * DURABLE_WRITES
            rows = rng.integers(0, DURABLE_ROWS, n)
            cols = rng.integers(0, DURABLE_SLICES << 20, n)
            acked = [[] for _ in range(DURABLE_THREADS)]
            times = [[] for _ in range(DURABLE_THREADS)]

            def writer(t):
                for i in range(t * DURABLE_WRITES, (t + 1) * DURABLE_WRITES):
                    q0 = time.perf_counter()
                    status, body = http(srv.host, "POST", "/index/d/query",
                                        f"SetBit(frame=f, rowID={rows[i]}, "
                                        f"columnID={cols[i]})".encode())
                    times[t].append(time.perf_counter() - q0)
                    if status != 200:
                        raise AssertionError(f"phase 13 SetBit: {status} {body}")
                    acked[t].append(i)

            w0 = time.perf_counter()
            with ThreadPoolExecutor(DURABLE_THREADS) as ex:
                for f in [ex.submit(writer, t) for t in range(DURABLE_THREADS)]:
                    f.result()
            out["write_s"] = time.perf_counter() - w0
            lat = sorted(x for ts in times for x in ts)
            out["concurrent_p50_ms"] = lat[len(lat) // 2] * 1e3
            out["concurrent_p99_ms"] = lat[int(len(lat) * 0.99)] * 1e3
            status, ing = http(srv.host, "GET", "/debug/ingest")
            wal = ing["wal"]
            out["appends"], out["fsyncs"] = wal["totalAppends"], wal["totalFsyncs"]
            if status != 200 or not out["fsyncs"] < out["appends"]:
                raise AssertionError(f"phase 13: fsyncs {out['fsyncs']} not below appends "
                                     f"{out['appends']}")
            shutil.copytree(live, copy)  # while the node is open
        finally:
            srv.close()
        idx = np.concatenate([np.asarray(a, np.int64) for a in acked])
        want = {r: sorted({int(c) for c in cols[idx][rows[idx] == r]}) for r in range(DURABLE_ROWS)}
        if sum(len(v) for v in want.values()) != out["appends"]:
            raise AssertionError(f"phase 13: {out['appends']} appends for "
                                 f"{sum(len(v) for v in want.values())} distinct bits")
        other = Server(copy, host="127.0.0.1:0", device="cuda")
        other.open()
        try:
            for r in range(DURABLE_ROWS):
                for pql, expect in ((f"Bitmap(frame=f, rowID={r})", {"attrs": {}, "bits": want[r]}),
                                    (f"Count(Bitmap(frame=f, rowID={r}))", len(want[r]))):
                    status, body = http(other.host, "POST", "/index/d/query", pql.encode())
                    if status != 200 or body["results"] != [expect]:
                        raise AssertionError(f"phase 13: the copy answers {pql} with {status} "
                                             f"{str(body)[:200]}")
            out["replayed"] = http(other.host, "GET", "/debug/ingest")[1]["wal"]["replayedOps"]
        finally:
            other.close()
        out["launches"] = {k: m.launches for k, m in kernels.items()}  # the main path ends here
        if out["launches"]["k1"] == 0:
            raise AssertionError("phase 13 launched no fused_popcount")
        # Serial SetBits, the WAL on and off in turns (on, off, off, on).
        serial: dict = {True: [], False: []}
        for turn, wal_on in enumerate((True, False, False, True)):
            d = os.path.join(root, f"serial{turn}")
            s2 = Server(d, host="127.0.0.1:0", device="cuda", ingest_wal=wal_on)
            s2.open()
            try:
                for path in ("/index/d", "/index/d/frame/f"):
                    http(s2.host, "POST", path)
                for i in range(SERIAL_WRITES):
                    q0 = time.perf_counter()
                    status, body = http(s2.host, "POST", "/index/d/query",
                                        f"SetBit(frame=f, rowID=1, columnID={i * 7919})".encode())
                    serial[wal_on].append(time.perf_counter() - q0)
                    if status != 200:
                        raise AssertionError(f"phase 13 serial SetBit: {status} {body}")
            finally:
                s2.close()
        for wal_on, ts in serial.items():
            ts.sort()
            key = "wal_on" if wal_on else "wal_off"
            out[f"serial_{key}_p50_ms"] = ts[len(ts) // 2] * 1e3
            out[f"serial_{key}_p99_ms"] = ts[int(len(ts) * 0.99)] * 1e3
    log(f"phase 13: {n} SetBits from {DURABLE_THREADS} threads over {DURABLE_SLICES} slices in "
        f"{out['write_s']:.3f} s (p50 {out['concurrent_p50_ms']:.3f} ms, p99 "
        f"{out['concurrent_p99_ms']:.3f} ms); WAL appends {out['appends']}, fsyncs "
        f"{out['fsyncs']}; the copy made while open holds every acknowledged bit "
        f"({out['replayed']} ops replayed from its segments); launches {out['launches']}")
    log(f"phase 13: serial SetBit p50 / p99 with the WAL {out['serial_wal_on_p50_ms']:.3f} / "
        f"{out['serial_wal_on_p99_ms']:.3f} ms, without {out['serial_wal_off_p50_ms']:.3f} / "
        f"{out['serial_wal_off_p99_ms']:.3f} ms ({2 * SERIAL_WRITES} requests each, in turns)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pilosa_tpu_torch import bsi, convert
    from pilosa_tpu_torch.exec import plan as tplan
    from pilosa_tpu_torch.ingest import scatter
    from pilosa_tpu_torch.net.client import InternalClient
    from pilosa_tpu_torch.net.server import Server
    from pilosa_tpu_torch.ops import _build
    from pilosa_tpu_torch.ops import anchored_count as ac
    from pilosa_tpu_torch.ops import bitplane as bp
    from pilosa_tpu_torch.ops import bsi_ripple as br
    from pilosa_tpu_torch.ops import delta_scatter as ds
    from pilosa_tpu_torch.ops import expand_payload as ep
    from pilosa_tpu_torch.ops import fused_popcount as fp
    from pilosa_tpu_torch.ops import score_planes as sp

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
    # The delta-scatter checks draw from their own stream, so the planes
    # of phases 5-6 stay those of the seed.
    rng7 = np.random.default_rng(SEED + 1)
    rng8 = np.random.default_rng(SEED + 2)
    rng4 = np.random.default_rng(SEED + 3)
    max_err = check_k1(fp, bp, rng)
    k7_err = check_k7(ds, scatter, rng7)
    k8_err = check_k8(br, bsi, rng8)
    k4_err = check_k4(sp, rng4)
    rng56 = np.random.default_rng(SEED + 4)
    k6_err = check_k6(ep, bp, rng56)
    k5_err = check_k5(ac, bp, tplan, rng56)

    a = bp.to_device(rng.integers(0, 2**32, size=(N_SLICES, 32768), dtype=np.uint32), "cuda")
    b = bp.to_device(rng.integers(0, 2**32, size=(N_SLICES, 32768), dtype=np.uint32), "cuda")
    k_ms = time_cuda(lambda: fp.row_popcounts(a, b, "and"))
    plain_ms = time_cuda(lambda: fp.plain_row_popcounts(a, b, "and"))
    k_dev = device_ms(lambda: fp.row_popcounts(a, b, "and"), "fused_popcount_kernel")
    bound_ms, bound_by = k1_bound_ms(N_SLICES, True, False, hbm)
    log(f"phase 4: fused_popcount [{N_SLICES}, 32768] and: {k_ms:.4f} ms "
        f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / k_ms:.1%} of it), "
        f"plain {plain_ms:.4f} ms; device time per launch from the profiler {k_dev} ms")
    del a, b
    k7_times = time_k7(ds, scatter, bp, rng7, hbm)
    k8_times = time_k8(br, bsi, hbm)
    k4_times = time_k4(sp, fp, hbm)
    k6_times = time_k6(ep, bp, rng56, hbm)
    k5_times = time_k5(ac, bp, tplan, rng56, hbm)

    with tempfile.TemporaryDirectory(prefix="pilosa-torch-smoke-") as data_dir:
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda")
        srv.open()
        try:
            served = serve_and_check(fp, ds, sp, bp, convert, srv, rng)
            planes = served.pop("planes")
            clustered = cluster_and_check(
                fp, ds, br, sp, scatter, convert, Server, InternalClient, planes, rng
            )
            valued = bsi_and_check(fp, ds, br, scatter, convert, InternalClient, srv, planes, rng)
            timed = time_and_check(fp, InternalClient, srv, planes, rng)
            ranked = topn_and_check(sp, fp, convert, srv, planes)
        finally:
            srv.close()
    # Phase 10 serves on a node of its own: the memory of phases 5-9 is freed.
    del srv, planes
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-tutorials-") as data_dir:
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda", plane_format="auto")
        srv.open()
        try:
            tutorials = tutorials_and_check(ac, ep, fp, sp, bp, InternalClient, srv,
                                            np.random.default_rng(SEED + 10))
        finally:
            srv.close()
        recovery_and_check(Server, ds)
        # Phase 12 reopens phase 10's directory under a budget, every
        # other node closed.
        del srv
        gc.collect()
        resident = residency_and_check(Server, data_dir, tutorials,
                                       {"k1": fp, "k4": sp, "k5": ac, "k6": ep})
    durable = durability_and_check(Server, {"k1": fp})

    k7 = k7_times[K7_SHAPES[1]]  # every slice's queue in one launch, as phase 7 flushes
    kernels = [
        {
            "name": fp.NAME,
            "route": "cuda",
            "source": fp.SOURCE,
            "replaces": fp.REPLACES,
            "launches": served["launches"] + clustered["launches"]
            + valued["launches"]["k1"] + timed["launches"] + ranked["launches"]
            + tutorials["totals"]["k1"] + resident["launches"]["k1"]
            + durable["launches"]["k1"],
            "launches_by_phase": {"5": served["launches"], "6": clustered["launches"],
                                  "7": valued["launches"]["k1"], "8": timed["launches"],
                                  "9": ranked["launches"], "10": tutorials["totals"]["k1"],
                                  "12": resident["launches"]["k1"],
                                  "13": durable["launches"]["k1"]},
            "max_abs_err": max_err,
            "ms": k_ms,
            "device_ms": k_dev,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "checked": max_err == 0.0,
            "topn_shape": {str(r): {k[3:]: v for k, v in k4_times[r].items()
                                    if k.startswith("k1_")} for r in K4_TIMED},
        },
        {
            "name": ds.NAME,
            "route": "cuda",
            "source": ds.SOURCE,
            "replaces": ds.REPLACES,
            "launches": served["k7_launches"] + clustered["k7_launches"] + valued["k7_launches"],
            "launches_by_phase": {"5": served["k7_launches"], "6": clustered["k7_launches"],
                                  "7": valued["k7_launches"]},
            "max_abs_err": k7_err,
            "ms": k7["ms"],
            "device_ms": k7["device_ms"],
            "plain_ms": k7["plain_ms"],
            "bound_ms": k7["bound_ms"],
            "bound_by": k7["bound_by"],
            "library_ms": None,
            "checked": k7_err == 0.0,
            "shape": [k7["jobs"], k7["records"]],
            "empty_launch_ms": k7["noop_ms"],
            "empty_kernel_device_ms": k7["noop_device_ms"],
            "shapes": {f"{j}x{r}": {k: v for k, v in k7_times[(j, r)].items()
                                    if not k.startswith("noop")} for j, r in K7_SHAPES},
            "queue_limit": k7_times["limit"],
        },
    ]
    for kernel in br.KERNELS:
        t = k8_times[kernel]
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": br.SOURCE,
            "replaces": br.REPLACES[kernel],
            "launches": clustered["k8_launches"][kernel] + valued["launches"][kernel],
            "launches_by_phase": {"6": clustered["k8_launches"][kernel],
                                  "7": valued["launches"][kernel]},
            "max_abs_err": k8_err[kernel],
            "ms": t["ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "checked": k8_err[kernel] == 0.0,
            "shape": [N_SLICES, K8_DEPTH],
        }
        if kernel == "bsi_cmp":  # count mode above; row mode (between) here
            entry.update({f"row_mode_{k}": v for k, v in k8_times["bsi_cmp_row"].items()})
        kernels.append(entry)
    k4 = k4_times[K4_TIMED[0]]  # phase 5's TopN(src) shape
    kernels.append({
        "name": sp.NAME,
        "route": "cuda",
        "source": sp.SOURCE,
        "replaces": sp.REPLACES,
        "launches": served["k4_launches"] + clustered["k4_launches"] + ranked["k4_launches"]
        + tutorials["totals"]["k4"] + resident["launches"]["k4"],
        "launches_by_phase": {"5": served["k4_launches"], "6": clustered["k4_launches"],
                              "9": ranked["k4_launches"], "10": tutorials["totals"]["k4"],
                              "12": resident["launches"]["k4"]},
        "max_abs_err": k4_err,
        "ms": k4["ms"],
        "device_ms": k4["device_ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "checked": k4_err == 0.0,
        "shape": [N_SLICES, K4_TIMED[0]],
        f"at_{N_SLICES}x{K4_TIMED[1]}": {k: v for k, v in k4_times[K4_TIMED[1]].items()
                                         if not k.startswith("k1_")},
    })
    kernels.append({
        "name": ac.NAME,
        "route": "cuda",
        "source": ac.SOURCE,
        "replaces": ac.REPLACES,
        "launches": tutorials["totals"]["k5"] + resident["launches"]["k5"],
        "launches_by_phase": {"10": tutorials["totals"]["k5"], "12": resident["launches"]["k5"]},
        "max_abs_err": k5_err,
        "ms": k5_times["ms"],
        "device_ms": k5_times["device_ms"],
        "plain_ms": k5_times["plain_ms"],
        "bound_ms": k5_times["bound_ms"],
        "bound_by": k5_times["bound_by"],
        "library_ms": None,
        "checked": k5_err == 0.0,
        "shape": [N_SLICES, K5_ANCHOR, "dense", K5_SPARSE, K5_RUNS],
    })
    k6 = k6_times["sparse"]
    kernels.append({
        "name": ep.NAME,
        "route": "cuda",
        "source": ep.SOURCE,
        "replaces": ep.REPLACES,
        "launches": tutorials["totals"]["k6"] + resident["launches"]["k6"],
        "launches_by_phase": {"10": tutorials["totals"]["k6"], "12": resident["launches"]["k6"]},
        "max_abs_err": k6_err,
        "ms": k6["ms"],
        "device_ms": k6["device_ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "library_ms": k6["library_ms"],
        "checked": k6_err == 0.0,
        "shape": [N_SLICES, "sparse", K6_SPARSE_POSITIONS],
        "rle": {k: v for k, v in k6_times["rle"].items() if k != "library_ms"},
        "dense": {k: v for k, v in k6_times["dense"].items() if k != "library_ms"},
    })
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
