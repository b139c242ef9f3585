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
   1, 7 and 954 slices x 7 leaves of every format and absent rows in one
   launch, rows on the windows' edges and a run over many windows, the
   anchor a leaf of every format (32,768, 1 and 0 positions, up to 2^20 -
   1, the edges, the long run) read by the tree or not, or none (-1),
   eight trees (one nested 11 sets deep, one 64); for the delta-scatter (K7) the
   one-plane interface on edge queues and 1 to 8,192 entries, and
   batches of one launch each: one bit set and cleared within and across
   queues, mirrors of 8, 16 and 65,536 rows in one launch, empty queues,
   one mirror twice, and 954 mirrors at once; for the fused tree eval (K2)
   1, 3 and 954 slices of 1 to 8 leaves, every fold, nested trees, a
   single leaf, Union(), Difference and Xor chains and a tree past its
   stack (which must run on K3), with absent, scratch and mirror rows of
   8, 64 and 65,536 rows in one table, count / row / total; for the
   interpreter (K3) FuseEmitter tables of 1, 2 and 16 programs with shared
   subtrees, MASKW over predicate rows of depth 1, 31 and 62, a full
   256-op table over 64 leaves, count / row / total; for the stream-floor
   read-sum (K11) 1, 7, 1,023 and 2^20 + 7 words and the probe's own size,
   each all zeros, all ones, all 0xFFFFFFFF and seeded random words; for
   the mesh TopN scorer (K9) 1, 3 and 954 slices of 1, 70 and 8 rows, both
   reduces, random, all-zero, all-ones and strided src rows; for ``top_k``
   1 to 100,000 counts (up to three rounds), k of 1 to 1,024 and past n,
   ties, all equal, all zero, int32 and int64;
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
   dense, a sparse and an RLE leaf], against the bound with the anchor
   read as a leaf of the tree and the one with the anchor uploaded; K2
   count and row at [954 slices, 2 leaves] (the row mode beside
   ``torch.bitwise_and``) and K3 count with 16 programs over 8 union leaves at 954
   slices, every leaf a row of one of 954 8-row mirrors; K11 at the
   probe's size (at least 8x the L2) with ``torch.sum`` of int32 beside
   it, and the probe's GB/s at that size and at the JAX package's 32 MiB,
   which the L2 holds; K9 at [954, 8, 32768] with a src row a slice, both
   reduces; ``top_k`` at query_step's 8 counts, k 4, and at 954 x 8, k 10,
   beside ``torch.sort(stable=True)[:k]``;
5. serve a 1B-column index — 954 slices x 8 dense rows, seeded random
   words, about 1 GiB on the card — with ``Server(device="cuda")`` and
   answer Count/Bitmap/TopN/SetBit over HTTP, every answer checked
   against a numpy oracle over the same planes, with the kernels'
   launch counts reset just before and read just after (each Count and
   Bitmap over a tree: one K2 launch through the coalescer, no K1;
   TopN(src): one K4 launch at the first request, none at the repeats,
   which reuse the cached prep and its scores); the TopN prep cache
   (repeats build nothing, a SetBit between two TopN(src)s makes one
   build and one K4, 8 threads asking at once make one of each); the
   SetBits' p50, each answered after its WAL group commit; a batch build
   and a cache hit timed; the node's open runs the stream-floor probe
   (K11, once per process); then phase 14 on the same node;
6. a cluster on the one card: three ``Server(device="cuda")`` nodes of
   an http cluster with 2 replicas; the schema created on one node
   reaches the others by broadcast; each node loads the phase-5 planes
   of the slices it owns (~2 GiB of mirrors); then a protobuf
   ``/import`` of 2^19 seeded bits (~550 per fragment), which must
   launch nothing on the card (the bits queue on the host), and the
   first Count after it, which applies the queues of every fragment a
   node reads with one delta-scatter launch per node leg;
   Count/TopN queries to every node in protobuf
   and JSON checked against the numpy oracle (each Count: one K2 launch
   per node leg, no K1; TopN(src): one K4 launch per node leg and round);
   a BSI field created on one
   node (its fan-out reaches the others), ``/import-value`` to every
   owner of 64 slices, Count(Range)/Sum/Min/Max from every node; a
   second import into new rows over the first 64 slices (the counted
   fallback to a mirror re-upload), and the Counts and the BSI queries again with one node
   closed (replica failover); launch counts reset just before and read
   just after;
7. on the phase-5 node, a signed 32-bit integer field over the 954
   slices (~4.13 GB of planes, seeded word by word): Count(Range) for
   every comparison and between, a Range inside Intersect, Sum/Min/Max
   with and without a filter, checked against a numpy oracle that
   decodes every column's value; a BSI Count, Sum and Bitmap asked twice,
   the second from the batch cache (``batch_cache=hit``); a shallow
   field w (depth 8) beside it, and a storm of 3 BSI trees over w, 1 over
   v and 4 row trees through the coalescer; w's comparisons that fit the
   coalescer's op budget as one fused K3 launch timed against their K8
   launches; then an ``/import-value`` of 2^15
   values over every slice, which launches nothing, and the first read
   after it, which applies all 954 queues (with and-not entries) in ONE
   delta-scatter launch; one import past a queue's limit on one slice
   (the counted fallback); the queries again after each;
8. on the phase-5 node, a time-quantum frame (YMD) over 16 slices:
   SetBits with timestamps and a protobuf ``/import`` of 2^16 bits over
   40 days, then Range(start, end) counts inside a month, across the
   month boundary and over the year, plain and inside Intersect,
   against numpy over the written triples (one K2 launch a request, the
   time views' union a scratch row of the cached batch);
9. on the phase-5 node, a TopN frame of 64 rows per fragment over the 954
   slices (1B columns, 8 GiB of mirrors), row k at density
   0.5 * 2^(-k/8), generated on the card slice by slice: TopN without a
   src, self-src, row-src (a tree over phase 5's frame), with threshold,
   tanimotoThreshold and ids, against a numpy oracle of per-slice scores;
10. on a node of its own at the JAX package's defaults (dense budget
    65,536, plane-format auto, 64 KiB caps), the two tutorials of
    docs/tutorials.md loaded through ``/import``: the star trace (index
    ``repository``, 2^17 stargazers in a random permutation, Zipf stars,
    1% of them starring a run of repositories, 2 slices: two tall
    fragments with 8 GiB plane tiers; 64 languages) and the chemical
    similarity (index ``mole``, 2^17 molecules x 1,024 positions, ~48
    bits each, frame ``fingerprint`` with inverse storage: a tall inverse
    fragment); Counts through K5, Union/Bitmap/TopN srcs through K6, TopN
    over both tiers, a SetBit into a sparse row, ``Bitmap(molecule_id=m)``
    and the tanimoto TopN on the inverse view, every answer against a
    numpy oracle over the written pairs, the launches of K1, K2, K4, K5
    and K6 counted around each query class (a cached batch expands its
    sparse rows with K6 once, at its build);
11. recovery on the card: a port node's data directory with a torn
    op-log tail and a WAL segment of a JAX node's (written with the
    port's encoder) reopens with the oracle's answers, restarts the
    segment at its checkpoint snapshot, applies a later write with one
    delta-scatter launch, and replays nothing twice;
12. residency under a budget: every other node closed, phase 10's
    directory reopens with ``hbm_budget_bytes`` of 12 GiB (three 8 GiB
    plane tiers; staging from its ``.residency.json`` in the
    background), and four of phase 10's query classes on repository
    (``RESIDENCY_QUERIES``: a saturating Count and one query for each of
    K4, K5 and K6) alternate with its mole queries (K1, K2), each answer
    against the oracle; after every query the
    pool's resident and high-water bytes, evictions, skipped evictions,
    over-budget admissions, restaged bytes, the batch cache's bytes and the
    allocator's ``memory_allocated()`` / ``memory_reserved()`` are printed and
    checked (within the budget outside pinned saturation; evictions > 0;
    a query pinning both 8 GiB star mirrors saturates and answers
    right); the time to the first answer, the staging job's end and one
    eviction-driven 8 GiB re-upload are timed;
13. durability: on a node of its own with the WAL on, 8 threads send 250
    SetBits each over HTTP across 16 slices; the data directory copied
    while the node is open opens in a second node with every
    acknowledged bit; ``/debug/ingest`` shows fewer fsyncs than appends;
    serial SetBit p50 / p99 with the WAL on and off, in turns;
14. the coalesced query path, on the phase-5 node right after phase 5:
    serial Count(Intersect(Bitmap(0), Bitmap(1))) — the first request a
    cache miss (after a SetBit), the rest hits, then a SetBit and the
    Count again (a rebuild, the answer one more), one K2 launch a request
    and no K1; then a storm of 64 client threads x 6 requests drawn from
    16 distinct trees over the 8 rows, as Count over every slice and as
    Bitmap (the tree intersected with a row of frame g, over 16 slices),
    every answer against numpy, in turns with coalescing on, off, off, on
    (off: the scheduler closed, the direct K2 path serves): requests/s,
    p50 / p99, the scheduler's snapshot; coalesced turns launch fewer
    times than they answer and fuse (K3);
15. print the ``kernels`` JSON line (K1-K9, K11, ``top_k``), then the final JSON line
    (last of all, after phase 17);
16. observability, on the phase-5 node right after phase 14 (run before
    phase 6) and on phase 6's cluster: ``/debug/perf``'s stream floor
    (above 0, at most 105% of the data-sheet rate, so the probe read
    device memory) and every site's ``floorPct`` (at most 105%); in a
    window with every kernel counter and the site table at 0, serial
    Counts, TopN(src) and a short storm with coalescing on and off, after
    which the per-site launches equal the kernels' own counters
    (``direct`` + ``total`` + ``coalesce`` = K2, ``interp`` = K3, ``topn``
    = K4, ``anchored`` = K5); ``/metrics`` parsed line by line and
    carrying the JAX package's counters; the p50 per-stage breakdown of
    20 serial Count(Intersect) hits from ``/debug/traces`` (the HTTP
    layer's own time beside it); a ``/debug/profile?seconds=2`` under a
    storm and the card's idle share from its trace; Count p50 with the
    telemetry (launch records and traces) on and off in 4 turns of 20; and
    on phase 6's cluster one TopN trace that covers all three nodes;
17. backup, restore and repair, on the phase-5 node after phase 9: the
    CLI's ``backup`` of frames f (954 fragments, ~1 GB) and g to files
    (bytes, seconds, GB/s); a second ``Server(device="cuda")`` with the
    schema and the CLI's ``restore`` (seconds, GB/s); phase 5's Count
    trees, Bitmap, TopN and TopN(src) there, equal to the source node's
    answers and to numpy over the archives' planes decoded on the host,
    K2 and K4 launched (the first Count, which uploads the mirrors, and
    the p50 timed); ``/fragment/blocks`` equal on both nodes for every
    fragment, then a few hundred bits set and cleared on the source in
    four fragments make exactly their block differ, the differences read
    through ``/fragment/block/data`` and pushed with
    ``/fragment/import-view``, the next Count applying them in one K7
    launch and equal to the source, the blocks equal again; a restore in
    place of a fragment with a resident mirror and a cached batch entry
    (the next Count equals numpy of the new contents) and a torn archive
    refused with 422 (no answer changes); one slice's ``/export`` (~4.2M
    bits, ~55 MB of CSV — a cut: the index's whole export would be ~55
    GB) equal to numpy's formatting byte for byte;
18. device health and the host fallback, on the phase-5 node right after
    phase 16 (run before phase 6; the node opened with a 300 ms
    quarantine window), driven by ``testing/faults.py``: (a) one injected
    launch error — the Count retried once and answered by K2, the path
    healthy; (b) an error on every attempt — three Counts take the path
    suspect, suspect, quarantined, each answered from the host planes
    with no kernel launched; (c) while quarantined, Count, Bitmap, TopN,
    TopN(src) and a BSI comparison and Sum on a small field (depth 8, 64
    slices) each equal to the oracle with no K2-K8 launch at all (a
    TopN(src)'s src, prep and scores all come from the host), the host's
    p50 against the
    card's for Count(Intersect) and TopN(src) at 954 slices, SetBits that
    queue on the host, ``/debug/health`` quarantined and
    ``pilosa_device_health_*`` on ``/metrics``; (d) the plan cleared and
    the window past, the next Count is the probe — one K2 and one K7
    launch (the SetBits applied), healed, a staging job started; (e) an
    injected OOM on the scorer — no retry, counted, the host's scores;
    (f) a real ``torch.OutOfMemoryError`` (an allocation past the card's
    memory) classified ``oom``, and a kernel's illegal-address error no
    device fault (built, not raised); and (g) after every other phase no device
    fault was classified and no host answer given anywhere in the
    process, and the phase-5 node's ``/debug/health`` reads healthy;
19. the multi-device data plane, on the phase-5 node right after phase 16
    (run before phase 18), with K2, K4, K9 and ``top_k``'s counts set to 0
    just before and read just after: (a) on a mesh of four members of
    ``cuda:0`` (``bitplane.set_local_members``) and on a one-member mesh,
    ``distributed_count``, ``distributed_topn`` and ``query_step`` at
    phase 5's shapes, each equal to numpy; (b) the phase-5 node's
    directory copied while it serves (its rank caches flushed first) and
    reopened with ``Server(mesh_devices=4)``: Count(Intersect), Count,
    Count(Union), Count(Xor), Bitmap, TopN and TopN(src) equal to the
    one-member node's answers, each Count launching K2 once a member and
    the first TopN(src) K4 once a member, a SetBit and a ClearBit between
    reads, 8 threads at once, ``/debug/perf``'s ``collective`` site; (c)
    an injected ``collective`` hang tripped by the watchdog and answered
    right from the per-member partials, the path quarantined; and (d)
    with two or more cards, the copy reopened by a node on the bare
    ``cuda``, whose slices spread over every card (the default on such a
    host), checked as in (b) against the one-card node, then a mesh over
    the cards and a two-process NCCL Count (otherwise one line says why
    it did not run); no collective fallback anywhere else in the run.

Every phase but 19 (d) runs on card 0 alone (``bitplane.
set_local_members``), so that its launch counts are a one-card node's on
a host with several cards too.

Exits non-zero when ``torch.cuda.is_available()`` is false, and when the
port's package is not beside this file.
"""

from __future__ import annotations

import contextlib
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
CLUSTER_REPS = 1
IMPORT_BITS = 1 << 19
# The second import (bits in new rows, the counted fallback) over the first
# slices only: each touched fragment replica re-snapshots and re-uploads.
FALLBACK_SLICES = 64
FALLBACK_IMPORT_BITS = 1 << 12
# Phase 6's BSI leg: values over the first slices.
CLUSTER_BSI_SLICES = 64
CLUSTER_BSI_VALUES = 1 << 14
# Phase 7: the first /import-value (every slice, the K7 path with clears); the
# second goes past its queue's limit on one slice (the counted fallback).
BSI_IMPORT_VALUES = 1 << 15
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


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's record, with the seconds since the script
    started (where the run's time limit goes)."""
    print(f"{msg}  [t+{time.perf_counter() - _T0:.1f}s]", flush=True)


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
    ("Intersect", ("leaf", 1), k5_deep_tree(9)),  # 11 sets deep
    ("Union", ("Intersect", ("leaf", 5), ("leaf", 6)), ("Difference", ("leaf", 6), ("leaf", 0))),
    ("Intersect", ("leaf", 5), ("Union", ("leaf", 6), k5_deep_tree(61))),  # 64 deep
)
# K5's windows: 1,024 words (32,768 positions) a block, 512 for the
# deepest programs.
K5_EDGES = (0, 16383, 16384, 32767, 32768, 65535, 65536, (1 << 20) - 32769, (1 << 20) - 32768,
            (1 << 20) - 1)


def k5_extra_rows(bp, s: int) -> list:
    """Leaves 5 and 6 of slice s: positions and short runs on the windows'
    edges, and one run over many windows, each in the format s picks."""
    edges = np.array(K5_EDGES, np.int64)
    near = np.concatenate([np.arange(e - 2, e + 3) for e in edges[1:-1]])
    on_edges = np.unique(np.concatenate([edges, near[:: 1 + s % 3]])).astype(np.uint32)
    long_run = np.arange(1000 + s, 200_000 + 7 * s, dtype=np.uint32)
    return [k56_payload(bp, on_edges, s % 3), k56_payload(bp, long_run, (s + 1) % 3)]


def check_k5(ac, bp, plan, rng) -> float:
    """K5 against its plain version on the card, exactly: 1, 7 and 954
    slices; 7 leaves a slice: 4 drawn from every kind of :func:`k56_row`
    in its own format (dense words, positions, runs; the edges; empty
    payloads) and absent rows, so every format mix meets in one launch,
    leaf 4 an anchor set (32,768, 1 and 0 positions, the last 300 up to
    2^20 - 1) that no tree reads, and :func:`k5_extra_rows`; the anchor
    leaf 4, 5 (the edges), 6 (the long run), 0 (a leaf the trees read) or
    none (-1), slice by slice; eight trees, one 11 sets deep and one 64
    (at full width every other tree, the deep ones among them).
    A ``torch.cuda.synchronize()`` after each launch.  Returns the
    largest absolute difference (0)."""
    import torch

    sw = bp.SLICE_WIDTH
    worst, n_checks = 0, 0
    for n in K56_SLICES:
        leaves, anchor_leaf = [], []
        for s in range(n):
            row = []
            for i in range(4):
                k = int(rng.integers(0, 8))
                row.append(None if k == 7 else k56_payload(bp, k56_row(bp, rng, k)))
            a = s % 4
            anchor = (np.sort(rng.choice(sw, size=K5_ANCHOR, replace=False)) if a == 0
                      else np.array([sw - 1]) if a == 1 else np.array([], np.int64)
                      if a == 2 else np.arange(sw - 300, sw))
            row.append(k56_payload(bp, anchor.astype(np.uint32)) if len(anchor) else None)
            leaves.append(row + k5_extra_rows(bp, s))
            anchor_leaf.append((4, 5, 6, 0, -1)[s % 5])
        anchor_leaf = np.array(anchor_leaf, np.int32)
        # At full width every other tree (both deep ones among them): the
        # plain version takes seconds a call there.
        for expr in K5_TREES if n < N_SLICES else K5_TREES[1::2]:
            before = ac.launches
            got = plan.anchored_count(expr, anchor_leaf, leaves, "cuda")
            torch.cuda.synchronize()
            if ac.launches != before + 1:
                raise AssertionError(f"anchored_count: {ac.launches - before} launches")
            want = ac.plain_anchored_count(plan.compile_program(expr), anchor_leaf, leaves,
                                           "cuda")
            torch.cuda.synchronize()
            diff = int((got.long() - want.long()).abs().max())
            worst = max(worst, diff)
            n_checks += 1
            if diff:
                raise AssertionError(f"anchored_count != plain: {n} slices, {expr}, diff {diff}")
    log(f"phase 3: anchored_count == plain on {n_checks} launches (max_abs_err {worst}): 1, 7 "
        f"and {N_SLICES} slices x 7 leaves of every format and absent rows mixed in one launch, "
        "rows on the windows' edges and a run over many windows; anchors of every format "
        "(32,768, 1 and 0 positions, up to 2^20 - 1, the edges, the long run) read by the tree "
        f"or not, or none; eight trees (one 11 deep, one 64), four of them at {N_SLICES}")
    return float(worst)


def k6_bound_ms(payload_bytes: int, rows: int, hbm: float) -> tuple[float, str]:
    """Least time for one K6 launch: the payloads and the table read once,
    128 KiB written per row."""
    nbytes = payload_bytes + rows * 32 + rows * 32768 * 4
    return nbytes / hbm * 1e3, "bytes"


def k5_bound_ms(positions: int, anchor_in_tree: bool, leaf_bytes: int, slices: int,
                leaves: int, hbm: float) -> tuple[float, str]:
    """Least time for one K5 launch: every leaf's encoded bytes read once,
    the anchor's too (4 B a position, as the JAX package's eff_bytes
    counts it) where it is not a leaf the tree reads, and the table (an
    anchor index and 3 int64 a leaf per slice) and 4 B out per slice."""
    nbytes = leaf_bytes + slices * (8 + 24 * leaves) + 4 * slices
    if not anchor_in_tree:
        nbytes += 4 * positions
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


def k5_phase4_case(bp, rng) -> dict:
    """Phase 4's K5 inputs: 954 slices, three leaves — leaf 0 a row of a
    954-row mirror (read in place, as a plane row is) whose 32,768 bits
    are the anchor, a K5_SPARSE-position leaf and a K5_RUNS-run leaf —
    and the anchor's host positions (uint32 [954, 32,768], which an
    uploaded-anchor design reads)."""
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
    return {"leaves": leaves, "anchor_leaf": np.zeros(N_SLICES, np.int32), "anchors": anchors,
            "expr": K5_TREES[0]}


def time_k5(ac, bp, plan, rng, hbm: float) -> dict:
    """K5 at :func:`k5_phase4_case`'s shape, the anchor leaf 0: back to
    back, device time, plain version, and two bounds: the anchor read as
    the tree's own leaf (this design) and the anchor uploaded besides (4 B
    a position, the JAX package's eff_bytes)."""
    case = k5_phase4_case(bp, rng)
    leaves, anchor_leaf = case["leaves"], case["anchor_leaf"]
    program = plan.compile_program(case["expr"])
    k_ms = time_cuda(lambda: ac.anchored_count(program, anchor_leaf, leaves, "cuda"),
                     runs=11, per_run=5)
    k_dev = device_ms(lambda: ac.anchored_count(program, anchor_leaf, leaves, "cuda"),
                      "anchored_count_kernel", launches=20)
    # The plain version takes seconds a call: timed once.
    plain_ms = time_cuda(lambda: ac.plain_anchored_count(program, anchor_leaf, leaves, "cuda"),
                         runs=1, per_run=1, warmup=0)
    # Encoded bytes as the JAX package's eff_bytes counts them: a dense row
    # 128 KiB, positions and runs at their bucketed payload sizes.
    leaf_bytes = N_SLICES * (32768 * 4 + 4 * bp.payload_bucket(K5_SPARSE)
                             + 8 * bp.payload_bucket(K5_RUNS))
    positions = case["anchors"].size
    bound_ms, bound_by = k5_bound_ms(positions, True, leaf_bytes, N_SLICES, 3, hbm)
    upload_bound_ms, _ = k5_bound_ms(positions, False, leaf_bytes, N_SLICES, 3, hbm)
    share = bound_ms / k_dev if k_dev else float("nan")
    log(f"phase 4: anchored_count [{N_SLICES} slices, {K5_ANCHOR}-position anchors, leaves "
        f"dense (the anchor) / {K5_SPARSE} positions / {K5_RUNS} runs]: {k_ms:.4f} ms back to "
        f"back, device {k_dev} ms ({share:.1%} of the bound), bound {bound_ms:.4f} ms by "
        f"{bound_by} (the anchor a leaf of the tree; {upload_bound_ms:.4f} ms with the anchor "
        f"uploaded, {upload_bound_ms / k_dev if k_dev else float('nan'):.1%}), "
        f"table {N_SLICES * (8 + 24 * 3) + 8 * len(program)} B up a call, "
        f"plain {plain_ms:.4f} ms")
    return {"ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "upload_bound_ms": upload_bound_ms, "library_ms": None}


# --- K2 and K3: the fused tree eval and the multi-query interpreter -----------

K23_SLICES = (1, 3, N_SLICES)
# Phase 3's K2 slice counts: the coalescer's Bitmap storm (16) and four
# node tables concatenated (under coalesce.MAX_CONCAT_ROWS) besides.
K2_SLICES = (1, 3, 16, N_SLICES, 4 * N_SLICES)
# Mirror heights mixed in one K2 table: 8 (phase 5's fragments), 64 and a
# full dense tier (65,536 rows, 8 GiB: row addresses past 2^32 bytes).
K2_MIRROR_ROWS = (8, 64, 65536)


def k2_chain(depth: int) -> tuple:
    """A right-nested tree that keeps ``depth`` + 1 rows on K2's stack."""
    ops = ("Intersect", "Union", "Xor", "Difference")
    expr = ("leaf", depth % 8)
    for k in reversed(range(depth)):
        expr = (ops[k % 4], ("leaf", k % 8), expr)
    return expr


def k2_trees() -> list:
    """Every fold, nested trees, a single leaf, Union(), Difference and
    Xor chains, a tree 11 deep and one past K2's stack (it runs on K3);
    9 and 16 leaves and a depth-8 tree of 11 pushes (the kernel's general
    variant), a depth-8 chain of 8 pushes (its fast variant's widest)."""
    leaf = [("leaf", i) for i in range(16)]
    return [
        leaf[0],
        ("Intersect", leaf[0], leaf[1]),
        ("Union", leaf[0], leaf[1], leaf[2]),
        ("Difference", leaf[0], leaf[1], leaf[2], leaf[3]),
        ("Xor", leaf[0], leaf[1], leaf[2], leaf[3], leaf[4]),
        ("Union",),
        ("Intersect", leaf[2], ("Union",)),
        ("Difference", ("Union", *leaf[:3]), ("Intersect", leaf[3], leaf[4]),
         ("Xor", leaf[5], leaf[6], leaf[7])),
        ("Xor", ("Difference", leaf[7], leaf[0]), ("Intersect", leaf[1], leaf[2], leaf[3])),
        ("Intersect", leaf[1], k5_deep_tree(9)),
        k2_chain(20),
        ("Union", *leaf[:9]),
        ("Xor", ("Intersect", *leaf[:4]), ("Union", *leaf[4:8]), ("Difference", *leaf[8:12]),
         ("Xor", *leaf[12:16])),
        k2_chain(7),
        ("Difference", ("Intersect", *leaf[8:12]), k2_chain(6)),
    ]


def n_leaves(expr) -> int:
    if expr[0] == "leaf":
        return expr[1] + 1
    return max([n_leaves(e) for e in expr[1:]], default=1)


def k2_bases(rng):
    """The bases of phase 3's K2 tables: a zero row, 16 scratch rows, and
    one mirror of each of K2_MIRROR_ROWS rows, all of random words
    (generated on the card)."""
    import torch

    def rand(rows):
        return torch.randint(-2**31, 2**31, (rows, 32768), dtype=torch.int32, device="cuda",
                             generator=gen)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(0, 2**31)))
    zero = torch.zeros(1, 32768, dtype=torch.int32, device="cuda")
    return [zero, rand(16)] + [rand(r) for r in K2_MIRROR_ROWS]


def k2_table(te, bases, n: int, n_cols: int, rng):
    """A row table of ``n`` slices x ``n_cols`` leaves whose rows are drawn
    from every base: absent (zero), scratch and mirror rows, the last row
    of the 65,536-row mirror included."""
    rows = [b.shape[0] for b in bases]
    idx = np.zeros((n, n_cols, 2), dtype=np.int64)
    idx[..., 0] = rng.integers(0, len(bases), size=(n, n_cols))
    idx[..., 1] = rng.integers(0, 2**31, size=(n, n_cols)) % np.asarray(rows)[idx[..., 0]]
    idx[0, 0] = (len(bases) - 1, rows[-1] - 1)
    return te.RowTable(bases, idx)


def check_k2(te, it, plan, rng) -> float:
    """K2 against its plain version on the card, exactly: 1, 3, 16 and 954
    slices, and 3,816 (four checked 954-slice tables concatenated, as the
    coalescer concatenates, under its 4,096-slice cap); 1 to 16 leaves;
    every tree of :func:`k2_trees` (the one past the stack cap through
    ``plan.tree_eval``, which must launch K3 and not K2); absent, scratch
    and mirror rows of 8, 64 and 65,536 rows in one table; count, row and
    total.  Returns the largest absolute difference (0)."""
    import torch

    bases = k2_bases(rng)
    worst, n_checks, variants = 0, 0, {}
    for n in K2_SLICES:
        for expr in k2_trees():
            if n > N_SLICES:
                parts = [k2_table(te, bases, N_SLICES, n_leaves(expr), rng)
                         for _ in range(n // N_SLICES)]
                for t in parts:
                    t.check()
                table = te.RowTable.concat_slices(parts)
                assert table.checked
            else:
                table = k2_table(te, bases, n, n_leaves(expr), rng)
            program = plan.compile_program(expr)
            deep = te.program_depth(program, table.shape[1]) > te.MAX_DEPTH
            variant = "k3" if deep else ("fast" if te.resolve(program) is not None else "general")
            for reduce in ("count", "row", "total"):
                k2, k3 = te.launches, it.launches
                got = plan.tree_eval(expr, reduce, table)
                torch.cuda.synchronize()
                if (te.launches - k2, it.launches - k3) != ((0, 1) if deep else (1, 0)):
                    raise AssertionError(f"tree_eval {expr}: {te.launches - k2} K2 and "
                                         f"{it.launches - k3} K3 launches")
                want = te.plain_tree_eval(table, program, reduce)
                torch.cuda.synchronize()
                diff = int((got.long() - want.long()).abs().max())
                worst = max(worst, diff)
                n_checks += 1
                if diff or got.shape != want.shape:
                    raise AssertionError(f"tree_eval != plain: {n} slices, {expr}, {reduce}, "
                                         f"diff {diff}")
                variants[variant] = variants.get(variant, 0) + 1
            del table, want, got
    del bases
    torch.cuda.empty_cache()
    log(f"phase 3: tree_eval == plain on {n_checks} launches (max_abs_err {worst}; by variant "
        f"{json.dumps(variants)}): {', '.join(map(str, K2_SLICES))} slices (the last four "
        f"checked {N_SLICES}-slice tables concatenated), 1 to 16 leaves, every fold, nested "
        "trees, a single leaf, Union(), Difference and Xor chains, depth 8 in both variants, "
        "absent / scratch / mirror rows of 8, 64 and 65,536 rows in one table, count / row / "
        "total; a tree past the stack cap ran on interp")
    return float(worst)


def storm_exprs() -> list:
    """16 distinct trees over 8 leaves (the phase-14 storm's trees), with
    shared subtrees."""
    leaf = [("leaf", i) for i in range(8)]
    return [
        ("Intersect", leaf[0], leaf[1]),
        ("Union", leaf[2], leaf[3]),
        ("Difference", leaf[4], leaf[5]),
        ("Xor", leaf[6], leaf[7]),
        ("Intersect", leaf[0], leaf[1], leaf[2]),
        ("Union", ("Intersect", leaf[0], leaf[3]), leaf[5]),
        ("Difference", ("Union", leaf[1], leaf[2]), leaf[7]),
        ("Xor", ("Intersect", leaf[2], leaf[4]), ("Intersect", leaf[3], leaf[5])),
        ("Intersect", ("Union", leaf[0], leaf[1]), ("Union", leaf[6], leaf[7])),
        ("Difference", leaf[6], leaf[0], leaf[1], leaf[2]),
        ("Union", leaf[4], leaf[5], leaf[6], leaf[7]),
        ("Intersect", ("Xor", leaf[0], leaf[2]), ("Difference", leaf[3], leaf[1])),
        leaf[5],
        ("Intersect", leaf[1], leaf[7]),
        ("Union", ("Difference", leaf[0], leaf[4]), ("Xor", leaf[5], leaf[6])),
        ("Difference", ("Intersect", leaf[2], leaf[3], leaf[4]), leaf[0]),
    ]


def k3_programs(plan, exprs, n_leaves_: int):
    """``exprs`` lowered into one table over ``n_leaves_`` leaves: (table,
    out_idx)."""
    em = plan.FuseEmitter(n_leaves_)
    regs = [plan.lower_expr(e, 0, em) for e in exprs]
    return em.table(), np.asarray(list(dict.fromkeys(regs)), dtype=np.int32)


def k3_bsi_case(bsi, plan, depth: int, rng):
    """A BSI field's leaves — exists, sign, ``depth`` planes, two
    predicate rows — and every comparison plus a between lowered into one
    table (the MASKW path): (leaf rows uint32 [n_leaves, 32768], table,
    out_idx)."""
    n = 2 + depth + 2
    words = rng.integers(0, 2**32, size=(n, 32768), dtype=np.uint32)
    words[2 + depth] = bsi.pred_row(int(rng.integers(-(2**depth) + 1, 2**depth)), depth)
    words[3 + depth] = bsi.pred_row(int(rng.integers(0, 2**depth)), depth)
    # Past the coalescer's op budget at depth 31 and 62: the kernel sizes
    # its tile from the table (128, 64 and 32 words here).
    em = plan.FuseEmitter(n, max_ops=4096)
    planes = list(range(2, 2 + depth))
    regs = [plan.ripple.lower_signed_cmp(em, op, 0, 1, planes, 2 + depth)
            for op in ("lt", "le", "eq", "ne", "ge", "gt")]
    regs.append(plan.ripple.lower_between(em, 0, 1, planes, 2 + depth, 3 + depth))
    return words, em.table(), np.asarray(regs, dtype=np.int32)


def k3_full_table(rng):
    """A full 256-op table over 64 leaves: random folds of earlier
    registers and MASKW over leaves, every op's result selected."""
    ops = np.zeros((256, 4), dtype=np.int32)
    for i in range(256):
        if i % 16 == 15:
            a = int(rng.integers(0, 64))
            ops[i] = (4, a, a, int(rng.integers(0, 32768)))
        else:
            ops[i] = (int(rng.integers(0, 4)), int(rng.integers(0, 64 + i)),
                      int(rng.integers(0, 64 + i)), 0)
    return ops, np.arange(64, 64 + 256, dtype=np.int32)


K3_SLICES = (1, 3, 16, N_SLICES)


def k3_edge_tables(n_leaves: int = 8) -> list:
    """K3 tables at the edges of its design, over ``n_leaves`` leaves, as
    (name, table, out_idx): a chain that forwards every operand after the
    first, a table that forwards none, ``x ^ x`` and and-nots of the
    previous result (forwarded as the first operand after a swap), and
    maskw of leaves 2 and 3's first and last words beside an odd number of
    leaf outputs."""
    last = 32767
    chain = [(0, 0, 1, 0)] + [(i % 4, n_leaves + i - 1, i % n_leaves, 0) for i in range(1, 40)]
    none = [(i % 4, i % n_leaves, (i + 1) % n_leaves, 0) for i in range(n_leaves)]
    swaps = [(0, 0, 1, 0), (3, n_leaves, n_leaves, 0), (2, 2, n_leaves + 1, 0),
             (2, 3, n_leaves + 2, 0), (1, n_leaves + 3, n_leaves, 0)]
    masks = [(4, 2, 2, 0), (4, 2, 2, last), (4, 3, 3, 0), (4, 3, 3, last),
             (0, n_leaves, 0, 0), (1, n_leaves + 1, n_leaves + 2, 0),
             (3, n_leaves + 3, n_leaves + 5, 0), (2, 1, n_leaves + 4, 0)]
    return [
        ("forward-all", np.asarray(chain, np.int32),
         np.asarray([n_leaves + 39, n_leaves + 20], np.int32)),
        ("forward-none", np.asarray(none, np.int32),
         np.arange(n_leaves, 2 * n_leaves, dtype=np.int32)),
        ("swaps", np.asarray(swaps, np.int32),
         np.asarray([n_leaves + 1, n_leaves + 2, n_leaves + 3, n_leaves + 4], np.int32)),
        ("maskw-first-last", np.asarray(masks, np.int32),
         np.asarray([n_leaves + j for j in range(8)] + [5], np.int32)),
    ]


def k3_mask_rows(table) -> None:
    """Bit 0 of word 0 set and of the last word clear in leaf 2 of every
    slice of ``table``, the other way in leaf 3 (written in place)."""
    for s in range(table.shape[0]):
        for leaf, (w0, w1) in ((2, (1, 0)), (3, (0, 1))):
            b, r = table.index[s, leaf]
            row = table.bases[int(b)][int(r)]
            row[0] = (row[0] & ~1) | w0
            row[-1] = (row[-1] & ~1) | w1


def check_k3(te, it, plan, bsi, rng) -> float:
    """K3 against its plain version on the card, exactly: tables from
    FuseEmitter holding 1, 2 and 16 programs with shared subtrees over 8
    leaves and the edge tables of :func:`k3_edge_tables` (forward every
    operand, forward none, swapped and-nots, maskw of the first and last
    words beside an odd number of leaf outputs) at 1, 3, 16 and 954
    slices; MASKW over predicate rows of depth 1, 31 and 62 (every
    comparison and a between, from lower_signed_cmp / lower_between; 1 and
    3 slices); a full 256-op table over 64 leaves (1 and 3 slices: the
    largest leaf buffer); every block shape in both variants on the edge
    tables, with the kernel's shared-memory figure against smem_bytes;
    count, row and total.  Returns the largest absolute
    difference (0)."""
    import torch

    def diff_of(got, want, what):
        nonlocal worst, n_checks
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        worst = max(worst, diff)
        n_checks += 1
        if diff or got.shape != want.shape:
            raise AssertionError(f"interp != plain: {what}, diff {diff}")

    def one(table, prog, out_idx, what):
        for reduce in ("count", "row", "total"):
            before = it.launches
            got = plan.interp_exec(reduce, table, prog, out_idx)
            torch.cuda.synchronize()
            if it.launches != before + 1:
                raise AssertionError(f"interp: {it.launches - before} launches")
            diff_of(got, it.plain_interp(reduce, table, prog, out_idx), f"{what}, {reduce}")

    worst, n_checks = 0, 0
    bases = k2_bases(rng)
    exprs = storm_exprs()
    edges = k3_edge_tables()
    for n in K3_SLICES:
        table = k2_table(te, bases, n, 8, rng)
        k3_mask_rows(table)
        for k in (1, 2, 16):
            prog, out_idx = k3_programs(plan, exprs[:k], 8)
            one(table, prog, out_idx, f"{k} programs, {n} slices")
        for name, prog, out_idx in edges:
            one(table, prog, out_idx, f"{name}, {n} slices")
    table = k2_table(te, bases, 3, 8, rng)
    k3_mask_rows(table)
    n_shapes = 0
    for name, prog, out_idx in edges:
        alloc = it.check_program(prog, out_idx, 8)
        k = len(set(out_idx.tolist()))
        sizes = (8, len(alloc.ins), alloc.n_phys, len(alloc.masks), len(alloc.lout), k)
        for reduce in ("count", "row", "total"):
            want = it.plain_interp(reduce, table, prog, out_idx)
            for warps in it.WARPS:
                for vec in it.VECS:
                    smem = it.smem_bytes(*sizes, reduce, warps, vec)
                    ksmem = it.kernel_smem_bytes(*sizes, reduce, warps, vec)
                    if ksmem != smem:
                        raise AssertionError(f"interp smem {ksmem} != smem_bytes {smem}")
                    if smem > it.SMEM_BYTES:
                        continue
                    for variant in (0, it.BRANCH_FREE):
                        shape = it.Shape(warps, vec, variant, smem)
                        got = it.interp(reduce, table, prog, out_idx, shape=shape)
                        diff_of(got, want, f"{name}, {reduce}, {shape}")
                        n_shapes += 1
    del bases, table
    for depth in (1, 31, 62):
        for n in K23_SLICES[:2]:
            words, prog, out_idx = k3_bsi_case(bsi, plan, depth, rng)
            rows = torch.from_numpy(words.view(np.int32)).cuda()
            idx = np.zeros((n, len(words), 2), dtype=np.int64)
            idx[..., 1] = np.arange(len(words))
            one(te.RowTable([rows], idx), prog, out_idx, f"BSI depth {depth}, {n} slices")
    prog, out_idx = k3_full_table(rng)
    leaves = torch.randint(-2**31, 2**31, (64, 32768), dtype=torch.int32, device="cuda")
    for n in K23_SLICES[:2]:
        idx = np.zeros((n, 64, 2), dtype=np.int64)
        idx[..., 1] = rng.permutation(64)
        one(te.RowTable([leaves], idx), prog, out_idx, f"256 ops over 64 leaves, {n} slices")
    full = it.launch_plan(it.check_program(prog, out_idx, 64), 64, 256, "count")
    log(f"phase 3: interp == plain on {n_checks} launches (max_abs_err {worst}): FuseEmitter "
        "tables of 1, 2 and 16 programs with shared subtrees over 8 leaves and the edge tables "
        "(every operand forwarded, none, swapped and-nots, maskw of the first and last words "
        f"beside an odd number of leaf outputs) at {', '.join(map(str, K3_SLICES))} slices; "
        f"{n_shapes} of them in every block shape and both variants (the kernel's shared memory "
        "== smem_bytes); MASKW over predicate rows of depth 1, 31 and 62 (every comparison and "
        f"a between); a full 256-op table over 64 leaves (planner: {full.warps} warps x "
        f"{full.vec} words, variant {full.variant}); count / row / total")
    return float(worst)


# The plain version of shapes (d) and (e) at 954 slices would hold 78 and
# 72 GB of registers on the card: it is timed over this many slices.
K3_PLAIN_SLICES = 16


def k3_needed_bytes(it, prog, out_idx, table, reduce: str) -> int:
    """Bytes a K3 launch must move: every leaf row that a live logic
    instruction or an output reads, once; one 4-byte word for each maskw
    (leaf, word) pair whose row is not read whole; the row addresses; the
    reduce's output."""
    n, n_leaves, words = table.shape
    alloc = it.allocate(prog, np.asarray(list(dict.fromkeys(out_idx.tolist())), np.int32),
                        n_leaves)
    logic = alloc.ins[(alloc.ins[:, 0] & 7) != it.OP_MASKW]
    used = {int(r) for r in logic[:, 1:3].reshape(-1) if 0 <= r < n_leaves}
    used |= {int(r) for r in alloc.lout[:, 0]}
    pairs = {(int(a), int(w)) for a, w in alloc.masks.tolist() if a not in used}
    k = len(set(out_idx.tolist()))
    out = {"count": n * k * 4, "total": k * 8, "row": n * k * words * 4}[reduce]
    return n * (len(used) * words * 4 + len(pairs) * 4 + n_leaves * 8) + out


def k3_stacks(te, rows: int, n: int, seed: int, pred=None):
    """A row table of ``n`` slices, each reading its ``rows`` leaves from a
    stack of its own of random words (generated on the card); ``pred``
    (uint32 [m, 32768]) replaces the last m rows of every stack."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    stacks = []
    for _ in range(n):
        st = torch.randint(-2**31, 2**31, (rows, 32768), dtype=torch.int32, device="cuda",
                           generator=gen)
        if pred is not None:
            st[rows - len(pred):] = torch.from_numpy(pred.view(np.int32)).cuda()
        stacks.append(st)
    idx = np.zeros((n, rows, 2), dtype=np.int64)
    idx[..., 0] = np.arange(n)[:, None]
    idx[..., 1] = np.arange(rows)[None, :]
    return te.RowTable(stacks, idx)


def k3_timed_shapes(te, plan, bsi, table8, rng) -> list:
    """Phase 4's K3 shapes, as (name, reduce, table, prog, out_idx, plain
    table): (a) the 16 storm programs, count over 954 slices; (b) 4 storm
    programs, total over 954 slices (the coalesced Count's mean
    occupancy); (c) those 4, row over 16 slices (the Bitmap storm); (d)
    every BSI comparison and a between at depth 31, count over 954 slices,
    each slice reading one plane stack of its own; (e) the full 256-op
    table over 64 leaves, count over 954 slices.  The storm shapes read
    ``table8`` (phase 5's layout: a mirror of 8 rows a slice)."""
    exprs = storm_exprs()
    prog16, out16 = k3_programs(plan, exprs, 8)
    prog4, out4 = k3_programs(plan, exprs[:4], 8)
    words, prog_d, out_d = k3_bsi_case(bsi, plan, 31, rng)
    table_d = k3_stacks(te, len(words), N_SLICES, int(rng.integers(0, 2**31)), words[-2:])
    prog_e, out_e = k3_full_table(rng)
    table_e = k3_stacks(te, 64, N_SLICES, int(rng.integers(0, 2**31)))
    table16 = te.RowTable(table8.bases[:16], table8.index[:16].copy())

    def head(t):
        return te.RowTable(t.bases[:K3_PLAIN_SLICES], t.index[:K3_PLAIN_SLICES].copy())

    return [
        ("a_storm16_count", "count", table8, prog16, out16, table8),
        ("b_storm4_total", "total", table8, prog4, out4, table8),
        ("c_storm4_row_16", "row", table16, prog4, out4, table16),
        ("d_bsi31_count", "count", table_d, prog_d, out_d, head(table_d)),
        ("e_full256_count", "count", table_e, prog_e, out_e, head(table_e)),
    ]


def time_k2k3(te, it, plan, bsi, hbm: float, rng) -> dict:
    """K2 at [954 slices, 2 leaves] in count, total and row, and row at
    [16, 2] (the coalescer's Bitmap storm), every leaf a row of one of 954
    mirrors of 8 rows (phase 5's layout, read in place), then K3 at the
    shapes of :func:`k3_timed_shapes`: back to back, device time, plain
    version, bound.  The row mode's library call, ``torch.bitwise_and(a,
    b, out=c)`` on two [954, 32768] int32 tensors, is timed the same two
    ways, and K2's row mode over a table naming those same rows (the
    call's own inputs).  K3's device time is also taken with the L2
    flushed before each launch (a 128 MiB write, 2.5 times the L2): the
    time set against the bound by bytes of device memory, which a shape
    whose data fits in L2 (c) would otherwise beat from the L2."""
    import torch

    mirrors = [torch.randint(-2**31, 2**31, (8, 32768), dtype=torch.int32, device="cuda")
               for _ in range(N_SLICES)]
    idx = np.zeros((N_SLICES, 8, 2), dtype=np.int64)
    idx[..., 0] = np.arange(N_SLICES)[:, None]
    idx[..., 1] = np.arange(8)[None, :]
    table8 = te.RowTable(mirrors, idx)
    table2 = te.RowTable(mirrors, idx[:, :2].copy())
    table2_16 = te.RowTable(mirrors[:16], idx[:16, :2].copy())
    expr = ("Intersect", ("leaf", 0), ("leaf", 1))
    program = plan.compile_program(expr)
    row_bytes = 32768 * 4
    a = torch.randint(-2**31, 2**31, (N_SLICES, 32768), dtype=torch.int32, device="cuda")
    b = torch.randint(-2**31, 2**31, (N_SLICES, 32768), dtype=torch.int32, device="cuda")
    c = torch.empty_like(a)
    same = np.zeros((N_SLICES, 2, 2), dtype=np.int64)
    same[:, 1, 0] = 1
    same[..., 1] = np.arange(N_SLICES)[:, None]
    table_ab = te.RowTable([a, b], same)
    lib_fn = lambda: torch.bitwise_and(a, b, out=c)  # noqa: E731
    lib_ms = time_cuda(lib_fn)
    lib_dev = device_ms(lib_fn, "elementwise")
    same_ms = time_cuda(lambda: te.tree_eval(table_ab, program, "row"))
    same_dev = device_ms(lambda: te.tree_eval(table_ab, program, "row"), "tree_eval_")
    if not torch.equal(te.tree_eval(table_ab, program, "row"), torch.bitwise_and(a, b)):
        raise AssertionError("phase 4: tree_eval row != torch.bitwise_and on the same rows")
    log(f"phase 4: torch.bitwise_and(out=) [{N_SLICES}, 32768] int32: {lib_ms:.4f} ms back to "
        f"back, device {lib_dev} ms; tree_eval row over a table naming the same two tensors' "
        f"rows: {same_ms:.4f} ms back to back, device {same_dev} ms")
    del a, b, c, table_ab
    out = {}
    for name, table, reduce, nbytes in (
        ("tree_eval_count", table2, "count", N_SLICES * (2 * row_bytes + 2 * 8 + 4)),
        ("tree_eval_total", table2, "total", N_SLICES * (2 * row_bytes + 2 * 8) + 8),
        ("tree_eval_row", table2, "row", N_SLICES * (3 * row_bytes + 2 * 8)),
        ("tree_eval_row_16", table2_16, "row", 16 * (3 * row_bytes + 2 * 8)),
    ):
        fn = lambda: te.tree_eval(table, program, reduce)  # noqa: E731
        k_ms = time_cuda(fn)
        k_dev = device_ms(fn, "tree_eval_")
        plain_ms = time_cuda(lambda: te.plain_tree_eval(table, program, reduce), runs=3,
                             per_run=1, warmup=1)
        bound_ms = nbytes / hbm * 1e3
        share = bound_ms / k_dev if k_dev else float("nan")
        n = table.shape[0]
        lib = "none (PyTorch has no popcount op)"
        row = {"ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "library_ms": None, "slices": n, "leaves": 2}
        if name == "tree_eval_row":
            # The row mode has no popcount: one PyTorch call computes the
            # same and of two [954, 32768] rows.
            row.update(library_ms=lib_ms, library_device_ms=lib_dev, same_inputs_ms=same_ms,
                       same_inputs_device_ms=same_dev)
            lib = f"torch.bitwise_and(out=) {lib_ms:.4f} ms, device {lib_dev} ms"
        out[name] = row
        log(f"phase 4: {name} [{n} slices, 2 leaves]: {k_ms:.4f} ms back to back, "
            f"device {k_dev} ms ({share:.1%} of the bound), bound {bound_ms:.4f} ms by bytes "
            f"({nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms; library: {lib}")
    shapes = {}
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for name, reduce, table, prog, out_idx, plain_table in k3_timed_shapes(te, plan, bsi, table8,
                                                                           rng):
        n, n_leaves, _ = table.shape
        alloc = it.check_program(prog, out_idx, n_leaves)
        k = len(set(out_idx.tolist()))
        shape = it.launch_plan(alloc, n_leaves, k, reduce)
        nbytes = k3_needed_bytes(it, prog, out_idx, table, reduce)
        fn = lambda: it.interp(reduce, table, prog, out_idx)  # noqa: E731
        k_ms = time_cuda(fn, runs=11, per_run=5)
        k_dev = device_ms(fn, "interp_kernel", launches=20)
        k_cold = device_ms(lambda: (l2_flush.fill_(1), fn()), "interp_kernel", launches=20)
        plain_ms = time_cuda(lambda: it.plain_interp(reduce, plain_table, prog, out_idx),
                             runs=3, per_run=1, warmup=1)
        torch.cuda.empty_cache()
        bound_ms = nbytes / hbm * 1e3
        shapes[name] = {
            "slices": n, "leaves": n_leaves, "ops": len(prog), "outputs": k, "reduce": reduce,
            "block": [shape.warps, shape.vec, shape.variant], "smem": shape.smem,
            "ms": k_ms, "device_ms": k_dev, "device_cold_ms": k_cold, "plain_ms": plain_ms,
            "plain_slices": plain_table.shape[0], "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
        }
        share = bound_ms / k_cold if k_cold else float("nan")
        log(f"phase 4: interp {name} [{n} slices, {n_leaves} leaves, {len(prog)} ops, {k} "
            f"outputs, {reduce}; block {shape.warps} warps x {shape.vec} words, variant "
            f"{shape.variant}, {shape.smem} B]: {k_ms:.4f} ms back to back, device {k_dev} ms, "
            f"{k_cold} ms with the L2 flushed ({share:.1%} of the bound), bound "
            f"{bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms over "
            f"{plain_table.shape[0]} slices; library: none (PyTorch has no popcount op)")
    out["interp_count"] = dict(shapes["a_storm16_count"])
    out["interp_count"]["programs"] = len(storm_exprs())
    out["interp_shapes"] = shapes
    return out


# --- K11: the stream-floor read-sum ------------------------------------------

K11_SIZES = (1, 7, 1023, (1 << 20) + 7)
K11_PATTERNS = ("zeros", "ones", "max", "random")
# The JAX package's probe size, which an H100's 50 MiB L2 holds.
K11_JAX_BYTES = 32 << 20


def k11_words(torch, n: int, pattern: str, dev):
    """n int32 words on the card: all zeros, all ones, all 0xFFFFFFFF, or
    seeded random words (their sum wraps many times)."""
    if pattern == "random":
        g = torch.Generator(device=dev).manual_seed(SEED + n)
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=g)
    fill = {"zeros": 0, "ones": 1, "max": -1}[pattern]
    return torch.full((n,), fill, dtype=torch.int32, device=dev)


def check_k11(ss, floorprobe) -> float:
    """Phase 3: K11 against its plain version, exactly, on every size and
    pattern, the probe's own size included."""
    import torch

    dev = torch.device("cuda")
    probe_words = floorprobe.probe_bytes(dev) // 4
    worst, n_checks = 0, 0
    for n in K11_SIZES + (probe_words,):
        for pattern in K11_PATTERNS:
            x = k11_words(torch, n, pattern, dev)
            got = int(ss.stream_sum(x))
            want = int(ss.plain_stream_sum(x))
            worst = max(worst, abs(got - want))
            n_checks += 1
            del x
    if worst:
        raise AssertionError(f"phase 3: stream_sum differs from plain by {worst}")
    log(f"phase 3: stream_sum == plain on {n_checks} cases (max_abs_err {worst}): "
        f"{', '.join(str(n) for n in K11_SIZES)} and {probe_words} words (the probe's size) x "
        f"{', '.join(K11_PATTERNS)}")
    return float(worst)


def time_k11(ss, floorprobe, hbm: float) -> dict:
    """Phase 4: K11 at the probe's size — back to back, device time from
    the profiler, its bound, the plain version and PyTorch's own int32
    sum — and the probe's GB/s at that size and at the JAX package's
    32 MiB (which the L2 holds)."""
    import torch

    dev = torch.device("cuda")
    n_bytes = floorprobe.probe_bytes(dev)
    x = k11_words(torch, n_bytes // 4, "random", dev)
    k_ms = time_cuda(lambda: ss.stream_sum(x))
    k_dev = device_ms(lambda: ss.stream_sum(x), "stream_sum_kernel", launches=20)
    plain_ms = time_cuda(lambda: ss.plain_stream_sum(x), runs=5, per_run=2)
    lib_ms = time_cuda(lambda: ss.library_stream_sum(x))
    del x
    t_bytes = (n_bytes + 4) / hbm
    t_ops = (n_bytes // 4) / SCALAR_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    gbps_probe = floorprobe.measure_device(dev, n_bytes)
    gbps_jax = floorprobe.measure_device(dev, K11_JAX_BYTES)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    log(f"phase 4: stream_sum [{n_bytes // 4} words, {n_bytes >> 20} MiB = "
        f"{n_bytes / l2:.1f}x the {l2 >> 20} MiB L2]: {k_ms:.4f} ms back to back, device "
        f"{k_dev} ms, bound {bound_ms:.4f} ms by {bound_by} ({bound_ms / k_ms:.1%} of it), "
        f"plain {plain_ms:.4f} ms, torch.sum(int32) {lib_ms:.4f} ms; the probe reads "
        f"{gbps_probe:.1f} GB/s at {n_bytes >> 20} MiB and {gbps_jax:.1f} GB/s at the JAX "
        f"package's {K11_JAX_BYTES >> 20} MiB (data sheet {hbm / 1e9:.0f} GB/s)")
    return {"ms": k_ms, "device_ms": k_dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "probe_bytes": n_bytes,
            "probe_gbps": gbps_probe, "jax_size_gbps": gbps_jax, "l2_bytes": l2}


# --- phase 16: observability -------------------------------------------------

OBS_SERIAL = 20
OBS_TURN = 20
OBS_PROFILE_S = 2.0
OBS_STORM_THREADS = 16
OBS_STORM_REQUESTS = 10
# Counters phase 16 requires on /metrics (the phase-5 node's Expvar client
# and the scrape-time gauges).
OBS_FAMILIES = (
    "pilosa_exec_coalesce_launches_total", "pilosa_exec_coalesce_coalescedQueries_total",
    "pilosa_exec_interp_launches_total", "pilosa_exec_interp_fusedQueries_total",
    "pilosa_setBit_total", "pilosa_ingest_wal_appends_total", "pilosa_ingest_wal_fsyncs_total",
    "pilosa_ingest_wal_groupSize", "pilosa_device_residentBytes", "pilosa_Count_total",
    "pilosa_device_streamFloorGbps", "pilosa_exec_launch_launches",
    "pilosa_exec_launch_floorPct", "pilosa_query_latency_ms", "pilosa_http_latency_ms",
)


# K9 (the mesh TopN scorer) and top_k: phase 3's checks and phase 4's times.
# Phase 5's shapes: 954 slices x 8 rows, one src row a slice.
K9_CASES = ((1, 1), (3, 70), (N_SLICES, ROWS))
TOPK_CASES = ((1, 1), (8, 4), (64, 64), (N_SLICES * ROWS, 10), (2048, 1024), (2049, 1024),
              (100_000, 5))


def check_k9(mt, rng) -> float:
    """K9 against its plain version on the card, both reduces: 1, 3 and 954
    slices of 1, 70 (two row tiles) and 8 rows, seeded random planes and
    src rows, all-zero and all-ones src rows, and src rows read from the
    plane itself (strided, as query_step passes them); exact equality."""
    import torch

    worst = 0
    cases = []
    for s, r in K9_CASES:
        plane = torch.from_numpy(rng.integers(0, 2**32, size=(s, r, 32768), dtype=np.uint32)
                                 .view(np.int32)).cuda()
        for kind in ("random", "zeros", "ones", "row0"):
            if kind == "random":
                src = torch.from_numpy(rng.integers(0, 2**32, size=(s, 32768), dtype=np.uint32)
                                       .view(np.int32)).cuda()
            elif kind == "row0":
                src = plane[:, 0, :]
            else:
                src = torch.full((s, 32768), 0 if kind == "zeros" else -1, dtype=torch.int32,
                                 device="cuda")
            for reduce in ("partials", "total"):
                got = mt.mesh_topn(plane, src, reduce)
                want = mt.plain_mesh_topn(plane, src, reduce)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                worst = max(worst, err)
                cases.append(f"{s}x{r} {kind} {reduce}")
        del plane, src
    torch.cuda.empty_cache()
    log(f"phase 3: mesh_topn (K9) vs plain on {len(cases)} cases ({', '.join(cases[:4])}, ...): "
        f"max |diff| {worst}")
    if worst:
        raise AssertionError(f"phase 3: mesh_topn differs from its plain version by {worst}")
    return float(worst)


def check_top_k(tk, rng) -> float:
    """top_k against its plain version on the card: 1 to 100,000 counts
    (one tile, two tiles, three rounds), k of 1 to 1,024 (to 2,048 in
    one tile), k past the
    non-zero counts and past n, all equal, all zero, many ties, int32
    and int64 counts; counts and indices exactly equal."""
    import torch

    worst = 0
    n_cases = 0
    for n, k in TOPK_CASES:
        for kind in ("random", "ties", "equal", "zeros", "sparse"):
            if kind == "random":
                c = rng.integers(0, 2**40, size=n)
            elif kind == "ties":
                c = rng.integers(0, 4, size=n)
            elif kind == "equal":
                c = np.full(n, 7)
            elif kind == "zeros":
                c = np.zeros(n, dtype=np.int64)
            else:
                c = np.zeros(n, dtype=np.int64)
                c[rng.integers(0, n, size=max(1, k // 2))] = rng.integers(1, 9, size=max(1, k // 2))
            for dtype in (torch.int64, torch.int32):
                if dtype == torch.int32 and kind == "random":
                    c32 = (c & 0x7FFFFFFF)
                    t = torch.from_numpy(c32.astype(np.int64)).to(dtype).cuda()
                else:
                    t = torch.from_numpy(c.astype(np.int64)).to(dtype).cuda()
                for kk in (k, n + 3):
                    if min(kk, n) > tk.MAX_K and n > tk.TILE:
                        continue
                    gv, gi = tk.top_k(t, kk)
                    wv, wi = tk.plain_top_k(t, kk)
                    torch.cuda.synchronize()
                    if gv.shape != wv.shape or not torch.equal(gi, wi):
                        raise AssertionError(f"phase 3: top_k n={n} k={kk} {kind} {dtype}: "
                                             f"indices differ")
                    if len(gv):
                        worst = max(worst, int((gv - wv).abs().max()))
                    n_cases += 1
    log(f"phase 3: top_k vs plain on {n_cases} cases (n 1 to 100,000, k 1 to 1,024, to 2,048 in one tile, and past n; "
        f"random, ties, all equal, all zero, fewer non-zero than k; int32 and int64): "
        f"max |diff| {worst}, indices equal")
    if worst:
        raise AssertionError(f"phase 3: top_k differs from its plain version by {worst}")
    return float(worst)


def k9_bound_ms(s: int, r: int, reduce: str, hbm: float) -> tuple[float, str]:
    """Least time for K9 over [s, r, 32768] and [s, 32768] src: each plane
    and src byte read once, the output written once; 3 int ops a word."""
    nbytes = (s * r + s) * 32768 * 4 + (s * r * 4 if reduce == "partials" else r * 8)
    t_bytes = nbytes / hbm
    t_ops = s * r * 32768 * 3 / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_k9(mt, hbm: float, rng) -> dict:
    """K9 at phase 5's shape, [954, 8, 32768] with a src row a slice:
    both reduces back to back, their device time from the profiler, the
    plain version beside them; torch has no popcount, so no library call
    computes the function."""
    import torch

    plane = torch.from_numpy(rng.integers(0, 2**32, size=(N_SLICES, ROWS, 32768),
                                          dtype=np.uint32).view(np.int32)).cuda()
    src = torch.from_numpy(rng.integers(0, 2**32, size=(N_SLICES, 32768),
                                        dtype=np.uint32).view(np.int32)).cuda()
    out = {}
    for reduce in ("total", "partials"):
        ms = time_cuda(lambda: mt.mesh_topn(plane, src, reduce))
        plain = time_cuda(lambda: mt.plain_mesh_topn(plane, src, reduce), runs=5, per_run=2)
        dev = device_ms(lambda: mt.mesh_topn(plane, src, reduce), "mesh_topn_kernel")
        bound, by = k9_bound_ms(N_SLICES, ROWS, reduce, hbm)
        out[reduce] = {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bound,
                       "bound_by": by, "library_ms": None}
        log(f"phase 4: mesh_topn (K9) {reduce} [{N_SLICES}, {ROWS}, 32768] + src: {ms:.4f} ms "
            f"(device {dev} ms; bound {bound:.4f} ms by {by}, {bound / ms:.1%} of it), plain "
            f"{plain:.4f} ms")
    del plane, src
    torch.cuda.empty_cache()
    return out


def time_top_k(tk, hbm: float, rng) -> dict:
    """top_k at query_step's shape (the per-row totals of phase 5's 8
    rows, k 4) and at 954 x 8 counts, k 10: back to back, its device
    time, the plain version's, and torch.sort(stable, descending)[:k] as
    the library call (torch.topk promises no order among ties)."""
    import torch

    out = {}
    for n, k in ((ROWS, 4), (N_SLICES * ROWS, 10)):
        c = torch.from_numpy(rng.integers(0, 2**30, size=n)).cuda()
        ms = time_cuda(lambda: tk.top_k(c, k))
        plain = time_cuda(lambda: tk.plain_top_k(c, k))
        lib = time_cuda(lambda: torch.sort(c, descending=True, stable=True)[0][:k])
        dev = device_ms(lambda: tk.top_k(c, k), "top_k_kernel")
        t_bytes = (n * 8 + k * 16) / hbm
        t_ops = n * 2 / SCALAR_OPS_PER_S  # each count read and compared once
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        out[f"{n}x{k}"] = {"ms": ms, "device_ms": dev, "plain_ms": plain, "bound_ms": bound,
                           "bound_by": by, "library_ms": lib}
        log(f"phase 4: top_k n {n} k {k}: {ms:.4f} ms (device {dev} ms; bound {bound:.6f} ms by "
            f"{by}: launch-bound), plain {plain:.4f} ms, torch.sort(stable)[:k] {lib:.4f} ms")
    return out


# Phase 19: the multi-device data plane on a mesh of logical members of the
# one card (every part of the sharded path but the hop between cards), and
# over the cards themselves where there are two or more.
MESH_MEMBERS = 4
MESH_THREADS = 8
MESH_REPS = 3
MESH_WATCHDOG_MS = 1000
MESH_UPDATES = 16
# The card the members share (a CPU rehearsal sets "cpu").
MESH_DEVICE = "cuda"

_NCCL_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.parallel import mesh as pmesh, multihost

rank = int(__import__("os").environ["JAX_PROCESS_ID"])
bp.set_local_members([f"cuda:{{rank}}"])
multihost.initialize()
assert dist.get_backend() == "nccl" and multihost.is_multihost()
planes = np.random.default_rng(19).integers(0, 2**32, size=(8, 2, 1, 32768), dtype=np.uint32)
mine = planes[rank * 4:(rank + 1) * 4]
batch = pmesh.shard(mine, pmesh.slice_mesh(1), ("slices", None, None, None))
total = pmesh.distributed_count(("Intersect", ("leaf", 0), ("leaf", 1)), batch)
want = int(np.bitwise_count(planes[:, 0] & planes[:, 1]).sum())
assert total == want, (total, want)
print("NCCL OK", rank, total, flush=True)
dist.destroy_process_group()
"""


def mesh_functions_and_check(planes, truth_count, pmesh, torch) -> dict:
    """(a) distributed_count, distributed_topn and query_step on the
    four-member mesh and on a one-member mesh, at phase 5's shapes, each
    equal to the numpy oracle."""
    out = {}
    n = planes.shape[0]
    expr = ("Intersect", ("leaf", 0), ("leaf", 1))
    pad = (-n) % MESH_MEMBERS
    padded = np.pad(planes, ((0, pad), (0, 0), (0, 0))) if pad else planes
    want_count = truth_count
    want_per = np.bitwise_count(planes & planes[:, :1]).sum(axis=(0, 2), dtype=np.int64)
    want_ids = np.argsort(-want_per, kind="stable")[:5]
    rng = np.random.default_rng(SEED + 19)
    flat = rng.choice(ROWS * 32768, size=MESH_UPDATES, replace=False)
    rows_upd, words_upd = flat // 32768, flat % 32768
    masks = rng.integers(0, 2**32, size=(padded.shape[0], MESH_UPDATES), dtype=np.uint32)
    ref = padded[:, :2].copy()
    for i in range(MESH_UPDATES):
        if rows_upd[i] < 2:
            ref[:, rows_upd[i], words_upd[i]] |= masks[:, i]
    want_step_count = np.bitwise_count(ref[:, 0] & ref[:, 1]).sum(axis=-1, dtype=np.int64)
    row0 = ref[:, 0]
    step_per = np.zeros(ROWS, dtype=np.int64)
    for r in range(ROWS):
        row = padded[:, r].copy()
        for i in np.nonzero(rows_upd == r)[0]:
            row[:, words_upd[i]] |= masks[:, i]
        step_per[r] = int(np.bitwise_count(row & row0).sum(dtype=np.int64))
    want_step_ids = np.argsort(-step_per, kind="stable")[:4]
    for members in (MESH_MEMBERS, 1):
        mesh = pmesh.slice_mesh(members)
        t0 = time.perf_counter()
        leaves = pmesh.shard(padded[:, :2, None, :], mesh, ("slices", None, None, None))
        got = pmesh.distributed_count(expr, leaves)
        del leaves
        plane = pmesh.shard_planes(padded, mesh)
        src = pmesh.shard(padded[:, 0], mesh, ("slices", None))
        counts, ids = pmesh.distributed_topn(plane, src, 5)
        del src
        _, step_count, top_counts, top_ids = pmesh.query_step(mesh)(
            plane, rows_upd, words_upd, masks)
        torch.cuda.synchronize()
        del plane
        torch.cuda.empty_cache()
        res = {"count": got, "topn": [[int(i), int(c)] for i, c in zip(ids, counts)],
               "step_count": int(step_count.astype(np.int64).sum()),
               "step_top": [[int(i), int(c)] for i, c in zip(top_ids.cpu().numpy(),
                                                            top_counts.cpu().numpy())],
               "seconds": time.perf_counter() - t0}
        if got != want_count:
            raise AssertionError(f"phase 19 (a): distributed_count on {members} members {got} "
                                 f"!= {want_count}")
        if list(ids) != list(want_ids) or list(counts) != list(want_per[want_ids]):
            raise AssertionError(f"phase 19 (a): distributed_topn on {members} members differs")
        if not np.array_equal(step_count.astype(np.int64), want_step_count):
            raise AssertionError(f"phase 19 (a): query_step's counts on {members} members differ")
        if list(top_ids.cpu().numpy()) != list(want_step_ids) or \
                list(top_counts.cpu().numpy()) != list(step_per[want_step_ids]):
            raise AssertionError(f"phase 19 (a): query_step's top 4 on {members} members differ")
        out[str(members)] = res
    if {k: v for k, v in out[str(MESH_MEMBERS)].items() if k != "seconds"} != \
            {k: v for k, v in out["1"].items() if k != "seconds"}:
        raise AssertionError("phase 19 (a): the four-member answers differ from one member's")
    log(f"phase 19 (a): distributed_count {want_count}, distributed_topn top 5 "
        f"{out['1']['topn']}, query_step (16 scatter-OR targets, Count(Intersect), top 4 "
        f"{out['1']['step_top']}) on {MESH_MEMBERS} members of cuda:0 and on one, equal to "
        f"numpy; seconds {out[str(MESH_MEMBERS)]['seconds']:.2f} / {out['1']['seconds']:.2f}")
    return out


MESH_QUERIES = (
    ("count_intersect", "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))"),
    ("count_bitmap", "Count(Bitmap(frame=f, rowID=0))"),
    ("count_union3", "Count(Union(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1), "
                     "Bitmap(frame=f, rowID=2)))"),
    ("count_xor", "Count(Xor(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=3)))"),
    ("bitmap_g", "Bitmap(frame=g, rowID=1)"),
    ("topn", "TopN(frame=f, n=5)"),
    ("topn_src", "TopN(Bitmap(frame=f, rowID=0), frame=f, n=5)"),
)


def serve_mesh_and_check(srv, te, sp, want: dict, n_members: int, part: str) -> dict:
    """A node reopened on ``n_members`` members: every query class of
    ``MESH_QUERIES`` equal to ``want`` (the one-member node's answers), K2
    once a member for each Count, K4 once a member for TopN(src); a SetBit
    and a ClearBit between reads; ``MESH_THREADS`` threads at once, all
    equal; the ``collective`` site in ``/debug/perf``."""
    from pilosa_tpu_torch.obs import perf as perf_mod

    out = {}
    paths = srv.device_health.device_paths()
    frag = srv.holder.fragment("i", "f", "standard", 5)
    if paths != [f"device:{i}" for i in range(n_members)] or frag is None:
        raise AssertionError(f"phase 19 ({part}): paths {paths}, fragment {frag}")
    out["devices"] = sorted({str(f.device) for f in srv.holder._all_fragments()})
    perf_mod.registry().configure(enabled=True)
    h = srv.host
    per_query = {}
    for name, pql in MESH_QUERIES:
        k2, k4 = te.launches, sp.launches
        status, body = http(h, "POST", "/index/i/query", pql.encode())
        if status != 200 or body != want[name]:
            raise AssertionError(f"phase 19 ({part}): {pql}: {status} {str(body)[:300]} != "
                                 f"{str(want[name])[:300]}")
        per_query[name] = {"k2": te.launches - k2, "k4": sp.launches - k4}
    for name in ("count_intersect", "count_bitmap", "count_union3", "count_xor"):
        if per_query[name]["k2"] != n_members:
            raise AssertionError(f"phase 19 ({part}): {name} launched K2 "
                                 f"{per_query[name]['k2']} times, not once a member")
    if per_query["topn_src"]["k4"] != n_members:
        raise AssertionError(f"phase 19 ({part}): TopN(src) launched K4 "
                             f"{per_query['topn_src']['k4']} times, not once a member")
    out["per_query"] = per_query
    # A write between two reads.
    words = srv.holder.fragment("i", "f", "standard", 0).row_words_host(0)
    w = int(np.argmax(words != 0xFFFFFFFF))
    col = w * 32 + ((~int(words[w]) & (int(words[w]) + 1)).bit_length() - 1)
    base = want["count_bitmap"]["results"][0]
    for pql, ans in ((f"SetBit(frame=f, rowID=0, columnID={col})", [True]),
                     (MESH_QUERIES[1][1], [base + 1]),
                     (f"ClearBit(frame=f, rowID=0, columnID={col})", [True]),
                     (MESH_QUERIES[1][1], [base])):
        status, body = http(h, "POST", "/index/i/query", pql.encode())
        if status != 200 or body["results"] != ans:
            raise AssertionError(f"phase 19 ({part}): {pql}: {status} {body} != {ans}")
    # MESH_THREADS threads at once.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(MESH_THREADS) as pool:
        got = list(pool.map(lambda q: (q[0], http(h, "POST", "/index/i/query", q[1].encode())),
                            MESH_QUERIES * MESH_REPS))
    out["storm_s"] = time.perf_counter() - t0
    for name, (status, body) in got:
        if status != 200 or body != want[name]:
            raise AssertionError(f"phase 19 ({part}): storm {name}: {status} {str(body)[:300]}")
    status, perf = http(h, "GET", "/debug/perf")
    site = perf.get("sites", {}).get("collective")
    if status != 200 or not site:
        raise AssertionError(f"phase 19 ({part}): /debug/perf has no collective site: "
                             f"{list(perf.get('sites', {}))}")
    out["collective_site"] = {k: site[k] for k in ("launches", "p50_ms") if k in site}
    return out


def mesh_and_check(kernels: dict, Server, ExpvarStatsClient, srv, data_dir: str, planes,
                   truth, watch) -> dict:
    """Phase 19 (see the module docstring): the kernels' counts set to 0
    just before the mesh is driven and read just after."""
    import shutil

    import torch

    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import bitplane as bp
    from pilosa_tpu_torch.parallel import mesh as pmesh
    from pilosa_tpu_torch.testing import faults

    t_start = time.perf_counter()
    out: dict = {}
    te, sp = kernels["k2"], kernels["k4"]
    # The one-member phase-5 node's answers are the reference; its
    # directory is copied while it serves (as phase 13 copies a node's) and
    # the copy reopened on the mesh.
    want = {}
    for name, pql in MESH_QUERIES:
        status, body = http(srv.host, "POST", "/index/i/query", pql.encode())
        if status != 200:
            raise AssertionError(f"phase 19: {pql} on the phase-5 node: {status} {body}")
        want[name] = body
    truth_count = int(np.bitwise_count(truth[:, 0] & truth[:, 1]).sum(dtype=np.int64))
    if want["count_intersect"]["results"] != [truth_count]:
        raise AssertionError("phase 19: the phase-5 node's Count differs from numpy")
    copy_dir = data_dir + "-mesh"
    t0 = time.perf_counter()
    # The rank caches to disk first, as the reference's periodic cache
    # flush would have them (a TopN without a src reads them at open).
    for frag in srv.holder._all_fragments():
        frag.flush_cache()
    shutil.copytree(data_dir, copy_dir)
    out["copy_s"] = time.perf_counter() - t0
    for k in kernels.values():
        k.launches = 0
    one_card = bp.local_members()
    n_cards = torch.cuda.device_count()
    bp.set_local_members([torch.device(MESH_DEVICE, 0)] * MESH_MEMBERS)
    srv4 = None
    try:
        out["functions"] = mesh_functions_and_check(planes, int(np.bitwise_count(
            planes[:, 0] & planes[:, 1]).sum(dtype=np.int64)), pmesh, torch)
        # (b) the copy reopened on four members.
        t0 = time.perf_counter()
        srv4 = Server(copy_dir, host="127.0.0.1:0", device=MESH_DEVICE, stats=ExpvarStatsClient(),
                      mesh_devices=MESH_MEMBERS, launch_watchdog_ms=MESH_WATCHDOG_MS,
                      quarantine_open_ms=600_000)
        srv4.open()
        out["open_s"] = time.perf_counter() - t0
        out["members"] = served = serve_mesh_and_check(srv4, te, sp, want, MESH_MEMBERS, "b")
        watch.check("19")
        log(f"phase 19 (b): phase 5's directory copied in {out['copy_s']:.2f}s and reopened on "
            f"{MESH_MEMBERS} members in {out['open_s']:.2f}s; {len(MESH_QUERIES)} query classes "
            f"equal to the one-member node's, K2/K4 a query {json.dumps(served['per_query'])}; a "
            f"SetBit and a ClearBit between reads; {MESH_THREADS} threads x "
            f"{len(MESH_QUERIES) * MESH_REPS} requests in {served['storm_s']:.2f}s, all equal; "
            f"/debug/perf collective {json.dumps(served['collective_site'])}")
        # (c) an injected hang in the collective: tripped, answered right.
        h = srv4.host
        faults.install(f"device.launch:path=collective,kind=hang,delay-ms="
                       f"{MESH_WATCHDOG_MS * 3},times=1")
        try:
            t0 = time.perf_counter()
            status, body = http(h, "POST", "/index/i/query", MESH_QUERIES[0][1].encode())
            out["trip_s"] = time.perf_counter() - t0
        finally:
            faults.clear()
        if status != 200 or body != want["count_intersect"]:
            raise AssertionError(f"phase 19 (c): {status} {body}")
        _, health = http(h, "GET", "/debug/health")
        dev = health["device"]
        if dev["watchdogTrips"] != 1 or dev["paths"]["collective"]["state"] != "quarantined":
            raise AssertionError(f"phase 19 (c): /debug/health {dev}")
        status, body = http(h, "POST", "/index/i/query", MESH_QUERIES[0][1].encode())
        if status != 200 or body != want["count_intersect"]:
            raise AssertionError(f"phase 19 (c): after the trip: {status} {body}")
        out["collective_fallbacks"] = plan.collective_fallbacks
        log(f"phase 19 (c): an injected collective hang tripped the {MESH_WATCHDOG_MS} ms "
            f"watchdog; the Count answered right in {out['trip_s']:.2f}s from the per-member "
            f"partials, the collective path quarantined, the next Count too "
            f"({plan.collective_fallbacks} collective fallbacks)")
        # The tripped body was abandoned, not stopped: it holds the
        # collective lock until its injected hang ends and its launches
        # finish. Wait for it, so that none of them counts against (d).
        with plan.collective_launch():
            pass
        srv4.close()
        srv4 = None
        # (d) the hop between cards, where there are two or more: the copy
        # served by a node whose slices spread over every card (the default
        # on such a host), then the distributed Count over the cards and a
        # two-process NCCL Count.
        if n_cards >= 2:
            watch.rebase(srv)
            bp.set_local_members(None)
            bp.configure_mesh_devices(0)
            t0 = time.perf_counter()
            srv4 = Server(copy_dir, host="127.0.0.1:0", device=MESH_DEVICE,
                          stats=ExpvarStatsClient(), launch_watchdog_ms=MESH_WATCHDOG_MS * 10)
            srv4.open()
            open_s = time.perf_counter() - t0
            served = serve_mesh_and_check(srv4, te, sp, want, n_cards, "d")
            watch.check("19")
            out["cards_served"] = dict(served, open_s=open_s)
            log(f"phase 19 (d): the copy reopened over {n_cards} cards ({served['devices']}) "
                f"in {open_s:.2f}s; {len(MESH_QUERIES)} query classes equal to the one-card "
                f"node's, K2/K4 a query {json.dumps(served['per_query'])}; a SetBit and a "
                f"ClearBit between reads; {MESH_THREADS} threads, all equal")
            srv4.close()
            srv4 = None
            out["cards"] = cards_and_check(pmesh, bp, torch, n_cards)
        else:
            out["cards"] = None
            log(f"phase 19 (d): not run: the machine has {n_cards} card, so no mesh over cards "
                "and no two-process NCCL Count (NCCL refuses two ranks on one card)")
    finally:
        if srv4 is not None:
            srv4.close()
        bp.set_local_members(one_card)
        bp.configure_mesh_devices(0)
        shutil.rmtree(copy_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    out["launches"] = {k: m.launches for k, m in kernels.items()}
    watch.rebase(srv)
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 19: launches {json.dumps(out['launches'])}; {out['seconds']:.1f} s")
    return out


def cards_and_check(pmesh, bp, torch, n_cards: int) -> dict:
    """(d) a mesh over the cards themselves, and a two-process NCCL Count
    over two of them."""
    import socket

    out = {}
    rng = np.random.default_rng(SEED + 190)
    leaves = rng.integers(0, 2**32, size=(n_cards * 4, 2, 1, 32768), dtype=np.uint32)
    want = int(np.bitwise_count(leaves[:, 0] & leaves[:, 1]).sum(dtype=np.int64))
    mesh = pmesh.slice_mesh(n_cards)
    got = pmesh.distributed_count(("Intersect", ("leaf", 0), ("leaf", 1)),
                                  pmesh.shard(leaves, mesh, ("slices", None, None, None)))
    if got != want:
        raise AssertionError(f"phase 19 (d): the mesh over {n_cards} cards counted {got} != {want}")
    out["mesh_count"] = got
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "nccl_worker.py")
        with open(script, "w") as fh:
            fh.write(_NCCL_WORKER.format(repo=repo))
        procs = [subprocess.Popen(
            [sys.executable, script], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                     JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r))) for r in range(2)]
        try:
            outs = [p.communicate(timeout=180) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"NCCL OK {r}" not in o:
            raise AssertionError(f"phase 19 (d): NCCL rank {r}: rc {p.returncode} {e[-800:]}")
    out["nccl"] = [o.strip().split()[-1] for o, _ in outs]
    log(f"phase 19 (d): a mesh over {n_cards} cards counted {got}, equal to numpy; a "
        f"two-process NCCL Count agreed on {out['nccl']}")
    return out

def http_raw(host: str, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://{host}{path}", timeout=600) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def parse_exposition(text: str) -> dict[str, str]:
    """Prometheus text format, checked line by line: family -> type."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
                        r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*)\})? (\S+)$')
    fams: dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ")
            fams[name] = typ
            continue
        m = sample.match(line)
        if m is None:
            raise AssertionError(f"phase 16: /metrics line does not parse: {line!r}")
        float(m.group(7))
        name = m.group(1)
        base = name.rsplit("_", 1)[0] if name.endswith(("_bucket", "_sum", "_count")) else name
        if name not in fams and base not in fams:
            raise AssertionError(f"phase 16: /metrics sample of an undeclared family: {line!r}")
    return fams


def check_perf_doc(doc: dict, hbm: float, where: str) -> None:
    floor = doc["floor_gbps"]
    if not 0 < floor <= 1.05 * hbm / 1e9:
        raise AssertionError(f"phase 16 {where}: stream floor {floor} GB/s outside "
                             f"(0, {1.05 * hbm / 1e9:.0f}]")
    for site, row in doc["sites"].items():
        if row.get("floor_pct", 0.0) > 105.0:
            raise AssertionError(f"phase 16 {where}: site {site} at {row['floor_pct']}% of the "
                                 f"floor: {row}")


def stage_p50(traces: list, pql: str, n: int) -> dict:
    """Per-stage p50 (ms) over the last ``n`` traces of ``pql``, the root
    span as ``query``."""
    from pilosa_tpu_torch.obs.trace import stage_breakdown

    recs = [t for t in traces if t["spans"][0]["tags"].get("query") == pql][-n:]
    stages: dict[str, list] = {}
    for r in recs:
        stages.setdefault("query", []).append(r["duration_ms"])
        for k, v in stage_breakdown(r).items():
            stages.setdefault(k, []).append(v)
    return {k: statistics.median(v) for k, v in sorted(stages.items()) if len(v) == len(recs)}


def profile_idle_share(tar_path: str, seconds: float) -> dict:
    """From a /debug/profile tarball: the card's busy time (the union of
    kernel, copy and set intervals) over the trace's window, and the
    kernels' own time."""
    import tarfile

    with tarfile.open(tar_path) as tf:
        member = next(m for m in tf.getmembers() if m.name.endswith("trace.json"))
        events = json.load(tf.extractfile(member)).get("traceEvents", [])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("cat", ""))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi, _ in dev:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    window_us = seconds * 1e6
    kernel_us = sum(hi - lo for lo, hi, cat in dev if cat == "kernel")
    return {"window_ms": window_us / 1e3, "busy_ms": busy / 1e3, "kernel_ms": kernel_us / 1e3,
            "device_events": len(dev), "idle_share": 1.0 - busy / window_us}


def cluster_trace(coordinator, hosts: list) -> dict:
    """Phase 16's cluster check, on phase 6's nodes: the coordinator's
    last own TopN trace holds every node's leg — a ``query`` root per
    node, each remote one under an ``rpc.execute`` span of this trace."""
    recs = [t for t in coordinator.tracer.traces()
            if t["spans"][0]["tags"].get("query", "").startswith("TopN(")
            and not t["spans"][0]["tags"].get("remote")]
    if not recs:
        raise AssertionError("phase 16: no coordinator TopN trace on phase 6's node 0")
    rec = recs[-1]
    ids = {s["span_id"] for s in rec["spans"]}
    roots = [s for s in rec["spans"] if s["name"] == "query"]
    nodes_seen = {s["tags"].get("node") for s in roots}
    rpcs = {s["span_id"] for s in rec["spans"] if s["name"] == "rpc.execute"}
    if nodes_seen != set(hosts) or any(s["parent_id"] not in ids for s in rec["spans"][1:]) \
            or any(r["parent_id"] not in rpcs for r in roots[1:]):
        raise AssertionError(f"phase 16: the cluster TopN trace covers {sorted(nodes_seen)}, "
                             f"not {sorted(hosts)}: {json.dumps(rec)[:2000]}")
    out = {"trace_id": rec["trace_id"], "spans": len(rec["spans"]), "nodes": len(nodes_seen),
           "ms": rec["duration_ms"],
           "rpc_ms": sorted(s["duration_ms"] for s in rec["spans"] if s["name"] == "rpc.execute"),
           "remote_query_ms": sorted(r["duration_ms"] for r in roots[1:])}
    log(f"phase 16: one trace of a cluster TopN on phase 6's nodes covers all {len(nodes_seen)} "
        f"nodes: {out}")
    return out


def observe_and_check(srv, kernels: dict, storm_queries: list, hbm: float, rng) -> dict:
    """Phase 16 on the phase-5 node, after phase 14: /debug/perf's floor
    and per-site table against the kernels' own counters, /metrics,
    the per-stage breakdown of serial Count hits from /debug/traces, a
    /debug/profile under a storm and the card's idle share from it, and
    Count p50 with telemetry on and off."""
    from pilosa_tpu_torch.exec.coalesce import CoalesceScheduler
    from pilosa_tpu_torch.obs import perf as perf_mod
    from pilosa_tpu_torch.obs import trace as trace_mod

    out: dict = {}
    h, ex = srv.host, srv.executor
    t_start = time.perf_counter()
    # Phases 5 and 14 as the node recorded them.
    doc = json.loads(http_raw(h, "/debug/perf")[1])
    check_perf_doc(doc, hbm, "after phase 14")
    out["after_14"] = {k: {c: v.get(c) for c in ("launches", "gbps", "eff_gbps", "floor_pct",
                                                  "p50_ms", "p99_ms", "occupancy")}
                       for k, v in doc["sites"].items()}
    log(f"phase 16: /debug/perf after phases 5 and 14: floor {doc['floor_gbps']} GB/s; "
        f"sites {json.dumps(out['after_14'])}")

    if ex.coalescer is None:
        srv.coalescer = ex.coalescer = CoalesceScheduler(stats=srv.stats)
    q = "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))"
    topn = "TopN(Bitmap(frame=f, rowID=2), frame=f, n=5)"
    status, body = http(h, "POST", "/index/i/query", q.encode())
    if status != 200:
        raise AssertionError(f"phase 16 {q}: {status} {body}")
    want = body["results"]
    # The window the site table is held to: every counter at 0 together.
    perf_mod.registry().reset()
    for mod in kernels.values():
        mod.launches = 0
    wall = []
    for _ in range(OBS_SERIAL):
        q0 = time.perf_counter()
        status, body = http(h, "POST", "/index/i/query", q.encode())
        wall.append((time.perf_counter() - q0) * 1e3)
        if status != 200 or body["results"] != want:
            raise AssertionError(f"phase 16 {q}: {status} {body} != {want}")
    traces = json.loads(http_raw(h, "/debug/traces")[1])["traces"]
    stages = stage_p50(traces, q, OBS_SERIAL)
    stages["client"] = statistics.median(wall)
    stages["outside_handler"] = stages["client"] - stages["query"]
    out["stages_p50_ms"] = stages
    log(f"phase 16: p50 stage breakdown of {OBS_SERIAL} serial {q} hits (ms; 'query' is the "
        f"handler's root span, 'client' the HTTP round trip, 'outside_handler' their "
        f"difference): {json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    for _ in range(3):
        status, _ = http(h, "POST", "/index/i/query", topn.encode())
        if status != 200:
            raise AssertionError(f"phase 16 {topn}: {status}")

    # A short storm in turns, coalescing on then off (the direct paths).
    def storm(n_threads: int, n_req: int, stop=None) -> int:
        reqs = [[storm_queries[int(i)] for i in rng.integers(0, len(storm_queries), n_req)]
                for _ in range(n_threads)]

        def client(rs):
            done = 0
            while True:
                for path, pql, w in rs:
                    status, body = http(h, "POST", path, pql.encode())
                    if status != 200 or body["results"] != [w]:
                        raise AssertionError(f"phase 16 storm {pql}: {status}")
                    done += 1
                if stop is None or stop.is_set():
                    return done

        with ThreadPoolExecutor(n_threads) as pool:
            return sum(f.result(timeout=600) for f in [pool.submit(client, r) for r in reqs])

    storm(OBS_STORM_THREADS, OBS_STORM_REQUESTS)
    srv.coalescer.close()
    srv.coalescer = ex.coalescer = None
    storm(OBS_STORM_THREADS, OBS_STORM_REQUESTS)
    srv.coalescer = ex.coalescer = CoalesceScheduler(stats=srv.stats)
    counters = {name: mod.launches for name, mod in kernels.items()}
    doc = json.loads(http_raw(h, "/debug/perf")[1])
    check_perf_doc(doc, hbm, "phase 16 window")
    sites = {k: v["launches"] for k, v in doc["sites"].items()}
    k2_sites = sum(sites.get(k, 0) for k in ("direct", "total", "coalesce"))
    pairs = {"k2": (k2_sites, counters["k2"]), "k3": (sites.get("interp", 0), counters["k3"]),
             "k4": (sites.get("topn", 0), counters["k4"]),
             "k5": (sites.get("anchored", 0), counters["k5"])}
    if any(a != b for a, b in pairs.values()) or not {"total", "direct", "coalesce", "interp",
                                                        "topn"} <= set(sites):
        raise AssertionError(f"phase 16: /debug/perf sites {sites} against the kernels' "
                             f"counters {counters}")
    out["sites"] = {k: {c: v.get(c) for c in ("launches", "bytes", "eff_bytes", "gbps",
                                               "floor_pct", "dispatch_ms", "device_ms",
                                               "p50_ms", "p99_ms", "occupancy")}
                    for k, v in doc["sites"].items()}
    out["floor_gbps"] = doc["floor_gbps"]
    log(f"phase 16: /debug/perf floor {doc['floor_gbps']} GB/s ({doc['floor_gbps'] * 1e9 / hbm:.1%} "
        f"of the data sheet); site launches equal the kernels' counters ({pairs}); every "
        f"floorPct <= 105%: {json.dumps(out['sites'])}")

    # /metrics: parses, and carries the counters.
    status, body = http_raw(h, "/metrics")
    fams = parse_exposition(body.decode())
    missing = [f for f in OBS_FAMILIES if f not in fams]
    if status != 200 or missing:
        raise AssertionError(f"phase 16: /metrics {status}, missing {missing}")
    out["metrics_families"] = len(fams)
    log(f"phase 16: /metrics parses: {len(fams)} families, {len(body)} bytes, every required "
        "counter present")

    # A profile under a storm: the card's idle share.
    stop = threading.Event()
    with ThreadPoolExecutor(1) as bg:
        fut = bg.submit(storm, OBS_STORM_THREADS, OBS_STORM_REQUESTS, stop)
        time.sleep(0.5)
        status, body = http(h, "GET", f"/debug/profile?seconds={OBS_PROFILE_S}")
        stop.set()
        served = fut.result(timeout=600)
    if status != 200:
        raise AssertionError(f"phase 16: /debug/profile {status} {body}")
    idle = profile_idle_share(body["trace"], OBS_PROFILE_S)
    if not idle["device_events"]:
        raise AssertionError(f"phase 16: the profile holds no device activity: {idle}")
    out["profile"] = {**idle, "trace_bytes": body["bytes"], "storm_requests": served}
    log(f"phase 16: /debug/profile?seconds={OBS_PROFILE_S} under a {OBS_STORM_THREADS}-thread "
        f"storm ({served} requests): {json.dumps(out['profile'])}; device idle share "
        f"{idle['idle_share']:.2%}")

    # Telemetry on and off (launch records and traces), in turns.
    tracer = srv.tracer
    turns = []
    for on in (True, False, False, True):
        perf_mod.registry().configure(enabled=on)
        srv.handler.tracer = ex.tracer = tracer if on else trace_mod.NOP_TRACER
        lat = []
        for _ in range(OBS_TURN):
            q0 = time.perf_counter()
            status, body = http(h, "POST", "/index/i/query", q.encode())
            lat.append((time.perf_counter() - q0) * 1e3)
            if status != 200 or body["results"] != want:
                raise AssertionError(f"phase 16 telemetry turn: {status} {body}")
        turns.append({"telemetry": on, "p50_ms": statistics.median(lat)})
    perf_mod.registry().configure(enabled=True)
    srv.handler.tracer = ex.tracer = tracer
    out["telemetry_turns"] = turns
    out["seconds"] = time.perf_counter() - t_start
    p50s = " / ".join(f"{t['p50_ms']:.3f}" for t in turns)
    log(f"phase 16: Count p50 with telemetry on / off / off / on over {OBS_TURN} requests each: "
        f"{p50s} ms; phase 16 took {out['seconds']:.1f} s")
    return out


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


def serve_and_check(fp, ds, sp, te, bp, convert, srv, rng) -> dict:
    """Phase 5 on ``srv``, an open one-node ``Server`` on the card, which
    stays open for phases 14 and 7-9.  Every Count and Bitmap over a
    bitmap tree is one K2 launch (through the coalescer), no K1."""
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
    load_in_threads(convert, [(srv.holder, "i", "f", "standard", {s: planes[s]})
                              for s in range(N_SLICES)])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(
        f"phase 5: {N_SLICES} slices x {ROWS} rows generated in {t1 - t0:.3f}s, "
        f"loaded (mirror upload + recount + snapshot, {LOAD_THREADS} loader threads) in "
        f"{t2 - t1:.3f}s; "
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
        ("bitmap_g", "Bitmap(frame=g, rowID=1)", {"attrs": {}, "bits": g_row1}, 1),
        ("topn", "TopN(frame=f, n=5)", topn_oracle(row_totals, 5), 0),
        # The folded TopN: one K4 launch scores every fragment, no K1.
        ("topn_src", "TopN(Bitmap(frame=f, rowID=0), frame=f, n=5)",
         topn_oracle(src_scores, 5), 0),
    ]
    # The folded TopN(src) scores once per prep entry: the first request
    # builds it and launches K4, the repeats reuse the entry and its scores
    # (topn_route: the builds each request's trace shows, and that the
    # entry's lifetime allows).
    k4_per_build = {"topn_src": 1}

    fp.launches = ds.launches = sp.launches = te.launches = 0  # the main path starts here
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
        if name.startswith("topn"):
            latencies[name + "_first"] = times[0] * 1e3
            latencies[name + "_repeats"] = statistics.median(times[1:]) * 1e3
            route = topn_route(srv, pql, REPS)
            expected_k4 += k4_per_build.get(name, 0) * (route["builds"] + route["two_round"])
        expected_launches += REPS * per_query
    # The TopN prep cache on the served path: repeats build nothing and
    # launch nothing; a SetBit between two TopN(src)s invalidates the entry
    # (one build, one K4, the answer with the bit); 8 threads asking one
    # TopN(src) at once make one build and one K4 launch.
    cached = topn_cache_and_check(srv, sp, ds, planes, queries[6:8], src_scores)

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
    launches = te.launches  # the main path ends here
    k1_launches = fp.launches
    k7_launches = ds.launches - cached["k7_launches"]
    k4_launches = sp.launches - cached["k4_launches"]
    if k4_launches != expected_k4:
        raise AssertionError(f"score_planes launches {k4_launches} != expected {expected_k4}")
    if (launches, k1_launches) != (expected_launches, 0):
        raise AssertionError(f"tree_eval / fused_popcount launches {launches} / {k1_launches} "
                             f"!= expected {expected_launches} / 0")
    # The SetBit queued its delta; the Count applied it with one K7.
    if k7_launches != 1:
        raise AssertionError(f"delta_scatter launches {k7_launches} != expected 1")
    out["topn_cache"] = cached
    out["launches"] = k1_launches
    out["k2_launches"] = launches
    out["k7_launches"] = k7_launches + cached["k7_launches"]
    out["k4_launches"] = k4_launches + cached["k4_launches"]
    out["setbit_col"] = col
    for name, ms in latencies.items():
        over = ("the first request" if name.endswith("_first") else
                f"the {REPS - 1} repeats" if name.endswith("_repeats") else f"{REPS} requests")
        log(f"phase 5: {name} p50 {ms:.3f} ms over {over}")
    log(f"phase 5: answers == numpy oracle; tree_eval launches {launches} (expected "
        f"{expected_launches}: one per Count and Bitmap request), fused_popcount launches "
        f"{k1_launches}; delta_scatter launches {k7_launches} (the SetBit's delta, applied "
        f"by the next Count); score_planes launches {k4_launches} (one per TopN(src) prep "
        f"build; the repeats reuse its scores)")

    # The batch cache apart from the kernel: a build of the Count(Intersect)
    # batch (one table over the 954 fragments' mirrors) and a hit's check.
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.pql import parse_string

    child = parse_string(queries[1][1]).calls[0].children[0]
    expr, leaves = plan.decompose(child)
    slices = list(range(N_SLICES))
    ex = srv.executor
    builds, hits = [], []
    for _ in range(REPS):
        torch.cuda.synchronize()
        a0 = time.perf_counter()
        ex._cached_batch_build("i", ("timing",), expr, leaves, slices)
        torch.cuda.synchronize()
        a1 = time.perf_counter()
        ex._cached_batch("i", child, expr, leaves, slices)
        hits.append((time.perf_counter() - a1) * 1e3)
        builds.append((a1 - a0) * 1e3)
    out["build_ms"], out["hit_ms"] = statistics.median(builds), statistics.median(hits)
    log(f"phase 5: the batch cache for Count(Intersect): a build p50 {out['build_ms']:.3f} ms, "
        f"a hit p50 {out['hit_ms']:.3f} ms (2 leaves x {N_SLICES} slice-rows, no row copied)")
    out["latencies_ms"] = latencies
    out["planes"] = planes
    return out


def perf_site_launches(host: str, site: str) -> int:
    """Launches of one site of ``/debug/perf`` (the launch telemetry)."""
    doc = json.loads(http_raw(host, "/debug/perf")[1])
    return int(doc["sites"].get(site, {}).get("launches", 0))


def stat_counts(srv, *names: str) -> dict[str, int]:
    """The node's counts of ``names`` (its stats client, /debug/vars)."""
    counts = srv.holder.stats.snapshot()["counts"]
    return {n: int(counts.get(n, 0)) for n in names}


def topn_route(srv, pql: str, n: int) -> dict:
    """How the last ``n`` requests of TopN ``pql`` were served, from their
    traces: ``folded`` (a ``topn.prep`` span) or ``two_round`` (none: the
    request prepares and scores every time); of the folded ones, the prep
    ``builds`` (``prep_cache=miss``) and the ``scored`` ones
    (``score_cache=computed``), which must be the builds; ``prep``, each
    request's ``prep_cache`` in order (None for the two rounds).  An entry lives
    ``cache.RECALCULATE_INTERVAL_S`` from its build, so a repeat may build
    again only if it ended that long after the request that last built it
    began (the entry is younger than that request, and the repeat looks
    it up before it ends): on a slower host the expected counts follow
    the builds that expiry allows, not the clock."""
    from pilosa_tpu_torch.core import cache as cache_mod

    recs = [t for t in srv.tracer.traces() if t["spans"][0]["tags"].get("query") == pql][-n:]
    if len(recs) != n:
        raise AssertionError(f"TopN route of {pql}: {len(recs)} traces (want {n})")
    out = {"folded": 0, "two_round": 0, "builds": 0, "scored": 0, "prep": []}
    built_at = None
    for t in sorted(recs, key=lambda t: t["start"]):
        tags = {sp["name"]: sp["tags"] for sp in t["spans"]}
        out["prep"].append(tags.get("topn.prep", {}).get("prep_cache"))
        if "topn.prep" not in tags:
            out["two_round"] += 1
            continue
        out["folded"] += 1
        if tags["topn.prep"].get("prep_cache") == "miss":
            age = None if built_at is None else t["start"] + t["duration_ms"] / 1e3 - built_at
            if age is not None and age < cache_mod.RECALCULATE_INTERVAL_S:
                raise AssertionError(f"TopN {pql}: a repeat within {age:.1f}s of the last "
                                     "build built its prep again")
            out["builds"] += 1
            built_at = t["start"]
        out["scored"] += tags.get("topn.score", {}).get("score_cache") == "computed"
    if out["scored"] != out["builds"]:
        raise AssertionError(f"TopN {pql}: {out['scored']} scorings for {out['builds']} builds")
    return out


TOPN_THREADS = 8


PREP_STATS = ("exec.topn.prepBuild", "exec.topn.prepHit", "exec.topn.scoreShared")


def topn_cache_and_check(srv, sp, ds, planes, topns, src_scores) -> dict:
    """Phase 5's TopN prep cache checks on the served path, after phase
    5's REPS requests of each TopN: builds, hits and shared scorings from
    the node's stats, each request's route from its trace
    (``topn_route``), and K4's launches both from its counter and from
    ``/debug/perf``'s ``topn`` site."""
    h = srv.host
    out: dict = {}
    k4_0, k7_0, site_0 = sp.launches, ds.launches, perf_site_launches(h, "topn")
    c0 = stat_counts(srv, *PREP_STATS)
    rebuilt = want_k4 = 0
    for name, pql, want, _ in topns:
        for _ in range(3):
            status, body = http(h, "POST", "/index/i/query", pql.encode())
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 5 {name} repeat: {status} {str(body)[:300]}")
        # Repeats build only where the entry of phase 5's first request
        # expired (none within its lifetime).
        n = topn_route(srv, pql, REPS + 3)["prep"][REPS:].count("miss")
        rebuilt += n
        want_k4 += n if "Bitmap" in pql else 0
    c1 = stat_counts(srv, *PREP_STATS)
    builds = c1["exec.topn.prepBuild"] - c0["exec.topn.prepBuild"]
    hits = c1["exec.topn.prepHit"] - c0["exec.topn.prepHit"]
    if (builds, hits, sp.launches - k4_0) != (rebuilt, 6 - rebuilt, want_k4) \
            or perf_site_launches(h, "topn") - site_0 != want_k4:
        raise AssertionError(f"phase 5: repeated TopNs: stats {c0} -> {c1}, score_planes "
                             f"launches {sp.launches - k4_0} (want {rebuilt} builds, "
                             f"{6 - rebuilt} hits, {want_k4} launches)")
    out["repeat"] = {"builds": builds, "hits": hits, "k4": sp.launches - k4_0}
    # A bit of row 7 where row 0 (the src) is set and row 7 is not: row
    # 7's src score rises by one, then falls back with the ClearBit.
    p0, p7 = planes[:, 0], planes[:, 7]
    col = next(c for c in range(N_SLICES << 20)
               if (int(p0[c >> 20, (c & 0xFFFFF) >> 5]) >> (c & 31)) & 1
               and not (int(p7[c >> 20, (c & 0xFFFFF) >> 5]) >> (c & 31)) & 1)
    name, pql, _, _ = topns[1]
    scores = src_scores.copy()
    scores[col >> 20, 7] += 1
    for verb, want in (("SetBit", topn_oracle(scores, 5)), ("ClearBit", topn_oracle(src_scores, 5))):
        status, body = http(h, "POST", "/index/i/query",
                            f"{verb}(frame=f, rowID=7, columnID={col})".encode())
        if status != 200 or body["results"] != [True]:
            raise AssertionError(f"phase 5 {verb}: {status} {body}")
        c2, k4_2 = stat_counts(srv, *PREP_STATS), sp.launches
        if verb == "SetBit":
            status, body = http(h, "POST", "/index/i/query", pql.encode())
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 5 TopN(src) after SetBit: {status} {str(body)[:300]}")
            got = [body["results"][0]]
        else:
            got = []
            barrier = threading.Barrier(TOPN_THREADS)

            def one():
                barrier.wait(timeout=60)
                return http(h, "POST", "/index/i/query", pql.encode())

            with ThreadPoolExecutor(TOPN_THREADS) as pool:
                for st_, body in [f.result(timeout=600)
                                  for f in [pool.submit(one) for _ in range(TOPN_THREADS)]]:
                    if st_ != 200 or body["results"] != [want]:
                        raise AssertionError(f"phase 5 TopN(src) x {TOPN_THREADS} threads: {st_}")
                    got.append(body["results"][0])
        c3 = stat_counts(srv, *PREP_STATS)
        builds, k4 = c3["exec.topn.prepBuild"] - c2["exec.topn.prepBuild"], sp.launches - k4_2
        if (builds, k4) != (1, 1):
            raise AssertionError(f"phase 5 TopN(src) after {verb}: {builds} builds and {k4} "
                                 f"score_planes launches (want 1 and 1)")
        out[verb] = {"requests": len(got), "builds": builds, "k4": k4,
                     "shared": c3["exec.topn.scoreShared"] - c2["exec.topn.scoreShared"]}
    out["k4_launches"] = sp.launches - k4_0
    out["k7_launches"] = ds.launches - k7_0
    if perf_site_launches(h, "topn") - site_0 != out["k4_launches"]:
        raise AssertionError("phase 5: /debug/perf's topn launches differ from score_planes'")
    log(f"phase 5: TopN prep cache: 3 repeats of TopN and TopN(src): {out['repeat']} (builds "
        f"only past an entry's lifetime); a SetBit between two TopN(src)s: "
        f"{out['SetBit']}; after a ClearBit, {TOPN_THREADS} threads at once: {out['ClearBit']} "
        f"(score_planes launches {out['k4_launches']} = /debug/perf topn launches, "
        f"delta_scatter {out['k7_launches']}); answers == numpy oracle")
    return out


# Phase 14: serial Counts after the miss, and the storm: threads x requests,
# the Bitmap requests' slices, the g-frame bits they intersect.
SERIAL_REPS = 20
STORM_THREADS = 64
STORM_REQUESTS = 6
STORM_SLICES = 16
STORM_G_BITS = 256


def expr_pql(expr: tuple) -> str:
    """A tree over ("leaf", i) as PQL over Bitmap(frame=f, rowID=i)."""
    if expr[0] == "leaf":
        return f"Bitmap(frame=f, rowID={expr[1]})"
    return f"{expr[0]}({', '.join(expr_pql(e) for e in expr[1:])})"


def expr_np(expr: tuple, rows: np.ndarray) -> np.ndarray:
    """uint32 [S, W] result rows of ``expr`` over ``rows`` [S, L, W]."""
    if expr[0] == "leaf":
        return rows[:, expr[1]]
    kids = [expr_np(e, rows) for e in expr[1:]]
    acc = kids[0]
    for k in kids[1:]:
        acc = {"Intersect": np.bitwise_and, "Union": np.bitwise_or, "Xor": np.bitwise_xor,
               "Difference": lambda a, b: a & ~b}[expr[0]](acc, k)
    return acc


@contextlib.contextmanager
def k2_shape_spy(te):
    """Count each K2 call's (slices x leaves: reduce) in the dict it
    yields, while the block runs."""
    shapes: dict = {}
    tree_eval = te.tree_eval

    def spied(table, program, reduce):
        key = f"{table.shape[0]}x{table.shape[1]}:{reduce}"
        shapes[key] = shapes.get(key, 0) + 1
        return tree_eval(table, program, reduce)

    te.tree_eval = spied
    try:
        yield shapes
    finally:
        te.tree_eval = tree_eval


def coalesce_and_check(fp, te, it, srv, truth: np.ndarray, rng) -> dict:
    """Phase 14 on the phase-5 node (``truth`` its frame-f planes): the
    coalesced query path.

    Serial Count(Intersect(Bitmap(0), Bitmap(1))): a SetBit, then the
    first Count (the entry rebuilds: a cache miss), SERIAL_REPS more (hits),
    another SetBit and the Count again (a rebuild, the answer one more) —
    one K2 launch a request, no K1.  Then the storm: STORM_THREADS client
    threads x STORM_REQUESTS requests drawn from 16 distinct trees over the
    8 rows, as Count over every slice and as Bitmap of the tree intersected
    with a row of frame g over the first STORM_SLICES slices, every answer
    against numpy (each query sent once before, serially, to build its
    batch); in turns with coalescing on, off, off, on (off: the
    scheduler closed, so the direct K2 path serves).  Coalesced turns must
    launch fewer times than they answer, and fuse (K3).  Every K2 launch's
    (slices, leaves, reduce) is counted and logged a turn: the shapes the
    coalescer sends."""
    with k2_shape_spy(te) as k2_shapes:
        return _coalesce_and_check(fp, te, it, srv, truth, rng, k2_shapes)


def _coalesce_and_check(fp, te, it, srv, truth, rng, k2_shapes: dict) -> dict:
    from pilosa_tpu_torch.exec.coalesce import CoalesceScheduler

    out: dict = {}
    h = srv.host
    ex = srv.executor
    builds = {"n": 0}
    build = ex._cached_batch_build

    def counted(*a, **kw):
        builds["n"] += 1
        return build(*a, **kw)

    def setbit(row: int, col: int) -> None:
        status, body = http(h, "POST", "/index/i/query",
                            f"SetBit(frame=f, rowID={row}, columnID={col})".encode())
        if status != 200 or body["results"] != [True]:
            raise AssertionError(f"phase 14 SetBit {row} {col}: {status} {body}")
        truth[col >> 20, row, (col & 0xFFFFF) >> 5] |= np.uint32(1 << (col & 31))

    def bit(row: int, col: int) -> int:
        return int(truth[col >> 20, row, (col & 0xFFFFF) >> 5] >> (col & 31)) & 1

    q = "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))"
    fresh: list[int] = []  # two columns in row 1 and not in row 0
    while len(fresh) < 2:
        c = int(rng.integers(0, N_SLICES << 20))
        if bit(1, c) and not bit(0, c) and c not in fresh:
            fresh.append(c)
    ex._cached_batch_build = counted
    try:
        fp.launches = te.launches = it.launches = 0  # the main path starts here
        setbit(0, fresh[0])
        want = int(np.bitwise_count(truth[:, 0] & truth[:, 1]).sum())
        times = []
        for n in range(1 + SERIAL_REPS):
            q0 = time.perf_counter()
            status, body = http(h, "POST", "/index/i/query", q.encode())
            times.append((time.perf_counter() - q0) * 1e3)
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 14 serial Count {n}: {status} {body} != {want}")
        if builds["n"] != 1:
            raise AssertionError(f"phase 14: {builds['n']} batch builds over the serial Counts "
                                 "(want 1: the first after the SetBit)")
        setbit(0, fresh[1])
        status, body = http(h, "POST", "/index/i/query", q.encode())
        if status != 200 or body["results"] != [want + 1] or builds["n"] != 2:
            raise AssertionError(f"phase 14 Count after a SetBit: {status} {body} (want "
                                 f"{want + 1}), {builds['n']} builds (want 2)")
        serial = (te.launches, fp.launches, it.launches)  # the main path ends here
        if serial != (SERIAL_REPS + 2, 0, 0):
            raise AssertionError(f"phase 14 serial: tree_eval / fused_popcount / interp launches "
                                 f"{serial} != {(SERIAL_REPS + 2, 0, 0)}")
    finally:
        del ex._cached_batch_build
    out["serial_miss_ms"] = times[0]
    out["serial_hit_p50_ms"] = statistics.median(times[1:])
    log(f"phase 14: serial {q}: first request (the entry rebuilt after a SetBit) "
        f"{times[0]:.3f} ms, then {SERIAL_REPS} hits p50 {out['serial_hit_p50_ms']:.3f} ms; a "
        f"SetBit made the next Count rebuild and answer {want + 1}; launches tree_eval "
        f"{serial[0]}, fused_popcount {serial[1]}, interp {serial[2]}")

    # The storm's Bitmap trees meet rows 4-7 of frame g (bits of our own
    # in the first STORM_SLICES slices): small answers over a few slices.
    g_cols = rng.choice(STORM_SLICES << 20, STORM_G_BITS, replace=False)
    g_rows = 4 + rng.integers(0, 4, STORM_G_BITS)
    calls = " ".join(f"SetBit(frame=g, rowID={r}, columnID={c})" for r, c in zip(g_rows, g_cols))
    status, _ = http(h, "POST", "/index/i/query", calls.encode())
    if status != 200:
        raise AssertionError(f"phase 14 g bits: {status}")
    exprs = storm_exprs()
    slices = ",".join(str(i) for i in range(STORM_SLICES))
    queries = []
    for k, e in enumerate(exprs):
        res = expr_np(e, truth)
        queries.append(("/index/i/query", f"Count({expr_pql(e)})",
                        int(np.bitwise_count(res).sum())))
        g = 4 + k % 4
        sel = np.sort(g_cols[g_rows == g])
        hit = (res[sel >> 20, (sel & 0xFFFFF) >> 5] >> (sel & 31)) & 1 == 1
        queries.append((f"/index/i/query?slices={slices}",
                        f"Intersect(Bitmap(frame=g, rowID={g}), {expr_pql(e)})",
                        {"attrs": {}, "bits": [int(c) for c in sel[hit]]}))
    plan_reqs = [[queries[int(i)] for i in rng.integers(0, len(queries), STORM_REQUESTS)]
                 for _ in range(STORM_THREADS)]
    # Each query once, serially: the turns below compare served batches,
    # not builds.
    w0 = time.perf_counter()
    for path, pql, want in queries:
        status, body = http(h, "POST", path, pql.encode())
        if status != 200 or body["results"] != [want]:
            raise AssertionError(f"phase 14 warm {pql}: {status} {str(body)[:200]}")
    log(f"phase 14: {len(queries)} storm queries built their batches in "
        f"{time.perf_counter() - w0:.3f} s, serially")
    n_req = STORM_THREADS * STORM_REQUESTS

    def storm(on: bool) -> dict:
        if on and ex.coalescer is None:
            srv.coalescer = ex.coalescer = CoalesceScheduler()
        if not on and ex.coalescer is not None:
            srv.coalescer.close()
            srv.coalescer = ex.coalescer = None
        snap0 = ex.coalescer.snapshot() if on else None
        k0 = (te.launches, it.launches, fp.launches)
        k2_shapes.clear()
        start = threading.Barrier(STORM_THREADS)

        def client(reqs):
            start.wait(timeout=600)
            lat = []
            for path, pql, want in reqs:
                q0 = time.perf_counter()
                status, body = http(h, "POST", path, pql.encode())
                lat.append((time.perf_counter() - q0) * 1e3)
                if status != 200 or body["results"] != [want]:
                    raise AssertionError(f"phase 14 storm {pql}: {status} {str(body)[:200]} "
                                         f"!= {str(want)[:200]}")
            return lat

        t0 = time.perf_counter()
        with ThreadPoolExecutor(STORM_THREADS) as pool:
            lats = [x for f in [pool.submit(client, r) for r in plan_reqs]
                    for x in f.result(timeout=1200)]
        wall = time.perf_counter() - t0
        lats.sort()
        row = {"coalesce": on, "requests": n_req, "rps": n_req / wall,
               "p50_ms": lats[len(lats) // 2], "p99_ms": lats[int(len(lats) * 0.99)],
               "k2": te.launches - k0[0], "k3": it.launches - k0[1], "k1": fp.launches - k0[2],
               "k2_shapes": dict(sorted(k2_shapes.items()))}
        if on:
            snap = ex.coalescer.snapshot()
            row.update({k: snap[k] - snap0[k] for k in ("launches", "queries", "fused_launches",
                                                         "fused_queries", "fuse_fallbacks")})
            row["mean_occupancy"] = row["queries"] / row["launches"] if row["launches"] else None
            if not row["launches"] < row["queries"] == n_req or not row["fused_launches"]:
                raise AssertionError(f"phase 14 storm (coalesce on): {row}")
            if row["k2"] + row["k3"] != row["launches"] or row["k1"]:
                raise AssertionError(f"phase 14 storm: launches {row} do not match the scheduler")
        elif (row["k2"], row["k3"], row["k1"]) != (n_req, 0, 0):
            raise AssertionError(f"phase 14 storm (coalesce off): {row}")
        log(f"phase 14: storm, coalescing {'on' if on else 'off'}: {n_req} requests "
            f"({STORM_THREADS} threads, {len(exprs)} trees x Count / Bitmap) == numpy oracle; "
            f"{row['rps']:.1f} requests/s, p50 {row['p50_ms']:.3f} ms, p99 "
            f"{row['p99_ms']:.3f} ms; launches tree_eval {row['k2']}, interp {row['k3']}, "
            f"fused_popcount {row['k1']}; tree_eval (slices x leaves: reduce) "
            f"{json.dumps(row['k2_shapes'])}"
            + (f"; scheduler {json.dumps(snap)}" if on else ""))
        return row

    out["storm"] = [storm(on) for on in (True, False, False, True)]
    out["queries"] = queries
    out["k2_launches"] = te.launches
    out["k3_launches"] = it.launches
    out["launches"] = fp.launches
    return out


def set_bits(truth: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> None:
    """OR (row, column) bits into the oracle planes [slices, rows, words]."""
    offs = cols & 0xFFFFF
    masks = (np.uint32(1) << (offs & 31).astype(np.uint32)).astype(np.uint32)
    np.bitwise_or.at(truth, (cols >> 20, rows, offs >> 5), masks)


def cluster_and_check(fp, ds, br, sp, te, scatter, convert, Server, InternalClient, planes,
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
            load_in_threads(convert, [(srv.holder, "i", "f", "standard", {sl: plane})
                                      for srv in nodes for sl, plane in owned[srv.host].items()])
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

            fp.launches = ds.launches = sp.launches = te.launches = 0  # the main path starts here
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
            if got != counts[0][2] or not 1 <= ds.launches <= legs or te.launches != legs:
                raise AssertionError(f"first Count after import 1: {got} (want {counts[0][2]}), "
                                     f"delta_scatter launches {ds.launches} (want 1..{legs}), "
                                     f"tree_eval launches {te.launches} (want {legs})")
            log(f"phase 6: the first Count after the import {out['first_count_ms']:.3f} ms: "
                f"delta_scatter launches {ds.launches} (at most one per node leg: {legs} legs), "
                f"tree_eval launches {te.launches} (one per node leg)")
            k4_before, k2_before, k1_before = sp.launches, te.launches, fp.launches
            latencies = run(counts + topns, hosts, CLUSTER_REPS)
            # TopN(src) from any node: the two rounds of the map/reduce, each
            # leg one K4 launch over the node's fragments.  Each Count: one
            # K2 launch per node leg, no K1.
            want_k4 = 3 * 2 * CLUSTER_REPS * 2 * legs
            want_k2 = 3 * 2 * CLUSTER_REPS * len(counts) * legs
            if sp.launches - k4_before != want_k4:
                raise AssertionError(f"phase 6 TopN(src): score_planes launches "
                                     f"{sp.launches - k4_before} != {want_k4} (2 rounds x "
                                     f"{legs} node legs x {3 * 2 * CLUSTER_REPS} requests)")
            if (te.launches - k2_before, fp.launches - k1_before) != (want_k2, 0):
                raise AssertionError(f"phase 6 Counts: tree_eval / fused_popcount launches "
                                     f"{te.launches - k2_before} / {fp.launches - k1_before} != "
                                     f"{want_k2} / 0 (one K2 per node leg)")
            out["k2_counts"] = te.launches - k2_before
            out["k4_legs"] = legs
            out["trace"] = cluster_trace(nodes[0], hosts)
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
            cols2 = rng.integers(0, FALLBACK_SLICES << 20, FALLBACK_IMPORT_BITS)
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
            out["k2_launches"] = te.launches
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
            log(f"phase 6: answers == numpy oracle; tree_eval launches {out['k2_launches']}, "
                f"fused_popcount launches {out['launches']} (the BSI Intersect's), "
                f"delta_scatter launches {out['k7_launches']}, "
                f"bsi_ripple launches {out['k8_launches']}, score_planes launches "
                f"{out['k4_launches']} (one per node leg and round: {legs} legs)")
            out["latencies_ms"] = latencies
        finally:
            for srv in opened:
                srv.close()
    return out


def load_in_threads(convert, jobs) -> None:
    """``convert.load_planes(holder, index, frame, view, {slice: plane})``
    of every job on LOAD_THREADS worker threads: the fragments are
    independent and their snapshots mostly wait on the disk."""
    with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
        for fut in [pool.submit(convert.load_planes, *job) for job in jobs]:
            fut.result()


def bsi_planes(rng, n_slices: int, depth: int = K8_DEPTH) -> np.ndarray:
    """uint32 [n_slices, 2 + depth, 32768] planes of a signed field (31
    magnitude bits: 32-bit), generated word by word: ~50% of columns
    valued, magnitudes masked to exists, the sign cleared where the
    magnitude is zero."""
    planes = rng.integers(0, 2**32, size=(n_slices, 2 + depth, 32768), dtype=np.uint32)
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


def bsi_and_check(fp, ds, br, te, it, scatter, convert, InternalClient, srv, f_planes,
                  rng) -> dict:
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
    te0, it0 = te.launches, it.launches  # K2 (a row leaf's rows) and K3 (the storm)
    for path, body in (("/index/i/frame/n", b'{"options": {"rangeEnabled": true}}'),
                       ("/index/i/frame/n/field/v",
                        b'{"min": -2147483647, "max": 2147483647}')):
        status, resp = http(h, "POST", path, body)
        if status != 200:
            raise AssertionError(f"POST {path}: {status} {resp}")
    t0 = time.perf_counter()
    planes = bsi_planes(rng, N_SLICES)
    t1 = time.perf_counter()
    load_in_threads(convert, [(srv.holder, "i", "n", "field_v", {s: planes[s]})
                              for s in range(N_SLICES)])
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
    # BSI trees on the main route: repeats from the batch cache, a storm of
    # BSI and row trees through the coalescer, fused K3 against K8.
    cache_q = [(f"Count(Range(frame=n, v > {drawn[0]}))", oracle.count(">", drawn[0])),
               (f"Sum({f2}, frame=n, field=v)", oracle.agg("Sum", "f2"))]
    out["cache"] = bsi_cache_and_check(srv, br, planes, cache_q, oracle, "loaded")
    w_planes, w_oracle = shallow_field(srv, convert, np.random.default_rng(SEED + 71))
    trees = bsi_storm_trees(oracle, w_oracle, f_planes, drawn)
    out["storm"] = bsi_storm_and_check(srv, br, it, te, fp, trees)
    for k, n in out["storm"]["k8"].items():
        out["launches"][k] += n
    out["launches"]["k1"] += out["storm"]["k1"]
    out["fused_vs_k8"] = bsi_fused_vs_k8(srv, br, it, te, fp, trees[:3])
    del w_planes, w_oracle

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
        # The import moved every field fragment's version: each entry built
        # before it rebuilds once, then hits.
        out["cache_after_import"] = bsi_cache_and_check(srv, br, planes, [
            (f"Count(Range(frame=n, v > {drawn[0]}))", oracle.count(">", drawn[0])),
            (f"Sum({f2}, frame=n, field=v)", oracle.agg("Sum", "f2"))], oracle, "after import 1")
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
    out["k2_launches"], out["k3_launches"] = te.launches - te0, it.launches - it0
    return out


def plan_cache_tags(srv, pql: str, n: int) -> list:
    """The ``batch_cache`` annotation of the ``plan`` span in each of the
    last ``n`` traces of ``pql``, oldest first."""
    recs = [t for t in srv.tracer.traces() if t["spans"][0]["tags"].get("query") == pql][-n:]
    return [next((sp["tags"].get("batch_cache") for sp in t["spans"] if sp["name"] == "plan"),
                 None) for t in recs]


def bsi_cache_and_check(srv, br, planes, queries, oracle, stage: str) -> dict:
    """Phase 7: BSI Count, Bitmap and Sum asked twice each; the second is a
    batch-cache hit (``batch_cache=hit`` in its trace) that builds nothing
    (the node's ``exec.batch.build`` count).  After the load the Count and Sum were
    asked before (two hits); the Bitmap, and after an /import-value every
    query, build once (a miss, then a hit).  The Bitmap is ``Range(v == x)``
    for the value x of slice 0's first valued column, each of its bits
    checked against its slice's decoded values."""
    h = srv.host
    valued, values = decode_values(planes[0])
    x = int(values[np.flatnonzero(valued)[0]])
    rng_pql = f"Range(frame=n, v == {x})"
    out: dict = {}
    for pql, want in queries + [(rng_pql, None)]:
        c0 = stat_counts(srv, "exec.batch.build")["exec.batch.build"]
        times = []
        for _ in range(2):
            q0 = time.perf_counter()
            status, body = http(h, "POST", "/index/i/query", pql.encode())
            times.append((time.perf_counter() - q0) * 1e3)
            if status != 200:
                raise AssertionError(f"phase 7 {stage} {pql}: {status} {str(body)[:300]}")
            got = body["results"][0]
            if want is None:
                bits = np.asarray(got["bits"], dtype=np.int64)
                ok = len(bits) == oracle.count("==", x)
                for s_ in np.unique(bits >> 20):
                    vd, vs = decode_values(planes[s_])
                    off = bits[(bits >> 20) == s_] & 0xFFFFF
                    ok = ok and bool(vd[off].all() and (vs[off] == x).all())
                if not ok:
                    raise AssertionError(f"phase 7 {stage} {rng_pql}: {len(bits)} bits")
            elif got != want:
                raise AssertionError(f"phase 7 {stage} {pql}: {got} != {want}")
        builds = stat_counts(srv, "exec.batch.build")["exec.batch.build"] - c0
        tags = plan_cache_tags(srv, pql, 2)
        rebuilt = stage != "loaded" or want is None
        if tags != (["miss", "hit"] if rebuilt else ["hit", "hit"]) or builds != int(rebuilt):
            raise AssertionError(f"phase 7 {stage} {pql}: plan spans {tags}, builds {builds}")
        out[pql] = {"batch_cache": tags, "builds": builds, "ms": [round(t, 3) for t in times]}
    log(f"phase 7 {stage}: BSI Count, Sum and Bitmap asked twice: the second from the batch "
        f"cache: {json.dumps(out)}")
    return out


# Phase 7's shallow field w: a depth whose comparisons lower within the
# coalescer's op budget (about nine instructions per magnitude bit), where
# a fused K3 launch and K8's per-key launches are both open to the
# coalescer; v's depth-31 ones do not fit.
W_DEPTH = 8


def shallow_field(srv, convert, rng) -> tuple:
    """Phase 7's field w (depth W_DEPTH) beside v, over every slice:
    (planes, oracle)."""
    import torch

    hi = (1 << W_DEPTH) - 1
    status, resp = http(srv.host, "POST", "/index/i/frame/n/field/w",
                        json.dumps({"min": -hi, "max": hi}).encode())
    if status != 200:
        raise AssertionError(f"POST field w: {status} {resp}")
    t0 = time.perf_counter()
    planes = bsi_planes(rng, N_SLICES, W_DEPTH)
    load_in_threads(convert, [(srv.holder, "i", "n", "field_w", {s: planes[s]})
                              for s in range(N_SLICES)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    oracle = ValueOracle(planes, {})
    log(f"phase 7: field w (depth {W_DEPTH}) over {N_SLICES} slices made and loaded in "
        f"{t1 - t0:.3f}s ({planes.nbytes / 1e9:.3f} GB), oracle decoded in "
        f"{time.perf_counter() - t1:.3f}s")
    return planes, oracle


def bsi_storm_trees(oracle, w_oracle, f_planes, drawn) -> list:
    """(pql, expected) of phase 7's storm: three BSI Counts over the
    shallow field w (within the op budget), one over v (past it), and four
    row Counts over frame f's rows 1-3 (phase 5 wrote a bit into row 0)."""
    f = [f_planes[:, r] for r in range(4)]
    w = [int(x) % (1 << W_DEPTH) for x in drawn]

    def pc(x):
        return int(np.bitwise_count(x).sum())

    B = "Bitmap(frame=f, rowID={})"
    return [
        (f"Count(Range(frame=n, w > {w[0]}))", w_oracle.count(">", w[0])),
        (f"Count(Range(frame=n, w <= {-w[1]}))", w_oracle.count("<=", -w[1])),
        (f"Count(Range(frame=n, w == {w[2]}))", w_oracle.count("==", w[2])),
        (f"Count(Range(frame=n, v > {drawn[0]}))", oracle.count(">", drawn[0])),
        (f"Count(Intersect({B.format(1)}, {B.format(3)}))", pc(f[1] & f[3])),
        (f"Count(Union({B.format(1)}, {B.format(3)}))", pc(f[1] | f[3])),
        (f"Count(Difference({B.format(3)}, {B.format(2)}))", pc(f[3] & ~f[2])),
        (f"Count(Xor({B.format(1)}, {B.format(2)}))", pc(f[1] ^ f[2])),
    ]


BSI_STORM_THREADS = 8
BSI_STORM_REQUESTS = 4


def bsi_storm_and_check(srv, br, it, te, fp, trees) -> dict:
    """Phase 7: a short storm of distinct BSI and row trees through the
    coalescer (each tree built once before), every answer against the
    oracle; the launches by kernel and the coalescer's fused and fallback
    counts: the row trees fuse into K3 launches, and each BSI tree takes
    its K8 launch (``bsi_fused_vs_k8`` times the other route)."""
    h, co = srv.host, srv.coalescer
    for pql, want in trees:
        status, body = http(h, "POST", "/index/i/query", pql.encode())
        if status != 200 or body["results"] != [want]:
            raise AssertionError(f"phase 7 storm {pql}: {status} {str(body)[:200]}")
    rng = np.random.default_rng(SEED + 70)
    reqs = [[trees[int(i)] for i in rng.permutation(len(trees))[:BSI_STORM_REQUESTS]]
            for _ in range(BSI_STORM_THREADS)]
    k0 = (dict(br.launches), it.launches, te.launches, fp.launches)
    snap0 = co.snapshot()

    def client(rs):
        for pql, want in rs:
            status, body = http(h, "POST", "/index/i/query", pql.encode())
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 7 storm {pql}: {status}")
        return len(rs)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(BSI_STORM_THREADS) as pool:
        n = sum(f.result(timeout=600) for f in [pool.submit(client, r) for r in reqs])
    wall = time.perf_counter() - t0
    snap = co.snapshot()
    out = {
        "requests": n, "s": round(wall, 3), "rps": round(n / wall, 1),
        "k8": {k: br.launches[k] - k0[0][k] for k in br.KERNELS},
        "k3": it.launches - k0[1], "k2": te.launches - k0[2], "k1": fp.launches - k0[3],
        "launches": snap["launches"] - snap0["launches"],
        "fused_launches": snap["fused_launches"] - snap0["fused_launches"],
        "fused_queries": snap["fused_queries"] - snap0["fused_queries"],
        "fuse_fallbacks": snap["fuse_fallbacks"] - snap0["fuse_fallbacks"],
    }
    n_row = sum("Range" not in pql for rs in reqs for pql, _ in rs)
    if not out["k8"]["bsi_cmp"] or out["fused_queries"] > n_row:
        raise AssertionError(f"phase 7 storm: BSI trees launched no K8, or fused "
                             f"({n_row} row-tree requests): {out}")
    log(f"phase 7: a storm of {len(trees)} distinct trees (3 over w, 1 over v, 4 row), "
        f"{BSI_STORM_THREADS} threads x {BSI_STORM_REQUESTS} requests: {json.dumps(out)}; "
        "answers == numpy oracle")
    return out


def bsi_fused_vs_k8(srv, br, it, te, fp, trees) -> dict:
    """Phase 7's BSI Count trees over the shallow field w on the card two
    ways, each over the batch entries the executor cached: one fused
    interpreter launch (K3) of every program that fits the coalescer's op
    budget (``plan.FUSE_MAX_OPS``) over their union leaves, lowered as the
    coalescer lowers a drain, and the per-key K8 count launches of the same
    trees.  CUDA-event times, the L2 warm."""
    import torch

    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops.tree_eval import RowTable
    from pilosa_tpu_torch.pql import parse_string

    ex = srv.executor
    # Launches made to compare are not the main path's: the counts are
    # put back as they were.
    saved = (dict(br.launches), it.launches, te.launches, fp.launches)
    slices = list(range(N_SLICES))
    ents = []
    for pql, _ in trees:
        child = ex._rewrite_bsi("i", parse_string(pql).calls[0].children[0])
        expr, leaves = plan.decompose(child)
        ents.append(ex._cached_batch("i", child, expr, leaves, slices))
    union: dict = {}
    src_of, maps = [], []
    for i, (ent, _) in enumerate(ents):
        lmap = []
        for j, k in enumerate(ent.leaf_keys):
            if k not in union:
                union[k] = len(src_of)
                src_of.append((i, j))
            lmap.append(union[k])
        maps.append(lmap)
    em = plan.FuseEmitter(len(src_of), plan.FUSE_MAX_OPS)
    regs, fit = [], []
    for i, ((ent, _), lmap) in enumerate(zip(ents, maps)):
        cp = em.checkpoint()
        try:
            regs.append(plan.lower_expr(ent.expr, lmap, em))
            fit.append(i)
        except plan.FuseUnsupported:
            em.rollback(cp)
    if len(fit) < 2:
        raise AssertionError(f"phase 7: {len(fit)} of w's trees fit the op budget")
    cols: dict = {}
    for i, j in src_of:
        cols.setdefault(i, []).append(j)
    combined = RowTable.concat_leaves([ents[i][1] for i in sorted(cols)],
                                      [cols[i] for i in sorted(cols)])
    prog = em.table()
    out_idx = np.asarray(regs, dtype=np.int32)
    fused = plan.interp_exec("total", combined, prog, out_idx).cpu().numpy()
    per_key = [ex._direct_eval(*ents[i], "total").cpu().numpy() for i in fit]
    want = [trees[i][1] for i in fit]
    if [int(x) for x in fused] != want or [int(x[0]) for x in per_key] != want:
        raise AssertionError(f"phase 7: fused {fused}, per-key {per_key} != oracle {want}")
    out = {"trees": len(trees), "fit": len(fit), "ops": int(len(prog)),
           "leaves": len(src_of), "dedup_hits": em.dedup_hits,
           "fused_ms": time_cuda(lambda: plan.interp_exec("total", combined, prog, out_idx),
                                 runs=5, per_run=3, warmup=1)}
    out["k8_ms"] = time_cuda(lambda: [ex._direct_eval(*ents[i], "total") for i in fit],
                             runs=5, per_run=3, warmup=1)
    out["faster"] = "k3_fused" if out["fused_ms"] < out["k8_ms"] else "k8_per_key"
    torch.cuda.synchronize()
    br.launches, it.launches, te.launches, fp.launches = saved
    log(f"phase 7: {len(fit)} of {len(trees)} BSI Count trees over w (depth {W_DEPTH}, "
        f"{N_SLICES} slices) fit the coalescer's op budget of {plan.FUSE_MAX_OPS}: one fused K3 "
        f"launch ({out['ops']} ops, {out['leaves']} union leaves) {out['fused_ms']:.3f} ms "
        f"against their {len(fit)} per-key K8 count launches {out['k8_ms']:.3f} ms (CUDA events, "
        f"L2 warm): {out['faster']} is faster")
    return out


def time_and_check(fp, te, InternalClient, srv, f_planes, rng) -> dict:
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
    fp.launches = te.launches = 0
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
    # A Range leaf is a scratch row of the cached batch (the union of its
    # time views' rows): one K2 launch per request, no K1.
    if (te.launches, fp.launches) != (n_queries, 0):
        raise AssertionError(f"phase 8: tree_eval / fused_popcount launches {te.launches} / "
                             f"{fp.launches} != {n_queries} / 0")
    for name, ms in latencies.items():
        log(f"phase 8: {name} p50 {ms:.3f} ms over {REPS} requests")
    log(f"phase 8: answers == numpy oracle; tree_eval launches {te.launches}, fused_popcount "
        f"launches {fp.launches}")
    return {"launches": fp.launches, "k2_launches": te.launches, "import_s": import_s,
            "latencies_ms": latencies}


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
    out: dict = {"latencies_ms": {}, "first_ms": {}, "answers": {}, "routes": {}}
    c0 = stat_counts(srv, *PREP_STATS)
    fp.launches = sp.launches = 0  # the main path starts here
    want_k4 = want_k1 = want_builds = 0
    for name, pql, want, k4, k1 in queries:
        times = []
        for _ in range(REPS):
            q0 = time.perf_counter()
            status, body = http(h, "POST", "/index/i/query", pql.encode())
            times.append(time.perf_counter() - q0)
            if status != 200 or body["results"] != [want]:
                raise AssertionError(f"phase 9 {name}: {status} {str(body)[:300]} != {want}")
        # A folded TopN builds its prep and scores at the first request and
        # reuses both while the entry lives; the two rounds (ids) prepare
        # and score at every request.
        route = topn_route(srv, pql, REPS)
        per = route["builds"] + route["two_round"]
        want_k4 += per * k4
        want_k1 += per * k1
        want_builds += route["builds"]
        out["routes"][name] = {k: route[k] for k in ("folded", "two_round", "builds")}
        out["latencies_ms"][name] = statistics.median(times[1:]) * 1e3
        out["first_ms"][name] = times[0] * 1e3
        out["answers"][name] = len(want)
    out["k4_launches"], out["launches"] = sp.launches, fp.launches  # the main path ends here
    c1 = stat_counts(srv, *PREP_STATS)
    out["prep_builds"] = c1["exec.topn.prepBuild"] - c0["exec.topn.prepBuild"]
    out["prep_hits"] = c1["exec.topn.prepHit"] - c0["exec.topn.prepHit"]
    if (out["k4_launches"], out["launches"], out["prep_builds"]) != (want_k4, want_k1,
                                                                      want_builds):
        raise AssertionError(f"phase 9: score_planes / fused_popcount launches / prep builds "
                             f"{out['k4_launches']} / {out['launches']} / {out['prep_builds']} "
                             f"!= {want_k4} / {want_k1} / {want_builds}")
    for name, ms in out["latencies_ms"].items():
        log(f"phase 9: {name} first {out['first_ms'][name]:.3f} ms, then p50 {ms:.3f} ms over "
            f"{REPS - 1} requests ({out['answers'][name]} pairs)")
    log(f"phase 9: TopN prep entries built {out['prep_builds']}, hits {out['prep_hits']}; "
        f"routes from the traces {json.dumps(out['routes'])}")
    log(f"phase 9: answers == numpy oracle; score_planes launches {out['k4_launches']}, "
        f"fused_popcount launches {out['launches']}")
    return out


# --- Phase 10: the two tutorials (docs/tutorials.md) at the JAX defaults -------

# Star trace (tutorials.md section 1): 2^17 stargazer ids in a random
# permutation, Zipf stars per user, 1% of users starring a contiguous run of
# repository ids, over 2 slices of repositories; 64 languages, one per
# repository.  2^17 stargazers and molecules (a cut for the run's time)
# must keep ids on both sides of the dense budget of 65,536 rows, so that
# every tall fragment has its 8 GiB plane tier.
STAR_USERS = 1 << 17
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
MOLECULES = 1 << 17
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
# Phase 12's repository queries, each followed by a mole query: one saturating
# Count over both star mirrors and a query for each of K4, K5 and K6 (the
# mole queries launch K1 and K2).
RESIDENCY_QUERIES = ("count_sparse_sparse", "topn_language", "count_sparse_after_reopen",
                     "bitmap_sparse_after_reopen")
RESIDENCY_SLACK = 256 << 20
# Phase 13: writer threads x SetBits each over slices, and the serial
# SetBits of each WAL setting, in turns.
DURABLE_THREADS = 8
DURABLE_WRITES = 250
DURABLE_SLICES = 16
DURABLE_ROWS = 8
SERIAL_WRITES = 50


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
         len(np.union1d(np.union1d(ra, rb), rc)), {"k6": (1, 0), "k2": 1}),
        ("bitmap_sparse", "repository", B.format(a),
         {"attrs": {}, "bits": [int(v) for v in ra]}, {"k6": (1, 0), "k2": 1}),
        ("topn_language", "repository", f"TopN({B.format(a)}, frame=language, n=5)",
         tutorial_topn(a_lang, lang_counts, 5), {"k6": (1, 0), "k4": (1, 0)}),
        ("topn_stargazer", "repository", "TopN(frame=stargazer, n=10)",
         tutorial_topn(counts, counts, 10), {}),
        ("topn_stargazer_src", "repository",
         "TopN(Bitmap(frame=language, language_id=3), frame=stargazer, n=10)",
         tutorial_topn(l3_scores, counts, 10), {"k4": (1, 0)}),
        ("bitmap_molecule", "mole", mole["pql_m1"],
         {"attrs": {}, "bits": [int(v) for v in fm1]}, {"k6": (1, 0), "k2": 1}),
        ("count_molecules", "mole", f"Count(Intersect({mole['pql_m1']}, {mole['pql_m2']}))",
         len(np.intersect1d(fm1, fm2)), {"k5": 1}),
        ("topn_tanimoto", "mole",
         f"TopN(Bitmap(frame=fingerprint, molecule_id={FP_QUERY}), frame=fingerprint, "
         "inverse=true, n=100, tanimotoThreshold=70)", mole["tani_want"], {"k1": 1, "k4": 1}),
    ]


def tutorials_and_check(ac, ep, fp, sp, te, bp, InternalClient, srv, rng) -> dict:
    """Phase 10 on ``srv``, a fresh one-node ``Server`` on the card at the
    JAX package's defaults (dense budget 65,536, plane-format auto, 64 KiB
    caps): the star trace and the chemical-similarity tutorials loaded
    through ``/import``, then every query class of the slice, each
    answer against a numpy oracle over the written pairs, the launches of
    K1, K2, K4, K5 and K6 counted around each class."""
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
    kernels = {"k1": fp, "k2": te, "k4": sp, "k5": ac, "k6": ep}
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
        # An int is launches per request; (first, later): the first request
        # builds the cached batch (its K6 expansions) or the folded TopN's
        # prep and scores, the later ones hit — a TopN's while its entry
        # lives (topn_route: the requests that built, from their traces).
        built = 1
        if pql.startswith("TopN("):
            route = topn_route(srv, pql, reps)
            built = route["builds"] + route["two_round"]
        expect = {}
        for k in kernels:
            first, later = per_request.get(k, 0), None
            if isinstance(first, tuple):
                first, later = first
            expect[k] = first * reps if later is None else first * built + later * (reps - built)
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
        repo_q = [q for q in queries if q[1] == "repository" and q[0] in RESIDENCY_QUERIES]
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
            cache = pool.snapshot()["cache_bytes"]
            row = {"name": name, "ms": (q1 - q0) * 1e3, "resident": resident, "high": high,
                   "alloc": alloc, "reserved": reserved, "saturated": saturated, "cache": cache,
                   **{k: c[k] - c0[k] for k in ("evictions", "evictSkipped", "overBudget",
                                                "restageBytes")}}
            out["queries"].append(row)
            log(f"phase 12: {name} on {index} {row['ms']:.3f} ms; resident "
                f"{resident / 2**30:.3f} GiB (high {high / 2**30:.3f}), evictions "
                f"{row['evictions']}, skipped {row['evictSkipped']}, over budget "
                f"{row['overBudget']}, restaged {row['restageBytes'] / 2**30:.3f} GiB, cache "
                f"{cache / 2**20:.3f} MiB; memory_allocated {alloc / 2**30:.3f} GiB over the "
                f"base, reserved "
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
        if out["launches"]["k2"] == 0:
            raise AssertionError("phase 13 launched no tree_eval")
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


# --- phase 17: backup, restore and repair -------------------------------------

# Client threads of the block-checksum walks (the node serves each request
# on a thread of its own; the checksum's SHA1 releases the GIL).
BLOCK_THREADS = 8
# Fragments the source changes before the repair, and bits set and cleared
# in each.
REPAIR_SLICES = 2
REPAIR_SETS = 100
REPAIR_CLEARS = 50


def archive_members(path: str) -> dict[int, bytes]:
    """A view backup (a tar of per-slice fragment archives): slice ->
    archive."""
    import io
    import tarfile

    out = {}
    with tarfile.open(path) as tr:
        for m in tr:
            out[int(m.name)] = tr.extractfile(m).read()
    return out


def archive_bits(archive: bytes) -> dict[int, np.ndarray]:
    """One fragment archive's rows, decoded on the host from its "data"
    entry (the roaring file): row -> uint32 [32768] words."""
    import io
    import tarfile

    from pilosa_tpu_torch.ops import roaring

    with tarfile.open(fileobj=io.BytesIO(archive)) as tr:
        data = tr.extractfile("data").read()
    rows: dict[int, np.ndarray] = {}
    for key, words in roaring.decode(data).items():
        r, c = divmod(int(key), 16)
        row = rows.setdefault(r, np.zeros(32768, np.uint32))
        row[c * 2048:(c + 1) * 2048] = words.view(np.uint32)
    return rows


def torn_archive(archive: bytes) -> bytes:
    """The archive with one byte of its "data" entry flipped."""
    import io
    import tarfile

    with tarfile.open(fileobj=io.BytesIO(archive)) as tr:
        entries = {m.name: tr.extractfile(m).read() for m in tr}
    data = bytearray(entries["data"])
    data[len(data) // 2] ^= 0x55
    entries["data"] = bytes(data)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tw:
        for name, payload in entries.items():
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tw.addfile(info, io.BytesIO(payload))
    return buf.getvalue()


def csv_oracle(planes_s: np.ndarray, slice_i: int) -> bytes:
    """``row,col`` lines of one slice's rows, formatted in Python (not
    the node's numpy formatter)."""
    base = slice_i << 20
    out = []
    for r, words in enumerate(planes_s):
        cols = np.flatnonzero(np.unpackbits(words.view(np.uint8), bitorder="little")) + base
        if len(cols):
            out.append(f"{r}," + f"\n{r},".join(map(str, cols.tolist())) + "\n")
    return "".join(out).encode()


def raw_get(host: str, path: str, headers=None) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection(host, timeout=600)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def raw_post(host: str, path: str, body: bytes) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection(host, timeout=600)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def block_positions(host: str, slice_i: int, block: int) -> np.ndarray:
    """A block's bits of frame f's standard view read through
    ``/fragment/block/data`` (the protobuf of ``InternalClient.block_data``,
    decoded to arrays): sorted ``row << 20 | offset``, int64."""
    import http.client

    from pilosa_tpu_torch.net import wire

    req = wire.BlockDataRequest(Index="i", Frame="f", View="standard", Slice=slice_i,
                                Block=block)
    conn = http.client.HTTPConnection(host, timeout=600)
    try:
        conn.request("GET", "/fragment/block/data", body=req.encode(),
                     headers={"Content-Type": "application/x-protobuf",
                              "Accept": "application/x-protobuf"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"phase 17 /fragment/block/data {slice_i}/{block} on {host}: "
                             f"{resp.status} {data[:200]}")
    msg = wire.BlockDataResponse.decode(data)
    return (np.asarray(msg.RowIDs, np.int64) << 20) | np.asarray(msg.ColumnIDs, np.int64)


def every_block(InternalClient, hosts: list, slices) -> dict:
    """``{(host, slice): [(block, sha1)]}`` of frame f's standard view,
    BLOCK_THREADS requests in flight."""
    keys = [(h, s) for h in hosts for s in slices]
    with ThreadPoolExecutor(BLOCK_THREADS) as ex:
        got = list(ex.map(lambda k: InternalClient(k[0], timeout=600).fragment_blocks(
            "i", "f", "standard", k[1]), keys))
    return dict(zip(keys, got))


def backup_and_check(fp, te, ds, sp, Server, InternalClient, srv, rng) -> dict:
    """Phase 17 on the phase-5 node ``srv``: (a) the CLI's backup of frames
    f and g; (b) a second node on the card, the schema, the CLI's
    restore; (c) phase 5's queries there against the source and numpy
    over the archives' planes, K2 and K4 launched; (d) every fragment's
    blocks equal on both nodes, then set and clear bits on the source,
    find the blocks that differ, read them and push the difference with
    ``/fragment/import-view`` — one K7 launch at the next Count, blocks
    equal again; (e) a restore in place over a resident mirror and a
    cached batch entry, and a torn archive refused; (f) one slice's CSV
    export byte for byte."""
    from pilosa_tpu_torch.cli.main import main as cli

    out: dict = {"launches": {}}
    h = srv.host
    fp.launches = te.launches = ds.launches = sp.launches = 0  # the main path starts here
    with tempfile.TemporaryDirectory(prefix="pilosa-torch-backup-") as work:
        files = {}
        for frame in ("f", "g"):
            files[frame] = os.path.join(work, f"{frame}.tar")
            t0 = time.perf_counter()
            code = cli(["backup", "--host", h, "-i", "i", "-f", frame, "-o", files[frame]])
            took = time.perf_counter() - t0
            if code != 0:
                raise AssertionError(f"phase 17 backup of frame {frame}: exit {code}")
            nbytes = os.path.getsize(files[frame])
            out[f"backup_{frame}"] = {"bytes": nbytes, "s": took, "gbps": nbytes / took / 1e9}
            log(f"phase 17 (a): CLI backup of frame {frame}: {nbytes} bytes in {took:.3f} s "
                f"({nbytes / took / 1e9:.3f} GB/s)")
        members = {frame: archive_members(path) for frame, path in files.items()}
        if sorted(members["f"]) != list(range(N_SLICES)):
            raise AssertionError(f"phase 17: the backup of f holds {len(members['f'])} slices")
        truth = np.zeros((N_SLICES, ROWS, 32768), np.uint32)
        for s, archive in members["f"].items():
            for r, words in archive_bits(archive).items():
                if r >= ROWS:
                    raise AssertionError(f"phase 17: row {r} in slice {s} of frame f")
                truth[s, r] = words
        g_row1 = sorted(
            (s << 20) + int(c)
            for s, archive in members["g"].items()
            for c in np.flatnonzero(np.unpackbits(
                archive_bits(archive).get(1, np.zeros(32768, np.uint32)).view(np.uint8),
                bitorder="little"))
        )

        dst_dir = os.path.join(work, "restored")
        dst = Server(dst_dir, host="127.0.0.1:0", device=srv.device)
        dst.open()
        try:
            for path in ("/index/i", "/index/i/frame/f", "/index/i/frame/g"):
                status, body = http(dst.host, "POST", path)
                if status != 200:
                    raise AssertionError(f"phase 17 POST {path}: {status} {body}")
            for frame in ("f", "g"):
                t0 = time.perf_counter()
                code = cli(["restore", "--host", dst.host, "-i", "i", "-f", frame, "-d",
                            files[frame]])
                took = time.perf_counter() - t0
                if code != 0:
                    raise AssertionError(f"phase 17 restore of frame {frame}: exit {code}")
                nbytes = out[f"backup_{frame}"]["bytes"]
                out[f"restore_{frame}"] = {"s": took, "gbps": nbytes / took / 1e9}
                log(f"phase 17 (b): CLI restore of frame {frame} into a second node: "
                    f"{len(members[frame])} fragments in {took:.3f} s ({nbytes / took / 1e9:.3f} GB/s)")

            # (c) phase 5's queries on the restored node.
            def pc(x):
                return int(np.bitwise_count(x).sum())

            def queries(planes):
                p0, p1, p2, p3 = (planes[:, r] for r in range(4))
                totals = np.bitwise_count(planes).sum(axis=-1, dtype=np.int64)
                src = np.bitwise_count(planes & planes[:, :1]).sum(axis=-1, dtype=np.int64)
                return [
                    ("count_bitmap", "Count(Bitmap(frame=f, rowID=0))", pc(p0)),
                    ("count_intersect",
                     "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))",
                     pc(p0 & p1)),
                    ("count_union3", "Count(Union(Bitmap(frame=f, rowID=0), Bitmap(frame=f, "
                     "rowID=1), Bitmap(frame=f, rowID=2)))", pc(p0 | p1 | p2)),
                    ("count_difference",
                     "Count(Difference(Bitmap(frame=f, rowID=2), Bitmap(frame=f, rowID=3)))",
                     pc(p2 & ~p3)),
                    ("count_xor", "Count(Xor(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=3)))",
                     pc(p1 ^ p3)),
                    ("bitmap_g", "Bitmap(frame=g, rowID=1)", {"attrs": {}, "bits": g_row1}),
                    ("topn", "TopN(frame=f, n=5)", topn_oracle(totals, 5)),
                    ("topn_src", "TopN(Bitmap(frame=f, rowID=0), frame=f, n=5)",
                     topn_oracle(src, 5)),
                ]

            out["p50_ms"] = {}
            for i, (name, pql, want) in enumerate(queries(truth)):
                times = []
                for _ in range(REPS + (1 if i == 0 else 0)):
                    q0 = time.perf_counter()
                    status, body = http(dst.host, "POST", "/index/i/query", pql.encode())
                    times.append(time.perf_counter() - q0)
                    if status != 200 or body["results"] != [want]:
                        raise AssertionError(f"phase 17 (c) {name} on the restored node: {status} "
                                             f"{str(body)[:300]} != {want}")
                if i == 0:
                    out["first_count_ms"] = times.pop(0) * 1e3
                src_status, src_body = http(h, "POST", "/index/i/query", pql.encode())
                if (src_status, src_body) != (status, body):
                    raise AssertionError(f"phase 17 (c) {name}: the source answers {src_status} "
                                         f"{str(src_body)[:300]}")
                out["p50_ms"][name] = statistics.median(times) * 1e3
            if te.launches == 0 or sp.launches == 0:
                raise AssertionError(f"phase 17 (c): tree_eval / score_planes launches "
                                     f"{te.launches} / {sp.launches}")
            log(f"phase 17 (c): the restored node answers phase 5's queries as the source and "
                f"numpy over the archives' planes; the first Count ({N_SLICES} mirrors uploaded) "
                f"{out['first_count_ms']:.3f} ms, p50 over {REPS}: "
                + ", ".join(f"{k} {v:.3f}" for k, v in out["p50_ms"].items())
                + f" ms; tree_eval launches {te.launches}, score_planes {sp.launches}")

            # (d) block sync: equal, then a repair of the blocks that differ.
            hosts = [h, dst.host]
            t0 = time.perf_counter()
            blocks = every_block(InternalClient, hosts, range(N_SLICES))
            out["blocks_s"] = time.perf_counter() - t0
            unequal = [s for s in range(N_SLICES) if blocks[(h, s)] != blocks[(dst.host, s)]]
            if unequal or any(not blocks[(h, s)] for s in range(N_SLICES)):
                raise AssertionError(f"phase 17 (d): blocks differ after the restore: {unequal[:10]}")
            touched = sorted(int(s) for s in rng.choice(N_SLICES, REPAIR_SLICES, replace=False))
            n_changed = 0
            t0 = time.perf_counter()
            for s in touched:
                calls = []
                for want_set, n in ((True, REPAIR_SETS), (False, REPAIR_CLEARS)):
                    picked: set = set()
                    while len(picked) < n:
                        r, off = int(rng.integers(0, ROWS)), int(rng.integers(0, 1 << 20))
                        bit = (int(truth[s, r, off >> 5]) >> (off & 31)) & 1
                        if bit != want_set and (r, off) not in picked:
                            picked.add((r, off))
                    for r, off in sorted(picked):
                        op = "SetBit" if want_set else "ClearBit"
                        calls.append(f"{op}(frame=f, rowID={r}, columnID={(s << 20) + off})")
                        if want_set:
                            truth[s, r, off >> 5] |= np.uint32(1 << (off & 31))
                        else:
                            truth[s, r, off >> 5] &= np.uint32(~(1 << (off & 31)) & 0xFFFFFFFF)
                status, body = http(h, "POST", "/index/i/query", " ".join(calls).encode())
                if status != 200 or body["results"] != [True] * len(calls):
                    raise AssertionError(f"phase 17 (d) writes to slice {s}: {status} {str(body)[:200]}")
                n_changed += len(calls)
            out["writes_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            blocks = every_block(InternalClient, hosts, range(N_SLICES))
            out["blocks_again_s"] = time.perf_counter() - t0
            diff = sorted((s, b) for s in range(N_SLICES)
                          for b in {bid for bid, _ in blocks[(h, s)] + blocks[(dst.host, s)]}
                          if dict(blocks[(h, s)]).get(b) != dict(blocks[(dst.host, s)]).get(b))
            if diff != [(s, 0) for s in touched]:
                raise AssertionError(f"phase 17 (d): blocks {diff} differ, the writes touched "
                                     f"block 0 of slices {touched}")
            dst_c = InternalClient(dst.host, timeout=600)
            pushed = 0
            t0 = time.perf_counter()
            for s, b in diff:
                have, held = (block_positions(host, s, b) for host in hosts)
                sets, clears = np.setdiff1d(have, held), np.setdiff1d(held, have)
                dst_c.import_view_bits("i", "f", "standard", s,
                                       (sets >> 20, (s << 20) + (sets & 0xFFFFF)),
                                       (clears >> 20, (s << 20) + (clears & 0xFFFFF)))
                pushed += len(sets) + len(clears)
            out["repair_s"] = time.perf_counter() - t0
            if pushed != n_changed:
                raise AssertionError(f"phase 17 (d): pushed {pushed} bits, changed {n_changed}")
            k7 = ds.launches
            want = pc(truth[:, 0])
            for host in (dst.host, h):
                status, body = http(host, "POST", "/index/i/query", b"Count(Bitmap(frame=f, rowID=0))")
                if status != 200 or body["results"] != [want]:
                    raise AssertionError(f"phase 17 (d) Count after the repair on {host}: "
                                         f"{status} {body} != {want}")
                if host == dst.host and ds.launches - k7 != 1:
                    raise AssertionError(f"phase 17 (d): the repaired node's Count launched "
                                         f"delta_scatter {ds.launches - k7} times (want 1)")
            blocks = every_block(InternalClient, hosts, range(N_SLICES))
            unequal = [s for s in range(N_SLICES) if blocks[(h, s)] != blocks[(dst.host, s)]]
            if unequal:
                raise AssertionError(f"phase 17 (d): blocks differ after the repair: {unequal}")
            log(f"phase 17 (d): /fragment/blocks equal on both nodes for all {N_SLICES} fragments "
                f"({out['blocks_s']:.3f} s for 2 x {N_SLICES} requests, {BLOCK_THREADS} in flight; "
                f"{out['blocks_again_s']:.3f} s with the checksums cached); {n_changed} bits set "
                f"and cleared on the source in slices {touched} ({out['writes_s']:.3f} s) made exactly "
                f"their block 0 differ; read through /fragment/block/data on both nodes and {pushed} "
                f"bits pushed through /fragment/import-view in {out['repair_s']:.3f} s; the next "
                f"Count applied them "
                f"with one delta_scatter launch, blocks equal again")
        finally:
            dst.close()

        # (e) restore in place over a resident mirror and a cached batch entry.
        s_dst, s_src = (int(x) for x in rng.choice(N_SLICES, 2, replace=False))
        q = "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))"
        for _ in range(2):
            status, body = http(h, "POST", "/index/i/query", q.encode())
        frag = srv.holder.fragment("i", "f", "standard", s_dst)
        if frag._mirror is None or not srv.executor._batch_cache:
            raise AssertionError("phase 17 (e): no resident mirror or batch entry before the restore")
        path = f"/fragment/data?index=i&frame=f&view=standard&slice={s_dst}"
        status, body = raw_post(h, path, torn_archive(members["f"][s_src]))
        if status != 422:
            raise AssertionError(f"phase 17 (e): a torn archive answered {status} {body[:200]}")
        want_torn = pc(truth[:, 0] & truth[:, 1])
        status, body = http(h, "POST", "/index/i/query", q.encode())
        if status != 200 or body["results"] != [want_torn]:
            raise AssertionError(f"phase 17 (e) after the torn archive: {status} {body} != {want_torn}")
        t0 = time.perf_counter()
        status, body = raw_post(h, path, members["f"][s_src])
        out["restore_in_place_ms"] = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise AssertionError(f"phase 17 (e) restore: {status} {body[:200]}")
        for r, words in archive_bits(members["f"][s_src]).items():
            truth[s_dst, r] = words
        want = pc(truth[:, 0] & truth[:, 1])
        status, body = http(h, "POST", "/index/i/query", q.encode())
        if status != 200 or body["results"] != [want]:
            raise AssertionError(f"phase 17 (e) after the restore: {status} {body} != {want}")
        log(f"phase 17 (e): slice {s_dst} restored in place from slice {s_src}'s archive "
            f"({out['restore_in_place_ms']:.3f} ms) over its resident mirror and a cached batch "
            f"entry: the next Count equals numpy ({want}, was {want_torn}); a torn archive got 422 "
            f"and changed no answer")

        # (f) one slice's CSV export.
        s_exp = int(rng.integers(0, N_SLICES))
        t0 = time.perf_counter()
        status, csv = raw_get(h, f"/export?index=i&frame=f&view=standard&slice={s_exp}",
                              {"Accept": "text/csv"})
        took = time.perf_counter() - t0
        want_csv = csv_oracle(truth[s_exp], s_exp)
        if status != 200 or csv != want_csv:
            raise AssertionError(f"phase 17 (f): /export of slice {s_exp}: {status}, {len(csv)} "
                                 f"bytes, numpy {len(want_csv)}")
        out["export"] = {"slice": s_exp, "bytes": len(csv), "bits": csv.count(b"\n"), "s": took}
        log(f"phase 17 (f): /export of slice {s_exp}: {out['export']['bits']} bits, {len(csv)} bytes of "
            f"CSV in {took:.3f} s ({len(csv) / took / 1e6:.1f} MB/s), equal to numpy's formatting "
            f"byte for byte")
    out["launches"] = {"k1": fp.launches, "k2": te.launches, "k4": sp.launches, "k7": ds.launches}
    log(f"phase 17: launches {out['launches']}")
    return out


# Phase 18: device health and the host fallback.
HEALTH_OPEN_MS = 300.0  # the phase-5 node's quarantine window
HEALTH_THRESHOLD = 3
HEALTH_BSI_SLICES = 64  # the small field q (a cut: the index has 954 slices)
HEALTH_BSI_DEPTH = 8
HEALTH_QUARANTINE_QUERIES = 3


class FallbackWatch:
    """Every device fault classified, every host answer and every
    collective fallback in this process, counted through
    ``health.classify``, the host evaluator's counter and
    ``exec/plan.collective_fallbacks``: a phase that ends with one of
    them moved was served, in part, by the host or the per-member
    partials."""

    def __init__(self):
        from pilosa_tpu_torch.device import health
        from pilosa_tpu_torch.exec import hosteval

        self.faults = self.host = 0
        classify, count = health.classify, hosteval.HostEvaluator._count

        def watched_classify(exc):
            kind = classify(exc)
            self.faults += kind is not None
            return kind

        def watched_count(ev, what, n=1):
            self.host += n
            return count(ev, what, n)

        health.classify = watched_classify
        hosteval.HostEvaluator._count = watched_count
        self.mark = (0, 0, 0)
        self.node_mark: dict[str, int] = {}

    def node_counts(self, srv) -> dict[str, int]:
        counts = srv.holder.stats.snapshot()["counts"]
        return {k: int(v) for k, v in counts.items()
                if k.startswith(("exec.hostEval.queries", "device.launch.retries"))}

    def check(self, phase: str, srv=None) -> None:
        """(g): nothing fell back in ``phase``; with ``srv`` (the phase-5
        node, still open) its counters are unmoved and /debug/health reads
        healthy."""
        now = (self.faults, self.host, self.collective())
        if now != self.mark:
            raise AssertionError(f"phase {phase}: {now[0] - self.mark[0]} device faults "
                                 f"classified, {now[1] - self.mark[1]} host answers, "
                                 f"{now[2] - self.mark[2]} collective fallbacks")
        if srv is None:
            return
        if self.node_counts(srv) != self.node_mark:
            raise AssertionError(f"phase {phase}: the node's fallback counters moved: "
                                 f"{self.node_counts(srv)} != {self.node_mark}")
        status, body = http(srv.host, "GET", "/debug/health")
        dev = body["device"]
        if status != 200 or dev["degraded"] or any(
                p["state"] != "healthy" for p in dev["paths"].values()):
            raise AssertionError(f"phase {phase}: /debug/health {status} {body}")

    @staticmethod
    def collective() -> int:
        """Answers a mesh's per-member partials gave after its collective
        tripped or was quarantined (exec/plan.py), process-wide."""
        from pilosa_tpu_torch.exec import plan

        return plan.collective_fallbacks

    def rebase(self, srv) -> None:
        self.mark = (self.faults, self.host, self.collective())
        self.node_mark = self.node_counts(srv)


def kernel_counts(kernels: dict, br) -> dict[str, int]:
    out = {k: m.launches for k, m in kernels.items()}
    out["k8"] = sum(br.launches.values())
    return out


def counts_delta(before: dict, after: dict) -> dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def health_and_check(kernels: dict, br, convert, srv, truth: np.ndarray, rng) -> dict:
    """Phase 18 on the phase-5 node (``truth`` its frame-f planes): the
    launch breaker and the host fallback, driven by the fault-injection
    layer.  (a) one injected error: the Count is answered by K2 after one
    retry; (b) a fault on every attempt: three Counts walk the card to
    quarantined, each answered from the host (no K2); (c) while
    quarantined, Count, Bitmap, TopN, TopN(src) and a BSI comparison and
    Sum on a small field each equal the oracle with no kernel launched,
    host p50 against
    the card's, SetBits that queue on the host, /debug/health and
    /metrics; (d) the plan cleared and the window past, the next Count is
    the probe: one K2 launch, one K7 applying (c)'s SetBits, healed,
    mirrors staged again; (e) an injected OOM on the scorer: no retry,
    counted; (f) a real ``torch.OutOfMemoryError`` classifies as
    ``oom``, and a kernel's own fault on the card as none."""
    import torch

    from pilosa_tpu_torch.device import health as hm
    from pilosa_tpu_torch.testing import faults

    out: dict = {}
    h, dh = srv.host, srv.device_health
    t_start = time.perf_counter()
    k_start, br_start = kernel_counts(kernels, br), dict(br.launches)
    if (dh.quarantine_threshold, dh.open_s) != (HEALTH_THRESHOLD, HEALTH_OPEN_MS / 1e3):
        raise AssertionError(f"phase 18: the node's breaker is {dh.snapshot()}")
    te, sp, ds = kernels["k2"], kernels["k4"], kernels["k7"]

    def state() -> str:
        return dh.snapshot()["paths"].get("device:0", {}).get("state", "healthy")

    def host_counts() -> dict[str, int]:
        return stat_counts(srv, "device.launch.retries", "device.health.heals",
                           "exec.hostEval.queries[kind:count]", "exec.hostEval.queries[kind:row]",
                           "exec.hostEval.queries[kind:agg]", "exec.hostEval.queries[kind:topn]",
                           "device.health.failures[kind:oom]")

    def ask(pql: str, want, what: str):
        q0 = time.perf_counter()
        status, body = http(h, "POST", "/index/i/query", pql.encode())
        took = (time.perf_counter() - q0) * 1e3
        if status != 200 or body["results"] != [want]:
            raise AssertionError(f"phase 18 {what}: {pql}: {status} {str(body)[:300]} != "
                                 f"{str(want)[:300]}")
        return took

    # The small BSI field q (depth 8) over the first HEALTH_BSI_SLICES slices.
    for path, body in (("/index/i/frame/hq", b'{"options": {"rangeEnabled": true}}'),
                       ("/index/i/frame/hq/field/q",
                        json.dumps({"min": -255, "max": 255}).encode())):
        status, resp = http(h, "POST", path, body)
        if status != 200:
            raise AssertionError(f"phase 18: POST {path}: {status} {resp}")
    q_planes = bsi_planes(rng, HEALTH_BSI_SLICES, HEALTH_BSI_DEPTH)
    load_in_threads(convert, [(srv.holder, "i", "hq", "field_q", {s: q_planes[s]})
                              for s in range(HEALTH_BSI_SLICES)])
    q_oracle = ValueOracle(q_planes, {})

    def pc(x) -> int:
        return int(np.bitwise_count(x).sum())

    count_q = "Count(Intersect(Bitmap(frame=f, rowID=0), Bitmap(frame=f, rowID=1)))"

    def count_want() -> int:
        return pc(truth[:, 0] & truth[:, 1])

    def src_scores():
        return np.bitwise_count(truth & truth[:, :1]).sum(axis=-1, dtype=np.int64)

    def topn_src(n: int) -> tuple[str, list]:
        return (f"TopN(Bitmap(frame=f, rowID=0), frame=f, n={n})",
                topn_oracle(src_scores(), n))

    # Frame g's row 1 (phases 5 and 14 wrote it) from the card, the tree's
    # frame-f part from numpy.
    status, body = http(h, "POST", "/index/i/query", b"Bitmap(frame=g, rowID=1)")
    g_row1 = body["results"][0]["bits"]
    bitmap_q = "Intersect(Bitmap(frame=g, rowID=1), Bitmap(frame=f, rowID=2))"
    bitmap_want = {"attrs": {}, "bits": [
        c for c in g_row1 if (int(truth[c >> 20, 2, (c & 0xFFFFF) >> 5]) >> (c & 31)) & 1]}
    topn_want = topn_oracle(np.bitwise_count(truth).sum(axis=-1, dtype=np.int64), 5)
    classes = [
        ("count", count_q, count_want()),
        ("bitmap", bitmap_q, bitmap_want),
        ("topn", "TopN(frame=f, n=5)", topn_want),
        ("topn_src",) + topn_src(5),
        ("bsi_count", "Count(Range(frame=hq, q > 17))", q_oracle.count(">", 17)),
        ("bsi_sum", "Sum(frame=hq, field=q)", q_oracle.agg("Sum")),
    ]
    # The card's answers first (each batch and prep built: what a probe
    # finds cached), and its p50s.  A ranked cache re-sorts at most every
    # RECALCULATE_INTERVAL_S, so a TopN within that of a write may carry
    # a count from before it, as in the reference: then ask again later.
    from pilosa_tpu_torch.core import cache as cache_mod

    status, body = http(h, "POST", "/index/i/query", classes[2][1].encode())
    if body["results"] != [topn_want]:
        time.sleep(cache_mod.RECALCULATE_INTERVAL_S)
    for name, pql, want in classes:
        ask(pql, want, f"card {name}")
    card_count = [ask(count_q, count_want(), "card count p50") for _ in range(REPS)]
    card_topn = [ask(*topn_src(n), "card topn_src p50") for n in range(6, 6 + REPS)]
    if state() != "healthy" or host_counts()["device.launch.retries"]:
        raise AssertionError(f"phase 18: not healthy before any fault: {dh.snapshot()}")

    # (a) One injected error: one retry, then K2.
    base, k0 = host_counts(), kernel_counts(kernels, br)
    faults.install("device.launch:kind=error,times=1")
    ask(count_q, count_want(), "(a)")
    faults.clear()
    made, c = counts_delta(k0, kernel_counts(kernels, br)), host_counts()
    if (c["device.launch.retries"] - base["device.launch.retries"], made, state()) != (
            1, {"k2": 1}, "healthy"):
        raise AssertionError(f"phase 18 (a): retries {c}, launches {made}, {dh.snapshot()}")
    out["a"] = {"retries": 1, "launches": made, "state": state()}
    log(f"phase 18 (a): device.launch:kind=error,times=1 — Count answered by K2 after one "
        f"retry (launches {made}), path {state()}")

    # (b) Every attempt fails: suspect, suspect, quarantined, all from the host.
    faults.install("device.launch:kind=error")
    states = []
    for i in range(HEALTH_QUARANTINE_QUERIES):
        before, k0 = host_counts(), kernel_counts(kernels, br)
        ask(count_q, count_want(), f"(b) {i}")
        made = counts_delta(k0, kernel_counts(kernels, br))
        rose = (host_counts()["exec.hostEval.queries[kind:count]"]
                - before["exec.hostEval.queries[kind:count]"])
        if made or rose != 1:
            raise AssertionError(f"phase 18 (b) {i}: launches {made}, host answers {rose}")
        states.append(state())
    if states != ["suspect", "suspect", "quarantined"]:
        raise AssertionError(f"phase 18 (b): states {states}")
    out["b"] = {"states": states}
    log(f"phase 18 (b): device.launch:kind=error on every attempt — states {states}, each "
        "answer the oracle's from the host, no kernel launched")

    # (c) Every class while quarantined (the plan stays: a probe past the
    # window fails and re-arms the clock).
    made_by = {}
    host_ms = {}
    # A TopN(src) the card never scored: its prep and scores are new.
    for name, pql, want in classes[:3] + [("topn_src",) + topn_src(3)] + classes[4:]:
        k0 = kernel_counts(kernels, br)
        host_ms[name] = ask(pql, want, f"(c) {name}")
        made_by[name] = counts_delta(k0, kernel_counts(kernels, br))
        if made_by[name]:
            raise AssertionError(f"phase 18 (c) {name}: launches {made_by[name]}")
    host_count = [ask(count_q, count_want(), "host count p50") for _ in range(REPS)]
    k0 = kernel_counts(kernels, br)
    host_topn = [ask(*topn_src(n), "host topn_src p50") for n in range(6 + REPS, 6 + 2 * REPS)]
    made_by["topn_src_p50"] = counts_delta(k0, kernel_counts(kernels, br))
    if made_by["topn_src_p50"]:
        raise AssertionError(f"phase 18 (c) TopN(src) p50: launches {made_by['topn_src_p50']}")
    # SetBits queue on the host: into row 0 where row 1 is set (rows 1-3
    # stay phase 5's, which later phases read).
    def bit(row: int, c: int) -> int:
        return (int(truth[c >> 20, row, (c & 0xFFFFF) >> 5]) >> (c & 31)) & 1

    cols: list[int] = []
    while len(cols) < 4:
        c = int(rng.integers(0, N_SLICES << 20))
        if bit(1, c) and not bit(0, c) and c not in cols:
            cols.append(c)
    k0 = kernel_counts(kernels, br)
    for c in cols:
        status, body = http(h, "POST", "/index/i/query",
                            f"SetBit(frame=f, rowID=0, columnID={c})".encode())
        if status != 200 or body["results"] != [True]:
            raise AssertionError(f"phase 18 (c) SetBit: {status} {body}")
    set_bits(truth, np.zeros(len(cols), dtype=np.int64), np.asarray(cols, dtype=np.int64))
    if counts_delta(k0, kernel_counts(kernels, br)):
        raise AssertionError("phase 18 (c): a SetBit launched a kernel")
    status, body = http(h, "GET", "/debug/health")
    if status != 200 or not body["device"]["degraded"] or \
            body["device"]["paths"]["device:0"]["state"] != "quarantined":
        raise AssertionError(f"phase 18 (c): /debug/health {status} {body}")
    fams = parse_exposition(http_raw(h, "/metrics")[1].decode())
    metrics = http_raw(h, "/metrics")[1].decode()
    if not {"pilosa_device_health_state", "pilosa_device_health_degraded",
            "pilosa_device_watchdogTrips"} <= set(fams) or \
            'pilosa_device_health_state{path="device:0"} 2' not in metrics:
        raise AssertionError("phase 18 (c): /metrics lacks the device-health gauges")
    out["c"] = {"host_ms": host_ms, "launches": made_by, "setbits": len(cols),
                "health": body["device"]}
    out["p50_ms"] = {
        "count_intersect": {"card": statistics.median(card_count),
                            "host": statistics.median(host_count)},
        "topn_src": {"card": statistics.median(card_topn), "host": statistics.median(host_topn)},
    }
    log(f"phase 18 (c): quarantined — every class equal to the oracle from the host; launches "
        f"by class {json.dumps(made_by)}; first host answers ms {json.dumps(host_ms)}; "
        f"p50 of {REPS} at {N_SLICES} "
        f"slices, card against host: {json.dumps(out['p50_ms'])} ({card_line()}); "
        f"{len(cols)} SetBits queued on the host, no launch; /debug/health quarantined, "
        "/metrics carries pilosa_device_health_*")

    # (d) The heal: the next Count after the window is the probe.
    faults.clear()
    time.sleep(HEALTH_OPEN_MS / 1e3 + 0.05)
    job, base, k0 = srv.staging_job, host_counts(), kernel_counts(kernels, br)
    ask(count_q, count_want(), "(d) probe")
    made, c = counts_delta(k0, kernel_counts(kernels, br)), host_counts()
    if (made, state(), c["device.health.heals"] - base["device.health.heals"]) != (
            {"k2": 1, "k7": 1}, "healthy", 1) or srv.staging_job is job \
            or srv.cluster.node_by_host(h).degraded:
        raise AssertionError(f"phase 18 (d): launches {made}, {dh.snapshot()}, counts {c}")
    out["d"] = {"launches": made, "staged": srv.staging_job.snapshot()}
    log(f"phase 18 (d): the probe healed the path — launches {made} (K7 applied the "
        f"{len(cols)} queued SetBits), heals 1, staging again "
        f"{json.dumps(out['d']['staged'])}")

    # (e) An OOM on the scorer: no retry, one failure, the host's scores.
    base, k0 = host_counts(), kernel_counts(kernels, br)
    faults.install("device.launch:kind=oom,path=topn")
    ask(*topn_src(4), "(e)")
    faults.clear()
    made, c = counts_delta(k0, kernel_counts(kernels, br)), host_counts()
    diff = {k: c[k] - base[k] for k in c if c[k] != base[k]}
    if state() != "suspect" or "k4" in made or diff != {
            "device.health.failures[kind:oom]": 1, "exec.hostEval.queries[kind:topn]": 1}:
        raise AssertionError(f"phase 18 (e): {diff}, launches {made}, {dh.snapshot()}")
    ask(count_q, count_want(), "(e) after")
    if state() != "healthy":
        raise AssertionError(f"phase 18 (e): not healthy after a success: {dh.snapshot()}")
    out["e"] = {"counts": diff, "launches": made}
    log(f"phase 18 (e): kind=oom,path=topn — TopN(src) from the host, counts {diff}, no "
        "retry, path suspect, then healthy after the next Count")

    # (f) A real allocation past the card's free memory.
    free, total = torch.cuda.mem_get_info()
    try:
        torch.empty(total + (1 << 30), dtype=torch.uint8, device="cuda")
    except Exception as e:  # noqa: BLE001 — classified below
        kind, err = hm.classify(e), type(e).__name__
    else:
        raise AssertionError("phase 18 (f): an allocation past free memory succeeded")
    torch.cuda.empty_cache()
    if kind != hm.KIND_OOM:
        raise AssertionError(f"phase 18 (f): {err} classified as {kind}")
    # A kernel's own fault leaves the context unusable: never a device
    # fault, so its query fails instead of moving to the host.  Built
    # here, not raised by the card, which would poison the run.
    accel = getattr(torch, "AcceleratorError", RuntimeError)
    sticky = hm.classify(accel("CUDA error: an illegal memory access was encountered"))
    if sticky is not None:
        raise AssertionError(f"phase 18 (f): {accel.__name__} classified as {sticky}")
    ask(count_q, count_want(), "(f) after")
    out["f"] = {"error": err, "kind": kind, "asked_bytes": total + (1 << 30), "free": free}
    log(f"phase 18 (f): torch.empty({total + (1 << 30)} B, the card's memory and 1 GiB) "
        f"raised {err}, classified {kind!r}; an illegal-address {accel.__name__} classified "
        "None; the card answers after it")
    out["launches"] = counts_delta(k_start, kernel_counts(kernels, br))
    out["k8_launches"] = {k: br.launches[k] - br_start[k] for k in br.launches}
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 18: launches {json.dumps(out['launches'])}, K8 {json.dumps(out['k8_launches'])}; "
        f"{out['seconds']:.1f} s")
    return out


# The phase functions of ``main``, by phase number: each one's wall-clock
# seconds go into the run's ``phase seconds`` line.
PHASES = {
    "serve_and_check": "5",
    "coalesce_and_check": "14",
    "observe_and_check": "16",
    "cluster_and_check": "6",
    "bsi_and_check": "7",
    "time_and_check": "8",
    "topn_and_check": "9",
    "backup_and_check": "17",
    "tutorials_and_check": "10",
    "recovery_and_check": "11",
    "residency_and_check": "12",
    "durability_and_check": "13",
    "health_and_check": "18",
    "mesh_and_check": "19",
}


def time_phases(module, seconds: dict) -> None:
    """Wrap each PHASES function of ``module`` (this script, or another
    tree's ``chip_smoke.py`` loaded as a module, whose phases have the
    same names) so that its wall-clock seconds land in ``seconds`` under
    its phase number.  A parent tree is timed the same way as this one:

        python3 -c "import importlib.util as u, sys; import chip_smoke as c; \
            s = u.spec_from_file_location('parent', 'DIR/chip_smoke.py'); \
            m = u.module_from_spec(s); s.loader.exec_module(m); t = {}; \
            c.time_phases(m, t); rc = m.main(); print(t); sys.exit(rc)"
    """
    import functools

    for name, phase in PHASES.items():
        fn = getattr(module, name)

        @functools.wraps(fn)
        def timed(*args, _fn=fn, _phase=phase):
            t0 = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                seconds[_phase] = round(time.perf_counter() - t0, 1)

        setattr(module, name, timed)


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
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import score_planes as sp
    from pilosa_tpu_torch.ops import tree_eval as te
    from pilosa_tpu_torch.ops import stream_sum as ss
    from pilosa_tpu_torch.ops import mesh_topn as mt
    from pilosa_tpu_torch.ops import top_k as tk
    from pilosa_tpu_torch.device import floorprobe
    from pilosa_tpu_torch.obs.stats import ExpvarStatsClient

    card = card_line()
    print(card, flush=True)
    bp.set_local_members([torch.device("cuda", 0)])
    phase_s: dict[str, float] = {}
    time_phases(sys.modules[__name__], phase_s)
    name = torch.cuda.get_device_name(0)
    hbm = hbm_rate(name)
    log(f"phase 1: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"memory rate for the bound {hbm / 1e12:.2f} TB/s")

    t0 = time.perf_counter()
    # The native roaring codec (g++) builds beside the kernels (nvcc); the
    # run asserts it loaded, so no Python fallback hides here.
    from pilosa_tpu_torch import native

    native_build = threading.Thread(target=native.available)
    native_build.start()
    built = _build.build_all()
    native_build.join()
    if not native.available():
        raise AssertionError("phase 2: the native roaring codec did not build or load")
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.3f}s {built}; native roaring "
        f"codec {native.loaded_path()}")

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
    rng23 = np.random.default_rng(SEED + 5)
    k2_err = check_k2(te, it, tplan, rng23)
    k3_err = check_k3(te, it, tplan, bsi, rng23)
    k11_err = check_k11(ss, floorprobe)
    rng9 = np.random.default_rng(SEED + 9)
    k9_err = check_k9(mt, rng9)
    topk_err = check_top_k(tk, rng9)

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
    k23_times = time_k2k3(te, it, tplan, bsi, hbm, np.random.default_rng(SEED + 6))
    k11_times = time_k11(ss, floorprobe, hbm)
    k9_times = time_k9(mt, hbm, rng9)
    topk_times = time_top_k(tk, hbm, rng9)
    # From here on, a device fault classified or a host answer anywhere in
    # the process fails the phase it came in (phase 18 excepted).
    watch = FallbackWatch()
    all_kernels = {"k1": fp, "k2": te, "k3": it, "k4": sp, "k5": ac, "k6": ep, "k7": ds}

    with tempfile.TemporaryDirectory(prefix="pilosa-torch-smoke-") as data_dir:
        # The stream-floor probe (K11) runs once in this process, at this
        # node's open: its main path.
        # A short quarantine window for phase 18: nothing changes while no
        # fault fires.
        srv = Server(data_dir, host="127.0.0.1:0", device="cuda", stats=ExpvarStatsClient(),
                     quarantine_open_ms=HEALTH_OPEN_MS, quarantine_threshold=HEALTH_THRESHOLD)
        ss.launches = 0
        srv.open()
        k11_launches = ss.launches
        if k11_launches != floorprobe.WARMUP_ITERS + floorprobe.TIMED_ITERS:
            raise AssertionError(f"phase 5: the floor probe launched stream_sum {k11_launches} "
                                 f"times at open (want {floorprobe.WARMUP_ITERS} + "
                                 f"{floorprobe.TIMED_ITERS})")
        log(f"phase 5: the node's open probed the stream floor with {k11_launches} stream_sum "
            f"launches: {json.dumps(floorprobe.probe(device='cuda'))}")
        try:
            served = serve_and_check(fp, ds, sp, te, bp, convert, srv, rng)
            watch.check("5", srv)
            planes = served.pop("planes")
            truth = planes.copy()  # with phase 5's SetBit, and phases 14's and 18's writes
            col = served["setbit_col"]
            truth[col >> 20, 0, (col & 0xFFFFF) >> 5] |= np.uint32(1 << (col & 31))
            coalesced = coalesce_and_check(fp, te, it, srv, truth,
                                           np.random.default_rng(SEED + 14))
            watch.check("14", srv)
            observed = observe_and_check(srv, {"k2": te, "k3": it, "k4": sp, "k5": ac},
                                         coalesced.pop("queries"), hbm,
                                         np.random.default_rng(SEED + 16))
            watch.check("16", srv)
            meshed = mesh_and_check({"k2": te, "k4": sp, "k9": mt, "top_k": tk}, Server,
                                    ExpvarStatsClient, srv, data_dir, planes, truth, watch)
            watch.check("19", srv)
            healed = health_and_check(all_kernels, br, convert, srv, truth,
                                      np.random.default_rng(SEED + 18))
            del truth
            watch.rebase(srv)
            watch.check("18", srv)
            clustered = cluster_and_check(fp, ds, br, sp, te, scatter, convert, Server,
                                          InternalClient, planes, rng)
            watch.check("6", srv)
            valued = bsi_and_check(fp, ds, br, te, it, scatter, convert, InternalClient, srv,
                                   planes, rng)
            watch.check("7", srv)
            timed = time_and_check(fp, te, InternalClient, srv, planes, rng)
            watch.check("8", srv)
            ranked = topn_and_check(sp, fp, convert, srv, planes)
            watch.check("9", srv)
            backed = backup_and_check(fp, te, ds, sp, Server, InternalClient, srv,
                                      np.random.default_rng(SEED + 17))
            watch.check("17", srv)
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
            tutorials = tutorials_and_check(ac, ep, fp, sp, te, bp, InternalClient, srv,
                                            np.random.default_rng(SEED + 10))
        finally:
            srv.close()
        watch.check("10")
        recovery_and_check(Server, ds)
        watch.check("11")
        # Phase 12 reopens phase 10's directory under a budget, every
        # other node closed.
        del srv
        gc.collect()
        resident = residency_and_check(Server, data_dir, tutorials,
                                       {"k1": fp, "k2": te, "k4": sp, "k5": ac, "k6": ep})
        watch.check("12")
    durable = durability_and_check(Server, {"k2": te})
    watch.check("13")
    log(f"phase seconds (native roaring codec loaded): {json.dumps(phase_s)}")

    k7 = k7_times[K7_SHAPES[1]]  # every slice's queue in one launch, as phase 7 flushes
    kernels = [
        {
            "name": fp.NAME,
            "route": "cuda",
            "source": fp.SOURCE,
            "replaces": fp.REPLACES,
            "launches": served["launches"] + coalesced["launches"] + clustered["launches"]
            + valued["launches"]["k1"] + timed["launches"] + ranked["launches"]
            + tutorials["totals"]["k1"] + resident["launches"]["k1"] + backed["launches"]["k1"],
            "launches_by_phase": {"5": served["launches"], "14": coalesced["launches"],
                                  "6": clustered["launches"],
                                  "7": valued["launches"]["k1"], "8": timed["launches"],
                                  "9": ranked["launches"], "10": tutorials["totals"]["k1"],
                                  "12": resident["launches"]["k1"],
                                  "17": backed["launches"]["k1"]},
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
            "launches": served["k7_launches"] + clustered["k7_launches"] + valued["k7_launches"]
            + backed["launches"]["k7"] + healed["launches"].get("k7", 0),
            "launches_by_phase": {"5": served["k7_launches"], "6": clustered["k7_launches"],
                                  "7": valued["k7_launches"], "17": backed["launches"]["k7"],
                                  "18": healed["launches"].get("k7", 0)},
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
            "launches": clustered["k8_launches"][kernel] + valued["launches"][kernel]
            + healed["k8_launches"][kernel],
            "launches_by_phase": {"6": clustered["k8_launches"][kernel],
                                  "7": valued["launches"][kernel],
                                  "18": healed["k8_launches"][kernel]},
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
        + tutorials["totals"]["k4"] + resident["launches"]["k4"] + backed["launches"]["k4"]
        + healed["launches"].get("k4", 0),
        "launches_by_phase": {"5": served["k4_launches"], "6": clustered["k4_launches"],
                              "9": ranked["k4_launches"], "10": tutorials["totals"]["k4"],
                              "12": resident["launches"]["k4"],
                              "17": backed["launches"]["k4"],
                              "18": healed["launches"].get("k4", 0)},
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
        "upload_bound_ms": k5_times["upload_bound_ms"],
        "library_ms": None,
        "checked": k5_err == 0.0,
        "shape": [N_SLICES, K5_ANCHOR, "dense", K5_SPARSE, K5_RUNS],
    })
    k2_by_phase = {"5": served["k2_launches"], "14": coalesced["k2_launches"],
                   "6": clustered["k2_launches"], "7": valued["k2_launches"],
                   "8": timed["k2_launches"],
                   "10": tutorials["totals"]["k2"], "12": resident["launches"]["k2"],
                   "13": durable["launches"]["k2"], "17": backed["launches"]["k2"],
                   "18": healed["launches"].get("k2", 0)}
    for kernel, err, times, by_phase, shape in (
        (te, k2_err, k23_times["tree_eval_count"], k2_by_phase, [N_SLICES, 2, "count"]),
        (it, k3_err, k23_times["interp_count"],
         {"14": coalesced["k3_launches"], "7": valued["k3_launches"]},
         [N_SLICES, 8, "count", len(storm_exprs()), "programs"]),
    ):
        entry = {
            "name": kernel.NAME,
            "route": "cuda",
            "source": kernel.SOURCE,
            "replaces": kernel.REPLACES,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": err,
            "checked": err == 0.0,
            "shape": shape,
            **{k: times[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        }
        if kernel is te:
            entry["total_reduce"] = k23_times["tree_eval_total"]
            entry["row_reduce"] = k23_times["tree_eval_row"]
            entry["row_reduce_16"] = k23_times["tree_eval_row_16"]
        else:
            entry["shapes"] = k23_times["interp_shapes"]
        kernels.append(entry)
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
    kernels.append({
        "name": ss.NAME,
        "route": "cuda",
        "source": ss.SOURCE,
        "replaces": ss.REPLACES,
        "launches": k11_launches,
        "launches_by_phase": {"5": k11_launches},
        "max_abs_err": k11_err,
        "checked": k11_err == 0.0,
        "shape": [k11_times["probe_bytes"] // 4],
        **{k: k11_times[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "probe_gbps", "jax_size_gbps")},
    })
    k9 = k9_times["total"]  # the reduce the mesh's TopN and query_step launch
    kernels.append({
        "name": mt.NAME,
        "route": "cuda",
        "source": mt.SOURCE,
        "replaces": mt.REPLACES,
        "launches": meshed["launches"]["k9"],
        "launches_by_phase": {"19": meshed["launches"]["k9"]},
        "max_abs_err": k9_err,
        "checked": k9_err == 0.0,
        "shape": [N_SLICES, ROWS, 32768, "total"],
        "partials": k9_times["partials"],
        **{k: k9[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
    })
    topk = topk_times[f"{ROWS}x4"]  # query_step's shape
    kernels.append({
        "name": tk.NAME,
        "route": "cuda",
        "source": tk.SOURCE,
        "replaces": tk.REPLACES,
        "launches": meshed["launches"]["top_k"],
        "launches_by_phase": {"19": meshed["launches"]["top_k"]},
        "max_abs_err": topk_err,
        "checked": topk_err == 0.0,
        "shape": [ROWS, 4],
        f"at_{N_SLICES * ROWS}x10": topk_times[f"{N_SLICES * ROWS}x10"],
        **{k: topk[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
    })
    k2_entry = next(k for k in kernels if k["name"] == te.NAME)
    k2_entry["launches"] += meshed["launches"]["k2"]
    k2_entry["launches_by_phase"]["19"] = meshed["launches"]["k2"]
    k4_entry = next(k for k in kernels if k["name"] == sp.NAME)
    k4_entry["launches"] += meshed["launches"]["k4"]
    k4_entry["launches_by_phase"]["19"] = meshed["launches"]["k4"]
    log(f"phase 19 (summary): {json.dumps(meshed)}")
    log(f"phase 16 (summary): {json.dumps({k: v for k, v in observed.items() if k != 'sites'})}; "
        f"cluster trace {json.dumps(clustered['trace'])}")
    log(f"phase 17 (summary): {json.dumps(backed)}")
    log(f"phase 18 (summary): {json.dumps(healed)}")
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
