"""Cross-query coalescing: one launch for many concurrent queries.

The counterpart of ``pilosa_tpu/exec/coalesce.py``.  Every Count or
Bitmap over a bitmap tree hands its cached batch — a row-address table
(``ops/tree_eval.RowTable``) over the node's slices — to one dispatcher
thread, and queries that arrive while a launch is in flight ride the next
one together.

Scheduling is continuous, not windowed: a lone query on an idle card
launches at once (``max_wait_us`` is only an optional accumulation
backstop, default 0); while a launch runs on the dispatcher thread, new
arrivals queue per compile key (tree, reduce, leaf count, row width,
device) and the next drain takes them all.  Under serial load every query
gets its own launch; under concurrent load occupancy rises with the
arrival rate.

Batch construction, per drained key:

* **Identity dedup.**  Waiters whose tables are the same cached entry's
  (``RowTable.ident``) share one segment, and a drain of one segment
  launches on that table as it is: N queries, one launch, no copies.
* **Concatenation.**  Distinct tables of one compile key concatenate
  along the slice axis — a table concat, no row moves — into one K2
  launch of the per-slice reduce ("count" partials, int32-exact, or
  "row"); each waiter takes its own positions.  The kernels take the
  slice count at run time, so nothing is padded (the JAX package padded
  to powers of two for XLA's compile cache; ``pad_rows`` stays 0).
  "total" reduces to one sum per table, so it never concatenates.
* **Program-key fusion.**  With ``fuse`` on, a drain also pulls every
  other queue of the same reduce and row width, lowers the distinct trees
  into one opcode table (``plan.lower_expr``) and runs them all in ONE
  interpreter launch (K3) over the union leaf set.  Union-leaf sharing is
  "same address, same register": columns whose row addresses are equal
  (``leaf_keys``) are one register, so each distinct row streams once and
  the emitter's value numbering dedups shared subtrees across queries.  A
  tree that cannot lower (the op budget) falls back to its own launch;
  fused results equal the per-tree ones byte for byte.
* **Shared fetches.**  ``submit_fetch`` batches concurrent blocking
  device-to-host copies (the folded TopN's scores) into one stream
  synchronisation per drain.

The waiter keeps its pin lease of the residency pool open until its
future resolves (``Executor._coalesce_eval``), so every mirror a table
names stays pinned through the launch; the table itself holds the
tensors whose rows it names.  ``snapshot()`` carries the scheduler's
counters; a stats client gets the JAX package's ``exec.coalesce.*`` and
``exec.interp.*`` counts, and every launch records into the launch
telemetry (``obs/perf.py``) as ``total``, ``coalesce``, ``interp`` or
``fetch``, with the trace id its first waiter had at submit time (the
dispatcher thread runs outside the queries' contexts).  The JAX
scheduler's health watchdog and sharded-batch rules are not ported (one
card, no mesh).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.obs import perf as perf_mod
from pilosa_tpu_torch.obs.stats import NopStatsClient
from pilosa_tpu_torch.ops.bitplane import WORDS_PER_SLICE
from pilosa_tpu_torch.ops.tree_eval import RowTable

DEFAULT_MAX_BATCH = 64
DEFAULT_MAX_WAIT_US = 0
# Most distinct programs one fused interpreter launch may carry; < 2
# disables fusion.
DEFAULT_FUSE_MAX_PROGRAMS = 16
# Leaf budget of one fused launch: segment sets past it split into further
# launches (64 leaves x 128 KiB = 8 MiB a slice read per pass).
MAX_FUSE_LEAVES = 64
# Reduces the interpreter evaluates.
_FUSABLE_REDUCES = frozenset({"count", "row", "total"})
# Queue key of the shared device-to-host fetches (submit_fetch).
_FETCH_KEY = ("__fetch__",)
# Slice budget of one concatenated launch: segments past it split into
# further launches.
MAX_CONCAT_ROWS = 4096
# Backstop bound on a waiter's wait: a wedged launch surfaces as a failed
# query, not a hung request thread.  A waiter that gives up detaches; the
# shared launch still serves the others.
RESULT_TIMEOUT_S = 600.0


class CoalesceClosed(RuntimeError):
    """Raised by submit() after close(); callers launch directly."""


def consume_abandoned(stats=None):
    """Done-callback for a future whose waiter detached: retrieves the
    launch's eventual error, so that it is counted (``stats.count``, when
    given) instead of logged at garbage collection as never retrieved."""

    def _cb(fut):
        try:
            exc = fut.exception()
        except Exception:  # noqa: BLE001 — cancelled futures
            return
        if exc is not None and stats is not None:
            stats.count("exec.coalesce.abandonedErrors")

    return _cb


@dataclass
class _Item:
    batch: object
    future: Future
    # One per table column: equal keys <=> the same rows (the same
    # addresses).  None: no identities known (columns stay unique).
    leaf_keys: "tuple | None" = None
    # The submitting query's trace id (the launch telemetry's slowest-
    # launch attribution).
    trace_id: str = ""


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class CoalesceScheduler:
    """Per-compile-key queues + one dispatcher thread.

    ``submit(expr, reduce, table)`` returns a Future resolving to
    ``(result, info)``: this table's part of the launch — host int32
    ``[n]`` partials for "count", the int32 ``[n, 32768]`` result rows on
    the table's device for "row", the host total (int) for "total" — and
    the launch's batch stats."""

    def __init__(
        self,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_wait_us: int = DEFAULT_MAX_WAIT_US,
        fuse: bool = True,
        fuse_max_programs: int = DEFAULT_FUSE_MAX_PROGRAMS,
        stats=None,
    ):
        self.stats = stats or NopStatsClient()
        self.max_batch = max(1, int(max_batch))
        self.max_wait_us = max(0, int(max_wait_us))
        self.fuse = bool(fuse) and int(fuse_max_programs) >= 2
        self.fuse_max_programs = max(1, int(fuse_max_programs))
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # key -> deque[_Item]; FIFO across keys (the key whose first item
        # arrived earliest drains first).
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()
        self._closed = False
        self._launches = 0
        self._queries = 0
        self._pad_rows = 0
        self._launched_rows = 0
        self._max_occupancy = 0
        self._fused_launches = 0
        self._fused_queries = 0
        self._fused_programs = 0
        self._fused_ops = 0
        self._fuse_dedup_hits = 0
        self._fuse_shared_leaves = 0
        self._fuse_fallbacks = 0
        self._fetch_launches = 0
        self._fetch_arrays = 0
        self._thread = threading.Thread(target=self._loop, daemon=True, name="exec-coalesce")
        self._thread.start()

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------

    def submit(self, expr: tuple, reduce: str, batch: RowTable, leaf_keys=None) -> Future:
        """Enqueue one row table for a coalesced launch of ``expr`` with
        ``reduce``; ``leaf_keys`` (optional) are per-column row identities
        for union-leaf sharing in fused launches."""
        key = (expr, reduce, tuple(batch.shape[1:]), str(batch.device))
        if leaf_keys is not None and len(leaf_keys) != batch.shape[1]:
            leaf_keys = None
        item = _Item(batch=batch, future=Future(), leaf_keys=leaf_keys,
                     trace_id=perf_mod.current_trace_id())
        self._enqueue(key, item)
        return item.future

    def submit_fetch(self, arrays) -> Future:
        """Enqueue a device-to-host fetch of ``arrays`` (tensors); resolves
        to ``(host numpy arrays, info)``.  Every fetch pending at a drain
        shares one stream synchronisation."""
        item = _Item(batch=list(arrays), future=Future(), trace_id=perf_mod.current_trace_id())
        self._enqueue(_FETCH_KEY, item)
        return item.future

    def _enqueue(self, key: tuple, item: _Item) -> None:
        with self._cv:
            if self._closed:
                raise CoalesceClosed("coalescer closed")
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
            q.append(item)
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            pending = [it for q in self._queues.values() for it in q]
            self._queues.clear()
            self._cv.notify_all()
        for it in pending:
            if not it.future.done():
                it.future.set_exception(CoalesceClosed("coalescer closed"))
        self._thread.join(timeout=10)

    def snapshot(self) -> dict:
        """Counters for the smoke run and tests (the JAX keys)."""
        with self._mu:
            launches = self._launches
            queries = self._queries
            fused_launches = self._fused_launches
            return {
                "launches": launches,
                "queries": queries,
                "pad_rows": self._pad_rows,
                "launched_rows": self._launched_rows,
                "max_occupancy": self._max_occupancy,
                "mean_occupancy": round(queries / launches, 3) if launches else None,
                "fused_launches": fused_launches,
                "fused_queries": self._fused_queries,
                "fused_programs": self._fused_programs,
                "fused_ops": self._fused_ops,
                "fuse_dedup_hits": self._fuse_dedup_hits,
                "fuse_shared_leaves": self._fuse_shared_leaves,
                "fuse_fallbacks": self._fuse_fallbacks,
                "mean_fused_per_launch": (
                    round(self._fused_queries / fused_launches, 3) if fused_launches else None
                ),
                "fetch_launches": self._fetch_launches,
                "fetch_arrays": self._fetch_arrays,
            }

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------

    def _drain_locked(self, key, items: list) -> None:
        q = self._queues.get(key)
        while q and len(items) < self.max_batch:
            items.append(q.popleft())
        if q is None:
            return
        if not q:
            del self._queues[key]
        else:
            # max_batch left items behind: rotate the key behind the others
            # so one hot query shape cannot starve the rest.
            self._queues.move_to_end(key)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not self._queues:
                    self._cv.wait()
                if self._closed:
                    return
                key = next(iter(self._queues))
                items: list = []
                self._drain_locked(key, items)
            self._serve(key, items)
            # The drained items hold their tables, and the tables every
            # mirror they name: none may stay alive (an evicted mirror
            # unfreed) while this thread waits for work.
            del items

    def _serve(self, key, items: list) -> None:
        """One drain: linger for company when asked, pull the fusable
        queues, launch; a launch error crosses every drained future."""
        if self.max_wait_us and len(items) < self.max_batch:
            # Optional backstop: linger at most max_wait_us for same-key
            # company.  0 (the default) launches at once — the launch in
            # flight is the only accumulation window.
            deadline = time.monotonic() + self.max_wait_us / 1e6
            with self._cv:
                while len(items) < self.max_batch and not self._closed:
                    if key in self._queues:
                        self._drain_locked(key, items)
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
        # Program-key tier: a fusable drain also pulls every other queue of
        # its program key — the mixed batch the interpreter runs.
        extra: list = []
        fk = self._fuse_key(key)
        if fk is not None:
            with self._cv:
                for k2 in list(self._queues):
                    if 1 + len(extra) >= self.fuse_max_programs:
                        break
                    if len(items) + sum(len(its) for _, its in extra) >= self.max_batch:
                        break
                    if k2 == key or self._fuse_key(k2) != fk:
                        continue
                    its: list = []
                    self._drain_locked(k2, its)
                    if its:
                        extra.append((k2, its))
        try:
            # The launch runs here, on the dispatcher thread: while it is in
            # flight new arrivals queue, and the next drain takes them.
            self._launch(key, items, extra)
        except BaseException as e:  # noqa: BLE001 — crosses the futures
            exc = e if isinstance(e, Exception) else RuntimeError(repr(e))
            for it in items + [it for _, its in extra for it in its]:
                if not it.future.done():
                    it.future.set_exception(exc)

    def _fuse_key(self, key) -> tuple | None:
        """The program-key tier's grouping token (reduce, row width,
        device); None = not fusable (fusion off, the fetch lane)."""
        if not self.fuse or key == _FETCH_KEY:
            return None
        _expr, reduce, tail, device = key
        if reduce not in _FUSABLE_REDUCES:
            return None
        return (reduce, tail[-1], device)

    def _launch(self, key, items: list, extra=()) -> None:
        if key == _FETCH_KEY:
            self._launch_fetch(items)
            return
        _expr, reduce, _tail, _device = key
        if extra:
            self._launch_fused(reduce, [(key, items)] + list(extra))
            return
        if reduce == "total" and self.fuse and len({it.batch.ident for it in items}) > 1:
            # Same-key Counts over distinct tables cannot concatenate under
            # "total" (each launch sums to one scalar): the interpreter runs
            # them as distinct programs in one pass instead.
            self._launch_fused(reduce, [(key, items)])
            return
        self._fallback_launch(key, items)

    def _fallback_launch(self, key, items: list) -> None:
        """The per-compile-key launch fusion falls back to: one K2 "total"
        launch per distinct table, else the slice-axis concat."""
        expr, reduce, _tail, _device = key
        if reduce == "total":
            groups: "OrderedDict[object, list]" = OrderedDict()
            for it in items:
                groups.setdefault(it.batch.ident, []).append(it)
            for grp in groups.values():
                self._launch_total(expr, grp)
            return
        self._launch_concat(expr, reduce, items)

    def _count(self, n_queries: int, rows: int) -> int:
        with self._mu:
            self._launches += 1
            self._queries += n_queries
            self._launched_rows += rows
            self._max_occupancy = max(self._max_occupancy, n_queries)
            n = self._launches
        self.stats.count("exec.coalesce.launches")
        self.stats.count("exec.coalesce.coalescedQueries", n_queries)
        self.stats.histogram("exec.coalesce.batchOccupancy", float(n_queries))
        return n

    @staticmethod
    def _record(site: str, reduce: str, items: list, rows: int, leaves: int,
                t0: float, t_disp: float, t1: float) -> None:
        """Launch telemetry: ``rows`` slices x ``leaves`` rows of plane
        bytes; ``t1`` is ``t0`` where the result stays on the card (the
        launch's time is not observed without a synchronize)."""
        if perf_mod.enabled():
            perf_mod.record_launch(
                site,
                reduce=reduce,
                queries=len(items),
                rows=rows,
                n_bytes=perf_mod.plane_bytes(rows, leaves * WORDS_PER_SLICE),
                dispatch_ms=(t_disp - t0) * 1e3,
                total_ms=(t1 - t0) * 1e3,
                trace_id=items[0].trace_id if items else "",
            )

    def _launch_total(self, expr, items: list) -> None:
        """One identity-deduped table through K2's "total" reduce: every
        waiter receives the same int."""
        table = items[0].batch
        t0 = time.monotonic()
        out = plan.tree_eval(expr, "total", table)
        t_disp = time.monotonic()
        res = int(_to_host(out)[0])
        t1 = time.monotonic()
        launch_ms = (t1 - t0) * 1e3
        rows = table.shape[0]
        self._record("total", "total", items, rows, table.shape[1], t0, t_disp, t1)
        info = {
            "launch": self._count(len(items), rows),
            "total": True,
            "batch_queries": len(items),
            "batch_segments": 1,
            "batch_rows": rows,
            "pad_rows": 0,
            "launch_ms": round(launch_ms, 3),
        }
        for it in items:
            it.future.set_result((res, info))

    def _launch_concat(self, expr, reduce, items: list) -> None:
        # Identity dedup: one segment per distinct table.
        segs: list = []
        seg_of: dict = {}
        seg_items: list[list] = []
        for it in items:
            i = seg_of.get(it.batch.ident)
            if i is None:
                i = seg_of[it.batch.ident] = len(segs)
                segs.append(it.batch)
                seg_items.append([])
            seg_items[i].append(it)
        # Greedy slice-budget chunks over the distinct segments.
        lo = 0
        while lo < len(segs):
            hi = lo + 1
            rows = segs[lo].shape[0]
            while hi < len(segs) and rows + segs[hi].shape[0] <= MAX_CONCAT_ROWS:
                rows += segs[hi].shape[0]
                hi += 1
            self._launch_one(expr, reduce, segs[lo:hi],
                             [it for sub in seg_items[lo:hi] for it in sub], seg_items[lo:hi])
            lo = hi

    def _launch_one(self, expr, reduce, segs, items, seg_items) -> None:
        n_rows = [s.shape[0] for s in segs]
        table = segs[0] if len(segs) == 1 else RowTable.concat_slices(segs)
        t0 = time.monotonic()
        out = plan.tree_eval(expr, reduce, table)
        t_disp = time.monotonic()
        res = _to_host(out) if reduce == "count" else out
        t1 = time.monotonic()
        launch_ms = (t1 - t0) * 1e3
        total = sum(n_rows)
        self._record("coalesce", reduce, items, total, table.shape[1], t0, t_disp,
                     t1 if reduce == "count" else t0)
        info = {
            "launch": self._count(len(items), total),
            "batch_queries": len(items),
            "batch_segments": len(segs),
            "batch_rows": total,
            "pad_rows": 0,
            "launch_ms": round(launch_ms, 3),
        }
        start = 0
        for rows, sub in zip(n_rows, seg_items):
            seg_res = res[start : start + rows]
            start += rows
            for it in sub:
                it.future.set_result((seg_res, info))

    # ------------------------------------------------------------------
    # multi-query fusion (interpreter launches)
    # ------------------------------------------------------------------

    def _launch_fused(self, reduce, buckets: list) -> None:
        """Launch a mixed drain of per-compile-key buckets (``[(key,
        items), ...]``, one program key) as interpreter passes.  Queries
        fused into one pass share the slice count (results go back slice
        for slice), so items group by it; a group with fewer than two
        distinct programs, or whose trees refuse to lower, falls back to
        the per-compile-key launch, never fails."""
        by_n: "OrderedDict[int, list]" = OrderedDict()
        for key, its in buckets:
            for it in its:
                by_n.setdefault(it.batch.shape[0], []).append((key, it))
        for n_rows, pairs in by_n.items():
            self._launch_interp(reduce, n_rows, pairs)

    def _fallback_by_key(self, reduce, fallback: "OrderedDict") -> None:
        for key, its in fallback.items():
            with self._mu:
                self._fuse_fallbacks += len(its)
            self.stats.count("exec.interp.fallbacks", len(its))
            self._fallback_launch(key, its)

    def _launch_interp(self, reduce, n_rows: int, pairs: list) -> None:
        # Segments: the distinct tables (identity dedup).
        segs: list = []
        seg_keys: list = []
        seg_of: dict = {}
        for _key, it in pairs:
            if it.batch.ident not in seg_of:
                seg_of[it.batch.ident] = len(segs)
                lk = it.leaf_keys
                if lk is None:
                    # No identities: every column is unique to its segment.
                    lk = tuple(("anon", it.batch.ident, j) for j in range(it.batch.shape[1]))
                seg_keys.append(lk)
                segs.append(it.batch)
        l_tot = sum(b.shape[1] for b in segs)
        if l_tot > MAX_FUSE_LEAVES and len(segs) > 1:
            # Leaf budget passed: greedy segment chunks, each its own fused
            # launch (a lone oversized segment proceeds whole).
            chunk_of: dict[int, int] = {}
            chunk = rows = 0
            for si, b in enumerate(segs):
                ln = b.shape[1]
                if rows and rows + ln > MAX_FUSE_LEAVES:
                    chunk += 1
                    rows = 0
                chunk_of[si] = chunk
                rows += ln
            parts: dict[int, list] = {}
            for key, it in pairs:
                parts.setdefault(chunk_of[seg_of[it.batch.ident]], []).append((key, it))
            for sub in parts.values():
                self._launch_interp(reduce, n_rows, sub)
            return

        # Union leaf layout: the first occurrence of each identity claims a
        # register; later references — within one query or across queries —
        # collapse onto it, so each distinct row streams once.
        union: "OrderedDict[tuple, int]" = OrderedDict()
        src_of: list[tuple[int, int]] = []  # union register -> (seg, col)
        for si, lk in enumerate(seg_keys):
            for j, k in enumerate(lk):
                if k not in union:
                    union[k] = len(src_of)
                    src_of.append((si, j))
        l_union = len(src_of)
        leaf_maps = [[union[k] for k in lk] for lk in seg_keys]

        # Lower each distinct (tree, leaf layout) once: identical queries
        # share a program, and with shared columns collapsed the emitter's
        # value numbering dedups shared subtrees across queries.  A tree
        # that cannot lower rolls the table back and falls back by key.
        em = plan.FuseEmitter(l_union, plan.FUSE_MAX_OPS)
        out_of: dict[tuple, int] = {}
        failed: set = set()
        fused: list = []  # (item, out register)
        fallback: "OrderedDict[tuple, list]" = OrderedDict()
        for key, it in pairs:
            lmap = leaf_maps[seg_of[it.batch.ident]]
            pk = (key[0], tuple(lmap))
            reg = out_of.get(pk)
            if reg is None and pk not in failed:
                cp = em.checkpoint()
                try:
                    reg = out_of[pk] = plan.lower_expr(key[0], lmap, em)
                except plan.FuseUnsupported:
                    em.rollback(cp)
                    failed.add(pk)
            if reg is None:
                fallback.setdefault(key, []).append(it)
            else:
                fused.append((key, it, reg))

        # Fewer than two distinct programs = nothing to fuse: the concat
        # path handles identity dedup with no copies.
        if fused and len(out_of) < 2:
            for key, it, _reg in fused:
                fallback.setdefault(key, []).append(it)
            fused = []

        if fused:
            # The combined table: each segment contributes the union columns
            # it provided first.
            cols_of: dict[int, list[int]] = {}
            for si, j in src_of:
                cols_of.setdefault(si, []).append(j)
            order = sorted(cols_of)
            combined = RowTable.concat_leaves([segs[si] for si in order],
                                              [cols_of[si] for si in order])
            prog = em.table()
            out_regs = list(dict.fromkeys(reg for _k, _it, reg in fused))
            pos_of_reg = {r: i for i, r in enumerate(out_regs)}
            t0 = time.monotonic()
            out = plan.interp_exec(reduce, combined, prog, np.asarray(out_regs, dtype=np.int32))
            t_disp = time.monotonic()
            res = out if reduce == "row" else _to_host(out)
            t1 = time.monotonic()
            launch_ms = (t1 - t0) * 1e3
            # Logical bytes: the deduped union leaf set, streamed once.
            self._record("interp", reduce, [it for _k, it, _r in fused], n_rows, l_union,
                         t0, t_disp, t0 if reduce == "row" else t1)
            launch_n = self._count(len(fused), n_rows)
            with self._mu:
                self._fused_launches += 1
                self._fused_queries += len(fused)
                self._fused_programs += len(out_of)
                self._fused_ops += len(prog)
                self._fuse_dedup_hits += em.dedup_hits
                self._fuse_shared_leaves += l_tot - l_union
            self.stats.count("exec.interp.launches")
            self.stats.count("exec.interp.fusedQueries", len(fused))
            self.stats.histogram("exec.interp.opsPerLaunch", float(len(prog)))
            if l_tot > l_union:
                self.stats.count("exec.interp.sharedLeaves", l_tot - l_union)
            info = {
                "launch": launch_n,
                "fused": True,
                "batch_queries": len(fused),
                "programs": len(out_of),
                "ops": len(prog),
                "dedup_hits": em.dedup_hits,
                "batch_rows": n_rows,
                "leaf_rows": l_union,
                "shared_leaves": l_tot - l_union,
                "pad_leaves": 0,
                "launch_ms": round(launch_ms, 3),
            }
            for _key, it, reg in fused:
                pos = pos_of_reg[reg]
                part = int(res[pos]) if reduce == "total" else res[:, pos]
                it.future.set_result((part, info))

        self._fallback_by_key(reduce, fallback)

    def _launch_fetch(self, items: list) -> None:
        """Drain pending fetches with one synchronisation: every copy is
        enqueued on the stream, then the stream is waited for once."""
        arrays: list = []
        spans: list[tuple[int, int]] = []
        for it in items:
            spans.append((len(arrays), len(it.batch)))
            arrays.extend(it.batch)
        t0 = time.monotonic()
        outs = [a.to("cpu", non_blocking=True) if a.is_cuda else a for a in arrays]
        for dev in {a.device for a in arrays if a.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        fetched = [o.numpy() for o in outs]
        fetch_ms = (time.monotonic() - t0) * 1e3
        if perf_mod.enabled():
            perf_mod.record_launch(
                "fetch", reduce="fetch", queries=len(items),
                n_bytes=sum(int(a.nbytes) for a in fetched), total_ms=fetch_ms,
                trace_id=items[0].trace_id,
            )
        with self._mu:
            self._fetch_launches += 1
            self._fetch_arrays += len(arrays)
            n = self._fetch_launches
        self.stats.count("exec.interp.fetchLaunches")
        self.stats.count("exec.interp.fetchedArrays", len(arrays))
        info = {
            "fetch_launch": n,
            "fetch_items": len(items),
            "fetch_arrays": len(arrays),
            "fetch_ms": round(fetch_ms, 3),
        }
        for it, (lo, cnt) in zip(items, spans):
            it.future.set_result((fetched[lo : lo + cnt], info))
