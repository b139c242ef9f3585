"""The standing-query delta engine: write listeners in, updates out.

The counterpart of ``pilosa_tpu/subscribe/engine.py``: the same modes,
fences, counters and update documents.  Data flow::

    fragment._notify_write            (under the fragment lock)
        └─ SubscriptionManager.on_write   — match the (index, frame,
           row) write index, fold the delta into the pending map
           (exact single-leaf counts adjust by ±n; everything else
           marks the touched slice dirty), and wake the notifier.
           Leaf locks only, like DeltaLog.record.

    notifier thread (one per manager)
        └─ coalesce a batch → acquire the "subscribe" admission lane
           (when an admission controller is given) → re-evaluate each
           touched subscription
           (±adjust / dirty-slice K2 / full re-run) → publish
           versioned updates to per-subscription queues → wake SSE
           and long-poll waiters.

Incremental strategy per (subscription, batch):

* ``adjust`` — the tree is a single standard ``Bitmap`` leaf and every
  contributing write was exact (point writes report only bits that
  actually changed): the count moves by exactly ±n, no evaluation.
* ``slice`` — compound tree, bounded dirt: re-evaluate only the dirty
  slices, one K2 "count" launch over them (``Executor.count_slices``:
  the pull's kernel, so byte-identical to a pull), counted under
  ``exec.subscribe.evals`` ``mode:slice``.  A single-leaf tree re-bases
  a slice from the fragment's row count, which every write keeps
  exact.  The JAX engine evaluates these slices with numpy over the
  host planes; the port keeps that work on the card, and only a
  quarantined card's host evaluator (``exec.hostEval.queries``)
  answers from the host.
* ``full`` — the slice's delta budget overflowed, a TopN ranking may
  have shifted, the cluster is multi-node (remote slices feed no local
  listener), or the topology moved: re-run the whole query through the
  executor — the same pull path clients use, on the card's kernels.

Incremental bases are race-free against in-flight writes: a write
commits to the plane and the row's count, bumps the fragment's
``_version``, and notifies listeners inside ONE fragment-lock critical
section, and the count read that (re)bases a slice captures
``(_serial, _version)`` under the same lock.  So an adj delta stamped
at or below the base version is provably already inside the base
(dropped, never double-applied), one stamped above it is provably not
(applied), and a range straddling the base — or a recreated fragment's
incomparable serial — degrades to a dirty re-evaluation instead of
arithmetic on a guess.

Epoch-following: every batch compares ``cluster.routing_version``
(bumped on ring changes AND per-slice flips) against the last value it
saw; a change forces a full snapshot re-evaluation of every
subscription — snapshot-then-stream, so no update is lost across a
rebalance cutover.  Delivery is at-least-once with monotonically
increasing per-subscription versions; updates carry absolute values,
so a coalesced-away intermediate version loses no information.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque

from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.exec.executor import DEFAULT_FRAME
from pilosa_tpu_torch.net import admission as adm
from pilosa_tpu_torch.net import codec
from pilosa_tpu_torch.obs import trace
from pilosa_tpu_torch.obs.stats import NopStatsClient
from pilosa_tpu_torch.pql.parser import Query, parse_string
from pilosa_tpu_torch.subscribe import registry as reg

# Snapshot caps: /debug/subscriptions lists at most this many entries.
_SNAPSHOT_SUBS = 100
# Ring of recent batch lags backing the /debug lag percentiles.
_LAG_RING = 512


class Subscription:
    """One registered standing query and its delivery state."""

    def __init__(
        self,
        sid: str,
        index: str,
        pql: str,
        kind: str,
        inner,
        tree,
        leaf_keys,
        force_pull: bool,
        queue_cap: int,
    ):
        self.id = sid
        self.index = index
        self.pql = pql
        self.kind = kind
        self.inner = inner          # Count(...) / TopN(...) — the pull call
        self.tree = tree            # bitmap tree (count kind) or None
        self.leaf_keys = leaf_keys  # {(frame, row|None)}
        self.force_pull = force_pull
        # Compiled program (count kind): filled by the manager at
        # registration; refreshed per-eval when it has BSI leaves.
        self.expr = None
        self.leaves: list = []
        self.has_bsi = False
        # Exact ±n fast path: single standard Bitmap leaf.
        self.fast_frame: str | None = None
        self.fast_row: int | None = None
        # Delivery state — guarded by ``cv``'s lock.
        self.cv = threading.Condition()
        self.version = 0
        self.value = None           # raw result (int | [Pair])
        self.value_json = None
        self.epoch = 0              # routing_version at last evaluation
        self.updates: deque = deque(maxlen=max(1, queue_cap))
        self.closed = False
        self.streams = 0            # live SSE connections
        self.delivered = 0          # updates handed to any waiter
        self.created = time.time()
        # False until the registration snapshot (version 1) is
        # published: the sub is in the watch index — so no write is
        # missed — but the notifier requeues its pending deltas
        # instead of racing the registering thread's evaluation.
        self.ready = False
        # Consecutive notifier-eval failures; drained deltas are
        # requeued (as full) until a small strike cap gives up.
        self.eval_failures = 0
        # Incremental per-slice counts — owned by the notifier thread.
        self.slice_counts: dict[int, int] = {}
        # Per-slice (fragment serial, write version) captured with the
        # plane read that produced slice_counts — the double-apply
        # fence for adj deltas (see module docstring).
        self.slice_vers: dict[int, tuple] = {}

    def watches(self, frame: str, rows) -> bool:
        """Does a write to ``frame`` touching ``rows`` intersect this
        subscription's leaves?  (Row-filtered only when every leaf in
        the frame names a concrete row.)"""
        wildcard = (frame, None) in self.leaf_keys
        if wildcard:
            return True
        return any((frame, int(r)) in self.leaf_keys for r in rows)


class SubscriptionManager:
    """Registry + delta engine + delivery for one node's standing
    queries.  Wired by the Server after the executor exists; the
    handler serves ``POST /subscribe`` and friends through it."""

    def __init__(
        self,
        executor,
        cluster=None,
        stats=None,
        tracer=None,
        admission=None,
        data_dir: str = "",
        logger=None,
        max_subscriptions: int = 10_000,
        queue_cap: int = 256,
        delta_cap: int = 50_000,
        coalesce_ms: float = 5.0,
        refresh_interval_ms: float = 500.0,
    ):
        self.ex = executor
        self.cluster = cluster
        self.stats = stats or NopStatsClient()
        self.tracer = tracer or trace.NOP_TRACER
        self.admission = admission
        self.data_dir = str(data_dir or "")
        # Node filter: normalized prefix WITH trailing separator so a
        # sibling data dir can never cross-match (/data/n1 vs /data/n10).
        self._data_dir_prefix = (
            os.path.normpath(self.data_dir) + os.sep if self.data_dir else ""
        )
        self.logger = logger or (lambda msg: None)
        self.max_subscriptions = int(max_subscriptions)
        self.queue_cap = int(queue_cap)
        self.delta_cap = int(delta_cap)
        self.coalesce_s = max(0.0, float(coalesce_ms)) / 1000.0
        self.refresh_s = max(0.05, float(refresh_interval_ms) / 1000.0)

        # Registry — mutations under _mu; readers use the published
        # immutable snapshots (_subs / _watch are REPLACED, never
        # mutated in place), so the write-side hot path is lock-free.
        self._mu = threading.Lock()
        self._subs: dict[str, Subscription] = {}
        # (index, frame) -> tuple[Subscription, ...]
        self._watch: dict[tuple[str, str], tuple] = {}

        # Pending deltas — the bounded "subscription delta log".
        # Guarded by _pending_mu, a LEAF lock: on_write runs under the
        # fragment lock and takes only this.
        self._pending_mu = threading.Lock()
        self._pending_cv = threading.Condition(self._pending_mu)
        # sid -> {"adj": {slice: [±n, frag_serial, ver_min, ver_max]},
        #         "dirty": {slice}, "full": bool,
        #         "t0": monotonic-first-touch}
        self._pending: dict[str, dict] = {}
        # (index, slice) -> bits accumulated since the last drain.
        self._pending_bits: dict[tuple[str, int], int] = {}
        self._busy = False

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_routing = cluster.routing_version if cluster else 0
        self._last_refresh = time.monotonic()
        self._lag_ring: deque = deque(maxlen=_LAG_RING)

        # Lifetime counters (mirrored to stats with exec.subscribe.*).
        self.registered = 0
        self.unregistered = 0
        self.updates_emitted = 0
        self.batches = 0
        self.overflows = 0
        self.epoch_flips = 0
        self.evals = {"adjust": 0, "slice": 0, "full": 0}

    # -- lifecycle -----------------------------------------------------

    def open(self) -> None:
        from pilosa_tpu_torch.core import fragment as fragment_mod

        self._last_routing = (
            self.cluster.routing_version if self.cluster else 0
        )
        fragment_mod.register_write_listener(self.on_write)
        fragment_mod.register_close_listener(self.on_fragment_close)
        self._thread = threading.Thread(
            target=self._notify_loop, name="subscribe-notify", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        from pilosa_tpu_torch.core import fragment as fragment_mod

        fragment_mod.unregister_write_listener(self.on_write)
        fragment_mod.unregister_close_listener(self.on_fragment_close)
        self._stop.set()
        with self._pending_cv:
            self._pending_cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        for sub in list(self._subs.values()):
            self._close_sub(sub)

    # -- registration --------------------------------------------------

    def register(self, index: str, pql: str) -> Subscription:
        """Parse, compile, index, THEN snapshot-evaluate one standing
        query; returns the live subscription with version 1 == the
        registration snapshot.  Publishing into the watch index before
        the snapshot is taken closes the registration window: a write
        landing during the evaluation is captured in the pending map
        and re-applied by the notifier (stale deltas are version-
        filtered on apply), so snapshot-then-stream holds from birth
        even on a single node with no refresh tick."""
        q = parse_string(pql)
        if len(q.calls) != 1:
            raise reg.SubscribeError("exactly one Subscribe(...) call required")
        kind, inner, tree, leaf_keys, force_pull = reg.compile_subscription(
            q.calls[0]
        )
        if self.ex.holder.index(index) is None:
            raise reg.SubscribeError(f"index {index!r} does not exist")
        sub = Subscription(
            sid=uuid.uuid4().hex[:16],
            index=index,
            pql=pql,
            kind=kind,
            inner=inner,
            tree=tree,
            leaf_keys=leaf_keys,
            force_pull=force_pull,
            queue_cap=self.queue_cap,
        )
        if kind == reg.KIND_COUNT:
            self._compile(sub)
        with self._mu:
            if len(self._subs) >= self.max_subscriptions:
                raise reg.SubscribeError(
                    f"subscription limit reached ({self.max_subscriptions})"
                )
            subs = dict(self._subs)
            subs[sub.id] = sub
            self._subs = subs
            self._rebuild_watch_locked()
        try:
            # Snapshot evaluation OUTSIDE any engine lock (takes
            # fragment locks through the executor).  The
            # notifier sees the sub but defers its deltas until ready.
            value = self._evaluate_full(sub)
            routing = self.cluster.routing_version if self.cluster else 0
            self._emit(sub, value, routing, force=True)
        except BaseException:
            with self._mu:
                if sub.id in self._subs:
                    subs = dict(self._subs)
                    del subs[sub.id]
                    self._subs = subs
                    self._rebuild_watch_locked()
            with self._pending_cv:
                self._pending.pop(sub.id, None)
            raise
        with self._pending_cv:
            sub.ready = True
            if sub.id in self._pending:
                # Writes landed mid-snapshot: have the notifier fold
                # them in now rather than on the next matching write.
                self._pending_cv.notify()
        self.registered += 1
        self.stats.count("exec.subscribe.registered")
        return sub

    def unregister(self, sid: str) -> bool:
        with self._mu:
            sub = self._subs.get(sid)
            if sub is None:
                return False
            subs = dict(self._subs)
            del subs[sid]
            self._subs = subs
            self._rebuild_watch_locked()
        with self._pending_mu:
            self._pending.pop(sid, None)
        self._close_sub(sub)
        self.unregistered += 1
        self.stats.count("exec.subscribe.unregistered")
        return True

    def get(self, sid: str) -> Subscription | None:
        return self._subs.get(sid)

    def _close_sub(self, sub: Subscription) -> None:
        with sub.cv:
            sub.closed = True
            sub.cv.notify_all()

    def _compile(self, sub: Subscription) -> None:
        """Compile the tree once: BSI rewrite + decompose — the same
        program the interpreter and hosteval evaluate."""
        rewritten = self.ex._rewrite_bsi(sub.index, sub.tree)
        sub.expr, sub.leaves = plan.decompose(rewritten)
        sub.has_bsi = reg.has_bsi_leaves(sub.leaves)
        if (
            not sub.force_pull
            and not sub.has_bsi
            and sub.expr == ("leaf", 0)
            and sub.leaves[0].name == "Bitmap"
        ):
            row = sub.leaves[0].args.get("rowID")
            if isinstance(row, int) and not isinstance(row, bool):
                sub.fast_frame = (
                    sub.leaves[0].args.get("frame") or DEFAULT_FRAME
                )
                sub.fast_row = int(row)

    def _rebuild_watch_locked(self) -> None:
        watch: dict[tuple[str, str], dict] = {}
        for sub in self._subs.values():
            for frame, _row in sub.leaf_keys:
                watch.setdefault((sub.index, frame), {})[sub.id] = sub
        self._watch = {k: tuple(v.values()) for k, v in watch.items()}

    # -- the fragment write listener (under the fragment lock) ---------

    def on_write(
        self, frag, set_rows, set_cols, clear_rows, clear_cols, exact=False
    ) -> None:
        """Fold one write into the pending delta map.  Called under the
        fragment lock — takes only the pending lock (a leaf in the
        lock hierarchy, like DeltaLog.record).  ``exact`` gates the ±n
        fast path: only bits that provably changed may adjust a count
        without re-evaluation."""
        watch = self._watch
        if not watch:
            return  # no subscriptions: one check per write
        entries = watch.get((frag.index, frag.frame))
        if not entries or self._foreign(frag):
            return  # unwatched, or another in-process node's fragment
        n = len(set_rows) + len(clear_rows)
        if n == 0:
            return
        now = time.monotonic()
        overflow_slices: list[int] = []
        with self._pending_cv:
            key = (frag.index, frag.slice)
            before = self._pending_bits.get(key, 0)
            self._pending_bits[key] = before + n
            overflowed = before + n > self.delta_cap
            if overflowed and before <= self.delta_cap:
                overflow_slices.append(frag.slice)
            touched = False
            for sub in entries:
                if not sub.watches(
                    frag.frame, list(set_rows) + list(clear_rows)
                ):
                    continue
                p = self._pending.get(sub.id)
                if p is None:
                    p = self._pending[sub.id] = {
                        "adj": {},
                        "dirty": set(),
                        "full": False,
                        "t0": now,
                    }
                touched = True
                if overflowed:
                    p["full"] = True
                    continue
                if (
                    exact
                    and sub.fast_row is not None
                    and frag.view == "standard"
                    and frag.frame == sub.fast_frame
                ):
                    d = sum(1 for r in set_rows if int(r) == sub.fast_row)
                    d -= sum(1 for r in clear_rows if int(r) == sub.fast_row)
                    if d:
                        # Stamp with the fragment's write version
                        # (already bumped for this write, same lock
                        # hold) — the apply side drops deltas the
                        # slice base provably includes.
                        adj = p["adj"]
                        ver = frag._version
                        cur = adj.get(frag.slice)
                        if cur is None:
                            adj[frag.slice] = [d, frag._serial, ver, ver]
                        elif cur[1] == frag._serial:
                            cur[0] += d
                            cur[3] = ver  # monotonic per fragment
                        else:
                            # Recreated fragment under this slice:
                            # stamps incomparable — degrade to dirty.
                            adj.pop(frag.slice, None)
                            p["dirty"].add(frag.slice)
                else:
                    p["dirty"].add(frag.slice)
            if touched:
                self._pending_cv.notify()
        for s in overflow_slices:
            self.overflows += 1
            self.stats.count_with_custom_tags(
                "exec.subscribe.overflows", 1, [f"slice:{frag.index}/{s}"]
            )

    def _foreign(self, frag) -> bool:
        """True when the fragment belongs to another in-process node
        (in-process clusters share the module-wide listener)."""
        if not self._data_dir_prefix:
            return False
        path = os.path.normpath(str(getattr(frag, "path", "")))
        return not path.startswith(self._data_dir_prefix)

    def on_fragment_close(self, frag) -> None:
        """Fragment left service (close/retire/demotion, including a
        rebalanced-away slice): drop its pending budget and force the
        affected subscriptions to re-base that slice — incremental
        state must never survive the plane it was computed from."""
        if self._foreign(frag):
            return
        watch = self._watch
        entries = watch.get((frag.index, frag.frame)) if watch else None
        with self._pending_cv:
            self._pending_bits.pop((frag.index, frag.slice), None)
            if not entries:
                return
            for sub in entries:
                p = self._pending.get(sub.id)
                if p is None:
                    p = self._pending[sub.id] = {
                        "adj": {},
                        "dirty": set(),
                        "full": False,
                        "t0": time.monotonic(),
                    }
                p["full"] = True
            self._pending_cv.notify()

    # -- the notifier thread -------------------------------------------

    def _notify_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._drain_once()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self.logger(f"subscribe: notify loop error: {e}")
                self._stop.wait(0.2)

    def _actionable_locked(self) -> bool:
        """Any pending entry whose subscription is ready (or gone)?
        Entries for subs whose registration snapshot is still in
        flight are deferred — they must not wake or spin the loop."""
        for sid in self._pending:
            sub = self._subs.get(sid)
            if sub is None or sub.ready:
                return True
        return False

    def _drain_once(self) -> None:
        with self._pending_cv:
            if not self._actionable_locked():
                self._pending_cv.wait(self.refresh_s)
        if self._stop.is_set():
            return
        if self.coalesce_s > 0:
            # Coalescing window: let a write burst accumulate into one
            # batch instead of one notification per bit.
            self._stop.wait(self.coalesce_s)
        with self._pending_cv:
            batch = {}
            for sid in list(self._pending):
                sub = self._subs.get(sid)
                if sub is not None and not sub.ready:
                    continue  # deferred until the snapshot publishes
                batch[sid] = self._pending.pop(sid)
            self._pending_bits = {}
            self._busy = bool(batch)

        routing = self.cluster.routing_version if self.cluster else 0
        epoch_flip = routing != self._last_routing
        now = time.monotonic()
        refresh_due = (
            self._multi_node()
            and now - self._last_refresh >= self.refresh_s
            and bool(self._subs)
        )
        if epoch_flip or refresh_due:
            # Snapshot-then-stream: full re-evaluation of every
            # subscription.  On a topology move this is what carries a
            # subscription across the cutover; on a quiet multi-node
            # tick it feeds subscriptions whose slices live remotely
            # (their writes fire no local listener).
            for sub in list(self._subs.values()):
                p = batch.setdefault(
                    sub.id,
                    {"adj": {}, "dirty": set(), "full": False, "t0": now},
                )
                p["full"] = True
            self._last_refresh = now
            if epoch_flip and self._subs:
                self.epoch_flips += 1
                self.stats.count("exec.subscribe.epochFlips")
        self._last_routing = routing
        if not batch:
            with self._pending_cv:
                self._busy = False
            return
        with self._pending_cv:
            self._busy = True
        try:
            self._process_batch(batch, routing, force=epoch_flip)
        finally:
            with self._pending_cv:
                self._busy = False

    def _process_batch(self, batch: dict, routing: int, force: bool) -> None:
        """Evaluate one drained batch.  The deltas are already out of
        the pending map, so every failure path — the admission lane
        shedding (shared with POST /subscribe), a per-subscription
        eval error, anything unexpected — must push its unprocessed
        entries BACK via _requeue: a silently dropped adj delta is
        permanent drift, a dropped dirty mark permanent staleness."""
        t0 = min(p["t0"] for p in batch.values())
        root = self.tracer.start_trace("subscribe", subscriptions=len(batch))
        remaining = dict(batch)
        requeue: dict[str, dict] = {}
        inflight: str | None = None
        ticket = None
        try:
            if self.admission is not None:
                with self.tracer.span("admission", parent=root):
                    ticket = self.admission.acquire(adm.CLASS_SUBSCRIBE)
            with self.tracer.span("subscribe.eval", parent=root) as sp:
                n_updates = 0
                for sid, p in batch.items():
                    sub = self._subs.get(sid)
                    if sub is None or sub.closed:
                        del remaining[sid]
                        continue
                    if not sub.ready:
                        # Registration snapshot still in flight —
                        # defer, don't race the registering thread.
                        requeue[sid] = p
                        del remaining[sid]
                        continue
                    try:
                        inflight = sid
                        changed = self._reevaluate(sub, p, routing, force)
                        inflight = None
                        sub.eval_failures = 0
                    except Exception as e:  # noqa: BLE001
                        inflight = None
                        sub.eval_failures += 1
                        if sub.eval_failures <= 3:
                            p["full"] = True
                            requeue[sid] = p
                        else:
                            # Give up on the entry, but invalidate the
                            # (possibly half-adjusted) bases so the
                            # next delta re-evaluates from planes.
                            sub.slice_counts = {}
                            sub.slice_vers = {}
                        self.logger(
                            f"subscribe: eval failed for {sid}: {e}"
                        )
                        del remaining[sid]
                        continue
                    del remaining[sid]
                    if changed:
                        n_updates += 1
                sp.annotate(updates=n_updates)
        except BaseException:
            # Batch-level failure (admission shed, ...): everything
            # not yet individually settled goes back on the map; the
            # notify loop logs and retries after a short backoff.  An
            # eval interrupted mid-flight may have half-applied its
            # adj deltas — force that one to re-base in full.
            if inflight is not None and inflight in remaining:
                remaining[inflight]["full"] = True
            requeue.update(remaining)
            raise
        finally:
            self._requeue(requeue)
            if ticket is not None:
                ticket.release()
            self.tracer.finish_root(root)
        lag_ms = (time.monotonic() - t0) * 1000.0
        self._lag_ring.append(lag_ms)
        self.batches += 1
        self.stats.count("exec.subscribe.notifyBatches")
        self.stats.histogram("exec.subscribe.lagMs", lag_ms)

    def _requeue(self, entries: dict) -> None:
        """Merge drained-but-unprocessed entries back into the live
        pending map (see _process_batch)."""
        if not entries:
            return
        with self._pending_cv:
            for sid, src in entries.items():
                p = self._pending.get(sid)
                if p is None:
                    self._pending[sid] = src
                else:
                    self._merge_entry(p, src)
            self._pending_cv.notify()

    @staticmethod
    def _merge_entry(p: dict, src: dict) -> None:
        """Fold ``src`` (an older drained entry) into live entry ``p``."""
        p["full"] = p["full"] or src["full"]
        p["t0"] = min(p["t0"], src["t0"])
        p["dirty"] |= src["dirty"]
        adj = p["adj"]
        for s, (d, serial, vmin, vmax) in src["adj"].items():
            if s in p["dirty"]:
                continue  # the dirty re-evaluation subsumes the delta
            cur = adj.get(s)
            if cur is None:
                adj[s] = [d, serial, vmin, vmax]
            elif cur[1] == serial:
                adj[s] = [
                    cur[0] + d, serial, min(cur[2], vmin), max(cur[3], vmax)
                ]
            else:
                adj.pop(s, None)
                p["dirty"].add(s)

    def _multi_node(self) -> bool:
        return self.cluster is not None and len(self.cluster.nodes) > 1

    def _reevaluate(self, sub, p: dict, routing: int, force: bool) -> bool:
        """Bring one subscription current; returns True when an update
        was emitted."""
        full = (
            p["full"]
            or sub.kind == reg.KIND_TOPN
            or sub.force_pull
            or self._multi_node()
            or (self.cluster is not None and self.cluster.transition is not None)
        )
        if full:
            value = self._evaluate_full(sub)
            self.evals["full"] += 1
            self.stats.count_with_custom_tags(
                "exec.subscribe.evals", 1, ["mode:full"]
            )
        else:
            value = self._evaluate_incremental(sub, p)
        return self._emit(sub, value, routing, force=force)

    def _evaluate_full(self, sub):
        """Snapshot evaluation — the pull path itself, so the value is
        correct regardless of slice placement; resets the incremental
        per-slice base for the count kind on a single node."""
        if sub.kind == reg.KIND_COUNT and not sub.force_pull and not self._multi_node():
            idx = self.ex.holder.index(sub.index)
            if idx is None:
                sub.slice_counts = {}
                sub.slice_vers = {}
                return 0
            slices = list(range(idx.max_slice() + 1))
            sub.slice_counts, sub.slice_vers = self._slice_count(sub, slices)
            return sum(sub.slice_counts.values())
        sub.slice_counts = {}
        sub.slice_vers = {}
        res = self.ex.execute(sub.index, Query(calls=[sub.inner]))
        return res[0]

    def _evaluate_incremental(self, sub, p: dict):
        """Single-node count kind: ±adjust exact deltas, re-evaluate
        only the dirty slices (``_slice_count``).

        An adj delta is applied ONLY when its whole write-version
        range lies above the slice base's stamp; at or below the stamp
        it was already counted by the read that produced the
        base (the double-apply fence — see the module docstring), and
        a straddling range or recreated-fragment serial degrades to a
        dirty re-evaluation."""
        dirty = set(p["dirty"])
        counts = sub.slice_counts
        vers = sub.slice_vers
        for s, (d, serial, vmin, vmax) in p["adj"].items():
            if s in dirty:
                continue  # the re-evaluation below subsumes the delta
            base = vers.get(s)
            if s not in counts or base is None:
                dirty.add(s)  # no stamped base yet — evaluate, don't guess
            elif serial != base[0]:
                dirty.add(s)  # fragment recreated: stamps incomparable
            elif vmax <= base[1]:
                continue      # fully inside the base plane read already
            elif vmin > base[1]:
                counts[s] += d
            else:
                dirty.add(s)  # straddles the base read — re-evaluate
        if dirty:
            new_counts, new_vers = self._slice_count(sub, sorted(dirty))
            counts.update(new_counts)
            vers.update(new_vers)
            self.evals["slice"] += 1
            self.stats.count_with_custom_tags(
                "exec.subscribe.evals", 1, ["mode:slice"]
            )
        elif p["adj"]:
            self.evals["adjust"] += 1
            self.stats.count_with_custom_tags(
                "exec.subscribe.evals", 1, ["mode:adjust"]
            )
        return sum(counts.values())

    def _slice_count(self, sub, slices) -> tuple[dict, dict]:
        """Per-slice counts of the subscription's tree; returns ``(counts,
        version stamps)``.

        The single-leaf fast path reads each fragment's row count, which
        every write keeps exact, and its ``(_serial, _version)`` under ONE
        hold of the fragment lock — anchoring exactly which adj deltas
        the base includes.  It launches nothing and popcounts nothing.
        Every other tree is one K2 "count" launch over ``slices``
        (``Executor.count_slices``: the Count pull's kernel and health
        gate).  Compound trees take no stamp: they only ever receive
        dirty marks, which are idempotent."""
        if sub.fast_row is None:
            return self.ex.count_slices(sub.index, sub.tree, list(slices)), {}
        out: dict[int, int] = {}
        vers: dict[int, tuple] = {}
        for s in slices:
            frag = self.ex.holder.fragment(sub.index, sub.fast_frame, "standard", s)
            if frag is None:
                # No fragment yet: serial -1 never matches a real
                # write's stamp, so the first delta re-evaluates.
                out[s] = 0
                vers[s] = (-1, -1)
                continue
            with frag._mu:
                vers[s] = (frag._serial, frag._version)
                out[s] = frag.row_count(sub.fast_row)
        return out, vers

    # -- delivery ------------------------------------------------------

    def _emit(self, sub, value, routing: int, force: bool = False) -> bool:
        changed = value != sub.value
        if not changed and not force and routing == sub.epoch:
            return False
        value_json = codec.result_to_json(value)
        with sub.cv:
            sub.value = value
            sub.value_json = value_json
            sub.version += 1
            sub.epoch = routing
            sub.updates.append(
                {
                    "id": sub.id,
                    "version": sub.version,
                    "epoch": routing,
                    "value": value_json,
                }
            )
            sub.cv.notify_all()
        self.updates_emitted += 1
        self.stats.count("exec.subscribe.updates")
        return True

    def wait_update(self, sub, after: int, timeout: float):
        """Block until the subscription moves past ``after`` (long-poll
        / SSE wait).  Returns the oldest retained update newer than
        ``after`` — or the current snapshot when the queue already
        rotated past it (at-least-once: the absolute value subsumes the
        missed versions) — or None on timeout / closed."""
        deadline = time.monotonic() + max(0.0, timeout)
        with sub.cv:
            while not sub.closed and sub.version <= after:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                sub.cv.wait(remaining)
            if sub.version <= after:
                return None  # closed without news
            for u in sub.updates:
                if u["version"] > after:
                    sub.delivered += 1
                    return u
            sub.delivered += 1
            return {
                "id": sub.id,
                "version": sub.version,
                "epoch": sub.epoch,
                "value": sub.value_json,
            }

    # -- quiescence ----------------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until every pending delta has been evaluated and
        published — the quiescence point tests compare against the
        oracle at."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._pending_mu:
                idle = not self._pending and not self._busy
            if idle:
                return True
            time.sleep(0.002)
        return False

    # -- observability -------------------------------------------------

    def _lag_percentiles(self) -> dict:
        lags = sorted(self._lag_ring)
        if not lags:
            return {"p50": None, "p99": None, "samples": 0}
        def pct(p):
            return round(lags[min(len(lags) - 1, int(p * (len(lags) - 1)))], 3)
        return {"p50": pct(0.50), "p99": pct(0.99), "samples": len(lags)}

    def snapshot(self) -> dict:
        """The ``GET /debug/subscriptions`` document."""
        subs = list(self._subs.values())
        with self._pending_mu:
            pending = len(self._pending)
            pending_bits = sum(self._pending_bits.values())
        return {
            "count": len(subs),
            "maxSubscriptions": self.max_subscriptions,
            "deltaCap": self.delta_cap,
            "routingVersion": self._last_routing,
            "pending": {"subscriptions": pending, "bits": pending_bits},
            "lagMs": self._lag_percentiles(),
            "counters": {
                "registered": self.registered,
                "unregistered": self.unregistered,
                "updates": self.updates_emitted,
                "batches": self.batches,
                "overflows": self.overflows,
                "epochFlips": self.epoch_flips,
                "evals": dict(self.evals),
            },
            "subscriptions": [
                {
                    "id": s.id,
                    "index": s.index,
                    "query": s.pql,
                    "kind": s.kind,
                    "version": s.version,
                    "epoch": s.epoch,
                    "streams": s.streams,
                    "delivered": s.delivered,
                    "value": s.value_json,
                }
                for s in subs[:_SNAPSHOT_SUBS]
            ],
        }

    def gauges(self) -> dict:
        return {
            "exec.subscribe.active": float(len(self._subs)),
            "exec.subscribe.pendingBits": float(
                sum(self._pending_bits.values())
            ),
        }
