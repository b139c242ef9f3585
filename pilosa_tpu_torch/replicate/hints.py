"""Hinted handoff — bounded per-(replica, slice) write hints.

When a quorum write cannot reach a replica, the coordinator queues the
write's effects here, destined for that replica, and the replayer pushes
them when the replica's circuit breaker re-admits traffic (open ->
half-open).  This is the delta-log idiom from the rebalance subsystem
(``rebalance/deltalog.py``) re-keyed by TARGET HOST: entries preserve
application order, the log is bounded per (target, index, slice), and an
overflow drops the slice's hints LOUDLY (counted) — anti-entropy and
read-repair then own convergence for that slice, bounded memory over
unbounded correctness.

Entry kinds (all idempotent to replay):

* ``("views", frame, view, set_rows, set_cols, clear_rows, clear_cols)``
  — exact per-view deltas captured from the fragment write-listener
  during the coordinator's local apply (absolute column ids, the
  ``/fragment/import-view`` wire shape); replays standard, inverse, and
  time views byte-exactly.
* ``("pql", query)`` — the original write call text, for coordinators
  that do not replicate the slice themselves (nothing local to
  capture); replays through the target's whole write path.
* ``("import", payload)`` / ``("import-value", payload)`` — raw
  ``/import`` (protobuf) / ``/import-value`` (JSON) bodies queued by
  the client-side import fan-out via ``POST /replicate/hint``.
"""

from __future__ import annotations

import contextvars
import threading
import time

# Active capture buffer: while a coordinator applies a write locally,
# the write-listener appends (index, slice, frame, view, sets, clears)
# tuples here so failed replicas get the exact local effects as hints.
_capture: "contextvars.ContextVar[list | None]" = contextvars.ContextVar(
    "pilosa_hint_capture", default=None
)


class _CaptureScope:
    def __init__(self, buf: list):
        self._buf = buf
        self._token = None

    def __enter__(self) -> list:
        self._token = _capture.set(self._buf)
        return self._buf

    def __exit__(self, *exc) -> None:
        _capture.reset(self._token)


def capture(buf: list | None = None) -> _CaptureScope:
    """Scope within which local fragment writes record into ``buf``."""
    return _CaptureScope(buf if buf is not None else [])


def record_local_write(frag, set_rows, set_cols, clear_rows, clear_cols) -> None:
    """Write-listener leg: feed the active capture scope (no-op — one
    contextvar read — when no coordinator is capturing)."""
    buf = _capture.get()
    if buf is None:
        return
    buf.append(
        (
            frag.index,
            frag.slice,
            frag.frame,
            frag.view,
            [int(r) for r in set_rows],
            [int(c) for c in set_cols],
            [int(r) for r in clear_rows],
            [int(c) for c in clear_cols],
        )
    )


def entry_bits(entry: tuple) -> int:
    """Cap accounting: logged bits for a views entry, 1 for pql, row
    count for import payloads (pre-computed by the queuer)."""
    kind = entry[0]
    if kind == "views":
        return len(entry[3]) + len(entry[5])
    if kind in ("import", "import-value"):
        return int(entry[2])
    return 1


class HintLog:
    """Ordered hint queues keyed (target_host, index, slice), each
    bounded at ``cap`` bits.  Leaf lock — holders never call out."""

    def __init__(self, cap: int = 10_000, stats=None):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.cap = int(cap)
        self.stats = stats or NopStatsClient()
        self._mu = threading.Lock()
        # (target, index, slice) -> {"entries": [...], "bits": int}
        self._logs: dict[tuple[str, str, int], dict] = {}
        # target -> {"lastReplay": ts, "lastError": str, "replayed": n}
        self._targets: dict[str, dict] = {}
        self.dropped = 0  # hints lost to cap overflow (slices count once)

    # -- queueing ------------------------------------------------------

    def _queue(self, target: str, index: str, slice_i: int, entry: tuple) -> bool:
        n = entry_bits(entry)
        with self._mu:
            log = self._logs.setdefault(
                (target, index, int(slice_i)),
                {"entries": [], "bits": 0, "overflowed": False},
            )
            if log["overflowed"] or log["bits"] + n > self.cap:
                # Overflow: drop the slice's whole backlog and stop
                # accepting until the next replay drain — a PARTIAL
                # hint stream replays to a state that is neither the
                # old nor the new one; the drain's overflow marker
                # makes the replayer checksum-reconcile (full push)
                # instead.
                dropped = len(log["entries"]) + 1
                log["entries"] = []
                log["bits"] = 0
                log["overflowed"] = True
                self.dropped += dropped
                self.stats.count("cluster.replication.hintsDropped", dropped)
                self._targets.setdefault(target, {})
                return False
            log["entries"].append(entry)
            log["bits"] += n
            self._targets.setdefault(target, {})
        return True

    def queue_views(self, target: str, captured: list) -> int:
        """Queue captured local write effects (see :func:`capture`);
        returns entries queued."""
        queued = 0
        for index, slice_i, frame, view, sr, sc, cr, cc in captured:
            if self._queue(
                target, index, slice_i, ("views", frame, view, sr, sc, cr, cc)
            ):
                queued += 1
        return queued

    def queue_pql(self, target: str, index: str, slice_i: int, query: str) -> bool:
        return self._queue(target, index, slice_i, ("pql", query))

    def queue_payload(
        self, target: str, index: str, slice_i: int, kind: str,
        payload: bytes, rows: int,
    ) -> bool:
        """An /import or /import-value body destined for ``target``."""
        if kind not in ("import", "import-value"):
            raise ValueError(f"unknown hint payload kind: {kind!r}")
        return self._queue(target, index, slice_i, (kind, payload, int(rows)))

    # -- replay side ---------------------------------------------------

    def targets(self) -> list[str]:
        """Hosts with a non-empty (or overflowed) backlog."""
        with self._mu:
            return sorted(
                {
                    t
                    for (t, _, _), log in self._logs.items()
                    if log["entries"] or log["overflowed"]
                }
            )

    def drain(self, target: str) -> list[tuple[str, int, list, bool]]:
        """Atomically take every (index, slice, entries, overflowed)
        queued for one target, in application order; the queues stay
        open (and un-overflowed) so writes racing the replay land in
        the next drain.  An overflowed group's entries are empty — the
        replayer must checksum-reconcile that slice instead."""
        out = []
        with self._mu:
            for (t, index, slice_i), log in sorted(self._logs.items()):
                if t != target or not (log["entries"] or log["overflowed"]):
                    continue
                out.append(
                    (index, slice_i, log["entries"], log["overflowed"])
                )
                log["entries"] = []
                log["bits"] = 0
                log["overflowed"] = False
        return out

    def requeue(self, target: str, index: str, slice_i: int, entries: list) -> None:
        """Head-requeue a replay's unapplied tail (push died mid-way)."""
        if not entries:
            return
        with self._mu:
            log = self._logs.setdefault(
                (target, index, int(slice_i)),
                {"entries": [], "bits": 0, "overflowed": False},
            )
            log["entries"] = list(entries) + log["entries"]
            log["bits"] += sum(entry_bits(e) for e in entries)

    def note_replay(self, target: str, replayed: int, error: str = "") -> None:
        with self._mu:
            st = self._targets.setdefault(target, {})
            st["lastReplay"] = time.time()
            st["replayed"] = st.get("replayed", 0) + replayed
            if error:
                st["lastError"] = error
            else:
                st.pop("lastError", None)
            if not error:
                # Fully drained + clean: forget empty queues so the
                # backlog map doesn't grow one key per ever-failed host.
                for key in [
                    k
                    for k, log in self._logs.items()
                    if k[0] == target and not log["entries"]
                ]:
                    del self._logs[key]

    def backlog(self, target: str | None = None) -> int:
        """Queued entry count (one target, or total)."""
        with self._mu:
            return sum(
                len(log["entries"])
                for (t, _, _), log in self._logs.items()
                if target is None or t == target
            )

    def snapshot(self) -> dict:
        """The ``/debug/replication`` hints block: per-target backlog
        (entries/bits/slices), last replay outcome, drop total."""
        with self._mu:
            by_target: dict[str, dict] = {}
            for (t, index, slice_i), log in sorted(self._logs.items()):
                ent = by_target.setdefault(
                    t, {"entries": 0, "bits": 0, "slices": []}
                )
                if log["entries"]:
                    ent["entries"] += len(log["entries"])
                    ent["bits"] += log["bits"]
                    ent["slices"].append(f"{index}/{slice_i}")
                if log["overflowed"]:
                    ent.setdefault("overflowed", []).append(
                        f"{index}/{slice_i}"
                    )
            for t, st in self._targets.items():
                by_target.setdefault(
                    t, {"entries": 0, "bits": 0, "slices": []}
                ).update(st)
            return {"cap": self.cap, "dropped": self.dropped, "targets": by_target}
