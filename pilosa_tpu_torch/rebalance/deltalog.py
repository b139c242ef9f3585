"""Bounded per-slice delta log — the write-forwarding half of cutover.

While a slice is being bulk-copied to its new owner, writes keep
landing on the source (reads still route there, and
``Cluster.write_nodes`` applies every write on both rings).  The copy
streams a snapshot, so writes that race the stream could be missed on
the target; the source therefore LOGS every write to a migrating slice
from the moment the coordinator opens its copy window, and the
coordinator replays the log to the target after the bulk copy — the
reference's anti-entropy protocol, scoped to one cutover instead of a
cluster-wide sweep.

The log is BOUNDED (``cap`` logged bits per slice): a write storm that
overflows it marks the slice ``overflowed`` and the coordinator redoes
the bulk copy instead of replaying — bounded memory, unbounded
correctness.  Entries preserve application order, so a set-then-clear
replays to the same final state.

The log feeds from the fragment write-listener hook
(:func:`pilosa_tpu_torch.core.fragment.register_write_listener`): every
successful ``set_bit``/``clear_bit``/``import_bulk`` on ANY fragment of
an actively-logged (index, slice) appends one entry.  When no slice is
logging, the listener costs one dict read per write.
"""

from __future__ import annotations

import threading


class DeltaLog:
    """Per-(index, slice) ordered write log with a per-slice bit cap."""

    def __init__(self, cap: int = 50_000, stats=None):
        self.cap = cap
        self._mu = threading.Lock()
        # (index, slice) -> {"entries": list, "bits": int, "overflowed": bool}
        self._logs: dict[tuple[str, int], dict] = {}
        # Lifetime overflow count per (index, slice) — survives
        # start/stop cycles so /debug/rebalance shows WHICH slices keep
        # outrunning the cap (the subscribe engine's re-run-on-overflow
        # path and capacity planning both need the per-slice view; the
        # untagged cluster.rebalance.deltaOverflow counter only says
        # that overflows happened somewhere).
        self._overflows: dict[tuple[str, int], int] = {}
        self.stats = stats

    # -- lifecycle (driven by the coordinator via /rebalance/delta) ----

    def start(self, index: str, slice_i: int) -> None:
        """Open (or keep open) the log for one slice — idempotent, and
        re-opening RESETS it: the coordinator calls start immediately
        before each bulk copy, so stale entries from a crashed earlier
        attempt never replay."""
        with self._mu:
            self._logs[(index, slice_i)] = {
                "entries": [],
                "bits": 0,
                "overflowed": False,
            }

    def stop(self, index: str, slice_i: int) -> None:
        with self._mu:
            self._logs.pop((index, slice_i), None)

    def active(self) -> list[tuple[str, int]]:
        with self._mu:
            return sorted(self._logs)

    def drain(self, index: str, slice_i: int) -> tuple[list[tuple], bool]:
        """Atomically take the slice's logged entries (in application
        order) and whether the log overflowed since the last drain;
        the log stays OPEN and empty, so writes racing the replay land
        in the next drain."""
        with self._mu:
            log = self._logs.get((index, slice_i))
            if log is None:
                return [], False
            entries = log["entries"]
            overflowed = log["overflowed"]
            log["entries"] = []
            log["bits"] = 0
            log["overflowed"] = False
            return entries, overflowed

    def requeue(self, index: str, slice_i: int, entries: list[tuple]) -> None:
        """Put drained-but-unreplayed entries BACK at the head of the
        log (a replay push that died mid-way must not lose the tail) —
        order is preserved; the cap is deliberately ignored here (the
        entries were already admitted once)."""
        if not entries:
            return
        with self._mu:
            log = self._logs.get((index, slice_i))
            if log is None or log["overflowed"]:
                return
            log["entries"] = list(entries) + log["entries"]
            log["bits"] += sum(
                len(e[2]) + len(e[4]) for e in entries
            )

    def snapshot(self) -> dict:
        with self._mu:
            return {
                f"{i}/{s}": {
                    "entries": len(log["entries"]),
                    "bits": log["bits"],
                    "overflowed": log["overflowed"],
                    "overflows": self._overflows.get((i, s), 0),
                }
                for (i, s), log in self._logs.items()
            }

    def overflow_counts(self) -> dict:
        """Lifetime per-slice overflow counts (``{"idx/slice": n}``) —
        includes slices whose log has since closed."""
        with self._mu:
            return {f"{i}/{s}": n for (i, s), n in self._overflows.items()}

    # -- the fragment write-listener hook ------------------------------

    def record(
        self, frag, set_rows, set_cols, clear_rows, clear_cols, exact=True
    ) -> None:
        """Append one write to the slice's log (no-op when the slice is
        not migrating).  ``*_cols`` are ABSOLUTE column ids, matching
        the import-view replay wire format.  ``exact`` (the listener
        protocol's changed-bits flag) is irrelevant here: replay is
        idempotent set/clear, so already-true bits are harmless.
        Called under the fragment lock so log order equals application
        order; only takes the log lock (a leaf in the lock
        hierarchy)."""
        key = (frag.index, frag.slice)
        with self._mu:
            log = self._logs.get(key)
            if log is None or log["overflowed"]:
                return
            n = len(set_rows) + len(clear_rows)
            if n == 0:
                return
            if log["bits"] + n > self.cap:
                # Overflow: drop everything — the coordinator must redo
                # the bulk copy, which subsumes any replay.
                log["entries"] = []
                log["bits"] = 0
                log["overflowed"] = True
                self._overflows[key] = self._overflows.get(key, 0) + 1
                if self.stats is not None:
                    self.stats.count("cluster.rebalance.deltaOverflow")
                    self.stats.count_with_custom_tags(
                        "rebalance.deltalog.overflows",
                        1,
                        [f"slice:{frag.index}/{frag.slice}"],
                    )
                return
            log["entries"].append(
                (
                    frag.frame,
                    frag.view,
                    [int(r) for r in set_rows],
                    [int(c) for c in set_cols],
                    [int(r) for r in clear_rows],
                    [int(c) for c in clear_cols],
                )
            )
            log["bits"] += n
