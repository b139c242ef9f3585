"""Mirror prefetcher: upload cold fragment mirrors in the background.

The counterpart of ``pilosa_tpu/device/prefetch.py``.  A query's leaf
fragments are known before its leaf stacks are assembled
(``Executor._prefetch_query``); any of them whose mirror is cold would
otherwise upload serially inside the assembly loop.  The prefetcher
uploads those mirrors from worker threads, so uploads overlap the
executor's host-side planning and each other.

Workers call the same ``Fragment.device_plane()`` the query path uses
(through ``Fragment.stage_mirror``, which does so only while the mirror
is cold), so admission, budget eviction and coherence all ride the
fragment lock: a prefetch never leaves a stale mirror, and a query that
reaches a fragment mid-upload waits on its lock.  Uploads are copies on
the device's current stream, the one every thread of the server uses.

A mirror counts as cold when it is absent.  Unlike the JAX package, a
mirror with queued writes is not cold: its queue is applied by the read
site's batched delta-scatter launch (``fragment.apply_pending_many``),
never one launch per fragment from a worker.

Two priority lanes share the workers (the JAX package's hydrate lane
belongs to its cold tier, which the port does not have yet):

* **query lane** (:meth:`prefetch`) — the per-query warm; always first.
* **staging lane** (:meth:`stage`) — re-uploading the residency set
  after a restart (``core/holder.stage_device_mirrors``); a restarted
  node answers while it drains, and a query's prefetch jumps it.

Workers are daemon threads: a worker stuck in a device call must cost a
lost prefetch, never a process that cannot exit.
"""

from __future__ import annotations

import threading
import time
from collections import deque

DEFAULT_WORKERS = 8


class StageJob:
    """Progress of one :meth:`Prefetcher.stage` call."""

    def __init__(self, total: int):
        self.total = total
        self.staged = 0
        self.skipped = 0  # already resident when its turn came
        self.errors = 0
        self._mu = threading.Lock()
        self._done = threading.Event()
        if total == 0:
            self._done.set()

    def _finish_one(self, *, staged: bool = False, skipped: bool = False,
                    error: bool = False) -> None:
        with self._mu:
            self.staged += staged
            self.skipped += skipped
            self.errors += error
            if self.staged + self.skipped + self.errors >= self.total:
                self._done.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "total": self.total,
                "staged": self.staged,
                "skipped": self.skipped,
                "errors": self.errors,
                "remaining": max(0, self.total - self.staged - self.skipped - self.errors),
            }


class Prefetcher:
    """Upload cold fragment mirrors from background threads; ``pool``
    (default the process-global one) keeps the hit, miss and staging
    counters."""

    def __init__(self, pool=None, max_workers: int = DEFAULT_WORKERS):
        self._pool = pool
        self._max_workers = max_workers
        # Query prefetches (high) always pop before staging (low).
        self._high: deque = deque()
        self._low: deque = deque()
        self._cv = threading.Condition(threading.Lock())
        self._threads: list[threading.Thread] = []
        self._idle = 0
        self._busy = 0

    def pool(self):
        if self._pool is not None:
            return self._pool
        from pilosa_tpu_torch import device as device_mod

        return device_mod.pool()

    @staticmethod
    def _is_cold(f) -> bool:
        # Advisory peek (no lock): the worker checks again under it.
        return f._mirror is None

    def prefetch(self, frags, wait: bool = False) -> int:
        """Schedule query-lane uploads for every cold fragment of
        ``frags``; resident mirrors count as prefetch hits.  Returns the
        number scheduled; ``wait=True`` blocks until they are done."""
        pool = self.pool()
        cold = []
        hits = 0
        for f in frags:
            if f is None:
                continue
            if self._is_cold(f):
                cold.append(f)
            else:
                hits += 1
        if hits:
            pool.count_prefetch(hit=hits)
        if not cold:
            return 0
        done = threading.Event()
        remaining = [len(cold)]
        rlock = threading.Lock()
        for f in cold:
            self._submit(("prefetch", f, pool, remaining, rlock, done), low=False)
        if wait:
            done.wait()
        return len(cold)

    def stage(self, frags) -> StageJob:
        """Schedule staging-lane uploads for every cold fragment of
        ``frags``, in the order given, and return the job's progress
        handle.  Query prefetches jump this backlog."""
        pool = self.pool()
        cold = [f for f in frags if f is not None and self._is_cold(f)]
        job = StageJob(len(cold))
        if cold:
            pool.count_stage(scheduled=len(cold))
            for f in cold:
                self._submit(("stage", f, pool, job), low=True)
        return job

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until both lanes are empty and no worker is uploading;
        False when ``timeout`` passed first."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._high or self._low or self._busy:
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(left)
        return True

    # ------------------------------------------------------------------

    def _submit(self, item: tuple, low: bool) -> None:
        with self._cv:
            (self._low if low else self._high).append(item)
            if self._idle == 0 and len(self._threads) < self._max_workers:
                t = threading.Thread(target=self._worker, daemon=True, name="hbm-prefetch")
                self._threads.append(t)
                t.start()
            else:
                self._cv.notify_all()

    def _take(self) -> tuple:
        with self._cv:
            self._idle += 1
            while not self._high and not self._low:
                self._cv.wait()
            self._idle -= 1
            self._busy += 1
            return (self._high or self._low).popleft()

    def _worker(self) -> None:
        while True:
            item = self._take()
            try:
                if item[0] == "prefetch":
                    self._run_prefetch(*item[1:])
                else:
                    self._run_stage(*item[1:])
            finally:
                with self._cv:
                    last = self._busy == 1 and not self._high and not self._low
                if last:
                    # No upload of ours is in flight: owners the uploads
                    # kept busy can be evicted back to the budget.
                    self.pool().reclaim()
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def _run_prefetch(self, frag, pool, remaining, rlock, done) -> None:
        try:
            staged = frag.stage_mirror()
            pool.count_prefetch(hit=0 if staged else 1, miss=1 if staged else 0)
        except Exception:  # noqa: BLE001 — prefetch is best-effort: the
            pass  # query path raises any real failure itself
        finally:
            with rlock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    done.set()

    def _run_stage(self, frag, pool, job: StageJob) -> None:
        try:
            if not self._is_cold(frag):
                # A query (or its prefetch) got here first.
                pool.count_stage(done=1)
                job._finish_one(skipped=True)
                return
            frag.stage_mirror()
            pool.count_stage(done=1, nbytes=frag.plane_nbytes)
            job._finish_one(staged=True)
        except Exception as e:  # noqa: BLE001 — staging is best-effort but
            # never silent: the error counts and the last one shows in
            # /debug/hbm.
            pool.count_stage(errors=1, last_error=repr(e))
            job._finish_one(error=True)
