"""PlanePool — the device-memory residency manager.

The counterpart of ``pilosa_tpu/device/pool.py``.  Every device tensor
the port keeps alive across queries registers here, in three categories:
fragment plane mirrors (``Fragment.device_plane``, ``"mirror"``), each
fragment's paged sparse-row payloads (``"sparse"``), and the executor's
cached batches (``"cache"``: each entry's row-address table and the
scratch rows it owns; the dense rows it names stay the mirrors').  The pool keeps per-device byte accounting against a budget
(``[device] hbm-budget-bytes``, ``Server(hbm_budget_bytes=...)``) and
reclaims by LRU eviction of unpinned entries whenever an admission
would pass it.  The budget is per physical device (JAX
``device/pool.py:31,139``): a fragment admits its bytes on its home
device (``ops/bitplane.home_device``), so the logical members of one
card share that card's budget, and ``/debug/hbm`` lists each device.
Eviction is free of correctness cost because the host
numpy plane is authoritative: an evicted mirror re-uploads at the next
read.

Design points, as in the JAX package:

* **Admission before upload.**  Owners call :meth:`admit` BEFORE the
  copy to the device, so accounted residency never passes the budget
  (except in pinned saturation, which is counted in ``overBudget``,
  never hidden).
* **Pin leases.**  The executor pins the entries a launch reads from
  before the launch until its result is fetched; pinned entries are
  never victims.  In the port an open lease (:meth:`pinned`) also pins
  every entry that its thread admits or touches while it is open: a
  query's mirrors are pinned under their fragment's lock, the moment
  they are found or uploaded, so none can be evicted between its
  upload and the launch that reads it.  (A torch tensor lives as long
  as someone holds it: an eviction only drops the fragment's
  reference.  Without the pin, a launch's memory would outlive its
  accounting.)
* **Non-blocking evict callbacks.**  A callback clears the owner's
  device reference under the OWNER's lock, but owners call into the
  pool while holding that lock (``device_plane`` admits under the
  fragment lock).  So callbacks take the owner's lock with
  ``blocking=False`` and return False when they lose the race; the pool
  skips that victim (it is in use) and moves to the next.  The pool's
  own lock is reentrant, so a callback may call :meth:`remove`.
* **LRU order** is insertion and touch order; :meth:`touch` on a hit
  moves an entry to the MRU end.
* **Saturation ends** (a port addition): the JAX pool evicts only when
  something is admitted, so a device pushed past its budget by pinned
  or busy tenants stays there until the next admission.  The port's
  pool evicts back to the budget (:meth:`reclaim`) when the outermost
  pin lease of a thread closes, when a fragment's upload completes and
  when the prefetcher runs out of work — the moments a pin or a busy
  owner lets go.  The explicit admit/touch/pin/unpin/remove calls
  behave as the JAX pool's.

Budget, per device: an explicit positive ``configure`` value, else the
``PILOSA_DEVICE_HBM_BUDGET_BYTES`` environment variable, else
``DEFAULT_BUDGET_FRACTION`` of a CUDA device's memory
(``torch.cuda.mem_get_info``), else unbounded — which is what a CPU
device gets, so tests never evict unless they set a budget.

The counters live in the pool and :meth:`snapshot` reports them (``GET
/debug/hbm``); with a stats client and a tracer (``configure``, as the
server does) the pool also emits the JAX package's ``device.evictions``,
``device.evictSkipped``, ``device.overBudget``, ``device.prefetch.*``,
``device.stage.*`` and ``device.pool.restageBytes`` counters and the
``device.residentBytes`` / ``device.cacheBytes`` gauges, always after its
lock is released, and an ``evict`` span around an admission's evictions.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from collections.abc import Callable
from dataclasses import dataclass, field

import torch

from pilosa_tpu_torch.obs import trace
from pilosa_tpu_torch.obs.stats import NopStatsClient

# Detected budget = this fraction of the device's memory: headroom for
# launch outputs, scratch and the caching allocator's rounding, none of
# which registers with the pool.
DEFAULT_BUDGET_FRACTION = 0.8

ENV_BUDGET = "PILOSA_DEVICE_HBM_BUDGET_BYTES"


def _device_label(dev) -> str:
    """Printable identity of a device key: ``cuda:0`` / ``cpu`` for a
    torch device (any other key prints as itself)."""
    return str(dev)


@dataclass
class _Entry:
    key: tuple
    bytes_by_device: dict
    evict: Callable[[], bool]
    category: str  # "mirror" | "sparse" | "cache"
    info: dict = field(default_factory=dict)
    pins: int = 0

    @property
    def nbytes(self) -> int:
        return sum(self.bytes_by_device.values())


class PlanePool:
    """Per-device byte accounting and LRU eviction for long-lived device
    tensors.  Thread-safe; one instance serves the process
    (``pilosa_tpu_torch.device.pool()``)."""

    def __init__(self, budget_bytes: int = 0, stats=None, tracer=None):
        # Reentrant: evict callbacks may call remove()/resize() back into
        # the pool from under _mu.
        self._mu = threading.RLock()
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._resident: dict = {}  # device -> bytes
        self._pinned: dict = {}  # device -> bytes held by pinned entries
        self._max_resident: dict = {}  # device -> high-water bytes
        self._cat_bytes: dict[str, int] = {}
        self._evictions = 0
        self._evict_skipped = 0
        self._over_budget = 0
        self._prefetch_hits = 0
        self._prefetch_misses = 0
        # Restart staging (core/holder.stage_device_mirrors and
        # device/prefetch.py): scheduled/done/error counts, bytes staged
        # and the last error, surfaced in /debug/hbm.
        self._stage_scheduled = 0
        self._stage_done = 0
        self._stage_errors = 0
        self._stage_bytes = 0
        self._stage_last_error: str | None = None
        # Full mirror (re)uploads through Fragment.device_plane.
        self._restage_uploads = 0
        self._restage_bytes = 0
        # 0 = auto (env -> detect -> unbounded); > 0 = explicit bytes.
        self._budget = int(budget_bytes or 0)
        self._detected: dict = {}
        # The open pin leases of each thread, outermost first.
        self._leases = threading.local()
        self.stats = stats or NopStatsClient()
        self.tracer = tracer or trace.NOP_TRACER
        self._dev_stats: dict = {}  # device -> tagged stats child

    # ------------------------------------------------------------------
    # configuration / budget
    # ------------------------------------------------------------------

    def configure(self, budget_bytes: int | None = None, stats=None, tracer=None) -> None:
        """Server wiring: the budget from its settings (0 = auto), and the
        stats client and tracer (None keeps the current ones)."""
        with self._mu:
            if budget_bytes is not None:
                self._budget = int(budget_bytes)
            if stats is not None:
                self.stats = stats
                self._dev_stats = {}
            if tracer is not None:
                self.tracer = tracer

    def budget_bytes(self, dev=None) -> int:
        """The effective budget of device ``dev`` (the current CUDA
        device, or none, when omitted); 0 means unbounded."""
        if self._budget > 0:
            return self._budget
        raw = os.environ.get(ENV_BUDGET, "")
        if raw:
            try:
                v = int(raw)
                if v > 0:
                    return v
            except ValueError:
                pass
        return self._detect_budget(dev)

    def _detect_budget(self, dev) -> int:
        if dev is None:
            if not torch.cuda.is_available():
                return 0
            dev = torch.device("cuda", torch.cuda.current_device())
        if not isinstance(dev, torch.device) or dev.type != "cuda":
            return 0
        got = self._detected.get(dev)
        if got is None:
            total = torch.cuda.mem_get_info(dev)[1]
            got = self._detected[dev] = int(total * DEFAULT_BUDGET_FRACTION)
        return got

    # ------------------------------------------------------------------
    # tenant lifecycle
    # ------------------------------------------------------------------

    def admit(
        self,
        key: tuple,
        bytes_by_device: dict,
        evict: Callable[[], bool],
        category: str = "mirror",
        info: dict | None = None,
    ) -> None:
        """Register (or re-register with new bytes) an entry, evicting
        LRU unpinned entries first so that every touched device stays
        within its budget.  Call BEFORE the device allocation; on a
        failed upload call :meth:`remove`.  Re-admission keeps pins."""
        need = {d: int(n) for d, n in bytes_by_device.items() if n}
        budgets = {d: self.budget_bytes(d) for d in need}
        # Stats go out after the critical section: a stats backend must
        # never lengthen the pool lock's hold.
        n_ev = n_skip = 0
        over_budget = False
        with self._mu:
            # A re-admitted entry keeps its identity (and so its pins and
            # the leases that hold them); it moves to the MRU end.
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._debit(ent)
            if any(b and self._resident.get(d, 0) + need[d] > b for d, b in budgets.items()):
                with self.tracer.span("evict", trigger=category) as sp:
                    n_ev, n_skip = self._evict_for_locked(need, budgets, key)
                    sp.annotate(evicted=n_ev)
                self._evictions += n_ev
            if ent is None:
                ent = _Entry(key=key, bytes_by_device=need, evict=evict, category=category,
                             info=dict(info or {}))
            else:
                ent.bytes_by_device, ent.evict = need, evict
                ent.category, ent.info = category, dict(info or {})
            lease = self._outer_lease()
            if lease is not None and lease.hold(ent):
                ent.pins += 1
            self._entries[key] = ent
            self._credit(ent)
            if any(b and self._resident.get(d, 0) > b for d, b in budgets.items()):
                # Every other tenant of the device was pinned (or its
                # owner busy): correctness before the budget, but the
                # breach is counted.
                self._over_budget += 1
                over_budget = True
            gauges = self._gauges_locked(need)
        self._emit_evictions(n_ev, n_skip, over_budget)
        self._publish(gauges)

    def _emit_evictions(self, n_ev: int, n_skip: int, over_budget: bool = False) -> None:
        if n_ev:
            self.stats.count("device.evictions", n_ev)
        if n_skip:
            self.stats.count("device.evictSkipped", n_skip)
        if over_budget:
            self.stats.count("device.overBudget")

    def _dev_stat(self, dev):
        # Outside _mu; a racing create stores two equal children — benign.
        c = self._dev_stats.get(dev)
        if c is None:
            c = self.stats.with_tags(f"device:{_device_label(dev)}")
            self._dev_stats[dev] = c
        return c

    def _gauges_locked(self, devices) -> list:
        """The gauge values for ``devices``, read under ``_mu`` and
        published by :meth:`_publish` after it is released."""
        out = [(d, "device.residentBytes", float(self._resident.get(d, 0))) for d in devices]
        out.append((None, "device.cacheBytes", float(self._cat_bytes.get("cache", 0))))
        return out

    def _publish(self, gauges) -> None:
        for dev, name, value in gauges:
            client = self.stats if dev is None else self._dev_stat(dev)
            client.gauge(name, value)

    def touch(self, key: tuple) -> None:
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                return
            self._entries.move_to_end(key)
            lease = self._outer_lease()
            if lease is not None and lease.hold(ent):
                self._pin_locked(ent)

    def resize(self, key: tuple, bytes_by_device: dict, info: dict | None = None) -> None:
        """Update an entry's bytes in place (the sparse-row cache growing
        or shrinking) without moving it in the LRU order or evicting;
        ``info``, when given, replaces the entry's annotations."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                return
            self._debit(ent)
            ent.bytes_by_device = {d: int(n) for d, n in bytes_by_device.items() if n}
            if info is not None:
                ent.info = dict(info)
            self._credit(ent)

    def remove(self, key: tuple) -> None:
        with self._mu:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._debit(ent)

    def contains(self, key: tuple) -> bool:
        with self._mu:
            return key in self._entries

    # ------------------------------------------------------------------
    # pin leases
    # ------------------------------------------------------------------

    def _pin_locked(self, ent: _Entry) -> None:
        ent.pins += 1
        if ent.pins == 1:
            for d, n in ent.bytes_by_device.items():
                self._pinned[d] = self._pinned.get(d, 0) + n

    def _unpin_locked(self, ent: _Entry) -> None:
        if ent.pins == 0:
            return
        ent.pins -= 1
        if ent.pins == 0:
            for d, n in ent.bytes_by_device.items():
                self._pinned[d] = max(0, self._pinned.get(d, 0) - n)

    def pin(self, key: tuple) -> bool:
        """Take a pin on an entry; False when it is not resident."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                return False
            self._pin_locked(ent)
            return True

    def unpin(self, key: tuple) -> None:
        with self._mu:
            ent = self._entries.get(key)
            if ent is not None:
                self._unpin_locked(ent)

    def pin_many(self, keys) -> list:
        """Pin every present key under ONE lock acquisition; returns the
        keys pinned, for the matching :meth:`unpin_many`."""
        held = []
        with self._mu:
            for k in keys:
                if k is None:
                    continue
                ent = self._entries.get(k)
                if ent is None:
                    continue
                self._pin_locked(ent)
                held.append(k)
        return held

    def unpin_many(self, keys) -> None:
        with self._mu:
            for k in keys:
                ent = self._entries.get(k)
                if ent is not None:
                    self._unpin_locked(ent)

    class _PinLease:
        def __init__(self, pool: "PlanePool", keys):
            self._pool = pool
            self._keys = keys
            self._held: list = []  # the entries this lease pinned
            self._ids: set = set()

        def hold(self, ent: _Entry) -> bool:
            """Record that this lease pins ``ent`` (the pool's lock is
            held); False when it already does."""
            if id(ent) in self._ids:
                return False
            self._ids.add(id(ent))
            self._held.append(ent)
            return True

        def __enter__(self):
            # One lock acquisition however many keys the launch pins.
            pool = self._pool
            with pool._mu:
                for k in self._keys:
                    ent = pool._entries.get(k) if k is not None else None
                    if ent is not None and self.hold(ent):
                        pool._pin_locked(ent)
            pool._lease_stack().append(self)
            return self

        def __exit__(self, *exc):
            pool = self._pool
            stack = pool._lease_stack()
            stack.remove(self)
            with pool._mu:
                for ent in self._held:
                    # A removed entry took its pins with it (_debit).
                    if pool._entries.get(ent.key) is ent:
                        pool._unpin_locked(ent)
            if not stack:
                # What the thread held, or its locks that made owners
                # look busy, may have kept a device past its budget.
                pool.reclaim()

    def pinned(self, *keys) -> "PlanePool._PinLease":
        """Context manager pinning every present key for the block, and
        every entry its thread admits or touches meanwhile (the
        outermost open lease of the thread holds those).  None keys are
        skipped."""
        return PlanePool._PinLease(self, keys)

    def _lease_stack(self) -> list:
        stack = getattr(self._leases, "stack", None)
        if stack is None:
            stack = self._leases.stack = []
        return stack

    def _outer_lease(self):
        stack = getattr(self._leases, "stack", None)
        return stack[0] if stack else None

    def reclaim(self, exclude_key=None) -> int:
        """Evict LRU unpinned entries (``exclude_key`` spared) of every
        device past its budget until it is within it, or no victim is
        left; returns the evictions.  The callbacks take their owners'
        locks non-blocking, so a caller may hold a fragment lock (its
        own fragment's entries should then be spared)."""
        with self._mu:
            devs = list(self._resident)
        budgets = {d: self.budget_bytes(d) for d in devs}
        n = skipped = 0
        with self._mu:
            for d, b in budgets.items():
                if b and self._resident.get(d, 0) > b:
                    ev, sk = self._evict_for_locked({d: 0}, {d: b}, exclude_key)
                    n += ev
                    skipped += sk
            self._evictions += n
        self._emit_evictions(n, skipped)
        return n

    # ------------------------------------------------------------------
    # eviction (callers hold _mu)
    # ------------------------------------------------------------------

    def _evict_for_locked(self, need: dict, budgets: dict, exclude_key) -> tuple:
        """Returns ``(evicted, skipped)``."""
        evicted = 0
        skipped = 0
        for k in list(self._entries.keys()):
            if all(not budgets[d] or self._resident.get(d, 0) + n <= budgets[d]
                   for d, n in need.items()):
                break
            if k == exclude_key:
                continue
            ent = self._entries.get(k)
            if ent is None or ent.pins > 0:
                continue
            # Only an entry on a device of the need makes room.
            if not any(d in need for d in ent.bytes_by_device):
                continue
            try:
                ok = bool(ent.evict())
            except Exception:  # noqa: BLE001 — a broken owner must not wedge
                ok = True  # the pool; drop the accounting.
            if ok:
                # The callback may have re-entered remove() itself.
                ent2 = self._entries.pop(k, None)
                if ent2 is not None:
                    self._debit(ent2)
                evicted += 1
            else:
                self._evict_skipped += 1
                skipped += 1
        return evicted, skipped

    # ------------------------------------------------------------------
    # accounting (callers hold _mu)
    # ------------------------------------------------------------------

    def _credit(self, ent: _Entry) -> None:
        for d, n in ent.bytes_by_device.items():
            r = self._resident.get(d, 0) + n
            self._resident[d] = r
            if r > self._max_resident.get(d, 0):
                self._max_resident[d] = r
            if ent.pins > 0:
                self._pinned[d] = self._pinned.get(d, 0) + n
        self._cat_bytes[ent.category] = self._cat_bytes.get(ent.category, 0) + ent.nbytes

    def _debit(self, ent: _Entry) -> None:
        for d, n in ent.bytes_by_device.items():
            self._resident[d] = max(0, self._resident.get(d, 0) - n)
            if ent.pins > 0:
                self._pinned[d] = max(0, self._pinned.get(d, 0) - n)
        self._cat_bytes[ent.category] = max(0, self._cat_bytes.get(ent.category, 0) - ent.nbytes)

    # ------------------------------------------------------------------
    # prefetch and staging bookkeeping (device/prefetch.py, core/holder.py)
    # ------------------------------------------------------------------

    def count_prefetch(self, hit: int = 0, miss: int = 0) -> None:
        with self._mu:
            self._prefetch_hits += hit
            self._prefetch_misses += miss
        if hit:
            self.stats.count("device.prefetch.hit", hit)
        if miss:
            self.stats.count("device.prefetch.miss", miss)

    def count_stage(self, scheduled: int = 0, done: int = 0, errors: int = 0,
                    nbytes: int = 0, last_error: str | None = None) -> None:
        with self._mu:
            self._stage_scheduled += scheduled
            self._stage_done += done
            self._stage_errors += errors
            self._stage_bytes += nbytes
            if last_error is not None:
                self._stage_last_error = str(last_error)
        for name, n in (("scheduled", scheduled), ("done", done), ("errors", errors),
                        ("bytes", nbytes)):
            if n:
                self.stats.count(f"device.stage.{name}", n)

    def count_restage(self, nbytes: int) -> None:
        """One full plane upload through ``Fragment.device_plane``."""
        with self._mu:
            self._restage_uploads += 1
            self._restage_bytes += int(nbytes)
        if nbytes:
            self.stats.count("device.pool.restageBytes", int(nbytes))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def evictions(self) -> int:
        return self._evictions

    def resident_bytes(self, dev=None) -> int:
        with self._mu:
            if dev is not None:
                return self._resident.get(dev, 0)
            return sum(self._resident.values())

    def max_resident_bytes(self, dev=None) -> int:
        with self._mu:
            if dev is not None:
                return self._max_resident.get(dev, 0)
            return max(self._max_resident.values(), default=0)

    def counters(self) -> dict:
        """The eviction, prefetch and restage counters (as in
        :meth:`snapshot`)."""
        with self._mu:
            return {
                "evictions": self._evictions,
                "evictSkipped": self._evict_skipped,
                "overBudget": self._over_budget,
                "prefetchHit": self._prefetch_hits,
                "prefetchMiss": self._prefetch_misses,
                "restageUploads": self._restage_uploads,
                "restageBytes": self._restage_bytes,
            }

    def snapshot(self) -> dict:
        """JSON-ready state for ``GET /debug/hbm``, with the JAX
        package's keys: per-device budget / resident / pinned /
        high-water bytes with each device's entries (LRU -> MRU), a
        per-fragment residency table, and the counters."""
        budget = self.budget_bytes()
        with self._mu:
            per_dev: dict = {}
            fragments: list[dict] = []
            resident_total = 0
            logical_total = 0
            for ent in self._entries.values():  # LRU -> MRU
                # Compressed sparse payloads annotate the dense bytes they
                # replace (info["logical_bytes"]).
                logical = int(ent.info.get("logical_bytes", ent.nbytes))
                resident_total += ent.nbytes
                logical_total += logical
                row = {
                    "kind": ent.category,
                    "bytes": ent.nbytes,
                    "logical_bytes": logical,
                    "pinned": ent.pins > 0,
                }
                row.update(ent.info)
                for d, n in ent.bytes_by_device.items():
                    dd = per_dev.setdefault(d, {
                        "device": _device_label(d),
                        "budget_bytes": self.budget_bytes(d),
                        "resident_bytes": self._resident.get(d, 0),
                        "pinned_bytes": self._pinned.get(d, 0),
                        "max_resident_bytes": self._max_resident.get(d, 0),
                        "entries": [],
                    })
                    dd["entries"].append(dict(row, bytes=n))
                if "fragment" in ent.info:
                    fragments.append(dict(
                        row, devices=[_device_label(d) for d in ent.bytes_by_device]))
            return {
                "budget_bytes": budget,
                "cache_bytes": self._cat_bytes.get("cache", 0),
                "resident_bytes": resident_total,
                "logical_bytes": logical_total,
                "compression_ratio": round(logical_total / resident_total, 3)
                if resident_total else 1.0,
                "devices": sorted(per_dev.values(), key=lambda d: d["device"]),
                "fragments": fragments,
                "counters": self.counters(),
                # Restart staging progress: a restarted node serves while
                # this drains toward scheduled == done + errors.
                "staging": {
                    "scheduled": self._stage_scheduled,
                    "done": self._stage_done,
                    "errors": self._stage_errors,
                    "pending": max(0, self._stage_scheduled - self._stage_done
                                   - self._stage_errors),
                    "bytes": self._stage_bytes,
                    "last_error": self._stage_last_error,
                },
            }
