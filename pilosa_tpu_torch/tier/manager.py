"""TierManager — the node-side policy engine over the object store.

The counterpart of ``pilosa_tpu/tier/manager.py``, with its store keys,
object metadata and archive format, so that either package's node reads
what the other wrote.  It extends the residency ladder (device mirror,
local file) one level down.  A fragment has three states:

    hot        local roaring file (+ optional device mirror)
    cold       metadata resident on the View, bytes as a tar in the
               object store
    (absent)   the slice has no data in this view

and the manager drives every transition:

* **Demand hydration** (cold → hydrating → hot): first touch through
  ``View.fragment`` / ``create_fragment_if_not_exists`` fetches the
  tar (checksum-verified twice: the store's content sha256 AND the
  tar's embedded per-entry sums), restores it, and installs the
  fragment — on the prefetcher's hydrate lane, so concurrent
  hydrations are bounded and query-lane mirror warms still win, under
  the ``hydrate_throttle_mbps`` token throttle.  Each
  hydration runs inside a ``hydrate`` trace span, so it shows up in
  the slow-query log's stage breakdown.
* **LRU demotion** (hot → cold): ``disk_budget_bytes`` bounds the local
  bytes of hot fragments (the roaring file, its WAL segment and the TopN
  cache);
  past it, least-recently-touched fragments upload (if stale in the
  store) and flip to tar-only.  The flip is optimistic — a write
  racing it either aborts the demotion or revives the fragment by
  hydration; bits are never dropped (core/fragment.py
  ``mark_retired_if_version``).  A hydrated fragment's mirror uploads at
  its first read, like any other fragment's.
* **Retention** (time-quantum views): expired sub-views age to the
  store past ``retention_age_s`` and DELETE past ``retention_delete_s``
  (per-frame overrides in frame meta).
* **Bootstrap**: a node with an empty data dir and only ``tier_store``
  set restores the schema from ``schema.json`` and
  registers every stored fragment cold — it serves the full index,
  hydrating on demand.

Counters: ``tier.hydrations`` / ``tier.demotions`` /
``tier.storeBytes`` / ``tier.storeErrors`` (+ per-op store latency
summaries from tier/store.py); full state at ``GET /debug/tier``.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from datetime import datetime, timezone

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD, unlink_fragment_files
from pilosa_tpu_torch.obs.stats import NopStatsClient
from pilosa_tpu_torch.obs.trace import NOP_TRACER
from pilosa_tpu_torch.tier.store import ObjectMeta, ObjectStore, StoreError

SCHEMA_KEY = "schema.json"
FRAGMENT_PREFIX = "fragments/"

# Per-fragment state history retained for /debug/tier (the cold-boot
# test asserts the cold -> hydrating -> hot transition is visible).
_HISTORY_LIMIT = 8


class TierError(RuntimeError):
    pass


class HydrationError(TierError):
    """A cold fragment could not be hydrated from the store.  Always
    loud: the alternative is serving (or writing into) a silently
    empty fragment."""


def fragment_store_key(index: str, frame: str, view: str, slice_i: int) -> str:
    return f"{FRAGMENT_PREFIX}{index}/{frame}/{view}/{int(slice_i)}.tar"


def parse_fragment_store_key(key: str) -> tuple[str, str, str, int] | None:
    if not key.startswith(FRAGMENT_PREFIX) or not key.endswith(".tar"):
        return None
    parts = key[len(FRAGMENT_PREFIX) : -len(".tar")].split("/")
    if len(parts) != 4 or not parts[3].isdigit():
        return None
    return parts[0], parts[1], parts[2], int(parts[3])


class TierManager:
    def __init__(
        self,
        holder,
        store: ObjectStore,
        prefetcher=None,
        stats=None,
        tracer=None,
        logger=None,
        hydrate_throttle_mbps: float = 0.0,
        disk_budget_bytes: int = 0,
        retention_age_s: float = 0.0,
        retention_delete_s: float = 0.0,
    ):
        self.holder = holder
        self.store = store
        # Every hydration rides the hydrate lane: the node's prefetcher, or
        # the process's shared one.
        self.prefetcher = prefetcher or device_mod.prefetcher()
        self.stats = stats or NopStatsClient()
        self.tracer = tracer or NOP_TRACER
        self.logger = logger or (lambda msg: None)
        self.hydrate_throttle_mbps = float(hydrate_throttle_mbps)
        self.disk_budget_bytes = int(disk_budget_bytes)
        self.retention_age_s = float(retention_age_s)
        self.retention_delete_s = float(retention_delete_s)

        self._mu = threading.Lock()
        # key -> current state; key -> bounded transition history
        self._states: dict[str, str] = {}
        self._history: dict[str, list[str]] = {}
        # Hydration single-flight: key -> Event while a fetch is in
        # progress (two queries touching the same cold fragment fetch
        # once; waiters block on the Event, then re-check).
        self._inflight: dict[str, threading.Event] = {}
        # LRU clock for demotion: key -> last-touch monotonic time.
        # Written LOCK-FREE from View.fragment's hot path (a dict store
        # is GIL-atomic); fragments never touched rank oldest.
        self._touch: dict[str, float] = {}
        # Known store object sizes (key -> bytes) behind the
        # tier.storeBytes gauge; refreshed by puts/deletes/bootstrap.
        self._store_sizes: dict[str, int] = {}
        # Serializing token throttle for hydration reads.
        self._gate_mu = threading.Lock()
        self._gate = 0.0
        # Single-flight flag for the ASYNC disk-budget enforcement a
        # hydration schedules (uploads+demotions must not ride the
        # query's critical path; the budget is soft between passes,
        # like the page cache it accounts).
        self._enforcing = False

    # ------------------------------------------------------------------
    # keys / state bookkeeping
    # ------------------------------------------------------------------

    @staticmethod
    def _frag_key(frag) -> str:
        return fragment_store_key(frag.index, frag.frame, frag.view, frag.slice)

    def _view_key(self, view, slice_i: int) -> str:
        return fragment_store_key(view.index, view.frame, view.name, slice_i)

    def _set_state(self, key: str, state: str) -> None:
        with self._mu:
            self._states[key] = state
            hist = self._history.setdefault(key, [])
            if not hist or hist[-1] != state:
                hist.append(state)
                if len(hist) > _HISTORY_LIMIT:
                    del hist[0]

    def _drop_state(self, key: str) -> None:
        with self._mu:
            self._states.pop(key, None)
            self._history.pop(key, None)
        self._touch.pop(key, None)

    def touch(self, view, slice_i: int) -> None:
        """Hot-path LRU update from ``View.fragment`` — lock-free."""
        self._touch[self._view_key(view, slice_i)] = time.monotonic()

    def _note_store_size(self, key: str, size: int | None) -> None:
        with self._mu:
            if size is None:
                self._store_sizes.pop(key, None)
            else:
                self._store_sizes[key] = int(size)
            total = sum(self._store_sizes.values())
        self.stats.gauge("tier.storeBytes", float(total))

    # ------------------------------------------------------------------
    # hydration (cold -> hydrating -> hot)
    # ------------------------------------------------------------------

    def hydrate(self, view, slice_i: int):
        """Materialize a cold fragment.  Called by the View on first
        touch; rides the prefetcher's hydrate lane (query-lane mirror
        warms still pop first) and blocks its caller.  Raises
        :class:`HydrationError` on failure — never installs a silently
        empty fragment."""
        key = self._view_key(view, slice_i)
        # Capture the CALLER's span before hopping to a prefetcher
        # worker thread: the hydrate span must parent into the query's
        # trace (and its slow-query stage breakdown), and contextvars
        # don't cross the lane's worker pool.
        parent = self.tracer.current()
        return self.prefetcher.run_hydration(
            lambda: self._hydrate_sync(view, slice_i, key, parent)
        )

    def _hydrate_sync(self, view, slice_i: int, key: str, parent=None):
        while True:
            frag = view._fragment_raw(slice_i)
            if frag is not None:
                return frag  # a racing hydration won
            if view.cold_meta(slice_i) is None:
                return None  # raced a release/delete: genuinely absent
            with self._mu:
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    owner = True
                else:
                    owner = False
            if owner:
                try:
                    return self._hydrate_owner(view, slice_i, key, parent)
                finally:
                    with self._mu:
                        self._inflight.pop(key, None)
                    ev.set()
            # Another thread is fetching this key: wait it out, then
            # loop to re-check (and take over if the owner failed).
            ev.wait()

    def _hydrate_owner(self, view, slice_i: int, key: str, parent=None):
        self._set_state(key, "hydrating")
        t0 = time.monotonic()
        try:
            with self.tracer.span(
                "hydrate", parent=parent, fragment=key
            ) as sp:
                data = self.store.get(key)  # content-sha verified
                self._throttle(len(data))
                frag = view._new_fragment(slice_i)
                frag.open()
                try:
                    # read_from verifies the tar's embedded per-entry
                    # checksums before installing.
                    frag.read_from(io.BytesIO(data))
                except BaseException:
                    frag.close()
                    unlink_fragment_files(frag)
                    raise
                view.adopt_hydrated(slice_i, frag)
                sp.annotate(bytes=len(data))
        except Exception as e:
            self._set_state(key, "cold")
            self.logger(f"tier: hydration of {key} failed: {e}")
            raise HydrationError(
                f"hydration of {key} from {self.store.url} failed: {e}"
            ) from e
        self._set_state(key, "hot")
        self._touch[key] = time.monotonic()
        self.stats.count("tier.hydrations")
        self.stats.histogram(
            "tier.hydrateMs", (time.monotonic() - t0) * 1000.0
        )
        # Budget enforcement runs in the BACKGROUND (single-flight):
        # the demotions' uploads must not ride this query's critical
        # path, so the budget is soft within a pass — like the page
        # cache it accounts.
        self._schedule_enforce(protect=key)
        return frag

    def _schedule_enforce(self, protect: str | None = None) -> None:
        if self.disk_budget_bytes <= 0:
            return
        with self._mu:
            if self._enforcing:
                return
            self._enforcing = True

        def _run() -> None:
            try:
                self.enforce_disk_budget(protect=protect)
            except Exception as e:  # noqa: BLE001 — best-effort sweep
                self.logger(f"tier: background budget sweep failed: {e}")
            finally:
                with self._mu:
                    self._enforcing = False

        threading.Thread(target=_run, daemon=True, name="tier-demote").start()

    def _throttle(self, nbytes: int) -> None:
        """Serializing token throttle: hydration reads collectively
        stay under ``hydrate-throttle-mbps`` so bulk hydration cannot
        saturate the store link while the node serves."""
        rate = self.hydrate_throttle_mbps * 1e6 / 8.0
        if rate <= 0:
            return
        with self._gate_mu:
            now = time.monotonic()
            start = max(now, self._gate)
            self._gate = start + nbytes / rate
            wait = start - now
        if wait > 0:
            time.sleep(min(wait, 60.0))

    # ------------------------------------------------------------------
    # upload / demotion (hot -> cold)
    # ------------------------------------------------------------------

    def upload_fragment(self, frag) -> ObjectMeta:
        """Archive one fragment to the store (checksummed tar; the
        fragment's LOGICAL checksum travels in the object's extra
        metadata so freshness checks never download the tar)."""
        buf = io.BytesIO()
        frag.write_to(buf)
        data = buf.getvalue()
        key = self._frag_key(frag)
        meta = self.store.put(
            key, data, extra={"checksum": frag.checksum().hex()}
        )
        self._note_store_size(key, meta.size)
        return meta

    def store_fresh_meta(self, frag) -> ObjectMeta | None:
        """The store's object metadata for ``frag`` IFF its recorded
        logical checksum matches the live fragment — the rebalance
        bulk-copy uses this to ride the store instead of peer
        streams."""
        try:
            meta = self.store.get_meta(self._frag_key(frag))
        except StoreError:
            return None
        if meta is None:
            return None
        if meta.extra.get("checksum") != frag.checksum().hex():
            return None
        return meta

    def demote(self, view, slice_i: int) -> bool:
        """Flip one hot fragment to tar-only: upload (skipped when the
        store already holds a checksum-fresh copy), then optimistically
        retire+pop — aborting if a write raced the upload — and delete
        the local files.  Returns True when the fragment went cold."""
        frag = view._fragment_raw(slice_i)
        if frag is None:
            return False
        # The view may post-date bootstrap's attach_all (created by a
        # later write): a cold entry without a hydrator would read as
        # absent, so attach before flipping anything cold.
        view.hydrator = self
        key = self._view_key(view, slice_i)
        # Exclude hydration for the whole flip + file cleanup: a
        # hydration racing the window between pop and close/unlink
        # would find the file still flock'd (or have its fresh file
        # deleted from under it).  Hydrations wait on the in-flight
        # event; a key already hydrating skips this demotion round.
        with self._mu:
            if key in self._inflight:
                return False
            ev = self._inflight[key] = threading.Event()
        try:
            version = frag._version
            try:
                meta = self.store_fresh_meta(frag)
                if meta is None:
                    meta = self.upload_fragment(frag)
            except StoreError as e:
                self.stats.count("tier.demoteErrors")
                self.logger(f"tier: demotion upload of {key} failed: {e}")
                return False
            popped = view.demote_fragment(
                slice_i, meta, expect=frag, expect_version=version
            )
            if popped is None:
                # A write landed between snapshot and flip: the upload
                # is stale — stay hot, the next sweep retries.
                self.stats.count("tier.demoteRaces")
                return False
            popped.close()
            unlink_fragment_files(popped)
            self._set_state(key, "cold")
            self._touch.pop(key, None)
            self.stats.count("tier.demotions")
            return True
        finally:
            with self._mu:
                self._inflight.pop(key, None)
            ev.set()

    # -- disk budget ---------------------------------------------------

    @staticmethod
    def _fragment_local_bytes(frag) -> int:
        """On-disk bytes of one hot fragment (roaring file, WAL segment
        and TopN cache), which is what ``disk_budget_bytes`` accounts."""
        n = 0
        for path in (frag.path, frag.cache_path, frag.path + ".wal"):
            try:
                n += os.path.getsize(path)
            except OSError:
                pass
        return n

    def _iter_hot(self):
        """(view, frag) over every hot fragment in the holder."""
        for index in self.holder.indexes().values():
            for frame in index.frames().values():
                for view in frame.views().values():
                    for frag in view.fragments():
                        yield view, frag

    def local_bytes(self) -> int:
        return sum(self._fragment_local_bytes(f) for _, f in self._iter_hot())

    def enforce_disk_budget(self, protect: str | None = None) -> int:
        """Demote least-recently-touched hot fragments until local
        bytes fit ``disk-budget-bytes``.  ``protect`` exempts one key
        (the fragment a hydration just installed — demoting it back
        immediately would thrash).  Returns the number demoted."""
        if self.disk_budget_bytes <= 0:
            return 0
        entries = []
        total = 0
        for view, frag in self._iter_hot():
            nbytes = self._fragment_local_bytes(frag)
            total += nbytes
            key = self._view_key(view, frag.slice)
            entries.append(
                (self._touch.get(key, 0.0), key, view, frag.slice, nbytes)
            )
        if total <= self.disk_budget_bytes:
            return 0
        entries.sort(key=lambda e: e[0])  # LRU first
        demoted = 0
        for _t, key, view, slice_i, nbytes in entries:
            if total <= self.disk_budget_bytes:
                break
            if key == protect:
                continue
            if self.demote(view, slice_i):
                total -= nbytes
                demoted += 1
        return demoted

    # ------------------------------------------------------------------
    # retention (time-quantum views)
    # ------------------------------------------------------------------

    def _frame_retention(self, frame) -> tuple[float, float]:
        age = getattr(frame, "retention_age_s", 0.0) or self.retention_age_s
        delete = (
            getattr(frame, "retention_delete_s", 0.0)
            or self.retention_delete_s
        )
        return float(age), float(delete)

    def sweep_retention(self, now: datetime | None = None) -> dict:
        """One retention pass: time-quantum sub-views whose period
        ended more than ``retention-age-s`` ago demote to the store;
        past ``retention-delete-s`` they delete — store objects AND
        local state.  ``now`` is injectable for tests."""
        now = now or datetime.now(timezone.utc).replace(tzinfo=None)
        aged = deleted = 0
        for index in self.holder.indexes().values():
            for frame in index.frames().values():
                if not frame.time_quantum:
                    continue
                age_s, delete_s = self._frame_retention(frame)
                if age_s <= 0 and delete_s <= 0:
                    continue
                for view_name, view in sorted(frame.views().items()):
                    parsed = tq.parse_time_view(view_name)
                    if parsed is None:
                        continue
                    base, start, unit = parsed
                    if base not in (VIEW_STANDARD, VIEW_INVERSE):
                        continue
                    age = (
                        now - tq.view_period_end(start, unit)
                    ).total_seconds()
                    if delete_s > 0 and age > delete_s:
                        deleted += self._delete_view(frame, view)
                    elif age_s > 0 and age > age_s:
                        view.hydrator = self
                        for s in sorted(f.slice for f in view.fragments()):
                            if self.demote(view, s):
                                aged += 1
        if aged or deleted:
            self.logger(
                f"tier: retention sweep aged {aged} fragment(s) to the "
                f"store, deleted {deleted} past the horizon"
            )
        return {"aged": aged, "deleted": deleted}

    def _delete_view(self, frame, view) -> int:
        """Delete one expired view everywhere: store objects, cold
        registrations, local files.  Returns fragments removed."""
        slices = {f.slice for f in view.fragments()} | view.cold_slices()
        n = 0
        for s in sorted(slices):
            key = self._view_key(view, s)
            try:
                self.store.delete(key)
            except StoreError as e:
                self.logger(f"tier: store delete of {key} failed: {e}")
            self._note_store_size(key, None)
            self._set_state(key, "deleted")
            self._touch.pop(key, None)
            n += 1
        frame.delete_view(view.name)
        return n

    def sweep(self, now: datetime | None = None) -> dict:
        """The background tick: retention first (it can free budget),
        then disk-budget enforcement."""
        out = self.sweep_retention(now=now)
        out["demoted"] = self.enforce_disk_budget()
        return out

    # ------------------------------------------------------------------
    # bootstrap / backup
    # ------------------------------------------------------------------

    def put_schema(self) -> None:
        doc = {"indexes": self.holder.schema()}
        meta = self.store.put(
            SCHEMA_KEY, json.dumps(doc, sort_keys=True).encode()
        )
        self._note_store_size(SCHEMA_KEY, meta.size)

    def _restore_schema(self) -> int:
        try:
            meta = self.store.get_meta(SCHEMA_KEY)
        except StoreError:
            meta = None
        if meta is None:
            return 0
        doc = json.loads(self.store.get(SCHEMA_KEY).decode())
        n = 0
        for idx_doc in doc.get("indexes", []):
            opts = {}
            if idx_doc.get("columnLabel"):
                opts["column_label"] = idx_doc["columnLabel"]
            if idx_doc.get("timeQuantum"):
                opts["time_quantum"] = idx_doc["timeQuantum"]
            idx = self.holder.create_index_if_not_exists(
                idx_doc["name"], **opts
            )
            for f_doc in idx_doc.get("frames", []):
                frame = idx.create_frame_if_not_exists(
                    f_doc["name"],
                    row_label=f_doc.get("rowLabel"),
                    cache_type=f_doc.get("cacheType"),
                    cache_size=f_doc.get("cacheSize"),
                    inverse_enabled=f_doc.get("inverseEnabled"),
                    time_quantum=f_doc.get("timeQuantum"),
                    range_enabled=f_doc.get("rangeEnabled"),
                )
                if f_doc.get("retentionAgeS") or f_doc.get("retentionDeleteS"):
                    frame.set_options(
                        retention_age_s=f_doc.get("retentionAgeS"),
                        retention_delete_s=f_doc.get("retentionDeleteS"),
                    )
                have = {fld.name for fld in frame.bsi_fields()}
                for fld in f_doc.get("fields", []):
                    if fld["name"] not in have:
                        frame.create_field(
                            fld["name"], int(fld["min"]), int(fld["max"])
                        )
                n += 1
        return n

    def bootstrap(self) -> dict:
        """Cold-boot wiring: restore the schema from the store, then
        register every stored fragment the node does not hold locally
        as COLD (a local copy always wins — this node's op-log may be
        ahead; anti-entropy reconciles real divergence).  Also attaches
        the hydrator to every view so later demotions hydrate back."""
        frames_restored = self._restore_schema()
        cold = 0
        for meta in self.store.list(FRAGMENT_PREFIX):
            parsed = parse_fragment_store_key(meta.key)
            if parsed is None:
                continue
            index, frame_name, view_name, slice_i = parsed
            idx = self.holder.index(index)
            if idx is None:
                continue
            frame = idx.frame(frame_name)
            if frame is None:
                continue
            view = frame.view(view_name) or frame.create_view_if_not_exists(
                view_name
            )
            view.hydrator = self
            self._note_store_size(meta.key, meta.size)
            if view._fragment_raw(slice_i) is not None:
                self._set_state(meta.key, "hot")
                continue
            if view.register_cold(slice_i, meta):
                self._set_state(meta.key, "cold")
                cold += 1
        self.attach_all()
        if cold:
            self.logger(
                f"tier: registered {cold} cold fragment(s) from "
                f"{self.store.url}; hydration is on demand"
            )
        return {"frames": frames_restored, "cold": cold}

    def attach_all(self) -> None:
        """Attach the hydrator to every view (new cold entries created
        by demotion/retention need it, and ``View.fragment``'s touch
        hook feeds the LRU clock)."""
        for index in self.holder.indexes().values():
            for frame in index.frames().values():
                for view in frame.views().values():
                    view.hydrator = self

    def upload_all(self, include_schema: bool = True) -> int:
        """Archive the schema + every hot fragment to the store — the
        seeding of a store before a cold boot or a resize."""
        if include_schema:
            self.put_schema()
        n = 0
        for _view, frag in self._iter_hot():
            self.upload_fragment(frag)
            n += 1
        return n

    def restore_from_store(
        self, index: str, frame: str, view_name: str, slice_i: int
    ) -> int:
        """Target side of store-riding rebalance bulk copy: register
        the stored fragment cold and hydrate it NOW.  Returns the
        object size; raises :class:`TierError` when the store has no
        such object."""
        idx = self.holder.index(index)
        f = idx.frame(frame) if idx is not None else None
        if f is None:
            raise TierError(f"frame not found: {index}/{frame}")
        key = fragment_store_key(index, frame, view_name, slice_i)
        meta = self.store.get_meta(key)
        if meta is None:
            raise TierError(f"store holds no object for {key}")
        view = f.create_view_if_not_exists(view_name)
        view.hydrator = self
        if view._fragment_raw(slice_i) is None:
            view.register_cold(slice_i, meta)
            self._set_state(key, "cold")
        self._note_store_size(key, meta.size)
        frag = self.hydrate(view, slice_i)
        if frag is None:
            raise TierError(f"hydration of {key} resolved no fragment")
        return meta.size

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /debug/tier`` document."""
        with self._mu:
            states = dict(self._states)
            history = {k: list(v) for k, v in self._history.items()}
            store_bytes = sum(self._store_sizes.values())
        by_state: dict[str, int] = {}
        for st in states.values():
            by_state[st] = by_state.get(st, 0) + 1
        return {
            "store": self.store.snapshot(),
            "storeBytes": store_bytes,
            "diskBudgetBytes": self.disk_budget_bytes,
            "localBytes": self.local_bytes(),
            "hydrateThrottleMbps": self.hydrate_throttle_mbps,
            "retention": {
                "ageS": self.retention_age_s,
                "deleteS": self.retention_delete_s,
            },
            "countsByState": by_state,
            "fragments": {
                key: {"state": states[key], "history": history.get(key, [])}
                for key in sorted(states)
            },
        }
