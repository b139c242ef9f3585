"""Holder — the root registry of indexes on one node.

Scans the data directory on open (reference: holder.go:72-119), offers
the Index/Frame/View/Fragment accessor chain (reference:
holder.go:175-316) and exposes the schema.  The data directory layout
is the JAX package's, so a directory one of them wrote and closed opens
in the other with identical planes.

Every fragment's device mirror lives on its slice's home member
(``ops/bitplane.home_device``): on a holder whose device is the CUDA card
(the default), slice ``s`` of a host with ``n`` participating cards lives
on card ``s mod n``, as in the JAX package; a CPU holder, or a host with
one card, keeps every mirror on the holder's device.  Which mirrors are resident is
the residency pool's business (``device/pool.py``); the holder persists
that set at close (``.residency.json``, the JAX package's format) and,
after a restart, stages the mirrors again in the background
(:meth:`stage_device_mirrors`), so a restarted node answers while they
upload.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.frame import Frame
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.names import ValidationError
from pilosa_tpu_torch.core.view import View
from pilosa_tpu_torch.obs.stats import NopStatsClient


class Holder:
    def __init__(self, path: str, device: torch.device | str | None = None):
        self.path = path
        self.device = device_mod.resolve(device)
        # What its children place slices by (``device.placed``): a bare
        # ``cuda`` shards them over the members, ``cuda:N`` pins them.
        self.placed = device_mod.placed(device)
        self._mu = threading.RLock()
        self._indexes: dict[str, Index] = {}
        self.on_create_slice = None  # wired by the server before open()
        # Tag-qualified stats chain down the storage hierarchy (JAX
        # ``holder.py:34-39``): index:<n>, frame:<n>, view:<n>, slice:<n>.
        # The server sets its client here before open().
        self.stats = NopStatsClient()
        self.staging_order: list[str] = []  # set by stage_device_mirrors

    # --- lifecycle ---

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.path, exist_ok=True)
            for entry in sorted(os.listdir(self.path)):
                if not os.path.isdir(os.path.join(self.path, entry)):
                    continue
                try:
                    index = self._new_index(entry)
                except ValidationError:
                    # Stray dirs (lost+found, editor backups) are skipped,
                    # not fatal (reference: holder.go:97-101).
                    continue
                index.open()
                self._indexes[entry] = index

    def close(self) -> None:
        # The residency table first: it reads the pool's entries, which
        # the fragments' close releases.
        try:
            self.save_residency()
        except OSError as e:
            print(f"holder: residency table save failed: {e}", file=sys.stderr)
        with self._mu:
            for index in self._indexes.values():
                index.close()
            self._indexes.clear()

    # --- indexes (reference: holder.go:175-257) ---

    def _new_index(self, name: str) -> Index:
        index = Index(os.path.join(self.path, name), name, device=self.placed)
        index.on_create_slice = self.on_create_slice
        index.stats = self.stats.with_tags(f"index:{name}")
        return index

    def index(self, name: str) -> Index | None:
        with self._mu:
            return self._indexes.get(name)

    def indexes(self) -> dict[str, Index]:
        with self._mu:
            return dict(self._indexes)

    def create_index(self, name: str, **options) -> Index:
        with self._mu:
            if name in self._indexes:
                raise ValueError(f"index already exists: {name!r}")
            return self._create_index(name, options)

    def create_index_if_not_exists(self, name: str, **options) -> Index:
        with self._mu:
            index = self._indexes.get(name)
            if index is not None:
                return index
            return self._create_index(name, options)

    def _create_index(self, name: str, options: dict) -> Index:
        index = self._new_index(name)
        index.open()
        if options.get("column_label"):
            index.set_column_label(options["column_label"])
        if options.get("time_quantum"):
            index.set_time_quantum(options["time_quantum"])
        index.save_meta()
        self._indexes[name] = index
        return index

    def delete_index(self, name: str) -> None:
        with self._mu:
            index = self._indexes.pop(name, None)
            if index is not None:
                index.close()
                shutil.rmtree(index.path, ignore_errors=True)

    # --- accessor chain (reference: holder.go:259-316) ---

    def frame(self, index: str, name: str) -> Frame | None:
        idx = self.index(index)
        return idx.frame(name) if idx else None

    def view(self, index: str, frame: str, name: str) -> View | None:
        f = self.frame(index, frame)
        return f.view(name) if f else None

    def fragment(self, index: str, frame: str, view: str, slice_i: int) -> Fragment | None:
        v = self.view(index, frame, view)
        return v.fragment(slice_i) if v else None

    def max_slices(self) -> dict[str, int]:
        """Per-index max slice (reference: holder.go:128-138)."""
        with self._mu:
            return {name: idx.max_slice() for name, idx in self._indexes.items()}

    def max_inverse_slices(self) -> dict[str, int]:
        """Per-index max inverse slice (JAX ``holder.py:150``)."""
        with self._mu:
            return {name: idx.max_inverse_slice() for name, idx in self._indexes.items()}

    # --- schema (reference: holder.go:151-169) ---

    def schema(self) -> list[dict]:
        with self._mu:
            return [idx.schema_dict() for _, idx in sorted(self._indexes.items())]

    # --- device residency: warming and restart staging (JAX holder.py:160-330) ---

    def _all_fragments(self) -> list:
        return [
            frag
            for index in self.indexes().values()
            for frame in index.frames().values()
            for view in frame.views().values()
            for frag in view.fragments()
        ]

    def _budgeted_fragments(self, budget_bytes: int | None) -> list:
        """Fragments whose mirrors fit ``budget_bytes``, largest planes
        first (their first query's upload hurts most).  None adopts the
        pool's budget of each fragment's home device (logical members of
        one card share it), so staging never floods past what the pool
        would evict again; an unbounded pool falls back to 8 GiB."""
        spent: dict = {}
        kept = []
        for frag in sorted(self._all_fragments(), key=lambda f: -f.plane_nbytes):
            budget = budget_bytes
            if budget is None:
                budget = device_mod.pool().budget_bytes(frag.device) or (8 << 30)
            used = spent.get(frag.device, 0)
            if used + frag.plane_nbytes > budget:
                continue
            spent[frag.device] = used + frag.plane_nbytes
            kept.append(frag)
        return kept

    def warm_device_mirrors(self, budget_bytes: int | None = None) -> int:
        """Upload every fragment's mirror now, up to ``budget_bytes`` —
        the synchronous warm; a server's restart stages in the
        background instead.  Returns the fragments warmed; failures count
        in the pool's staging errors."""
        warmed = 0
        for frag in self._budgeted_fragments(budget_bytes):
            try:
                frag.device_plane()
            except Exception as e:  # noqa: BLE001 — warming is best-effort
                device_mod.pool().count_stage(errors=1, last_error=repr(e))
                print(f"holder: mirror warm failed for {frag.path}: {e}", file=sys.stderr)
                continue
            warmed += 1
        return warmed

    def hot_slices(self, limit: int = 32) -> dict[str, list[int]]:
        """This node's hottest resident slices, ``{index: [slice, ...]}``:
        the most recently used end of the pool's mirror entries (JAX
        ``core/holder.py:209``).  Gossip carries them to peers
        (``cluster/gossip.py``'s ``hot_provider``), and a restarting peer
        stages those slices first."""
        out: dict[str, dict[int, None]] = {}
        n = 0
        for row in reversed(device_mod.pool().snapshot()["fragments"]):  # MRU first
            if row.get("kind") != "mirror" or "fragment" not in row:
                continue
            index = str(row["fragment"]).split("/", 1)[0]
            s = row.get("slice")
            if not isinstance(s, int) or self.index(index) is None:
                continue
            d = out.setdefault(index, {})
            if s not in d:
                d[s] = None
                n += 1
                if n >= limit:
                    break
        return {idx: list(d) for idx, d in out.items()}

    def _residency_path(self) -> str:
        return os.path.join(self.path, ".residency.json")

    @staticmethod
    def fragment_key(frag) -> str:
        return f"{frag.index}/{frag.frame}/{frag.view}/{frag.slice}"

    def save_residency(self) -> int:
        """Write which of this holder's fragments hold mirrors, in the
        pool's LRU -> MRU order — the staging order a restarted node
        replays, most recently used first.  Written atomically; returns
        the fragments recorded."""
        mine = {self.fragment_key(f) for f in self._all_fragments()}
        resident = [
            row["fragment"]
            for row in device_mod.pool().snapshot()["fragments"]
            if row.get("kind") == "mirror" and row.get("fragment") in mine
        ]
        path = self._residency_path()
        tmp = path + ".tmp"
        os.makedirs(self.path, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"fragments": resident}, f)
        os.replace(tmp, path)
        return len(resident)

    def load_residency(self) -> list[str]:
        """The previous run's resident fragment keys (LRU -> MRU); [] when
        none was written or it does not parse."""
        try:
            with open(self._residency_path()) as f:
                doc = json.load(f)
            return [str(s) for s in doc.get("fragments", [])]
        except (OSError, ValueError):
            return []

    def stage_device_mirrors(
        self,
        prefetcher,
        hot_slices: dict[str, list[int]] | None = None,
        budget_bytes: int | None = None,
        tracer=None,
        throttle_s: float = 0.0,
    ):
        """Stage fragment mirrors in the BACKGROUND and return the
        prefetcher's ``StageJob`` at once: the node serves meanwhile, and
        a query's own prefetch jumps this backlog.  Order (JAX
        ``core/holder.py:274-320``): the fragments of ``hot_slices``
        (``{index: [slice, ...]}``, what gossip peers report they are
        being asked about, in their order), then the previous run's
        residency table, most recently used first, then every other
        fragment that fits the budget, largest planes first.  With a
        ``tracer``, a root ``staging`` trace spans the whole drain and is
        finalized, with the job's outcome, when it completes.
        ``throttle_s`` sleeps before each upload of the job."""
        frags = self._budgeted_fragments(budget_bytes)
        by_key = {self.fragment_key(f): f for f in frags}
        prev = [k for k in reversed(self.load_residency()) if k in by_key]
        hot_keys: list[str] = []
        for index, slices in (hot_slices or {}).items():
            by_slice: dict[int, list[str]] = {}
            for k, f in by_key.items():
                if f.index == index:
                    by_slice.setdefault(f.slice, []).append(k)
            for s in slices:
                hot_keys += by_slice.get(s, [])
        order = list(dict.fromkeys(hot_keys + prev + list(by_key)))
        self.staging_order = order  # which fragments a restart staged first
        ordered = [by_key[k] for k in order]
        job = prefetcher.stage(ordered, throttle_s=throttle_s)
        if tracer is not None:
            root = tracer.start_trace(
                "staging", fragments=len(ordered), hot=len(hot_keys),
                from_residency_table=len(prev)
            )

            def _finish():
                job.wait()
                root.annotate(**job.snapshot())
                tracer.finish_root(root)

            threading.Thread(target=_finish, daemon=True, name="staging-trace").start()
        return job
