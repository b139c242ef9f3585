"""Holder — the root registry of indexes on one node.

Scans the data directory on open (reference: holder.go:72-119), offers
the Index/Frame/View/Fragment accessor chain (reference:
holder.go:175-316) and exposes the schema.  The data directory layout
is the JAX package's, so a directory one of them wrote and closed opens
in the other with identical planes.

Every fragment's device mirror lives on the holder's device, the CUDA
card unless the caller asks for the CPU.  Which mirrors are resident is
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


class Holder:
    def __init__(self, path: str, device: torch.device | str | None = None):
        self.path = path
        self.device = device_mod.resolve(device)
        self._mu = threading.RLock()
        self._indexes: dict[str, Index] = {}
        self.on_create_slice = None  # wired by the server before open()

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
        index = Index(os.path.join(self.path, name), name, device=self.device)
        index.on_create_slice = self.on_create_slice
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
        pool's budget for the holder's device, so staging never floods
        past what the pool would evict again; an unbounded pool falls
        back to 8 GiB."""
        if budget_bytes is None:
            budget_bytes = device_mod.pool().budget_bytes(self.device) or (8 << 30)
        spent = 0
        kept = []
        for frag in sorted(self._all_fragments(), key=lambda f: -f.plane_nbytes):
            if spent + frag.plane_nbytes > budget_bytes:
                continue
            spent += frag.plane_nbytes
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

    def stage_device_mirrors(self, prefetcher, budget_bytes: int | None = None):
        """Stage fragment mirrors in the BACKGROUND and return the
        prefetcher's ``StageJob`` at once: the node serves meanwhile, and
        a query's own prefetch jumps this backlog.  Order: the previous
        run's residency table, most recently used first, then every
        other fragment that fits the budget, largest planes first.  (The
        JAX package puts the slices its gossip peers report hot first;
        the port has no gossip.)"""
        frags = self._budgeted_fragments(budget_bytes)
        by_key = {self.fragment_key(f): f for f in frags}
        prev = [k for k in reversed(self.load_residency()) if k in by_key]
        ordered = [by_key[k] for k in dict.fromkeys(prev + list(by_key))]
        return prefetcher.stage(ordered)
