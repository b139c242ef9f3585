"""Holder — the root registry of indexes on one node.

Scans the data directory on open (reference: holder.go:72-119), offers
the Index/Frame/View/Fragment accessor chain (reference:
holder.go:175-316) and exposes the schema.  The data directory layout
is the JAX package's, so a directory one of them wrote and closed opens
in the other with identical planes.

Every fragment's device mirror lives on the holder's device, the CUDA
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import shutil
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

