"""Index — a database: a named container of frames plus column attrs.

Reference behavior (reference: index.go): column label (default
"columnID"), a default time quantum inherited by new frames, JSON
``.meta`` persistence with the keys of ``pilosa_tpu.core.index``, and a
column AttrStore at ``<index>/.data``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.attr import AttrStore
from pilosa_tpu_torch.core.frame import Frame
from pilosa_tpu_torch.core.names import ValidationError, validate_label, validate_name
from pilosa_tpu_torch.obs.stats import NopStatsClient

# reference: index.go:33-35
DEFAULT_COLUMN_LABEL = "columnID"


class IndexError_(RuntimeError):
    pass


class Index:
    def __init__(self, path: str, name: str, device: torch.device | str | None = None):
        validate_name(name)
        self.path = path
        self.name = name
        self.device = device_mod.resolve(device)
        self.placed = device_mod.placed(device)
        self.stats = NopStatsClient()  # re-tagged by its parent
        self._mu = threading.RLock()
        self._frames: dict[str, Frame] = {}
        self.column_label = DEFAULT_COLUMN_LABEL
        self.time_quantum = ""
        self.column_attr_store = AttrStore(os.path.join(path, ".data"))
        # Highest slice other nodes hold (broadcast or polled): a node
        # answers for the whole index, not only the slices it owns.
        self.remote_max_slice = 0
        self.remote_max_inverse_slice = 0
        # Called as (index, view, slice) when a view grows a new max
        # slice; wired by the server to its CreateSlice broadcast.
        self.on_create_slice = None

    # --- lifecycle (reference: index.go:134-228) ---

    @property
    def meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.path, exist_ok=True)
            self._load_meta()
            self.column_attr_store.open()
            for entry in sorted(os.listdir(self.path)):
                if not os.path.isdir(os.path.join(self.path, entry)):
                    continue
                try:
                    frame = self._new_frame(entry)
                except ValidationError:
                    continue  # skip stray dirs (reference: index.go:148-152)
                frame.open()
                self._frames[entry] = frame

    def close(self) -> None:
        with self._mu:
            self.column_attr_store.close()
            for frame in self._frames.values():
                frame.close()
            self._frames.clear()

    def _load_meta(self) -> None:
        try:
            with open(self.meta_path) as fh:
                meta = json.load(fh)
        except FileNotFoundError:
            return
        self.column_label = meta.get("columnLabel", DEFAULT_COLUMN_LABEL)
        self.time_quantum = meta.get("timeQuantum", "")

    def save_meta(self) -> None:
        with self._mu:
            os.makedirs(self.path, exist_ok=True)
            tmp = self.meta_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(
                    {"columnLabel": self.column_label, "timeQuantum": self.time_quantum},
                    fh,
                )
            os.replace(tmp, self.meta_path)

    def set_column_label(self, label: str) -> None:
        with self._mu:
            validate_label(label)
            self.column_label = label
            self.save_meta()

    def set_time_quantum(self, q: str) -> None:
        """reference: index.go:303-319"""
        with self._mu:
            self.time_quantum = tq.parse_time_quantum(q)
            self.save_meta()

    # --- frames (reference: index.go:336-435) ---

    def _new_frame(self, name: str) -> Frame:
        frame = Frame(os.path.join(self.path, name), self.name, name, device=self.placed)
        frame.on_create_slice = self.on_create_slice
        frame.stats = self.stats.with_tags(f"frame:{name}")
        return frame

    def frame(self, name: str) -> Frame | None:
        with self._mu:
            return self._frames.get(name)

    def frames(self) -> dict[str, Frame]:
        with self._mu:
            return dict(self._frames)

    def create_frame(self, name: str, **options) -> Frame:
        with self._mu:
            if name in self._frames:
                raise IndexError_(f"frame already exists: {name!r}")
            return self._create_frame(name, options)

    def create_frame_if_not_exists(self, name: str, **options) -> Frame:
        with self._mu:
            frame = self._frames.get(name)
            if frame is not None:
                return frame
            return self._create_frame(name, options)

    def _create_frame(self, name: str, options: dict) -> Frame:
        # Row label must not collide with the index's column label
        # (reference: index.go:386-388).
        row_label = options.get("row_label") or "rowID"
        if row_label == self.column_label:
            raise ValidationError("row label and column label cannot be equal")
        frame = self._new_frame(name)
        frame.open()
        opts = {k: v for k, v in options.items() if v is not None}
        # New frames inherit the index's default time quantum (reference:
        # index.go:419-424).
        if not opts.get("time_quantum") and self.time_quantum:
            opts["time_quantum"] = self.time_quantum
        if opts:
            frame.set_options(**opts)
        else:
            frame.save_meta()
        self._frames[name] = frame
        return frame

    def delete_frame(self, name: str) -> None:
        """reference: index.go:437-456"""
        with self._mu:
            frame = self._frames.pop(name, None)
            if frame is not None:
                frame.close()
                shutil.rmtree(frame.path, ignore_errors=True)

    # --- slices (reference: index.go:249-297) ---

    def max_slice(self) -> int:
        with self._mu:
            local = max((f.max_slice() for f in self._frames.values()), default=0)
            m = max(local, self.remote_max_slice)
            self.stats.gauge("maxSlice", float(m))  # reference: index.go:264
            return m

    def set_remote_max_slice(self, n: int) -> None:
        with self._mu:
            self.remote_max_slice = max(self.remote_max_slice, n)

    def max_inverse_slice(self) -> int:
        """Max inverse slice, local or learned from peers (JAX
        ``index.py:184-197``)."""
        with self._mu:
            local = max((f.max_inverse_slice() for f in self._frames.values()), default=0)
            return max(local, self.remote_max_inverse_slice)

    def set_remote_max_inverse_slice(self, n: int) -> None:
        with self._mu:
            self.remote_max_inverse_slice = max(self.remote_max_inverse_slice, n)

    def schema_dict(self) -> dict:
        with self._mu:
            return {
                "name": self.name,
                "columnLabel": self.column_label,
                "timeQuantum": self.time_quantum,
                "frames": [f.schema_dict() for _, f in sorted(self._frames.items())],
            }
