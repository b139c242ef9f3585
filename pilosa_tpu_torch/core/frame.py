"""Frame — a named row namespace inside an index.

Reference behavior (reference: frame.go): row label (default "rowID"),
TopN cache type and size, JSON ``.meta`` persistence with the same keys
as ``pilosa_tpu.core.frame`` (so either package opens the other's data
directory), a row AttrStore at ``<frame>/.data``, and views under
``views/``: the standard view, one generated view per time-quantum unit
(``set_bit`` with a time and ``import_bulk`` with timestamps write them,
reference: frame.go:443-483,527-604), and a ``field_<name>`` view per
BSI integer field of a range-enabled frame (``create_field``,
``import_value``; JAX ``frame.py:196-267``), and with ``inverseEnabled``
the inverse view: every bit (row, column) is also stored transposed, as
(column, row) in inverse slice ``row // SLICE_WIDTH`` (``set_bit`` /
``clear_bit`` on the inverse view, and the fan-out of ``import_bulk``;
JAX ``frame.py:322, 360-405``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from datetime import datetime

import numpy as np
import torch

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core import fragment as fragment_mod
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.attr import AttrStore
from pilosa_tpu_torch.core.names import ValidationError, validate_label, validate_name
from pilosa_tpu_torch.core.view import (
    VIEW_INVERSE,
    VIEW_STANDARD,
    View,
    is_inverse_view,
    is_valid_view,
)
from pilosa_tpu_torch.obs.stats import NopStatsClient
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH, np_group_by

# reference: frame.go:40-46
DEFAULT_ROW_LABEL = "rowID"
DEFAULT_CACHE_TYPE = cache_mod.TYPE_RANKED
DEFAULT_CACHE_SIZE = cache_mod.DEFAULT_CACHE_SIZE


class FrameError(RuntimeError):
    pass


class Frame:
    def __init__(
        self, path: str, index: str, name: str, device: torch.device | str | None = None
    ):
        validate_name(name)
        self.path = path
        self.index = index
        self.name = name
        self.device = device_mod.resolve(device)
        self.placed = device_mod.placed(device)
        self.stats = NopStatsClient()  # re-tagged by its parent
        self._mu = threading.RLock()
        self._views: dict[str, View] = {}
        self.row_label = DEFAULT_ROW_LABEL
        self.cache_type = DEFAULT_CACHE_TYPE
        self.cache_size = DEFAULT_CACHE_SIZE
        self.inverse_enabled = False
        self.time_quantum = ""
        self.range_enabled = False
        self.retention_age_s = 0.0
        self.retention_delete_s = 0.0
        # BSI integer fields, each stored in its own field_<name> view.
        self._fields: dict[str, bsi.BSIField] = {}
        self.on_create_slice = None  # wired by Index
        self.row_attr_store = AttrStore(os.path.join(path, ".data"))

    # --- lifecycle (reference: frame.go:218-334) ---

    @property
    def meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.path, exist_ok=True)
            self._load_meta()
            self.row_attr_store.open()
            views_path = os.path.join(self.path, "views")
            os.makedirs(views_path, exist_ok=True)
            for entry in sorted(os.listdir(views_path)):
                view = self._new_view(entry)
                view.open()
                self._views[entry] = view

    def close(self) -> None:
        with self._mu:
            self.row_attr_store.close()
            for view in self._views.values():
                view.close()
            self._views.clear()

    def _load_meta(self) -> None:
        try:
            with open(self.meta_path) as fh:
                meta = json.load(fh)
        except FileNotFoundError:
            return
        self.row_label = meta.get("rowLabel", DEFAULT_ROW_LABEL)
        self.cache_type = meta.get("cacheType", DEFAULT_CACHE_TYPE)
        self.cache_size = meta.get("cacheSize", DEFAULT_CACHE_SIZE)
        self.inverse_enabled = meta.get("inverseEnabled", False)
        self.time_quantum = meta.get("timeQuantum", "")
        self.range_enabled = meta.get("rangeEnabled", False)
        self.retention_age_s = float(meta.get("retentionAgeS", 0.0))
        self.retention_delete_s = float(meta.get("retentionDeleteS", 0.0))
        self._fields = {
            f["name"]: bsi.BSIField(name=f["name"], min=int(f["min"]), max=int(f["max"]))
            for f in meta.get("fields", [])
        }

    def _meta(self) -> dict:
        return {
            "rowLabel": self.row_label,
            "cacheType": self.cache_type,
            "cacheSize": self.cache_size,
            "inverseEnabled": self.inverse_enabled,
            "timeQuantum": self.time_quantum,
            "rangeEnabled": self.range_enabled,
            "retentionAgeS": self.retention_age_s,
            "retentionDeleteS": self.retention_delete_s,
            "fields": [self._fields[n].to_dict() for n in sorted(self._fields)],
        }

    def save_meta(self) -> None:
        with self._mu:
            os.makedirs(self.path, exist_ok=True)
            tmp = self.meta_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self._meta(), fh)
            os.replace(tmp, self.meta_path)

    def set_options(
        self,
        row_label: str | None = None,
        cache_type: str | None = None,
        cache_size: int | None = None,
        inverse_enabled: bool | None = None,
        time_quantum: str | None = None,
        range_enabled: bool | None = None,
        retention_age_s: float | None = None,
        retention_delete_s: float | None = None,
    ) -> None:
        with self._mu:
            if row_label is not None:
                validate_label(row_label)
                self.row_label = row_label
            if cache_type is not None:
                if cache_type not in (cache_mod.TYPE_RANKED, cache_mod.TYPE_LRU):
                    raise ValidationError(f"invalid cache type: {cache_type!r}")
                self.cache_type = cache_type
            if cache_size is not None:
                self.cache_size = cache_size
            if inverse_enabled is not None:
                self.inverse_enabled = inverse_enabled
            if time_quantum is not None:
                self.time_quantum = tq.parse_time_quantum(time_quantum)
                # The quantum decides which time views a Range() reads:
                # epoch-validated read caches must notice.
                fragment_mod.bump_write_epoch()
            if range_enabled is not None:
                self.range_enabled = range_enabled
            if retention_age_s is not None:
                if float(retention_age_s) < 0:
                    raise ValidationError("retention age must be >= 0")
                self.retention_age_s = float(retention_age_s)
            if retention_delete_s is not None:
                if float(retention_delete_s) < 0:
                    raise ValidationError("retention delete must be >= 0")
                self.retention_delete_s = float(retention_delete_s)
            self.save_meta()

    def set_time_quantum(self, q: str) -> None:
        """reference: frame.go:397-414 (JAX ``core/frame.py:186``).  The
        quantum decides which time views a ``Range()`` reads, so the write
        epoch moves: a batch built before the change is not served after
        it."""
        with self._mu:
            self.time_quantum = tq.parse_time_quantum(q)
            self.save_meta()
        fragment_mod.bump_write_epoch()

    # --- views (reference: frame.go:336-395) ---

    def _new_view(self, name: str) -> View:
        view = View(
            os.path.join(self.path, "views", name),
            self.index,
            self.name,
            name,
            device=self.placed,
            cache_type=self.cache_type,
            cache_size=self.cache_size,
            row_attr_store=self.row_attr_store,
            on_create_slice=self.on_create_slice,
        )
        view.stats = self.stats.with_tags(f"view:{name}")
        return view

    def view(self, name: str) -> View | None:
        with self._mu:
            return self._views.get(name)

    def views(self) -> dict[str, View]:
        with self._mu:
            return dict(self._views)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._mu:
            v = self._views.get(name)
            if v is None:
                v = self._new_view(name)
                v.open()
                self._views[name] = v
            return v

    def delete_view(self, name: str) -> None:
        with self._mu:
            v = self._views.pop(name, None)
            if v is not None:
                v.close()
                shutil.rmtree(v.path, ignore_errors=True)

    # --- BSI integer fields (JAX frame.py:196-267) ---

    def bsi_field(self, name: str) -> bsi.BSIField | None:
        with self._mu:
            return self._fields.get(name)

    def bsi_fields(self) -> list[bsi.BSIField]:
        with self._mu:
            return [self._fields[n] for n in sorted(self._fields)]

    def create_field(self, name: str, min: int, max: int) -> bsi.BSIField:
        """Declare an integer field.  Requires ``rangeEnabled``; the
        ``field_<name>`` view and its fragments materialize on the first
        value import."""
        with self._mu:
            if not self.range_enabled:
                raise FrameError("frame does not support range queries")
            if name in self._fields:
                raise FrameError(f"field already exists: {name!r}")
            bsi.validate_field(name, min, max)
            fld = bsi.BSIField(name=name, min=int(min), max=int(max))
            self._fields[name] = fld
            self.save_meta()
        return fld

    def delete_field(self, name: str) -> None:
        with self._mu:
            fld = self._fields.pop(name, None)
            if fld is None:
                raise FrameError(f"field not found: {name!r}")
            self.save_meta()
        self.delete_view(bsi.field_view_name(name))

    def import_value(self, field: str, column_ids, values) -> None:
        """Columnar integer import: one value per column, grouped by
        slice, each slice written as ONE set+clear pass over the field
        view's planes (``Fragment.import_bulk``), so a re-imported
        column's previous value is fully overwritten."""
        with self._mu:
            fld = self._fields.get(field)
        if fld is None:
            raise FrameError(f"field not found: {field!r}")
        cols = np.asarray(column_ids, dtype=np.int64)
        if len(cols) == 0:
            return
        set_r, set_c, clr_r, clr_c = bsi.value_bit_rows(fld, cols, values)
        view = self.create_view_if_not_exists(fld.view)
        # Both halves grouped by slice in one pass: set bits tagged 0,
        # clear bits 1.
        all_c = np.concatenate([set_c, clr_c])
        all_r = np.concatenate([set_r, clr_r])
        tags = np.concatenate([np.zeros(len(set_c), np.int64), np.ones(len(clr_c), np.int64)])
        for s, (r_s, c_s, t_s) in np_group_by(all_c // SLICE_WIDTH, all_r, all_c, tags):
            sm = t_s == 0
            view.create_fragment_if_not_exists(s).import_bulk(
                r_s[sm], c_s[sm], clear_row_ids=r_s[~sm], clear_column_ids=c_s[~sm]
            )

    def set_value(self, field: str, column_id: int, value: int) -> None:
        self.import_value(field, [column_id], [value])

    # --- slices ---

    def max_slice(self) -> int:
        """Max slice over non-inverse views (reference: frame.go:169-186)."""
        with self._mu:
            return max(
                (v.max_slice() for n, v in self._views.items() if not is_inverse_view(n)),
                default=0,
            )

    def max_inverse_slice(self) -> int:
        """Max slice over the inverse views (JAX ``frame.py:322``)."""
        with self._mu:
            return max(
                (v.max_slice() for n, v in self._views.items() if is_inverse_view(n)),
                default=0,
            )

    # --- writes (reference: frame.go:443-525) ---

    def _writable_view(self, view_name: str) -> View:
        if not is_valid_view(view_name):
            raise FrameError(f"invalid view: {view_name!r}")
        return self.create_view_if_not_exists(view_name)

    def set_bit(
        self, view_name: str, row_id: int, col_id: int, t: datetime | None = None
    ) -> bool:
        """Set the bit in ``view_name`` and, with a time ``t``, in each of
        its time views (reference: frame.go:443-483)."""
        changed = self._writable_view(view_name).set_bit(row_id, col_id)
        if t is None:
            return changed
        for subname in tq.views_by_time(view_name, t, self.time_quantum):
            if self.create_view_if_not_exists(subname).set_bit(row_id, col_id):
                changed = True
        return changed

    def clear_bit(self, view_name: str, row_id: int, col_id: int) -> bool:
        """reference: frame.go:485-506 (standard view only; no time fan-out)"""
        return self._writable_view(view_name).clear_bit(row_id, col_id)

    def import_bulk(self, row_ids, column_ids, timestamps=None) -> None:
        """Bulk import grouped by (view, slice) (reference:
        frame.go:527-604; JAX ``frame.py:353-404``): every bit goes to the
        standard view, a bit with a timestamp also to the time views of
        the frame's quantum, and with inverse storage the transposed bits
        to the inverse side (:meth:`import_inverse`).  Timestamps on a
        frame without a time quantum are refused as in the JAX
        package."""
        self.import_standard(row_ids, column_ids, timestamps)
        if self.inverse_enabled:
            self.import_inverse(row_ids, column_ids, timestamps)

    def _check_timestamps(self, timestamps) -> bool:
        has_ts = timestamps is not None and any(t is not None for t in timestamps)
        if self.time_quantum == "" and has_ts:
            raise FrameError("time quantum not set in either index or frame")
        return has_ts

    def import_standard(self, row_ids, column_ids, timestamps=None) -> None:
        """The standard half of :meth:`import_bulk`: the standard view
        and its time views, grouped by column slice."""
        has_ts = self._check_timestamps(timestamps)
        rows = np.asarray(row_ids, dtype=np.int64)
        cols = np.asarray(column_ids, dtype=np.int64)
        self._import_grouped(VIEW_STANDARD, rows, cols)
        if has_ts:
            for name, sel in self._time_view_groups(VIEW_STANDARD, timestamps):
                self._import_grouped(name, rows[sel], cols[sel])

    def import_inverse(self, row_ids, column_ids, timestamps=None) -> None:
        """The inverse half of :meth:`import_bulk`: (column, row) grouped
        by inverse slice ``row // SLICE_WIDTH``.  As in the JAX package
        (``frame.py:378-398``), a bit without a timestamp goes to the
        inverse view and a bit with one to the inverse time views only."""
        if not self.inverse_enabled:
            raise FrameError("inverse storage is not enabled on this frame")
        has_ts = self._check_timestamps(timestamps)
        rows = np.asarray(row_ids, dtype=np.int64)
        cols = np.asarray(column_ids, dtype=np.int64)
        if not has_ts:
            self._import_grouped(VIEW_INVERSE, cols, rows)
            return
        plain = np.asarray([t is None for t in timestamps], dtype=bool)
        if plain.any():
            self._import_grouped(VIEW_INVERSE, cols[plain], rows[plain])
        for name, sel in self._time_view_groups(VIEW_INVERSE, timestamps):
            self._import_grouped(name, cols[sel], rows[sel])

    def _time_view_groups(self, view_name: str, timestamps):
        """``(time view, int64 indexes of its bits)`` for the bits with a
        timestamp: each distinct timestamp names its views once."""
        by_time: dict[datetime, list[int]] = {}
        for i, t in enumerate(timestamps):
            if t is not None:
                by_time.setdefault(t, []).append(i)
        by_view: dict[str, list[int]] = {}
        for t, idx in by_time.items():
            for name in tq.views_by_time(view_name, t, self.time_quantum):
                by_view.setdefault(name, []).extend(idx)
        return [(name, np.asarray(idx, dtype=np.int64)) for name, idx in by_view.items()]

    def _import_grouped(self, view_name: str, rows: np.ndarray, cols: np.ndarray) -> None:
        view = self.create_view_if_not_exists(view_name)
        for s, (r_s, c_s) in np_group_by(cols // SLICE_WIDTH, rows, cols):
            view.create_fragment_if_not_exists(s).import_bulk(r_s, c_s)

    def schema_dict(self) -> dict:
        with self._mu:
            meta = self._meta()
            return {"name": self.name, **meta}
