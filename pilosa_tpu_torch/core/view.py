"""View — one physical layout of a frame: its fragments by slice.

Reference behavior (reference: view.go): a view directory holds one
fragment file per slice under ``fragments/``; the standard view stores
(row, column) as given, and so do the views named after it — a
time-quantum view (``standard_2017``, ``standard_201703``, ...) and a
BSI field view (``field_<name>``), which open, list and count their
slices like the standard one.  The inverse view (and its time views)
stores (column, row) in slice ``row // SLICE_WIDTH``; its fragments are
typically tall — one row per column of the standard view — and live
mostly in the fragment's sparse tier.
"""

from __future__ import annotations

import os
import threading

import torch

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core import fragment as fragment_mod
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.obs.stats import NopStatsClient
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH

VIEW_STANDARD = "standard"
VIEW_INVERSE = "inverse"


def is_valid_view(name: str) -> bool:
    """reference: view.go:31-41"""
    return name in (VIEW_STANDARD, VIEW_INVERSE)


def is_inverse_view(name: str) -> bool:
    """Inverse views (incl. time sub-views) share the prefix (reference:
    view.go:43-46)."""
    return name.startswith(VIEW_INVERSE)


class View:
    def __init__(
        self,
        path: str,
        index: str,
        frame: str,
        name: str,
        device: torch.device | str | None = None,
        cache_type: str = cache_mod.TYPE_RANKED,
        cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
        row_attr_store=None,
        on_create_slice=None,
    ):
        self.path = path
        self.index = index
        self.frame = frame
        self.name = name
        self.device = device_mod.resolve(device)
        self.placed = device_mod.placed(device)
        self.stats = NopStatsClient()  # re-tagged by its parent
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        # Called as (index, view, slice) when this view grows a new max
        # slice (reference: view.go:236-241), outside the view lock.
        self.on_create_slice = on_create_slice
        self._mu = threading.RLock()
        self._fragments: dict[int, Fragment] = {}

    # --- lifecycle (reference: view.go:97-154) ---

    @property
    def fragments_path(self) -> str:
        return os.path.join(self.path, "fragments")

    def open(self) -> None:
        with self._mu:
            os.makedirs(self.fragments_path, exist_ok=True)
            for entry in sorted(os.listdir(self.fragments_path)):
                if not entry.isdigit():
                    continue  # skip .cache / .snapshotting / strays
                frag = self._new_fragment(int(entry))
                frag.open()
                self._fragments[int(entry)] = frag

    def close(self) -> None:
        with self._mu:
            for frag in self._fragments.values():
                frag.close()
            self._fragments.clear()

    def _new_fragment(self, slice_i: int) -> Fragment:
        # A BSI field's fragment holds at most 2 + MAX_DEPTH rows, which
        # the ripple kernel K8 reads in place from the plane: they always
        # get plane slots, whatever the dense budget.
        budget = None
        if bsi.is_field_view(self.name):
            budget = max(fragment_mod.DENSE_ROW_BUDGET, bsi.ROW_BIT_BASE + bsi.MAX_DEPTH)
        frag = Fragment(
            os.path.join(self.fragments_path, str(slice_i)),
            self.index,
            self.frame,
            self.name,
            slice_i,
            device=self.placed,
            cache_type=self.cache_type,
            cache_size=self.cache_size,
            dense_row_budget=budget,
        )
        frag.row_attr_store = self.row_attr_store
        frag.stats = self.stats.with_tags(f"slice:{slice_i}")
        frag.cache.stats = frag.stats  # hit/miss/evict counters
        return frag

    # --- accessors ---

    def fragment(self, slice_i: int) -> Fragment | None:
        with self._mu:
            return self._fragments.get(slice_i)

    def fragment_map(self) -> dict[int, Fragment]:
        """A copy of the view's fragments by slice, taken under one lock."""
        with self._mu:
            return dict(self._fragments)

    def fragments(self) -> list[Fragment]:
        """The view's fragments in the order they were opened or made."""
        with self._mu:
            return list(self._fragments.values())

    def fragment_slices(self) -> set[int]:
        with self._mu:
            return set(self._fragments)

    def max_slice(self) -> int:
        with self._mu:
            return max(self._fragments.keys(), default=0)

    def create_fragment_if_not_exists(self, slice_i: int) -> Fragment:
        """reference: view.go:218-250"""
        with self._mu:
            frag = self._fragments.get(slice_i)
            if frag is not None:
                return frag
            notify = not self._fragments or slice_i > self.max_slice()
            frag = self._new_fragment(slice_i)
            frag.open()
            self._fragments[slice_i] = frag
        # Outside the view lock: the callback crosses into the network.
        if notify and self.on_create_slice is not None:
            self.on_create_slice(self.index, self.name, slice_i)
        return frag

    def remove_fragment(self, slice_i: int) -> bool:
        """Take one fragment out of service and delete its files (the
        release of a slice a resize moved away, JAX ``view.py:192``): its
        mirror leaves the pool at close, its data file, cache and WAL
        segment leave the disk.  False when the view has no such
        fragment."""
        with self._mu:
            frag = self._fragments.pop(slice_i, None)
        if frag is None:
            return False
        frag.close()
        for path in (frag.path, frag.cache_path, frag.path + ".wal"):
            try:
                os.unlink(path)
            except OSError:
                pass
        return True

    # --- writes (reference: view.go:262-279) ---

    def set_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SLICE_WIDTH)
        return frag.set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.fragment(column_id // SLICE_WIDTH)
        if frag is None:
            return False
        return frag.clear_bit(row_id, column_id)
