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

With a cold tier (``pilosa_tpu_torch/tier``, JAX ``core/view.py:11-17``)
a slice can also be **cold**: its metadata is registered here (it counts
in ``max_slice`` and ``fragment_slices``) while its bytes are an archive
in the object store.  The first ``fragment`` or
``create_fragment_if_not_exists`` of it hydrates through the attached
``hydrator`` (the ``TierManager``), outside the view lock; a hydration
that fails raises rather than serve an empty fragment.
"""

from __future__ import annotations

import os
import threading

import torch

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core import fragment as fragment_mod
from pilosa_tpu_torch.core.fragment import Fragment, FragmentRetiredError
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
        # Cold slices: slice -> the store's metadata of its archive, set
        # by the tier manager, whose ``hydrator`` revives them on first
        # touch.  Empty, with no hydrator, on a node without a tier.
        self._cold: dict[int, object] = {}
        self.hydrator = None

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
            frag = self._fragments.get(slice_i)
            if frag is not None:
                if self.hydrator is not None:
                    self.hydrator.touch(self, slice_i)
                return frag
            if slice_i not in self._cold or self.hydrator is None:
                return None
        # Cold: hydrate outside the view lock (store I/O holds no data
        # lock); the hydrator serializes per fragment.
        return self.hydrator.hydrate(self, slice_i)

    def fragment_map(self) -> dict[int, Fragment]:
        """A copy of the view's hot fragments by slice, taken under one
        lock (no hydration)."""
        with self._mu:
            return dict(self._fragments)

    def fragments(self) -> list[Fragment]:
        """The view's hot fragments in the order they were opened or
        made: a cold one has nothing local to flush, close or count."""
        with self._mu:
            return list(self._fragments.values())

    def fragment_slices(self) -> set[int]:
        """The slices with a fragment here, hot or cold: a per-slice walk
        must find a cold slice's bits (its ``fragment()`` hydrates)."""
        with self._mu:
            return set(self._fragments) | set(self._cold)

    def max_slice(self) -> int:
        with self._mu:
            return max(max(self._fragments, default=0), max(self._cold, default=0))

    def create_fragment_if_not_exists(self, slice_i: int) -> Fragment:
        """reference: view.go:218-250"""
        if self.hydrator is not None:
            with self._mu:
                cold = slice_i in self._cold and slice_i not in self._fragments
            if cold:
                # A write to a cold fragment revives it first, so that it
                # lands on the whole restored plane; a failure raises.
                frag = self.hydrator.hydrate(self, slice_i)
                if frag is not None:
                    return frag
        with self._mu:
            frag = self._fragments.get(slice_i)
            if frag is not None:
                return frag
            notify = (not self._fragments and not self._cold) or slice_i > self.max_slice()
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
        fragment.  A cold slice is released by dropping its registration
        (nothing of it is local)."""
        with self._mu:
            frag = self._fragments.pop(slice_i, None)
            was_cold = self._cold.pop(slice_i, None) is not None
        if frag is None:
            return was_cold
        frag.close()
        unlink_fragment_files(frag)
        return True

    # --- cold state (pilosa_tpu_torch/tier; JAX view.py:213-290) ---

    def register_cold(self, slice_i: int, meta: object) -> bool:
        """Register a cold slice (its archive is in the store); False
        when a hot fragment holds the slice."""
        with self._mu:
            if slice_i in self._fragments:
                return False
            self._cold[slice_i] = meta
            return True

    def cold_slices(self) -> set[int]:
        with self._mu:
            return set(self._cold)

    def cold_meta(self, slice_i: int) -> object | None:
        with self._mu:
            return self._cold.get(slice_i)

    def drop_cold(self, slice_i: int) -> None:
        with self._mu:
            self._cold.pop(slice_i, None)

    def _fragment_raw(self, slice_i: int) -> Fragment | None:
        """The hot fragment of a slice, with no hydration and no touch:
        the hydrator's own check."""
        with self._mu:
            return self._fragments.get(slice_i)

    def adopt_hydrated(self, slice_i: int, frag: Fragment) -> None:
        """Install a hydrated fragment and drop its cold registration, in
        one hold of the view lock."""
        with self._mu:
            self._fragments[slice_i] = frag
            self._cold.pop(slice_i, None)

    def demote_fragment(
        self,
        slice_i: int,
        meta: object,
        expect: Fragment | None = None,
        expect_version: int | None = None,
    ) -> Fragment | None:
        """Flip a hot fragment cold under the view lock: retire it (its
        writes now raise and retry through the view, which hydrates it
        again), drop it and register ``meta``.  With ``expect`` /
        ``expect_version`` the flip aborts (None; the fragment stays hot)
        when the fragment was replaced or written since the caller read
        the version, that is since the uploaded archive was taken.  The
        caller closes the returned fragment and deletes its files outside
        the lock."""
        with self._mu:
            frag = self._fragments.get(slice_i)
            if frag is None:
                return None
            if expect is not None:
                if frag is not expect or not frag.mark_retired_if_version(expect_version or 0):
                    return None
            else:
                frag.mark_retired()
            del self._fragments[slice_i]
            self._cold[slice_i] = meta
            return frag

    # --- writes (reference: view.go:262-279) ---

    def set_bit(self, row_id: int, column_id: int) -> bool:
        # Two attempts: a fragment that a concurrent demotion retired
        # revives through hydration on the second; a second failure
        # propagates — a write never lands in a retired plane.
        last: FragmentRetiredError | None = None
        for _ in range(2):
            frag = self.create_fragment_if_not_exists(column_id // SLICE_WIDTH)
            try:
                return frag.set_bit(row_id, column_id)
            except FragmentRetiredError as e:
                last = e
        raise last

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        last: FragmentRetiredError | None = None
        for _ in range(2):
            frag = self.fragment(column_id // SLICE_WIDTH)
            if frag is None:
                return False
            try:
                return frag.clear_bit(row_id, column_id)
            except FragmentRetiredError as e:
                last = e
        raise last


def unlink_fragment_files(frag: Fragment) -> None:
    """Delete a closed fragment's data file, rank cache and WAL segment."""
    for path in (frag.path, frag.cache_path, frag.path + ".wal"):
        try:
            os.unlink(path)
        except OSError:
            pass
