"""Fragment — the storage/compute unit: one (frame, view, slice) bit-plane.

The reference keeps a fragment as an mmap'd roaring bitmap with an
appended op-log, a row cache and a ranked TopN cache (reference:
fragment.go).  Here, as in ``pilosa_tpu.core.fragment``:

* **Authoritative storage** is a host numpy uint32 plane of shape
  (pad_rows(rows), 32768), one *slot* per row id in first-touch order,
  loaded from and persisted to the reference's roaring file format
  (cookie 12346 + op-log), so data directories interoperate with the JAX
  package and the reference's tools.
* **Compute** runs on a device mirror of the plane: an int32 bit-view
  tensor of the same shape on the fragment's device.  Point writes and
  imports of at most ``IMPORT_SCATTER_MAX`` bits queue their deltas
  (``_queue_device_update`` / ``_queue_import_updates_locked``); the
  next read, or ``apply_pending_scatter``, folds the queue into ONE
  launch of the delta-scatter kernel K7 on the resident mirror
  (``ingest/scatter.py``).  Structural changes — rows past the padded
  plane, larger imports, a queue past ``_MAX_DEVICE_PENDING`` — drop
  the mirror for a full re-upload, each counted by
  ``scatter.note_fallback`` (the JAX package's designed behaviour,
  ``pilosa_tpu/core/fragment.py:1602-1682``).
* **The mirror is updated in place**, where the JAX package built a new
  array per apply.  On the card a reader still sees each fragment old
  or new, never half-applied: a queue is applied by one kernel launch,
  enqueued while the fragment lock is held, and every reader's copy of
  mirror rows is a later or an earlier kernel on the same stream (the
  server's threads share PyTorch's default stream).  On the CPU (the
  tests' device) the plain version runs under the fragment lock, and a
  reader copying rows outside it in another thread may race it.
* **Writes** go to the host plane and append 13-byte ops to the file;
  after ``max_op_n`` ops the fragment snapshots (full roaring
  serialization to ``<path>.snapshotting`` renamed over the data file,
  reference: fragment.go:1006-1074).
* **TopN** keeps the reference's ranked-cache candidate selection and
  splits the scoring as the JAX package does: ``top_prepare_parts`` /
  ``top_prepare_union_parts`` capture the mirror and the candidates'
  slots in it (a :class:`SubRef`), the executor scores every fragment
  of a node in one launch of the cross-fragment scorer K4
  (``ops/score_planes.py``), and ``top_score_arrays`` / ``top_finish``
  select from the fetched scores.  ``top`` is the three for one
  fragment.

This is the dense tier only: every row lives in the plane, up to
``DENSE_ROW_BUDGET`` rows, and a row beyond the budget raises.  The JAX
package's sparse tier, WAL, tiering, residency pool and prefetch are not
ported yet.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
from collections.abc import Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.ingest import scatter
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops import roaring, score_planes

SLICE_WIDTH = bp.SLICE_WIDTH

# reference: fragment.go:58-65
DEFAULT_FRAGMENT_MAX_OP_N = 2000
# Dense-tier budget: rows a fragment's plane may hold (128 KiB each).
DENSE_ROW_BUDGET = 1 << 16
# Largest legal row id: op-log positions are u64 and pos = row*2^20+off.
MAX_ROW_ID = 1 << 44


class FragmentError(RuntimeError):
    pass


@dataclass
class TopOptions:
    """reference: fragment.go:675-691"""

    n: int = 0
    src: RowBitmap | None = None
    row_ids: list[int] | None = None
    min_threshold: int = 0
    filter_field: str = ""
    filter_values: list[Any] | None = None
    tanimoto_threshold: int = 0


@dataclass
class TopState:
    """One fragment's TopN pass between the prepare and the selection
    (JAX ``core/fragment.py:255``), array-native: candidate ids and
    cached counts are int64 arrays in candidate (count-descending)
    order, and ``dense_pos`` are the positions among them that the
    scorer scores.  ``done_ids``/``done_cnts`` short-circuit the
    src-less and empty cases with a final (filtered, sorted, trimmed)
    result; otherwise the scorer fills ``counts``, one score per dense
    position.  Dense tier only: the JAX package's sparse-tier positions
    join when the port has a sparse tier."""

    done_ids: np.ndarray | None = None
    done_cnts: np.ndarray | None = None
    cand_ids: np.ndarray | None = None
    cand_cached: np.ndarray | None = None
    dense_pos: np.ndarray | None = None
    n: int = 0
    tanimoto: int = 0
    src_count: int = 0
    min_threshold: int = 0
    counts: np.ndarray | None = None


@dataclass
class SubRef:
    """One fragment's scorer inputs (JAX ``core/fragment.py:282``): the
    mirror tensor and the candidates' slots in it, captured together
    under the fragment lock after the queued deltas were applied.

    Unlike the JAX package's immutable array, the mirror is patched in
    place by K7, so the capture is a reference, not a snapshot.  What a
    concurrent write can change in a score: the scorer runs on the
    stream the writes' K7 launches run on, so it sees each queued write
    wholly or not at all — a queue applied (by a later read) before the
    scorer launch is in the score, one applied after is not.  What it
    cannot change: the slot map.  A structural write (a row past the
    padded plane, a large import) drops the mirror for a new tensor and
    leaves this one — and so ``slots`` — as it was; the reference kept
    here holds its memory until the scorer launch is enqueued."""

    plane: torch.Tensor
    slots: np.ndarray  # int64 candidate slots in ``plane``


def encode_cache_ids(ids: list[int]) -> bytes:
    """The reference's protobuf ``Cache`` message (``repeated uint64 IDs
    = 1``, packed), written by hand: .cache files stay interchangeable
    with the JAX package's and a real Pilosa's (reference:
    fragment.go:1083-1110)."""
    if not ids:
        return b""
    body = b"".join(_varint(int(i)) for i in ids)
    return b"\x0a" + _varint(len(body)) + body


def decode_cache_ids(payload: bytes) -> list[int] | None:
    """Cache-file payload -> row ids: the protobuf ``Cache`` message
    (packed or unpacked field 1), or a JSON list from older files.
    None = unreadable (the cache rebuilds lazily, like the reference)."""
    if payload[:1] == b"[":
        try:
            ids = json.loads(payload)
        except json.JSONDecodeError:
            return None
        return ids if isinstance(ids, list) else None
    ids: list[int] = []
    pos = 0
    try:
        while pos < len(payload):
            key, pos = _read_varint(payload, pos)
            field, wire_type = key >> 3, key & 7
            if wire_type == 2:
                n, pos = _read_varint(payload, pos)
                end = pos + n
                if end > len(payload):
                    return None
                while pos < end:
                    v, pos = _read_varint(payload, pos)
                    if field == 1:
                        ids.append(v)
            elif wire_type == 0:
                v, pos = _read_varint(payload, pos)
                if field == 1:
                    ids.append(v)
            else:
                return None
    except IndexError:
        return None
    return ids


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


class Fragment:
    """One frame-view x slice bit-plane with its device mirror and caches."""

    def __init__(
        self,
        path: str,
        index: str,
        frame: str,
        view: str,
        slice_i: int,
        device: torch.device | str | None = None,
        cache_type: str = cache_mod.TYPE_RANKED,
        cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
        max_op_n: int = DEFAULT_FRAGMENT_MAX_OP_N,
    ):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice_i
        self.device = device_mod.resolve(device)
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.max_op_n = max_op_n
        self.row_attr_store = None  # wired by View

        self._mu = threading.RLock()
        self._plane = bp.empty_plane(bp.ROW_BLOCK)
        self._slot_of: dict[int, int] = {}
        self._count_of: dict[int, int] = {}
        self._op_n = 0
        # int32 bit-view mirror of _plane on self.device; None = stale
        # (rebuilt by the next device_plane()).
        self._mirror: torch.Tensor | None = None
        # Queued (slot, word, mask, op) deltas not yet in the mirror, as
        # int64 [k, 4] chunks, and their total count.
        self._pending: list[np.ndarray] = []
        self._pending_n = 0
        self._file = None
        self.cache = cache_mod.new_cache(cache_type, cache_size)

    # ------------------------------------------------------------------
    # lifecycle (reference: fragment.go:154-338)
    # ------------------------------------------------------------------

    def open(self) -> None:
        with self._mu:
            if self._file is not None:
                return
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._file = open(self.path, "a+b")
            try:
                fcntl.flock(self._file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                self._file.close()
                self._file = None
                raise FragmentError(f"fragment file locked: {self.path}") from e
            try:
                self._open_storage()
                self._open_cache()
            except BaseException:
                fcntl.flock(self._file.fileno(), fcntl.LOCK_UN)
                self._file.close()
                self._file = None
                raise

    def _open_storage(self) -> None:
        self._file.seek(0)
        data = self._file.read()
        if not data:
            # Seed an empty roaring header so op-log appends produce a
            # parseable file (reference: fragment.go:187-242).
            self._file.write(roaring.encode({}))
            self._file.flush()
            return
        containers, op_n = roaring.decode_with_ops(data)
        rows = sorted({int(k) // bp.CONTAINERS_PER_SLICE for k in containers})
        if len(rows) > DENSE_ROW_BUDGET:
            raise FragmentError(
                f"{self.path}: {len(rows)} rows exceed the dense row budget "
                f"{DENSE_ROW_BUDGET}"
            )
        slot_of = {r: i for i, r in enumerate(rows)}
        plane = bp.empty_plane(bp.pad_rows(len(rows)))
        wpc = bp.WORDS_PER_CONTAINER
        for key, words in containers.items():
            row, cidx = divmod(int(key), bp.CONTAINERS_PER_SLICE)
            plane[slot_of[row], cidx * wpc : (cidx + 1) * wpc] = words.view("<u4")
        counts = bp.np_row_counts(plane)
        self._plane = plane
        self._slot_of = slot_of
        self._count_of = {r: int(counts[s]) for r, s in slot_of.items()}
        self._invalidate_device()
        self._op_n = op_n

    def close(self) -> None:
        with self._mu:
            if self._file is not None:
                self.flush_cache()
                fcntl.flock(self._file.fileno(), fcntl.LOCK_UN)
                self._file.close()
                self._file = None
            self._invalidate_device()

    @property
    def cache_path(self) -> str:
        """reference: fragment.go:147-149"""
        return self.path + ".cache"

    def _open_cache(self) -> None:
        """Load persisted TopN candidate ids with their current counts
        (reference: fragment.go:244-282)."""
        try:
            with open(self.cache_path, "rb") as fh:
                payload = fh.read()
        except OSError:
            return
        ids = decode_cache_ids(payload)
        if ids is None:
            return
        for row_id in ids:
            if isinstance(row_id, int) and row_id in self._slot_of:
                self.cache.bulk_add(row_id, self._count_of.get(row_id, 0))
        self.cache.invalidate()

    def flush_cache(self) -> None:
        """Persist TopN candidate row ids (reference: fragment.go:1083-1110)."""
        with self._mu:
            tmp = self.cache_path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(encode_cache_ids(self.cache.ids()))
            os.replace(tmp, self.cache_path)

    # ------------------------------------------------------------------
    # geometry
    # ------------------------------------------------------------------

    def pos(self, row_id: int, column_id: int) -> int:
        """Bit position within the fragment (reference: fragment.go:476-484)."""
        min_col = self.slice * SLICE_WIDTH
        if not (min_col <= column_id < min_col + SLICE_WIDTH):
            raise FragmentError(
                f"column out of bounds: {column_id} not in slice {self.slice}"
            )
        return row_id * SLICE_WIDTH + (column_id % SLICE_WIDTH)

    def _ensure_slot(self, row_id: int) -> int:
        """The row's plane slot, allocated on first touch."""
        slot = self._slot_of.get(row_id)
        if slot is not None:
            return slot
        if row_id >= MAX_ROW_ID:
            raise FragmentError(f"row id out of range: {row_id}")
        if len(self._slot_of) >= DENSE_ROW_BUDGET:
            raise FragmentError(
                f"row {row_id} exceeds the dense row budget "
                f"{DENSE_ROW_BUDGET} of {self.path} (the sparse tier "
                "is not ported)"
            )
        slot = len(self._slot_of)
        self._slot_of[row_id] = slot
        self._count_of[row_id] = 0
        self._reserve(slot + 1)
        return slot

    def _reserve(self, n_slots: int) -> None:
        """Grow the plane to hold ``n_slots`` rows in one allocation; the
        mirror no longer matches its shape — a structural change the
        delta-scatter cannot express — and is dropped."""
        needed = bp.pad_rows(max(n_slots, 1))
        if needed > self._plane.shape[0]:
            extra = bp.empty_plane(needed - self._plane.shape[0])
            self._plane = np.vstack([self._plane, extra])
            if self._mirror is not None:
                scatter.note_fallback()
            self._invalidate_device()

    # ------------------------------------------------------------------
    # device mirror maintenance (JAX: fragment.py:1263,1602-1682)
    # ------------------------------------------------------------------

    # Above this many queued deltas a full re-upload beats the scatter.
    _MAX_DEVICE_PENDING = 8192

    def _invalidate_device(self) -> None:
        """Drop the mirror and its queued deltas: the next read uploads
        the host plane, which already holds every write."""
        self._mirror = None
        self._pending.clear()
        self._pending_n = 0

    def _queue_device_update(self, slot: int, offset: int, op: int) -> None:
        """Queue one point write (op 1 set, 0 clear) for the mirror; a
        full queue degrades to a re-upload on the next read."""
        if self._mirror is None:
            return
        if self._pending_n >= self._MAX_DEVICE_PENDING:
            scatter.note_fallback()
            self._invalidate_device()
            return
        word, shift = divmod(offset, bp.WORD_BITS)
        self._pending.append(np.array([[slot, word, 1 << shift, op]], dtype=np.int64))
        self._pending_n += 1

    def _queue_import_updates_locked(
        self, set_slots, set_offs, clr_slots=None, clr_offs=None
    ) -> None:
        """Queue an import's set bits (op 1) and cleared bits (op 0) as
        deltas when the import is small enough; otherwise drop the mirror
        (one re-upload beats thousands of folded entries)."""
        parts = [(a, b, op) for a, b, op in ((set_slots, set_offs, 1), (clr_slots, clr_offs, 0))
                 if a is not None and len(a)]
        n = sum(len(a) for a, _, _ in parts)
        if (
            self._mirror is None
            or n == 0
            or n > scatter.IMPORT_SCATTER_MAX
            or self._pending_n + n > self._MAX_DEVICE_PENDING
        ):
            if self._mirror is not None:
                scatter.note_fallback()
            self._invalidate_device()
            return
        for slots, offsets, op in parts:
            words, shifts = np.divmod(np.asarray(offsets, dtype=np.int64), bp.WORD_BITS)
            chunk = np.empty((len(slots), 4), dtype=np.int64)
            chunk[:, 0] = slots
            chunk[:, 1] = words
            chunk[:, 2] = np.left_shift(1, shifts)
            chunk[:, 3] = op
            self._pending.append(chunk)
        self._pending_n += n

    def apply_pending_scatter(self) -> bool:
        """Fold the queued deltas into the resident mirror NOW, as one
        delta-scatter launch, instead of at the next read.  Returns True
        when a launch was made."""
        with self._mu:
            if self._mirror is None or not self._pending_n:
                return False
            scatter.apply(self._mirror, np.concatenate(self._pending))
            self._pending.clear()
            self._pending_n = 0
            return True

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def device_plane(self) -> torch.Tensor:
        """The int32 bit-view mirror of the plane on the fragment's
        device: queued deltas applied first (one K7 launch), uploaded
        when stale."""
        with self._mu:
            if self._mirror is None:
                self._mirror = bp.to_device(self._plane, self.device)
            else:
                self.apply_pending_scatter()
            return self._mirror

    def device_row(self, row_id: int) -> torch.Tensor | None:
        """One row of the mirror (a view), or None when the row is absent."""
        with self._mu:
            slot = self._slot_of.get(row_id)
            if slot is None:
                return None
            return self.device_plane()[slot]

    def device_slots(self, row_ids) -> tuple[torch.Tensor, list[int]]:
        """The mirror (queued deltas applied) and the rows of ``row_ids``
        in it, -1 for an absent row — read together under the lock, so
        the slots name rows of this mirror."""
        with self._mu:
            plane = self.device_plane()
            return plane, [self._slot_of.get(r, -1) for r in row_ids]

    def slot_in(self, row_id: int, plane: torch.Tensor) -> int | None:
        """The row's slot while ``plane`` is still this fragment's mirror
        (queued deltas applied), else None: a slot names a row only of
        the mirror it was read with."""
        with self._mu:
            slot = self._slot_of.get(row_id)
            if slot is None or self.device_plane() is not plane:
                return None
            return slot

    def row_words_host(self, row_id: int) -> np.ndarray | None:
        """One row's uint32 words on the host (a copy), or None."""
        with self._mu:
            slot = self._slot_of.get(row_id)
            return None if slot is None else self._plane[slot].copy()

    def row(self, row_id: int) -> RowBitmap:
        """One row as a RowBitmap segment on the fragment's device
        (reference: fragment.go:340-375)."""
        with self._mu:
            seg = self.device_row(row_id)
            if seg is None:
                seg = torch.zeros(bp.WORDS_PER_SLICE, dtype=torch.int32, device=self.device)
            return RowBitmap.from_segment(self.slice, seg.clone())

    def has_row(self, row_id: int) -> bool:
        with self._mu:
            return row_id in self._slot_of

    def row_count(self, row_id: int) -> int:
        with self._mu:
            return self._count_of.get(row_id, 0)

    def count(self) -> int:
        with self._mu:
            return sum(self._count_of.values())

    # ------------------------------------------------------------------
    # writes (reference: fragment.go:379-473)
    # ------------------------------------------------------------------

    def set_bit(self, row_id: int, column_id: int) -> bool:
        return self._point_write(row_id, column_id, roaring.OP_ADD)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            if row_id not in self._slot_of:
                self.pos(row_id, column_id)
                return False
        return self._point_write(row_id, column_id, roaring.OP_REMOVE)

    def _point_write(self, row_id: int, column_id: int, typ: int) -> bool:
        with self._mu:
            pos = self.pos(row_id, column_id)
            offset = pos % SLICE_WIDTH
            slot = self._ensure_slot(row_id)
            bit = slot * SLICE_WIDTH + offset
            if typ == roaring.OP_ADD:
                changed = bp.np_set_bit(self._plane, bit)
            else:
                changed = bp.np_clear_bit(self._plane, bit)
            if not changed:
                return False
            self._queue_device_update(slot, offset, 1 if typ == roaring.OP_ADD else 0)
            self._append_op(typ, pos)
            self._after_write(row_id, 1 if typ == roaring.OP_ADD else -1)
            return True

    def _after_write(self, row_id: int, delta: int) -> None:
        n = self._count_of[row_id] = self._count_of.get(row_id, 0) + delta
        self.cache.add(row_id, n)
        self._op_n += 1
        if self._op_n >= self.max_op_n:
            self.snapshot()

    def _append_op(self, typ: int, pos: int) -> None:
        if self._file is not None:
            self._file.seek(0, os.SEEK_END)
            self._file.write(roaring.encode_op(typ, pos))
            self._file.flush()

    def import_bulk(
        self,
        row_ids: Sequence[int],
        column_ids: Sequence[int],
        clear_row_ids: Sequence[int] | None = None,
        clear_column_ids: Sequence[int] | None = None,
    ) -> None:
        """Bulk load: vectorized scatter into the host plane, the bits
        queued as mirror deltas (or the mirror dropped, see
        ``_queue_import_updates_locked``), the touched rows recounted
        through the fused popcount kernel on the updated mirror, then a
        snapshot (reference: fragment.go:936-1004).

        ``clear_row_ids``/``clear_column_ids`` clear bits in the same
        pass (one snapshot, one recount) — the overwrite half of a BSI
        value import (JAX ``fragment.py:1735``); they reach the mirror as
        and-not deltas.  Clears never create rows: a clear on an absent
        row does nothing.  A bit must not appear in both lists."""
        clear_row_ids = [] if clear_row_ids is None else clear_row_ids
        clear_column_ids = [] if clear_column_ids is None else clear_column_ids
        if len(row_ids) != len(column_ids) or len(clear_row_ids) != len(clear_column_ids):
            raise FragmentError("mismatch of row/column len")
        if len(row_ids) == 0 and len(clear_row_ids) == 0:
            return
        with self._mu:
            rows = np.asarray(row_ids, dtype=np.int64)
            cols = np.asarray(column_ids, dtype=np.int64)
            min_col = self.slice * SLICE_WIDTH
            if ((cols < min_col) | (cols >= min_col + SLICE_WIDTH)).any():
                raise FragmentError("column out of bounds for slice")
            uniq = np.unique(rows)
            new = [int(r) for r in uniq if int(r) not in self._slot_of]
            if len(self._slot_of) + len(new) > DENSE_ROW_BUDGET:
                raise FragmentError(
                    f"import exceeds the dense row budget {DENSE_ROW_BUDGET} "
                    f"of {self.path}"
                )
            self._reserve(len(self._slot_of) + len(new))
            slot_of = {int(r): self._ensure_slot(int(r)) for r in uniq}
            slot_table = np.asarray([slot_of[int(r)] for r in uniq], dtype=np.int64)
            slots = slot_table[np.searchsorted(uniq, rows)]
            offs = cols % SLICE_WIDTH
            bp.np_set_bulk(self._plane, slots, offs)
            c_slots = c_offs = None
            if len(clear_row_ids):
                c_rows = np.asarray(clear_row_ids, dtype=np.int64)
                c_cols = np.asarray(clear_column_ids, dtype=np.int64)
                if ((c_cols < min_col) | (c_cols >= min_col + SLICE_WIDTH)).any():
                    raise FragmentError("column out of bounds for slice")
                c_uniq = np.unique(c_rows)
                c_table = np.asarray(
                    [self._slot_of.get(int(r), -1) for r in c_uniq], dtype=np.int64
                )
                c_slots = c_table[np.searchsorted(c_uniq, c_rows)]
                keep = c_slots >= 0
                c_slots, c_offs = c_slots[keep], (c_cols % SLICE_WIDTH)[keep]
                bp.np_clear_bulk(self._plane, c_slots, c_offs)
                for r, slot in zip(c_uniq, c_table):
                    if slot >= 0:
                        slot_of[int(r)] = int(slot)
            self._queue_import_updates_locked(slots, offs, c_slots, c_offs)
            self._recount(slot_of)
            self.snapshot()

    def install_plane(self, plane: np.ndarray) -> None:
        """Replace the fragment's content with ``plane`` (uint32
        [rows, 32768], plane[r] = row id r; all-zero rows stay absent),
        upload the mirror, recount the rank cache through the fused
        popcount kernel and snapshot."""
        plane = np.asarray(plane, dtype=np.uint32)
        if plane.ndim != 2 or plane.shape[1] != bp.WORDS_PER_SLICE:
            raise FragmentError(f"plane must be [rows, {bp.WORDS_PER_SLICE}] uint32")
        rows = [int(r) for r in np.flatnonzero(plane.any(axis=1))]
        if len(rows) > DENSE_ROW_BUDGET:
            raise FragmentError(
                f"{len(rows)} rows exceed the dense row budget {DENSE_ROW_BUDGET}"
            )
        with self._mu:
            self._plane = bp.empty_plane(bp.pad_rows(len(rows)))
            self._plane[: len(rows)] = plane[rows]
            self._slot_of = {r: i for i, r in enumerate(rows)}
            self._count_of = {}
            self.cache = cache_mod.new_cache(self.cache_type, self.cache_size)
            self._invalidate_device()
            self._recount(self._slot_of)
            self.snapshot()

    def _recount(self, slot_of: dict[int, int]) -> None:
        """Exact counts of ``slot_of``'s rows from one row-popcount
        launch over the up-to-date mirror; the rank cache follows."""
        if slot_of:
            counts = bp.row_counts(self.device_plane()).cpu().numpy()
            for r, s in slot_of.items():
                n = int(counts[s])
                self._count_of[r] = n
                self.cache.bulk_add(r, n)
        self.cache.invalidate()
        self.cache.recalculate()

    def snapshot(self) -> None:
        """Full roaring serialization atomically renamed over the data
        file; resets the op count (reference: fragment.go:1032-1074)."""
        with self._mu:
            data = roaring.encode_tiered(self._containers(), {})
            tmp = self.path + ".snapshotting"
            with open(tmp, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            if self._file is not None:
                fcntl.flock(self._file.fileno(), fcntl.LOCK_UN)
                self._file.close()
            os.replace(tmp, self.path)
            self._file = open(self.path, "a+b")
            fcntl.flock(self._file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            self._op_n = 0

    def _containers(self) -> dict[int, np.ndarray]:
        """The plane as {container key: uint64[1024] words}, non-empty
        containers only."""
        cps = bp.CONTAINERS_PER_SLICE
        wpc = bp.WORDS_PER_CONTAINER
        out: dict[int, np.ndarray] = {}
        for r, s in sorted(self._slot_of.items()):
            chunks = self._plane[s].reshape(cps, wpc)
            for cidx in np.flatnonzero(chunks.any(axis=1)):
                out[r * cps + int(cidx)] = chunks[cidx].view(np.uint64)
        return out

    # ------------------------------------------------------------------
    # TopN (reference: fragment.go:505-673)
    # ------------------------------------------------------------------

    def top(self, opt: TopOptions | None = None) -> list[Pair]:
        """Ranked-cache candidates, filtered; with a src, every
        candidate scored by one launch of the cross-fragment scorer
        over this fragment's mirror; then the threshold/tanimoto
        selection in (count desc, id asc) order, trimmed to n.  With
        explicit ``row_ids`` every scored row returns (n applies only to
        cache candidates, reference: fragment.go:516)."""
        st, sub, src = self.top_prepare_parts(opt)
        if sub is not None:
            scores = score_planes.score_planes([sub.plane], sub.slots[None, :], [src])
            st.counts = scores.cpu().numpy()[0]
        return self.top_finish(st)

    def top_prepare_parts(self, opt: TopOptions | None = None):
        """The scoring pass up to the scorer launch (JAX
        ``core/fragment.py:1951``): ``(TopState, SubRef or None, src
        row or None)``, so the executor can score many fragments in one
        launch."""
        opt = opt or TopOptions()
        with self._mu:
            ids, cnts = self._top_candidates_arrays(opt.row_ids)
        return self._top_score_parts(ids, cnts, opt, bool(opt.row_ids))

    def top_finish(self, st: TopState) -> list[Pair]:
        """The final selection of a scored pass (JAX
        ``core/fragment.py:1961``), over ``top_score_arrays``."""
        ids, cnts, keep, short = self.top_score_arrays(st)
        if not short:
            ids, cnts = ids[keep], cnts[keep]
            order = np.lexsort((ids, -cnts))  # sort_pairs' (-count, id)
            if st.n:
                order = order[: st.n]
            ids, cnts = ids[order], cnts[order]
        return [Pair(int(i), int(c)) for i, c in zip(ids, cnts)]

    def top_candidates_arrays(
        self, opt: TopOptions | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(ids, cached counts) of the filtered candidate listing a
        scoring pass would use — host-only: the folded TopN forms the
        cross-slice union from these before any scoring."""
        opt = opt or TopOptions()
        with self._mu:
            ids, cnts = self._top_candidates_arrays(opt.row_ids)
        ids, cnts, _, _ = self._filter_arrays(ids, cnts, opt)
        return ids, cnts

    @staticmethod
    def select_winners(
        ids: np.ndarray, cnts: np.ndarray, keep: np.ndarray, cand_mask: np.ndarray, n: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Phase-1 winner selection over a scored union restricted to the
        slice's own candidates (``cand_mask``): filter mask, (-count, id)
        sort, trim to ``n``."""
        m = keep & cand_mask
        sel_ids, sel_cnts = ids[m], cnts[m]
        order = np.lexsort((sel_ids, -sel_cnts))
        if n:
            order = order[:n]
        return sel_ids[order], sel_cnts[order]

    _EMPTY_I64 = np.empty(0, np.int64)

    def _top_score_parts(
        self,
        ids: np.ndarray,
        cached: np.ndarray,
        opt: TopOptions,
        row_ids_mode: bool,
    ):
        """A scoring pass without the scorer launch (JAX
        ``core/fragment.py:2074``): ``(TopState, SubRef or None, src row
        or None)``.  ``ids``/``cached`` are the unfiltered candidates in
        count-descending order; ``row_ids_mode`` returns every scored
        row (n applies only to cache candidates, reference:
        fragment.go:516)."""
        n = 0 if row_ids_mode else opt.n
        ids, cached, tanimoto, src_count = self._filter_arrays(ids, cached, opt)
        empty = TopState(done_ids=self._EMPTY_I64, done_cnts=self._EMPTY_I64)
        if opt.src is None:
            # No intersection: cached counts are final, already
            # count-descending; take the first n.
            if n and n < len(ids):
                ids, cached = ids[:n], cached[:n]
            return TopState(done_ids=ids, done_cnts=cached), None, None
        src = opt.src.segments.get(self.slice)
        if not len(ids) or src is None:
            return empty, None, None
        plane, slots = self.device_slots(ids)
        slots = np.asarray(slots, dtype=np.int64)
        dense_pos = np.flatnonzero(slots >= 0)
        if not len(dense_pos):
            return empty, None, None
        sub = SubRef(plane=plane, slots=slots[dense_pos])
        st = TopState(
            cand_ids=ids,
            cand_cached=cached,
            dense_pos=dense_pos,
            n=n,
            tanimoto=tanimoto,
            src_count=src_count,
            min_threshold=opt.min_threshold,
        )
        return st, sub, src.to(plane.device).contiguous()

    def top_score_arrays(
        self, st: TopState
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
        """``(ids, counts, keep, done)`` over the candidates in candidate
        order (JAX ``core/fragment.py:2192``): ``keep`` is the
        threshold/tanimoto mask ``top_finish`` applies; ``done`` means
        the pass short-circuited and ``ids``/``counts`` are its final
        list."""
        if st.done_ids is not None:
            return st.done_ids, st.done_cnts, np.ones(len(st.done_ids), dtype=bool), True
        ids, cached = st.cand_ids, st.cand_cached
        cnts = np.zeros(len(ids), np.int64)
        cnts[st.dense_pos] = np.asarray(st.counts[: len(st.dense_pos)], dtype=np.int64)
        if st.tanimoto > 0:
            denom = cached + st.src_count - cnts
            with np.errstate(divide="ignore", invalid="ignore"):
                score = np.ceil(cnts * 100.0 / denom)
            keep = (cnts > 0) & (score > st.tanimoto)
        else:
            keep = (cnts > 0) & (cnts >= st.min_threshold)
        return ids, cnts, keep, False

    def top_prepare_union_parts(
        self,
        union_ids: np.ndarray,
        cand_ids: np.ndarray,
        cand_cnts: np.ndarray,
        opt: TopOptions,
    ):
        """The folded TopN's union scoring pass without the scorer
        launch (JAX ``core/fragment.py:2268``): as
        ``top_prepare_parts(replace(opt, row_ids=union))``, reusing the
        already-listed candidates and resolving counts only for the
        union ids this slice did not list.  ``union_ids`` is unique."""
        with self._mu:
            foreign = np.setdiff1d(union_ids, cand_ids, assume_unique=True)
            f_cnts = np.fromiter(
                (self._row_count_locked(int(r)) for r in foreign), np.int64, len(foreign)
            )
        fm = f_cnts > 0
        all_ids = np.concatenate([cand_ids, foreign[fm]])
        all_cnts = np.concatenate([cand_cnts, f_cnts[fm]])
        order = np.lexsort((all_ids, -all_cnts))
        return self._top_score_parts(all_ids[order], all_cnts[order], opt, row_ids_mode=True)

    def _filter_arrays(
        self, ids: np.ndarray, cnts: np.ndarray, opt: TopOptions
    ) -> tuple[np.ndarray, np.ndarray, int, int]:
        """Candidate filtering on cached counts (reference:
        fragment.go:535-594).  Returns ``(ids, cnts, tanimoto,
        src_count)``."""
        tanimoto = 0
        src_count = 0
        mask = cnts > 0
        if opt.tanimoto_threshold > 0 and opt.src is not None:
            tanimoto = opt.tanimoto_threshold
            src_count = opt.src.count()
            min_tan = float(src_count * tanimoto) / 100
            max_tan = float(src_count * 100) / float(tanimoto)
            mask &= (cnts > min_tan) & (cnts < max_tan)
        elif opt.min_threshold:
            mask &= cnts >= opt.min_threshold
        if opt.filter_field and opt.filter_values:
            filters = set()
            for v in opt.filter_values:
                try:
                    filters.add(v)
                except TypeError:
                    pass
            store = self.row_attr_store
            if store is None:
                mask[:] = False
            else:
                for k in np.flatnonzero(mask):
                    attrs = store.attrs(int(ids[k]))
                    if not attrs or attrs.get(opt.filter_field) not in filters:
                        mask[k] = False
        return ids[mask], cnts[mask], tanimoto, src_count

    def _top_candidates_arrays(
        self, row_ids: list[int] | None
    ) -> tuple[np.ndarray, np.ndarray]:
        """reference: fragment.go:641-673 topBitmapPairs"""
        if not row_ids:
            # invalidate() is throttle-aware: the re-sort happens at most
            # every RECALCULATE_INTERVAL_S (reference: cache.go:236-241).
            self.cache.invalidate()
            return self.cache.top_arrays()
        ids, cnts = [], []
        for row_id in dict.fromkeys(row_ids):
            c = self._row_count_locked(row_id)
            if c > 0:
                ids.append(row_id)
                cnts.append(c)
        ids = np.asarray(ids, np.int64)
        cnts = np.asarray(cnts, np.int64)
        order = np.lexsort((ids, -cnts))
        return ids[order], cnts[order]

    def _row_count_locked(self, row_id: int) -> int:
        """Cached ranking first, then the maintained count."""
        n = self.cache.get(row_id)
        if n <= 0 and row_id in self._slot_of:
            n = self._count_of.get(row_id, 0)
        return n

    def __repr__(self) -> str:
        return (
            f"Fragment({self.index}/{self.frame}/{self.view}/{self.slice}, "
            f"rows={len(self._slot_of)}, device={self.device})"
        )
