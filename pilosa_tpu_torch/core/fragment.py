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
  tensor of the same shape on the fragment's device, uploaded by the
  first read.  Writes never touch the device: point writes and imports
  queue the plane bits they change (``_queue_device_update`` /
  ``_queue_import_updates_locked``), and row counts come from the host
  plane (``_plane_write``).  A read applies the queues of every
  fragment it reads with ONE launch of the delta-scatter kernel K7 per
  device (:func:`apply_pending_many`, ``ingest/scatter.py``); a read of
  one fragment, or ``apply_pending_scatter``, applies its queue alone.
  Structural changes — rows past the padded plane, a queue past
  ``scatter.pending_limit`` of its mirror — drop the mirror for a full
  re-upload, each counted by ``scatter.note_fallback`` (the JAX
  package's designed behaviour, ``pilosa_tpu/core/fragment.py:
  1602-1682``).
* **The mirror is updated in place**, where the JAX package built a new
  array per apply.  On the card a reader still sees each fragment old
  or new, never half-applied, and sees every write acknowledged before
  it began: a queue is taken and its launch enqueued while the
  fragment's lock is held (a batch holds every lock of the batch,
  taken in one global order), and every reader's copy of mirror rows is
  a later or an earlier kernel on the same stream (the server's threads
  share PyTorch's default stream).  On the CPU (the tests' device) the
  plain version runs under the locks, and a reader copying rows outside
  them in another thread may race it.
* **Writes** go to the host plane and append 13-byte ops to the file;
  after ``max_op_n`` ops the fragment snapshots (full roaring
  serialization to ``<path>.snapshotting`` renamed over the data file,
  reference: fragment.go:1006-1074).  With a WAL writer attached (a
  ``Server`` with its WAL on, ``ingest/wal.py``) the op-log is buffered
  as in the JAX package (``_op_buf``, flushed at 64 KiB, at a snapshot
  and at close) and every op also goes to the fragment's WAL segment,
  whose group-commit fsync the acknowledgement waits for; each snapshot
  restarts the segment.  Without one, each op is written to the file as
  it happens.
* **Residency** goes through the process-wide pool
  (``device/pool.py``): the mirror is admitted at its plane's bytes
  before each upload, and the paged sparse payloads are one entry at
  their compressed bytes.  Under a budget the pool evicts unpinned
  entries in LRU order through ``_evict_mirror`` /
  ``_evict_sparse_rows``, which take the fragment lock only if it is
  free; an evicted mirror's queue is dropped with it (the host plane
  already holds every write), so the next read uploads the current
  plane.
* **TopN** keeps the reference's ranked-cache candidate selection and
  splits the scoring as the JAX package does: ``top_prepare_parts`` /
  ``top_prepare_union_parts`` capture the mirror and the candidates'
  slots in it (a :class:`SubRef`), the executor scores every fragment
  of a node in one launch of the cross-fragment scorer K4
  (``ops/score_planes.py``), and ``top_score_arrays`` / ``top_finish``
  select from the fetched scores.  ``top`` is the three for one
  fragment.

* **Two tiers**, as in the JAX package (``pilosa_tpu/core/fragment.py:
  63-76``): up to ``dense_row_budget`` rows live in the plane (first
  touch on writes; the densest rows first on open); every further row is
  a sorted uint32 array of in-slice offsets (``_sparse``), paying per set
  bit.  A sparse row's device form is its compressed container payload
  (``bitplane.encode_row``: positions, runs, or dense words, whichever
  is smallest), paged to the device on demand into a small LRU
  (``SPARSE_DEVICE_CACHE``).  Queries read it through its format: the
  anchored Count K5 (``ops/anchored_count.py``) reads it in place,
  and the payload expansion K6 (``ops/expand_payload.py``) writes its
  dense row wherever a whole row must be stacked.  A sparse row past
  ``PROMOTE_BITS`` moves to the plane while budget remains.  Answers,
  counts, the ranked cache and the snapshot bytes do not depend on the
  tier a row sits in.

* **Recovery on open**, as in the JAX package: an op-log whose tail was
  torn by a crash mid-append is cut back to its last whole record (only
  inside the last flush window, and only once the prefix is shown to
  decode); the WAL segment (``<path>.wal``) has its ops past the op-log
  replayed (``ingest/recovery.py``) and the fragment checkpoints with a
  snapshot, then keeps writing the segment (``IngestManager.attach``).
  With the WAL off the segment is replayed the same way and then
  removed, since nothing would log to it and a later open would replay
  it again over newer writes.

* **Block checksums, archives and export** (JAX ``core/fragment.py:
  2301-2665``): ``blocks`` hashes each block of ``HASH_BLOCK_SIZE`` rows
  over its sorted bit positions, cached per block and recomputed where a
  write marked the block dirty (every write path marks the blocks of the
  rows it touched; a wholesale load clears the cache); ``merge_block``
  is the replicas' majority vote; ``write_to`` / ``tar_chunks`` write the
  self-verifying tar ("checksum", "data", "cache") and ``read_from``
  verifies it before it replaces the fragment's contents, the mirror and
  its queue dropped with them; ``csv_chunks`` formats the export a row
  block at a time.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import io
import itertools
import json
import os
import sys
import tarfile
import threading
import time
import weakref
from collections import OrderedDict
from collections.abc import Iterable, Sequence
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.ingest import recovery, scatter, wal
from pilosa_tpu_torch.obs.stats import NopStatsClient
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops import expand_payload, roaring, score_planes

SLICE_WIDTH = bp.SLICE_WIDTH

# reference: fragment.go:58-65
DEFAULT_FRAGMENT_MAX_OP_N = 2000
# Dense-tier budget: rows a fragment's plane may hold (128 KiB each);
# rows beyond it live in the sparse tier.
DENSE_ROW_BUDGET = 1 << 16
# A sparse row past this many bits moves to the plane while budget remains
# (past it, offsets at 4 B a bit cost more than the 128 KiB plane row).
PROMOTE_BITS = 32 * 1024
# Sparse rows whose compressed payload is kept on the device (LRU).
SPARSE_DEVICE_CACHE = 64
# Bytes of one plane row.
ROW_NBYTES = bp.WORDS_PER_SLICE * 4
# Largest legal row id: op-log positions are u64 and pos = row*2^20+off.
MAX_ROW_ID = 1 << 44
# Rows per checksummed block of the block sync (reference: fragment.go:58).
HASH_BLOCK_SIZE = 100


class FragmentError(RuntimeError):
    pass


class ArchiveChecksumError(FragmentError):
    """A fragment tar whose payload does not match the checksum recorded
    in its "checksum" entry: restore rejects it before anything is
    applied (JAX ``core/fragment.py:225``)."""


@dataclass
class PairSet:
    """Parallel row and column-offset lists of one block's bits
    (reference: fragment.go:1509-1512)."""

    row_ids: list[int] = field(default_factory=list)
    column_ids: list[int] = field(default_factory=list)


_counters_mu = threading.Lock()
_counters = {"oplogRepair": 0, "walReplayedOps": 0}


def _count(name: str, n: int = 1) -> None:
    with _counters_mu:
        _counters[name] += n


def counters() -> dict:
    """Recovery counts of this process: op-logs cut back to their last
    whole record, and WAL ops replayed."""
    with _counters_mu:
        return dict(_counters)


def _log(msg: str) -> None:
    print(f"fragment: {msg}", file=sys.stderr)


# Process-unique fragment identities for the residency pool's keys: unlike
# id(), a serial is never reused by a later fragment.
_fragment_serials = itertools.count(1)

# Process-wide epochs the executor's batch cache validates against in O(1)
# (JAX ``core/fragment.py:82-96``): the write epoch moves at every content
# change of any fragment (a write, an import, a queued delta, a replay, a
# load, a close) and at a frame's quantum change; the mirror epoch (no JAX
# counterpart) moves whenever any fragment's mirror or sparse payloads are
# replaced, evicted or uploaded again, which changes the addresses a cached
# row table holds without changing a version.  Only when one moved does
# the cache compare each fragment's ``(serial, version, mirror generation)``.
# Bumped under a lock: a lost increment could leave an epoch unchanged
# across a write.
_epoch_mu = threading.Lock()
_write_epoch = 0
_mirror_epoch = 0


def bump_write_epoch() -> None:
    global _write_epoch
    with _epoch_mu:
        _write_epoch += 1


def _bump_mirror_epoch() -> None:
    global _mirror_epoch
    with _epoch_mu:
        _mirror_epoch += 1


def write_epoch() -> int:
    return _write_epoch


# Close listeners (JAX ``core/fragment.py:100-136``): bound methods, held
# weakly (an executor never closed is still collected), called with a
# fragment when it leaves service — a shutdown, or its view, frame or
# index deleted.  Read caches that hold a fragment's prepared state (the
# executor's TopN prep) drop its entries here instead of at displacement.
_close_listeners: list = []
_close_listeners_mu = threading.Lock()


def register_close_listener(method) -> None:
    with _close_listeners_mu:
        _close_listeners.append(weakref.WeakMethod(method))


def unregister_close_listener(method) -> None:
    with _close_listeners_mu:
        _close_listeners[:] = [wm for wm in _close_listeners if wm() not in (None, method)]


def _notify_close(frag) -> None:
    with _close_listeners_mu:
        listeners = [wm() for wm in _close_listeners]
        if None in listeners:
            _close_listeners[:] = [wm for wm in _close_listeners if wm() is not None]
    for fn in listeners:
        if fn is None:
            continue
        try:
            fn(frag)
        except Exception:  # noqa: BLE001 — a listener must not break a close
            pass


def mirror_epoch() -> int:
    return _mirror_epoch


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
    order; ``dense_pos`` are the positions among them that the scorer
    scores, ``sparse_pos`` those in the sparse tier, scored on the host
    from their offsets (``sparse_offs``, captured under the lock) against
    the src row's words (``Fragment.score_sparse``).
    ``done_ids``/``done_cnts`` short-circuit the src-less and empty cases
    with a final (filtered, sorted, trimmed) result; otherwise the scorer
    fills ``counts``, one score per dense position, and ``sparse_cnt``
    one per sparse position."""

    done_ids: np.ndarray | None = None
    done_cnts: np.ndarray | None = None
    cand_ids: np.ndarray | None = None
    cand_cached: np.ndarray | None = None
    dense_pos: np.ndarray | None = None
    sparse_pos: np.ndarray | None = None
    sparse_offs: list | None = None
    sparse_cnt: np.ndarray | None = None
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

    plane: torch.Tensor | None  # None: prepared for the host scorer
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
    """One frame-view x slice bit-plane with its device mirror, its
    sparse tier and caches."""

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
        dense_row_budget: int | None = None,
    ):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice_i
        # The slice's home member (JAX core/fragment.py:1335): its mirror,
        # paged sparse rows and zero rows live there.
        self.device = bp.home_device(slice_i, device_mod.placed(device))
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.max_op_n = max_op_n
        self.dense_row_budget = DENSE_ROW_BUDGET if dense_row_budget is None else dense_row_budget
        self.row_attr_store = None  # wired by View
        # Tagged by View._new_fragment (index, frame, view, slice); the
        # JAX package's counter names (reference: fragment.go:418-969).
        self.stats = NopStatsClient()
        self._max_row_id: int | None = None  # for the "rows" gauge, lazily
        # Residency-pool keys (device/pool.py): the plane mirror and the
        # paged sparse payloads are accounted apart.
        self._serial = next(_fragment_serials)
        self._pool_key = ("frag", self._serial, "mirror")
        self._sparse_pool_key = ("frag", self._serial, "sparse")
        # Content version, bumped at every change of the fragment's bits
        # (JAX ``core/fragment.py:369``), and the mirror generation, bumped
        # whenever the mirror or a sparse payload on the device is
        # replaced, evicted or uploaded again.
        self._version = 0
        self._mirror_gen = 0

        self._mu = threading.RLock()
        self._plane = bp.empty_plane(bp.ROW_BLOCK)
        self._slot_of: dict[int, int] = {}
        # Sparse tier: row id -> sorted uint32 in-slice offsets.  A write
        # replaces a row's array (never mutates it), so an array captured
        # under the lock stays a snapshot.
        self._sparse: dict[int, np.ndarray] = {}
        # Sparse rows' encoded payloads, (fmt, padded payload, nbytes) as
        # bitplane.encode_row gives them, dropped when the row is written
        # (the next read re-selects the format at the row's new density).
        self._payload_cache: dict[int, tuple] = {}
        # Sparse rows paged to the device: row id -> (fmt, int32 tensor of
        # the payload's real entries, encoded nbytes), LRU, and the sum of
        # their encoded bytes (the pool entry's size).  The tensors are
        # never written in place.
        self._sparse_dev: OrderedDict[int, tuple] = OrderedDict()
        self._sparse_dev_nbytes = 0
        self._count_of: dict[int, int] = {}
        self._op_n = 0
        # int32 bit-view mirror of _plane on self.device; None = stale
        # (rebuilt by the next device_plane()).
        self._mirror: torch.Tensor | None = None
        # Plane bits changed since the mirror was last brought up to
        # date, as int64 chunks of scatter.codes, and their total count.
        self._pending: list[np.ndarray] = []
        self._pending_n = 0
        self._file = None
        # Op-log records not yet written to the file (only while a WAL
        # writer is attached; see _append_op).
        self._op_buf = bytearray()
        # The WAL writer attached at open (ingest/wal.py), or None.
        self._wal = None
        # Set while a WAL replay writes: ops stay out of the op-log and
        # the WAL, and the auto-snapshot waits for the replay's end.
        self._replaying = False
        self.cache = cache_mod.new_cache(cache_type, cache_size)
        # Block checksums of blocks(), and the blocks a write has touched
        # since their checksum was taken (None: the block was empty).
        self._block_sums: dict[int, bytes | None] = {}
        self._dirty_blocks: set[int] = set()

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
                self._recover_wal()
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
        try:
            words, arrays, op_n = roaring.decode_tiered(data)
        except roaring.CorruptError as e:
            words, arrays, op_n = self._repair_torn_tail(data, e)
        self._load_tiered(words, arrays)
        self._op_n = op_n

    def _repair_torn_tail(self, data: bytes, err: roaring.CorruptError):
        """Cut an op-log torn by a crash mid-append back to its last whole
        record (JAX ``core/fragment.py:474-530``) and return the decoded
        prefix; re-raise ``err`` for damage that is not such a tail.  The
        window is the JAX package's group-commit flush plus two records:
        a data file a JAX node wrote may end in that much.  The prefix
        must decode before the file is touched."""
        try:
            torn = roaring.scan_torn_tail(data, max_tail=roaring.MAX_TORN_TAIL)
        except roaring.CorruptError:
            torn = None
        if torn is None:
            raise err
        valid_end, reason = torn
        try:
            decoded = roaring.decode_tiered(data[:valid_end])
        except roaring.CorruptError:
            raise err from None
        self._file.truncate(valid_end)
        self._file.flush()
        os.fsync(self._file.fileno())
        _count("oplogRepair")
        self.stats.count("oplogRepair")
        _log(f"{self.path}: repaired torn op-log tail ({reason}); dropped "
             f"{len(data) - valid_end} uncommitted bytes")
        return decoded

    def _recover_wal(self) -> None:
        """Attach the fragment to the WAL manager that owns its path,
        which replays its segment and keeps a writer
        (``IngestManager.attach``).  Where none does (the WAL is off), a
        segment found here is replayed by the same rules — a segment
        cut against another snapshot (stale) or whose ops do not extend
        the op-log (diverged) is discarded — and then removed: nothing
        logs to it, so it would be replayed again after the snapshot
        reset the op count, over whatever was written since."""
        if wal.attach_fragment(self):
            return
        path = wal.wal_path(self.path)
        seg = wal.load_segment(path)
        if seg is None:
            return
        snap_size, data_ops = wal._data_state(self)
        if seg.snap_size != snap_size:
            _log(f"discarding stale wal segment {path} "
                 f"(snap_size {seg.snap_size} != {snap_size})")
        elif not b"".join(p for _, _, p in seg.frames).startswith(data_ops):
            _log(f"discarding diverged wal segment {path} (data op-log is not a prefix "
                 f"of the logged ops; {len(seg.frames)} frames forfeited)")
        else:
            replayed = recovery.replay(self, seg)["replayed"]
            if replayed:
                self.snapshot()
                _log(f"{self.path}: replayed {replayed} wal ops"
                     + (f" (torn tail: {seg.problem})" if seg.torn else ""))
        os.remove(path)
        wal._fsync_dir(path)

    def _load_tiered(self, words: dict[int, np.ndarray], arrays: dict[int, np.ndarray]) -> None:
        """Fill both tiers from decoded containers (JAX ``_load_tiered``,
        ``core/fragment.py:1062``): the densest rows, up to the budget,
        go to the plane; every other row becomes an offset array."""
        cps = bp.CONTAINERS_PER_SLICE
        cbits = roaring.CONTAINER_BITS
        wpc = bp.WORDS_PER_CONTAINER
        counts: dict[int, int] = {}
        for key, w in words.items():
            r = int(key) // cps
            counts[r] = counts.get(r, 0) + bp.np_count(w)
        for key, vals in arrays.items():
            r = int(key) // cps
            counts[r] = counts.get(r, 0) + len(vals)
        by_density = sorted(counts, key=lambda r: (-counts[r], r))
        dense_rows = sorted(by_density[: self.dense_row_budget])
        slot_of = {r: i for i, r in enumerate(dense_rows)}
        plane = bp.empty_plane(bp.pad_rows(len(dense_rows)))
        segs: dict[int, list[np.ndarray]] = {r: [] for r in by_density[self.dense_row_budget:]}
        for key in sorted(set(words) | set(arrays)):
            r, cidx = divmod(int(key), cps)
            slot = slot_of.get(r)
            if key in words:
                if slot is not None:
                    plane[slot, cidx * wpc : (cidx + 1) * wpc] = words[key].view("<u4")
                    continue
                vals = roaring.words_to_values(words[key])
            else:
                vals = arrays[key]
                if slot is not None:
                    offs = vals.astype(np.int64) + cidx * cbits
                    bp.np_set_bulk(plane, np.full(len(offs), slot, np.int64), offs)
                    continue
            segs[r].append(vals.astype(np.uint32) + np.uint32(cidx * cbits))
        self._plane = plane
        self._slot_of = slot_of
        self._sparse = {
            r: np.concatenate(parts) if parts else np.empty(0, np.uint32)
            for r, parts in segs.items()
        }
        self._count_of = counts
        self._max_row_id = None
        self._payload_cache.clear()
        self._sparse_dev.clear()
        self._sync_sparse_pool_locked()
        self._block_sums.clear()
        self._dirty_blocks.clear()
        self._invalidate_device()
        self._changed_locked()

    def close(self) -> None:
        with self._mu:
            if self._wal is not None:
                # The final group commit; waiters resolve durable (or
                # fail with WalClosed when the commit fails).
                writer, self._wal = self._wal, None
                writer._manager.detach(writer)
            if self._file is not None:
                self._flush_ops_locked()
                self.flush_cache()
                fcntl.flock(self._file.fileno(), fcntl.LOCK_UN)
                self._file.close()
                self._file = None
            # Device memory goes back now, with both pool entries.
            self._invalidate_device()
            self._sparse_dev.clear()
            self._sync_sparse_pool_locked()
            # A fragment leaving service (shutdown, or a view, frame or
            # index deleted) invalidates the epoch-validated read caches.
            bump_write_epoch()
        # Outside the lock: listeners take their own locks.
        _notify_close(self)

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
            if isinstance(row_id, int) and self._has_row_locked(row_id):
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
    # geometry and tiers
    # ------------------------------------------------------------------

    def pos(self, row_id: int, column_id: int) -> int:
        """Bit position within the fragment (reference: fragment.go:476-484)."""
        min_col = self.slice * SLICE_WIDTH
        if not (min_col <= column_id < min_col + SLICE_WIDTH):
            raise FragmentError(
                f"column out of bounds: {column_id} not in slice {self.slice}"
            )
        return row_id * SLICE_WIDTH + (column_id % SLICE_WIDTH)

    def _has_row_locked(self, row_id: int) -> bool:
        return row_id in self._slot_of or row_id in self._sparse

    def _ensure_slot(self, row_id: int) -> int | None:
        """The row's plane slot, allocated on first touch while the dense
        budget lasts; None for a row in (or new to) the sparse tier
        (JAX ``core/fragment.py:714``)."""
        slot = self._slot_of.get(row_id)
        if slot is not None:
            return slot
        if row_id in self._sparse:
            return None
        if row_id >= MAX_ROW_ID:
            raise FragmentError(f"row id out of range: {row_id}")
        self._count_of[row_id] = 0
        if len(self._slot_of) >= self.dense_row_budget:
            self._sparse[row_id] = np.empty(0, dtype=np.uint32)
            return None
        slot = len(self._slot_of)
        self._slot_of[row_id] = slot
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

    def _maybe_promote(self, row_id: int) -> None:
        """A sparse row past PROMOTE_BITS moves to the plane while budget
        remains (JAX ``core/fragment.py:766``); answers never depend on
        it.  Rewriting a whole plane row is structural: the mirror is
        dropped."""
        offs = self._sparse.get(row_id)
        if offs is None or len(offs) <= PROMOTE_BITS or len(self._slot_of) >= self.dense_row_budget:
            return
        del self._sparse[row_id]
        self._payload_cache.pop(row_id, None)
        if self._sparse_dev.pop(row_id, None) is not None:
            self._sync_sparse_pool_locked()
        slot = len(self._slot_of)
        self._slot_of[row_id] = slot
        self._reserve(slot + 1)
        self._plane[slot] = bp.np_columns_to_row(offs)
        if self._mirror is not None:
            scatter.note_fallback()
        self._invalidate_device()

    # ------------------------------------------------------------------
    # device mirror maintenance (JAX: fragment.py:1263,1602-1682)
    # ------------------------------------------------------------------

    # A queue's cap, under the mirror-size rule of scatter.pending_limit.
    _MAX_DEVICE_PENDING = scatter.MAX_PENDING

    def _changed_locked(self) -> None:
        """The fragment's bits changed: a new version, and the write
        epoch moves."""
        self._version += 1
        bump_write_epoch()

    def _mirror_changed_locked(self) -> None:
        """The mirror was replaced, evicted or uploaded, or device payloads
        were evicted or replaced by a write: a new mirror generation, and
        the mirror epoch moves.  (A payload's page-in, or its page-out from
        the small LRU, changes no address a row table holds: tables name
        the rows K6 expanded into their scratch.)"""
        self._mirror_gen += 1
        _bump_mirror_epoch()

    def cache_state(self, row_id: int) -> tuple:
        """What a cached row table naming this fragment's row is valid for:
        ``(serial, version, mirror generation)`` for a plane row (the table
        holds its address in the mirror), the generation None for a sparse
        or absent row (the table holds a scratch copy, or the zero row)."""
        return self._serial, self._version, (self._mirror_gen if row_id in self._slot_of else None)

    def _invalidate_device(self) -> None:
        """Drop the mirror and its queued deltas: the next read uploads
        the host plane, which already holds every write.  The pool
        drops the mirror's entry with it."""
        self._mirror = None
        self._pending.clear()
        self._pending_n = 0
        self._mirror_changed_locked()
        device_mod.pool().remove(self._pool_key)

    def _pool_info(self) -> dict:
        return {"fragment": f"{self.index}/{self.frame}/{self.view}/{self.slice}",
                "slice": self.slice}

    def _evict_mirror(self) -> bool:
        """The pool's eviction hook for the mirror (JAX
        ``core/fragment.py:1279``): drop it and its queue together,
        under the fragment lock — the queued deltas describe the dropped
        tensor, and the next upload of the host plane already holds
        them.  Non-blocking: a fragment whose lock is taken is in use,
        and the pool skips it."""
        if not self._mu.acquire(blocking=False):
            return False
        try:
            self._mirror = None
            self._pending.clear()
            self._pending_n = 0
            self._mirror_changed_locked()
            return True
        finally:
            self._mu.release()

    def _evict_sparse_rows(self) -> bool:
        """The pool's eviction hook for the paged sparse payloads: page
        them all out (they page in again from the host offsets)."""
        if not self._mu.acquire(blocking=False):
            return False
        try:
            self._sparse_dev.clear()
            self._sparse_dev_nbytes = 0
            self._mirror_changed_locked()
            return True
        finally:
            self._mu.release()

    def _sync_sparse_pool_locked(self) -> None:
        """Account the paged sparse payloads again after they changed
        (page-in, a write, a promotion, a bulk load, close): their
        encoded bytes, with the dense bytes they stand for and their
        format mix as the entry's annotations (JAX
        ``core/fragment.py:1313``)."""
        self._sparse_dev_nbytes = sum(e[2] for e in self._sparse_dev.values())
        pool = device_mod.pool()
        if not self._sparse_dev:
            pool.remove(self._sparse_pool_key)
            return
        mix: dict[str, int] = {}
        for fmt, _dev, _nb in self._sparse_dev.values():
            name = bp.FMT_NAMES.get(fmt, str(fmt))
            mix[name] = mix.get(name, 0) + 1
        info = dict(self._pool_info(), logical_bytes=len(self._sparse_dev) * ROW_NBYTES,
                    formats=mix)
        pool.resize(self._sparse_pool_key, {self.device: self._sparse_dev_nbytes}, info=info)

    @property
    def plane_nbytes(self) -> int:
        """The host plane's bytes: what its mirror costs on the device,
        and what restart staging orders and accounts by."""
        return int(self._plane.nbytes)

    def _queue_locked(self, chunks: list[np.ndarray]) -> None:
        """Queue code chunks for the resident mirror; a queue that would
        pass its limit drops the mirror instead (the next read uploads
        the host plane, which already holds every write).  Without a
        mirror there is nothing to queue."""
        n = sum(len(c) for c in chunks)
        if n:
            # A queued delta is a change a cached row table must not
            # outlive, even before a read applies it.
            self._changed_locked()
        if self._mirror is None or n == 0:
            return
        limit = min(self._MAX_DEVICE_PENDING, scatter.pending_limit(self._mirror.shape[0]))
        if self._pending_n + n > limit:
            scatter.note_fallback()
            self._invalidate_device()
            return
        self._pending.extend(c for c in chunks if len(c))
        self._pending_n += n

    def _queue_device_update(self, slot: int, offset: int, op: int) -> None:
        """Queue one point write's bit (op 1 set, 0 clear)."""
        self._queue_locked([scatter.codes([slot], [offset], op)])

    def _queue_import_updates_locked(
        self, set_slots, set_offs, clr_slots=None, clr_offs=None
    ) -> None:
        """Queue an import's plane bits, set (op 1) and cleared (op 0)."""
        self._queue_locked([
            scatter.codes(slots, offs, op)
            for slots, offs, op in ((set_slots, set_offs, 1), (clr_slots, clr_offs, 0))
            if slots is not None
        ])

    def apply_pending_scatter(self) -> bool:
        """Apply this fragment's queue to its resident mirror NOW, as one
        delta-scatter launch, instead of at the next read.  Returns True
        when a launch was made."""
        with self._mu:
            if self._mirror is None or not self._pending_n:
                return False
            pool = device_mod.pool()
            held = pool.pin_many([self._pool_key])
            try:
                scatter.apply_many([(self._mirror, self._pending)])
            finally:
                pool.unpin_many(held)
            self._pending = []
            self._pending_n = 0
            return True

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def device_plane(self) -> torch.Tensor:
        """The int32 bit-view mirror of the plane on the fragment's
        device: its queue applied first (one K7 launch of its own, where
        no batched flush took it), uploaded when stale.  The upload is
        admitted through the residency pool first, so LRU mirrors are
        evicted to make room (JAX ``core/fragment.py:1347``); a failed
        upload leaves no entry and raises."""
        with self._mu:
            if self._mirror is None:
                self._upload_locked()
            else:
                device_mod.pool().touch(self._pool_key)
                self.apply_pending_scatter()
            return self._mirror

    def _upload_locked(self) -> None:
        pool = device_mod.pool()
        nbytes = self.plane_nbytes
        pool.admit(self._pool_key, {self.device: nbytes}, self._evict_mirror,
                   category="mirror", info=self._pool_info())
        try:
            self._mirror = bp.to_device(self._plane, self.device)
        except BaseException:
            pool.remove(self._pool_key)
            raise
        pool.count_restage(nbytes)
        self._pending.clear()
        self._pending_n = 0
        self._mirror_changed_locked()
        # Other owners that were busy while this one was admitted may be
        # free now: back to the budget, this mirror spared.
        pool.reclaim(exclude_key=self._pool_key)

    def stage_mirror(self) -> bool:
        """Upload the mirror if it is cold (the prefetcher's and restart
        staging's call); True when this call uploaded it.  An open
        fragment only."""
        with self._mu:
            if self._mirror is not None or self._file is None:
                return False
            self.device_plane()
            return True

    def device_row(self, row_id: int) -> torch.Tensor | None:
        """One row on the device, or None when the row is absent: a view
        of the mirror for a plane row; for a sparse row a new dense row,
        its payload expanded by one K6 launch."""
        with self._mu:
            leaf = self.device_leaf(row_id)
            if leaf is None:
                return None
            fmt, t = leaf
            if self._slot_of.get(row_id) is not None:
                return t
            row = torch.empty(bp.WORDS_PER_SLICE, dtype=torch.int32, device=self.device)
        expand_payload.expand_payloads([(fmt, t, row)])
        return row

    def device_leaf(self, row_id: int) -> tuple[int, torch.Tensor] | None:
        """The row as the K5/K6 kernels read it, or None when absent:
        ``(FMT_DENSE, mirror row view)`` for a plane row (queued deltas
        applied), ``(fmt, payload)`` for a sparse row — its compressed
        payload's real entries on the device, paged in on a miss."""
        with self._mu:
            slot = self._slot_of.get(row_id)
            if slot is not None:
                return bp.FMT_DENSE, self.device_plane()[slot]
            ent = self._sparse_dev_entry_locked(row_id)
            return None if ent is None else ent[:2]

    def device_row_ref(self, row_id: int) -> tuple[tuple | None, tuple]:
        """The row as a cached row table names it, and the state that
        name is valid for, read together under the lock: ``(("plane",
        mirror, slot) | ("payload", fmt, payload) | None, cache_state(row_id))``
        — a plane row of the mirror (queued deltas applied), a sparse
        row's device payload (paged in on a miss), or None when absent."""
        with self._mu:
            slot = self._slot_of.get(row_id)
            if slot is not None:
                ref = ("plane", self.device_plane(), slot)
            else:
                ent = self._sparse_dev_entry_locked(row_id)
                ref = None if ent is None else ("payload", ent[0], ent[1])
            return ref, self.cache_state(row_id)

    def _sparse_dev_entry_locked(self, row_id: int):
        """``(fmt, device payload, encoded nbytes)`` of a sparse row, paged
        in on a miss into the LRU (JAX ``core/fragment.py:1444``); None
        for an absent row."""
        offs = self._sparse.get(row_id)
        if offs is None:
            return None
        pool = device_mod.pool()
        ent = self._sparse_dev.get(row_id)
        if ent is not None:
            self._sparse_dev.move_to_end(row_id)
            pool.touch(self._sparse_pool_key)
            return ent
        fmt, payload, nbytes = self._host_payload_locked(row_id, offs)
        # Admitted at the compressed bytes before the upload.
        pool.admit(self._sparse_pool_key, {self.device: self._sparse_dev_nbytes + nbytes},
                   self._evict_sparse_rows, category="sparse", info=self._pool_info())
        try:
            dev = bp.to_device(bp.payload_entries(fmt, payload), self.device)
        except BaseException:
            self._sync_sparse_pool_locked()
            raise
        ent = self._sparse_dev[row_id] = (fmt, dev, nbytes)
        while len(self._sparse_dev) > SPARSE_DEVICE_CACHE:
            self._sparse_dev.popitem(last=False)
        self._sync_sparse_pool_locked()
        return ent

    def _host_payload_locked(self, row_id: int, offs) -> tuple:
        ent = self._payload_cache.get(row_id)
        if ent is None:
            ent = self._payload_cache[row_id] = bp.encode_row(offs)
        return ent

    def host_payload(self, row_id: int):
        """Host container view of any present row (JAX
        ``core/fragment.py:1486``): ``(fmt, payload, encoded_nbytes,
        cardinality)`` — a plane row as FMT_DENSE words (a view: callers
        copy, never mutate), a sparse row as its memoized encoding; None
        when absent."""
        with self._mu:
            slot = self._slot_of.get(row_id)
            if slot is not None:
                return bp.FMT_DENSE, self._plane[slot], ROW_NBYTES, self._count_of.get(row_id, 0)
            offs = self._sparse.get(row_id)
            if offs is None:
                return None
            fmt, payload, nbytes = self._host_payload_locked(row_id, offs)
            return fmt, payload, nbytes, len(offs)

    def row_positions(self, row_id: int) -> np.ndarray | None:
        """Sorted uint32 in-slice positions of a present row (the anchored
        count's anchor), or None."""
        with self._mu:
            slot = self._slot_of.get(row_id)
            if slot is not None:
                return bp.np_row_to_columns(self._plane[slot]).astype(np.uint32)
            offs = self._sparse.get(row_id)
            return None if offs is None else np.asarray(offs, dtype=np.uint32)

    def device_slots(self, row_ids) -> tuple[torch.Tensor, list[int]]:
        """The mirror (queued deltas applied) and the rows of ``row_ids``
        in it, -1 for a row not in the plane — read together under the
        lock, so the slots name rows of this mirror."""
        with self._mu:
            plane = self.device_plane()
            return plane, [self._slot_of.get(r, -1) for r in row_ids]

    def device_field_ref(self, row_ids) -> tuple[torch.Tensor, list[int], list[tuple]]:
        """:meth:`device_slots` with each row's :meth:`cache_state`, all
        read under one lock hold: a cached batch's plane rows of a BSI
        field and the state they are valid for."""
        with self._mu:
            plane = self.device_plane()
            return (plane, [self._slot_of.get(r, -1) for r in row_ids],
                    [self.cache_state(r) for r in row_ids])

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
            if slot is not None:
                return self._plane[slot].copy()
            offs = self._sparse.get(row_id)
            return None if offs is None else bp.np_columns_to_row(offs)

    def row(self, row_id: int) -> RowBitmap:
        """One row as a RowBitmap segment on the fragment's device
        (reference: fragment.go:340-375)."""
        with self._mu:
            seg = self.device_row(row_id)
            if seg is None:
                seg = torch.zeros(bp.WORDS_PER_SLICE, dtype=torch.int32, device=self.device)
            elif self._slot_of.get(row_id) is not None:
                seg = seg.clone()
            return RowBitmap.from_segment(self.slice, seg)

    def contains(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            offset = self.pos(row_id, column_id) % SLICE_WIDTH
            slot = self._slot_of.get(row_id)
            if slot is not None:
                return bp.np_contains(self._plane, slot * SLICE_WIDTH + offset)
            offs = self._sparse.get(row_id)
            if offs is None:
                return False
            i = int(np.searchsorted(offs, offset))
            return i < len(offs) and int(offs[i]) == offset

    def has_row(self, row_id: int) -> bool:
        with self._mu:
            return self._has_row_locked(row_id)

    def row_count(self, row_id: int) -> int:
        with self._mu:
            return self._count_of.get(row_id, 0)

    def count(self) -> int:
        with self._mu:
            return sum(self._count_of.values())

    # ------------------------------------------------------------------
    # writes (reference: fragment.go:379-473; JAX fragment.py:1535-1600)
    # ------------------------------------------------------------------

    def set_bit(self, row_id: int, column_id: int) -> bool:
        return self._point_write(row_id, column_id, roaring.OP_ADD)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            if not self._has_row_locked(row_id):
                self.pos(row_id, column_id)
                return False
        return self._point_write(row_id, column_id, roaring.OP_REMOVE)

    def _point_write(self, row_id: int, column_id: int, typ: int) -> bool:
        with self._mu:
            pos = self.pos(row_id, column_id)
            offset = pos % SLICE_WIDTH
            slot = self._ensure_slot(row_id)
            add = typ == roaring.OP_ADD
            if slot is not None:
                bit = slot * SLICE_WIDTH + offset
                write = bp.np_set_bit if add else bp.np_clear_bit
                changed = write(self._plane, bit)
                if changed:
                    self._queue_device_update(slot, offset, 1 if add else 0)
            else:
                changed = self._sparse_write(row_id, offset, add)
            if not changed:
                return False
            self._append_op(typ, pos)
            self._after_write(row_id, 1 if add else -1)
            if add:
                self.stats.count("setBit")  # reference: fragment.go:418
                if self._max_row_id is None:
                    self._max_row_id = max(self._count_of, default=-1)
                if row_id > self._max_row_id:
                    # reference: fragment.go:421-423
                    self._max_row_id = row_id
                    self.stats.gauge("rows", float(row_id))
                self._maybe_promote(row_id)
            else:
                self.stats.count("clearBit")  # reference: fragment.go:470
            return True

    def _sparse_write(self, row_id: int, offset: int, add: bool) -> bool:
        offs = self._sparse[row_id]
        i = int(np.searchsorted(offs, offset))
        present = i < len(offs) and int(offs[i]) == offset
        if add == present:
            return False
        self._sparse[row_id] = (
            np.insert(offs, i, np.uint32(offset)) if add else np.delete(offs, i)
        )
        return True

    def _after_write(self, row_id: int, delta: int) -> None:
        # Dropping the encoded payload is the format re-selection: the
        # next read encodes the row at its new density.
        self._payload_cache.pop(row_id, None)
        if self._sparse_dev.pop(row_id, None) is not None:
            self._mirror_changed_locked()
            self._sync_sparse_pool_locked()
        self._changed_locked()
        self._dirty_blocks.add(row_id // HASH_BLOCK_SIZE)
        n = self._count_of[row_id] = self._count_of.get(row_id, 0) + delta
        self.cache.add(row_id, n)
        self._op_n += 1
        if self._op_n >= self.max_op_n and not self._replaying:
            self.snapshot()

    # The op buffer is written out once it holds this many bytes (~5k ops).
    _OP_FLUSH_BYTES = roaring.OP_FLUSH_BYTES

    def _append_op(self, typ: int, pos: int) -> None:
        """Record a changed op (not while a replay writes: its ops are
        already logged).  With a WAL writer the record is buffered for
        the op-log and logged to the WAL, whose fsync the acknowledgement
        waits for (JAX ``core/fragment.py:1707``): the op-log stays a
        prefix of the WAL's ops, which recovery requires.  Without one
        it is written to the file at once."""
        if self._file is None or self._replaying:
            return
        op = roaring.encode_op(typ, pos)
        if self._wal is None:
            self._file.seek(0, os.SEEK_END)
            self._file.write(op)
            self._file.flush()
            return
        self._op_buf += op
        if len(self._op_buf) >= self._OP_FLUSH_BYTES:
            self._flush_ops_locked()
        try:
            self._wal.log(typ, pos)
        except wal.WalClosed:
            # A shutdown race: the writer closed under us.
            pass

    def _flush_ops_locked(self) -> None:
        if self._op_buf and self._file is not None:
            self._file.seek(0, os.SEEK_END)
            self._file.write(self._op_buf)
            self._file.flush()
        self._op_buf.clear()

    def import_bulk(
        self,
        row_ids: Sequence[int],
        column_ids: Sequence[int],
        clear_row_ids: Sequence[int] | None = None,
        clear_column_ids: Sequence[int] | None = None,
    ) -> None:
        """Bulk load (reference: fragment.go:936-1004; JAX
        ``core/fragment.py:1735``): plane rows take a vectorized scatter
        on the host, their counts moved by the popcount change of the
        words it wrote, and the bits are queued for the mirror (see
        ``_queue_import_updates_locked``); sparse rows merge their sorted
        offsets; then rows past PROMOTE_BITS move to the plane, and a
        snapshot.  Nothing here touches the device.

        ``clear_row_ids``/``clear_column_ids`` clear bits in the same
        pass — the overwrite half of a BSI value import.  Clears never
        create rows: a clear on an absent row does nothing.  A bit must
        not appear in both lists."""
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
            if len(rows) and int(rows.max()) >= MAX_ROW_ID:
                raise FragmentError(f"row id out of range: {int(rows.max())}")
            offs = cols % SLICE_WIDTH
            uniq = np.unique(rows)
            # Size the plane once for every row this import can add.
            n_new = sum(1 for r in uniq if not self._has_row_locked(int(r)))
            self._reserve(min(len(self._slot_of) + n_new, self.dense_row_budget))
            slot_of = {int(r): self._ensure_slot(int(r)) for r in uniq}
            slot_table = np.asarray(
                [-1 if slot_of[int(r)] is None else slot_of[int(r)] for r in uniq], dtype=np.int64
            )
            slots = slot_table[np.searchsorted(uniq, rows)] if len(rows) else np.empty(0, np.int64)
            dm = slots >= 0
            set_slots, set_offs = slots[dm], offs[dm]
            if not dm.all():
                s_rows = rows[~dm]
                s_offs = offs[~dm].astype(np.uint32)
                order = np.lexsort((s_offs, s_rows))
                s_rows, s_offs = s_rows[order], s_offs[order]
                first = np.ones(len(s_rows), dtype=bool)
                first[1:] = (s_rows[1:] != s_rows[:-1]) | (s_offs[1:] != s_offs[:-1])
                s_rows, s_offs = s_rows[first], s_offs[first]
                u_s, starts = np.unique(s_rows, return_index=True)
                bounds = np.append(starts, len(s_rows))
                for i, r in enumerate(u_s.tolist()):
                    seg = s_offs[bounds[i] : bounds[i + 1]]
                    cur = self._sparse[r]
                    if len(cur):
                        seg = np.union1d(cur, seg).astype(np.uint32)
                    self._sparse[r] = seg
            c_slots = c_offs = None
            if len(clear_row_ids):
                c_rows = np.asarray(clear_row_ids, dtype=np.int64)
                c_cols = np.asarray(clear_column_ids, dtype=np.int64)
                if ((c_cols < min_col) | (c_cols >= min_col + SLICE_WIDTH)).any():
                    raise FragmentError("column out of bounds for slice")
                c_all = c_cols % SLICE_WIDTH
                c_uniq = np.unique(c_rows)
                c_table = np.asarray(
                    [self._slot_of.get(int(r), -1) for r in c_uniq], dtype=np.int64
                )
                c_all_slots = c_table[np.searchsorted(c_uniq, c_rows)]
                keep = c_all_slots >= 0
                c_slots, c_offs = c_all_slots[keep], c_all[keep]
                for r, slot in zip(c_uniq, c_table):
                    r = int(r)
                    if slot >= 0:
                        slot_of[r] = int(slot)
                    elif r in self._sparse:
                        self._sparse[r] = np.setdiff1d(
                            self._sparse[r], c_all[c_rows == r].astype(np.uint32)
                        ).astype(np.uint32)
                        slot_of[r] = None
            deltas = self._plane_write(set_slots, set_offs, c_slots, c_offs)
            self._queue_import_updates_locked(set_slots, set_offs, c_slots, c_offs)
            for r, slot in slot_of.items():
                if slot is None:
                    self._payload_cache.pop(r, None)
                    if self._sparse_dev.pop(r, None) is not None:
                        self._mirror_changed_locked()
            self._sync_sparse_pool_locked()
            self._recount(slot_of, deltas)
            self._changed_locked()
            self._dirty_blocks.update(r // HASH_BLOCK_SIZE for r in slot_of)
            for r in slot_of:
                self._maybe_promote(r)
            self.stats.count("ImportBit", len(row_ids))  # reference: fragment.go:969
            self.snapshot()

    def install_plane(self, plane: np.ndarray) -> None:
        """Replace the fragment's content with ``plane`` (uint32
        [rows, 32768], plane[r] = row id r; all-zero rows stay absent);
        see :meth:`install_rows`."""
        plane = np.asarray(plane, dtype=np.uint32)
        if plane.ndim != 2 or plane.shape[1] != bp.WORDS_PER_SLICE:
            raise FragmentError(f"plane must be [rows, {bp.WORDS_PER_SLICE}] uint32")
        rows = np.flatnonzero(plane.any(axis=1))
        self.install_rows(rows, plane[rows])

    def install_rows(self, row_ids, words: np.ndarray, sparse: dict | None = None) -> None:
        """Replace the fragment's content with rows ``row_ids`` (words
        ``words[i]``, uint32 [n, 32768]) and ``sparse`` ({row id: sorted
        in-slice offsets}, the JAX package's sparse tier) — the densest
        rows up to the budget in the plane, the rest sparse, as on open;
        empty rows stay absent.  Then the rank cache is recounted from the
        host, the mirror uploads and the fragment snapshots."""
        words = np.asarray(words, dtype=np.uint32).reshape(-1, bp.WORDS_PER_SLICE)
        row_ids = np.asarray(row_ids, dtype=np.int64)
        if len(row_ids) != len(words):
            raise FragmentError("row_ids and words differ in length")
        sparse = {int(r): np.asarray(o, dtype=np.uint32) for r, o in (sparse or {}).items()}
        counts = {int(r): int(c) for r, c in zip(row_ids, bp.np_row_counts(words))}
        if set(counts) & set(sparse):
            raise FragmentError("a row is given in both tiers")
        counts.update((r, len(o)) for r, o in sparse.items())
        counts = {r: c for r, c in counts.items() if c > 0}
        if counts and max(counts) >= MAX_ROW_ID:
            raise FragmentError(f"row id out of range: {max(counts)}")
        by_density = sorted(counts, key=lambda r: (-counts[r], r))
        dense_rows = sorted(by_density[: self.dense_row_budget])
        where = {int(r): i for i, r in enumerate(row_ids)}
        with self._mu:
            self._plane = bp.empty_plane(bp.pad_rows(len(dense_rows)))
            self._slot_of = {r: i for i, r in enumerate(dense_rows)}
            for r, slot in self._slot_of.items():
                i = where.get(r)
                self._plane[slot] = words[i] if i is not None else bp.np_columns_to_row(sparse[r])
            self._sparse = {}
            for r in by_density[self.dense_row_budget :]:
                i = where.get(r)
                self._sparse[r] = (
                    bp.np_row_to_columns(words[i]).astype(np.uint32) if i is not None else sparse[r]
                )
            self._count_of = {}
            self._max_row_id = None
            self._payload_cache.clear()
            self._sparse_dev.clear()
            self._sync_sparse_pool_locked()
            self._block_sums.clear()
            self._dirty_blocks.clear()
            self.cache = cache_mod.new_cache(self.cache_type, self.cache_size)
            self.cache.stats = self.stats
            self._invalidate_device()
            self._recount({**self._slot_of, **{r: None for r in self._sparse}},
                          {s: counts[r] for r, s in self._slot_of.items()})
            self._changed_locked()
            self._upload_locked()
            self.snapshot()

    def _plane_write(self, set_slots, set_offs, clr_slots=None, clr_offs=None) -> dict:
        """Set and clear plane bits (a bit is never in both lists) and
        return ``{slot: change in the row's count}``, from the popcounts
        of the words written, before and after: the cost is the bits'
        words, not the rows'."""
        parts = [(a, o) for a, o in ((set_slots, set_offs), (clr_slots, clr_offs))
                 if a is not None and len(a)]
        if not parts:
            return {}
        width = bp.WORDS_PER_SLICE
        keys = np.unique(np.concatenate(
            [np.asarray(a, np.int64) * width + np.asarray(o, np.int64) // bp.WORD_BITS
             for a, o in parts]))
        flat = self._plane.reshape(-1)
        before = bp.np_popcounts(flat[keys])
        if set_slots is not None and len(set_slots):
            bp.np_set_bulk(self._plane, set_slots, set_offs)
        if clr_slots is not None and len(clr_slots):
            bp.np_clear_bulk(self._plane, clr_slots, clr_offs)
        delta = bp.np_popcounts(flat[keys]) - before
        slots, inv = np.unique(keys // width, return_inverse=True)
        sums = np.zeros(len(slots), np.int64)
        np.add.at(sums, inv, delta)
        return dict(zip(slots.tolist(), sums.tolist()))

    def _recount(self, slot_of: dict[int, int | None], deltas: dict) -> None:
        """Exact counts of ``slot_of``'s rows from the host — a plane row
        (a slot) moves by ``deltas[slot]``, a sparse row (None) counts
        its offsets — and the rank cache follows, plane rows first and
        then sparse rows, each in ``slot_of``'s order, as the JAX
        package adds them (``core/fragment.py:1867-1879``): a ranked
        cache prunes as it goes, so the order decides which rows past its
        size it keeps, and so the bytes of its ``.cache`` file and of an
        archive.  Nothing here reads the device."""
        for r, s in slot_of.items():
            self._count_of[r] = (len(self._sparse[r]) if s is None
                                 else self._count_of.get(r, 0) + deltas.get(s, 0))
        for dense in (True, False):
            for r, s in slot_of.items():
                if (s is not None) == dense:
                    self.cache.bulk_add(r, self._count_of[r])
        self.cache.invalidate()
        self.cache.recalculate()

    def snapshot(self) -> None:
        """Full roaring serialization atomically renamed over the data
        file; resets the op count (reference: fragment.go:1032-1074) and
        restarts the WAL segment (JAX ``core/fragment.py:1891``)."""
        with self._mu:
            t0 = time.perf_counter()
            # Buffered ops are in the serialized state below.
            self._op_buf.clear()
            data = roaring.encode_tiered(*self._containers())
            tmp = self.path + ".snapshotting"
            with open(tmp, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            if self._file is not None:
                fcntl.flock(self._file.fileno(), fcntl.LOCK_UN)
                self._file.close()
            os.replace(tmp, self.path)
            # The rename is durable once its directory entry is: only
            # then may the segment be truncated.
            wal._fsync_dir(self.path)
            self._file = open(self.path, "a+b")
            fcntl.flock(self._file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            self._op_n = 0
            if self._wal is not None:
                # The snapshot holds every op the segment covers; its
                # size names the snapshot the new segment is cut against.
                self._wal.truncate_segment(len(data))
            # reference: fragment.go:1026-1030
            self.stats.histogram("snapshot", time.perf_counter() - t0)

    def _containers(self) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray]]:
        """Both tiers as roaring containers (JAX ``_containers_packed``,
        ``core/fragment.py:1116``): plane rows as {key: uint64[1024]
        words}, non-empty containers only; sparse rows as {key: sorted
        uint32 in-container values}, never through a plane row.  The
        encoder picks each container's form by its count, so the bytes
        do not depend on the tier."""
        cps = bp.CONTAINERS_PER_SLICE
        wpc = bp.WORDS_PER_CONTAINER
        cbits = roaring.CONTAINER_BITS
        words: dict[int, np.ndarray] = {}
        arrays: dict[int, np.ndarray] = {}
        items = sorted(self._slot_of.items())
        # Plane rows in blocks of 256 (32 MiB): a container the encoder
        # writes as an array is read as values from its nonzero words, so
        # a tall plane of mostly-empty rows costs its set bits, not a
        # 64K-bit unpack per container.
        for b in range(0, len(items), 256):
            rids = np.asarray([r for r, _ in items[b : b + 256]], dtype=np.int64)
            blk = self._plane[[s for _, s in items[b : b + 256]]].reshape(-1, wpc)
            keys = (rids[:, None] * cps + np.arange(cps)).ravel()
            n = bp.np_row_counts(blk)
            for i in np.flatnonzero(n > roaring.ARRAY_MAX_SIZE):
                words[int(keys[i])] = blk[i].view(np.uint64)
            small = np.flatnonzero((n > 0) & (n <= roaring.ARRAY_MAX_SIZE))
            if not len(small):
                continue
            ci, wi = np.nonzero(blk[small])
            w = blk[small[ci], wi]
            mi, bi = np.nonzero(np.unpackbits(w.view(np.uint8).reshape(-1, 4), axis=1,
                                              bitorder="little"))
            vals = (wi[mi] * bp.WORD_BITS + bi).astype(np.uint32)
            bounds = np.searchsorted(ci[mi], np.arange(len(small) + 1))
            for j, i in enumerate(small.tolist()):
                arrays[int(keys[i])] = vals[bounds[j] : bounds[j + 1]]
        sp_rows = sorted(r for r, o in self._sparse.items() if len(o))
        if sp_rows:
            lens = np.asarray([len(self._sparse[r]) for r in sp_rows])
            rows_rep = np.repeat(np.asarray(sp_rows, dtype=np.int64), lens)
            offs_all = np.concatenate([self._sparse[r] for r in sp_rows]).astype(np.int64)
            keys_all = rows_rep * cps + offs_all // cbits
            vals_all = (offs_all % cbits).astype(np.uint32)
            uniq_keys, starts = np.unique(keys_all, return_index=True)
            bounds = np.append(starts, len(vals_all))
            for j, k in enumerate(uniq_keys):
                arrays[int(k)] = vals_all[bounds[j] : bounds[j + 1]]
        return words, arrays

    # ------------------------------------------------------------------
    # block checksums and sync (reference: fragment.go:694-934; JAX
    # core/fragment.py:2301-2455)
    # ------------------------------------------------------------------

    def checksum(self) -> bytes:
        """SHA1 over the block checksums (reference: fragment.go:694-701)."""
        h = hashlib.sha1()
        for _, chk in self.blocks():
            h.update(chk)
        return h.digest()

    def blocks(self) -> list[tuple[int, bytes]]:
        """``[(block id, sha1)]`` per ``HASH_BLOCK_SIZE`` rows, empty blocks
        left out (reference: fragment.go:717-796).  A block's checksum is
        the SHA1 of its bits' row ids then their column offsets, each a
        little-endian uint64 in (row, offset) order — the JAX package's
        bytes, so checksums agree across packages, tiers and replicas.  A
        checksum is kept until a write marks its block dirty."""
        with self._mu:
            by_block: dict[int, list[int]] = {}
            for r in itertools.chain(self._slot_of, self._sparse):
                by_block.setdefault(r // HASH_BLOCK_SIZE, []).append(r)
            out = []
            for block_id in sorted(by_block):
                if block_id in self._block_sums and block_id not in self._dirty_blocks:
                    chk = self._block_sums[block_id]
                else:
                    chk = self._block_sum_locked(sorted(by_block[block_id]))
                    self._block_sums[block_id] = chk
                    self._dirty_blocks.discard(block_id)
                if chk is not None:
                    out.append((block_id, chk))
            return out

    def _block_sum_locked(self, rows: list[int]) -> bytes | None:
        """One block's checksum from its rows (ascending), hashed a row at
        a time: the row-id half first, then the offsets; None when the
        block holds no bit."""
        segs = [(r, self._row_offsets_locked(r)) for r in rows]
        segs = [(r, offs) for r, offs in segs if len(offs)]
        if not segs:
            return None
        h = hashlib.sha1()
        for r, offs in segs:
            h.update(np.full(len(offs), r, dtype="<u8"))
        for _, offs in segs:
            # Plane rows' int64 offsets are their own little-endian bytes.
            h.update(offs.view("<u8") if offs.dtype == np.int64 else offs.astype("<u8"))
        return h.digest()

    def _row_offsets_locked(self, row_id: int) -> np.ndarray:
        """Sorted in-slice offsets of a row in either tier (empty when
        absent): int64 for a plane row (its unpacked bits, read as bools),
        the uint32 array of a sparse row."""
        slot = self._slot_of.get(row_id)
        if slot is not None:
            bits = np.unpackbits(self._plane[slot].view(np.uint8), bitorder="little")
            return np.flatnonzero(bits.view(bool))
        offs = self._sparse.get(row_id)
        return np.empty(0, np.int64) if offs is None else offs

    def _block_positions(self, block_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Sorted (rows, column offsets), int64, of every bit of a block,
        from both tiers."""
        lo = block_id * HASH_BLOCK_SIZE
        hi = lo + HASH_BLOCK_SIZE
        rows = sorted(r for r in itertools.chain(self._slot_of, self._sparse) if lo <= r < hi)
        segs = [(r, self._row_offsets_locked(r).astype(np.int64, copy=False)) for r in rows]
        segs = [(r, offs) for r, offs in segs if len(offs)]
        if not segs:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        lens = [len(offs) for _, offs in segs]
        rws = np.repeat(np.asarray([r for r, _ in segs], dtype=np.int64), lens)
        return rws, np.concatenate([offs for _, offs in segs])

    def block_arrays(self, block_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Every bit of a block as (rows, column offsets), int64 arrays in
        (row, offset) order: what ``/fragment/block/data`` encodes."""
        with self._mu:
            return self._block_positions(block_id)

    def block_data(self, block_id: int) -> PairSet:
        """Every (row, column offset) bit of a block (reference:
        fragment.go:798-808)."""
        rws, cls = self.block_arrays(block_id)
        return PairSet(row_ids=rws.tolist(), column_ids=cls.tolist())

    def merge_block(self, block_id: int, data: list[PairSet]) -> tuple[list[PairSet], list[PairSet]]:
        """Majority merge of the replicas' data of a block (reference:
        fragment.go:810-934): a bit is set where at least (n + 2) // 2 of
        the n + 1 participants (this fragment first) have it.  The local
        difference is applied here; returns (sets, clears) for each
        remote participant.  The clears are computed from the clear
        positions, as in the JAX package, not from the sets as the
        reference's fragment.go:913 does."""
        for i, ps in enumerate(data):
            if len(ps.row_ids) != len(ps.column_ids):
                raise FragmentError(
                    f"pair set mismatch(idx={i}): {len(ps.row_ids)} != {len(ps.column_ids)}"
                )
        with self._mu:
            lo_row = block_id * HASH_BLOCK_SIZE
            hi_row = lo_row + HASH_BLOCK_SIZE
            participants = [self.block_data(block_id)] + list(data)

            def to_pos(ps: PairSet) -> np.ndarray:
                if not ps.row_ids:
                    return np.empty(0, dtype=np.int64)
                r = np.asarray(ps.row_ids, dtype=np.int64)
                c = np.asarray(ps.column_ids, dtype=np.int64)
                keep = (r >= lo_row) & (r < hi_row) & (c >= 0) & (c < SLICE_WIDTH)
                return np.unique(r[keep] * SLICE_WIDTH + c[keep])

            pos_sets = [to_pos(ps) for ps in participants]
            all_pos = np.concatenate(pos_sets)
            if all_pos.size == 0:
                return [PairSet() for _ in data], [PairSet() for _ in data]
            uniq, votes = np.unique(all_pos, return_counts=True)
            consensus = votes >= (len(participants) + 1) // 2

            def pairs(pos: np.ndarray) -> PairSet:
                return PairSet(row_ids=(pos // SLICE_WIDTH).tolist(),
                               column_ids=(pos % SLICE_WIDTH).tolist())

            sets_out, clears_out = [], []
            for pos in pos_sets:
                has = np.isin(uniq, pos)
                sets_out.append(pairs(uniq[consensus & ~has]))
                clears_out.append(pairs(uniq[~consensus & has]))
            base = self.slice * SLICE_WIDTH
            for r, c in zip(sets_out[0].row_ids, sets_out[0].column_ids):
                self.set_bit(r, base + c)
            for r, c in zip(clears_out[0].row_ids, clears_out[0].column_ids):
                self.clear_bit(r, base + c)
            return sets_out[1:], clears_out[1:]

    # ------------------------------------------------------------------
    # archive backup and restore (reference: fragment.go:1112-1283; JAX
    # core/fragment.py:2457-2600)
    # ------------------------------------------------------------------

    def _archive_payloads(self) -> list[tuple[str, bytes]]:
        """The archive's entries from one consistent snapshot taken under
        the lock (the tar is written outside it): "checksum" (the sha256
        of every other entry, JSON), "data" (the roaring file, no
        op-log) and "cache" (the ranked cache's row ids)."""
        with self._mu:
            data = roaring.encode_tiered(*self._containers())
            cache_data = encode_cache_ids(self.cache.ids())
        sums = json.dumps(
            {
                "algo": "sha256",
                "entries": {
                    "data": hashlib.sha256(data).hexdigest(),
                    "cache": hashlib.sha256(cache_data).hexdigest(),
                },
            },
            separators=(",", ":"),
        ).encode()
        return [("checksum", sums), ("data", data), ("cache", cache_data)]

    @staticmethod
    def _write_archive(entries: list[tuple[str, bytes]], w) -> None:
        tw = tarfile.open(fileobj=w, mode="w|")
        for name, payload in entries:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            info.mtime = int(time.time())
            tw.addfile(info, io.BytesIO(payload))
        tw.close()

    def write_to(self, w) -> None:
        """Write the archive, a tar of "checksum", "data" and "cache"."""
        self._write_archive(self._archive_payloads(), w)

    def tar_chunks(self, chunk_bytes: int = 0) -> Iterable[bytes]:
        """The archive as a generator of bounded chunks: the tar writer
        runs on a producer thread against a ChunkPipe, so the HTTP layer
        pulls chunks with backpressure and the tar is never held whole."""
        from pilosa_tpu_torch import stream as stream_mod

        entries = self._archive_payloads()
        return stream_mod.generate_from_writer(
            lambda w: self._write_archive(entries, w), chunk_bytes=chunk_bytes
        )

    @staticmethod
    def _verify_archive_payloads(payloads: dict[str, bytes]) -> None:
        """Check every entry against the archive's "checksum" entry (an
        archive without one installs unverified, as the reference's do);
        raises :class:`ArchiveChecksumError` before anything is applied."""
        chk = payloads.pop("checksum", None)
        if chk is None:
            return
        try:
            entries = json.loads(chk).get("entries", {})
        except (ValueError, AttributeError) as e:
            raise ArchiveChecksumError(
                f"fragment archive has an unreadable checksum entry: {e}"
            ) from e
        for name, want in entries.items():
            payload = payloads.get(name)
            if payload is None:
                continue
            got = hashlib.sha256(payload).hexdigest()
            if got != want:
                raise ArchiveChecksumError(
                    f"fragment archive entry {name!r} is torn: sha256 "
                    f"{got[:12]}… != recorded {str(want)[:12]}…"
                )

    def read_from(self, r) -> None:
        """Restore from an archive of :meth:`write_to`: every entry is read
        and verified first (a rejected archive changes nothing), then the
        data replaces both tiers — the mirror, its queued deltas and the
        device payloads dropped with them, a new version and both epochs
        moved, so no cached batch outlives it — and is made durable as a
        snapshot is (fsynced ``.snapshotting`` file, rename, directory
        fsync, the lock taken again, the WAL segment restarted); then the
        ranked cache is rebuilt from the "cache" entry."""
        with self._mu:
            tr = tarfile.open(fileobj=r, mode="r|")
            payloads: dict[str, bytes] = {}
            for member in tr:
                payloads[member.name] = tr.extractfile(member).read()
            tr.close()
            self._verify_archive_payloads(payloads)
            payload = payloads.get("data")
            if payload is not None:
                words, arrays, _ = roaring.decode_tiered(payload)
                self._load_tiered(words, arrays)
                self._op_n = 0
                self._op_buf.clear()
                tmp = self.path + ".snapshotting"
                with open(tmp, "wb") as fh:
                    fh.write(payload)
                    fh.flush()
                    os.fsync(fh.fileno())
                if self._file is not None:
                    fcntl.flock(self._file.fileno(), fcntl.LOCK_UN)
                    self._file.close()
                os.replace(tmp, self.path)
                wal._fsync_dir(self.path)
                self._file = open(self.path, "a+b")
                fcntl.flock(self._file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                if self._wal is not None:
                    # The restored contents replace all the segment
                    # described: it restarts against the new file.
                    self._wal.truncate_segment(len(payload))
            cache_payload = payloads.get("cache")
            if cache_payload is not None:
                ids = decode_cache_ids(cache_payload)
                if ids is not None:
                    self.cache = cache_mod.new_cache(self.cache_type, self.cache_size)
                    self.cache.stats = self.stats
                    for row_id in ids:
                        if isinstance(row_id, int) and self._has_row_locked(row_id):
                            self.cache.bulk_add(row_id, self._count_of.get(row_id, 0))
                    self.cache.invalidate()
                    # A new ranked cache changes TopN's candidates without a
                    # write: a cache-only archive moves the epoch too.
                    bump_write_epoch()

    # ------------------------------------------------------------------
    # export (reference: fragment.go:487-502; JAX core/fragment.py:2602-2665)
    # ------------------------------------------------------------------

    def _iter_row_offsets(self) -> Iterable[tuple[int, np.ndarray]]:
        """``(row id, sorted uint64 in-slice offsets)`` of every non-empty
        row, ascending, the lock taken a row at a time: one row is
        unpacked at once, never the plane."""
        with self._mu:
            rows = sorted(set(self._slot_of) | set(self._sparse))
        for r in rows:
            with self._mu:
                if not self._has_row_locked(r):
                    continue
                offs = self._row_offsets_locked(r)
            if len(offs):
                yield r, offs

    def for_each_bit(self) -> Iterable[tuple[int, int]]:
        """Yield (row id, absolute column id) for every set bit."""
        base = self.slice * SLICE_WIDTH
        for r, offs in self._iter_row_offsets():
            for c in offs:
                yield r, base + int(c)

    def csv_chunks(self, chunk_pairs: int = 1 << 20) -> Iterable[bytes]:
        """The CSV export: ``row,col\\n`` records, rows ascending, in chunks
        of up to ``chunk_pairs`` records formatted a row block at a time."""
        base = self.slice * SLICE_WIDTH
        pend_r: list[np.ndarray] = []
        pend_c: list[np.ndarray] = []
        pending = 0
        for r, offs in self._iter_row_offsets():
            pend_r.append(np.full(len(offs), r, dtype=np.uint64))
            pend_c.append(offs.astype(np.uint64) + np.uint64(base))
            pending += len(offs)
            if pending >= chunk_pairs:
                yield self._format_pairs(np.concatenate(pend_r), np.concatenate(pend_c))
                pend_r, pend_c, pending = [], [], 0
        if pending:
            yield self._format_pairs(np.concatenate(pend_r), np.concatenate(pend_c))

    @staticmethod
    def _format_pairs(rws: np.ndarray, cls: np.ndarray) -> bytes:
        """``row,col\\n`` records of two uint64 arrays through the native
        formatter (JAX ``core/fragment.py:2652``), else the numpy path,
        which writes the same bytes."""
        from pilosa_tpu_torch import native

        blob = native.format_csv(rws, cls)
        if blob is not None:
            return blob
        out = np.char.add(
            np.char.add(rws.astype("S20"), b","),
            np.char.add(cls.astype("S20"), b"\n"),
        )
        return b"".join(out.tolist())

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
        if st.sparse_pos is not None and len(st.sparse_pos):
            self.score_sparse(st, bp.to_host(src))
        return self.top_finish(st)

    def top_prepare_parts(self, opt: TopOptions | None = None, host: bool = False):
        """The scoring pass up to the scorer launch (JAX
        ``core/fragment.py:1951``): ``(TopState, SubRef or None, src
        row or None)``, so the executor can score many fragments in one
        launch.  ``host``: for the host scorer, touching no card (the
        SubRef holds no plane, the src row stays where it is)."""
        opt = opt or TopOptions()
        with self._mu:
            ids, cnts = self._top_candidates_arrays(opt.row_ids)
        return self._top_score_parts(ids, cnts, opt, bool(opt.row_ids), host)

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
        host: bool = False,
    ):
        """A scoring pass without the scorer launch (JAX
        ``core/fragment.py:2074``): ``(TopState, SubRef or None, src row
        or None)``.  ``ids``/``cached`` are the unfiltered candidates in
        count-descending order; ``row_ids_mode`` returns every scored
        row (n applies only to cache candidates, reference:
        fragment.go:516).  ``host``: the slots come from the host plane's
        slot map (the mirror's layout) and no mirror is read, so a
        quarantined card is not touched."""
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
        with self._mu:
            if host:
                plane, slots = None, [self._slot_of.get(r, -1) for r in ids]
            else:
                plane, slots = self.device_slots(ids)
            slots = np.asarray(slots, dtype=np.int64)
            dense_pos = np.flatnonzero(slots >= 0)
            # Sparse candidates (the low-count tail) are scored on the host
            # from their offsets (JAX ``core/fragment.py:2152-2160``); the
            # arrays captured here are snapshots (writes replace them).
            sparse_pos = np.asarray(
                [k for k in np.flatnonzero(slots < 0) if int(ids[k]) in self._sparse], np.int64
            )
            sparse_offs = [self._sparse[int(ids[k])] for k in sparse_pos]
        if not len(dense_pos) and not len(sparse_pos):
            return empty, None, None
        sub = SubRef(plane=plane, slots=slots[dense_pos]) if len(dense_pos) else None
        st = TopState(
            cand_ids=ids,
            cand_cached=cached,
            dense_pos=dense_pos,
            sparse_pos=sparse_pos,
            sparse_offs=sparse_offs,
            n=n,
            tanimoto=tanimoto,
            src_count=src_count,
            min_threshold=opt.min_threshold,
        )
        return st, sub, src if host else src.to(plane.device).contiguous()

    @staticmethod
    def score_sparse(st: TopState, src_words: np.ndarray) -> None:
        """Fill ``st.sparse_cnt``: each sparse candidate's count of its
        offsets set in ``src_words`` (the src row's uint32 words on the
        host)."""
        offs = st.sparse_offs
        lens = np.fromiter((len(o) for o in offs), np.int64, len(offs))
        if not lens.sum():
            st.sparse_cnt = np.zeros(len(offs), np.int64)
            return
        allo = np.concatenate(offs).astype(np.int64)
        bits = (src_words[allo >> 5].astype(np.int64) >> (allo & 31)) & 1
        csum = np.concatenate(([0], np.cumsum(bits)))
        ends = np.cumsum(lens)
        st.sparse_cnt = csum[ends] - csum[ends - lens]

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
        if len(st.dense_pos):
            cnts[st.dense_pos] = np.asarray(st.counts[: len(st.dense_pos)], dtype=np.int64)
        if st.sparse_pos is not None and len(st.sparse_pos):
            cnts[st.sparse_pos] = st.sparse_cnt
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
        host: bool = False,
    ):
        """The folded TopN's union scoring pass without the scorer
        launch (JAX ``core/fragment.py:2268``): as
        ``top_prepare_parts(replace(opt, row_ids=union), host)``, reusing the
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
        return self._top_score_parts(all_ids[order], all_cnts[order], opt, True, host)

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
        if n <= 0 and self._has_row_locked(row_id):
            n = self._count_of.get(row_id, 0)
        return n

    def __repr__(self) -> str:
        return (
            f"Fragment({self.index}/{self.frame}/{self.view}/{self.slice}, "
            f"rows={len(self._slot_of)}+{len(self._sparse)}, device={self.device})"
        )


def _lock_order(frag: Fragment) -> tuple:
    return (frag.index, frag.frame, frag.view, frag.slice, frag.path)


def apply_pending_many(frags) -> int:
    """Bring the mirrors of ``frags`` (None entries and repeats allowed)
    up to date with ONE delta-scatter launch per device, however many
    of them have queues (``scatter.apply_many``); returns the fragments
    applied.  A fragment without a mirror has no queue: its first read
    uploads it.

    Every fragment of the batch stays locked from the taking of its
    queue until the launch is enqueued, so no reader can find a queue
    empty while its deltas are not yet on the stream.  The locks are
    taken in one global order, (index, frame, view, slice, path), so two
    flushes cannot deadlock; a writer that queues meanwhile waits for
    the lock and lands in the next batch.  The queue counts are first
    read without the locks: a write acknowledged before this read began
    has its count set already, and one that races it is applied by the
    fragment's own next read."""
    todo = sorted({id(f): f for f in frags if f is not None and f._pending_n}.values(),
                  key=_lock_order)
    if not todo:
        return 0
    with contextlib.ExitStack() as locks:
        for f in todo:
            locks.enter_context(f._mu)
        live = [f for f in todo if f._mirror is not None and f._pending_n]
        if live:
            # Pinned from the taking of the queues until the launch is
            # enqueued (the held locks already make the pool skip them).
            pool = device_mod.pool()
            held = pool.pin_many([f._pool_key for f in live])
            try:
                scatter.apply_many([(f._mirror, f._pending) for f in live])
            finally:
                pool.unpin_many(held)
            for f in live:
                f._pending = []
                f._pending_n = 0
    return len(live)
