"""AttrStore — typed row/column attributes with anti-entropy checksums.

The reference stores attrs in BoltDB (key = big-endian u64 id, value =
protobuf AttrMap) with an in-memory cache and SHA1 block checksums per
100 ids for sync diffing (reference: attr.go:43-254, 411-508).  This
implementation uses stdlib sqlite3 (embedded, transactional, no new
deps) with JSON-encoded values; the block/diff protocol semantics are
the same.

Value types: str | int | bool | float (reference: attr.go:34-40);
``None`` deletes a key (reference: attr.go:285-289).
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading
from typing import Any

# reference: attr.go:31-32
ATTR_BLOCK_SIZE = 100


def _to_db_id(id_: int) -> int:
    """Map a uint64 id into SQLite's signed 64-bit INTEGER (two's
    complement); the reference's boltdb keys are raw big-endian u64 so
    ids up to 2^64-1 are legal at the API."""
    id_ &= (1 << 64) - 1
    return id_ - (1 << 64) if id_ >= (1 << 63) else id_


def _from_db_id(id_: int) -> int:
    return id_ + (1 << 64) if id_ < 0 else id_


def validate_attrs(attrs: dict[str, Any]) -> None:
    for k, v in attrs.items():
        if v is None:
            continue
        if not isinstance(v, (str, int, bool, float)):
            raise TypeError(f"invalid attr type for {k!r}: {type(v).__name__}")


class AttrStore:
    """sqlite-backed attribute store with in-memory cache."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        self._cache: dict[int, dict[str, Any]] = {}
        self._db: sqlite3.Connection | None = None
        # Per-block checksums, maintained INCREMENTALLY at write time:
        # a block's digest is the XOR of sha1(id || json) over its
        # non-empty rows (order-independent, so a write updates it in
        # O(1) by xoring out the row's old term and xoring in the new
        # one) plus a non-empty-row count to detect emptied blocks.
        # blocks() then costs O(#blocks) dict reads instead of
        # SELECT+JSON-parsing the whole table per sync tick per peer.
        self._block_sums: dict[int, bytes] = {}
        self._block_counts: dict[int, int] = {}
        self._scanned = False  # digests cover the whole table

    # --- lifecycle ---

    def open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS attrs (id INTEGER PRIMARY KEY, data TEXT)"
        )
        self._db.commit()
        self._block_sums = {}
        self._block_counts = {}
        # A fresh (empty) store's digests are trivially complete, and
        # every subsequent write maintains them — the common path never
        # scans.  A store reopened over existing rows digests lazily on
        # the first blocks() call (one streaming pass, once per open).
        row = self._db.execute("SELECT 1 FROM attrs LIMIT 1").fetchone()
        self._scanned = row is None

    def close(self) -> None:
        if self._db is not None:
            self._db.close()
            self._db = None
        self._cache.clear()
        self._block_sums = {}
        self._block_counts = {}
        self._scanned = False

    def _conn(self) -> sqlite3.Connection:
        if self._db is None:
            raise RuntimeError("attr store is not open")
        return self._db

    # --- reads ---

    def attrs(self, id_: int) -> dict[str, Any]:
        with self._lock:
            if id_ in self._cache:
                return dict(self._cache[id_])
            row = self._conn().execute(
                "SELECT data FROM attrs WHERE id = ?", (_to_db_id(id_),)
            ).fetchone()
            m = json.loads(row[0]) if row else {}
            self._cache[id_] = m
            return dict(m)

    # --- writes ---

    def set_attrs(self, id_: int, attrs: dict[str, Any]) -> None:
        """Merge attrs into the stored map; None values delete keys
        (reference: attr.go:120-155, 268-303)."""
        validate_attrs(attrs)
        with self._lock:
            old = self.attrs(id_)
            cur = dict(old)
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
            self._conn().execute(
                "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
                (_to_db_id(id_), json.dumps(cur, sort_keys=True)),
            )
            self._conn().commit()
            self._cache[id_] = cur
            self._digest_update_locked(id_, old, cur)

    # SQLite's bound-parameter ceiling is 999 before 3.32; stay under it.
    _SELECT_BATCH = 500

    def set_bulk_attrs(self, attr_sets: dict[int, dict[str, Any]]) -> None:
        """Sorted batch write in ONE transaction (reference:
        SetBulkAttrs, attr.go:158-191 runs a single bolt Update): the
        current values of all touched ids load via batched ``IN``
        selects instead of a per-id Python-loop SELECT, the merged rows
        land through one executemany, and a failure anywhere rolls the
        whole batch back."""
        if not attr_sets:
            return
        with self._lock:
            ids = sorted(attr_sets)
            for id_ in ids:
                validate_attrs(attr_sets[id_])
            conn = self._conn()
            missing = [i for i in ids if i not in self._cache]
            for lo in range(0, len(missing), self._SELECT_BATCH):
                chunk = missing[lo : lo + self._SELECT_BATCH]
                marks = ",".join("?" * len(chunk))
                rows = conn.execute(
                    f"SELECT id, data FROM attrs WHERE id IN ({marks})",
                    [_to_db_id(i) for i in chunk],
                ).fetchall()
                for db_id, data in rows:
                    self._cache[_from_db_id(db_id)] = json.loads(data)
            params: list[tuple[int, str]] = []
            merged: dict[int, dict[str, Any]] = {}
            olds: dict[int, dict[str, Any]] = {}
            for id_ in ids:
                old = self._cache.get(id_, {})
                cur = dict(old)
                for k, v in attr_sets[id_].items():
                    if v is None:
                        cur.pop(k, None)
                    else:
                        cur[k] = v
                params.append((_to_db_id(id_), json.dumps(cur, sort_keys=True)))
                merged[id_] = cur
                olds[id_] = old
            try:
                conn.executemany(
                    "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
                    params,
                )
                conn.commit()
            except sqlite3.Error:
                conn.rollback()
                raise
            # Cache updates only after the transaction commits — a
            # rolled-back batch must not leave phantom attrs in memory.
            self._cache.update(merged)
            for id_ in ids:
                self._digest_update_locked(id_, olds[id_], merged[id_])

    # --- anti-entropy (reference: attr.go:193-254, 411-441) ---

    @staticmethod
    def _row_term(id_: int, data: str) -> int:
        """One non-empty row's digest term: sha1 over the unsigned id
        and the row's canonical json text (writes always store
        sort_keys=True, so text identity == value identity)."""
        h = hashlib.sha1()
        h.update(id_.to_bytes(8, "big"))
        h.update(data.encode())
        return int.from_bytes(h.digest(), "big")

    def _digest_update_locked(
        self, id_: int, old: dict[str, Any], new: dict[str, Any]
    ) -> None:
        """O(1) block-digest maintenance for one row write: xor out the
        old term, xor in the new one.  Skipped while the store hasn't
        digested its pre-existing rows yet (the lazy first scan reads
        this write's committed value from the table anyway)."""
        if not self._scanned or old == new:
            return
        b = id_ // ATTR_BLOCK_SIZE
        acc = int.from_bytes(self._block_sums.get(b, b"\0" * 20), "big")
        n = self._block_counts.get(b, 0)
        if old:
            acc ^= self._row_term(id_, json.dumps(old, sort_keys=True))
            n -= 1
        if new:
            acc ^= self._row_term(id_, json.dumps(new, sort_keys=True))
            n += 1
        if n <= 0:
            self._block_sums.pop(b, None)
            self._block_counts.pop(b, None)
        else:
            self._block_sums[b] = acc.to_bytes(20, "big")
            self._block_counts[b] = n

    def blocks(self) -> list[tuple[int, bytes]]:
        """[(block_id, digest)] over all ids, blocked per 100 ids.

        A block's digest is the XOR of its rows' sha1 terms —
        order-independent, so writes keep it current in O(1)
        (_digest_update_locked) and this call is a dict copy, not the
        full SELECT+JSON-parse of every row the sync loop used to pay
        per tick per peer.  Only a store reopened over existing rows
        pays one streaming digest pass, on its first blocks() call."""
        with self._lock:
            if not self._scanned:
                self._scan_all_blocks_locked()
            return sorted(self._block_sums.items())

    def _scan_all_blocks_locked(self) -> None:
        """One streaming pass over the whole table — only on the first
        blocks() after an open() that found existing rows."""
        sums: dict[int, int] = {}
        counts: dict[int, int] = {}
        cur = self._conn().execute("SELECT id, data FROM attrs")
        for db_id, data in cur:
            if data == "{}" or json.loads(data) == {}:
                continue
            id_ = _from_db_id(db_id)
            b = id_ // ATTR_BLOCK_SIZE
            sums[b] = sums.get(b, 0) ^ self._row_term(id_, data)
            counts[b] = counts.get(b, 0) + 1
        self._block_sums = {b: v.to_bytes(20, "big") for b, v in sums.items()}
        self._block_counts = counts
        self._scanned = True

    def _block_rows_locked(self, block_id: int):
        """One block's rows as ``(unsigned id, raw json text)`` in
        unsigned-id order, streamed by cursor.  "ORDER BY (id < 0), id"
        is unsigned order under the two's-complement id mapping."""
        lo = block_id * ATTR_BLOCK_SIZE
        hi = lo + ATTR_BLOCK_SIZE
        dlo, dhi = _to_db_id(lo), _to_db_id(hi - 1)
        if dlo <= dhi:
            cur = self._conn().execute(
                "SELECT id, data FROM attrs WHERE id >= ? AND id <= ?"
                " ORDER BY (id < 0), id",
                (dlo, dhi),
            )
        else:  # block straddles the uint63 sign boundary
            cur = self._conn().execute(
                "SELECT id, data FROM attrs WHERE id >= ? OR id <= ?"
                " ORDER BY (id < 0), id",
                (dlo, dhi),
            )
        for db_id, data in cur:
            yield _from_db_id(db_id), data

    def block_data(self, block_id: int) -> dict[int, dict[str, Any]]:
        """All attrs in one block (reference: BlockData, attr.go:226-254),
        streamed straight off the range cursor."""
        with self._lock:
            out: dict[int, dict[str, Any]] = {}
            for id_, data in self._block_rows_locked(block_id):
                m = json.loads(data)
                if m:
                    out[id_] = m
            return out


def diff_blocks(
    local: list[tuple[int, bytes]], remote: list[tuple[int, bytes]]
) -> list[int]:
    """Block ids that differ between two checksum lists (reference:
    AttrBlocks.Diff, attr.go:411-441): present on only one side, or
    present on both with different checksums."""
    lmap = dict(local)
    rmap = dict(remote)
    out = []
    for b in sorted(lmap.keys() | rmap.keys()):
        if lmap.get(b) != rmap.get(b):
            out.append(b)
    return out
