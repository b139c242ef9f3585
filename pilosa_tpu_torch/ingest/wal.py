"""Per-fragment write-ahead log with group commit.

The counterpart of ``pilosa_tpu/ingest/wal.py``, in the same format, so
a data directory either package leaves opens in the other with every
acknowledged bit.  Every changed bit is appended to the fragment's WAL
before the write is acknowledged, and the acknowledgement waits only for
the WAL's fsync, never for a snapshot.  Concurrent writers share one
fsync: a writer parks on a :class:`concurrent.futures.Future`, the
manager's committer thread lingers for the ``group_commit_ms`` window
(or until ``group_commit_max`` ops are pending), seals each fragment's
buffered ops into one checksummed frame, fsyncs once, and resolves the
future of every waiter at once.  The executor waits for this thread's
futures after a write, outside every fragment lock
(:meth:`IngestManager.wait_durable`).

Segment layout (``<fragment-path>.wal``)::

    header   "<4sIQQ"  magic=b"PWAL"  version=1  base_op_version  snap_size
    frame*   "<IIQ"    payload_len  n_ops  end_op_version
             payload   n_ops x 13-byte roaring op records
             digest    sha256(frame_header + payload), 32 bytes

``base_op_version`` is the fragment's op version at the last truncating
snapshot; a frame's ``end_op_version`` is the version after its last op.
``snap_size`` is the data file's op-region offset when the segment was
last truncated: a segment whose ``snap_size`` differs from the data
file's was written against another snapshot and is stale.  A torn tail
(a frame cut by a crash mid-append) fails its digest, and decoding stops
at the first bad frame: exactly the ops that were never acknowledged.

On open (:meth:`IngestManager.attach`) a fragment replays the ops of its
segment past its op-log (``ingest/recovery.py``), checkpoints with a
snapshot when it replayed any, and keeps a writer that continues the
segment or starts a fresh one.  A fragment that no manager owns (the
WAL is off) replays a segment it finds and then removes it, since it
logs nothing itself (``Fragment._recover_wal``).

Lock order, as in the JAX package: ``frag._mu`` -> ``WalWriter._io_mu``
-> ``WalWriter._mu``.  :meth:`WalWriter.log`, called under ``frag._mu``,
takes only ``_mu`` and never touches the file; the committer takes
``_io_mu`` for the write and fsync and ``_mu`` only to swap the buffer,
so an fsync never stalls a writer's append.  The committer never blocks
on a fragment lock: a segment's rollover snapshot takes the fragment's
lock only when it is free, else waits for that segment's next commit.
The JAX committer's background delta-scatter is not ported: the port
applies queued writes at the next read, with one launch for every
fragment the read needs (``fragment.apply_pending_many``).
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import time
from concurrent.futures import Future

from pilosa_tpu_torch.ops import roaring

MAGIC = b"PWAL"
FORMAT_VERSION = 1

_HEADER = struct.Struct("<4sIQQ")  # magic, version, base_op_version, snap_size
_FRAME = struct.Struct("<IIQ")  # payload_len, n_ops, end_op_version
HEADER_SIZE = _HEADER.size
FRAME_HEADER_SIZE = _FRAME.size
DIGEST_SIZE = 32

# A corrupt length field must not allocate without bound.
MAX_FRAME_OPS = 1 << 20
MAX_FRAME_PAYLOAD = MAX_FRAME_OPS * roaring.OP_SIZE


class WalClosed(RuntimeError):
    """The WAL (or its manager) was closed while a write waited on it."""


def wal_path(fragment_path: str) -> str:
    return fragment_path + ".wal"


def encode_header(base_op_version: int, snap_size: int) -> bytes:
    return _HEADER.pack(MAGIC, FORMAT_VERSION, base_op_version, snap_size)


def encode_frame(payload: bytes, n_ops: int, end_op_version: int) -> bytes:
    hdr = _FRAME.pack(len(payload), n_ops, end_op_version)
    return hdr + payload + hashlib.sha256(hdr + payload).digest()


class Segment:
    """A decoded WAL segment: the verified prefix of one ``.wal`` file."""

    __slots__ = ("base_op_version", "snap_size", "frames", "torn", "good_bytes", "problem")

    def __init__(self, base_op_version: int = 0, snap_size: int = 0):
        self.base_op_version = base_op_version
        self.snap_size = snap_size
        # [(end_op_version, n_ops, payload bytes)] in append order.
        self.frames: list[tuple[int, int, bytes]] = []
        self.torn = False
        self.good_bytes = HEADER_SIZE
        self.problem: str | None = None

    @property
    def n_ops(self) -> int:
        return sum(n for _, n, _ in self.frames)

    @property
    def end_op_version(self) -> int:
        return self.frames[-1][0] if self.frames else self.base_op_version


def load_segment(path: str) -> Segment | None:
    """Decode the WAL at ``path``; None when it is absent or its header
    does not verify (then nothing in it can be trusted).  A torn tail
    ends the decode at the first frame whose length, digest or op
    records fail (``torn`` set, ``problem`` says why)."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return None
    if len(data) < HEADER_SIZE:
        return None
    magic, version, base, snap_size = _HEADER.unpack_from(data, 0)
    if magic != MAGIC or version != FORMAT_VERSION:
        return None
    seg = Segment(base, snap_size)
    pos = HEADER_SIZE
    expect_version = base
    while pos < len(data):
        if pos + FRAME_HEADER_SIZE > len(data):
            seg.torn, seg.problem = True, "torn frame header"
            break
        payload_len, n_ops, end_version = _FRAME.unpack_from(data, pos)
        if (payload_len > MAX_FRAME_PAYLOAD
                or payload_len != n_ops * roaring.OP_SIZE
                or n_ops == 0
                or end_version != expect_version + n_ops):
            seg.torn, seg.problem = True, "bad frame header"
            break
        frame_end = pos + FRAME_HEADER_SIZE + payload_len + DIGEST_SIZE
        if frame_end > len(data):
            seg.torn, seg.problem = True, "torn frame"
            break
        payload = data[pos + FRAME_HEADER_SIZE : frame_end - DIGEST_SIZE]
        want = hashlib.sha256(data[pos : pos + FRAME_HEADER_SIZE] + payload).digest()
        if data[frame_end - DIGEST_SIZE : frame_end] != want:
            seg.torn, seg.problem = True, "frame checksum mismatch"
            break
        # Each op record carries its own FNV checksum too.
        problem = next((p for off in range(0, payload_len, roaring.OP_SIZE)
                        if (p := roaring._read_op(payload, off)[2]) is not None), None)
        if problem is not None:
            seg.torn, seg.problem = True, f"op record: {problem}"
            break
        seg.frames.append((end_version, n_ops, payload))
        expect_version = end_version
        pos = frame_end
        seg.good_bytes = pos
    return seg


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``, so that a rename or unlink
    in it survives a crash."""
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _data_state(frag) -> tuple[int, bytes]:
    """The data file's op-region offset (which snapshot a segment was
    truncated against) and its op-log bytes, cut to the records the
    fragment recovered (``frag._op_n``: a repaired torn tail is left
    out of the prefix comparison)."""
    try:
        with open(frag.path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return 0, b""
    if not data:
        return 0, b""
    try:
        off = roaring.ops_region_offset(data)
    except roaring.CorruptError:
        return 0, b""
    return off, bytes(data[off : off + frag._op_n * roaring.OP_SIZE])


def _truncate_file(path: str, size: int) -> None:
    with open(path, "r+b") as fh:
        fh.truncate(size)
        fh.flush()
        os.fsync(fh.fileno())


class WalWriter:
    """One fragment's WAL segment: appends that never wait on I/O, and
    the group commit that makes them durable.

    ``log()`` runs under ``frag._mu`` on the write path and only
    buffers; the manager's committer thread calls ``commit()``, which
    writes one frame and fsyncs it.  ``truncate_segment()`` is called by
    the fragment's snapshot (under ``frag._mu``, after the snapshot and
    its directory entry are fsynced) and restarts the segment empty at a
    new base version."""

    def __init__(self, frag, path: str, base_op_version: int, snap_size: int,
                 manager: "IngestManager", *, fresh: bool):
        self.frag = frag
        self.path = path
        self._manager = manager
        # Lock order: frag._mu -> _io_mu -> _mu.  _mu guards the buffered
        # (not yet durable) state; _io_mu serializes writes, fsyncs and
        # truncations, so a commit never holds _mu across I/O.
        self._io_mu = threading.Lock()
        self._mu = threading.Lock()
        self._buf = bytearray()
        self._buf_ops = 0
        self._op_version = base_op_version
        self._base = base_op_version
        self._snap_size = snap_size
        self._pending: Future | None = None
        self._closed = False
        self._wal_bytes = HEADER_SIZE
        self._last_fsync_ms = 0.0
        self._last_group = 0
        self._appends = 0
        self._fsyncs = 0
        # Frame bytes fsynced over the writer's life (survives truncation).
        self._bytes_written = 0
        if fresh:
            self._rewrite_locked_io(base_op_version, snap_size)
        else:
            self._file = open(path, "ab")
            self._wal_bytes = self._file.tell()

    # -- write path (under frag._mu) ----------------------------------

    def log(self, typ: int, pos: int) -> Future:
        """Buffer one op record; returns the Future that resolves when it
        is durable.  Never touches the file."""
        with self._mu:
            if self._closed:
                raise WalClosed(f"wal closed: {self.path}")
            self._buf += roaring.encode_op(typ, pos)
            self._buf_ops += 1
            self._op_version += 1
            self._appends += 1
            if self._pending is None:
                self._pending = Future()
            fut = self._pending
        _note_pending(self, fut)
        self._manager._poke(self)
        return fut

    # -- committer side -----------------------------------------------

    def commit(self) -> int:
        """Seal the buffered ops into one frame and fsync it; returns the
        ops made durable (0 for an empty buffer)."""
        with self._io_mu:
            with self._mu:
                if self._closed or not self._buf_ops:
                    return 0
                payload = bytes(self._buf)
                n_ops = self._buf_ops
                end_version = self._op_version
                fut = self._pending
                self._buf = bytearray()
                self._buf_ops = 0
                self._pending = None
            frame = encode_frame(payload, n_ops, end_version)
            t0 = time.perf_counter()
            try:
                self._file.write(frame)
                self._file.flush()
                os.fsync(self._file.fileno())
            except OSError as e:
                if fut is not None and not fut.done():
                    fut.set_exception(e)
                raise
            self._wal_bytes += len(frame)
            self._last_fsync_ms = (time.perf_counter() - t0) * 1e3
            self._last_group = n_ops
            self._fsyncs += 1
            self._bytes_written += len(frame)
        if fut is not None and not fut.done():
            fut.set_result(None)
        return n_ops

    def truncate_segment(self, snap_size: int) -> None:
        """Restart the segment after a snapshot.  The caller holds
        ``frag._mu`` and has fsynced the snapshot and its directory
        entry: every op the WAL covers, durable or still buffered, is in
        the snapshot, so buffered waiters resolve as durable and the log
        restarts empty at the new base version."""
        with self._io_mu:
            with self._mu:
                if self._closed:
                    return
                base = self._op_version
                fut = self._pending
                self._buf = bytearray()
                self._buf_ops = 0
                self._pending = None
                self._base = base
                self._snap_size = snap_size
            self._file.close()
            self._rewrite_locked_io(base, snap_size)
        if fut is not None and not fut.done():
            fut.set_result(None)

    def _rewrite_locked_io(self, base: int, snap_size: int) -> None:
        """(Re)create the segment with just a header.  The caller holds
        ``_io_mu`` (or is the constructor)."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(encode_header(base, snap_size))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(self.path)
        self._file = open(self.path, "ab")
        self._wal_bytes = HEADER_SIZE

    def close(self, *, final_commit: bool = True) -> None:
        """Detach: optionally commit the tail, then close the file.
        Waiters that cannot be committed fail with WalClosed."""
        if final_commit:
            try:
                self.commit()
            except OSError:
                pass
        with self._io_mu:
            with self._mu:
                if self._closed:
                    return
                self._closed = True
                fut = self._pending
                self._pending = None
                self._buf = bytearray()
                self._buf_ops = 0
            try:
                self._file.close()
            except OSError:
                pass
        if fut is not None and not fut.done():
            fut.set_exception(WalClosed(f"wal closed: {self.path}"))

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "path": self.path,
                "walBytes": int(self._wal_bytes),
                "bufferedOps": int(self._buf_ops),
                "opVersion": int(self._op_version),
                "baseOpVersion": int(self._base),
                "lastFsyncMs": round(self._last_fsync_ms, 3),
                "lastGroupSize": int(self._last_group),
                "appends": int(self._appends),
                "fsyncs": int(self._fsyncs),
                "walBytesWritten": int(self._bytes_written),
            }


# -- per-thread durable-wait bookkeeping ------------------------------

_local = threading.local()


def _note_pending(writer: WalWriter, fut: Future) -> None:
    """Record this thread's latest unawaited future per writer.  A
    writer's futures resolve in seal order, so waiting on the latest
    covers every earlier append by the same thread."""
    pending = getattr(_local, "pending", None)
    if pending is None:
        pending = _local.pending = {}
    pending[id(writer)] = fut


class IngestManager:
    """The WAL of one data directory: one committer thread batching
    every attached fragment's appends into per-fragment group commits.
    Registered in a module list, so that :func:`attach_fragment` (called
    from ``Fragment.open``) finds the manager owning a fragment by path
    prefix: several servers in one process stay apart."""

    def __init__(self, data_dir: str, *, group_commit_ms: float = 2.0,
                 group_commit_max: int = 128, wal_segment_bytes: int = 4 << 20, logger=None):
        self.data_dir = os.path.realpath(data_dir)
        self.group_commit_ms = float(group_commit_ms)
        self.group_commit_max = int(group_commit_max)
        self.wal_segment_bytes = int(wal_segment_bytes)
        self.logger = logger or (lambda m: None)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._writers: dict[int, WalWriter] = {}
        self._dirty: dict[int, WalWriter] = {}
        # Writers whose segment passed wal_segment_bytes while their
        # fragment's lock was busy: their rollover waits for a free lock.
        self._rollover: dict[int, WalWriter] = {}
        self._dirty_since: float | None = None
        self._dirty_ops = 0
        self._closed = False
        self._last_replay: dict | None = None
        self._replays = 0
        self._replayed_ops = 0
        # Appends and fsyncs of writers already detached, so that the
        # totals of snapshot() survive a fragment's close.
        self._gone_appends = 0
        self._gone_fsyncs = 0
        self._thread = threading.Thread(target=self._run, name="ingest-committer", daemon=True)
        self._thread.start()

    # -- registry -----------------------------------------------------

    def owns(self, path: str) -> bool:
        return os.path.realpath(path).startswith(self.data_dir + os.sep)

    def attach(self, frag) -> None:
        """Replay the fragment's durable WAL tail newer than its data
        file, then install a fresh or continuing writer as
        ``frag._wal``.  Called from ``Fragment.open`` under ``frag._mu``
        (JAX ``IngestManager.attach``)."""
        from pilosa_tpu_torch.ingest import recovery

        path = wal_path(frag.path)
        seg = load_segment(path)
        snap_size, data_ops = _data_state(frag)
        fresh = True
        base = 0
        if seg is not None:
            if seg.snap_size != snap_size:
                # Written against another snapshot: replaying it would
                # double- or mis-apply.  Discard and restart.
                self.logger(f"[ingest] discarding stale wal segment {path} "
                            f"(snap_size {seg.snap_size} != {snap_size})")
            elif not b"".join(p for _, _, p in seg.frames).startswith(data_ops):
                # The fragment took writes while the WAL was off: the two
                # histories cannot be ordered, and the segment is forfeited.
                self.logger(f"[ingest] discarding diverged wal segment {path} (data op-log "
                            f"is not a prefix of the logged ops; {len(seg.frames)} frames "
                            "forfeited)")
            else:
                report = recovery.replay(frag, seg)
                self._note_replay(frag, report)
                base = seg.end_op_version
                if report["replayed"] or report["unchanged"]:
                    # Restart checkpoint: fold the replayed tail into a
                    # snapshot, so that op-log and WAL restart aligned.
                    frag.snapshot()
                    snap_size, _ = _data_state(frag)
                else:
                    fresh = False
                    if seg.torn:
                        # New frames go after the last good one.
                        _truncate_file(path, seg.good_bytes)
        if fresh and frag._op_n:
            # A fresh segment starts with no preceding ops: fold an
            # existing op-log into the snapshot first.
            frag.snapshot()
            snap_size, _ = _data_state(frag)
        writer = WalWriter(frag, path, base, snap_size, self, fresh=fresh)
        with self._mu:
            if self._closed:
                writer.close(final_commit=False)
                raise WalClosed("ingest manager closed")
            self._writers[id(writer)] = writer
        frag._wal = writer

    def detach(self, writer: WalWriter) -> None:
        """Called from ``Fragment.close`` (under frag._mu)."""
        with self._mu:
            self._writers.pop(id(writer), None)
            self._dirty.pop(id(writer), None)
            self._rollover.pop(id(writer), None)
        writer.close(final_commit=True)
        with self._mu:
            self._gone_appends += writer._appends
            self._gone_fsyncs += writer._fsyncs

    def _note_replay(self, frag, report: dict) -> None:
        with self._mu:
            self._replays += 1
            self._replayed_ops += int(report.get("replayed", 0))
            self._last_replay = report
        self.logger(f"[ingest] replayed {report['replayed']} wal ops for "
                    f"{frag.index}/{frag.frame}/{frag.view}/{frag.slice}"
                    + (" (torn tail)" if report.get("torn") else ""))

    # -- group commit -------------------------------------------------

    def _poke(self, writer: WalWriter) -> None:
        with self._mu:
            if self._closed:
                return
            self._dirty[id(writer)] = writer
            self._dirty_ops += 1
            if self._dirty_since is None:
                self._dirty_since = time.monotonic()
            self._cv.notify()

    def _run(self) -> None:
        window = self.group_commit_ms / 1e3
        while True:
            with self._mu:
                while not self._dirty and not self._closed:
                    self._cv.wait()
                if self._closed and not self._dirty:
                    return
                # Linger: let concurrent writers join this frame until the
                # window passes or the batch is full.
                while not self._closed:
                    elapsed = time.monotonic() - (self._dirty_since or 0.0)
                    if elapsed >= window or self._dirty_ops >= self.group_commit_max:
                        break
                    self._cv.wait(timeout=window - elapsed)
                batch = list(self._dirty.values())
                self._dirty.clear()
                self._dirty_since = None
                self._dirty_ops = 0
            for w in batch:
                try:
                    w.commit()
                except OSError as e:
                    self.logger(f"[ingest] wal commit error: {e}")
                    continue
                if w._wal_bytes > self.wal_segment_bytes:
                    with self._mu:
                        self._rollover[id(w)] = w
            with self._mu:
                rollover = list(self._rollover.values())
            for w in rollover:
                self._try_rollover(w)

    def _try_rollover(self, w: WalWriter) -> None:
        """Snapshot a fragment whose segment passed the size limit; the
        snapshot truncates the segment.  Only while the fragment's lock
        is free: the committer never waits on a fragment."""
        mu = w.frag._mu
        if not mu.acquire(blocking=False):
            return
        try:
            with self._mu:
                if self._rollover.pop(id(w), None) is None:
                    return
            if w.frag._wal is w:
                w.frag.snapshot()
        except Exception as e:  # noqa: BLE001 — the committer must keep running
            self.logger(f"[ingest] rollover snapshot error: {e}")
        finally:
            mu.release()

    def wait_durable(self, timeout: float = 30.0) -> None:
        """Block until every append THIS thread made is durable.  A no-op
        when the thread wrote nothing."""
        pending = getattr(_local, "pending", None)
        if not pending:
            return
        futs = list(pending.values())
        pending.clear()
        for fut in futs:
            fut.result(timeout=timeout)

    # -- lifecycle / debug --------------------------------------------

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        with self._mu:
            writers = list(self._writers.values())
            self._writers.clear()
            self._dirty.clear()
            self._rollover.clear()
        for w in writers:
            w.close(final_commit=True)

    def snapshot(self) -> dict:
        """``GET /debug/ingest``'s ``wal`` object, with the JAX package's
        keys."""
        with self._mu:
            writers = list(self._writers.values())
            doc = {
                "walEnabled": True,
                "groupCommitMs": self.group_commit_ms,
                "groupCommitMax": self.group_commit_max,
                "walSegmentBytes": self.wal_segment_bytes,
                "fragments": len(writers),
                "replays": self._replays,
                "replayedOps": self._replayed_ops,
                "lastReplay": self._last_replay,
            }
            gone_appends = self._gone_appends
            gone_fsyncs = self._gone_fsyncs
        doc["writers"] = [w.snapshot() for w in writers]
        doc["totalAppends"] = gone_appends + sum(w["appends"] for w in doc["writers"])
        doc["totalFsyncs"] = gone_fsyncs + sum(w["fsyncs"] for w in doc["writers"])
        return doc


# -- module registry --------------------------------------------------

_reg_mu = threading.Lock()
_managers: list[IngestManager] = []


def register_manager(m: IngestManager) -> None:
    with _reg_mu:
        _managers.append(m)


def unregister_manager(m: IngestManager) -> None:
    with _reg_mu:
        try:
            _managers.remove(m)
        except ValueError:
            pass


def attach_fragment(frag) -> bool:
    """Called from ``Fragment.open``: attach the fragment to the manager
    that owns its path; False when none does (the WAL is off, or the
    fragment lives outside any server's data directory)."""
    with _reg_mu:
        managers = list(_managers)
    for m in managers:
        if m.owns(frag.path):
            m.attach(frag)
            return True
    return False
