"""The JAX package's per-fragment write-ahead log: its format and reader.

A JAX node (``pilosa_tpu/ingest/wal.py``) appends every changed bit to
``<fragment-path>.wal`` and acknowledges the write once that log is
fsynced; its data file's op-log may lag by up to a 64 KiB flush buffer.
A data directory copied while such a node runs — what a kill -9 leaves —
therefore holds acknowledged bits only in the WAL.  The port reads and
replays that log when it opens a fragment (``core/fragment.py``,
``ingest/recovery.py``); it writes no WAL of its own yet.

Segment layout (``<fragment-path>.wal``)::

    header   "<4sIQQ"  magic=b"PWAL"  version=1  base_op_version  snap_size
    frame*   "<IIQ"    payload_len  n_ops  end_op_version
             payload   n_ops x 13-byte roaring op records
             digest    sha256(frame_header + payload), 32 bytes

``snap_size`` is the data file's op-region offset when the segment was
last truncated: a segment whose ``snap_size`` differs from the data
file's was written against another snapshot and is stale.  A torn tail
(a frame cut by a crash mid-append) fails its digest, and decoding stops
at the first bad frame: exactly the ops that were never acknowledged.
"""

from __future__ import annotations

import hashlib
import os
import struct

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


def wal_path(fragment_path: str) -> str:
    return fragment_path + ".wal"


def encode_header(base_op_version: int, snap_size: int) -> bytes:
    return _HEADER.pack(MAGIC, FORMAT_VERSION, base_op_version, snap_size)


def encode_frame(payload: bytes, n_ops: int, end_op_version: int) -> bytes:
    hdr = _FRAME.pack(len(payload), n_ops, end_op_version)
    return hdr + payload + hashlib.sha256(hdr + payload).digest()


class Segment:
    """A decoded WAL segment: the verified prefix of one ``.wal`` file."""

    __slots__ = ("base_op_version", "snap_size", "frames", "torn", "problem")

    def __init__(self, base_op_version: int = 0, snap_size: int = 0):
        self.base_op_version = base_op_version
        self.snap_size = snap_size
        # [(end_op_version, n_ops, payload bytes)] in append order.
        self.frames: list[tuple[int, int, bytes]] = []
        self.torn = False
        self.problem: str | None = None

    @property
    def n_ops(self) -> int:
        return sum(n for _, n, _ in self.frames)


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
