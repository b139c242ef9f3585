"""Roaring file-format codec, bit-compatible with the reference.

The on-disk format (reference: roaring/roaring.go:507-660) is the
framework's checkpoint format — keeping it byte-compatible means the
reference's ``pilosa check`` / ``pilosa inspect`` tools and backup tars
work unchanged against our data files, and golden files cut from either
implementation validate the other.

Layout (all little-endian):

    u32 cookie = 12346
    u32 containerCount                  # non-empty containers only
    containerCount * { u64 key, u32 n-1 }
    containerCount * { u32 offset }     # absolute byte offset of payload
    payloads:
        n <= 4096  -> n * u32 sorted low-bits ("array" container)
        n >  4096  -> 1024 * u64 bitmap words ("bitmap" container)
    op-log, repeated until EOF:
        u8 type (0=add, 1=remove), u64 value, u32 FNV-1a(first 9 bytes)

A container covers 2^16 bit-positions; its key is ``value >> 16``
(reference: roaring/roaring.go:1786-1787).  Decoding is TIERED like the
reference's in-memory forms (roaring/roaring.go:893-906): bitmap
containers materialize as uint64[1024] word arrays, array containers
stay as sorted uint32 value arrays (pay-per-bit), and encoding chooses
the payload form by the same ArrayMaxSize = 4096 rule regardless of the
in-memory tier (reference: roaring/roaring.go:893).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

COOKIE = 12346
HEADER_SIZE = 8
ARRAY_MAX_SIZE = 4096
CONTAINER_BITS = 1 << 16
CONTAINER_WORDS64 = CONTAINER_BITS // 64  # 1024 u64 words ("bitmapN")
OP_SIZE = 13

OP_ADD = 0
OP_REMOVE = 1

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193


def fnv1a32(data: bytes) -> int:
    """32-bit FNV-1a (stdlib has no FNV; matches Go's hash/fnv.New32a)."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h


class CorruptError(ValueError):
    pass


@dataclass
class ContainerInfo:
    """Stats for one container (reference: roaring.ContainerInfo,
    roaring/roaring.go:669-683) — powers the ``inspect`` CLI."""

    key: int
    type: str  # "array" | "bitmap"
    n: int
    alloc: int


@dataclass
class BitmapInfo:
    ops: int
    containers: list[ContainerInfo] = field(default_factory=list)


def decode(data: bytes) -> dict[int, np.ndarray]:
    """Decode a roaring file into {container_key: uint64[1024] words},
    applying the trailing op-log (reference: roaring/roaring.go:567-646).

    Dispatches to the port's C++ codec (``pilosa_tpu_torch/native``) when
    it is available; the Python path is the fallback and parity oracle."""
    return decode_with_ops(data)[0]


def decode_with_ops(data: bytes) -> tuple[dict[int, np.ndarray], int]:
    """decode() plus the replayed op count — one parse serves both the
    containers and Fragment.open's op-counter bookkeeping."""
    from pilosa_tpu_torch import native

    try:
        res = native.decode(data)
    except native.NativeCorruptError as e:
        raise CorruptError(str(e)) from e
    if res is not None:
        return res
    return decode_with_ops_py(data)


def decode_with_ops_py(data: bytes) -> tuple[dict[int, np.ndarray], int]:
    """The Python path of :func:`decode_with_ops`."""
    containers, ops_offset, _ = _decode_containers(data)
    op_n = _apply_ops(containers, data, ops_offset)
    return containers, op_n


def decode_tiered(
    data,
) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray], int]:
    """Decode keeping each container in its cheapest form:
    ``(words, arrays, op_n)`` where ``words[key]`` is uint64[1024] (bitmap
    containers) and ``arrays[key]`` is a SORTED uint32 value array (array
    containers, pay-per-bit — never materialized to 8 KiB).  This is the
    loading path for tall-sparse fragments (e.g. inverse views with one
    array container per row), where materializing every container would
    cost rows x 8 KiB (reference keeps the same two forms in memory,
    roaring/roaring.go:893-906).

    ``data`` may be bytes or any readable buffer (mmap, memoryview):
    both decoders read it in place and every returned array is a fresh
    copy, so the buffer can be closed immediately after (reference
    analog: zero-copy container attach straight out of the mmap,
    roaring/roaring.go:567-620 — here tiers are materialized instead,
    but the FILE bytes are never duplicated in memory).

    Dispatches to the C++ tiered decoder when available; the Python path
    (:func:`decode_tiered_py`) is the fallback and parity oracle."""
    from pilosa_tpu_torch import native

    try:
        res = native.decode_tiered(data)
    except native.NativeCorruptError as e:
        raise CorruptError(str(e)) from e
    if res is not None:
        return res
    return decode_tiered_py(data)


def decode_tiered_py(
    data,
) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray], int]:
    """The Python path of :func:`decode_tiered`."""
    words, arrays, ops_offset, _ = _decode_containers_tiered(data)
    op_n = _apply_ops_tiered(words, arrays, data, ops_offset)
    return words, arrays, op_n


def _parse_header_tables(data):
    """Vectorized header parse shared by the tiered decoder and
    :func:`ops_region_offset` — the ONE place the header layout and the
    container payload-size rule (n <= 4096 -> 4n-byte array, else
    8 KiB bitmap) live.  Returns ``(keys u64[], ns i64[], offs i64[],
    plens i64[], ops_base)``; a tall-sparse file has one container per
    row (hundreds of thousands of entries), so the key and offset
    tables read as one structured view each."""
    if len(data) < HEADER_SIZE:
        raise CorruptError("data too small")
    cookie, key_n = struct.unpack_from("<II", data, 0)
    if cookie != COOKIE:
        raise CorruptError("invalid roaring file")
    if HEADER_SIZE + key_n * 16 > len(data):
        raise CorruptError(
            f"header claims {key_n} containers but file is {len(data)} bytes"
        )
    ktab = np.frombuffer(
        data,
        dtype=np.dtype([("key", "<u8"), ("n1", "<u4")]),
        count=key_n,
        offset=HEADER_SIZE,
    )
    keys = ktab["key"]
    ns = ktab["n1"].astype(np.int64) + 1
    # The format writes containers in strictly ascending key order
    # (encoder sorts; reference roaring.go:507-531 iterates sorted) and
    # every consumer here — the streaming fragment loader's grouping,
    # the sparse tier's binary searches — depends on it, so fail fast
    # instead of silently mis-answering on an out-of-order file.
    if key_n > 1 and (np.diff(keys.astype(np.int64)) <= 0).any():
        raise CorruptError("container keys are not sorted/unique")
    offs = np.frombuffer(
        data, dtype="<u4", count=key_n, offset=HEADER_SIZE + key_n * 12
    ).astype(np.int64)
    plens = np.where(ns <= ARRAY_MAX_SIZE, ns * 4, CONTAINER_WORDS64 * 8)
    return keys, ns, offs, plens, HEADER_SIZE + key_n * 16


# Public alias: the fragment's streaming loader parses the header
# tables itself to fill its storage tiers straight from the mmap.
parse_header_tables = _parse_header_tables


def _decode_containers_tiered(data: bytes):
    """Parse into (words, arrays, ops_offset, infos): bitmap containers
    as uint64[1024] words, array containers as sorted uint32 values."""
    keys, ns, offs, plens, ops_base = _parse_header_tables(data)
    words_out: dict[int, np.ndarray] = {}
    arrays_out: dict[int, np.ndarray] = {}
    ops_offset = ops_base
    infos: list[ContainerInfo] = []
    for i in range(len(keys)):
        offset = int(offs[i])
        if offset >= len(data):
            raise CorruptError(f"offset out of bounds: off={offset}, len={len(data)}")
        n = int(ns[i])
        key = int(keys[i])
        payload_len = int(plens[i])
        if offset + payload_len > len(data):
            raise CorruptError(
                f"container payload out of bounds: off={offset}, "
                f"need={payload_len}, len={len(data)}"
            )
        if n <= ARRAY_MAX_SIZE:
            values = np.frombuffer(data, dtype="<u4", count=n, offset=offset)
            if values.size and int(values.max()) >= CONTAINER_BITS:
                raise CorruptError(
                    f"array value out of range in container key={key}: "
                    f"{int(values.max())}"
                )
            # The format requires strictly-ascending array values; the
            # sparse tier's binary searches depend on it, so fail fast
            # instead of silently mis-answering on corrupt input.
            if values.size > 1 and (np.diff(values.astype(np.int64)) <= 0).any():
                raise CorruptError(
                    f"array container key={key} is not sorted/unique"
                )
            arrays_out[key] = values.astype(np.uint32)
            end = offset + n * 4
            infos.append(ContainerInfo(key, "array", n, n * 4))
        else:
            words_out[key] = np.frombuffer(
                data, dtype="<u8", count=CONTAINER_WORDS64, offset=offset
            ).copy()
            end = offset + CONTAINER_WORDS64 * 8
            infos.append(ContainerInfo(key, "bitmap", n, CONTAINER_WORDS64 * 8))
        ops_offset = max(ops_offset, end)
    return words_out, arrays_out, ops_offset, infos


def values_to_words(values: np.ndarray) -> np.ndarray:
    """Sorted uint32 container values -> uint64[1024] words."""
    words = np.zeros(CONTAINER_WORDS64, dtype=np.uint64)
    if len(values):
        widx = (values // 64).astype(np.int64)
        masks = np.uint64(1) << (values % 64).astype(np.uint64)
        np.bitwise_or.at(words, widx, masks)
    return words


def words_to_values(words: np.ndarray) -> np.ndarray:
    """uint64[1024] words -> sorted uint32 container values."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    (positions,) = np.nonzero(bits)
    return positions.astype(np.uint32)


def _decode_containers(data: bytes):
    words_out, arrays_out, ops_offset, infos = _decode_containers_tiered(data)
    containers = words_out
    for key, values in arrays_out.items():
        containers[key] = values_to_words(values)
    return containers, ops_offset, infos


def ops_region_offset(data) -> int:
    """Byte offset where the op-log begins (one past the last container
    payload), computed from the header tables alone — no payload is
    materialized, so this is cheap even on multi-hundred-MB files.
    Used by torn-tail recovery, which must locate the op region of a
    file whose op-log no longer parses."""
    keys, ns, offs, plens, base = _parse_header_tables(data)
    if len(keys) == 0:
        return base
    end = int((offs + plens).max())
    if end > len(data):
        raise CorruptError(
            f"container payload out of bounds: end={end}, len={len(data)}"
        )
    return max(base, end)


def _read_op(data, pos: int):
    """THE parser of the 13-byte op wire record (reference:
    roaring/roaring.go:1746-1762): returns ``(typ, value, problem)``
    where ``problem`` is None for a valid record — shared by op replay
    (:func:`_iter_ops`) and torn-tail scanning so record validity can
    never diverge between them."""
    typ = data[pos]
    (value,) = struct.unpack_from("<Q", data, pos + 1)
    (chk,) = struct.unpack_from("<I", data, pos + 9)
    want = fnv1a32(bytes(data[pos : pos + 9]))
    if chk != want:
        return typ, value, f"checksum mismatch: exp={want:08x}, got={chk:08x}"
    if typ not in (OP_ADD, OP_REMOVE):
        return typ, value, f"invalid op type: {typ}"
    return typ, value, None


def _op_record_valid(data, pos: int) -> bool:
    return _read_op(data, pos)[2] is None


# Group-commit flush threshold for op-log appends — owned here, next to
# the record format, so the torn-tail bound below can never drift from
# the writer's actual flush size (fragment._OP_FLUSH_BYTES aliases it).
OP_FLUSH_BYTES = 64 << 10

# A process crash can tear at most one group-commit flush buffer off the
# op-log tail (plus the record that tripped the threshold).  An invalid
# tail LARGER than this cannot be crash residue — it is at-rest damage
# to committed data and must refuse to load rather than silently
# truncate.
MAX_TORN_TAIL = OP_FLUSH_BYTES + 2 * OP_SIZE


def scan_torn_tail(data, max_tail: int = MAX_TORN_TAIL) -> tuple[int, str] | None:
    """Decide whether an unparseable op-log is a TORN TAIL — the residue
    of a crash mid-append — and if so where the committed prefix ends.

    Returns ``(valid_end, reason)`` when the file's op region consists of
    a run of valid records followed ONLY by invalid bytes (a partial
    record at EOF, or full-size records that all fail their FNV check —
    what an interrupted group-commit ``write()`` leaves, since appends
    are sequential).  Returns ``None`` when the op-log is healthy OR when
    a VALID record exists beyond the first invalid one: that shape means
    mid-log damage to committed data (e.g. a flipped bit at rest), which
    must never be silently truncated away.

    The reference's recovery window is one 13-byte record (it appends
    per-op, fragment.go:379-418); group commit widens the torn window to
    the flush buffer, so recovery must handle a multi-record tail — but
    never one larger than ``max_tail`` (see :data:`MAX_TORN_TAIL`).
    Analog: roaring/roaring.go:622-646 (op replay on open).
    """
    ops_offset = ops_region_offset(data)
    pos = ops_offset
    n = len(data)
    # Only the final max_tail window can be torn, and records are a
    # fixed 13 bytes from ops_offset, so the scan can fast-forward to
    # the record boundary nearest (n - max_tail): identical accept /
    # refuse outcomes — damage before the window makes the caller's
    # committed-prefix decode refuse — at O(64 KiB) cost instead of
    # O(op-log) per-byte Python FNV on a multi-hundred-MB log.
    if n - pos > max_tail:
        pos += ((n - max_tail - pos) // OP_SIZE) * OP_SIZE
    while pos < n:
        if n - pos < OP_SIZE:
            return pos, f"partial {n - pos}-byte op record at EOF"
        if not _op_record_valid(data, pos):
            # First bad record.  Torn iff nothing after it validates —
            # scan the remaining aligned windows (a random 13-byte blob
            # passes the 32-bit FNV check with p ~= 2^-32) — and the
            # invalid run fits inside one flush buffer.
            if n - pos > max_tail:
                return None
            q = pos + OP_SIZE
            while q + OP_SIZE <= n:
                if _op_record_valid(data, q):
                    return None
                q += OP_SIZE
            return pos, f"unchecksummed {n - pos}-byte op-log tail"
        pos += OP_SIZE
    return None


def _iter_ops(data: bytes, ops_offset: int):
    """Validate and yield (typ, value) op-log records — the single
    parser of the 13-byte wire record, shared by both appliers."""
    pos = ops_offset
    while pos < len(data):
        if len(data) - pos < OP_SIZE:
            raise CorruptError(f"op data out of bounds: len={len(data) - pos}")
        typ, value, problem = _read_op(data, pos)
        if problem is not None:
            raise CorruptError(problem)
        yield typ, value
        pos += OP_SIZE


def _apply_ops(containers: dict[int, np.ndarray], data: bytes, ops_offset: int) -> int:
    """Replay the op-log over words-form containers; returns the number
    of ops applied."""
    op_n = 0
    for typ, value in _iter_ops(data, ops_offset):
        key = value >> 16
        word, shift = divmod(value & 0xFFFF, 64)
        if key not in containers:
            containers[key] = np.zeros(CONTAINER_WORDS64, dtype=np.uint64)
        mask = np.uint64(1) << np.uint64(shift)
        if typ == OP_ADD:
            containers[key][word] |= mask
        else:
            containers[key][word] &= ~mask
        op_n += 1
    return op_n


def _apply_ops_tiered(
    words: dict[int, np.ndarray],
    arrays: dict[int, np.ndarray],
    data: bytes,
    ops_offset: int,
) -> int:
    """Op-log replay over tiered containers; array containers mutate in
    value form (sorted insert/remove) without materialization."""
    op_n = 0
    for typ, value in _iter_ops(data, ops_offset):
        key = value >> 16
        low = np.uint32(value & 0xFFFF)
        if key in words:
            word, shift = divmod(int(low), 64)
            mask = np.uint64(1) << np.uint64(shift)
            if typ == OP_ADD:
                words[key][word] |= mask
            else:
                words[key][word] &= ~mask
        else:
            vals = arrays.get(key)
            if vals is None:
                vals = np.empty(0, dtype=np.uint32)
            i = int(np.searchsorted(vals, low))
            present = i < len(vals) and vals[i] == low
            if typ == OP_ADD and not present:
                arrays[key] = np.insert(vals, i, low)
            elif typ == OP_REMOVE and present:
                arrays[key] = np.delete(vals, i)
            elif key not in arrays:
                arrays[key] = vals
        op_n += 1
    return op_n


def encode(containers: dict[int, np.ndarray]) -> bytes:
    """Serialize {container_key: uint64[1024]} to the reference file format.

    Empty containers are dropped (reference: roaring/roaring.go:510-531
    skips c.n == 0).  Containers with <= 4096 bits are written in array
    form, else bitmap form.
    """
    return encode_tiered(containers, {})


def encode_packed(
    keys: np.ndarray,
    words2d: np.ndarray,
    arrays: dict[int, np.ndarray] | None = None,
) -> bytes:
    """Serialize a PACKED dense tier — ``keys`` ascending container
    keys, ``words2d[i]`` the 1024-u64 payload of ``keys[i]`` — plus an
    optional sparse-arrays tier.  The all-dense case hands the buffers
    straight to the C++ codec with no per-container Python; mixed or
    native-less cases take the general dict path."""
    from pilosa_tpu_torch import native

    if not arrays:
        res = native.encode_packed(keys, words2d)
        if res is not None:
            return res
    words = {int(k): words2d[i] for i, k in enumerate(keys)}
    return encode_tiered(words, arrays or {})


def encode_tiered(
    words: dict[int, np.ndarray], arrays: dict[int, np.ndarray]
) -> bytes:
    """Serialize tiered containers (see decode_tiered) to the reference
    file format, choosing array vs bitmap payload form by the SAME
    n <= 4096 rule regardless of the in-memory form; empty containers
    are dropped.  Peak transient memory is one container.  All-words
    inputs (the dense-fragment case) dispatch to the C++ codec."""
    from pilosa_tpu_torch import native

    if not arrays:
        res = native.encode(words)
        if res is not None:
            return res
    return encode_tiered_py(words, arrays)


def encode_tiered_py(
    words: dict[int, np.ndarray], arrays: dict[int, np.ndarray]
) -> bytes:
    """The Python path of :func:`encode_tiered`."""
    entries: list[tuple[int, int, object, bool]] = []  # key, n, src, is_vals
    for key, vals in arrays.items():
        if key in words:
            raise ValueError(f"container key={key} present in both tiers")
        if len(vals):
            entries.append((int(key), len(vals), vals, True))
    for key, w in words.items():
        n = _words_count(w)
        if n:
            entries.append((int(key), n, w, False))
    entries.sort()

    payloads: list[bytes] = []
    for key, n, src, is_vals in entries:
        if n <= ARRAY_MAX_SIZE:
            vals = src if is_vals else words_to_values(src)
            payloads.append(np.asarray(vals, dtype="<u4").tobytes())
        else:
            w = values_to_words(src) if is_vals else src
            payloads.append(np.asarray(w, dtype="<u8").tobytes())

    # Vectorized key/offset tables (a tall-sparse fragment serializes
    # hundreds of thousands of containers).
    ktab = np.zeros(len(entries), dtype=np.dtype([("key", "<u8"), ("n1", "<u4")]))
    ktab["key"] = [key for key, _, _, _ in entries]
    ktab["n1"] = [n - 1 for _, n, _, _ in entries]
    plens = np.asarray([len(p) for p in payloads], dtype=np.int64)
    base = HEADER_SIZE + 12 * len(entries) + 4 * len(entries)
    otab = (base + np.concatenate(([0], np.cumsum(plens[:-1])))
            if len(entries) else np.empty(0, np.int64)).astype("<u4")

    out = io.BytesIO()
    out.write(struct.pack("<II", COOKIE, len(entries)))
    out.write(ktab.tobytes())
    out.write(otab.tobytes())
    for p in payloads:
        out.write(p)
    return out.getvalue()


def encode_op(typ: int, value: int) -> bytes:
    """One 13-byte op-log record (reference: roaring/roaring.go:1746-1762)."""
    buf = struct.pack("<BQ", typ, value)
    return buf + struct.pack("<I", fnv1a32(buf))


def _words_count(words: np.ndarray) -> int:
    return int(np.unpackbits(words.view(np.uint8)).sum())


def info(data: bytes) -> BitmapInfo:
    """Container stats + op count for ``inspect`` (reference:
    roaring.Bitmap.Info, roaring/roaring.go:669-683, ctl/inspect.go).
    Runs on the tiered parse — array containers are never materialized,
    so tall-sparse files inspect in O(file size)."""
    words, arrays, ops_offset, infos = _decode_containers_tiered(data)
    op_n = sum(1 for _ in _iter_ops(data, ops_offset))
    return BitmapInfo(ops=op_n, containers=infos)


def check(data: bytes) -> list[str]:
    """Consistency check (reference: roaring.Bitmap.Check,
    roaring/roaring.go:686-706, driven by ctl/check.go).  Returns a list
    of problem strings, empty when healthy.  Array containers are
    validated during the tiered parse (range + sortedness, and their
    header n IS their length); bitmap containers verify n against the
    actual popcount; the op-log replays through the shared record
    parser."""
    errs: list[str] = []
    try:
        words, arrays, ops_offset, infos = _decode_containers_tiered(data)
    except CorruptError as e:
        return [str(e)]
    for ci in infos:
        if ci.type == "bitmap":
            actual = _words_count(words[ci.key])
            if ci.n != actual:
                errs.append(
                    f"container key={ci.key} count mismatch: n={ci.n}, count={actual}"
                )
    try:
        for _ in _iter_ops(data, ops_offset):
            pass
    except CorruptError as e:
        errs.append(str(e))
    return errs


# ---------------------------------------------------------------------------
# Bridges between the container dict and the dense slice-row planes used by
# core.fragment.  A fragment file covers bit positions
# row*SLICE_WIDTH + (column % SLICE_WIDTH); container key k covers positions
# [k*2^16, (k+1)*2^16) — i.e. 16 consecutive containers per row.
# ---------------------------------------------------------------------------


def containers_to_plane(containers: dict[int, np.ndarray], slice_width: int) -> np.ndarray:
    """Densify into a (rows, slice_width/32) uint32 plane."""
    per_row = slice_width // CONTAINER_BITS
    max_key = max(containers.keys(), default=-1)
    rows = (max_key // per_row) + 1 if max_key >= 0 else 0
    plane = np.zeros((max(rows, 1), slice_width // 32), dtype=np.uint32)
    words32_per_container = CONTAINER_BITS // 32
    for key, words in containers.items():
        row, cidx = divmod(key, per_row)
        lo = cidx * words32_per_container
        plane[row, lo : lo + words32_per_container] = words.view("<u4").astype(np.uint32)
    return plane


def plane_to_containers(plane: np.ndarray, slice_width: int) -> dict[int, np.ndarray]:
    """Sparsify a (rows, slice_width/32) plane into the container dict."""
    per_row = slice_width // CONTAINER_BITS
    words32_per_container = CONTAINER_BITS // 32
    out: dict[int, np.ndarray] = {}
    nz_rows = np.nonzero(plane.any(axis=1))[0]
    for row in nz_rows:
        for cidx in range(per_row):
            lo = cidx * words32_per_container
            chunk = plane[row, lo : lo + words32_per_container]
            if chunk.any():
                out[int(row) * per_row + cidx] = np.ascontiguousarray(chunk).view(
                    np.uint64
                ).copy()
    return out


