"""The protobuf wire, written by hand: proto3 encode/decode of the
messages in ``pilosa_tpu/net/wire.proto`` that the port speaks.

The machine with the card has no protobuf package, so the messages are
plain dataclasses with ``encode() -> bytes`` and ``decode(bytes)``.  The
encoding is proto3's, byte for byte what ``SerializeToString()`` of the
generated ``wire_pb2`` gives for the same message:

* fields in field-number order; a singular scalar equal to its default
  (0, "", False, +0.0) is left out; -0.0 and NaN are written;
* a singular message field is written when it is not ``None``, even
  when empty (``QueryResult.Bitmap`` tells an empty bitmap from a count
  that way);
* repeated scalars are packed; repeated messages one record each;
* a ``map<string, uint64>`` entry always carries key and value, and
  entries go out in key order.

The decoder takes packed and unpacked repeated scalars, skips unknown
fields, and lets the last value of a singular scalar win, as proto3
parsers do.  uint64 values span the full 0..2^64-1 range; int64 travels
as its two's complement (ten varint bytes when negative).  Packed
integer runs encode and decode vectorized with numpy: an ``/import``
body carries a million row and column ids.
"""

from __future__ import annotations

import operator
import struct
from dataclasses import dataclass, field, fields

import numpy as np

_MASK64 = (1 << 64) - 1

# Field kinds.
U64, I64, U32, BOOL, STR, F64, MSG, MAP_STR_U64 = range(8)
_VARINT_KINDS = (U64, I64, U32, BOOL)

# Wire types.
_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


class DecodeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    v &= _MASK64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    v = 0
    shift = 0
    end = len(buf)
    while True:
        if pos >= end or shift >= 70:
            raise DecodeError("truncated or overlong varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v & _MASK64, pos
        shift += 7


def _as_u64_array(values, kind: int) -> np.ndarray:
    """Repeated integer values as uint64 bit patterns (int64 two's
    complement); a negative value in an unsigned field raises."""
    if kind == I64:
        return np.asarray(values, dtype=np.int64).view(np.uint64)
    a = np.asarray(values)
    if a.dtype.kind == "i":
        if (a < 0).any():
            raise ValueError("negative value in an unsigned field")
        a = a.astype(np.uint64)
    elif a.dtype.kind != "u":
        a = np.asarray(values, dtype=np.uint64)
    if kind == U32 and (a > 0xFFFFFFFF).any():
        raise ValueError("value out of range for uint32")
    return a.astype(np.uint64, copy=False)


def _varints(v: np.ndarray) -> bytes:
    """Packed varint bytes of a uint64 array, vectorized: a value's k-th
    byte in column k of a [values, bytes of the largest] grid (in uint32
    arithmetic where the values fit), the grid read row by row up to each
    value's own length."""
    if not len(v):
        return b""
    nmax = max(1, (int(v.max()).bit_length() + 6) // 7)
    if nmax == 1:
        return v.astype(np.uint8).tobytes()
    w = v.astype(np.uint32) if nmax <= 4 else v
    one = w.dtype.type
    n = np.ones(len(v), dtype=np.uint8)
    for k in range(1, nmax):
        n += w >= one(1 << (7 * k))
    cols = []
    for k in range(nmax):
        byte = ((w >> one(7 * k)) & one(0x7F)).astype(np.uint8)
        if k < nmax - 1:
            byte |= (n > k + 1).view(np.uint8) << 7
        cols.append(byte)
    grid = np.stack(cols, axis=1)
    if (n == nmax).all():
        return grid.tobytes()
    return grid[np.arange(nmax, dtype=np.uint8)[None, :] < n[:, None]].tobytes()


def _read_varints(buf: bytes) -> np.ndarray:
    """uint64 values of a packed varint run, vectorized (in uint32
    arithmetic where every value has at most 4 bytes)."""
    b = np.frombuffer(buf, dtype=np.uint8)
    if not len(b):
        return np.zeros(0, dtype=np.uint64)
    ends = np.flatnonzero(b < 0x80)
    if not len(ends) or ends[-1] != len(b) - 1:
        raise DecodeError("truncated packed varint run")
    if len(ends) == len(b):  # every value one byte
        return b.astype(np.uint64)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    n = ends - starts + 1
    nmax = int(n.max())
    if nmax > 10:
        raise DecodeError("overlong varint")
    acc = np.uint32 if nmax <= 4 else np.uint64
    v = (b[starts] & 0x7F).astype(acc)
    last = len(b) - 1
    for k in range(1, nmax):
        byte = b[np.minimum(starts + k, last)] & 0x7F
        byte[n <= k] = 0
        v |= byte.astype(acc) << acc(7 * k)
    return v.astype(np.uint64, copy=False)


def _from_u64(v: int, kind: int):
    if kind == I64:
        return v - (1 << 64) if v >> 63 else v
    if kind == U32:
        return v & 0xFFFFFFFF
    if kind == BOOL:
        return v != 0
    return v


def _from_u64_array(v: np.ndarray, kind: int) -> list:
    if kind == I64:
        return v.view(np.int64).tolist()
    if kind == U32:
        return (v & np.uint64(0xFFFFFFFF)).tolist()
    if kind == BOOL:
        return (v != 0).tolist()
    return v.tolist()


def _skip(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _WT_VARINT:
        return _read_varint(buf, pos)[1]
    if wire_type == _WT_I64:
        pos += 8
    elif wire_type == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == _WT_I32:
        pos += 4
    else:
        raise DecodeError(f"unsupported wire type {wire_type}")
    if pos > len(buf):
        raise DecodeError("truncated field")
    return pos


def _key(number: int, wire_type: int) -> bytes:
    return _varint(number << 3 | wire_type)


def _len_field(number: int, payload: bytes) -> bytes:
    return _key(number, _WT_LEN) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


class Message:
    """Base of the wire dataclasses.  ``_FIELDS`` lists
    ``(number, name, kind, repeated, message class or None)`` in
    field-number order."""

    _FIELDS: tuple = ()

    def encode(self) -> bytes:
        out = bytearray()
        for number, name, kind, repeated, sub in self._FIELDS:
            v = getattr(self, name)
            if kind == MAP_STR_U64:
                for k in sorted(v):
                    entry = _len_field(1, k.encode()) + _key(2, _WT_VARINT) + _varint(v[k])
                    out += _len_field(number, entry)
            elif kind == MSG:
                if repeated:
                    for m in v:
                        out += _len_field(number, m.encode())
                elif v is not None:
                    out += _len_field(number, v.encode())
            elif repeated:
                if len(v) == 0:
                    continue
                if kind == STR:
                    for s in v:
                        out += _len_field(number, s.encode())
                elif kind == F64:
                    out += _len_field(number, struct.pack(f"<{len(v)}d", *v))
                else:
                    out += _len_field(number, _varints(_as_u64_array(v, kind)))
            elif kind == STR:
                if v:
                    out += _len_field(number, v.encode())
            elif kind == F64:
                raw = struct.pack("<d", v)
                if raw != b"\x00" * 8:
                    out += _key(number, _WT_I64) + raw
            elif v:
                if kind in (U64, U32) and v < 0:
                    raise ValueError(f"{name}: negative value in an unsigned field")
                if kind == U32 and v > 0xFFFFFFFF:
                    raise ValueError(f"{name}: value out of range for uint32")
                out += _key(number, _WT_VARINT) + _varint(int(v))
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes):
        msg = cls()
        msg._merge(bytes(data))
        return msg

    def _merge(self, buf: bytes) -> None:
        by_number = {f[0]: f for f in self._FIELDS}
        pos = 0
        end = len(buf)
        while pos < end:
            key, pos = _read_varint(buf, pos)
            number, wire_type = key >> 3, key & 7
            spec = by_number.get(number)
            if spec is None or number == 0:
                pos = _skip(buf, pos, wire_type)
                continue
            _, name, kind, repeated, sub = spec
            if wire_type == _WT_LEN:
                n, pos = _read_varint(buf, pos)
                payload = buf[pos : pos + n]
                if len(payload) != n:
                    raise DecodeError(f"{name}: truncated field")
                pos += n
                self._merge_len(name, kind, repeated, sub, payload)
            elif wire_type == _WT_VARINT and kind in _VARINT_KINDS:
                v, pos = _read_varint(buf, pos)
                self._set_scalar(name, repeated, _from_u64(v, kind))
            elif wire_type == _WT_I64 and kind == F64:
                if pos + 8 > end:
                    raise DecodeError(f"{name}: truncated double")
                (v,) = struct.unpack_from("<d", buf, pos)
                pos += 8
                self._set_scalar(name, repeated, v)
            else:
                raise DecodeError(f"{name}: wire type {wire_type} does not fit the field")

    def _set_scalar(self, name: str, repeated: bool, v) -> None:
        if repeated:
            getattr(self, name).append(v)
        else:
            setattr(self, name, v)

    def _merge_len(self, name, kind, repeated, sub, payload: bytes) -> None:
        if kind == MSG:
            if repeated:
                getattr(self, name).append(sub.decode(payload))
            else:
                cur = getattr(self, name)
                if cur is None:
                    setattr(self, name, sub.decode(payload))
                else:
                    cur._merge(payload)
        elif kind == MAP_STR_U64:
            entry = _MapEntry.decode(payload)
            getattr(self, name)[entry.key] = entry.value
        elif kind == STR:
            try:
                s = payload.decode()
            except UnicodeDecodeError as e:
                raise DecodeError(f"{name}: invalid UTF-8") from e
            self._set_scalar(name, repeated, s)
        elif repeated and kind in _VARINT_KINDS:
            getattr(self, name).extend(_from_u64_array(_read_varints(payload), kind))
        elif repeated and kind == F64:
            if len(payload) % 8:
                raise DecodeError(f"{name}: packed doubles of odd length")
            getattr(self, name).extend(struct.unpack(f"<{len(payload) // 8}d", payload))
        else:
            raise DecodeError(f"{name}: length-delimited data for a scalar field")

    def __repr__(self) -> str:
        parts = []
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list) and len(v) > 8:
                v = f"[{len(v)} items]"
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def check_scalars(msg: Message) -> None:
    """Raise what the generated ``wire_pb2`` constructor raises for a
    singular scalar it cannot hold, with its exception type and text,
    checking the fields in field-number order: a string field takes
    ``str``/``bytes``; an integer or bool field takes what
    ``operator.index`` takes, a uint32 in 0..2^32-1, a bool a C long.
    ``None`` leaves a field unset."""
    for _, name, kind, repeated, _ in msg._FIELDS:
        v = getattr(msg, name)
        if repeated or v is None or kind not in (STR, *_VARINT_KINDS):
            continue
        if kind == STR:
            if not isinstance(v, (str, bytes)):
                raise TypeError("bad argument type for built-in operation")
            continue
        try:
            i = operator.index(v)
        except TypeError:
            raise TypeError(
                f"'{type(v).__name__}' object cannot be interpreted as an integer") from None
        if kind == BOOL and not -(1 << 63) <= i < 1 << 63:
            raise OverflowError("Python int too large to convert to C long")
        if kind == U32 and not 0 <= i <= 0xFFFFFFFF:
            raise ValueError(f"Value out of range: {i}")


def _spec(cls, *specs):
    cls._FIELDS = tuple(sorted(specs))
    return cls


@dataclass(repr=False)
class _MapEntry(Message):
    key: str = ""
    value: int = 0


_spec(_MapEntry, (1, "key", STR, False, None), (2, "value", U64, False, None))


# ---- public (reference: internal/public.proto) ----


@dataclass(repr=False)
class Attr(Message):
    Key: str = ""
    Type: int = 0
    StringValue: str = ""
    IntValue: int = 0
    BoolValue: bool = False
    FloatValue: float = 0.0


_spec(
    Attr,
    (1, "Key", STR, False, None),
    (2, "Type", U64, False, None),
    (3, "StringValue", STR, False, None),
    (4, "IntValue", I64, False, None),
    (5, "BoolValue", BOOL, False, None),
    (6, "FloatValue", F64, False, None),
)


@dataclass(repr=False)
class Bitmap(Message):
    Bits: list = field(default_factory=list)
    Attrs: list = field(default_factory=list)


_spec(Bitmap, (1, "Bits", U64, True, None), (2, "Attrs", MSG, True, Attr))


@dataclass(repr=False)
class Pair(Message):
    Key: int = 0
    Count: int = 0


_spec(Pair, (1, "Key", U64, False, None), (2, "Count", U64, False, None))


@dataclass(repr=False)
class ColumnAttrSet(Message):
    ID: int = 0
    Attrs: list = field(default_factory=list)


_spec(ColumnAttrSet, (1, "ID", U64, False, None), (2, "Attrs", MSG, True, Attr))


@dataclass(repr=False)
class QueryRequest(Message):
    Query: str = ""
    Slices: list = field(default_factory=list)
    ColumnAttrs: bool = False
    Quantum: str = ""
    Remote: bool = False


_spec(
    QueryRequest,
    (1, "Query", STR, False, None),
    (2, "Slices", U64, True, None),
    (3, "ColumnAttrs", BOOL, False, None),
    (4, "Quantum", STR, False, None),
    (5, "Remote", BOOL, False, None),
)


@dataclass(repr=False)
class QueryResult(Message):
    Bitmap: Bitmap | None = None
    N: int = 0
    Pairs: list = field(default_factory=list)
    Changed: bool = False


_spec(
    QueryResult,
    (1, "Bitmap", MSG, False, Bitmap),
    (2, "N", U64, False, None),
    (3, "Pairs", MSG, True, Pair),
    (4, "Changed", BOOL, False, None),
)


@dataclass(repr=False)
class QueryResponse(Message):
    Err: str = ""
    Results: list = field(default_factory=list)
    ColumnAttrSets: list = field(default_factory=list)


_spec(
    QueryResponse,
    (1, "Err", STR, False, None),
    (2, "Results", MSG, True, QueryResult),
    (3, "ColumnAttrSets", MSG, True, ColumnAttrSet),
)


@dataclass(repr=False)
class ImportRequest(Message):
    Index: str = ""
    Frame: str = ""
    Slice: int = 0
    RowIDs: list = field(default_factory=list)
    ColumnIDs: list = field(default_factory=list)
    Timestamps: list = field(default_factory=list)


_spec(
    ImportRequest,
    (1, "Index", STR, False, None),
    (2, "Frame", STR, False, None),
    (3, "Slice", U64, False, None),
    (4, "RowIDs", U64, True, None),
    (5, "ColumnIDs", U64, True, None),
    (6, "Timestamps", I64, True, None),
)


# ---- private (reference: internal/private.proto) ----


@dataclass(repr=False)
class ImportResponse(Message):
    Err: str = ""


_spec(ImportResponse, (1, "Err", STR, False, None))


@dataclass(repr=False)
class IndexMeta(Message):
    ColumnLabel: str = ""
    TimeQuantum: str = ""


_spec(IndexMeta, (1, "ColumnLabel", STR, False, None), (2, "TimeQuantum", STR, False, None))


@dataclass(repr=False)
class FrameMeta(Message):
    """Checked at construction, as the generated message is: a frame's
    options that the wire cannot carry fail the request that made them."""

    RowLabel: str = ""
    InverseEnabled: bool = False
    CacheType: str = ""
    CacheSize: int = 0
    TimeQuantum: str = ""

    def __post_init__(self):
        check_scalars(self)


_spec(
    FrameMeta,
    (1, "RowLabel", STR, False, None),
    (2, "InverseEnabled", BOOL, False, None),
    (3, "CacheType", STR, False, None),
    (4, "CacheSize", U32, False, None),
    (5, "TimeQuantum", STR, False, None),
)


@dataclass(repr=False)
class Frame(Message):
    Name: str = ""
    Meta: FrameMeta | None = None


_spec(Frame, (1, "Name", STR, False, None), (2, "Meta", MSG, False, FrameMeta))


@dataclass(repr=False)
class Index(Message):
    Name: str = ""
    Meta: IndexMeta | None = None
    MaxSlice: int = 0
    Frames: list = field(default_factory=list)
    Slices: list = field(default_factory=list)


_spec(
    Index,
    (1, "Name", STR, False, None),
    (2, "Meta", MSG, False, IndexMeta),
    (3, "MaxSlice", U64, False, None),
    (4, "Frames", MSG, True, Frame),
    (5, "Slices", U64, True, None),
)


@dataclass(repr=False)
class NodeStatus(Message):
    """A node's schema and max slices: the state blob gossip piggybacks
    and ``GET /state`` serves (reference: internal/private.proto)."""

    Host: str = ""
    State: str = ""
    Indexes: list = field(default_factory=list)


_spec(
    NodeStatus,
    (1, "Host", STR, False, None),
    (2, "State", STR, False, None),
    (3, "Indexes", MSG, True, Index),
)


@dataclass(repr=False)
class MaxSlicesResponse(Message):
    MaxSlices: dict = field(default_factory=dict)


_spec(MaxSlicesResponse, (1, "MaxSlices", MAP_STR_U64, False, None))


@dataclass(repr=False)
class CreateSliceMessage(Message):
    Index: str = ""
    Slice: int = 0
    IsInverse: bool = False


_spec(
    CreateSliceMessage,
    (1, "Index", STR, False, None),
    (2, "Slice", U64, False, None),
    (3, "IsInverse", BOOL, False, None),
)


@dataclass(repr=False)
class DeleteIndexMessage(Message):
    Index: str = ""


_spec(DeleteIndexMessage, (1, "Index", STR, False, None))


@dataclass(repr=False)
class CreateIndexMessage(Message):
    Index: str = ""
    Meta: IndexMeta | None = None


_spec(CreateIndexMessage, (1, "Index", STR, False, None), (2, "Meta", MSG, False, IndexMeta))


@dataclass(repr=False)
class CreateFrameMessage(Message):
    Index: str = ""
    Frame: str = ""
    Meta: FrameMeta | None = None


_spec(
    CreateFrameMessage,
    (1, "Index", STR, False, None),
    (2, "Frame", STR, False, None),
    (3, "Meta", MSG, False, FrameMeta),
)


@dataclass(repr=False)
class DeleteFrameMessage(Message):
    Index: str = ""
    Frame: str = ""


_spec(DeleteFrameMessage, (1, "Index", STR, False, None), (2, "Frame", STR, False, None))


# ---- block sync and view-scoped repair (reference: internal/private.proto) ----


@dataclass(repr=False)
class BlockDataRequest(Message):
    Index: str = ""
    Frame: str = ""
    View: str = ""
    Slice: int = 0
    Block: int = 0


# The field numbers of the reference: View (5) goes after Slice (4), so
# it is encoded last.
_spec(
    BlockDataRequest,
    (1, "Index", STR, False, None),
    (2, "Frame", STR, False, None),
    (3, "Block", U64, False, None),
    (4, "Slice", U64, False, None),
    (5, "View", STR, False, None),
)


@dataclass(repr=False)
class BlockDataResponse(Message):
    RowIDs: list = field(default_factory=list)
    ColumnIDs: list = field(default_factory=list)


_spec(BlockDataResponse, (1, "RowIDs", U64, True, None), (2, "ColumnIDs", U64, True, None))


@dataclass(repr=False)
class ImportViewRequest(Message):
    Index: str = ""
    Frame: str = ""
    View: str = ""
    Slice: int = 0
    RowIDs: list = field(default_factory=list)
    ColumnIDs: list = field(default_factory=list)
    ClearRowIDs: list = field(default_factory=list)
    ClearColumnIDs: list = field(default_factory=list)


_spec(
    ImportViewRequest,
    (1, "Index", STR, False, None),
    (2, "Frame", STR, False, None),
    (3, "View", STR, False, None),
    (4, "Slice", U64, False, None),
    (5, "RowIDs", U64, True, None),
    (6, "ColumnIDs", U64, True, None),
    (7, "ClearRowIDs", U64, True, None),
    (8, "ClearColumnIDs", U64, True, None),
)
