"""The port's hand-written protobuf wire (``pilosa_tpu_torch.net.wire``)
against the generated ``pilosa_tpu.net.wire_pb2``: for seeded and
hypothesis-drawn messages of every type the port speaks, the port's
``encode()`` equals ``SerializeToString()`` byte for byte, and each side
decodes the other's bytes.  Also: unpacked repeated fields, unknown
fields, uint64 values above 2^63, and malformed input."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu_torch.net import wire  # noqa: E402

MESSAGES = [
    wire.Bitmap,
    wire.Pair,
    wire.Attr,
    wire.ColumnAttrSet,
    wire.QueryRequest,
    wire.QueryResponse,
    wire.QueryResult,
    wire.ImportRequest,
    wire.ImportResponse,
    wire.MaxSlicesResponse,
    wire.CreateSliceMessage,
    wire.CreateIndexMessage,
    wire.DeleteIndexMessage,
    wire.CreateFrameMessage,
    wire.DeleteFrameMessage,
    wire.IndexMeta,
    wire.FrameMeta,
    wire.BlockDataRequest,
    wire.BlockDataResponse,
    wire.ImportViewRequest,
]

U64_MAX = (1 << 64) - 1


def to_pb(msg):
    """The wire_pb2 message with the same field values."""
    out = getattr(pb, type(msg).__name__)()
    for _, name, kind, repeated, _sub in msg._FIELDS:
        v = getattr(msg, name)
        if kind == wire.MAP_STR_U64:
            for k, val in v.items():
                getattr(out, name)[k] = val
        elif kind == wire.MSG:
            if repeated:
                getattr(out, name).extend(to_pb(m) for m in v)
            elif v is not None:
                getattr(out, name).CopyFrom(to_pb(v))
        elif repeated:
            getattr(out, name).extend(list(v))
        else:
            setattr(out, name, v)
    return out


# --- strategies ------------------------------------------------------------

_SCALARS = {
    wire.U64: st.integers(0, U64_MAX),
    wire.I64: st.integers(-(1 << 63), (1 << 63) - 1),
    wire.U32: st.integers(0, (1 << 32) - 1),
    wire.BOOL: st.booleans(),
    wire.STR: st.text(max_size=12),
    wire.F64: st.floats(allow_nan=False) | st.just(-0.0),
}


def strategy(cls, depth: int = 0):
    kwargs = {}
    for _, name, kind, repeated, sub in cls._FIELDS:
        if kind == wire.MAP_STR_U64:
            # More than one entry has no canonical byte order in
            # wire_pb2 (see test_map_with_many_entries).
            s = st.dictionaries(st.text(max_size=6), _SCALARS[wire.U64], max_size=1)
        elif kind == wire.MSG:
            inner = strategy(sub, depth + 1)
            if repeated:
                s = st.lists(inner, max_size=3 if depth < 2 else 0)
            else:
                s = st.none() | inner
        elif repeated:
            s = st.lists(_SCALARS[kind], max_size=20)
        else:
            s = _SCALARS[kind]
        kwargs[name] = s
    return st.builds(cls, **kwargs)


def assert_same_wire(msg) -> None:
    ours = msg.encode()
    theirs = to_pb(msg).SerializeToString()
    assert ours == theirs
    # Each side decodes the other's bytes to the same message.
    parsed = getattr(pb, type(msg).__name__)()
    parsed.ParseFromString(ours)
    assert parsed.SerializeToString() == theirs
    assert type(msg).decode(theirs).encode() == ours


@pytest.mark.parametrize("cls", MESSAGES, ids=lambda c: c.__name__)
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_drawn_messages_encode_as_wire_pb2(cls, data):
    assert_same_wire(data.draw(strategy(cls)))


def seeded(cls, rng, depth: int = 0):
    """A message with every field set from the seed (unlike a drawn one,
    never empty)."""
    kwargs = {}
    for _, name, kind, repeated, sub in cls._FIELDS:
        if kind == wire.MAP_STR_U64:
            v = {f"index{int(rng.integers(1000))}": int(rng.integers(0, 1 << 63))}
        elif kind == wire.MSG:
            if repeated:
                v = [seeded(sub, rng, depth + 1) for _ in range(2 if depth < 2 else 0)]
            else:
                v = seeded(sub, rng, depth + 1)
        else:
            one = {
                wire.U64: lambda: int(rng.integers(0, 1 << 63)) * 2 + 1,
                wire.I64: lambda: int(rng.integers(-(1 << 62), 1 << 62)),
                wire.U32: lambda: int(rng.integers(1, 1 << 32)),
                wire.BOOL: lambda: True,
                wire.STR: lambda: "k" + "é" * int(rng.integers(0, 3)),
                wire.F64: lambda: float(rng.normal()),
            }[kind]
            v = [one() for _ in range(int(rng.integers(1, 50)))] if repeated else one()
        kwargs[name] = v
    return cls(**kwargs)


@pytest.mark.parametrize("cls", MESSAGES, ids=lambda c: c.__name__)
def test_seeded_messages_encode_as_wire_pb2(cls):
    rng = np.random.default_rng(len(cls.__name__))
    for _ in range(5):
        assert_same_wire(seeded(cls, rng))


def test_empty_singular_message_is_written():
    """An empty Bitmap result is present on the wire (it is how a
    Bitmap result with no bits differs from a count of 0)."""
    msg = wire.QueryResult(Bitmap=wire.Bitmap())
    assert msg.encode() == b"\n\x00"
    assert_same_wire(msg)
    assert wire.QueryResult.decode(b"\n\x00").Bitmap == wire.Bitmap()
    assert wire.QueryResult.decode(b"").Bitmap is None


def test_unpacked_repeated_fields_decode():
    rows = [0, 1, 300, U64_MAX, 1 << 63]
    ts = [-1, 0, 5, -(1 << 63)]
    ref = pb.ImportRequest(RowIDs=rows, Timestamps=ts)
    # Unpacked: one key + varint per value (what proto2 writers send).
    body = b"".join(b"\x20" + wire._varint(v) for v in rows)
    body += b"".join(b"\x30" + wire._varint(v & U64_MAX) for v in ts)
    ours = wire.ImportRequest.decode(body)
    assert ours.RowIDs == rows and ours.Timestamps == ts
    theirs = pb.ImportRequest()
    theirs.ParseFromString(body)
    assert list(theirs.RowIDs) == rows and list(theirs.Timestamps) == ts
    assert ours.encode() == ref.SerializeToString()
    # Packed and unpacked runs of one field concatenate.
    mixed = wire.ImportRequest(RowIDs=[7, 8]).encode() + b"\x20\x09"
    assert wire.ImportRequest.decode(mixed).RowIDs == [7, 8, 9]


def test_unknown_fields_are_skipped():
    known = pb.QueryRequest(Query="Count(Bitmap(rowID=1))", Slices=[1, 2], Remote=True)
    unknown = (
        b"\xa8\x06\x96\x01"  # field 101, varint
        + b"\xb1\x06" + b"\x01" * 8  # field 102, fixed64
        + b"\xba\x06\x03abc"  # field 103, length-delimited
        + b"\xc5\x06" + b"\x02" * 4  # field 104, fixed32
    )
    body = unknown + known.SerializeToString() + unknown
    ours = wire.QueryRequest.decode(body)
    assert ours == wire.QueryRequest(Query="Count(Bitmap(rowID=1))", Slices=[1, 2], Remote=True)
    theirs = pb.QueryRequest()
    theirs.ParseFromString(body)
    theirs.DiscardUnknownFields()  # wire_pb2 keeps them; the port drops them
    assert ours.encode() == known.SerializeToString() == theirs.SerializeToString()


@pytest.mark.parametrize(
    "value", [1 << 63, (1 << 63) + 1, U64_MAX - 1, U64_MAX], ids=lambda v: hex(v)
)
def test_uint64_above_2_63(value):
    for msg in (
        wire.Pair(Key=value, Count=value),
        wire.Bitmap(Bits=[value, 0, value]),
        wire.ColumnAttrSet(ID=value),
        wire.QueryResult(N=value),
        wire.ImportRequest(Slice=value, RowIDs=np.asarray([value], dtype=np.uint64)),
    ):
        assert_same_wire(msg)
    assert wire.Pair.decode(wire.Pair(Key=value).encode()).Key == value


@pytest.mark.parametrize(
    "value", [0, 1, (1 << 32) + 7, 1 << 63, U64_MAX - 1, U64_MAX], ids=lambda v: hex(v)
)
def test_block_sync_messages_carry_every_uint64(value):
    """The three messages of block sync and view-scoped repair, with ids
    up to 2^64 - 1, encode as wire_pb2 does; ``BlockDataRequest`` writes
    View (field 5) after Slice (4) and Block (3), by field number."""
    ids = np.asarray([value, 0, value, 1], dtype=np.uint64)
    for msg in (
        wire.BlockDataRequest(Index="i", Frame="f", View="standard", Slice=value, Block=value),
        wire.BlockDataResponse(RowIDs=ids, ColumnIDs=ids[::-1].copy()),
        wire.ImportViewRequest(Index="i", Frame="f", View="inverse", Slice=value, RowIDs=ids,
                               ColumnIDs=ids, ClearRowIDs=ids[:2], ClearColumnIDs=ids[2:]),
        wire.ImportViewRequest(ClearRowIDs=[value], ClearColumnIDs=[value]),
    ):
        assert_same_wire(msg)
    got = wire.ImportViewRequest.decode(
        pb.ImportViewRequest(RowIDs=[value], ColumnIDs=[value]).SerializeToString())
    assert [int(v) for v in got.RowIDs] == [int(v) for v in got.ColumnIDs] == [value]
    enc = wire.BlockDataRequest(View="v", Slice=2, Block=1).encode()
    assert enc == b"\x18\x01\x20\x02\x2a\x01v"


def test_map_with_many_entries():
    """wire_pb2 writes map entries in no fixed order; the port writes
    them by key.  Either side reads the other's map."""
    ms = {"a": 5, "": 0, "zz": U64_MAX, "i": 3}
    ours = wire.MaxSlicesResponse(MaxSlices=ms).encode()
    theirs = pb.MaxSlicesResponse()
    theirs.ParseFromString(ours)
    assert dict(theirs.MaxSlices) == ms
    theirs = to_pb(wire.MaxSlicesResponse(ms)).SerializeToString()
    assert wire.MaxSlicesResponse.decode(theirs).MaxSlices == ms


@pytest.mark.parametrize(
    "body",
    [b"\x0a\x05ab", b"\x10\xff\xff", b"\x0b", b"\x22\x02\xff", b"\x0a\x02\xff\xfe"],
    ids=["truncated-string", "truncated-varint", "group", "truncated-packed", "bad-utf8"],
)
def test_malformed_input_raises(body):
    with pytest.raises(wire.DecodeError):
        wire.ImportRequest.decode(body)
    with pytest.raises(Exception):  # wire_pb2 refuses it too
        pb.ImportRequest().ParseFromString(body)


def test_negative_in_unsigned_field_raises():
    with pytest.raises(ValueError):
        wire.Pair(Key=-1).encode()
    with pytest.raises(ValueError):
        wire.Bitmap(Bits=[1, -1]).encode()


@given(value=st.integers(-(1 << 63), (1 << 63) - 1), count=st.integers(0, 1 << 40))
@settings(max_examples=80, deadline=None)
def test_valcount_rides_pairs_as_jax(value, count):
    """A Sum/Min/Max result travels as one Pair (value u64-wrapped, then
    sign-extended by the reduce): the same bytes as the JAX codec's, the
    same JSON, and the executor's decode gives the value back."""
    from pilosa_tpu import bsi as jbsi
    from pilosa_tpu.net import codec as jcodec
    from pilosa_tpu_torch import bsi as tbsi
    from pilosa_tpu_torch.exec.executor import Executor
    from pilosa_tpu_torch.net import codec as tcodec

    ours = tcodec.result_to_proto(tbsi.ValCount(value, count)).encode()
    theirs = jcodec.result_to_proto(jbsi.ValCount(value, count)).SerializeToString()
    assert ours == theirs
    resp = tcodec.response_to_proto([tbsi.ValCount(value, count), None]).encode()
    assert resp == jcodec.response_to_proto([jbsi.ValCount(value, count), None]).SerializeToString()
    assert tcodec.result_to_json(tbsi.ValCount(value, count)) == jcodec.result_to_json(
        jbsi.ValCount(value, count))
    back = tcodec.result_from_proto(wire.QueryResult.decode(theirs))
    assert Executor._normalize_valcount(back) == tbsi.ValCount(value, count)
