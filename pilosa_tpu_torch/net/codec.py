"""Wire codecs — the port's result types <-> protobuf / JSON.

The counterpart of ``pilosa_tpu.net.codec``: converts RowBitmaps, Pairs,
counts and attrs to and from the protobuf messages of ``net/wire.py``
and the JSON shapes, with the reference's polymorphic QueryResult
encoding (reference: handler.go:1380-1470, bitmap.go:220-268,
attr.go:256-303).  Attribute type tags and the uint64 wrap are those of
the JAX package, so both encode the same bytes.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pilosa_tpu_torch.bsi import ValCount
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.net import wire

# Attr value type tags (reference: attr.go:34-40)
ATTR_TYPE_STRING = 1
ATTR_TYPE_INT = 2
ATTR_TYPE_BOOL = 3
ATTR_TYPE_FLOAT = 4

_U64_MASK = (1 << 64) - 1


def _u64(v: int) -> int:
    return v & _U64_MASK


# ---------------------------------------------------------------------------
# attrs
# ---------------------------------------------------------------------------


def attrs_to_proto(attrs: dict[str, Any]) -> list[wire.Attr]:
    """Sorted-by-key Attr list (reference: attr.go:256-276)."""
    out = []
    for k in sorted(attrs):
        v = attrs[k]
        # bool must be tested before int (bool subclasses int in Python).
        if isinstance(v, bool):
            a = wire.Attr(Key=k, Type=ATTR_TYPE_BOOL, BoolValue=v)
        elif isinstance(v, str):
            a = wire.Attr(Key=k, Type=ATTR_TYPE_STRING, StringValue=v)
        elif isinstance(v, int):
            a = wire.Attr(Key=k, Type=ATTR_TYPE_INT, IntValue=v)
        elif isinstance(v, float):
            a = wire.Attr(Key=k, Type=ATTR_TYPE_FLOAT, FloatValue=v)
        else:
            raise TypeError(f"unrecognized attribute type: {type(v).__name__}")
        out.append(a)
    return out


def attrs_from_proto(pb_attrs) -> dict[str, Any]:
    """reference: attr.go:279-303"""
    out: dict[str, Any] = {}
    for a in pb_attrs:
        if a.Type == ATTR_TYPE_STRING:
            out[a.Key] = a.StringValue
        elif a.Type == ATTR_TYPE_INT:
            out[a.Key] = a.IntValue
        elif a.Type == ATTR_TYPE_BOOL:
            out[a.Key] = a.BoolValue
        elif a.Type == ATTR_TYPE_FLOAT:
            out[a.Key] = a.FloatValue
    return out


# ---------------------------------------------------------------------------
# RowBitmap
# ---------------------------------------------------------------------------


def bitmap_to_proto(b: RowBitmap) -> wire.Bitmap:
    """Flat absolute-column bit list (reference: bitmap.go:245-255)."""
    return wire.Bitmap(Bits=b.bits(), Attrs=attrs_to_proto(b.attrs) if b.attrs else [])


def bitmap_from_proto(pb: wire.Bitmap, device=None) -> RowBitmap:
    """reference: bitmap.go:258-268; segments land on ``device``."""
    b = RowBitmap.from_bits(pb.Bits, device=device)
    b.attrs = attrs_from_proto(pb.Attrs)
    return b


# ---------------------------------------------------------------------------
# QueryResult / QueryResponse
# ---------------------------------------------------------------------------


def result_to_proto(result: Any) -> wire.QueryResult:
    """Polymorphic result encode (reference: handler.go:1444-1470):
    RowBitmap -> Bitmap; ValCount -> one Pair; [Pair] -> Pairs; int ->
    N; bool -> Changed; None -> empty result."""
    pb = wire.QueryResult()
    if isinstance(result, RowBitmap):
        pb.Bitmap = bitmap_to_proto(result)
    elif isinstance(result, ValCount):
        # A BSI aggregate (Sum/Min/Max) rides the Pairs message: the value
        # u64-wrapped in Key (negatives sign-extend on decode, in the
        # executor's reduce), the count in Count (JAX codec.py:128-135).
        pb.Pairs = [wire.Pair(Key=_u64(result.value), Count=_u64(result.count))]
    elif isinstance(result, bool):
        pb.Changed = result
    elif isinstance(result, (int, np.integer)):
        pb.N = _u64(int(result))
    elif isinstance(result, list):
        pb.Pairs = [wire.Pair(Key=_u64(p.id), Count=_u64(p.count)) for p in result]
    elif result is not None:
        raise TypeError(f"unknown query result type: {type(result).__name__}")
    return pb


def result_from_proto(pb: wire.QueryResult, device=None) -> Any:
    """Inverse of result_to_proto (reference: client.go:283-301).  An
    absent field set means 0 / False / nil in the reference's sparse
    encoding; it decodes as 0 (counts dominate reads)."""
    if pb.Bitmap is not None:
        return bitmap_from_proto(pb.Bitmap, device)
    if pb.Pairs:
        return [Pair(id=p.Key, count=p.Count) for p in pb.Pairs]
    if pb.Changed:
        return True
    return int(pb.N)


def result_to_json(result: Any) -> Any:
    """reference: handler.go:216-280: RowBitmap -> {"attrs", "bits"};
    ValCount -> {"value", "count"}; [Pair] -> [{"id", "count"}]; int ->
    N; bool -> changed; None -> null."""
    if isinstance(result, RowBitmap):
        return result.to_json_dict()
    if isinstance(result, ValCount):
        return {"value": int(result.value), "count": int(result.count)}
    if isinstance(result, list):
        return [{"id": _u64(p.id), "count": _u64(p.count)} for p in result]
    if isinstance(result, (int, np.integer)) and not isinstance(result, bool):
        return int(result)
    return result


def response_to_proto(
    results: list[Any],
    column_attr_sets: list[tuple[int, dict[str, Any]]] | None = None,
    err: str = "",
) -> wire.QueryResponse:
    return wire.QueryResponse(
        Err=err,
        Results=[result_to_proto(r) for r in results or []],
        ColumnAttrSets=[
            wire.ColumnAttrSet(ID=_u64(id_), Attrs=attrs_to_proto(attrs))
            for id_, attrs in column_attr_sets or []
        ],
    )


def response_to_json(
    results: list[Any],
    column_attr_sets: list[tuple[int, dict[str, Any]]] | None = None,
) -> dict:
    """reference: handler.go:216-280 JSON shape."""
    out: dict[str, Any] = {"results": [result_to_json(r) for r in results or []]}
    if column_attr_sets is not None:
        out["columnAttrs"] = [
            {"id": _u64(id_), "attrs": attrs} for id_, attrs in column_attr_sets
        ]
    return out
