"""Bit-sliced integer (BSI) fields — schema, layout, and wire shapes.

The port's own copy of ``pilosa_tpu.bsi`` (the port imports nothing of
the JAX package); ``tests/test_torch_bsi.py`` holds every helper equal
to the JAX one.

An integer per column is stored O'Neil/Quass-style as bit-planes inside
an ordinary frame view named ``field_<name>``, using the row layout the
rest of the storage stack already understands (fragments, device
mirrors, the roaring files — none of them special-case BSI):

* row 0 (``ROW_EXISTS``) — the not-null plane: bit set iff the column
  has a value;
* row 1 (``ROW_SIGN``)   — sign plane: bit set iff the value is
  negative (zero always stores sign 0);
* row ``2+k`` (``ROW_BIT_BASE + k``) — bit ``k`` of the magnitude
  ``abs(value)``.

A field's ``bit_depth`` is the number of magnitude planes needed for
``max(abs(min), abs(max))``.  The JAX package buckets the depth to
multiples of ``DEPTH_BLOCK`` (padded planes are identically zero) to
share compiled programs; the port keeps the bucket as the layout of the
aggregate partial vectors, so both packages produce the same vectors.

:func:`pred_row` packs a predicate's magnitude bits and sign flag into
one uint32 slice-row (word ``k`` holds bit ``k``, word ``bucket`` the
sign flag): the input of the plain ripple (``bsi/ripple.py``).  The
CUDA kernel (``ops/bsi_ripple.py``) takes the same predicate as two
scalar arguments instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pilosa_tpu_torch.ops import bitplane as bp

# Field view naming (matches later-Pilosa's field view convention).
VIEW_FIELD_PREFIX = "field_"

# Plane rows within a field view.
ROW_EXISTS = 0
ROW_SIGN = 1
ROW_BIT_BASE = 2

# Depth bucket: magnitude plane counts round up to a multiple of this
# (the layout of the Sum/Min/Max partial vectors).
DEPTH_BLOCK = 8
# Magnitudes must fit an int64 with headroom for host arithmetic.
MAX_DEPTH = 62

# PQL comparison operator -> canonical op tag.
OPS = {
    "<": "lt",
    "<=": "le",
    "==": "eq",
    "!=": "ne",
    ">=": "ge",
    ">": "gt",
    "><": "between",
}


class BSIError(ValueError):
    pass


@dataclass(frozen=True)
class BSIField:
    """One integer field of a range-enabled frame."""

    name: str
    min: int
    max: int

    @property
    def bit_depth(self) -> int:
        return bit_depth_for(self.min, self.max)

    @property
    def view(self) -> str:
        return field_view_name(self.name)

    def to_dict(self) -> dict:
        return {"name": self.name, "type": "int", "min": self.min, "max": self.max}


@dataclass(frozen=True)
class ValCount:
    """Aggregate result: Sum returns (sum, n-columns); Min/Max return
    (extreme value, n-columns holding it).  JSON renders as
    ``{"value":..., "count":...}``; the internal protobuf leg rides the
    existing Pairs message (net/codec.py)."""

    value: int
    count: int


def field_view_name(field: str) -> str:
    return VIEW_FIELD_PREFIX + field


def is_field_view(view: str) -> bool:
    return view.startswith(VIEW_FIELD_PREFIX)


def bit_depth_for(lo: int, hi: int) -> int:
    """Magnitude planes needed to represent every value in [lo, hi]
    sign-magnitude (at least one, so a {0}-only field still has a
    stable layout)."""
    mag = max(abs(int(lo)), abs(int(hi)))
    return max(1, int(mag).bit_length())


def validate_field(name: str, lo: int, hi: int) -> None:
    from pilosa_tpu_torch.core.names import validate_label

    validate_label(name)
    if lo > hi:
        raise BSIError(f"field min ({lo}) must be <= max ({hi})")
    if bit_depth_for(lo, hi) > MAX_DEPTH:
        raise BSIError(f"field range needs more than {MAX_DEPTH} bit planes")


def pad_depth(depth: int) -> int:
    """Round a magnitude depth up to its bucket."""
    if depth <= 0:
        return DEPTH_BLOCK
    return ((depth + DEPTH_BLOCK - 1) // DEPTH_BLOCK) * DEPTH_BLOCK


def pred_row(value: int, bucket: int) -> np.ndarray:
    """Pack one signed predicate into a uint32 slice-row: word ``k``
    (k < bucket) holds bit ``k`` of ``abs(value)``, word ``bucket``
    holds the sign flag.  Shaped like a bitmap leaf row: the predicate
    input of the plain ripple."""
    row = bp.empty_row()
    mag = abs(int(value))
    for k in range(bucket):
        row[k] = (mag >> k) & 1
    row[bucket] = 1 if value < 0 else 0
    return row


def clamp_predicate(op: str, value: int, depth: int) -> tuple[str, int]:
    """Rewrite an out-of-range predicate to an equivalent in-range one.

    Magnitude planes carry ``depth`` bits, so the representable window
    is [-(2^depth - 1), 2^depth - 1]; a predicate outside it truncates
    in the bit packing and would compare WRONG.  Every comparison
    against an out-of-window constant has an exact in-window equivalent
    (all-match ones get the loosest in-window bound, never-match ones a
    strictly-impossible bound), so the ripple stays oblivious.
    """
    hi = (1 << depth) - 1
    lo = -hi
    value = int(value)
    if lo <= value <= hi:
        return op, value
    if value > hi:
        return {
            "lt": ("le", hi),
            "le": ("le", hi),
            "eq": ("gt", hi),   # empty
            "ne": ("le", hi),   # everything with a value
            "gt": ("gt", hi),   # empty
            "ge": ("gt", hi),   # empty
        }[op]
    return {
        "gt": ("ge", lo),
        "ge": ("ge", lo),
        "eq": ("lt", lo),   # empty
        "ne": ("ge", lo),   # everything with a value
        "lt": ("lt", lo),   # empty
        "le": ("lt", lo),   # empty
    }[op]


def clamp_between(a: int, b: int, depth: int) -> tuple[int, int]:
    """Clamp a between-range to the representable window; an empty
    window stays empty (a > b yields no matches in the ripple)."""
    hi = (1 << depth) - 1
    lo = -hi
    a, b = int(a), int(b)
    if a > b:
        return hi, lo  # canonical empty range
    if b < lo or a > hi:
        return hi, lo
    return max(a, lo), min(b, hi)


def value_bit_rows(
    field: BSIField, column_ids: np.ndarray, values: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized sign-magnitude encoding of a columnar import:
    returns ``(set_rows, set_cols, clear_rows, clear_cols)`` — the
    plane bits to set and the plane bits to clear (stale bits from a
    previous value of the column).  Every plane row of every imported
    column appears in exactly one of the two lists, so re-importing a
    column fully overwrites its old value."""
    cols = np.asarray(column_ids, dtype=np.int64)
    vals = np.asarray(values, dtype=np.int64)
    if len(cols) != len(vals):
        raise BSIError("mismatch of column/value len")
    if len(vals) and (
        int(vals.min()) < field.min or int(vals.max()) > field.max
    ):
        raise BSIError(
            f"value out of range for field {field.name!r}"
            f" [{field.min}, {field.max}]"
        )
    depth = field.bit_depth
    mag = np.abs(vals)
    neg = vals < 0

    set_rows: list[np.ndarray] = [np.zeros(len(cols), np.int64)]  # exists
    set_cols: list[np.ndarray] = [cols]
    clear_rows: list[np.ndarray] = []
    clear_cols: list[np.ndarray] = []

    def route(row_id: int, mask: np.ndarray) -> None:
        on = cols[mask]
        off = cols[~mask]
        if len(on):
            set_rows.append(np.full(len(on), row_id, np.int64))
            set_cols.append(on)
        if len(off):
            clear_rows.append(np.full(len(off), row_id, np.int64))
            clear_cols.append(off)

    route(ROW_SIGN, neg)
    for k in range(depth):
        route(ROW_BIT_BASE + k, ((mag >> k) & 1).astype(bool))

    return (
        np.concatenate(set_rows),
        np.concatenate(set_cols),
        np.concatenate(clear_rows) if clear_rows else np.zeros(0, np.int64),
        np.concatenate(clear_cols) if clear_cols else np.zeros(0, np.int64),
    )
