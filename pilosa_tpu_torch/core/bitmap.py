"""RowBitmap — a query-result row spanning many slices.

The reference's ``pilosa.Bitmap`` walks two sorted lists of per-slice
roaring segments with a merge iterator (reference: bitmap.go:28-134,
282-437).  Here a row result is a dict of ``slice -> int32[32768]``
torch segments (bit-views of the uint32 words, on any device); counts
go through the fused popcount kernel and are memoized per segment like
the reference's cached ``n``.  ``bits()`` and the JSON form copy to the
host.

Host words (a decoded remote result, a numpy row) are uploaded to the
bitmap's device: the one its owner passes, else the CUDA default of
``device.resolve`` — never silently the CPU.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.ops import bitplane as bp


class RowBitmap:
    """Segmented row bitmap with per-segment cached counts and row
    attributes (reference: bitmap.go:24-43).  ``device`` is where host
    words are uploaded (resolved at first upload: CUDA unless asked)."""

    __slots__ = ("segments", "_counts", "attrs", "device")

    def __init__(self, device: torch.device | str | None = None):
        self.segments: dict[int, torch.Tensor] = {}
        self._counts: dict[int, int] = {}
        self.attrs: dict[str, Any] = {}
        self.device = device

    # --- construction ---

    @classmethod
    def from_segment(
        cls, slice_i: int, words, count: int | None = None, device=None
    ) -> "RowBitmap":
        b = cls(device)
        b.set_segment(slice_i, words, count)
        return b

    @classmethod
    def from_bits(cls, bits, device=None) -> "RowBitmap":
        """Build from absolute column IDs (reference: bitmap.go:258-268,
        decoding the protobuf flat bit list): one segment per slice that
        holds a bit."""
        b = cls(device)
        cols = np.asarray(bits, dtype=np.uint64)
        if len(cols):
            slices = cols // np.uint64(bp.SLICE_WIDTH)
            for s, (offs,) in bp.np_group_by(slices, cols % np.uint64(bp.SLICE_WIDTH)):
                b.set_segment(int(s), bp.np_columns_to_row(offs))
        return b

    def _as_segment(self, words) -> torch.Tensor:
        """A segment as an int32 bit-view tensor: tensors pass through,
        uint32 host words are copied to the bitmap's device."""
        if isinstance(words, torch.Tensor):
            return words
        self.device = device_mod.resolve(self.device)
        return bp.to_device(np.asarray(words, dtype=np.uint32), self.device)

    def set_segment(self, slice_i: int, words, count: int | None = None) -> None:
        self.segments[slice_i] = self._as_segment(words)
        if count is not None:
            self._counts[slice_i] = count
        else:
            self._counts.pop(slice_i, None)

    def merge(self, other: "RowBitmap") -> None:
        """In-place union used by the map/reduce combiner (reference:
        Bitmap.Merge, bitmap.go:137-156)."""
        for s, words in other.segments.items():
            if s in self.segments:
                self.segments[s] = self.segments[s] | words.to(self.segments[s].device)
                self._counts.pop(s, None)
            else:
                self.segments[s] = words
                if s in other._counts:
                    self._counts[s] = other._counts[s]

    # --- counts (reference: bitmap.go:159-217) ---

    def segment_count(self, slice_i: int) -> int:
        n = self._counts.get(slice_i)
        if n is None:
            n = bp.count(self.segments[slice_i])
            self._counts[slice_i] = n
        return n

    def count(self) -> int:
        return sum(self.segment_count(s) for s in self.segments)

    def intersection_count(self, other: "RowBitmap") -> int:
        """Count-only AND without materializing (reference:
        bitmap.go:74-83 -> roaring.IntersectionCount)."""
        total = 0
        for s in self.segments.keys() & other.segments.keys():
            total += bp.count_and(self.segments[s], other.segments[s])
        return total

    # --- materialization ---

    def host_segment(self, slice_i: int) -> np.ndarray:
        return bp.to_host(self.segments[slice_i])

    def bits(self) -> list[int]:
        """Sorted absolute column IDs (reference: Bitmap.Bits,
        bitmap.go:236-242)."""
        out: list[int] = []
        for s in sorted(self.segments):
            offs = bp.np_row_to_columns(self.host_segment(s))
            base = s * bp.SLICE_WIDTH
            out.extend(int(o) + base for o in offs)
        return out

    def to_json_dict(self) -> dict:
        """{"attrs": ..., "bits": ...} (reference: bitmap.go:220-233)."""
        return {"attrs": self.attrs or {}, "bits": self.bits()}

    def __repr__(self) -> str:
        return f"RowBitmap(n={self.count()}, slices={sorted(self.segments)})"
