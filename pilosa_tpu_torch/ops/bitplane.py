"""Dense bit-plane representation and the device bitmap ops, on torch.

The unit of storage is a *slice-row*: one row of one fragment, covering
SLICE_WIDTH = 2^20 columns, stored as 32,768 uint32 words (128 KiB).  A
fragment is a plane of shape (rows, WORDS_PER_SLICE).  Bit ``i`` of a
slice-row (column ``slice*SLICE_WIDTH + i``) lives at word ``i >> 5``,
bit ``i & 31`` (little-endian within the word, matching the reference's
roaring bitmap-container layout).

The host helpers (``np_*``) are those of ``pilosa_tpu.ops.bitplane``,
verbatim.  The device ops work on **int32 bit-views** of the uint32
words: PyTorch's CPU build has no ``~`` or shifts for uint32 and no
popcount at all, so every count goes through the fused popcount kernel
(``ops/fused_popcount.py``: the CUDA kernel on the card, its plain
version on the CPU).  Counts come back as Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import fused_popcount

# Matches the reference: SliceWidth = 2^20 (reference: fragment.go:47).
SLICE_WIDTH = 1 << 20
WORD_BITS = 32
WORDS_PER_SLICE = SLICE_WIDTH // WORD_BITS  # 32768 words = 128 KiB
# A roaring container spans 2^16 bits (reference: roaring/roaring.go:36).
CONTAINER_BITS = 1 << 16
WORDS_PER_CONTAINER = CONTAINER_BITS // WORD_BITS  # 2048
CONTAINERS_PER_SLICE = SLICE_WIDTH // CONTAINER_BITS  # 16

# Rows are padded to power-of-two shape classes (floor ROW_BLOCK), as in
# the JAX package: a fragment's plane and its device mirror hold
# pad_rows(rows) rows, so a plane grows by doubling, not row by row.
ROW_BLOCK = 8


def empty_row() -> np.ndarray:
    return np.zeros(WORDS_PER_SLICE, dtype=np.uint32)


def empty_plane(rows: int) -> np.ndarray:
    return np.zeros((rows, WORDS_PER_SLICE), dtype=np.uint32)


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Round ``n`` up to the next power of two, at least ``floor``."""
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


def pad_rows(rows: int) -> int:
    """Round a row count up to its pow2 shape class (floor ROW_BLOCK)."""
    return pow2_bucket(rows, ROW_BLOCK)


# ---------------------------------------------------------------------------
# Host-side (numpy) bit manipulation — the write path.  Mutations happen on
# the host-resident authoritative plane; the fragment then updates its
# device mirror (see core/fragment.py).
# ---------------------------------------------------------------------------


def np_set_bit(plane: np.ndarray, bit: int) -> bool:
    """Set bit ``bit`` (a fragment position: row*SLICE_WIDTH + col%SLICE_WIDTH
    flattened into the plane).  Returns True if the bit changed."""
    row, offset = divmod(bit, SLICE_WIDTH)
    word, shift = divmod(offset, WORD_BITS)
    mask = np.uint32(1 << shift)
    old = plane[row, word]
    if old & mask:
        return False
    plane[row, word] = old | mask
    return True


def np_clear_bit(plane: np.ndarray, bit: int) -> bool:
    row, offset = divmod(bit, SLICE_WIDTH)
    word, shift = divmod(offset, WORD_BITS)
    mask = np.uint32(1 << shift)
    old = plane[row, word]
    if not (old & mask):
        return False
    plane[row, word] = old & ~mask
    return True


def np_contains(plane: np.ndarray, bit: int) -> bool:
    row, offset = divmod(bit, SLICE_WIDTH)
    word, shift = divmod(offset, WORD_BITS)
    return bool((int(plane[row, word]) >> shift) & 1)


def np_set_bulk(plane: np.ndarray, rows: np.ndarray, offsets: np.ndarray) -> None:
    """Bulk set: vectorized scatter-OR for imports (reference:
    fragment.go:936-1004 bulk Import path)."""
    words = offsets // WORD_BITS
    masks = (np.uint32(1) << (offsets % WORD_BITS).astype(np.uint32)).astype(np.uint32)
    np.bitwise_or.at(plane, (rows, words), masks)


def np_clear_bulk(plane: np.ndarray, rows: np.ndarray, offsets: np.ndarray) -> None:
    """Bulk clear: vectorized scatter-ANDNOT — the overwrite half of a
    columnar BSI value import (a re-imported column must drop the stale
    bits of its previous value)."""
    words = offsets // WORD_BITS
    masks = (np.uint32(1) << (offsets % WORD_BITS).astype(np.uint32)).astype(np.uint32)
    np.bitwise_and.at(plane, (rows, words), ~masks)


def np_row_to_columns(row_words: np.ndarray) -> np.ndarray:
    """Expand one slice-row's set bits into sorted uint64 column offsets
    within the slice (0 .. SLICE_WIDTH)."""
    bits = np.unpackbits(
        np.ascontiguousarray(row_words).view(np.uint8), bitorder="little"
    )
    (positions,) = np.nonzero(bits)
    return positions.astype(np.uint64)


def np_columns_to_row(offsets: np.ndarray) -> np.ndarray:
    """Inverse of np_row_to_columns: bit offsets (within slice) -> row words."""
    row = empty_row()
    if len(offsets) == 0:
        return row
    offsets = np.asarray(offsets, dtype=np.uint64)
    words = (offsets // WORD_BITS).astype(np.int64)
    masks = (np.uint32(1) << (offsets % WORD_BITS).astype(np.uint32)).astype(np.uint32)
    np.bitwise_or.at(row, words, masks)
    return row


if hasattr(np, "bitwise_count"):  # numpy >= 2.0

    def np_count(words: np.ndarray) -> int:
        """Host popcount (the CPU reference path, equivalent of the
        reference's pure-Go popcntSlice fallback, reference:
        roaring/assembly.go:21-28)."""
        return int(np.bitwise_count(words).sum())

    def np_row_counts(plane: np.ndarray) -> np.ndarray:
        """Host per-row popcounts (cache maintenance without a device trip)."""
        return np.bitwise_count(plane).sum(axis=-1, dtype=np.int64)

    def np_popcounts(words: np.ndarray) -> np.ndarray:
        """Host popcount of each uint32 word, int64."""
        return np.bitwise_count(words).astype(np.int64)

else:  # pragma: no cover - numpy 1.x fallback

    def np_count(words: np.ndarray) -> int:
        return int(np.unpackbits(np.ascontiguousarray(words).view(np.uint8)).sum())

    def np_row_counts(plane: np.ndarray) -> np.ndarray:
        return (
            np.unpackbits(np.ascontiguousarray(plane).view(np.uint8), axis=-1)
            .sum(axis=-1, dtype=np.int64)
        )

    def np_popcounts(words: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(np.ascontiguousarray(words, dtype=np.uint32).view(np.uint8))
        return bits.reshape(-1, 32).sum(axis=1, dtype=np.int64)


def np_group_by(keys: np.ndarray, *arrays: np.ndarray):
    """Yield ``(key, (aligned subarrays...))`` per unique key: ONE stable
    sort plus contiguous slicing — O(n log n) regardless of key
    cardinality.  Used by the bulk-import slice grouping."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    sorted_arrays = [a[order] for a in arrays]
    uniq, starts = np.unique(sk, return_index=True)
    bounds = np.append(starts, len(sk))
    for i, k in enumerate(uniq):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        yield int(k), tuple(a[lo:hi] for a in sorted_arrays)


# ---------------------------------------------------------------------------
# Host <-> device.  Device words are int32 bit-views of the uint32 words.
# ---------------------------------------------------------------------------


def to_device(words: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """uint32 host words -> a NEW int32 bit-view tensor on ``device``
    (never aliasing the host array, which stays authoritative)."""
    host = torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))
    return host.to(device=device, copy=True)


def to_host(words: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> uint32 numpy words (a host copy)."""
    return words.detach().to("cpu").contiguous().numpy().view(np.uint32).copy()


def _as_rows(words: torch.Tensor) -> torch.Tensor:
    """View any word tensor as [R, W] for the row kernel: whole
    slice-rows when the size tiles into them, else one row."""
    n = words.numel()
    if n and n % WORDS_PER_SLICE == 0:
        return words.reshape(-1, WORDS_PER_SLICE)
    return words.reshape(1, n)


# ---------------------------------------------------------------------------
# Counts — every one a launch of the fused popcount kernel (K1).
# ---------------------------------------------------------------------------


def count(words: torch.Tensor) -> int:
    """Popcount of a row/plane (reference: popcntSliceAsm)."""
    return fused_popcount.fused_count(_as_rows(words.contiguous()))


def _fused_count(a: torch.Tensor, b: torch.Tensor, op: str) -> int:
    return fused_popcount.fused_count(
        _as_rows(a.contiguous()), _as_rows(b.contiguous()), op
    )


def count_and(a: torch.Tensor, b: torch.Tensor) -> int:
    """|a AND b| without materializing (reference: intersectionCount*,
    roaring/roaring.go:1259-1347, popcntAndSliceAsm)."""
    return _fused_count(a, b, "and")


def count_or(a: torch.Tensor, b: torch.Tensor) -> int:
    return _fused_count(a, b, "or")


def count_xor(a: torch.Tensor, b: torch.Tensor) -> int:
    return _fused_count(a, b, "xor")


def count_andnot(a: torch.Tensor, b: torch.Tensor) -> int:
    """|a AND NOT b| (reference: popcntMaskSliceAsm / differenceCount)."""
    return _fused_count(a, b, "andnot")


def row_counts(plane: torch.Tensor) -> torch.Tensor:
    """Per-row popcounts of a [rows, words] plane -> int32[rows] (the
    ranked cache's recount; reference: fragment.go:244-282)."""
    return fused_popcount.row_popcounts(plane.contiguous())


# ---------------------------------------------------------------------------
# Materializing set algebra (reference: roaring/roaring.go:345-474) — one
# elementwise op on the int32 bit-views.
# ---------------------------------------------------------------------------


def and_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def or_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a ^ b


def andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & ~b


def _range_mask(n: int, start: int, end: int, device) -> torch.Tensor:
    """int32[n] bit-view word masks selecting bit positions in
    [start, end).  Built in int64, where every shift is exact and no
    sign bit is in the way, then folded to the int32 bit-view."""
    lo = torch.arange(n, dtype=torch.int64, device=device) * WORD_BITS
    s = (start - lo).clamp(0, WORD_BITS)
    e = (end - lo).clamp(0, WORD_BITS)
    width = (e - s).clamp(min=0)
    mask = ((torch.ones_like(width) << width) - 1) << s
    mask = mask & 0xFFFFFFFF
    return torch.where(mask >= 1 << 31, mask - (1 << 32), mask).to(torch.int32)


def flip_range(words: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Negate bits in [start, end) of a word array's last axis
    (reference: roaring.Bitmap.Flip, roaring/roaring.go:708-734)."""
    return words ^ _range_mask(words.shape[-1], start, end, words.device)


def count_range(words: torch.Tensor, start: int, end: int) -> int:
    """Count set bits with positions in [start, end) of the last axis
    (reference: roaring.Bitmap.CountRange, roaring/roaring.go:195-249)."""
    n = words.shape[-1]
    mask = _range_mask(n, start, end, words.device).reshape(1, n)
    return fused_popcount.fused_count(
        words.reshape(-1, n).contiguous(), mask, "and"
    )


# ---------------------------------------------------------------------------
# Compressed row containers (the sparse tier's device payloads), copied from
# ``pilosa_tpu/ops/bitplane.py:302-426``:
#
#   FMT_DENSE   uint32[WORDS_PER_SLICE] words           128 KiB always
#   FMT_SPARSE  sorted uint32 positions                 4 B / position
#   FMT_RLE     sorted (start, end) uint32 runs         8 B / run
#
# ``encode_row`` chooses the format by BUCKETED bytes, as the JAX package
# does, and returns the JAX package's sentinel-padded payload, so both pick
# the same format for every row.  The port's kernels search over the real
# length, so the fragment keeps only the real entries on the device
# (``payload_entries``): no sentinel (0xFFFFFFFF, which is -1 in an int32
# view and would sort first) ever reaches a kernel.
# ---------------------------------------------------------------------------

FMT_DENSE = 0
FMT_SPARSE = 1
FMT_RLE = 2
FMT_NAMES = {FMT_DENSE: "dense", FMT_SPARSE: "sparse", FMT_RLE: "rle"}

# Padding sentinel of the JAX package's payloads: > any slice position.
FMT_SENTINEL = 0xFFFFFFFF

# Floor of the payload pow2 bucket grid (64 positions = 256 B, 64 runs =
# 512 B), which the format choice compares.
PAYLOAD_BUCKET_FLOOR = 64

# ``Server(plane_format=...)``: "auto" selects per row by encoded bytes,
# "dense" disables compression.  Module-level, as in the JAX package, so
# fragments see it without per-fragment plumbing.
PLANE_FORMAT = "auto"

# Per-row encoded-size caps: a format is eligible only while its BUCKETED
# payload fits the cap (default half a dense row).
SPARSE_MAX_BYTES = 65536
RLE_MAX_BYTES = 65536


def configure_plane_format(
    mode: str | None = None,
    sparse_max_bytes: int | None = None,
    rle_max_bytes: int | None = None,
) -> None:
    """Apply the plane-format policy process-wide (``Server.open``).
    Selection is write-time only: already-encoded payloads keep their
    format until the row is written again."""
    global PLANE_FORMAT, SPARSE_MAX_BYTES, RLE_MAX_BYTES
    if mode is not None:
        if mode not in ("auto", "dense"):
            raise ValueError(f"unknown plane-format {mode!r}")
        PLANE_FORMAT = mode
    if sparse_max_bytes is not None:
        SPARSE_MAX_BYTES = max(0, int(sparse_max_bytes))
    if rle_max_bytes is not None:
        RLE_MAX_BYTES = max(0, int(rle_max_bytes))


def payload_bucket(n: int) -> int:
    """Pow2 payload-length bucket (entries, not bytes) with the shared
    floor."""
    return pow2_bucket(n, PAYLOAD_BUCKET_FLOOR)


def np_positions_to_runs(offsets: np.ndarray) -> np.ndarray:
    """Sorted positions -> (R, 2) uint32 half-open maximal runs."""
    o = np.asarray(offsets, dtype=np.uint32)
    if len(o) == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    brk = np.nonzero(np.diff(o) != 1)[0]
    starts = o[np.concatenate(([0], brk + 1))]
    ends = o[np.concatenate((brk, [len(o) - 1]))].astype(np.uint64) + 1
    return np.stack([starts, ends.astype(np.uint32)], axis=1)


def encode_row(offsets: np.ndarray) -> tuple[int, np.ndarray, int]:
    """Write-time format selection for one sparse-tier row: ``(fmt,
    payload, encoded_nbytes)``, the payload sentinel-padded to its
    bucket.  Minimum bucketed bytes wins, ties broken toward the lower
    format tag (dense < sparse < rle)."""
    offs = np.asarray(offsets, dtype=np.uint32)
    card = len(offs)
    dense_b = WORDS_PER_SLICE * 4
    cands = [(dense_b, FMT_DENSE)]
    if PLANE_FORMAT != "dense":
        sparse_b = 4 * payload_bucket(card)
        if sparse_b < dense_b and sparse_b <= SPARSE_MAX_BYTES:
            cands.append((sparse_b, FMT_SPARSE))
        runs = np_positions_to_runs(offs)
        rle_b = 8 * payload_bucket(len(runs))
        if rle_b < dense_b and rle_b <= RLE_MAX_BYTES:
            cands.append((rle_b, FMT_RLE))
    nbytes, fmt = min(cands)
    if fmt == FMT_SPARSE:
        payload = np.full(payload_bucket(card), FMT_SENTINEL, dtype=np.uint32)
        payload[:card] = offs
    elif fmt == FMT_RLE:
        runs = np_positions_to_runs(offs)
        payload = np.full((payload_bucket(len(runs)), 2), FMT_SENTINEL, dtype=np.uint32)
        payload[: len(runs)] = runs
    else:
        payload = np_columns_to_row(offs)
    return fmt, payload, nbytes


def decode_payload(fmt: int, payload: np.ndarray) -> np.ndarray:
    """Host inverse of encode_row: any container payload (padded or
    not) -> dense row words."""
    if fmt == FMT_DENSE:
        return np.asarray(payload, dtype=np.uint32)
    if fmt == FMT_SPARSE:
        p = np.asarray(payload, dtype=np.uint32)
        return np_columns_to_row(p[p != np.uint32(FMT_SENTINEL)])
    if fmt == FMT_RLE:
        p = np.asarray(payload, dtype=np.uint32).reshape(-1, 2)
        real = p[p[:, 0] != np.uint32(FMT_SENTINEL)]
        if len(real) == 0:
            return empty_row()
        pos = np.concatenate([np.arange(s, e, dtype=np.uint32) for s, e in real])
        return np_columns_to_row(pos)
    raise ValueError(f"unknown container format {fmt!r}")


def payload_entries(fmt: int, payload: np.ndarray) -> np.ndarray:
    """The real entries of an ``encode_row`` payload, sentinels dropped:
    uint32 [n] positions, [R, 2] runs, or the [32768] dense words."""
    p = np.asarray(payload, dtype=np.uint32)
    if fmt == FMT_SPARSE:
        return p[p != np.uint32(FMT_SENTINEL)]
    if fmt == FMT_RLE:
        p = p.reshape(-1, 2)
        return p[p[:, 0] != np.uint32(FMT_SENTINEL)]
    if fmt == FMT_DENSE:
        return p
    raise ValueError(f"unknown container format {fmt!r}")


# --- plain membership (K5's plain version, ``bitplane.py:429-453``) -------
# Each takes one row's payload as an int32 tensor of its REAL entries (the
# values are < 2^31, so the int32 view orders them as uint32 would) and
# int64 positions, and answers "is position p set?" per position.


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values of 32-bit words -> their int32 bit-view."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def membership_dense(row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(pos >> 5, max=WORDS_PER_SLICE - 1)
    return ((row[w].to(torch.int64) >> (pos & 31)) & 1).to(torch.bool)


def membership_sparse(payload: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if payload.numel() == 0:
        return torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    vals = payload.to(torch.int64)
    i = torch.clamp(torch.searchsorted(vals, pos), max=vals.numel() - 1)
    return vals[i] == pos


def membership_rle(payload: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if payload.numel() == 0:
        return torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    runs = payload.reshape(-1, 2).to(torch.int64)
    i = torch.searchsorted(runs[:, 0].contiguous(), pos, right=True) - 1
    return (i >= 0) & (pos < runs[torch.clamp(i, min=0), 1])


def membership(fmt: int, payload: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if fmt == FMT_DENSE:
        return membership_dense(payload, pos)
    if fmt == FMT_SPARSE:
        return membership_sparse(payload, pos)
    if fmt == FMT_RLE:
        return membership_rle(payload, pos)
    raise ValueError(f"unknown container format {fmt!r}")


# --- plain expansion (K6's plain version, ``bitplane.py:457-519``) --------


def expand_sparse(payload: torch.Tensor) -> torch.Tensor:
    """Positions -> int32 [32768] row: scatter-add of one-bit masks
    (positions are unique, so add is or)."""
    p = payload.to(torch.int64)
    row = torch.zeros(WORDS_PER_SLICE, dtype=torch.int64, device=payload.device)
    row.index_add_(0, p >> 5, torch.ones_like(p) << (p & 31))
    return _i32_bits(row)


def _lowmask(n: torch.Tensor) -> torch.Tensor:
    """int64 mask of the low ``n`` bits, n in [0, 32]."""
    return (torch.ones_like(n) << n) - 1


def expand_rle(payload: torch.Tensor) -> torch.Tensor:
    """Runs -> int32 [32768] row: boundary-word masks (runs are disjoint
    and maximal, so masks in a shared word have disjoint bits) plus an
    interior cover from a +1/-1 difference array over word index."""
    runs = payload.reshape(-1, 2).to(torch.int64)
    device = payload.device
    row = torch.zeros(WORDS_PER_SLICE, dtype=torch.int64, device=device)
    if runs.shape[0] == 0:
        return _i32_bits(row)
    s, e = runs[:, 0], runs[:, 1]
    w0, wl = s >> 5, (e - 1) >> 5
    b0, bl = s & 31, (e - 1) & 31
    same = w0 == wl
    m0 = _lowmask(torch.where(same, bl + 1, torch.full_like(bl, 32))) & ~_lowmask(b0)
    ml = torch.where(same, torch.zeros_like(bl), _lowmask(bl + 1))
    row.index_add_(0, w0, m0)
    row.index_add_(0, wl, ml)
    interior = (wl > w0 + 1).to(torch.int64)
    d = torch.zeros(WORDS_PER_SLICE + 1, dtype=torch.int64, device=device)
    d.index_add_(0, w0 + 1, interior)
    d.index_add_(0, wl, -interior)
    cover = torch.cumsum(d, 0)[:WORDS_PER_SLICE] > 0
    row = row | torch.where(cover, 0xFFFFFFFF, 0)
    return _i32_bits(row)


def expand_payload(fmt: int, payload: torch.Tensor) -> torch.Tensor:
    """Dense int32 [32768] row of a compressed payload (a new tensor; a
    FMT_DENSE payload is copied)."""
    if fmt == FMT_DENSE:
        return payload.clone()
    if fmt == FMT_SPARSE:
        return expand_sparse(payload)
    if fmt == FMT_RLE:
        return expand_rle(payload)
    raise ValueError(f"unknown container format {fmt!r}")


def top_k(counts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (count, index) by count descending, ties broken by the
    smaller index first — the reference's Pair order (reference:
    cache.go:316-330).  ``torch.topk`` promises no tie order, so this
    is a stable descending sort."""
    kk = min(k, counts.shape[0])
    vals, idx = torch.sort(counts, descending=True, stable=True)
    return vals[:kk], idx[:kk]

