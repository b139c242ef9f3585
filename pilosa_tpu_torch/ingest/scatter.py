"""Device delta-scatter: incremental maintenance of the device mirrors.

The counterpart of ``pilosa_tpu.ingest.scatter``.  A fragment queues
the plane bits its writes change as int64 *codes*,
``(slot * 2^20 + offset) * 2 + op`` (op 1 sets the bit, 0 clears it;
:func:`codes`), in write order.  The write path does nothing else on
the device.  A read applies every queue it needs with
:func:`apply_many`: ONE vectorized fold of all queues, with the job
index in the key (:func:`fold_many`), and ONE launch of the
delta-scatter kernel K7 per device (``exec/plan.py:
scatter_apply_many`` -> ``ops/delta_scatter.py``); a read of one
fragment applies its queue as a batch of one.

The JAX package pads the entry count to a power-of-two bucket
(``_pad_to_bucket``) only to bound XLA's compile cache and folds each
fragment apart; a hand-written kernel takes any count and any number of
planes, so the port does neither.

A queue longer than :func:`pending_limit` of its mirror — or a
structural change, such as a plane grown past its padded rows — drops
the mirror for a full re-upload at the next read, and
:func:`note_fallback` counts each one.  The counters are plain module
integers, as in the JAX package.
"""

from __future__ import annotations

import threading

import numpy as np

# The queue limit weighs what the next read pays for a queue against a
# re-upload of the mirror, both in bytes of upload: one queued code costs
# ENTRY_COST_BYTES (the host's fold, check and copy of its record); a
# re-upload costs the mirror's rows x 128 KiB plus UPLOAD_FIXED_BYTES (the
# copy's fixed cost).  From the rates chip_smoke.py measures in phase 4
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md, section 6).
ENTRY_COST_BYTES = 800
UPLOAD_FIXED_BYTES = 360_000
# A fragment's queue never holds more codes than this (8 B each).
MAX_PENDING = 1 << 22
_ROW_NBYTES = 32768 * 4

# Point writes and small imports queue their bits for K7 (the JAX
# package's ``[ingest] scatter``); set by Server.open, process-wide.  Off,
# every write drops the resident mirror and the next read uploads the
# host plane again.
ENABLED = True

_mu = threading.Lock()
launches = 0
updates_applied = 0
fallback_invalidations = 0


def pending_limit(rows: int) -> int:
    """The most codes a queue against a mirror of ``rows`` rows holds
    before a re-upload costs less than applying it."""
    return min(MAX_PENDING, (rows * _ROW_NBYTES + UPLOAD_FIXED_BYTES) // ENTRY_COST_BYTES)


def codes(slots, offsets, op: int) -> np.ndarray:
    """Queue codes of the bits ``(slots[i], offsets[i])`` (in-row bit
    offsets), set when ``op`` is 1, cleared when 0."""
    pos = (np.asarray(slots, dtype=np.int64) << 20) | np.asarray(offsets, dtype=np.int64)
    return (pos << 1) | np.int64(op)


def fold_many(queues) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fold the code queues of a batch's jobs (queue ``k`` -> job ``k``)
    into unique per-word entries ``(job int32, word uint32, or uint32,
    andnot uint32)`` sorted by ``(job, word)``, where ``word`` is slot x
    32768 + word in the job's plane: per bit, the last code of its queue
    decides (a set lands in the or mask, a clear in the and-not mask).

    One in-place value sort of every queue's ``(job, bit, op)`` keys and
    one OR per word, with no index array: repeats of a bit with one op
    OR away, and only a bit both set and cleared in its queue (rare: a
    point write and its undo) looks up its last code in that queue.  The
    host's time here is what the queue limit weighs
    (``ENTRY_COST_BYTES``)."""
    n = sum(len(q) for q in queues)
    if not n:
        return (np.empty(0, np.int32), np.empty(0, np.uint32), np.empty(0, np.uint32),
                np.empty(0, np.uint32))
    # The job above the 37 bits of a code's (slot, offset) and its op.
    v = np.empty(n, dtype=np.int64)
    at = 0
    for job, q in enumerate(queues):
        np.bitwise_or(q, job << 38, out=v[at : at + len(q)])
        at += len(q)
    v.sort()
    k = v >> 1
    # A set's bit in the low half of a 64-bit mask, a clear's in the high
    # half: one OR per word folds both.
    shift = k & 31
    shift |= (~v & 1) << 5
    masks = np.left_shift(np.int64(1), shift)
    dup = np.flatnonzero(k[1:] == k[:-1])
    dup += 1  # a bit's code after its first
    # Clears sort first within a bit, so an op change inside a bit's run
    # marks a bit both set and cleared: its run keeps only the mask of
    # its last code in write order.
    mixed = np.unique(k[dup[(v[dup] & 1) != (v[dup - 1] & 1)]])
    for job in np.unique(mixed >> 37).tolist():
        mk = mixed[(mixed >> 37) == job]
        q = np.asarray(queues[job], dtype=np.int64)
        bits = (q >> 1) | (job << 37)
        at = np.minimum(np.searchsorted(mk, bits), len(mk) - 1)
        hit = np.flatnonzero(mk[at] == bits)
        last = np.zeros(len(mk), dtype=np.int64)
        np.maximum.at(last, at[hit], hit)
        lo, hi = np.searchsorted(k, mk), np.searchsorted(k, mk + 1)
        run = np.repeat(lo - np.cumsum(hi - lo) + (hi - lo), hi - lo) + np.arange(int((hi - lo).sum()))
        masks[run] = 0
        masks[lo] = np.left_shift(np.int64(1), (mk & 31) + np.where(q[last] & 1, 0, 32))
    k >>= 5
    wstart = np.flatnonzero(k[1:] != k[:-1])
    wstart += 1
    wstart = np.concatenate(([0], wstart))
    masks = np.bitwise_or.reduceat(masks, wstart)
    wkey = k[wstart]
    return ((wkey >> 32).astype(np.int32), wkey.astype(np.uint32),
            masks.astype(np.uint32), (masks >> 32).astype(np.uint32))


def fold(pending) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The JAX package's fold (``pilosa_tpu/ingest/scatter.py:59-84``)
    over a ``(slot, word, mask, op)`` queue (a list of tuples or an int64
    ``[n, 4]`` array, in write order): unique per-word ``(slots int32,
    words int32, or_masks uint32, andnot_masks uint32)`` in order of
    first appearance, the later op winning per bit — :func:`fold_many`
    over the queue's bits, put back in that order."""
    q = np.asarray(pending, dtype=np.int64).reshape(-1, 4)
    e, b = np.nonzero((q[:, 2:3] >> np.arange(32)) & 1)
    _, word, or_b, andnot_b = fold_many([codes(q[e, 0], q[e, 1] * 32 + b, 0) | (q[e, 3] != 0)])
    # Every queued word has an entry, a zero mask's too.
    uniq, first = np.unique(q[:, 0] * 32768 + q[:, 1], return_index=True)
    at = np.searchsorted(uniq, word)
    or_m = np.zeros(len(uniq), np.uint32)
    andnot_m = np.zeros(len(uniq), np.uint32)
    or_m[at], andnot_m[at] = or_b, andnot_b
    order = np.argsort(first, kind="stable")
    keys = uniq[order]
    return ((keys >> 15).astype(np.int32), (keys & 32767).astype(np.int32),
            or_m[order], andnot_m[order])


def apply_many(jobs) -> int:
    """Apply ``[(plane, queue), ...]`` — int32 mirrors and their code
    queues (an array or a list of arrays, in write order) — in place
    with ONE delta-scatter launch per device; returns the launches.
    Two jobs on one plane merge, in the order given.  The caller holds
    every job's fragment lock until this returns, so the launches are
    enqueued before any reader can find a queue empty."""
    global launches, updates_applied
    from pilosa_tpu_torch.exec import plan

    merged: dict[tuple, tuple] = {}
    for plane, queue in jobs:
        parts = queue if isinstance(queue, list) else [queue]
        key = (plane.device, plane.data_ptr(), tuple(plane.shape))
        merged.setdefault(key, (plane, []))[1].extend(parts)
    by_device: dict = {}
    for plane, parts in merged.values():
        q = np.concatenate(parts) if parts else np.empty(0, np.int64)
        if len(q):
            by_device.setdefault(plane.device, []).append((plane, q))
    for batch in by_device.values():
        plan.scatter_apply_many([p for p, _ in batch], *fold_many([q for _, q in batch]))
        with _mu:
            launches += 1
            updates_applied += sum(len(q) for _, q in batch)
    return len(by_device)


def note_fallback(n: int = 1) -> None:
    """Count a fallback to a full mirror re-upload."""
    global fallback_invalidations
    with _mu:
        fallback_invalidations += n


def counters() -> dict:
    with _mu:
        return {
            "launches": launches,
            "updatesApplied": updates_applied,
            "fallbackInvalidations": fallback_invalidations,
        }
