"""Device delta-scatter: incremental maintenance of the device mirror.

The counterpart of ``pilosa_tpu.ingest.scatter``.  A fragment queues its
point-write and small-import deltas as ``(slot, word, mask, op)``
entries (op 1 sets the mask's bits, 0 clears them); :func:`apply` folds
the queue into unique ``(slot, word, or-mask, andnot-mask)`` entries and
applies them to the resident mirror with ONE launch of the delta-scatter
kernel K7 (``exec/plan.py:scatter_apply`` -> ``ops/delta_scatter.py``).

The JAX package pads the entry count to a power-of-two bucket
(``_pad_to_bucket``) only to bound XLA's compile cache; a hand-written
kernel takes any count, so the port leaves the padding out.

Structural changes — a plane that grew past its padded row count, an
import above :data:`IMPORT_SCATTER_MAX` bits, a queue past the
fragment's limit — still drop the mirror for a full re-upload, and
:func:`note_fallback` counts each one.  The counters are plain module
integers, as in the JAX package.
"""

from __future__ import annotations

import threading

import numpy as np

# import_bulk queues its bits as scatter entries only up to this many;
# past it, one upload of the plane beats thousands of folded entries.
IMPORT_SCATTER_MAX = 4096

_mu = threading.Lock()
launches = 0
updates_applied = 0
fallback_invalidations = 0


def fold(pending) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fold a ``(slot, word, mask, op)`` queue (a list of tuples or an
    int64 ``[n, 4]`` array, in write order) into unique per-word
    ``(slots int32, words int32, or_masks uint32, andnot_masks uint32)``
    in order of first appearance, the later op winning per bit: a set
    clears the bit from the andnot mask and a clear from the or mask
    (``pilosa_tpu/ingest/scatter.py:59-84``), vectorized per bit."""
    q = np.asarray(pending, dtype=np.int64).reshape(-1, 4)
    key = (q[:, 0] << 32) | q[:, 1]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    # Renumber the unique keys by first appearance.
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    cell = rank[inv]
    or_m = np.zeros(len(uniq), dtype=np.uint32)
    andnot_m = np.zeros(len(uniq), dtype=np.uint32)
    masks = q[:, 2]
    for b in range(32):
        idx = np.flatnonzero((masks >> b) & 1)
        if not len(idx):
            continue
        # The last entry per cell among those touching bit b decides it.
        rev = idx[::-1]
        _, last_pos = np.unique(cell[rev], return_index=True)
        last = rev[last_pos]
        bit = np.uint32(1 << b)
        sets = q[last, 3] != 0
        or_m[cell[last[sets]]] |= bit
        andnot_m[cell[last[~sets]]] |= bit
    slots = (uniq[order] >> 32).astype(np.int32)
    words = (uniq[order] & 0xFFFFFFFF).astype(np.int32)
    return slots, words, or_m, andnot_m


def apply(plane, pending) -> None:
    """Fold a non-empty queue and apply it to ``plane`` (an int32 mirror)
    in place with one delta-scatter launch.  The caller holds the
    fragment lock."""
    global launches, updates_applied
    from pilosa_tpu_torch.exec import plan

    slots, words, or_m, andnot_m = fold(pending)
    plan.scatter_apply(plane, slots, words, or_m, andnot_m)
    with _mu:
        launches += 1
        updates_applied += len(pending)


def note_fallback(n: int = 1) -> None:
    """Count a structural-change fallback to a full mirror re-upload."""
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

