"""Crash recovery: replay the WAL tail newer than the data file.

The counterpart of ``pilosa_tpu/ingest/recovery.py``.  The data file's
op-log and the WAL record the SAME sequence of changed ops; the op-log
is the prefix that was flushed before the crash (the op-log is buffered
up to 64 KiB, the WAL is fsynced before every acknowledgement).  So
replay skips the first ``frag._op_n`` WAL ops (already applied from the
data file) and applies the rest through ``set_bit``/``clear_bit`` with
``frag._replaying`` set, which keeps them out of the op-log and the WAL
and defers the auto-snapshot: the caller takes one snapshot after the
replay.  Replay runs under the fragment lock (``Fragment.open`` holds
it).
"""

from __future__ import annotations

from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops import roaring

SLICE_WIDTH = bp.SLICE_WIDTH


def replay(frag, seg) -> dict:
    """Apply the ops of ``seg`` past the fragment's recovered op count;
    returns the report ``/debug/ingest`` shows as ``lastReplay``."""
    skip = frag._op_n
    applied = unchanged = seen = 0
    col_base = frag.slice * SLICE_WIDTH
    frag._replaying = True
    try:
        for _end_version, n_ops, payload in seg.frames:
            for off in range(0, n_ops * roaring.OP_SIZE, roaring.OP_SIZE):
                seen += 1
                if seen <= skip:
                    continue
                typ, pos, _ = roaring._read_op(payload, off)
                row, col = pos // SLICE_WIDTH, col_base + pos % SLICE_WIDTH
                write = frag.set_bit if typ == roaring.OP_ADD else frag.clear_bit
                if write(row, col):
                    applied += 1
                else:
                    unchanged += 1
    finally:
        frag._replaying = False
    if applied:
        from pilosa_tpu_torch.core import fragment as fragment_mod

        fragment_mod._count("walReplayedOps", applied)
    return {
        "fragment": f"{frag.index}/{frag.frame}/{frag.view}/{frag.slice}",
        "walOps": seg.n_ops,
        "skipped": min(skip, seen),
        "replayed": applied,
        "unchanged": unchanged,
        "torn": bool(seg.torn),
        "problem": seg.problem,
    }
