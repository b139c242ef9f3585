"""Crash recovery: replay a JAX node's WAL tail newer than the snapshot.

The counterpart of ``pilosa_tpu/ingest/recovery.py``.  The data file's
op-log and the WAL record the SAME sequence of changed ops; the op-log
is the prefix that was flushed before the crash.  So replay skips the
first ``frag._op_n`` WAL ops (already applied from the data file) and
applies the rest through ``set_bit``/``clear_bit`` with
``frag._replaying`` set, which keeps them out of the op-log and defers
the auto-snapshot: the caller takes one snapshot after the replay.
Replay runs under the fragment lock (``Fragment.open`` holds it).
"""

from __future__ import annotations

from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops import roaring

SLICE_WIDTH = bp.SLICE_WIDTH


def replay(frag, seg) -> int:
    """Apply the ops of ``seg`` past the fragment's recovered op count;
    returns how many of them changed the fragment."""
    skip = frag._op_n
    applied = seen = 0
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
                applied += write(row, col)
    finally:
        frag._replaying = False
    return applied
