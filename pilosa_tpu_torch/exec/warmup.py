"""Cold-start work at open: build every kernel and launch each once.

The counterpart of ``pilosa_tpu/exec/warmup.py``.  A JAX node compiled
one XLA program per (tree shape, slice bucket) and warmed the standard
shapes so that the first queries found them ready; it could also keep
the executables in a persistent compile cache.  The port's kernels are
compiled once per checkout (``ops/_build.py``: one ``nvcc`` per source,
all started together) and take their shapes at run time, so there is no
compile cache to port and no shape grid to warm: :func:`prewarm` builds
every kernel and makes one launch of each of the query path's kernels at
the standard shapes — K2's three reduces over the 2-leaf Intersect, K3's
three reduces over a small fused table, K1 over one row — so that a
fresh node's first query pays neither a build nor a first launch.  On
the CPU there is nothing to build, and the launches run the plain
versions.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.ops import _build, fused_popcount
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops.tree_eval import RowTable

# The headline tree (executor.go:418-505): Count(Intersect(a, b)).
_STANDARD_EXPR = ("Intersect", ("leaf", 0), ("leaf", 1))


def prewarm(device=None) -> int:
    """Build every kernel (on CUDA) and launch each query-path kernel once
    on zero rows of ``device``; returns the launches made."""
    device = device_mod.resolve(device)
    if device.type == "cuda":
        _build.build_all()
    rows = torch.zeros(2, bp.WORDS_PER_SLICE, dtype=torch.int32, device=device)
    table = RowTable([rows], np.asarray([[[0, 0], [0, 1]]], dtype=np.int64))
    em = plan.FuseEmitter(2)
    out_idx = np.asarray([plan.lower_expr(_STANDARD_EXPR, 0, em),
                          plan.lower_expr(("Union", ("leaf", 0), ("leaf", 1)), 0, em)],
                         dtype=np.int32)
    # The JAX package's smallest table bucket; the zero rows past the two
    # trees AND leaf 0 with itself.
    prog = np.zeros((plan.FUSE_OPS_FLOOR, 4), dtype=np.int32)
    prog[: len(em.rows)] = em.table()
    warmed = 0
    for reduce in ("count", "row", "total"):
        plan.tree_eval(_STANDARD_EXPR, reduce, table)
        plan.interp_exec(reduce, table, prog, out_idx)
        warmed += 2
    fused_popcount.row_popcounts(rows, rows, "and")
    warmed += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return warmed


def prewarm_async(device=None, logger=None) -> threading.Thread:
    """Run :func:`prewarm` on a daemon thread (open must not wait for the
    build); returns the thread for tests to join."""

    def run():
        try:
            n = prewarm(device)
            if logger is not None:
                logger(f"prewarm: {n} kernel launches warmed")
        except Exception as e:  # noqa: BLE001 — diagnostics only
            if logger is not None:
                logger(f"prewarm failed: {e}")

    t = threading.Thread(target=run, daemon=True, name="prewarm")
    t.start()
    return t
