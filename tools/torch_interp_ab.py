#!/usr/bin/env python3
"""K3 (the multi-query interpreter) of one tree at phase 4's shapes, for A/B runs on one CUDA card.

    python3 tools/torch_interp_ab.py [--tree DIR] [--label NAME]

Imports ``pilosa_tpu_torch`` from ``DIR`` (default: this checkout), so
that one call on the card can time two versions of the kernel in turns
(A, B, B, A), and times ``interp.interp`` at the shapes of this
checkout's ``chip_smoke.k3_timed_shapes`` ((a) 16 storm programs, count
over 954 slices; (b) 4 programs, total; (c) 4 programs, row over 16
slices; (d) every BSI comparison at depth 31; (e) the full 256-op table
over 64 leaves), built from a fixed seed: the device time of one launch
from a ``torch.profiler`` trace, and the time of a call back to back (CUDA
events).  Prints one JSON line: the card's name and power limit, the
tree, the label and the times.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_interp_ab: no CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from pilosa_tpu_torch import bsi
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import tree_eval as te

    # This checkout's shapes, whichever tree the kernel comes from.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    mirrors = [torch.randint(-2**31, 2**31, (8, 32768), dtype=torch.int32, device="cuda")
               for _ in range(cs.N_SLICES)]
    idx = np.zeros((cs.N_SLICES, 8, 2), dtype=np.int64)
    idx[..., 0] = np.arange(cs.N_SLICES)[:, None]
    idx[..., 1] = np.arange(8)[None, :]
    table8 = te.RowTable(mirrors, idx)
    rng = np.random.default_rng(cs.SEED + 6)
    times = {}
    for name, reduce, table, prog, out_idx, _plain in cs.k3_timed_shapes(te, plan, bsi, table8,
                                                                        rng):
        fn = lambda: it.interp(reduce, table, prog, out_idx)  # noqa: E731
        times[name] = {"device_ms": cs.device_ms(fn, "interp_kernel", launches=20),
                       "ms": cs.time_cuda(fn, runs=11, per_run=5)}
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.card_line(), "tree": tree, "label": args.label,
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
