"""Phases 6 and 20 of ``chip_smoke.py`` alone on one card: phase 6's
three-node cluster (954 slices x 8 rows, 2 replicas), then replica
agreement on it (hints, restart and replay, anti-entropy, a live resize).

    python3 tools/torch_replicas_phase.py [--full-sweep] [--out FILE]

``--full-sweep`` makes phase 20 (c)'s anti-entropy tick the one that walks
every owned fragment's blocks (the server's every ``FULL_SYNC_EVERY``-th
tick) instead of the tick that skips slices whose replica versions agree.
The card's name and power limit print first; the phase's JSON summary
prints last (and goes to ``--out``).  Needs a CUDA card (~6 min).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-sweep", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.ingest import scatter
    from pilosa_tpu_torch.net.client import InternalClient
    from pilosa_tpu_torch.net.server import Server
    from pilosa_tpu_torch.ops import _build
    from pilosa_tpu_torch.ops import bitplane as bp
    from pilosa_tpu_torch.ops import bsi_ripple as br
    from pilosa_tpu_torch.ops import delta_scatter as ds
    from pilosa_tpu_torch.ops import fused_popcount as fp
    from pilosa_tpu_torch.ops import score_planes as sp
    from pilosa_tpu_torch.ops import tree_eval as te

    print(cs.card_line(), flush=True)
    bp.set_local_members([torch.device("cuda", 0)])
    _build.build_all()
    rng = np.random.default_rng(cs.SEED)
    planes = rng.integers(0, 2**32, size=(cs.N_SLICES, cs.ROWS, 32768), dtype=np.uint32)
    t0 = time.perf_counter()
    out = cs.cluster_and_check(fp, ds, br, sp, te, scatter, convert, Server, InternalClient,
                               planes, rng, full_sweep=args.full_sweep)
    summary = {"card": cs.card_line(), "full_sweep": args.full_sweep,
               "phase_6_and_20_s": time.perf_counter() - t0, "phase_20": out["replicas"]}
    text = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
