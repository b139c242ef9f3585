"""Phase 21 of ``chip_smoke.py`` alone on one card: standing queries on a
node holding phase 5's index (954 slices x 8 rows, loaded directly), then
the cold tier and gossip on nodes of their own (``CLUSTER_OPS_SLICES``,
32 slices).

    python3 tools/torch_cluster_ops_phase.py [--out FILE] [--skip a,b,c]

The card's name and power limit print first; the phase's JSON summary
prints last (and goes to ``--out``).  Needs a CUDA card (~3-4 min with
the kernels' build and the index's load).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--skip", default="", help="parts to leave out, e.g. 'a' or 'b,c'")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pilosa_tpu_torch import convert
    from pilosa_tpu_torch.net.client import InternalClient
    from pilosa_tpu_torch.net.server import Server
    from pilosa_tpu_torch.obs.stats import ExpvarStatsClient
    from pilosa_tpu_torch.ops import _build
    from pilosa_tpu_torch.ops import bitplane as bp
    from pilosa_tpu_torch.ops import delta_scatter as ds
    from pilosa_tpu_torch.ops import score_planes as sp
    from pilosa_tpu_torch.ops import tree_eval as te

    print(cs.card_line(), flush=True)
    bp.set_local_members([torch.device("cuda", 0)])
    _build.build_all()
    rng = np.random.default_rng(cs.SEED)
    planes = rng.integers(0, 2**32, size=(cs.N_SLICES, cs.ROWS, 32768), dtype=np.uint32)
    watch = cs.FallbackWatch()
    summary: dict = {"card": cs.card_line(), "seconds": {}}
    if "a" not in skip:
        with tempfile.TemporaryDirectory(prefix="pilosa-torch-standing-") as d:
            srv = Server(d, host="127.0.0.1:0", device="cuda", stats=ExpvarStatsClient())
            srv.open()
            try:
                cs.load_in_threads(convert, [(srv.holder, "i", "f", "standard", {s: planes[s]})
                                             for s in range(cs.N_SLICES)])
                watch.rebase(srv)
                t0 = time.perf_counter()
                summary["a"] = cs.standing_and_check(te, sp, ds, InternalClient, srv, planes,
                                                     np.random.default_rng(cs.SEED + 21))
                summary["seconds"]["21a"] = time.perf_counter() - t0
                watch.check("21a", srv)
            finally:
                srv.close()
    ops = planes[:cs.CLUSTER_OPS_SLICES].copy()
    del planes
    if "b" not in skip:
        t0 = time.perf_counter()
        summary["b"] = cs.tier_and_check(te, ds, convert, Server, InternalClient, ExpvarStatsClient,
                                         ops, np.random.default_rng(cs.SEED + 22))
        summary["seconds"]["21b"] = time.perf_counter() - t0
        watch.check("21b")
    if "c" not in skip:
        t0 = time.perf_counter()
        summary["c"] = cs.gossip_and_check(te, ds, convert, Server, InternalClient,
                                           ExpvarStatsClient, ops, watch)
        summary["seconds"]["21c"] = time.perf_counter() - t0
        watch.check("21c")
    text = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
