#!/usr/bin/env python3
"""K5 (the anchored Count): an earlier kernel source against this checkout's, in turns on one CUDA card.

    git show HEAD:pilosa_tpu_torch/ops/csrc/anchored_count.cu > build/k5_ab/parent.cu
    python3 tools/torch_anchored_ab.py --parent-source build/k5_ab/parent.cu [--turns 2]

The parent source is the uploaded-anchor design (C entry point
``pilosa_anchored_count(meta, slices, leaves, n_prog, max_positions,
positions, out, stream)``: each slice's anchor positions copied from the
host as CSR beside the leaf table).  Without ``--parent-source`` the
script runs ``git show REV:...`` itself (``--rev``, default HEAD), which
needs a git checkout.  It builds that source with ``nvcc`` under
``build/k5_ab/``, and times it against this checkout's
``ops.anchored_count`` (the anchor read on the card as a leaf) at
``chip_smoke.k5_phase4_case``'s shape from a fixed seed: 954 slices, a
dense leaf whose 32,768 bits are the anchor, a 16,384-position and an
8,192-run leaf, ``Intersect`` of the three.  Each turn pair runs parent,
change, change, parent: the device time of one launch from a
``torch.profiler`` trace, and the time of a call back to back (CUDA
events), the parent's call doing the host work its wrapper did (the
table and the anchor's upload).  Both designs' counts must equal the
plain version's.  Prints one JSON line: the card's name and power limit,
the times, the bytes each design uploads a call.  Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "pilosa_tpu_torch/ops/csrc/anchored_count.cu"


def build_parent(source: str) -> ctypes.CDLL:
    sys.path.insert(0, ROOT)
    from pilosa_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "k5_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "anchored_count_parent.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, source], check=True)
    fn = ctypes.CDLL(lib).pilosa_anchored_count
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def parent_call(fn, program, positions: np.ndarray, offsets: np.ndarray, leaves):
    """The parent wrapper's work for one call: its checks and table (a
    pass each over the leaves), the table's and the anchor's upload from
    pageable memory, one launch."""
    import torch

    from pilosa_tpu_torch.ops.expand_payload import entries

    n, n_leaves = len(leaves), len(leaves[0])
    for row in leaves:
        for fmt, t in row:
            if entries(fmt, t) > 1 << 20 or t.device.type != "cuda":
                raise ValueError("bad leaf")
    if (np.diff(offsets) < 0).any() or int(positions.max()) >= 1 << 20:
        raise ValueError("bad anchor")
    meta = np.zeros(n + 1 + 3 * n * n_leaves + len(program), dtype=np.int64)
    meta[: n + 1] = offsets
    table = meta[n + 1 : n + 1 + 3 * n * n_leaves].reshape(n, n_leaves, 3)
    for s, row in enumerate(leaves):
        for i, (fmt, t) in enumerate(row):
            table[s, i] = (fmt, t.data_ptr(), entries(fmt, t))
    meta[n + 1 + 3 * n * n_leaves :] = program
    dev_meta = torch.from_numpy(meta).to("cuda")
    dev_pos = torch.from_numpy(positions.view(np.int32)).to("cuda")
    out = torch.zeros(n, dtype=torch.int32, device="cuda")
    widest = int(np.diff(offsets).max())
    rc = fn(dev_meta.data_ptr(), n, n_leaves, len(program), widest, dev_pos.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent anchored_count launch failed: cudaError {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-source")
    ap.add_argument("--rev", default="HEAD")
    ap.add_argument("--turns", type=int, default=1, help="pairs of parent, change, change, parent")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_anchored_ab: no CUDA card", file=sys.stderr)
        return 1
    source = args.parent_source
    if source is None:
        source = os.path.join(ROOT, "build", "k5_ab", "parent.cu")
        os.makedirs(os.path.dirname(source), exist_ok=True)
        with open(source, "wb") as fh:
            fh.write(subprocess.run(["git", "show", f"{args.rev}:{SOURCE}"], cwd=ROOT,
                                    check=True, capture_output=True).stdout)
    parent_fn = build_parent(source)
    sys.path.insert(0, ROOT)
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import anchored_count as ac
    from pilosa_tpu_torch.ops import bitplane as bp

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    case = cs.k5_phase4_case(bp, np.random.default_rng(cs.SEED + 4))
    leaves, anchor_leaf = case["leaves"], case["anchor_leaf"]
    program = plan.compile_program(case["expr"])
    positions = np.ascontiguousarray(case["anchors"].ravel())
    offsets = np.arange(cs.N_SLICES + 1, dtype=np.int64) * case["anchors"].shape[1]
    calls = {
        "parent": lambda: parent_call(parent_fn, program, positions, offsets, leaves),
        "change": lambda: ac.anchored_count(program, anchor_leaf, leaves, "cuda"),
    }
    want = ac.plain_anchored_count(program, anchor_leaf, leaves, "cuda")
    for label, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{label} != plain: {int((got - want).abs().max())}")
    runs = []
    for _ in range(args.turns):
        for label in ("parent", "change", "change", "parent"):
            fn = calls[label]
            runs.append({"label": label,
                         "device_ms": cs.device_ms(fn, "anchored_count_kernel", launches=20),
                         "ms": cs.time_cuda(fn, runs=11, per_run=5)})
    n, n_leaves = len(leaves), len(leaves[0])
    print(json.dumps({
        "card": cs.card_line(),
        "shape": [n, case["anchors"].shape[1], "dense", cs.K5_SPARSE, cs.K5_RUNS],
        "upload_bytes": {"parent": 8 * (n + 1 + 3 * n * n_leaves + len(program))
                         + positions.nbytes,
                         "change": 8 * (n + 3 * n * n_leaves + len(program))},
        "runs": runs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
