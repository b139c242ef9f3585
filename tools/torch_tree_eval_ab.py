#!/usr/bin/env python3
"""K2 (the fused tree eval): an earlier kernel and wrapper against this checkout's, in turns on one CUDA card.

    git show HEAD:pilosa_tpu_torch/ops/csrc/tree_eval.cu > build/k2_ab/parent.cu
    git show HEAD:pilosa_tpu_torch/ops/tree_eval.py > build/k2_ab/parent.py
    python3 tools/torch_tree_eval_ab.py --parent-source build/k2_ab/parent.cu \\
        --parent-wrapper build/k2_ab/parent.py [--turns 2] [--ptxas]

The parent is the first design (C entry point ``pilosa_tree_eval(table,
slices, leaves, program, prog_len, words, reduce, out, stream)``, the
output zeroed by its wrapper), called through its own wrapper module, so
a call back to back pays the parent's host work (its row-table pass, its
zeroing launch).  Without the two paths the script runs ``git show
REV:...`` itself (``--rev``, default HEAD), which needs a git checkout.
Beside the parent and this checkout's kernel ("change": one block per
tile) it times the persistent designs of ``tools/tree_eval_persistent.cu``
through this checkout's wrapper: "walk" (each lane loads its vectors, a
contiguous range of tiles a block), "walk_strided" (the same, tiles
``blockIdx.x + k * gridDim.x``) and "tma" (a producer warp bulk-copying
each leaf's tile into a shared-memory ring, contiguous ranges).  Each is
built with ``nvcc`` under ``build/k2_ab/``.

Shapes, from a fixed seed: 954 slices x 2 leaves (each slice's leaves
two rows of its own 8-row mirror, phase 5's layout) in count, total and
row, and the first 16 slices in row (the coalescer's Bitmap storm).
Every contender's result must equal the plain version's.  Each turn runs
parent, change, walk, walk_strided, tma, then the same in reverse: the
device time of one launch from a ``torch.profiler`` trace and the time of
a call back to back (CUDA events).  Once a turn, ``torch.bitwise_and(a,
b, out=c)`` on two [954, 32768] int32 tensors is timed the same two ways,
and the change's row mode over a table naming those same rows
("change_contiguous": the library call's inputs).  ``--ptxas`` prints
each source's registers and spills (``nvcc -Xptxas -v``).  Prints one
JSON line: the card's name and power limit, the bounds, every run.  Exits
non-zero without a card.
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
SOURCE = "pilosa_tpu_torch/ops/csrc/tree_eval.cu"
WRAPPER = "pilosa_tpu_torch/ops/tree_eval.py"
DESIGNS_SOURCE = os.path.join(ROOT, "tools", "tree_eval_persistent.cu")
DESIGNS = {"walk": ["-DK2_TMA=0", "-DK2_STRIDED=0"],
           "walk_strided": ["-DK2_TMA=0", "-DK2_STRIDED=1"],
           "tma": ["-DK2_TMA=1", "-DK2_STRIDED=0"]}
OUT_DIR = os.path.join(ROOT, "build", "k2_ab")
KERNELS = {"parent": "tree_eval_kernel", "change": "tree_eval_fast_kernel",
           **{d: "tree_eval_persistent_kernel" for d in DESIGNS}}


def git_show(rev: str, path: str, dest: str) -> str:
    with open(dest, "wb") as fh:
        fh.write(subprocess.run(["git", "show", f"{rev}:{path}"], cwd=ROOT, check=True,
                                capture_output=True).stdout)
    return dest


def build(source: str, name: str, ptxas: bool, defines=()) -> ctypes.CDLL:
    from pilosa_tpu_torch.ops import _build

    lib = os.path.join(OUT_DIR, f"{name}.so")
    flags = [*_build.NVCC_FLAGS, *defines, *(["-Xptxas", "-v"] if ptxas else [])]
    res = subprocess.run([_build.nvcc_path(), *flags, "-o", lib, source], check=True,
                         capture_output=True, text=True)
    if ptxas:
        for line in (res.stdout + res.stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    return ctypes.CDLL(lib)


def load_wrapper(path: str, name: str, fn, argtypes):
    """A second instance of a tree_eval wrapper module whose kernel is
    ``fn`` (the module's ``_kernel()`` returns it)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    mod._fn = fn
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-source")
    ap.add_argument("--parent-wrapper")
    ap.add_argument("--rev", default="HEAD")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of every contender in order, then in reverse")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tree_eval_ab: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    source = args.parent_source or git_show(args.rev, SOURCE, os.path.join(OUT_DIR, "parent.cu"))
    wrapper = args.parent_wrapper or git_show(args.rev, WRAPPER,
                                              os.path.join(OUT_DIR, "parent.py"))
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import tree_eval as te

    if args.ptxas:
        build(os.path.join(ROOT, SOURCE), "change", True)
    te._kernel()  # this checkout's library, built by the package
    vp, ci = ctypes.c_void_p, ctypes.c_int
    parent = load_wrapper(wrapper, "k2_parent_tree_eval",
                          build(source, "parent", args.ptxas).pilosa_tree_eval,
                          [vp, ci, ci, vp, ci, ci, ci, vp, vp])
    mods = {"parent": parent, "change": te}
    for name, defines in DESIGNS.items():
        lib = build(DESIGNS_SOURCE, name, args.ptxas, defines)
        mods[name] = load_wrapper(os.path.join(ROOT, WRAPPER), f"k2_{name}_tree_eval",
                                  lib.pilosa_tree_eval, [vp, ci, ci, vp, vp, ci, ci, ci, vp, vp])

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hbm = cs.hbm_rate(torch.cuda.get_device_name(0))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    n = cs.N_SLICES
    mirrors = [torch.randint(-2**31, 2**31, (8, 32768), dtype=torch.int32, device="cuda",
                             generator=gen) for _ in range(n)]
    idx = np.zeros((n, 2, 2), dtype=np.int64)
    idx[..., 0] = np.arange(n)[:, None]
    idx[..., 1] = np.arange(2)[None, :]
    # Each wrapper's own table class, vouched for as a cache hit's is.
    tables = {}
    for label, mod in mods.items():
        big = mod.RowTable(mirrors, idx, checked=True)
        big.addresses()
        small = mod.RowTable(mirrors[:16], idx[:16].copy(), checked=True)
        small.addresses()
        tables[label] = {n: big, 16: small}
    program = plan.compile_program(("Intersect", ("leaf", 0), ("leaf", 1)))
    shapes = [(n, "count"), (n, "total"), (n, "row"), (16, "row")]
    row_bytes = 32768 * 4

    def nbytes(s: int, reduce: str) -> int:
        out = {"count": 4 * s, "total": 8, "row": s * row_bytes}[reduce]
        return s * (2 * row_bytes + 2 * 8) + out

    def call(label: str, s: int, reduce: str):
        mod, table = mods[label], tables[label][s]
        return lambda: mod.tree_eval(table, program, reduce)

    for s, reduce in shapes:
        want = te.plain_tree_eval(tables["change"][s], program, reduce)
        for label in mods:
            got = call(label, s, reduce)()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{label} != plain at [{s}, 2] {reduce}")
    a = torch.randint(-2**31, 2**31, (n, 32768), dtype=torch.int32, device="cuda", generator=gen)
    b = torch.randint(-2**31, 2**31, (n, 32768), dtype=torch.int32, device="cuda", generator=gen)
    c = torch.empty_like(a)
    same = np.zeros((n, 2, 2), dtype=np.int64)
    same[:, 1, 0] = 1
    same[..., 1] = np.arange(n)[:, None]
    contiguous = te.RowTable([a, b], same)
    if not torch.equal(te.tree_eval(contiguous, program, "row"), torch.bitwise_and(a, b)):
        raise AssertionError("change != bitwise_and over the library call's inputs")
    order = list(mods)
    runs, library = [], []
    for _ in range(args.turns):
        for label in order + order[::-1]:
            for s, reduce in shapes:
                fn = call(label, s, reduce)
                runs.append({"label": label, "slices": s, "reduce": reduce,
                             "device_ms": cs.device_ms(fn, KERNELS[label], launches=20),
                             "ms": cs.time_cuda(fn, runs=11, per_run=5)})
        for label, fn, kernel in (
                ("bitwise_and", lambda: torch.bitwise_and(a, b, out=c), "elementwise"),
                ("change_contiguous", lambda: te.tree_eval(contiguous, program, "row"),
                 KERNELS["change"])):
            library.append({"label": label, "device_ms": cs.device_ms(fn, kernel, launches=20),
                            "ms": cs.time_cuda(fn, runs=11, per_run=5)})
    print(json.dumps({
        "card": cs.card_line(),
        "bound_ms": {f"{s}x2_{r}": nbytes(s, r) / hbm * 1e3 for s, r in shapes},
        "library_954_row": library,
        "runs": runs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
