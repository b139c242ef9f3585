#!/usr/bin/env python3
"""K3 (the multi-query interpreter) in every block shape, on one CUDA card.

    python3 tools/torch_interp_shapes.py [--cases a,b,...,h] [--out FILE]

Builds the kernel, then for each shape of ``chip_smoke.k3_timed_shapes``
((a) 16 storm programs, count over 954 slices; (b) 4 programs, total;
(c) 4 programs, row over 16 slices; (d) the BSI depth-31 table; (e) the
full 256-op table over 64 leaves; (h) shape (a) with every slice reading
one mirror, so that its 1 MB stays in L2: the kernel apart from device
memory):

1. checks that the kernel's shared-memory figure
   (``pilosa_interp_smem``) equals ``interp.smem_bytes`` for every block
   shape;
2. checks the kernel in the planner's block shape against the plain
   version over the first 3 slices, and every other block shape that fits
   against the planner's at full size (``torch.equal``);
3. times every block shape that fits, in both kernel variants (the op
   by a switch and branch-free), with CUDA events around back-to-back
   launches of the bare kernel: the host's table work is done once;
4. sums each shape up: the planner's block in both variants and the
   fastest block of each variant.

Prints the card's name and power limit, one JSON line per (shape, block),
the planner's choice and the summary; writes every line to ``--out`` too.
Exits non-zero without a card or on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# Every block shape (consumer warps, words a lane) in both variants.
SWEEP = [(w, v, o) for o in (0, 1) for w in (8, 4, 2, 1) for v in (8, 4, 2, 1)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="a,b,c,d,e,h")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "interp_shapes.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_interp_shapes: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pilosa_tpu_torch import bsi
    from pilosa_tpu_torch.exec import plan
    from pilosa_tpu_torch.ops import interp as it
    from pilosa_tpu_torch.ops import tree_eval as te

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    open(args.out, "w").close()

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")

    name = torch.cuda.get_device_name(0)
    emit({"card": cs.card_line(), "torch": torch.__version__, "cuda": torch.version.cuda})
    hbm = cs.hbm_rate(name)
    it.interp("count", cs.k3_stacks(te, 2, 1, 0), np.zeros((1, 4), np.int32),
              np.asarray([2], np.int32))  # builds the kernel
    fn, _ = it._lib()

    mirrors = [torch.randint(-2**31, 2**31, (8, 32768), dtype=torch.int32, device="cuda")
               for _ in range(cs.N_SLICES)]
    idx = np.zeros((cs.N_SLICES, 8, 2), dtype=np.int64)
    idx[..., 0] = np.arange(cs.N_SLICES)[:, None]
    idx[..., 1] = np.arange(8)[None, :]
    table8 = te.RowTable(mirrors, idx)
    rng = np.random.default_rng(cs.SEED + 6)
    wanted = set(args.cases.split(","))
    bad = 0
    shapes = cs.k3_timed_shapes(te, plan, bsi, table8, rng)
    # (h) shape (a) with every slice reading the first slice's mirror: the
    # same work from L2, the kernel's rate apart from device memory.
    hot = te.RowTable(mirrors[:1], np.stack([np.zeros_like(idx[..., 0]), idx[..., 1]], -1))
    shapes.append(("h_storm16_count_l2", "count", hot, *shapes[0][3:5], hot))
    for case, reduce, table, prog, out_idx, _plain in shapes:
        if case[0] not in wanted:
            continue
        n, n_leaves, words = table.shape
        alloc = it.check_program(prog, out_idx, n_leaves)
        k = len(set(out_idx.tolist()))
        sizes = (n_leaves, len(alloc.ins), alloc.n_phys, len(alloc.masks), len(alloc.lout), k)
        best = it.launch_plan(alloc, n_leaves, k, reduce)
        nbytes = cs.k3_needed_bytes(it, prog, out_idx, table, reduce)
        bound_ms = nbytes / hbm * 1e3
        addrs = table.addresses()
        meta = torch.from_numpy(np.concatenate(
            [alloc.ins.reshape(-1), alloc.masks.reshape(-1), alloc.lout.reshape(-1)])).cuda()
        small = te.RowTable(table.bases, table.index[:3].copy())
        want3 = it.plain_interp(reduce, small, prog, out_idx)
        got3 = it.interp(reduce, small, prog, out_idx)
        ok3 = torch.equal(got3, want3)
        bad += not ok3

        def run(shape):
            if reduce == "row":
                out = torch.empty(n, k, words, dtype=torch.int32, device="cuda")
            elif reduce == "count":
                out = torch.zeros(n, k, dtype=torch.int32, device="cuda")
            else:
                out = torch.zeros(k, dtype=torch.int64, device="cuda")
            rc = fn(addrs.data_ptr(), n, n_leaves, meta.data_ptr(), *sizes[1:], words,
                    te.REDUCES[reduce], shape[0], shape[1], shape[2], out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"cudaError {rc}")
            return out

        ref = run(best[:3])
        torch.cuda.synchronize()
        emit({"case": case, "reduce": reduce, "slices": n, "leaves": n_leaves, "ops": len(prog),
              "kept_ops": len(alloc.ins), "n_phys": alloc.n_phys, "masks": len(alloc.masks),
              "outputs": k, "bytes": nbytes, "bound_ms": bound_ms,
              "planner": list(best), "equal_plain_3_slices": ok3})
        times = {}
        for warps, vec, variant in SWEEP:
            smem = it.smem_bytes(*sizes, reduce, warps, vec)
            ksmem = it.kernel_smem_bytes(*sizes, reduce, warps, vec)
            if ksmem != smem:
                bad += 1
                emit({"case": case, "block": [warps, vec, variant],
                      "smem_mismatch": [smem, ksmem]})
            if smem > it.SMEM_BYTES:
                continue
            got = run((warps, vec, variant))
            same = bool(torch.equal(got, ref))
            bad += not same
            del got
            ms = cs.time_cuda(lambda: run((warps, vec, variant)), runs=5, per_run=5, warmup=2)
            times[(warps, vec, variant)] = ms
            emit({"case": case, "block": [warps, vec, variant], "smem": smem,
                  "equal": same, "ms": ms, "share": bound_ms / ms})
        fastest = {v: min((b for b in times if b[2] == v), key=times.get) for v in (0, 1)}
        emit({"case": case, "summary": True, "planner": list(best[:3]),
              "planner_ms": times[best[:3]],
              "planner_other_variant_ms": times.get((best.warps, best.vec, 1 - best.variant)),
              "fastest_switch": [*fastest[0], times[fastest[0]]],
              "fastest_branch_free": [*fastest[1], times[fastest[1]]]})
        del ref, meta
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
