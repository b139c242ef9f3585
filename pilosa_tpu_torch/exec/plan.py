"""Query planning: PQL call trees -> leaf stacks and one fused count.

A bitmap call tree decomposes into a hashable expression over its leaf
calls (``("leaf", i)`` or ``(op, child_exprs...)``), as in
``pilosa_tpu.exec.plan``.  Each leaf becomes a stack of slice-rows,
int32 ``[n_slices, 32768]``; the interior folds
(``Intersect``/``Union``/``Difference``/``Xor``, left-fold, reference:
executor.go:418-434,486-505,621-637) run as plain torch bitwise ops over
the stacks, and for a count the LAST fold step — the outer op, the
popcount and the reduce — is one launch of the fused popcount kernel
(``ops/fused_popcount.py``), so the outermost result row is never
written to device memory.

``scatter_apply`` applies folded write deltas to a fragment's mirror
with one launch of the delta-scatter kernel (``ops/delta_scatter.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import delta_scatter, fused_popcount
from pilosa_tpu_torch.pql.parser import Call

# Calls that fetch rows (leaves of a bitmap expression).
LEAF_CALLS = frozenset({"Bitmap"})
# Interior set-algebra calls and the fused kernel op of each.
FOLD_OPS = {"Intersect": "and", "Union": "or", "Difference": "andnot", "Xor": "xor"}
FOLD_CALLS = frozenset(FOLD_OPS)
# Leaf calls of the JAX package that this port does not execute yet.
UNPORTED_CALLS = frozenset({"Range"})


class PlanError(ValueError):
    pass


def decompose(call: Call) -> tuple[tuple, list[Call]]:
    """Flatten a bitmap call tree into a hashable structure + leaf calls.

    Returns ``(expr, leaves)`` where ``expr`` is a nested tuple —
    ``("leaf", i)`` referencing ``leaves[i]``, or ``(op, child_exprs...)``.
    """
    leaves: list[Call] = []

    def rec(c: Call) -> tuple:
        if c.name in LEAF_CALLS:
            idx = len(leaves)
            leaves.append(c)
            return ("leaf", idx)
        if c.name in UNPORTED_CALLS:
            raise PlanError(f"{c.name}() is not supported by this port yet")
        if c.name not in FOLD_CALLS:
            raise PlanError(f"unknown call: {c.name}")
        if c.name in ("Intersect", "Difference") and not c.children:
            raise PlanError(f"empty {c.name} query is currently not supported")
        return (c.name,) + tuple(rec(ch) for ch in c.children)

    return rec(call), leaves


def canonicalize_call(c: Call) -> Call:
    """Reorder the children of commutative fold calls (Intersect/Union/
    Xor) into a canonical order, bottom up, so semantically identical
    trees produce one canonical string.  Returns the ORIGINAL object
    when nothing changed.  Difference is not commutative and is left
    alone."""
    kids = [canonicalize_call(ch) for ch in c.children]
    if c.name in ("Intersect", "Union", "Xor") and len(kids) > 1:
        kids = sorted(kids, key=str)
    if len(kids) == len(c.children) and all(a is b for a, b in zip(kids, c.children)):
        return c
    return Call(name=c.name, args=dict(c.args), children=kids)


def _fold(name: str, acc, nxt):
    if name == "Intersect":
        return acc & nxt
    if name == "Union":
        return acc | nxt
    if name == "Difference":
        return acc & ~nxt
    return acc ^ nxt


def eval_expr(expr: tuple, leaves: list[torch.Tensor]) -> torch.Tensor:
    """The result rows of a decomposed tree over leaf stacks
    (``leaves[i]`` is int32 [n, words]): torch bitwise ops throughout."""
    if expr[0] == "leaf":
        return leaves[expr[1]]
    name = expr[0]
    children = [eval_expr(e, leaves) for e in expr[1:]]
    if not children:  # Union()
        return torch.zeros_like(leaves[0])
    acc = children[0]
    for nxt in children[1:]:
        acc = _fold(name, acc, nxt)
    return acc


def count_rows(expr: tuple, leaves: list[torch.Tensor]) -> torch.Tensor:
    """int32[n] popcounts of the tree's result rows: the inner folds as
    torch ops, the outer op + popcount + reduce as ONE fused popcount
    launch."""
    if expr[0] == "leaf":
        return fused_popcount.row_popcounts(leaves[expr[1]])
    name = expr[0]
    kids = expr[1:]
    if not kids:  # Union(): nothing is set
        return torch.zeros(leaves[0].shape[0], dtype=torch.int32, device=leaves[0].device)
    if len(kids) == 1:
        return count_rows(kids[0], leaves)
    acc = eval_expr(kids[0], leaves)
    for e in kids[1:-1]:
        acc = _fold(name, acc, eval_expr(e, leaves))
    last = eval_expr(kids[-1], leaves)
    return fused_popcount.row_popcounts(
        acc.contiguous(), last.contiguous(), FOLD_OPS[name]
    )


def scatter_apply(plane: torch.Tensor, slots, words, or_m, andnot_m) -> torch.Tensor:
    """Apply unique (slot, word, or-mask, andnot-mask) entries to the
    int32 mirror ``plane`` IN PLACE and return it (the counterpart of
    ``pilosa_tpu/exec/plan.py:840``, which returned a new array): one
    K7 launch for a CUDA plane, the plain version for a CPU plane."""
    delta_scatter.delta_scatter(plane, slots, words, or_m, andnot_m)
    return plane


def eval_expr_np(expr: tuple, leaf_rows, words: int):
    """HOST (numpy) evaluation of a decomposed tree over one slice's
    leaf rows (``leaf_rows[i]`` is uint32[words] or None = empty); the
    result is None when the tree is empty on this slice."""
    rows = [None if r is None else np.asarray(r, dtype=np.uint32) for r in leaf_rows]

    def zeros():
        return np.zeros(words, dtype=np.uint32)

    def rec(e):
        if e[0] == "leaf":
            return rows[e[1]]
        name = e[0]
        children = [rec(c) for c in e[1:]]
        if name == "Union":
            live = [c for c in children if c is not None]
            if not live:
                return None
            acc = live[0]
            for nxt in live[1:]:
                acc = acc | nxt
            return acc
        acc = children[0]
        for nxt in children[1:]:
            if name == "Intersect":
                if acc is None or nxt is None:
                    return None
                acc = acc & nxt
            elif name == "Difference":
                if acc is None:
                    return None
                if nxt is not None:
                    acc = acc & ~nxt
            elif name == "Xor":
                if acc is None:
                    acc = zeros()
                acc = acc ^ (nxt if nxt is not None else zeros())
        return acc

    return rec(expr)
