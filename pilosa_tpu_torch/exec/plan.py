"""Query planning: PQL call trees -> leaf stacks and one fused count.

A bitmap call tree decomposes into a hashable expression over its leaf
calls (``("leaf", i)`` or ``(op, child_exprs...)``), as in
``pilosa_tpu.exec.plan``.  Each row leaf (``Bitmap``, a time-quantum
``Range``) becomes a stack of slice-rows, int32 ``[n_slices, 32768]``;
the interior folds (``Intersect``/``Union``/``Difference``/``Xor``,
left-fold, reference: executor.go:418-434,486-505,621-637) run as plain
torch bitwise ops over the stacks, and for a count the LAST fold step —
the outer op, the popcount and the reduce — is one launch of the fused
popcount kernel (``ops/fused_popcount.py``), so the outermost result row
is never written to device memory.

The BSI nodes the executor's rewrite produces (``BsiCmp`` over
``BsiPlane``/``BsiZero``/``BsiPred`` leaves, and ``BsiSum``/``BsiMin``/
``BsiMax`` with an optional filter subtree) decompose as in the JAX
package.  Their plane leaves are not stacked: the executor hands every
plane leaf of a field the field's one :class:`~pilosa_tpu_torch.ops.
bsi_ripple.FieldPlanes` (its fragments' mirrors and the rows of exists,
sign and each magnitude bit in them), and the node runs on the ripple
kernel K8
(``ops/bsi_ripple.py``), which reads the planes in place — in count mode
when the comparison is the root of a Count, in row mode inside a fold,
and :func:`agg_vectors` for the aggregates.

``anchored_count`` counts a fold-only tree in the position domain: the
tree becomes a postfix program (``compile_program``) and every slice of
the node goes through one launch of the anchored count K5
(``ops/anchored_count.py``), each leaf read through its own container
format — the counterpart of ``compiled_anchored_count`` /
``anchored_count_exec`` (``pilosa_tpu/exec/plan.py:855-934``), which
compiled one program per format signature.

``scatter_apply_many`` applies folded write deltas to any number of
fragments' mirrors with one launch of the delta-scatter kernel
(``ops/delta_scatter.py``); ``scatter_apply`` is its one-mirror
interface.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.bsi import ripple
from pilosa_tpu_torch.ops import anchored_count as ac
from pilosa_tpu_torch.ops import bsi_ripple, delta_scatter, fused_popcount
from pilosa_tpu_torch.ops.bitplane import WORDS_PER_SLICE
from pilosa_tpu_torch.pql.parser import Call

# Calls that fetch rows (leaves of a bitmap expression).  The Bsi*
# leaves are synthetic calls of the executor's BSI rewrite: BsiPlane is
# one field-view plane row, BsiPred a predicate, BsiZero an all-zero pad
# plane (the depth bucket).
LEAF_CALLS = frozenset({"Bitmap", "Range", "BsiPlane", "BsiPred", "BsiZero"})
# Interior set-algebra calls and the fused kernel op of each.
FOLD_OPS = {"Intersect": "and", "Union": "or", "Difference": "andnot", "Xor": "xor"}
FOLD_CALLS = frozenset(FOLD_OPS)
# Synthetic BSI interior calls: BsiCmp produces a result row; the
# aggregates produce per-slice int32 partial vectors.
BSI_CALLS = frozenset({"BsiCmp", "BsiSum", "BsiMin", "BsiMax"})
# Leaves that carry slice-invariant data rather than fragment content:
# they never make a slice non-empty on their own.
NEUTRAL_LEAVES = frozenset({"BsiPred", "BsiZero"})


class PlanError(ValueError):
    pass


@dataclass
class PredLeaf:
    """A ``BsiPred`` leaf: the (clamped) predicate value."""

    value: int


def decompose(call: Call) -> tuple[tuple, list[Call]]:
    """Flatten a bitmap call tree into a hashable structure + leaf calls.

    Returns ``(expr, leaves)`` where ``expr`` is a nested tuple —
    ``("leaf", i)`` referencing ``leaves[i]``, or ``(op, child_exprs...)``;
    a BSI node is ``("bsiCmp", op, children...)`` or ``("bsiSum" |
    "bsiMin" | "bsiMax", has_filter, children...)``, as in the JAX package.
    """
    leaves: list[Call] = []

    def rec(c: Call) -> tuple:
        if c.name in LEAF_CALLS:
            idx = len(leaves)
            leaves.append(c)
            return ("leaf", idx)
        if c.name in BSI_CALLS:
            if c.name == "BsiCmp":
                head = ("bsiCmp", c.args["op"])
            else:
                tag = {"BsiSum": "bsiSum", "BsiMin": "bsiMin", "BsiMax": "bsiMax"}
                head = (tag[c.name], bool(c.args.get("filter")))
            return head + tuple(rec(ch) for ch in c.children)
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


def _rows_shape(inputs) -> tuple[int, torch.device]:
    """(slices, device) of a leaf-input list."""
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.shape[0], x.device
        if isinstance(x, bsi_ripple.FieldPlanes):
            return x.n, x.device
    raise PlanError("a tree without row or plane leaves has no rows")


def _field(kids: tuple, inputs) -> tuple[bsi_ripple.FieldPlanes, list[int]]:
    """A BSI node's plane/pad/predicate leaves as the kernel's input:
    (the field's FieldPlanes, which every plane leaf of the node holds;
    the predicate values).  The node must read each of the field's
    planes once and pad them to its bucket."""
    planes, preds, pads = [], [], 0
    for e in kids:
        if e[0] != "leaf":
            raise PlanError("a BSI node's planes must be leaves")
        x = inputs[e[1]]
        if isinstance(x, bsi_ripple.FieldPlanes):
            planes.append(x)
        elif isinstance(x, PredLeaf):
            preds.append(x.value)
        elif x is None:
            pads += 1
        else:
            raise PlanError("a BSI node takes plane, pad and predicate leaves")
    fp = planes[0] if planes else None
    if (fp is None or any(p is not fp for p in planes) or len(planes) != 2 + fp.depth
            or pads != fp.bucket - fp.depth):
        raise PlanError("a BSI node must read every plane of one field, padded to its bucket")
    return fp, preds


def _cmp(expr: tuple, inputs, count: bool) -> torch.Tensor:
    op = expr[1]
    fp, preds = _field(expr[2:], inputs)
    if len(preds) != (2 if op == "between" else 1):
        raise PlanError(f"bsiCmp {op} with {len(preds)} predicates")
    return bsi_ripple.bsi_cmp(fp, op, preds[0], preds[1] if op == "between" else None, count)


def eval_expr(expr: tuple, inputs: list) -> torch.Tensor:
    """The result rows of a decomposed tree (int32 [n, words]) over the
    leaf inputs: ``inputs[i]`` is an int32 [n, words] stack for a row
    leaf, a BSI plane leaf's FieldPlanes, a :class:`PredLeaf`, or None
    (a pad).
    Folds are torch bitwise ops; a comparison is one K8 launch (row
    mode)."""
    if expr[0] == "leaf":
        x = inputs[expr[1]]
        if not isinstance(x, torch.Tensor):
            raise PlanError("a BSI leaf outside a BSI node")
        return x
    name = expr[0]
    if name == "bsiCmp":
        return _cmp(expr, inputs, count=False)
    if name not in FOLD_CALLS:
        raise PlanError(f"{name} does not produce a row")
    children = [eval_expr(e, inputs) for e in expr[1:]]
    if not children:  # Union()
        n, device = _rows_shape(inputs)
        return torch.zeros(n, WORDS_PER_SLICE, dtype=torch.int32, device=device)
    acc = children[0]
    for nxt in children[1:]:
        acc = _fold(name, acc, nxt)
    return acc


def count_rows(expr: tuple, inputs: list) -> torch.Tensor:
    """int32[n] popcounts of the tree's result rows: the inner folds as
    torch ops, the outer op + popcount + reduce as ONE fused popcount
    launch; a comparison at the root is one K8 launch in count mode."""
    if expr[0] == "leaf":
        return fused_popcount.row_popcounts(eval_expr(expr, inputs))
    name = expr[0]
    if name == "bsiCmp":
        return _cmp(expr, inputs, count=True)
    kids = expr[1:]
    if not kids:  # Union(): nothing is set
        n, device = _rows_shape(inputs)
        return torch.zeros(n, dtype=torch.int32, device=device)
    if len(kids) == 1:
        return count_rows(kids[0], inputs)
    acc = eval_expr(kids[0], inputs)
    for e in kids[1:-1]:
        acc = _fold(name, acc, eval_expr(e, inputs))
    last = eval_expr(kids[-1], inputs)
    return fused_popcount.row_popcounts(
        acc.contiguous(), last.contiguous(), FOLD_OPS[name]
    )


def agg_vectors(expr: tuple, inputs: list) -> torch.Tensor:
    """The per-slice partial vectors of a ``bsiSum``/``bsiMin``/``bsiMax``
    node — int32 [n, 2 * bucket + 1] or [n, bucket + 2], in the JAX
    package's layout — from one K8 launch; a filter subtree folds first
    (its comparisons in K8's row mode)."""
    name, has_filter = expr[0], expr[1]
    if name not in ("bsiSum", "bsiMin", "bsiMax"):
        raise PlanError(f"{name} is not an aggregate")
    kids = expr[2:]
    filt = None
    if has_filter:
        filt = eval_expr(kids[-1], inputs).contiguous()
        kids = kids[:-1]
    fp, _ = _field(kids, inputs)
    if name == "bsiSum":
        return bsi_ripple.bsi_sum(fp, filt)
    return bsi_ripple.bsi_minmax(fp, "min" if name == "bsiMin" else "max", filt)


_PROGRAM_OPS = {"Intersect": ac.OP_AND, "Union": ac.OP_OR,
                "Difference": ac.OP_ANDNOT, "Xor": ac.OP_XOR}


def compile_program(expr: tuple) -> list[int]:
    """A fold-only tree as K5's postfix program: a leaf pushes its
    membership, an n-ary fold left-folds its children (the JAX
    package's ``_build_anchored`` order), an empty Union pushes 0."""
    if expr[0] == "leaf":
        return [expr[1]]
    if expr[0] not in _PROGRAM_OPS:
        raise PlanError(f"{expr[0]} is not a fold")
    kids = expr[1:]
    if not kids:
        return [ac.OP_ZERO]
    out = compile_program(kids[0])
    for e in kids[1:]:
        out += compile_program(e) + [_PROGRAM_OPS[expr[0]]]
    return out


def anchored_count(expr: tuple, positions: np.ndarray, offsets: np.ndarray, leaves,
                   device) -> torch.Tensor:
    """int32 [S] position-domain counts of a fold-only tree: slice s
    counts the anchor positions ``positions[offsets[s]:offsets[s + 1]]``
    where the tree holds over ``leaves[s]`` (each ``(fmt, device
    payload)`` or None for an absent row) — one K5 launch on CUDA, the
    plain version on the CPU."""
    return ac.anchored_count(compile_program(expr), positions, offsets, leaves, device)


def scatter_apply(plane: torch.Tensor, slots, words, or_m, andnot_m) -> torch.Tensor:
    """Apply unique (slot, word, or-mask, andnot-mask) entries to the
    int32 mirror ``plane`` IN PLACE and return it (the counterpart of
    ``pilosa_tpu/exec/plan.py:840``, which returned a new array): one
    K7 launch for a CUDA plane, the plain version for a CPU plane."""
    delta_scatter.delta_scatter(plane, slots, words, or_m, andnot_m)
    return plane


def scatter_apply_many(planes: list, job, word, or_m, andnot_m) -> None:
    """Apply a batch's folded entries (``ingest.scatter.fold_many``:
    ``(job, word, or, andnot)`` sorted by ``(job, word)``) to the int32
    mirrors ``planes`` IN PLACE: one K7 launch for CUDA planes however
    many there are (the JAX package ran one program per mirror), the
    plain version for CPU planes."""
    delta_scatter.delta_scatter_many(planes, job, word, or_m, andnot_m)


def _bsi_np(e: tuple, rows: list):
    """A BSI node over one slice's numpy rows, through the torch ripple
    (one implementation for the host and the plain device path)."""
    t = [torch.from_numpy(np.ascontiguousarray(r).view(np.int32)) for r in rows]
    name = e[0]
    if name == "bsiCmp":
        op = e[1]
        npred = 2 if op == "between" else 1
        exists, sign, planes, preds = t[0], t[1], t[2 : len(t) - npred], t[len(t) - npred :]
        if op == "between":
            out = ripple.between_row(exists, sign, planes, preds[0], preds[1])
        else:
            out = ripple.signed_cmp(op, exists, sign, planes, preds[0])
        return out.numpy().view(np.uint32)
    has_filter = e[1]
    body = t[:-1] if has_filter else t
    filt = t[-1] if has_filter else None
    if name == "bsiSum":
        return ripple.sum_vec(body[0], body[1], body[2:], filt).numpy()
    which = "min" if name == "bsiMin" else "max"
    return ripple.minmax_vec(which, body[0], body[1], body[2:], filt).numpy()


def eval_expr_np(expr: tuple, leaf_rows, words: int):
    """HOST (numpy) evaluation of a decomposed tree over one slice's
    leaf rows (``leaf_rows[i]`` is uint32[words] or None = empty); the
    result is None when the tree is empty on this slice.  A BSI node
    reads absent rows as zeros and returns its row or partial vector."""
    rows = [None if r is None else np.asarray(r, dtype=np.uint32) for r in leaf_rows]

    def zeros():
        return np.zeros(words, dtype=np.uint32)

    def rec(e):
        if e[0] == "leaf":
            return rows[e[1]]
        name = e[0]
        if name in ("bsiCmp", "bsiSum", "bsiMin", "bsiMax"):
            kids = [rec(c) for c in e[2:]]
            return _bsi_np(e, [zeros() if r is None else r for r in kids])
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
