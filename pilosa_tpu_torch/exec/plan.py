"""Query planning: PQL call trees -> fused launches over leaf rows.

A bitmap call tree decomposes into a hashable expression over its leaf
calls (``("leaf", i)`` or ``(op, child_exprs...)``), as in
``pilosa_tpu.exec.plan``.  The interior folds (``Intersect``/``Union``/
``Difference``/``Xor``, left-fold, reference:
executor.go:418-434,486-505,621-637) of a tree over row leaves
(``Bitmap``, a time-quantum ``Range``) run in ONE launch of the fused
tree eval K2 (``ops/tree_eval.py``, :func:`tree_eval`): the tree becomes a
postfix program and the kernel reads every leaf row in place through a
row-address table (the executor's cached batch), with a ``count``,
``row`` or ``total`` reduce; no inner result row is written to memory.  A
tree deeper than K2's operand stack runs as one program of the
interpreter K3.

The interpreter (``ops/interp.py``, :func:`interp_exec`) is the
coalescer's launch for a mix of distinct trees: ``FuseEmitter`` and
:func:`lower_expr` (``pilosa_tpu/exec/plan.py:438-568``) lower any number
of trees into one ``int32[n_ops, 4]`` opcode table over a union leaf set
— value numbering shares identical instructions, so subtrees shared by
queries evaluate once — and one launch reduces every selected register.
The tables are byte-equal to the JAX emitter's.

The ripple route of a tree with a BSI node, and a TopN's src tree, are
eager: each row leaf is a stack of slice-rows, int32 ``[n_slices,
32768]``, the folds run as torch bitwise ops (:func:`eval_expr`), and for
a count the last fold step is one launch of the fused popcount K1
(:func:`count_rows`).

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

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch.bsi import ripple
from pilosa_tpu_torch.ops import anchored_count as ac
from pilosa_tpu_torch.ops import bsi_ripple, delta_scatter, fused_popcount
from pilosa_tpu_torch.ops import interp as interp_mod
from pilosa_tpu_torch.ops import tree_eval as tree_eval_mod
from pilosa_tpu_torch.ops.bitplane import WORDS_PER_SLICE
from pilosa_tpu_torch.ops.tree_eval import RowTable
from pilosa_tpu_torch.pql.parser import Call

# Calls that fetch rows (leaves of a bitmap expression).  The Bsi*
# leaves are synthetic calls of the executor's BSI rewrite: BsiPlane is
# one field-view plane row, BsiPred a predicate, BsiZero an all-zero pad
# plane (the depth bucket).
LEAF_CALLS = frozenset({"Bitmap", "Range", "BsiPlane", "BsiPred", "BsiZero"})
# Interior set-algebra calls and the fused kernel op of each.
FOLD_OPS = {"Intersect": "and", "Union": "or", "Difference": "andnot", "Xor": "xor"}
FOLD_CALLS = frozenset(FOLD_OPS)
# The cost class of a query (JAX exec/plan.py:116-144): the label of its
# latency histogram series on /metrics.
COST_POINT = "point"
COST_HEAVY = "heavy"
COST_WRITE = "write"
COST_INTERNAL = "internal"  # a remote leg of another node's query
_HEAVY_CALLS = frozenset({"TopN", "Sum", "Min", "Max", "Range"})
_WRITE_CALLS = frozenset({"SetBit", "ClearBit", "SetRowAttrs", "SetColumnAttrs"})


def cost_class(calls: "list[Call]") -> str:
    """``write`` when any call mutates, else ``heavy`` when any call (at
    any depth) is a TopN, an aggregate or a Range, else ``point``."""

    def heavy(c: Call) -> bool:
        return c.name in _HEAVY_CALLS or any(heavy(ch) for ch in c.children)

    if any(c.name in _WRITE_CALLS for c in calls):
        return COST_WRITE
    if any(heavy(c) for c in calls):
        return COST_HEAVY
    return COST_POINT


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



def collect_leaf_calls(call: Call) -> list[Call]:
    """Every Bitmap/Range (and BSI plane) leaf under ``call``, crossing
    calls that are not bitmap operations (a Count's child, a TopN's src
    tree) — JAX ``exec/plan.py:91``.  Unlike :func:`decompose` it never
    raises on an unknown call: it only names the leaves (the standing
    queries' write index), so it recurses into anything else."""
    out: list[Call] = []

    def rec(c: Call) -> None:
        if c.name in LEAF_CALLS:
            out.append(c)
            return
        for ch in c.children:
            rec(ch)

    rec(call)
    return out

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


@functools.lru_cache(maxsize=1024)
def _tree_program(expr: tuple) -> tuple:
    """:func:`compile_program` of a served tree, kept: a repeated query
    compiles once."""
    return tuple(compile_program(expr))


def anchored_count(expr: tuple, anchor_leaf, leaves, device) -> torch.Tensor:
    """int32 [S] position-domain counts of a fold-only tree: slice s
    counts the positions of its leaf ``anchor_leaf[s]`` (-1: none) where
    the tree holds over ``leaves[s]`` (each ``(fmt, device payload)`` or
    None for an absent row) — one K5 launch on CUDA, the plain version on
    the CPU."""
    return ac.anchored_count(compile_program(expr), anchor_leaf, leaves, device)


def expr_has_bsi(expr: tuple) -> bool:
    """Whether a decomposed tree holds a BSI node (JAX
    ``exec/plan.py:397``)."""
    if expr[0] == "leaf":
        return False
    if expr[0] in ("bsiCmp", "bsiSum", "bsiMin", "bsiMax"):
        return True
    return any(expr_has_bsi(e) for e in expr[1:])


def recombine_count_limbs(limbs):
    """(hi, lo) int32 limbs -> exact totals (JAX ``exec/plan.py:383``):
    a limb pair (shape [2]) -> Python int, vector limbs ([2, n]) -> int64
    ndarray.  The port's kernels sum in 64 bits and return no limbs; this
    reads the JAX package's."""
    limbs = np.asarray(limbs, dtype=np.int64)
    hi, lo = limbs[0], limbs[1]
    total = (hi << 16) + lo
    return int(total) if total.ndim == 0 else total


# Partial budget of the on-device cross-slice reduce (JAX
# ``exec/plan.py:336``): the JAX package's (hi, lo) limbs are exact up to
# 2^15 slice-row partials, and past it its callers take the per-slice
# host sum.  The port's kernels sum in 64 bits, so either route is exact;
# the port keeps the budget where the JAX package changes route, so that
# both routes stay reachable and are tested.
MAX_ONDEVICE_COUNT_PARTIALS = 1 << 15


def collective_launch():
    """The process-wide cross-member launch lock (JAX ``exec/plan.py:361``):
    hold it across the launches AND the fetch of any cross-member sum
    (``total_count``, the coalescer's sharded "total" drains,
    ``parallel/mesh``'s distributed reduces), so that two threads never interleave launches of one
    collective across members.  ``DeviceHealth.run_collective`` takes the
    same lock on its watchdog's runner thread."""
    from pilosa_tpu_torch.device import health

    return health._COLLECTIVE_MU


def run_collective(fn, health=None):
    """Run one cross-member launch+fetch serialized with every other
    collective in the process: given a ``DeviceHealth``, under its
    watchdog and ``collective`` breaker path (``LaunchWatchdogTimeout`` /
    ``CollectiveUnavailable`` propagate to the caller, who falls back to
    the per-member partials); else under the collective lock alone."""
    if health is not None:
        return health.run_collective(fn)
    with collective_launch():
        return fn()


# Answers the per-member partials gave because the collective path tripped
# or was quarantined, process-wide (``parallel/mesh``'s reduces and the
# executor's mesh Count): a run checks that none happened outside a phase
# that injects one.
collective_fallbacks = 0
_fallback_mu = threading.Lock()


def note_collective_fallback() -> None:
    global collective_fallbacks
    with _fallback_mu:
        collective_fallbacks += 1


def total_count(tables, launch) -> int:
    """Count(tree) over a sharded batch — ``launch(table)``, one "total"
    launch (int64 ``[1]``) on each member's table, all enqueued before any
    is fetched, then the cross-member sum in int64 (JAX
    ``compiled_total_count`` with a mesh, ``exec/plan.py:339``).  The
    caller holds the collective lock (:func:`run_collective`)."""
    outs = [launch(t) for t in tables]
    return int(sum(int(o.cpu()[0]) for o in outs))


def tree_eval(expr: tuple, reduce: str, table: RowTable) -> torch.Tensor:
    """A fold-only tree over the rows of ``table`` (int64 ``[S, L]`` row
    addresses; leaf ``i`` of the tree is column ``i``) with ``reduce``
    ``"count"`` (int32 ``[S]``), ``"row"`` (int32 ``[S, 32768]``) or
    ``"total"`` (int64 ``[1]``): one launch of K2 — the counterpart of
    ``compiled_batched`` / ``compiled_total_count``
    (``pilosa_tpu/exec/plan.py:314,339``) — or, for a tree deeper than
    K2's stack, one K3 launch of the tree lowered alone."""
    program = _tree_program(expr)
    if tree_eval_mod.program_depth(program, table.shape[1]) <= tree_eval_mod.MAX_DEPTH:
        return tree_eval_mod.tree_eval(table, program, reduce)
    em = FuseEmitter(table.shape[1])
    try:
        reg = lower_expr(expr, 0, em)
    except FuseUnsupported as e:
        raise PlanError(f"tree too large for one launch: {e}") from None
    out = interp_exec(reduce, table, em.table(), np.asarray([reg], dtype=np.int32))
    return out if reduce == "total" else out[:, 0]


def interp_exec(reduce: str, table: RowTable, prog: np.ndarray, out_idx: np.ndarray):
    """One fused interpreter launch (JAX ``exec/plan.py:667``): the
    registers ``out_idx`` of the opcode table ``prog`` over ``table``'s
    union leaves, reduced by ``reduce`` — int32 ``[S, k]`` counts, int32
    ``[S, k, 32768]`` rows, or int64 ``[k]`` totals (K3)."""
    return interp_mod.interp(reduce, table, prog, out_idx)


# ---------------------------------------------------------------------------
# expression-as-data interpreter (plane-major multi-query fusion)
# ---------------------------------------------------------------------------
#
# Register file per slice: slots [0, n_leaves) are the leaf rows, slot
# n_leaves + i is instruction i's output.  Instruction row: (opcode, a, b,
# aux).  The opcodes are K3's (ops/interp.py).

OP_AND = interp_mod.OP_AND
OP_OR = interp_mod.OP_OR
OP_ANDNOT = interp_mod.OP_ANDNOT
OP_XOR = interp_mod.OP_XOR
# Broadcast of predicate word ``aux`` of register ``a``: all-ones iff bit 0
# of that word is set — the BSI ripple's per-plane predicate mask
# (ripple.lower_magnitude_cmp), reading the packed predicate leaf.
OP_MASKW = interp_mod.OP_MASKW

# Opcode-table budget for one fused launch: a lowered tree past it falls
# back to its own launch.  The JAX package pads tables to pow2 buckets of
# at least FUSE_OPS_FLOOR rows for XLA's compile cache; K3 takes any
# length, and the warm-up launch uses the floor's size.
FUSE_MAX_OPS = 256
FUSE_OPS_FLOOR = 8


class FuseUnsupported(PlanError):
    """The expression cannot lower to the interpreter's opcode table (BSI
    aggregates reduce inside the expression; oversized trees blow the op
    budget): callers fall back to the per-compile-key path."""


class FuseEmitter:
    """Value-numbering opcode emitter (JAX ``exec/plan.py:461``):
    identical instructions (with commutative operand order normalized)
    share one register, so shared subtrees within a fused batch evaluate
    once.  ``rollback`` restores a checkpoint when a tree fails to lower
    mid-way, keeping the shared table clean for the batch's other
    queries."""

    def __init__(self, n_leaves: int, max_ops: int = FUSE_MAX_OPS):
        self.n_leaves = int(n_leaves)
        self.max_ops = int(max_ops)
        self.rows: list[tuple[int, int, int, int]] = []
        self._memo: dict[tuple, int] = {}
        self.dedup_hits = 0

    def _emit(self, op: int, a: int, b: int, aux: int = 0) -> int:
        if op in (OP_AND, OP_OR, OP_XOR) and b < a:
            a, b = b, a
        key = (op, a, b, aux)
        reg = self._memo.get(key)
        if reg is not None:
            self.dedup_hits += 1
            return reg
        if len(self.rows) >= self.max_ops:
            raise FuseUnsupported(f"opcode table full ({self.max_ops} instructions)")
        reg = self.n_leaves + len(self.rows)
        self.rows.append((int(op), int(a), int(b), int(aux)))
        self._memo[key] = reg
        return reg

    def and_(self, a: int, b: int) -> int:
        return self._emit(OP_AND, a, b)

    def or_(self, a: int, b: int) -> int:
        return self._emit(OP_OR, a, b)

    def andnot(self, a: int, b: int) -> int:
        return self._emit(OP_ANDNOT, a, b)

    def xor(self, a: int, b: int) -> int:
        return self._emit(OP_XOR, a, b)

    def maskw(self, a: int, word: int) -> int:
        return self._emit(OP_MASKW, a, a, word)

    def checkpoint(self) -> tuple:
        return len(self.rows), dict(self._memo), self.dedup_hits

    def rollback(self, cp: tuple) -> None:
        n, memo, hits = cp
        del self.rows[n:]
        self._memo = memo
        self.dedup_hits = hits

    def table(self) -> np.ndarray:
        """The emitted instructions as K3's int32 ``[n_ops, 4]`` table."""
        return np.asarray(self.rows, dtype=np.int32).reshape(-1, 4)


_FOLD_EMIT = {"Intersect": "and_", "Union": "or_", "Difference": "andnot", "Xor": "xor"}


def _leaf_reg(leaf_map, i: int) -> int:
    return leaf_map + i if isinstance(leaf_map, int) else leaf_map[i]


def lower_expr(expr: tuple, leaf_map, em: FuseEmitter) -> int:
    """Lower one decomposed tree into ``em``'s opcode table (JAX
    ``exec/plan.py:529``); returns the result row's register.
    ``leaf_map`` places the tree's leaves in the combined register file:
    an int means leaves sit contiguously at ``base + i``; a sequence maps
    leaf ``i`` to its register (the fused union-leaf layout, where a leaf
    shared between queries is one register, so value numbering dedups
    whole subtrees across queries).  The emitted stream mirrors the
    fold, and the BSI ripple (``bsi/ripple.py`` ``lower_*``), operation
    for operation.  Raises :class:`FuseUnsupported` for BSI aggregates
    and when the op budget runs out."""
    if expr[0] == "leaf":
        return _leaf_reg(leaf_map, expr[1])
    name = expr[0]
    if name == "bsiCmp":
        op = expr[1]
        regs = [lower_expr(e, leaf_map, em) for e in expr[2:]]
        npred = 2 if op == "between" else 1
        body, preds = regs[: len(regs) - npred], regs[len(regs) - npred :]
        exists, sign, planes = body[0], body[1], body[2:]
        if op == "between":
            return ripple.lower_between(em, exists, sign, planes, preds[0], preds[1])
        return ripple.lower_signed_cmp(em, op, exists, sign, planes, preds[0])
    if name in ("bsiSum", "bsiMin", "bsiMax"):
        raise FuseUnsupported(f"{name} reduces inside the expression")
    children = [lower_expr(e, leaf_map, em) for e in expr[1:]]
    if not children:
        # Empty Union: the canonical all-zero row (x ^ x).
        zero = _leaf_reg(leaf_map, 0)
        return em.xor(zero, zero)
    emit = getattr(em, _FOLD_EMIT[name])
    acc = children[0]
    for nxt in children[1:]:
        acc = emit(acc, nxt)
    return acc


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
