"""Executor — PQL calls over one node's local slices.

Behavior parity with ``pilosa_tpu.exec.executor`` (reference:
executor.go) for the calls this port executes: ``Bitmap``, ``Union``,
``Intersect``, ``Difference``, ``Xor``, ``Count``, ``SetBit``,
``ClearBit`` and ``TopN`` (with or without a src bitmap, ``ids``,
``threshold``, ``tanimotoThreshold``, attribute filters), with the same
slice lists, the same two-phase TopN and the same error messages.

Execution on the device: a bitmap tree's leaves are stacked per leaf
from the fragments' device mirrors (int32 ``[n_slices, 32768]``, only
slices where some leaf row exists), the tree folds with torch bitwise
ops, and a count's last fold step is one fused popcount launch
(exec/plan.py).  TopN scores each fragment's candidates with one fused
popcount launch against the src row (core/fragment.py).

Cluster fan-out, replication, BSI/Range, time-quantum and inverse views,
attribute writes and the coalescer of the JAX executor are not ported
yet.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.fragment import TopOptions
from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD
from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.pql.parser import Call, Query

# reference: executor.go:33-40
DEFAULT_FRAME = "general"
MIN_THRESHOLD = 1
# reference: config.go (max-writes-per-request default)
DEFAULT_MAX_WRITES_PER_REQUEST = 5000

WRITE_CALLS = frozenset({"SetBit", "ClearBit", "SetRowAttrs", "SetColumnAttrs"})


class ExecutorError(RuntimeError):
    pass


class IndexNotFoundError(ExecutorError):
    def __init__(self):
        super().__init__("index not found")


class FrameNotFoundError(ExecutorError):
    def __init__(self):
        super().__init__("frame not found")


class TooManyWritesError(ExecutorError):
    def __init__(self):
        super().__init__("too many write commands")


def needs_slices(calls: list[Call]) -> bool:
    """reference: executor.go:1326-1343"""
    if not calls:
        return False
    return any(c.name not in WRITE_CALLS for c in calls)


def merge_counts_by_id(parts) -> list[Pair]:
    """Sum (ids, counts) array pairs by id — Pairs.Add semantics
    (reference: cache.go:312-334) — into Pairs in ascending id order."""
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return []
    uids, inv = np.unique(np.concatenate([i for i, _ in parts]), return_inverse=True)
    sums = np.zeros(len(uids), np.int64)
    np.add.at(sums, inv, np.concatenate([c for _, c in parts]))
    return [Pair(int(i), int(c)) for i, c in zip(uids, sums)]


class Executor:
    def __init__(self, holder, max_writes_per_request: int = DEFAULT_MAX_WRITES_PER_REQUEST):
        self.holder = holder
        self.max_writes_per_request = max_writes_per_request
        self._zero_rows: dict[torch.device, torch.Tensor] = {}
        self._zero_mu = threading.Lock()

    def execute(self, index: str, q: Query, slices: list[int] | None = None) -> list:
        if not index:
            raise ExecutorError("index required")
        if (
            self.max_writes_per_request > 0
            and q.write_call_n() > self.max_writes_per_request
        ):
            raise TooManyWritesError()
        slices = list(slices) if slices else []
        computed_lists = False
        column_label = ""
        if not slices and needs_slices(q.calls):
            idx = self.holder.index(index)
            if idx is None:
                raise IndexNotFoundError()
            slices = list(range(idx.max_slice() + 1))
            column_label = idx.column_label
            computed_lists = True
        results = []
        for call in q.calls:
            if call.supports_inverse() and computed_lists:
                # Orientation check on the node's own slice lists
                # (reference: executor.go:93-117).
                f = self.holder.frame(index, call.args.get("frame") or DEFAULT_FRAME)
                if f is None:
                    raise FrameNotFoundError()
                if call.is_inverse(f.row_label, column_label):
                    raise ExecutorError("inverse views are not supported by this port yet")
            results.append(self._execute_call(index, call, slices))
        return results

    # ------------------------------------------------------------------
    # dispatch (reference: executor.go:156-182)
    # ------------------------------------------------------------------

    def _execute_call(self, index: str, c: Call, slices: list[int]):
        name = c.name
        if name == "ClearBit":
            return self._execute_clear_bit(index, c)
        if name == "SetBit":
            return self._execute_set_bit(index, c)
        if name in ("SetRowAttrs", "SetColumnAttrs"):
            raise ExecutorError(f"{name}() is not supported by this port yet")
        if name == "Count":
            return self._execute_count(index, c, slices)
        if name == "TopN":
            return self._execute_topn(index, c, slices)
        return self._execute_bitmap_call(index, c, slices)

    # ------------------------------------------------------------------
    # bitmap call trees
    # ------------------------------------------------------------------

    def _resolve_bitmap_leaf(self, index: str, c: Call):
        """Frame/row/orientation resolution for a Bitmap() leaf
        (reference: executor.go:438-484): ``(view or None, row_id)``."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        row_label = f.row_label
        column_label = idx.column_label
        row_id, row_ok = _uint_arg(c, row_label)
        col_id, col_ok = _uint_arg(c, column_label)
        if row_ok and col_ok:
            raise ExecutorError(
                f"Bitmap() cannot specify both {row_label} and {column_label} values"
            )
        if not row_ok and not col_ok:
            raise ExecutorError(
                f"Bitmap() must specify either {row_label} or {column_label} values"
            )
        if col_ok:
            if not f.inverse_enabled:
                raise ExecutorError(
                    "Bitmap() cannot retrieve columns unless inverse storage enabled"
                )
            raise ExecutorError("inverse views are not supported by this port yet")
        return f.view(VIEW_STANDARD), row_id

    def _zero_row(self, device: torch.device) -> torch.Tensor:
        with self._zero_mu:
            z = self._zero_rows.get(device)
            if z is None:
                z = torch.zeros(bp.WORDS_PER_SLICE, dtype=torch.int32, device=device)
                self._zero_rows[device] = z
            return z

    def leaf_stacks(
        self, index: str, leaves: list[Call], slices: list[int]
    ) -> tuple[list[torch.Tensor], list[int]]:
        """Stack every leaf's rows from the fragments' device mirrors:
        ``(stacks, kept)`` with ``stacks[j]`` int32 [len(kept), 32768]
        for leaf j, over the slices where at least one leaf row exists
        (elsewhere every tree is empty).  An absent row is a zero row."""
        targets = [self._resolve_bitmap_leaf(index, leaf) for leaf in leaves]
        per_leaf: list[list[torch.Tensor]] = [[] for _ in leaves]
        kept: list[int] = []
        zero = self._zero_row(self.holder.device)
        for s in slices:
            rows = []
            for view, row_id in targets:
                frag = view.fragment(s) if view is not None else None
                rows.append(frag.device_row(row_id) if frag is not None else None)
            if all(r is None for r in rows):
                continue
            kept.append(s)
            for j, r in enumerate(rows):
                per_leaf[j].append(zero if r is None else r)
        if not kept:
            return [], kept
        return [torch.stack(rows) for rows in per_leaf], kept

    def _execute_bitmap_call(self, index: str, c: Call, slices: list[int]) -> RowBitmap:
        """reference: executor.go:203-261"""
        bm = RowBitmap()
        expr, leaves = plan.decompose(c)
        stacks, kept = self.leaf_stacks(index, leaves, slices)
        if kept:
            # One device->host copy of every slice's result row.
            rows = plan.eval_expr(expr, stacks).cpu()
            for i, s in enumerate(kept):
                bm.set_segment(s, rows[i])
        # Attach attributes for Bitmap() calls (reference: executor.go:226-258).
        if c.name == "Bitmap":
            idx = self.holder.index(index)
            if idx is not None:
                col_id, col_ok = _uint_arg(c, idx.column_label)
                if col_ok:
                    bm.attrs = idx.column_attr_store.attrs(col_id)
                else:
                    # Raw frame arg, NOT defaulted: with frame omitted the
                    # reference attaches no row attrs (executor.go:244-258).
                    frame = c.args.get("frame") or ""
                    f = idx.frame(frame) if frame else None
                    if f is not None:
                        row_id, row_ok = _uint_arg(c, f.row_label)
                        if row_ok:
                            bm.attrs = f.row_attr_store.attrs(row_id)
        return bm

    def _execute_count(self, index: str, c: Call, slices: list[int]) -> int:
        """reference: executor.go:611-639"""
        if len(c.children) == 0:
            raise ExecutorError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise ExecutorError("Count() only accepts a single bitmap input")
        expr, leaves = plan.decompose(c.children[0])
        stacks, kept = self.leaf_stacks(index, leaves, slices)
        if not kept:
            return 0
        return int(plan.count_rows(expr, stacks).sum(dtype=torch.int64))

    # ------------------------------------------------------------------
    # TopN (reference: executor.go:281-415) — two-phase
    # ------------------------------------------------------------------

    def _execute_topn(self, index: str, c: Call, slices: list[int]) -> list[Pair]:
        ids_arg = _uint_slice_arg(c, "ids")
        n = _uint_arg(c, "n")[0]
        pairs = self._execute_topn_slices(index, c, slices)
        if not pairs or ids_arg:
            return pairs
        # With one slice the phase-1 scores are already exact.
        if len(slices) <= 1:
            return pairs[:n] if n and n < len(pairs) else pairs
        # Phase 2: exact counts for the phase-1 winner union (reference:
        # executor.go:301-321).
        other = c.clone()
        other.args["ids"] = sorted({p.id for p in pairs})
        trimmed = self._execute_topn_slices(index, other, slices)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _execute_topn_slices(self, index: str, c: Call, slices: list[int]) -> list[Pair]:
        if len(c.children) > 1:
            raise ExecutorError("TopN() can only have one input bitmap")
        frame = c.args.get("frame") or DEFAULT_FRAME
        if bool(c.args.get("inverse", False)):
            raise ExecutorError("inverse views are not supported by this port yet")
        idx = self.holder.index(index)
        f = idx.frame(frame) if idx is not None else None
        view = f.view(VIEW_STANDARD) if f is not None else None
        if view is None:
            return []
        have = view.fragment_slices()
        local = [s for s in slices if s in have]
        n = _uint_arg(c, "n")[0]
        fld = c.args.get("field", "") or ""
        row_ids = _uint_slice_arg(c, "ids")
        min_threshold = _uint_arg(c, "threshold")[0]
        if min_threshold <= 0:
            min_threshold = MIN_THRESHOLD
        filters = c.args.get("filters")
        tanimoto = _uint_arg(c, "tanimotoThreshold")[0]
        src_rows = None
        if len(c.children) == 1:
            # The src tree's row per slice, folded on the device like a
            # Bitmap() call.  A slice without one is an empty src there,
            # and an all-zero row scores nothing: both give no pairs.
            expr, leaves = plan.decompose(c.children[0])
            stacks, kept = self.leaf_stacks(index, leaves, local)
            src_rows = {}
            if kept:
                rows = plan.eval_expr(expr, stacks)
                src_rows = {s: rows[i] for i, s in enumerate(kept)}
        parts = []
        for s in local:
            frag = view.fragment(s)
            # Validated after the fragment-existence check, matching the
            # reference's ordering (executor.go:346-415).
            if tanimoto > 100:
                raise ExecutorError("Tanimoto Threshold is from 1 to 100 only")
            src = None
            if src_rows is not None:
                src = RowBitmap()
                row = src_rows.get(s)
                if row is not None:
                    src.set_segment(s, row)
            pairs = frag.top(
                TopOptions(
                    n=n,
                    src=src,
                    row_ids=list(row_ids) if row_ids else None,
                    filter_field=fld,
                    filter_values=list(filters) if filters else None,
                    min_threshold=min_threshold,
                    tanimoto_threshold=tanimoto,
                )
            )
            parts.append(
                (
                    np.fromiter((p.id for p in pairs), np.int64, len(pairs)),
                    np.fromiter((p.count for p in pairs), np.int64, len(pairs)),
                )
            )
        return cache_mod.sort_pairs(merge_counts_by_id(parts))

    # ------------------------------------------------------------------
    # writes (reference: executor.go:642-840)
    # ------------------------------------------------------------------

    def _resolve_write(self, index: str, c: Call, verb: str):
        frame_name = c.args.get("frame")
        if not isinstance(frame_name, str):
            raise ExecutorError(f"{verb}() field required: frame")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        f = idx.frame(frame_name)
        if f is None:
            raise FrameNotFoundError()
        row_label = f.row_label
        column_label = idx.column_label
        row_id, ok = _uint_arg(c, row_label)
        if not ok:
            raise ExecutorError(f"{verb}() row field '{row_label}' required")
        col_id, ok = _uint_arg(c, column_label)
        if not ok:
            raise ExecutorError(f"{verb}() column field '{column_label}' required")
        return f, row_id, col_id

    def _write(self, index: str, c: Call, verb: str, write_fn) -> bool:
        """Standard-view writes (reference: executor.go:679-734)."""
        view = c.args.get("view", "") or ""
        f, row_id, col_id = self._resolve_write(index, c, verb)
        if view == VIEW_INVERSE or (view == "" and f.inverse_enabled):
            raise ExecutorError("inverse views are not supported by this port yet")
        if view not in ("", VIEW_STANDARD):
            raise ExecutorError(f"invalid view: {view}")
        return write_fn(f, row_id, col_id)

    def _execute_set_bit(self, index: str, c: Call) -> bool:
        if isinstance(c.args.get("timestamp"), str):
            raise ExecutorError("time-quantum views are not supported by this port yet")
        return self._write(
            index, c, "SetBit", lambda f, r, col: f.set_bit(VIEW_STANDARD, r, col)
        )

    def _execute_clear_bit(self, index: str, c: Call) -> bool:
        return self._write(
            index, c, "ClearBit", lambda f, r, col: f.clear_bit(VIEW_STANDARD, r, col)
        )


def _uint_arg(c: Call, key: str) -> tuple[int, bool]:
    """(value, present) via Call.uint_arg, with type errors normalized
    to ExecutorError at the API boundary."""
    try:
        v = c.uint_arg(key)
    except TypeError as e:
        raise ExecutorError(str(e)) from e
    return (0, False) if v is None else (v, True)


def _uint_slice_arg(c: Call, key: str) -> list[int] | None:
    try:
        return c.uint_slice_arg(key)
    except TypeError as e:
        raise ExecutorError(str(e)) from e
