"""Executor — PQL calls over one node's local slices.

Behavior parity with ``pilosa_tpu.exec.executor`` (reference:
executor.go) for the calls this port executes: ``Bitmap``, ``Range``
(a time-quantum union, or a BSI comparison), ``Union``, ``Intersect``,
``Difference``, ``Xor``, ``Count``, ``Sum``/``Min``/``Max``,
``SetBit`` (with a timestamp too), ``ClearBit`` and ``TopN`` (with or
without a src bitmap, ``ids``, ``threshold``, ``tanimotoThreshold``,
attribute filters), with the same slice lists, the same two-phase TopN
and the same error messages.

Execution on the device: every read site first brings the mirrors it
reads up to date with one launch of the delta-scatter K7 per device for
all the fragments with queued writes (``apply_pending_many``: the leaf
stacks, the anchored Count, the TopN prepares).  A bitmap tree's row
leaves are stacked per
leaf (int32 ``[n_slices, 32768]``, only slices where some leaf row
exists; a time-quantum ``Range`` is the union of its time views' rows)
from the fragments' device mirrors, and a sparse-tier row's compressed
payload is written into its place by the payload expansion K6 — one
launch per stacking; the tree folds with torch bitwise ops, and a
count's last fold step is one fused popcount launch (exec/plan.py).  A
Count over Bitmap leaves whose tree has an anchor (a leaf that bounds
the result) and a compressed leaf runs first in the position domain:
one launch of the anchored count K5 over every local slice (JAX
``executor.py:1634-1830``, same routing rules).  A BSI ``Range``
comparison and ``Sum``/``Min``/``Max``
are rewritten as in the JAX package (``_rewrite_bsi``) into nodes over
the field's plane leaves, which the ripple kernel K8 reads in place from
the field fragments' mirrors.  TopN prepares every local fragment's
candidates first and scores them all in one launch of the
cross-fragment scorer K4 (``ops/score_planes.py``) with one fetch per
node and phase; on one node both phases come from one scoring pass (the
folded TopN, JAX ``executor.py:2611-2851``).

Across a cluster (JAX ``executor.py:3203-3500``): a read maps the
slice list over the owning nodes — local slices run here, the others
go to their owners as protobuf queries with ``Remote`` set, which run
only locally there — and reduces each answer as it lands (Count sums,
Bitmap unions, TopN pair merges, TopN's two phases on the coordinating
node).  A node whose leg fails with a transport error or a 5xx has its
slices placed again on the remaining replicas.  ``SetBit``/``ClearBit``
reach every owner of the slice.

Inverse views (JAX ``executor.py:496-571``): ``Bitmap(<columnLabel>=c)``,
``Range`` with a column id and ``TopN(inverse=true)`` read the frame's
inverse view over the index's inverse slices, swapped in only when this
node computed the slice lists itself (a remote leg's list is used as
it is); ``SetBit``/``ClearBit`` without a view also write the inverse
view of an inverse-enabled frame, on the owners of slice
``row // SLICE_WIDTH``.

Residency and durability (JAX ``executor.py:577``, ``:3068``): a query
first asks the prefetcher to upload the cold mirrors of its leaf
fragments in the background (``_prefetch_query``); every local map leg,
and the folded TopN, runs inside a pin lease of the residency pool, so
every mirror and sparse payload it finds or uploads stays pinned until
its launches are enqueued and their results fetched.  ``SetBit`` and
``ClearBit`` answer only after the WAL's group commit made this
thread's writes durable (``_wait_durable``), outside every fragment
lock; a remote leg waits on its own node before it answers.

Replication quorums, attribute writes and the coalescer of the JAX
executor are not ported yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field, replace
from datetime import datetime

import numpy as np
import torch

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.bsi import ripple
from pilosa_tpu_torch.cluster.topology import Cluster, Node
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.fragment import Fragment, TopOptions, apply_pending_many
from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD
from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.net.client import is_node_failure
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops import bsi_ripple, expand_payload, score_planes
from pilosa_tpu_torch.pql.parser import TIME_FORMAT, Call, Query

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


class SliceUnavailableError(ExecutorError):
    def __init__(self):
        super().__init__("slice unavailable")


class SlicesUnavailableError(ExecutorError):
    """Every owner of ``slices`` failed: fail WITH the slice list."""

    def __init__(self, slices, cause: Exception | None = None):
        self.slices = sorted({int(s) for s in slices})
        msg = f"slices unavailable: {self.slices}"
        if cause is not None:
            msg += f" (last error: {cause})"
        super().__init__(msg)


@dataclass
class ExecOptions:
    """reference: executor.go:1302-1304.  ``remote``: this is a map leg
    of another node's query — run it on the local slices only."""

    remote: bool = False


@dataclass
class _MapResponse:
    node: Node
    slices: list[int] = field(default_factory=list)
    result: object = None
    error: Exception | None = None


def needs_slices(calls: list[Call]) -> bool:
    """reference: executor.go:1326-1343"""
    if not calls:
        return False
    return any(c.name not in WRITE_CALLS for c in calls)


def isin_sorted(values: np.ndarray, sorted_ref: np.ndarray) -> np.ndarray:
    """Membership of ``values`` in sorted-unique ``sorted_ref`` by one
    binary search."""
    if not len(sorted_ref):
        return np.zeros(len(values), dtype=bool)
    idx = np.searchsorted(sorted_ref, values)
    idx[idx == len(sorted_ref)] = len(sorted_ref) - 1
    return sorted_ref[idx] == values


def merge_counts_by_id(parts):
    """Sum (ids, counts) array pairs by id — Pairs.Add semantics
    (reference: cache.go:312-334): ``(ids ascending, sums)``, or None
    when every part is empty."""
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return None
    uids, inv = np.unique(np.concatenate([i for i, _ in parts]), return_inverse=True)
    sums = np.zeros(len(uids), np.int64)
    np.add.at(sums, inv, np.concatenate([c for _, c in parts]))
    return uids, sums


class Executor:
    """Runs PQL on ``holder``; with a ``cluster``, maps reads over the
    slices' owners (``host`` is this node, ``client_factory(node)`` a
    client for a peer)."""

    def __init__(
        self,
        holder,
        max_writes_per_request: int = DEFAULT_MAX_WRITES_PER_REQUEST,
        cluster: Cluster | None = None,
        host: str = "",
        client_factory=None,
        prefetcher=None,
        ingest=None,
    ):
        self.holder = holder
        # Background uploads of a query's cold mirrors (device/prefetch.py),
        # and the WAL manager whose group commit a write's answer waits
        # for (ingest/wal.py); None turns either off.
        self.prefetcher = prefetcher
        self.ingest = ingest
        self.max_writes_per_request = max_writes_per_request
        self.cluster = cluster if cluster is not None else Cluster()
        self.host = host
        self.client_factory = client_factory
        self._zero_rows: dict[torch.device, torch.Tensor] = {}
        self._zero_mu = threading.Lock()
        # Map legs to peers; threads start at the first submit.
        self._pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="map")
        self._slice_groups: OrderedDict = OrderedDict()
        self._groups_mu = threading.Lock()

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def execute(
        self,
        index: str,
        q: Query,
        slices: list[int] | None = None,
        opt: ExecOptions | None = None,
    ) -> list:
        opt = opt or ExecOptions()
        if not index:
            raise ExecutorError("index required")
        if (
            self.max_writes_per_request > 0
            and q.write_call_n() > self.max_writes_per_request
        ):
            raise TooManyWritesError()
        slices = list(slices) if slices else []
        inverse_slices: list[int] = []
        computed_lists = False
        column_label = ""
        if not slices and needs_slices(q.calls):
            idx = self.holder.index(index)
            if idx is None:
                raise IndexNotFoundError()
            slices = list(range(idx.max_slice() + 1))
            inverse_slices = list(range(idx.max_inverse_slice() + 1))
            column_label = idx.column_label
            computed_lists = True
        if self.prefetcher is not None and slices:
            self._prefetch_query(index, q.calls, slices)
        results = []
        for call in q.calls:
            call_slices = slices
            if call.supports_inverse() and computed_lists:
                # Orientation on the node's own slice lists (reference:
                # executor.go:93-117); a coordinator's list for a remote
                # leg already has the right orientation.
                f = self.holder.frame(index, call.args.get("frame") or DEFAULT_FRAME)
                if f is None:
                    raise FrameNotFoundError()
                if call.is_inverse(f.row_label, column_label):
                    call_slices = inverse_slices
            results.append(self._execute_call(index, call, call_slices, opt))
        return results

    def _prefetch_query(self, index: str, calls, slices: list[int]) -> None:
        """Schedule background uploads of the cold mirrors of the query's
        leaf fragments — its Bitmap leaves' views, a BSI Range's or
        aggregate's field view, a TopN's frame view — over ``slices``
        (JAX ``executor.py:577``).  Best-effort: an error resolving them
        is swallowed, since the call itself raises the error that
        counts."""
        frags: list = []
        seen: set[int] = set()

        def add_view(view) -> None:
            if view is None:
                return
            have = view.fragment_slices()
            for s in slices:
                frag = view.fragment(s) if s in have else None
                # Advisory (no lock): the worker checks again under it.
                if frag is not None and frag._mirror is None and id(frag) not in seen:
                    seen.add(id(frag))
                    frags.append(frag)

        def leaves(c: Call):
            if c.name in ("Bitmap", "Range"):
                yield c
                return
            for ch in c.children:
                yield from leaves(ch)

        try:
            idx = self.holder.index(index)
            if idx is None:
                return
            for call in calls:
                if call.name in WRITE_CALLS:
                    continue
                for leaf in leaves(call):
                    f = idx.frame(leaf.args.get("frame") or DEFAULT_FRAME)
                    if f is None:
                        continue
                    if leaf.name == "Range":
                        for field_name in leaf.conditions():
                            add_view(f.view(bsi.field_view_name(field_name)))
                        continue
                    _, col_ok = _uint_arg(leaf, idx.column_label)
                    add_view(f.view(VIEW_INVERSE if col_ok else VIEW_STANDARD))
                if call.name == "TopN":
                    add_view(self._topn_view(index, call))
                if call.name in ("Sum", "Min", "Max") and isinstance(call.args.get("field"), str):
                    f = idx.frame(call.args.get("frame") or DEFAULT_FRAME)
                    if f is not None:
                        add_view(f.view(bsi.field_view_name(call.args["field"])))
        except Exception:  # noqa: BLE001 — a prefetch must never fail a query
            return
        if frags:
            self.prefetcher.prefetch(frags)

    # ------------------------------------------------------------------
    # dispatch (reference: executor.go:156-182)
    # ------------------------------------------------------------------

    def _execute_call(self, index: str, c: Call, slices: list[int], opt: ExecOptions):
        name = c.name
        if name == "ClearBit":
            return self._execute_clear_bit(index, c, opt)
        if name == "SetBit":
            return self._execute_set_bit(index, c, opt)
        if name in ("SetRowAttrs", "SetColumnAttrs"):
            raise ExecutorError(f"{name}() is not supported by this port yet")
        if name == "Count":
            return self._execute_count(index, c, slices, opt)
        if name == "TopN":
            return self._execute_topn(index, c, slices, opt)
        if name in ("Sum", "Min", "Max"):
            return self._execute_bsi_agg(index, c, slices, opt)
        return self._execute_bitmap_call(index, c, slices, opt)

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
            return f.view(VIEW_INVERSE), col_id
        return f.view(VIEW_STANDARD), row_id

    def _resolve_range(self, index: str, c: Call) -> tuple[list, int]:
        """A time-quantum Range() leaf (reference: executor.go:507-589;
        JAX ``executor.py:751-792``): ``(time views, row_id)``, the views
        covering [start, end) under the frame's quantum that exist."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        f = idx.frame(c.args.get("frame") or DEFAULT_FRAME)
        if f is None:
            raise FrameNotFoundError()
        column_label, row_label = idx.column_label, f.row_label
        col_id, col_ok = _uint_arg(c, column_label)
        row_id, row_ok = _uint_arg(c, row_label)
        if col_ok and row_ok:
            raise ExecutorError(
                f'Range() cannot contain both "{column_label}" and "{row_label}"'
            )
        if not col_ok and not row_ok:
            raise ExecutorError(
                f'Range() must specify either "{column_label}" or "{row_label}"'
            )
        view_name, id_ = (VIEW_INVERSE, col_id) if col_ok else (VIEW_STANDARD, row_id)
        start, end = _time_arg(c, "start"), _time_arg(c, "end")
        if not f.time_quantum:
            return [], id_
        names = tq.views_by_time_range(view_name, start, end, f.time_quantum)
        return [v for v in (f.view(n) for n in names) if v is not None], id_

    def _resolve_leaf(self, index: str, c: Call) -> tuple:
        """What a leaf reads in each slice: ``("row", views, row_id)`` —
        the union of the row over ``views`` — for Bitmap and time Range
        leaves, ``("plane", view, row)`` for a BSI plane, ``("pred", v)``
        and ``("zero",)`` for the slice-invariant BSI leaves."""
        if c.name == "Bitmap":
            view, row_id = self._resolve_bitmap_leaf(index, c)
            return ("row", [] if view is None else [view], row_id)
        if c.name == "Range":
            views, row_id = self._resolve_range(index, c)
            return ("row", views, row_id)
        if c.name == "BsiPlane":
            view = self.holder.view(
                index, c.args["frame"], bsi.field_view_name(c.args["field"])
            )
            return ("plane", view, c.args["row"])
        if c.name == "BsiPred":
            return ("pred", c.args["v"])
        if c.name == "BsiZero":
            return ("zero",)
        raise plan.PlanError(f"unknown call: {c.name}")

    def _zero_row(self, device: torch.device) -> torch.Tensor:
        with self._zero_mu:
            z = self._zero_rows.get(device)
            if z is None:
                z = torch.zeros(bp.WORDS_PER_SLICE, dtype=torch.int32, device=device)
                self._zero_rows[device] = z
            return z

    @staticmethod
    def _row_sources(views: list, row_id: int, slice_i: int) -> list:
        """The row's device forms in ``views`` at one slice, as
        ``Fragment.device_leaf`` gives them (a mirror row, or a sparse
        row's compressed payload); their union is the leaf's row."""
        out = []
        for view in views:
            frag = view.fragment(slice_i)
            leaf = frag.device_leaf(row_id) if frag is not None else None
            if leaf is not None:
                out.append(leaf)
        return out

    def _stack_rows(self, sources: list[list]) -> tuple[torch.Tensor, list, list]:
        """One row leaf's int32 [n, 32768] stack over the kept slices
        from each slice's row sources: plane rows copied in one stack,
        every compressed row returned as a K6 job writing its stack row
        (or, in a union of several views, a scratch row OR-ed in after
        the launch — ``(stack, i, rows)`` in the second list)."""
        device = self.holder.device
        zero = self._zero_row(device)
        plain = [len(p) == 1 and p[0][0] == bp.FMT_DENSE for p in sources]
        if any(plain):
            out = torch.stack([p[0][1] if ok else zero for p, ok in zip(sources, plain)])
        else:
            out = torch.empty(len(sources), bp.WORDS_PER_SLICE, dtype=torch.int32, device=device)
        jobs, unions = [], []
        for i, (p, ok) in enumerate(zip(sources, plain)):
            if ok:
                continue
            if not p:
                out[i].zero_()
            elif len(p) == 1:
                jobs.append((p[0][0], p[0][1], out[i]))
            else:
                rows = []
                for fmt, t in p:
                    if fmt == bp.FMT_DENSE:
                        rows.append(t)
                    else:
                        tmp = torch.empty(bp.WORDS_PER_SLICE, dtype=torch.int32, device=device)
                        jobs.append((fmt, t, tmp))
                        rows.append(tmp)
                unions.append((out, i, rows))
        return out, jobs, unions

    def leaf_stacks(
        self, index: str, leaves: list[Call], slices: list[int]
    ) -> tuple[list, list[int]]:
        """The plan's inputs for every leaf over the slices where at least
        one leaf row exists (elsewhere every tree is empty): ``(inputs,
        kept)``.  A row leaf becomes an int32 [len(kept), 32768] stack of
        mirror rows (an absent row is a zero row), its sparse-tier rows
        expanded in place by one K6 launch for the whole call; every BSI plane leaf of
        a field the field's one ``bsi_ripple.FieldPlanes`` — its fragments'
        mirrors and the rows of exists, sign and each magnitude bit in
        them, read in place by the ripple kernel; a predicate a
        ``plan.PredLeaf``; a pad plane None."""
        targets = [self._resolve_leaf(index, leaf) for leaf in leaves]
        # Every fragment a leaf reads is brought up to date first, in one
        # K7 launch for all of them.
        views = [v for t in targets if t[0] in ("row", "plane")
                 for v in (t[1] if t[0] == "row" else [t[1]]) if v is not None]
        apply_pending_many(v.fragment(s) for v in views for s in slices)
        # The plane leaves of one field read one fragment per slice, at
        # the field's rows 0 .. 1 + depth, in that order in each BSI node.
        fields: dict[int, tuple] = {}
        for j, t in enumerate(targets):
            if t[0] == "plane":
                fields.setdefault(id(t[1]), (t[1], []))[1].append(t[2])
        for _, prows in fields.values():
            nrows = max(prows) + 1
            if nrows < 3 or prows != list(range(nrows)) * (len(prows) // nrows):
                raise plan.PlanError(
                    "a field's plane leaves must list exists, sign and every bit in order")
            del prows[nrows:]
        rows: dict[int, list] = {j: [] for j, t in enumerate(targets) if t[0] == "row"}
        mirrors: dict[int, list] = {key: [] for key in fields}
        slots: dict[int, list] = {key: [] for key in fields}
        kept: list[int] = []
        for s in slices:
            got = {j: self._row_sources(targets[j][1], targets[j][2], s) for j in rows}
            any_set = any(got.values())
            planes = {}
            for key, (view, prows) in fields.items():
                frag = view.fragment(s) if view is not None else None
                if frag is None:
                    planes[key] = (None, [-1] * len(prows))
                    continue
                planes[key] = frag.device_slots(prows)
                any_set = any_set or any(x >= 0 for x in planes[key][1])
            if not any_set:
                continue
            kept.append(s)
            for j, r in got.items():
                rows[j].append(r)
            for key, (mirror, sl) in planes.items():
                mirrors[key].append(mirror)
                slots[key].append(sl)
        if not kept:
            return [], kept
        field_planes = {
            key: bsi_ripple.FieldPlanes(
                mirrors[key], np.asarray(slots[key], dtype=np.int64),
                bsi.pad_depth(len(prows) - 2), self.holder.device,
            )
            for key, (_, prows) in fields.items()
        }
        stacks, jobs, unions = {}, [], []
        for j, srcs in rows.items():
            stacks[j], leaf_jobs, leaf_unions = self._stack_rows(srcs)
            jobs += leaf_jobs
            unions += leaf_unions
        if jobs:
            expand_payload.expand_payloads(jobs)
        for out, i, parts in unions:
            acc = parts[0]
            for r in parts[1:]:
                acc = acc | r
            out[i] = acc
        inputs: list = []
        for j, t in enumerate(targets):
            if t[0] == "row":
                inputs.append(stacks[j])
            elif t[0] == "plane":
                inputs.append(field_planes[id(t[1])])
            elif t[0] == "pred":
                inputs.append(plan.PredLeaf(t[1]))
            else:
                inputs.append(None)
        return inputs, kept

    # ------------------------------------------------------------------
    # BSI rewrite — Range(field > x) / Sum / Min / Max expansion
    # (JAX executor.py:797-905)
    # ------------------------------------------------------------------

    def _bsi_resolve_field(self, index: str, c: Call):
        """(frame name, Frame) for a BSI call — schema errors surface
        here, before any leaf machinery runs."""
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = self.holder.frame(index, frame)
        if f is None:
            raise FrameNotFoundError()
        if not f.range_enabled:
            raise ExecutorError(f"frame {frame!r} does not support range queries")
        return frame, f

    def _bsi_field_leaves(self, frame: str, fld) -> tuple[list[Call], int]:
        """The plane leaves of one field, padded to its depth bucket:
        exists, sign, ``depth`` magnitude planes, then all-zero pads."""
        depth = fld.bit_depth
        bucket = bsi.pad_depth(depth)
        leaves = [
            Call("BsiPlane", {"frame": frame, "field": fld.name, "row": r})
            for r in (bsi.ROW_EXISTS, bsi.ROW_SIGN)
        ]
        leaves += [
            Call("BsiPlane", {"frame": frame, "field": fld.name, "row": bsi.ROW_BIT_BASE + k})
            for k in range(depth)
        ]
        leaves += [Call("BsiZero") for _ in range(bucket - depth)]
        return leaves, bucket

    def _rewrite_bsi(self, index: str, c: Call) -> Call:
        """Expand BSI Range calls (a comparison arg present) anywhere in a
        call tree into synthetic ``BsiCmp`` nodes over plane/predicate
        leaves; returns the ORIGINAL object when nothing changed.  Remote
        forwarding ships the un-rewritten PQL text, and each node
        re-expands against its own schema."""
        if c.name == "Range" and c.conditions():
            return self._rewrite_bsi_range(index, c)
        new_children = [self._rewrite_bsi(index, ch) for ch in c.children]
        if all(nc is oc for nc, oc in zip(new_children, c.children)):
            return c
        return Call(name=c.name, args=dict(c.args), children=new_children)

    def _rewrite_bsi_range(self, index: str, c: Call) -> Call:
        conds = c.conditions()
        if len(conds) != 1:
            raise ExecutorError(
                "Range() supports exactly one field comparison (use >< for between)"
            )
        ((field_name, cond),) = conds.items()
        frame, f = self._bsi_resolve_field(index, c)
        fld = f.bsi_field(field_name)
        if fld is None:
            raise ExecutorError(f"unknown field: {field_name!r}")
        op = bsi.OPS.get(cond.op)
        if op is None:
            raise ExecutorError(f"unknown comparison: {cond.op!r}")
        depth = fld.bit_depth
        leaves, bucket = self._bsi_field_leaves(frame, fld)
        v = cond.value
        if op == "between":
            if (
                not isinstance(v, list)
                or len(v) != 2
                or any(isinstance(x, bool) or not isinstance(x, int) for x in v)
            ):
                raise ExecutorError("between (><) requires a two-int list")
            lo, hi = bsi.clamp_between(v[0], v[1], depth)
            leaves.append(Call("BsiPred", {"v": lo, "d": bucket}))
            leaves.append(Call("BsiPred", {"v": hi, "d": bucket}))
        else:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ExecutorError(
                    f"Range() comparison value must be an integer, got {v!r}"
                )
            op, v = bsi.clamp_predicate(op, v, depth)
            leaves.append(Call("BsiPred", {"v": v, "d": bucket}))
        return Call("BsiCmp", {"op": op}, children=leaves)

    def _rewrite_bsi_agg(self, index: str, c: Call) -> Call:
        """Expand Sum/Min/Max(frame=, field=, [filter child]) into the
        synthetic aggregate node of the plan."""
        if len(c.children) > 1:
            raise ExecutorError(f"{c.name}() can only have one input bitmap")
        field_name = c.args.get("field")
        if not isinstance(field_name, str):
            raise ExecutorError(f"{c.name}() field required")
        frame, f = self._bsi_resolve_field(index, c)
        fld = f.bsi_field(field_name)
        if fld is None:
            raise ExecutorError(f"unknown field: {field_name!r}")
        leaves, bucket = self._bsi_field_leaves(frame, fld)
        has_filter = bool(c.children)
        if has_filter:
            leaves.append(self._rewrite_bsi(index, c.children[0]))
        return Call("Bsi" + c.name, {"filter": has_filter, "nplanes": bucket}, children=leaves)

    def _execute_bitmap_call(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> RowBitmap:
        """reference: executor.go:203-261"""
        expr, leaves = plan.decompose(self._rewrite_bsi(index, c))

        def map_fn(local_slices: list[int]) -> RowBitmap:
            out = RowBitmap(self.holder.device)
            inputs, kept = self.leaf_stacks(index, leaves, local_slices)
            if kept:
                rows = plan.eval_expr(expr, inputs)
                for i, s in enumerate(kept):
                    out.set_segment(s, rows[i])
            return out

        def reduce_fn(prev, v):
            if prev is None:
                return v
            prev.merge(v)
            return prev

        bm = self._map_reduce(index, slices, c, opt, map_fn, reduce_fn)
        if bm is None:
            bm = RowBitmap(self.holder.device)
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

    def _execute_count(self, index: str, c: Call, slices: list[int], opt: ExecOptions) -> int:
        """reference: executor.go:611-639"""
        if len(c.children) == 0:
            raise ExecutorError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise ExecutorError("Count() only accepts a single bitmap input")
        expr, leaves = plan.decompose(self._rewrite_bsi(index, c.children[0]))

        def map_fn(local_slices: list[int]) -> int:
            anchored = self._try_anchored_count(index, expr, leaves, local_slices)
            if anchored is not None:
                return anchored
            inputs, kept = self.leaf_stacks(index, leaves, local_slices)
            if not kept:
                return 0
            return int(plan.count_rows(expr, inputs).sum(dtype=torch.int64))

        n = self._map_reduce(
            index, slices, c, opt, map_fn, lambda prev, v: (prev or 0) + v
        )
        return int(n or 0)

    # ------------------------------------------------------------------
    # anchored position-domain Count (JAX executor.py:1627-1802)
    # ------------------------------------------------------------------

    # Anchor-cardinality ceiling: past one dense row's worth of words the
    # position-domain searches cost more than streaming the dense words.
    ANCHORED_MAX_POSITIONS = bp.WORDS_PER_SLICE

    @staticmethod
    def _expr_fold_only(expr: tuple) -> bool:
        """True when the tree is set algebra over leaves (membership masks
        compose pointwise only for the folds)."""
        if expr[0] == "leaf":
            return True
        if expr[0] not in plan.FOLD_CALLS:
            return False
        return all(Executor._expr_fold_only(ch) for ch in expr[1:])

    @staticmethod
    def _anchor_candidates(expr: tuple) -> set:
        """Leaves whose rows are supersets of the result: every child of
        an Intersect and the first child of a Difference bound it, so a
        leaf reached from the root through only those edges bounds it."""
        if expr[0] == "leaf":
            return {expr[1]}
        if expr[0] == "Intersect":
            out: set = set()
            for ch in expr[1:]:
                out |= Executor._anchor_candidates(ch)
            return out
        if expr[0] == "Difference" and len(expr) > 1:
            return Executor._anchor_candidates(expr[1])
        return set()

    def _try_anchored_count(self, index: str, expr: tuple, leaves: list[Call],
                            slices: list[int]) -> int | None:
        """Count(tree) over ``slices`` in the position domain, or None
        where the JAX package's route declines (``executor.py:1665``):
        the plane format is "dense", a leaf is not a Bitmap, the tree is
        not fold-only, it has no anchor candidate, some slice's smallest
        anchor passes ANCHORED_MAX_POSITIONS, or no leaf is compressed.
        In each slice the candidate with the fewest bits (the first on a
        tie) is the anchor; an empty anchor bounds the slice at 0.  The
        count is ONE launch of K5 (``plan.anchored_count``) over every
        remaining slice, any mix of formats; a failure raises."""
        if bp.PLANE_FORMAT == "dense":
            return None
        if not leaves or any(leaf.name != "Bitmap" for leaf in leaves):
            return None
        if not self._expr_fold_only(expr):
            return None
        cands = sorted(self._anchor_candidates(expr))
        if not cands:
            return None
        resolved = [self._resolve_bitmap_leaf(index, leaf) for leaf in leaves]
        picked = []
        any_compressed = False
        for s in slices:
            frags = [view.fragment(s) if view is not None else None for view, _ in resolved]
            card, ai = min(
                ((frags[i].row_count(resolved[i][1]) if frags[i] is not None else 0), i)
                for i in cands
            )
            if card == 0:
                continue
            if card > self.ANCHORED_MAX_POSITIONS:
                return None
            anchor = frags[ai].row_positions(resolved[ai][1])
            if anchor is None or len(anchor) == 0:
                continue
            for frag, (_, rid) in zip(frags, resolved):
                hp = frag.host_payload(rid) if frag is not None else None
                if hp is not None and hp[0] != bp.FMT_DENSE:
                    any_compressed = True
            picked.append((anchor, frags))
        if not any_compressed:
            return None
        apply_pending_many(f for _, frags in picked for f in frags)
        offsets = np.zeros(len(picked) + 1, dtype=np.int64)
        offsets[1:] = np.cumsum([len(a) for a, _ in picked])
        positions = np.concatenate([a for a, _ in picked])
        dev_leaves = [
            [frag.device_leaf(rid) if frag is not None else None
             for frag, (_, rid) in zip(frags, resolved)]
            for _, frags in picked
        ]
        counts = plan.anchored_count(expr, positions, offsets, dev_leaves, self.holder.device)
        return int(counts.sum(dtype=torch.int64))

    # ------------------------------------------------------------------
    # BSI aggregates — Sum / Min / Max (JAX executor.py:2094-2225)
    # ------------------------------------------------------------------

    @staticmethod
    def _normalize_valcount(v):
        """Map a local (ValCount | None) or remote-decoded ([Pair] | 0)
        partial to ValCount | None.  A remote node with no valued
        columns answers an empty result that decodes to 0; legitimate
        partials are always Pair lists, so bare ints mean "no data"."""
        if isinstance(v, bsi.ValCount):
            return v
        if isinstance(v, list) and v:
            p = v[0]
            val = int(p.id) & 0xFFFFFFFFFFFFFFFF
            if val >= 1 << 63:  # sign-extend the u64 wire wrap
                val -= 1 << 64
            return bsi.ValCount(value=val, count=int(p.count))
        return None

    def _execute_bsi_agg(self, index: str, c: Call, slices: list[int], opt: ExecOptions):
        """Sum/Min/Max(…, frame=f, field=q): per-slice partial vectors
        from ONE ripple-kernel launch over the field's planes (plus an
        optional filter tree), combined in Python ints, reduced across
        nodes through the ordinary map/reduce.  Cross-node partials ride
        the Pairs wire shape (value u64-wrapped, count)."""
        name = c.name
        rc = self._rewrite_bsi_agg(index, c)
        bucket = int(rc.args["nplanes"])
        expr, leaves = plan.decompose(rc)

        def map_fn(local_slices: list[int]):
            inputs, kept = self.leaf_stacks(index, leaves, local_slices)
            if not kept:
                return None
            vecs = plan.agg_vectors(expr, inputs).cpu().numpy()
            return self._decode_agg_parts(c, bucket, vecs)

        def reduce_fn(prev, v):
            v = self._normalize_valcount(v)
            if v is None:
                return prev
            prev = self._normalize_valcount(prev)
            if prev is None:
                return v
            if name == "Sum":
                return bsi.ValCount(prev.value + v.value, prev.count + v.count)
            if v.value == prev.value:
                return bsi.ValCount(prev.value, prev.count + v.count)
            if name == "Min":
                return v if v.value < prev.value else prev
            return v if v.value > prev.value else prev

        res = self._normalize_valcount(
            self._map_reduce(index, slices, c, opt, map_fn, reduce_fn)
        )
        if res is None and name == "Sum":
            res = bsi.ValCount(0, 0)
        return res

    @staticmethod
    def _decode_agg_parts(c: Call, bucket: int, vecs):
        """Reduce per-slice aggregate partial vectors into one ValCount
        (None when no slice holds a valued column)."""
        if c.name == "Sum":
            total = 0
            count = 0
            for vec in vecs:
                part, n = ripple.decode_sum(vec, bucket)
                total += part
                count += n
            return bsi.ValCount(total, count) if count else None
        best = None
        for vec in vecs:
            decoded = ripple.decode_minmax(vec, bucket)
            if decoded is None:
                continue
            val, n = decoded
            if best is None:
                best = (val, n)
            elif val == best[0]:
                best = (val, best[1] + n)
            elif (c.name == "Min") == (val < best[0]):
                best = (val, n)
        return bsi.ValCount(*best) if best is not None else None

    # ------------------------------------------------------------------
    # TopN (reference: executor.go:281-415; JAX executor.py:2227-3020)
    # ------------------------------------------------------------------

    def _execute_topn(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> list[Pair]:
        ids_arg = _uint_slice_arg(c, "ids")
        n = _uint_arg(c, "n")[0]
        # Folded single-round-trip path: when this node owns every slice,
        # both phases come from ONE union scoring pass with one launch
        # and one fetch; the answers equal the two-phase protocol's.
        if not ids_arg and not opt.remote and len(slices) > 1:
            if self._all_slices_local(index, slices):
                return self._execute_topn_folded(index, c, slices, opt)
        pairs = self._execute_topn_slices(index, c, slices, opt)
        # Phase 2 runs on the coordinating node only (reference:
        # executor.go:301-321).
        if not pairs or ids_arg or opt.remote:
            return pairs
        # With one slice the phase-1 scores are already exact.
        if len(slices) <= 1:
            return pairs[:n] if n and n < len(pairs) else pairs
        return self._topn_refetch(index, c, slices, opt, n, pairs)

    def _execute_topn_two_phase(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions, n: int
    ) -> list[Pair]:
        """The reference's two rounds, when the folded path's union
        guard trips."""
        pairs = self._execute_topn_slices(index, c, slices, opt)
        if not pairs:
            return pairs
        return self._topn_refetch(index, c, slices, opt, n, pairs)

    def _topn_refetch(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions, n: int,
        pairs: list[Pair],
    ) -> list[Pair]:
        """Phase 2: exact counts for the phase-1 winner union."""
        other = c.clone()
        other.args["ids"] = sorted({p.id for p in pairs})
        trimmed = self._execute_topn_slices(index, other, slices, opt)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _all_slices_local(self, index: str, slices: list[int]) -> bool:
        try:
            groups = self._slices_by_node(list(self.cluster.nodes), index, slices)
        except SliceUnavailableError:
            return False
        return set(groups) == {self.host}

    def _execute_topn_slices(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> list[Pair]:
        def map_fn(local_slices: list[int]) -> list[Pair]:
            # Two passes: prepare every local fragment, then score them
            # all in one launch with one fetch (a round trip per node and
            # phase, however many slices it owns), then merge.
            local_slices = self._existing_topn_slices(index, c, local_slices)
            if len(c.children) > 1:
                raise ExecutorError("TopN() can only have one input bitmap")
            srcs = self._topn_srcs(index, c, local_slices) if c.children else None
            view, template = self._topn_view(index, c), self._topn_template(c)
            self_src = self._topn_self_src(index, c)
            if view is not None:
                apply_pending_many(view.fragment(s) for s in local_slices)
            states = []
            for s in local_slices:
                prep = self._topn_options_for_slice(view, s, template, srcs)
                if prep is None:
                    continue
                frag, topt = prep
                states.append((frag, frag.top_prepare_parts(topt)))
            scored = [self._attach_dev_src(frag, part, self_src) for frag, part in states]
            self._score_topn_parts(scored)
            self._score_topn_sparse(scored)
            parts = []
            for frag, (st, _, _) in states:
                ids, cnts, keep, short = frag.top_score_arrays(st)
                if not short:
                    ids, cnts = ids[keep], cnts[keep]
                    if st.n and st.n < len(ids):
                        order = np.lexsort((ids, -cnts))[: st.n]
                        ids, cnts = ids[order], cnts[order]
                parts.append((ids, cnts))
            merged = merge_counts_by_id(parts)
            if merged is None:
                return []
            return [Pair(int(i), int(cnt)) for i, cnt in zip(*merged)]

        pairs = self._map_reduce(
            index, slices, c, opt, map_fn,
            # A remote leg without pairs arrives as an empty QueryResult,
            # which decodes as 0: it adds no pairs.
            lambda prev, v: cache_mod.add_pairs(prev or [], v or []),
        )
        return cache_mod.sort_pairs(pairs or [])

    def _score_topn_parts(self, parts) -> None:
        """Score the parts — ``(TopState, SubRef or None, src row, src
        slot or None)`` — of every fragment with a SubRef in ONE launch
        of the cross-fragment scorer and fetch the scores in one copy,
        filling each ``TopState.counts`` (JAX ``executor.py:2281``).
        The candidate and src rows are read in place: a fragment's src
        is its own mirror's row when ``src slot`` is set, else the row
        its src tree was evaluated into.  Only the slot lists are
        ragged; they pad with -1."""
        live = [p for p in parts if p[1] is not None]
        for lo in range(0, len(live), score_planes.MAX_FRAGMENTS):
            group = live[lo : lo + score_planes.MAX_FRAGMENTS]
            slots = np.full((len(group), max(len(p[1].slots) for p in group)), -1, np.int64)
            for i, (_, sub, _, _) in enumerate(group):
                slots[i, : len(sub.slots)] = sub.slots
            srcs = [src if slot is None else sub.plane[slot] for _, sub, src, slot in group]
            scores = score_planes.score_planes(
                [sub.plane for _, sub, _, _ in group], slots, srcs
            ).cpu().numpy()
            for (st, sub, _, _), row in zip(group, scores):
                st.counts = row[: len(sub.slots)]

    @staticmethod
    def _score_topn_sparse(parts) -> None:
        """Score the sparse-tier candidates of every part on the host
        against its src row's words (JAX ``core/fragment.py:2152``): the
        src rows of every part that has such candidates come to the host
        in ONE copy per node and phase, not one per fragment."""
        live = [p for p in parts if p[0].sparse_pos is not None and len(p[0].sparse_pos)]
        if not live:
            return
        words = bp.to_host(torch.stack([src for _, _, src, _ in live]))
        for (st, _, _, _), w in zip(live, words):
            Fragment.score_sparse(st, w)

    def _topn_self_src(self, index: str, c: Call):
        """``(view, row_id)`` when the src tree is one Bitmap leaf, whose
        row the scorer may read from a fragment's own mirror (the
        ``TopN(Bitmap(frame=f), frame=f)`` shape), else None."""
        if len(c.children) != 1:
            return None
        leaf = c.children[0]
        if leaf.name != "Bitmap" or leaf.children:
            return None
        return self._resolve_bitmap_leaf(index, leaf)

    @staticmethod
    def _attach_dev_src(frag, part, self_src):
        """Extend a fragment's ``(st, SubRef, src row)`` part with the
        src row's slot in the fragment's captured mirror (JAX
        ``executor.py:2429``), where the src is a Bitmap leaf of this
        same fragment and the mirror is still the one the prepare
        captured — a structural write since then may have moved the
        rows.  Otherwise the slot is None and the scorer reads the
        evaluated src row."""
        st, sub, src = part
        slot = None
        if sub is not None and self_src is not None:
            view, row_id = self_src
            if view is not None and view.fragment(frag.slice) is frag:
                slot = frag.slot_in(row_id, sub.plane)
        return st, sub, src, slot

    def _topn_srcs(self, index: str, c: Call, slices: list[int]) -> dict[int, RowBitmap]:
        """The src tree's row per slice as one-segment RowBitmaps, folded
        on the device like a Bitmap() call; slices without a row are
        absent (an empty src there).  A tanimoto selection needs each
        row's count: all of them come from one row-popcount launch."""
        expr, leaves = plan.decompose(self._rewrite_bsi(index, c.children[0]))
        inputs, kept = self.leaf_stacks(index, leaves, slices)
        if not kept:
            return {}
        rows = plan.eval_expr(expr, inputs)
        counts = [None] * len(kept)
        if _uint_arg(c, "tanimotoThreshold")[0] > 0:
            counts = [int(x) for x in bp.row_counts(rows).cpu().numpy()]
        return {
            s: RowBitmap.from_segment(s, rows[i], counts[i], device=self.holder.device)
            for i, s in enumerate(kept)
        }

    def _topn_view(self, index: str, c: Call):
        """The view a TopN call reads — its frame's inverse view with
        ``inverse=true``, else the standard view — or None."""
        f = self.holder.frame(index, c.args.get("frame") or DEFAULT_FRAME)
        if f is None:
            return None
        return f.view(VIEW_INVERSE if bool(c.args.get("inverse", False)) else VIEW_STANDARD)

    def _existing_topn_slices(self, index: str, c: Call, slices: list[int]) -> list[int]:
        """The slices among ``slices`` where the TopN frame has a
        fragment (no other slice contributes)."""
        view = self._topn_view(index, c)
        if view is None:
            return []
        have = view.fragment_slices()
        return [s for s in slices if s in have]

    @staticmethod
    def _topn_template(c: Call) -> TopOptions:
        """The slice-invariant TopN options (reference:
        executor.go:346-415), parsed once per query."""
        min_threshold = _uint_arg(c, "threshold")[0]
        row_ids = _uint_slice_arg(c, "ids")
        filters = c.args.get("filters")
        return TopOptions(
            n=_uint_arg(c, "n")[0],
            row_ids=list(row_ids) if row_ids else None,
            filter_field=c.args.get("field", "") or "",
            filter_values=list(filters) if filters else None,
            min_threshold=min_threshold if min_threshold > 0 else MIN_THRESHOLD,
            tanimoto_threshold=_uint_arg(c, "tanimotoThreshold")[0],
        )

    def _topn_options_for_slice(self, view, slice_i: int, template: TopOptions, srcs=None):
        """``(fragment, TopOptions)`` of one slice of the TopN ``view``,
        or None where the fragment does not exist; ``srcs`` the src rows
        by slice, None for a TopN without a src tree."""
        frag = view.fragment(slice_i) if view is not None else None
        if frag is None:
            return None
        # Validated after the fragment-existence check, matching the
        # reference's ordering (executor.go:346-415).
        if template.tanimoto_threshold > 100:
            raise ExecutorError("Tanimoto Threshold is from 1 to 100 only")
        src = None
        if srcs is not None:
            src = srcs.get(slice_i) or RowBitmap(self.holder.device)
        return frag, replace(template, src=src)

    def _topn_folded_build(self, index: str, c: Call, slices: list[int]):
        """The folded TopN's prep (JAX ``executor.py:2611``): None when
        nothing can score, ``"two_phase"`` when the union guard trips,
        else ``[(frag, topt, cand_ids, cand_mask, (st, sub, src)),
        ...]``, the union scoring pass of every slice, not yet
        scored."""
        slices = self._existing_topn_slices(index, c, slices)
        view, template = self._topn_view(index, c), self._topn_template(c)
        # Pass 1 (host only): each slice's candidates without the src —
        # a src only narrows them (the tanimoto window), so their union
        # is a conservative estimate for the guard below.
        per = []
        for s in slices:
            prep = self._topn_options_for_slice(view, s, template)
            if prep is not None:
                frag, topt = prep
                per.append((frag, topt) + frag.top_candidates_arrays(topt))
        if not per:
            return None
        union = np.unique(np.concatenate([ids for _, _, ids, _ in per]))
        if not len(union):
            return None
        # Every slice scores the WHOLE union: when the union dwarfs the
        # largest candidate list, two rounds cost less device work.
        max_cand = max(len(ids) for _, _, ids, _ in per)
        if len(union) > max(2 * max_cand, 512):
            return "two_phase"
        if c.children:
            srcs = self._topn_srcs(index, c, slices)
            if template.tanimoto_threshold > 0:
                # The tanimoto window depends on the src count: derive
                # the candidates (and the union) again with the src.
                per = []
                for s in slices:
                    prep = self._topn_options_for_slice(view, s, template, srcs)
                    if prep is not None:
                        frag, topt = prep
                        per.append((frag, topt) + frag.top_candidates_arrays(topt))
                if not per:
                    return None
                union = np.unique(np.concatenate([ids for _, _, ids, _ in per]))
            else:
                # Without tanimoto only the scorer reads the src.
                per = [
                    (frag, replace(topt, src=srcs.get(frag.slice) or RowBitmap(self.holder.device)),
                     ids, cnts)
                    for frag, topt, ids, cnts in per
                ]
        if not len(union):
            return None
        self_src = self._topn_self_src(index, c)
        apply_pending_many(frag for frag, *_ in per)
        parts = []
        for frag, topt, cand_ids, cand_cnts in per:
            part = frag.top_prepare_union_parts(union, cand_ids, cand_cnts, topt)
            st = part[0]
            cand_mask = (
                np.isin(st.cand_ids, cand_ids, assume_unique=True)
                if st.cand_ids is not None
                else None
            )
            parts.append((frag, topt, cand_ids, cand_mask,
                          self._attach_dev_src(frag, part, self_src)))
        return parts

    def _execute_topn_folded(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> list[Pair]:
        """Both TopN phases from one scoring pass (JAX
        ``executor.py:2715``; reference protocol executor.go:281-321):
        the cross-slice candidate union is known after a host-only cache
        walk, so every slice scores the whole union once — one launch,
        one fetch — and the phase-1 winner selection and the phase-2
        exact counts both read those scores."""
        n = _uint_arg(c, "n")[0]
        if len(c.children) > 1:
            raise ExecutorError("TopN() can only have one input bitmap")
        # The mirrors the prep finds stay pinned until the scores are
        # fetched.
        with device_mod.pool().pinned():
            parts = self._topn_folded_build(index, c, slices)
            if parts is None:
                return []
            if parts == "two_phase":
                return self._execute_topn_two_phase(index, c, slices, opt, n)
            self._score_topn_parts([p[4] for p in parts])
            self._score_topn_sparse([p[4] for p in parts])
        # Phase-1 winners per slice, from the scores the first round
        # would have given the slice's own candidates (a subset of the
        # union).
        winner_ids, fulls = [], []
        for frag, topt, cand_ids, cand_mask, (st, _, _, _) in parts:
            ids, cnts, keep, short = frag.top_score_arrays(st)
            fulls.append((ids[keep], cnts[keep]))
            if topt.src is None:
                winner_ids.append(cand_ids[: topt.n] if topt.n else cand_ids)
            elif short:
                # Scoring short-circuited (no src segment here): the
                # subset selection would too.
                winner_ids.append(ids)
            else:
                sel_ids, _ = frag.select_winners(ids, cnts, keep, cand_mask, topt.n)
                winner_ids.append(sel_ids)
        ids2 = np.unique(np.concatenate(winner_ids)) if winner_ids else np.empty(0, np.int64)
        if not len(ids2):
            return []
        # Phase 2's exact counts for the winner union, already in hand;
        # counts sum across slices (reference: Pairs.Add, cache.go:312-334).
        kept = []
        for i, cts in fulls:
            m = isin_sorted(i, ids2)
            kept.append((i[m], cts[m]))
        merged = merge_counts_by_id(kept)
        if merged is None:
            return []
        uids, sums = merged
        order = np.lexsort((uids, -sums))
        if n and n < len(order):
            order = order[:n]
        return [Pair(int(uids[k]), int(sums[k])) for k in order]

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

    def _write(self, index: str, c: Call, verb: str, write_fn, opt: ExecOptions) -> bool:
        """Writes to the standard and/or inverse view (reference:
        executor.go:679-734,783-840; JAX ``executor.py:3080-3098``): the
        named view, or with no view the standard one and, for an
        inverse-enabled frame, the inverse one too.  The inverse view
        stores (column, row) in slice ``row // SLICE_WIDTH``."""
        view = c.args.get("view", "") or ""
        f, row_id, col_id = self._resolve_write(index, c, verb)
        if view == VIEW_STANDARD:
            return self._write_one_view(index, c, f, VIEW_STANDARD, row_id, col_id, write_fn, opt)
        if view == VIEW_INVERSE:
            return self._write_one_view(index, c, f, VIEW_INVERSE, col_id, row_id, write_fn, opt)
        if view == "":
            ret = self._write_one_view(index, c, f, VIEW_STANDARD, row_id, col_id, write_fn, opt)
            if f.inverse_enabled and self._write_one_view(
                index, c, f, VIEW_INVERSE, col_id, row_id, write_fn, opt
            ):
                ret = True
            return ret
        raise ExecutorError(f"invalid view: {view}")

    def _write_one_view(self, index: str, c: Call, f, view: str, row_id: int, col_id: int,
                        write_fn, opt: ExecOptions) -> bool:
        """One view's write on every owner of its slice: the local write
        here when this node owns it, the whole call as a remote leg to
        each other owner unless this is itself a remote leg."""
        slice_i = col_id // bp.SLICE_WIDTH
        targets = self.cluster.fragment_nodes(index, slice_i) or [Node(host=self.host)]
        ret = False
        for node in targets:
            if node.host == self.host:
                ret = write_fn(f, view, row_id, col_id) or ret
            elif not opt.remote:
                res = self._exec_remote(node, index, Query(calls=[c]), None)
                ret = bool(res and res[0]) or ret
        return ret

    def _execute_set_bit(self, index: str, c: Call, opt: ExecOptions) -> bool:
        """A SetBit; with ``timestamp`` the bit also goes to the frame's
        time views (JAX ``executor.py:3037-3055``)."""
        self._resolve_write(index, c, "SetBit")
        timestamp = None
        ts = c.args.get("timestamp")
        if isinstance(ts, str):
            try:
                timestamp = datetime.strptime(ts, TIME_FORMAT)
            except ValueError:
                raise ExecutorError(f"invalid date: {ts}") from None
        ret = self._write(
            index, c, "SetBit",
            lambda f, view, r, col: f.set_bit(view, r, col, timestamp), opt,
        )
        self._wait_durable()
        return ret

    def _execute_clear_bit(self, index: str, c: Call, opt: ExecOptions) -> bool:
        ret = self._write(
            index, c, "ClearBit", lambda f, view, r, col: f.clear_bit(view, r, col), opt
        )
        self._wait_durable()
        return ret

    def _wait_durable(self) -> None:
        """Log before the answer: wait until every WAL append this thread
        made while applying the write is fsynced by the group commit.
        Outside every fragment lock: a slow fsync holds back only this
        writer's answer, never a reader."""
        if self.ingest is not None:
            self.ingest.wait_durable()

    # ------------------------------------------------------------------
    # map/reduce over the cluster (reference: executor.go:1131-1283;
    # JAX executor.py:3203-3500)
    # ------------------------------------------------------------------

    def _slices_by_node(
        self, nodes: list[Node], index: str, slices: list[int]
    ) -> dict[str, tuple[Node, list[int]]]:
        """Group slices by their first owner among ``nodes``; cached per
        (ring, node set, index, slice list) — placement is pure in
        those, and hashing ~1000 slices per query costs more host time
        than the query's kernels.  Callers treat the result as
        read-only."""
        if not self.cluster.nodes:
            return {self.host: (Node(host=self.host), list(slices))}
        key = (
            tuple(self.cluster.hosts()),
            self.cluster.replica_n,
            tuple(n.host for n in nodes),
            index,
            tuple(slices),
        )
        with self._groups_mu:
            hit = self._slice_groups.get(key)
            if hit is not None:
                self._slice_groups.move_to_end(key)
                return hit
        m: dict[str, tuple[Node, list[int]]] = {}
        hosts = {n.host for n in nodes}
        for s in slices:
            owners = [o for o in self.cluster.fragment_nodes(index, s) if o.host in hosts]
            if not owners:
                raise SliceUnavailableError()
            m.setdefault(owners[0].host, (owners[0], []))[1].append(s)
        with self._groups_mu:
            self._slice_groups[key] = m
            while len(self._slice_groups) > 8:
                self._slice_groups.popitem(last=False)
        return m

    def _map_reduce(self, index, slices, c, opt, map_fn, reduce_fn):
        """Map ``slices`` over their owners and reduce each answer as it
        lands; a leg that fails for its node (transport error or 5xx)
        has its slices placed again on the remaining owners.  A remote
        leg (``opt.remote``) maps over this node alone."""
        if opt.remote or not self.cluster.nodes:
            me = self.cluster.node_by_host(self.host) or Node(host=self.host)
            nodes = [me]
        else:
            nodes = list(self.cluster.nodes)
        if not slices:
            # Sliceless execution still runs locally once.
            resp = self._map_node(Node(host=self.host), [], index, c, map_fn)
            if resp.error is not None:
                raise resp.error
            return reduce_fn(None, resp.result)

        inflight: dict = {}

        def submit(avail: list[Node], want: list[int]) -> None:
            for node, node_slices in self._slices_by_node(avail, index, want).values():
                fut = self._pool.submit(self._map_node, node, node_slices, index, c, map_fn)
                inflight[fut] = avail

        def failover(resp: _MapResponse, avail: list[Node]) -> None:
            if not is_node_failure(resp.error):
                raise resp.error
            remaining = [n for n in avail if n.host != resp.node.host]
            placeable, lost = self.cluster.split_by_owner(
                index, resp.slices, {n.host for n in remaining}
            )
            if lost:
                raise SlicesUnavailableError(lost, cause=resp.error)
            submit(remaining, placeable)

        groups = self._slices_by_node(nodes, index, slices)
        if len(groups) == 1:
            # One target (the single-node case): run the leg inline.
            ((node, node_slices),) = groups.values()
            resp = self._map_node(node, node_slices, index, c, map_fn)
            if resp.error is None:
                return reduce_fn(None, resp.result)
            failover(resp, nodes)
        else:
            submit(nodes, slices)

        result = None
        while inflight:
            done, _ = wait(list(inflight), return_when=FIRST_COMPLETED)
            for fut in done:
                avail = inflight.pop(fut)
                resp = fut.result()
                if resp.error is not None:
                    failover(resp, avail)
                    continue
                result = reduce_fn(result, resp.result)
        return result

    def _map_node(self, node: Node, node_slices: list[int], index, c, map_fn) -> _MapResponse:
        resp = _MapResponse(node=node, slices=node_slices)
        try:
            if node.host == self.host:
                # Every mirror and sparse payload the leg finds or uploads
                # stays pinned until its launches are enqueued and their
                # results fetched.
                with device_mod.pool().pinned():
                    resp.result = map_fn(node_slices)
            else:
                results = self._exec_remote(node, index, Query(calls=[c]), node_slices)
                resp.result = results[0] if results else None
        except Exception as e:  # noqa: BLE001 — failover boundary
            resp.error = e
        return resp

    def _exec_remote(self, node: Node, index: str, q: Query, slices) -> list:
        """Forward a query to a peer as a remote leg (reference:
        executor.go:1045-1129)."""
        if self.client_factory is None:
            raise ExecutorError(f"no client for remote node {node.host}")
        return self.client_factory(node).execute_query(index, str(q), slices, remote=True)


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


def _time_arg(c: Call, key: str) -> datetime:
    v = c.args.get(key)
    if not isinstance(v, str):
        raise ExecutorError(f"Range() {key} time required")
    try:
        return datetime.strptime(v, TIME_FORMAT)
    except ValueError:
        raise ExecutorError(f"cannot parse Range() {key} time") from None
