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

Across a cluster (JAX ``executor.py:3203-3500``): a read maps the
slice list over the owning nodes — local slices run here, the others
go to their owners as protobuf queries with ``Remote`` set, which run
only locally there — and reduces each answer as it lands (Count sums,
Bitmap unions, TopN pair merges, TopN's two phases on the coordinating
node).  A node whose leg fails with a transport error or a 5xx has its
slices placed again on the remaining replicas.  ``SetBit``/``ClearBit``
reach every owner of the slice.

Replication quorums, BSI/Range, time-quantum and inverse views,
attribute writes and the coalescer of the JAX executor are not ported
yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np
import torch

from pilosa_tpu_torch.cluster.topology import Cluster, Node
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.fragment import TopOptions
from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD
from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.net.client import is_node_failure
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
    ):
        self.holder = holder
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
            results.append(self._execute_call(index, call, slices, opt))
        return results

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

    def _execute_bitmap_call(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> RowBitmap:
        """reference: executor.go:203-261"""
        expr, leaves = plan.decompose(c)

        def map_fn(local_slices: list[int]) -> RowBitmap:
            out = RowBitmap(self.holder.device)
            stacks, kept = self.leaf_stacks(index, leaves, local_slices)
            if kept:
                rows = plan.eval_expr(expr, stacks)
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
        expr, leaves = plan.decompose(c.children[0])

        def map_fn(local_slices: list[int]) -> int:
            stacks, kept = self.leaf_stacks(index, leaves, local_slices)
            if not kept:
                return 0
            return int(plan.count_rows(expr, stacks).sum(dtype=torch.int64))

        n = self._map_reduce(
            index, slices, c, opt, map_fn, lambda prev, v: (prev or 0) + v
        )
        return int(n or 0)

    # ------------------------------------------------------------------
    # TopN (reference: executor.go:281-415) — two-phase
    # ------------------------------------------------------------------

    def _execute_topn(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> list[Pair]:
        ids_arg = _uint_slice_arg(c, "ids")
        n = _uint_arg(c, "n")[0]
        pairs = self._execute_topn_slices(index, c, slices, opt)
        # Phase 2 runs on the coordinating node only (reference:
        # executor.go:301-321).
        if not pairs or ids_arg or opt.remote:
            return pairs
        # With one slice the phase-1 scores are already exact.
        if len(slices) <= 1:
            return pairs[:n] if n and n < len(pairs) else pairs
        # Phase 2: exact counts for the phase-1 winner union (reference:
        # executor.go:301-321).
        other = c.clone()
        other.args["ids"] = sorted({p.id for p in pairs})
        trimmed = self._execute_topn_slices(index, other, slices, opt)
        if n and n < len(trimmed):
            trimmed = trimmed[:n]
        return trimmed

    def _execute_topn_slices(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> list[Pair]:
        pairs = self._map_reduce(
            index,
            slices,
            c,
            opt,
            lambda local: self._topn_local(index, c, local),
            # A remote leg without pairs arrives as an empty QueryResult,
            # which decodes as 0: it adds no pairs.
            lambda prev, v: cache_mod.add_pairs(prev or [], v or []),
        )
        return cache_mod.sort_pairs(pairs or [])

    def _topn_local(self, index: str, c: Call, slices: list[int]) -> list[Pair]:
        """TopN over this node's fragments among ``slices``: per-fragment
        candidates, summed by id (ascending id order)."""
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
                src = RowBitmap(self.holder.device)
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
        return merge_counts_by_id(parts)

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
        """Standard-view writes on every owner of the slice (reference:
        executor.go:679-734,783-840): the local write here when this
        node owns it, a remote leg to each other owner unless this is
        itself a remote leg."""
        view = c.args.get("view", "") or ""
        f, row_id, col_id = self._resolve_write(index, c, verb)
        if view == VIEW_INVERSE or (view == "" and f.inverse_enabled):
            raise ExecutorError("inverse views are not supported by this port yet")
        if view not in ("", VIEW_STANDARD):
            raise ExecutorError(f"invalid view: {view}")
        slice_i = col_id // bp.SLICE_WIDTH
        targets = self.cluster.fragment_nodes(index, slice_i) or [Node(host=self.host)]
        ret = False
        for node in targets:
            if node.host == self.host:
                ret = write_fn(f, row_id, col_id) or ret
            elif not opt.remote:
                res = self._exec_remote(node, index, Query(calls=[c]), None)
                ret = bool(res and res[0]) or ret
        return ret

    def _execute_set_bit(self, index: str, c: Call, opt: ExecOptions) -> bool:
        if isinstance(c.args.get("timestamp"), str):
            raise ExecutorError("time-quantum views are not supported by this port yet")
        return self._write(
            index, c, "SetBit", lambda f, r, col: f.set_bit(VIEW_STANDARD, r, col), opt
        )

    def _execute_clear_bit(self, index: str, c: Call, opt: ExecOptions) -> bool:
        return self._write(
            index, c, "ClearBit", lambda f, r, col: f.clear_bit(VIEW_STANDARD, r, col), opt
        )

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
