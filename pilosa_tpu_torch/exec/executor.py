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
all the fragments with queued writes (``apply_pending_many``: the batch
build, the leaf stacks, the anchored Count, the TopN prepares).

A Count or Bitmap over a bitmap tree (Bitmap and time-quantum ``Range``
leaves under Intersect/Union/Difference/Xor) runs as in a JAX node
(``executor.py:1030-1160,1439-1609,1804-1974``): a Count whose tree has
an anchor (a leaf that bounds the result) and a compressed leaf counts
first in the position domain, one launch of the anchored count K5 over
every local slice; otherwise the tree's cached batch — a row-address
table over the slices where some leaf row exists (``_cached_batch``):
each leaf row a row of its fragment's mirror read in place, a sparse-tier
row or a union of time views a scratch row the entry owns (filled by one
payload-expansion K6 launch and ORs at build), an absent row one shared
zero row — goes to the coalescer (``exec/coalesce.py``), which launches
the fused tree eval K2 for it and for every concurrent query of its
tree, or the interpreter K3 for a mix of trees; without a coalescer, one
K2 launch.  An entry is checked in O(1) against the write and mirror
epochs, and after any change against every fragment's (serial, version,
mirror generation); entries are residency-pool tenants (``"cache"``).

A tree with a BSI node takes the same route (JAX
``executor.py:1037-1060``): BSI ``Range`` comparisons and
``Sum``/``Min``/``Max`` are rewritten as in the JAX package
(``_rewrite_bsi``) into nodes over the field's plane leaves, and the
tree's cached batch holds the planes as rows of the field fragments'
mirrors, each predicate as a packed row, and the field's
``bsi_ripple.FieldPlanes`` (its address table checked and uploaded once),
so a repeated query builds nothing on the host.  The coalescer launches
a BSI tree per key, never in a fused K3 launch (``coalesce.py``): the
ripple kernel K8 over the cached FieldPlanes, a row leaf's rows copied
out of the table by one K2 launch, the folds as torch ops and a Count's
last fold one fused popcount K1 launch (exec/plan.py).  TopN prepares every local fragment's candidates first and scores
them all in one launch of the cross-fragment scorer K4
(``ops/score_planes.py``) with one fetch per node and phase, through the
coalescer's fetch lane (``_shared_fetch``); on one node both phases come
from one scoring pass (the folded TopN, JAX ``executor.py:2611-2851``),
whose prep is cached per query and slice list and checked like a batch
entry, its scores fetched once per entry by one leader while identical
concurrent TopNs wait (``_topn_folded_entry``).  A TopN's src tree keeps
the eager route (``leaf_stacks``): it is evaluated once per prep entry.

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

Attribute writes (JAX ``executor.py:3139-3218``): ``SetRowAttrs`` and
``SetColumnAttrs`` write the frame's row or the index's column attribute
store and then reach every other node as the same query with ``Remote``
set; a query made only of ``SetRowAttrs`` writes each frame's rows in one
bulk call.

Observability (JAX ``executor.py:543-3446``): with a tracer, a query's
trace gets ``call.<name>``, ``prefetch``, ``plan``, ``exec.device``,
``coalesce`` (and ``fuse``), ``topn.*``, ``ingest`` and ``rpc.execute``
spans (the rpc span's ids travel to the peer, whose spans come back into
this trace); every kernel launch site records into the launch telemetry
(``obs/perf.py``) under the JAX site names — ``direct``, ``total``,
``topn``, ``anchored`` here, ``coalesce``, ``interp`` and ``fetch`` in the
coalescer — timed from before the launch to the end of the host copy that
already waits for its result; no site adds a synchronize.  Map legs run on
the executor's pool inside a copy of the submitting context, so their
spans join the query's trace.

Device health (JAX ``executor.py:1325-1390``): every launch site of a
read — the Count, Bitmap and BSI aggregate routes and the TopN scorer —
first asks the card's breaker (``device/health.py``).  A quarantined card
answers from the host planes (``exec/hosteval.py``, byte for byte) before
any batch is built, so those routes launch nothing, and the TopN src tree
is evaluated on the host; the TopN prep still applies queued writes to
the mirrors it reads (K7), as the JAX prep does.  A launch that fails
with a device fault (``health.classify``; any other exception re-raises)
is retried once when it was a transient ``error``, counted against the
breaker, and answered from the host; a coalesced waiter fails over on its
own.  The anchored K5 Count runs only on a healthy card: a half-open
probe goes through the guarded batch launch.  Writes during a quarantine
queue on the host as ever, and the first read after the heal applies
them.  Coordinators prefer a replica whose card is not quarantined
(``_slices_by_node``).

Replication (JAX ``executor.py:525-550, 3100-3122, 3200-3470``): with a
``replication`` (``replicate/quorum.py``, wired by the server) a write goes
to the slice's write owners — both rings during a resize — through
``Replication.coordinate_write`` (W-of-N at the request's
``write_consistency``, hints for the owners it cannot reach, a loud
failure under W), and a read at ``read_consistency`` quorum or all first
checks the touched slices' replica versions and repairs any that
diverged, under a ``replicate.read`` span.  Routing is epoch-guarded (a
ring that changes under a query fails it with ``MixedEpochError``) and
covers the new ring's nodes during a resize (``Cluster.route_nodes``);
the query's deadline (``net/resilience.py``) bounds every wait for a map
leg, and a read leg to a peer may retry, a write leg never.  With
``allow_partial`` a read whose slices lost every replica answers over the
others and lists the lost ones in ``missing_slices``.
"""

from __future__ import annotations

import contextvars
import functools
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass, field, replace
from datetime import datetime

import numpy as np
import torch

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.bsi import ripple
from pilosa_tpu_torch.cluster.topology import Cluster, MixedEpochError, Node
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core import timequantum as tq
from pilosa_tpu_torch.core import fragment as fragment_mod
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.fragment import Fragment, SubRef, TopOptions, apply_pending_many
from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD
from pilosa_tpu_torch.device import health as health_mod
from pilosa_tpu_torch.exec import coalesce as coalesce_mod
from pilosa_tpu_torch.exec import hosteval as hosteval_mod
from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.net import resilience
from pilosa_tpu_torch.net.resilience import is_node_failure
from pilosa_tpu_torch.obs import perf as perf_mod
from pilosa_tpu_torch.obs import trace
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.ops import bsi_ripple, expand_payload, score_planes
from pilosa_tpu_torch.ops.tree_eval import RowTable, ShardedTable
from pilosa_tpu_torch.pql.parser import TIME_FORMAT, Call, Query
from pilosa_tpu_torch.testing import faults

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
    of another node's query — run it on the local slices only.
    ``write_consistency`` / ``read_consistency``: the request's levels
    (one, quorum, all), "" for the server's defaults; ignored without a
    replication."""

    remote: bool = False
    write_consistency: str = ""
    read_consistency: str = ""
    # Answer over the surviving slices when every replica of some slice
    # is down, listing the lost ones in ``missing_slices`` (filled by
    # _map_reduce, sorted) instead of failing the query.
    allow_partial: bool = False
    missing_slices: list[int] = field(default_factory=list)
    # The tenant that sent the query (net/admission.py's registry, set
    # by the handler): forwarded as X-Tenant on every remote leg, so a
    # fan-out is charged to its origin on every node it touches (JAX
    # executor.py:141-147).  A field, not a context variable: map legs
    # run on pool threads.
    tenant: str = ""


class _NoLaunch:
    """A gated leg's answer made without a launch (no slice held a leaf
    row, or a TopN took its scores from the prep cache): the health gate
    records neither a success nor a failure for it."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


@dataclass
class _BatchEntry:
    """A cached batch: a bitmap tree's row-address table over the slices
    ``kept`` (where some leaf row exists; ``empties`` are the others).
    ``refs[b]`` is base ``b`` of the table — the executor's zero row and
    the entry's scratch rows held, each mirror by a weak reference, so
    that an evicted mirror is freed and the entry found stale.  ``index``
    (int64 ``[len(kept), L, 2]``) and ``addrs`` (the row addresses on the
    card, None on the CPU) are ``RowTable``'s.  Valid while the write and
    mirror epochs are ``epoch`` / ``mirror_epoch``, or while
    ``_leaf_versions`` still gives ``versions``."""

    expr: tuple
    kept: list
    empties: list
    refs: list
    index: np.ndarray
    addrs: torch.Tensor | None
    epoch: int
    mirror_epoch: int
    versions: tuple
    # Per-column row identities (the columns' row addresses) for the
    # coalescer's union-leaf sharing.
    leaf_keys: tuple
    # The fragments' mirror pool keys and the entry's own: pinned for every
    # launch that reads the table.
    pin_keys: tuple
    nbytes: int = 0
    # A tree with a BSI node: each leaf's input to the ripple route —
    # ("row",), ("plane", field), ("pred", value) or ("zero",) — and per
    # field the base of its mirror in each kept slice (-1: no fragment),
    # its slots (int64 [kept, 2 + depth]), its bucket and the kernel's
    # address table, checked and uploaded once at the build.
    leaf_inputs: tuple = ()
    fields: tuple = ()

    def table(self) -> RowTable | None:
        """The table with strong references to its bases, or None when a
        mirror it names was freed (the entry is stale).  Checked: the
        build checked the entry's bases and index once."""
        bases = []
        for r in self.refs:
            t = r() if isinstance(r, weakref.ref) else r
            if t is None:
                return None
            bases.append(t)
        return RowTable(bases, self.index, self.addrs, checked=True)


@dataclass
class _MeshEntry:
    """A batch over a mesh (JAX ``executor.py:1084-1140``): one cached
    :class:`_BatchEntry` a member, over the slices homed there (``slice
    mod n``), each with its table (None where the member keeps no slice).
    ``kept`` and ``empties`` are in slice order; the batch's launch order
    is the members' tables in turn, and ``pos_of`` maps a kept slice to
    its position there.  The port pads nothing: each member's table takes
    its own slice count, so no pad slice exists to skip."""

    expr: tuple
    kept: list
    empties: list
    parts: list
    pin_keys: tuple
    leaf_inputs: tuple
    pos_of: dict

    @classmethod
    def of(cls, expr: tuple, parts: list) -> "_MeshEntry":
        kept, empties, pin_keys, pos_of, n = [], [], {}, {}, 0
        for _m, ent, table in parts:
            empties += ent.empties
            pin_keys.update(dict.fromkeys(ent.pin_keys))
            if table is None:
                continue
            for i, s in enumerate(ent.kept):
                pos_of[s] = n + i
            n += len(ent.kept)
            kept += ent.kept
        return cls(expr=expr, kept=sorted(kept), empties=sorted(empties), parts=parts,
                   pin_keys=tuple(pin_keys), leaf_inputs=parts[0][1].leaf_inputs,
                   pos_of=pos_of)

    def live(self) -> list:
        """``(member, entry, table)`` of the members that keep a slice, in
        the batch's launch order."""
        return [p for p in self.parts if p[2] is not None]

    def table(self) -> ShardedTable | None:
        live = self.live()
        if not live:
            return None
        return ShardedTable([m for m, _, _ in live], [t for _, _, t in live],
                            [e.leaf_keys for _, e, _ in live])


@dataclass
class _TopnEntry:
    """A cached folded-TopN prep (JAX ``executor.py:2515-2610``): ``kind``
    is ``"empty"``, ``"two_phase"`` or ``"parts"``; ``parts`` are ``(frag,
    topt, cand_ids, cand_mask, (state, plane ref, slots, src, src slot))``
    per fragment, ``state`` the unscored ``TopState`` every query copies
    and the plane (the fragment's mirror the candidate slots index) held
    by a weak reference, so that an evicted mirror is freed and the entry
    found stale.  ``nbytes`` are the device bytes the entry owns (the
    evaluated src rows), ``device_bytes`` the same by device (on a mesh
    each src row lies on its slice's member).  ``scores`` memoize each
    part's fetched scores (dense, sparse) for as long as the entry holds;
    ``score_event`` is the single flight of the first scoring."""

    key: tuple
    kind: str
    parts: list
    epoch: int
    mirror_epoch: int
    versions: tuple | None
    built_at: float
    nbytes: int = 0
    device_bytes: dict = field(default_factory=dict)
    scores: list | None = None
    score_event: threading.Event | None = None

    @classmethod
    def of(cls, built, key: tuple, epoch: int, mepoch: int, versions) -> "_TopnEntry":
        """The entry of one ``Executor._topn_folded_build`` result."""
        kind = "empty" if built is None else "two_phase" if built == "two_phase" else "parts"
        parts, storages = [], {}
        for frag, topt, cand_ids, cand_mask, (st, sub, src, slot, _) in (
                built if kind == "parts" else ()):
            ref = None if sub is None else weakref.ref(sub.plane)
            if src is not None:
                st_ = src.untyped_storage()
                storages[st_.data_ptr()] = (src.device, st_.nbytes())
            parts.append((frag, topt, cand_ids, cand_mask,
                          (st, ref, None if sub is None else sub.slots, src, slot)))
        device_bytes: dict = {}
        for dev, nb in storages.values():
            device_bytes[dev] = device_bytes.get(dev, 0) + nb
        return cls(key=key, kind=kind, parts=parts, epoch=epoch, mirror_epoch=mepoch,
                   versions=versions, built_at=time.monotonic(),
                   nbytes=sum(device_bytes.values()), device_bytes=device_bytes)

    def query_parts(self) -> list | None:
        """One query's parts — ``(frag, topt, cand_ids, cand_mask, (state,
        SubRef or None, src, src slot, frag))``, each state a fresh copy — or
        None when a mirror the entry names was freed (the entry is
        stale)."""
        out = []
        for frag, topt, cand_ids, cand_mask, (st, ref, slots, src, slot) in self.parts:
            sub = None
            if ref is not None:
                plane = ref()
                if plane is None:
                    return None
                sub = SubRef(plane, slots)
            out.append((frag, topt, cand_ids, cand_mask,
                        (replace(st, counts=None, sparse_cnt=None), sub, src, slot, frag)))
        return out


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
        coalescer=None,
        tracer=None,
        device_health=None,
        replication=None,
    ):
        self.holder = holder
        # Quorum writes and version-checked reads (replicate/quorum.py);
        # None writes to every owner and reads from one.
        self.replication = replication
        # Query-path spans (obs/trace.py); the server wires its tracer.
        self.tracer = tracer or trace.NOP_TRACER
        # The cross-query scheduler (exec/coalesce.py) the Count and Bitmap
        # routes and the TopN score fetch go through; None launches directly.
        self.coalescer = coalescer
        # Background uploads of a query's cold mirrors (device/prefetch.py),
        # and the WAL manager whose group commit a write's answer waits
        # for (ingest/wal.py); None turns either off.
        self.prefetcher = prefetcher
        self.ingest = ingest
        self.max_writes_per_request = max_writes_per_request
        self.cluster = cluster if cluster is not None else Cluster()
        self.host = host
        self.client_factory = client_factory
        # The card's breaker (device/health.py): every launch site of the
        # query path asks it first, and a failed launch drives it.  The
        # server wires its own (shared with /debug/health); a bare
        # executor builds and owns a default one (JAX executor.py:352).
        self._owns_health = device_health is None
        self.device_health = device_health or health_mod.DeviceHealth(
            stats=getattr(holder, "stats", None), device=getattr(holder, "placed", None)
        )
        # What answers while the card is quarantined or a launch failed:
        # the host planes, byte for byte (exec/hosteval.py).
        self.hosteval = hosteval_mod.HostEvaluator(self)
        self._zero_rows: dict[torch.device, torch.Tensor] = {}
        self._zero_mu = threading.Lock()
        # (value, bucket, device) -> a packed BSI predicate row on the device.
        self._pred_rows: dict = {}
        # Map legs to peers; threads start at the first submit.
        self._pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="map")
        self._slice_groups: OrderedDict = OrderedDict()
        self._groups_mu = threading.Lock()
        # Cached batches per (index, call, slice list); see _cached_batch.
        self._batch_cache: OrderedDict[tuple, _BatchEntry] = OrderedDict()
        self._batch_mu = threading.Lock()
        # Folded-TopN prep entries per (index, canonical call, slice list);
        # see _topn_folded_entry.  Guarded by _batch_mu.
        self._topn_cache: OrderedDict[tuple, _TopnEntry] = OrderedDict()
        # Keys being built, each with the event its other queries wait on.
        self._topn_building: dict[tuple, threading.Event] = {}
        # A fragment leaving service drops the TopN entries that hold it
        # now, not at displacement (JAX executor.py:390-393).
        fragment_mod.register_close_listener(self._drop_closed_fragment)

    def close(self) -> None:
        fragment_mod.unregister_close_listener(self._drop_closed_fragment)
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._owns_health:
            self.device_health.close()
        # A closed executor's entries stop counting as resident.
        with self._batch_mu:
            keys = list(self._batch_cache)
            self._batch_cache.clear()
            topn_keys = list(self._topn_cache)
            self._topn_cache.clear()
        pool = device_mod.pool()
        for k in keys:
            pool.remove(self._batch_pool_key(k))
        self._drop_topn_keys(topn_keys)

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
        # The cost-class mix the executor saw (JAX executor.py:511-523),
        # tagged with the tenant where QoS resolved one.
        class_tags = [f"class:{plan.cost_class(q.calls)}"]
        if opt.tenant:
            class_tags.append(f"tenant:{opt.tenant}")
        self.holder.stats.count_with_custom_tags("exec.class", 1, class_tags)
        # Bulk attribute-insert path (reference: executor.go:119-122).
        if q.calls and all(c.name == "SetRowAttrs" for c in q.calls):
            return self._execute_bulk_set_row_attrs(index, q.calls, opt)
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
        # Version-checked replica reads: at read consistency quorum or all
        # the touched slices' replica versions must agree before the
        # query runs, and a slice that diverged is repaired first (read
        # your writes at W + R > N).  Level one costs nothing here.
        if (
            self.replication is not None
            and not opt.remote
            and slices
            and any(c.name not in WRITE_CALLS for c in q.calls)
        ):
            level = self.replication.read_consistency_for(opt)
            if level != "one":
                with self.tracer.span("replicate.read", consistency=level) as sp:
                    repaired = self.replication.ensure_read_consistency(index, slices, level)
                    sp.annotate(repaired=repaired)
        # No uploads to a quarantined card: the heal stages the mirrors.
        if self.prefetcher is not None and slices and not self.device_health.denied():
            self._prefetch_query(index, q.calls, slices)
        results = []
        for call in q.calls:
            # A multi-call query whose budget ran out fails before the
            # next call's fan-out.
            resilience.check_deadline(f"before call {call.name}")
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
            with self.tracer.span(f"call.{call.name}", index=index):
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
            have = view.fragment_map()
            for s in slices:
                frag = have.get(s)
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
            with self.tracer.span("prefetch", fragments=len(frags)):
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
        if name == "SetRowAttrs":
            self._execute_set_row_attrs(index, c, opt)
            return None
        if name == "SetColumnAttrs":
            self._execute_set_column_attrs(index, c, opt)
            return None
        # Read calls count per call name with the index tag (reference:
        # executor.go:163-181).
        self.holder.stats.count_with_custom_tags(name, 1, [f"index:{index}"])
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

    def _stack_rows(self, sources: list[list], device: torch.device
                    ) -> tuple[torch.Tensor, list, list]:
        """One row leaf's int32 [n, 32768] stack over the kept slices
        from each slice's row sources: plane rows copied in one stack,
        every compressed row returned as a K6 job writing its stack row
        (or, in a union of several views, a scratch row OR-ed in after
        the launch — ``(stack, i, rows)`` in the second list)."""
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
        self, index: str, leaves: list[Call], slices: list[int],
        device: torch.device | None = None,
    ) -> tuple[list, list[int]]:
        """The plan's inputs for every leaf over the slices where at least
        one leaf row exists (elsewhere every tree is empty): ``(inputs,
        kept)``.  A row leaf becomes an int32 [len(kept), 32768] stack of
        mirror rows (an absent row is a zero row), its sparse-tier rows
        expanded in place by one K6 launch for the whole call; every BSI plane leaf of
        a field the field's one ``bsi_ripple.FieldPlanes`` — its fragments'
        mirrors and the rows of exists, sign and each magnitude bit in
        them, read in place by the ripple kernel; a predicate a
        ``plan.PredLeaf``; a pad plane None.  ``device`` is where the
        slices' mirrors live (default the holder's): on a mesh, the caller
        passes one member's slices and its device."""
        device = self.holder.device if device is None else device
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
                bsi.pad_depth(len(prows) - 2), device,
            )
            for key, (_, prows) in fields.items()
        }
        stacks, jobs, unions = {}, [], []
        for j, srcs in rows.items():
            stacks[j], leaf_jobs, leaf_unions = self._stack_rows(srcs, device)
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

    @staticmethod
    def _views_row_host(views: list, row_id: int, slice_i: int):
        """The union of the row over ``views`` in one slice, from the
        host planes: uint32 words, or None when no view has the row."""
        acc = None
        for view in views:
            frag = view.fragment(slice_i) if view is not None else None
            row = frag.row_words_host(row_id) if frag is not None else None
            if row is not None:
                acc = row if acc is None else (acc | row)
        return acc

    def _leaf_row_host(self, index: str, c: Call, slice_i: int, target: tuple | None = None):
        """Host (numpy) variant of one leaf's row in one slice (JAX
        ``executor.py:907,928``): uint32 words, or None when the row has no
        bits — a time Range leaf's the union over its views.  ``target`` is
        the leaf's ``_leaf_targets`` entry, resolved once by a caller that
        walks many slices."""
        kind, views, row_id, ctx = target or self._leaf_targets(index, [c])[0]
        if kind == "pred":
            return bsi.pred_row(row_id, ctx[2])
        if kind == "zero":
            return None
        return self._views_row_host(views, row_id, slice_i)

    def _eval_tree_slices_host(self, index: str, c: Call, slices: list[int]) -> dict:
        """HOST (numpy) evaluation of a bitmap tree per slice (JAX
        ``executor.py:1612``): ``{slice: uint32 words or None}``; reads the
        host planes only."""
        expr, leaves = plan.decompose(self._rewrite_bsi(index, c))
        targets = self._leaf_targets(index, leaves)
        return {
            s: plan.eval_expr_np(expr, [self._leaf_row_host(index, leaf, s, t)
                                        for leaf, t in zip(leaves, targets)],
                                 bp.WORDS_PER_SLICE)
            for s in slices
        }

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
        rc = self._rewrite_bsi(index, c)
        expr, leaves = plan.decompose(rc)

        def map_fn(local_slices: list[int]) -> RowBitmap:
            out = RowBitmap(self.holder.device)
            kept, rows = self._eval_tree_slices(index, rc, expr, leaves, local_slices)
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
        child = self._rewrite_bsi(index, c.children[0])
        expr, leaves = plan.decompose(child)

        def map_fn(local_slices: list[int]) -> int:
            return self._count_slices_total(index, child, expr, leaves, local_slices)

        n = self._map_reduce(
            index, slices, c, opt, map_fn, lambda prev, v: (prev or 0) + v
        )
        return int(n or 0)

    def _count_slices_total(self, index: str, c: Call, expr: tuple, leaves: list[Call],
                            slices: list[int]) -> int:
        """Count(tree) over local slices, in the JAX order
        (``executor.py:1804``): the anchored K5 Count first, then the
        cached batch through the coalescer ("count" partials, summed
        here in int64), else one direct K2 launch with the "total"
        reduce.  All of it runs under the health gate: a quarantined
        card has the host planes answer, and no batch is built (its
        build would launch K7 and K6)."""
        if not slices or not leaves:
            return 0
        got: list = []

        def launch(mode: str, retry: bool = False):
            if not got:
                if mode == health_mod.MODE_OK and not retry:
                    # A granted probe must resolve through a fault-checked
                    # launch.
                    anchored = self._try_anchored_count(index, expr, leaves, slices)
                    if anchored is not None:
                        return anchored
                got.append(self._cached_batch(index, c, expr, leaves, slices))
            ent, table = got[0]
            if table is None:
                return _NoLaunch(0)
            with device_mod.pool().pinned(*ent.pin_keys):
                if isinstance(ent, _MeshEntry):
                    return self._mesh_count(ent, table, retry)
                if self.coalescer is not None and not retry:
                    res = self._coalesce_eval(ent, table, "count")
                    if res is not None:
                        return int(np.asarray(res).sum(dtype=np.int64))
                with self._device_span("total"):
                    self._fault_check_launch("direct")
                    t0 = time.monotonic()
                    out = self._direct_eval(ent, table, "total")
                    t_disp = time.monotonic()
                    n = int(out.cpu()[0])
                    self._record_direct_launch(table, "total", t0, t_disp, time.monotonic(),
                                               "total")
                return n

        return self._launch_guarded(
            launch, retry_fn=functools.partial(launch, retry=True),
            host_fn=lambda: self.hosteval.count_total(index, c, self._host_slices(got, slices)))

    def count_slices(self, index: str, c: Call, slices: list[int]) -> dict[int, int]:
        """``{slice: Count(c)}`` over local ``slices``, 0 where no leaf row
        exists: K2's "count" reduce (int32 ``[S]``) over a batch built for
        this call and not cached (the standing-query engine asks for a
        different slice list at every notify batch), one direct launch a
        member, under the health gate like every Count — a quarantined
        card has the host evaluator answer.  The subscribe engine's slice
        and full evaluations read it."""
        child = self._rewrite_bsi(index, c)
        expr, leaves = plan.decompose(child)
        out = dict.fromkeys(slices, 0)
        if not slices or not leaves:
            return out
        got: list = []

        def launch(mode: str, retry: bool = False):
            if not got:
                got.append(self._cached_batch(index, child, expr, leaves, slices, cache=False))
            ent, table = got[0]
            if table is None:
                return _NoLaunch(out)
            with device_mod.pool().pinned(*ent.pin_keys), self._device_span("count"):
                self._fault_check_launch("direct")
                t0 = time.monotonic()
                if isinstance(ent, _MeshEntry):
                    parts = [self._direct_eval(pe, t, "count") for _m, pe, t in ent.live()]
                    t_disp = time.monotonic()
                    flat = np.concatenate([p.cpu().numpy() for p in parts])
                    counts = [flat[ent.pos_of[s]] for s in ent.kept]
                else:
                    res = self._direct_eval(ent, table, "count")
                    t_disp = time.monotonic()
                    counts = res.cpu().numpy()
                self._record_direct_launch(table, "count", t0, t_disp, time.monotonic())
            return {**out, **{s: int(n) for s, n in zip(ent.kept, counts)}}

        return self._launch_guarded(
            launch, retry_fn=functools.partial(launch, retry=True),
            host_fn=lambda: {**out, **self.hosteval.counts(index, c, self._host_slices(got, slices))})

    def _eval_tree_slices(self, index: str, c: Call, expr: tuple, leaves: list[Call],
                          slices: list[int]):
        """``(kept, rows)``: a bitmap tree's result rows over the local
        slices where some leaf row exists (JAX ``executor.py:1521``) —
        the cached batch through the coalescer, else one direct K2
        launch; ``rows[i]`` is slice ``kept[i]``'s.  From the host, the
        slices with a non-empty result and their rows on the CPU."""
        if not slices or not leaves:
            return [], None
        got: list = []

        def launch(mode: str, retry: bool = False):
            if not got:
                got.append(self._cached_batch(index, c, expr, leaves, slices))
            ent, table = got[0]
            if table is None:
                return _NoLaunch(([], None))
            with device_mod.pool().pinned(*ent.pin_keys):
                if isinstance(ent, _MeshEntry):
                    return ent.kept, self._mesh_rows(ent, table, retry)
                if self.coalescer is not None and not retry:
                    res = self._coalesce_eval(ent, table, "row")
                    if res is not None:
                        return ent.kept, res
                with self._device_span("row"):
                    self._fault_check_launch("direct")
                    t0 = time.monotonic()
                    out = self._direct_eval(ent, table, "row")
                    # The result rows stay on the card: nothing waits for
                    # the launch here, so its time is not observed
                    # (total_ms 0).
                    self._record_direct_launch(table, "row", t0, time.monotonic(), t0)
                return ent.kept, out

        return self._launch_guarded(
            launch, retry_fn=functools.partial(launch, retry=True),
            host_fn=lambda: self._host_rows(index, c, self._host_slices(got, slices)))

    def _mesh_count(self, ent: _MeshEntry, table: ShardedTable, retry: bool) -> int:
        """Count(tree) over a mesh batch (JAX ``executor.py:1804-1935``).
        Within the partial budget, and while the ``collective`` path is
        admitted, the cross-member reduce is the collective: through the
        coalescer, a "total" drain (one K2 or fused K3 launch a member,
        summed under the collective watchdog); directly, one K2 "total"
        launch a member and the int64 sum in a body that
        ``DeviceHealth.run_collective`` watches, with the ``collective``
        fault check point inside it.  A trip or a quarantine, or a batch
        past the budget, takes the per-member "count" partials, summed on
        the host in int64."""
        health = self.device_health
        fits = len(ent.kept) <= plan.MAX_ONDEVICE_COUNT_PARTIALS
        degraded = (health_mod.LaunchWatchdogTimeout, health_mod.CollectiveUnavailable)
        if self.coalescer is not None and not retry:
            if fits and health.collective_allowed():
                try:
                    res = self._coalesce_eval(ent, table, "total")
                except degraded:
                    self._note_collective_fallback()
                else:
                    if res is not None:
                        return int(res)
            res = self._coalesce_eval(ent, table, "count")
            if res is not None:
                return int(np.asarray(res).sum(dtype=np.int64))
        live = ent.live()
        with self._device_span("total"):
            self._fault_check_launch("direct")
            if fits and health.collective_allowed():
                def body():
                    self._fault_check_launch("collective")
                    t0 = time.monotonic()
                    n = plan.total_count(live, lambda m: self._direct_eval(m[1], m[2], "total"))
                    t1 = time.monotonic()
                    self._record_direct_launch(table, "total", t0, t1, t1, "collective")
                    return n

                try:
                    return plan.run_collective(body, health)
                except degraded:
                    self._note_collective_fallback()
            t0 = time.monotonic()
            outs = [self._direct_eval(pe, t, "count") for _m, pe, t in live]
            t_disp = time.monotonic()
            n = int(sum(int(o.cpu().sum(dtype=torch.int64)) for o in outs))
            self._record_direct_launch(table, "count", t0, t_disp, time.monotonic())
        return n

    def _note_collective_fallback(self) -> None:
        self.holder.stats.count("device.collective.fallbacks")
        plan.note_collective_fallback()

    def _mesh_rows(self, ent: _MeshEntry, table: ShardedTable, retry: bool) -> list:
        """A mesh batch's result rows, one K2 "row" launch a member
        (through the coalescer, or directly), merged in slice order:
        ``rows[i]`` is slice ``ent.kept[i]``'s row, on its member's
        device."""
        per = None
        if self.coalescer is not None and not retry:
            per = self._coalesce_eval(ent, table, "row")
        if per is None:
            with self._device_span("row"):
                self._fault_check_launch("direct")
                t0 = time.monotonic()
                per = [self._direct_eval(pe, t, "row") for _m, pe, t in ent.live()]
                self._record_direct_launch(table, "row", t0, time.monotonic(), t0)
        flat = [r for rows in per for r in rows]
        return [flat[ent.pos_of[s]] for s in ent.kept]

    @staticmethod
    def _host_slices(got: list, slices: list[int]) -> list[int]:
        """The slices a host answer walks: the batch's kept ones when the
        batch was built before the launch failed, else all of them (the
        others hold no leaf row, so the answer is the same)."""
        return got[0][0].kept if got else slices

    def _host_rows(self, index: str, c: Call, slices: list[int]):
        """The "row" answer of ``_eval_tree_slices`` from the host
        evaluator: the slices with a non-empty result and their rows as
        CPU tensors."""
        rows = {s: r for s, r in self.hosteval.rows(index, c, slices).items() if r is not None}
        return list(rows), [torch.from_numpy(r.view(np.int32)) for r in rows.values()]

    def _fault_check_launch(self, site: str) -> None:
        """Chaos hook at a launch site (testing/faults.py), fired once per
        participating device so a rule can target one device (JAX
        ``executor.py:1325``).  The exception is annotated with the
        matched ordinal, letting the health layer narrow the blame to
        that device's path."""
        host = self.host or None
        for i in range(len(self.device_health.device_paths())):
            try:
                faults.check("device.launch", host=host, path=site, device=i)
            except Exception as e:
                if getattr(e, "fault_device", None) is None:
                    try:
                        e.fault_device = i
                    except Exception:  # noqa: BLE001 — slots-only exceptions
                        pass
                raise

    def _launch_guarded(self, device_fn, retry_fn, host_fn):
        """Run one query leg's card work under the health gate (JAX
        ``executor.py:1345``).  Admission first: a denied card answers
        through ``host_fn`` (the host evaluator, byte for byte) and the
        leg touches no card.  Otherwise ``device_fn(mode)`` runs all of
        the leg's card work — its preparation (queued writes, uploads,
        batch tables) as well as its launch — so a failure anywhere in it
        is classified (``health.classify``): a device fault is retried
        ONCE through ``retry_fn(mode)`` when it is an ``error`` and not a
        probe, drives the breaker, and has ``host_fn`` answer; anything
        else re-raises unchanged, after releasing a granted probe, so
        that a broken kernel fails its query loudly and never leaves the
        node on the host.  A result wrapped in :class:`_NoLaunch` made no
        launch: it resolves neither way (a probe is released)."""
        health = self.device_health
        paths = health.device_paths()
        mode = health.acquire(paths)
        if mode == health_mod.MODE_DENY:
            return host_fn()
        probe = mode == health_mod.MODE_PROBE

        def run(fn):
            try:
                return fn(mode), None
            except Exception as e:
                kind = health_mod.classify(e)
                if kind is None:
                    if probe:
                        health.cancel_probe(paths)
                    raise
                return None, (kind, getattr(e, "fault_device", None))

        res, fault = run(device_fn)
        if fault is not None and fault[0] == health_mod.KIND_ERROR and not probe \
                and retry_fn is not None:
            # One glitch must not start the quarantine clock.
            self.holder.stats.count("device.launch.retries")
            res, again = run(retry_fn)
            if again is not None:
                fault = (again[0], again[1] if again[1] is not None else fault[1])
            else:
                fault = None
        if fault is not None:
            health.failure(paths, fault[0], probe=probe, device=fault[1])
            return host_fn()
        if isinstance(res, _NoLaunch):
            if probe:
                health.cancel_probe(paths)
            return res.value
        health.success(paths, probe=probe)
        return res

    def _device_span(self, reduce: str):
        """The ``exec.device`` span of a direct launch (JAX
        ``executor.py:1402``).  The port builds each kernel once per
        process, so every launch is warm."""
        return self.tracer.span("exec.device", reduce=reduce, warm=True)

    @staticmethod
    def _record_direct_launch(table: RowTable, reduce: str, t0, t_disp, t1,
                              site: str = "direct") -> None:
        """Launch telemetry of an uncoalesced K2 launch (JAX
        ``executor.py:1408``): the table's slices x leaves x words."""
        if not perf_mod.enabled():
            return
        rows, leaves, words = table.shape
        perf_mod.record_launch(
            site,
            reduce=reduce,
            rows=rows,
            n_bytes=perf_mod.plane_bytes(rows, leaves * words),
            dispatch_ms=(t_disp - t0) * 1e3,
            total_ms=(t1 - t0) * 1e3,
            trace_id=perf_mod.current_trace_id(),
        )

    def _coalesce_eval(self, ent: _BatchEntry, table: RowTable, reduce: str):
        """One cached batch through the coalescing scheduler (JAX
        ``executor.py:1439``): this entry's part of the shared launch, or
        None when the scheduler is closed (the caller launches directly).
        The caller's pin lease stays open until the future resolves.  A
        waiter that times out detaches; the launch still serves the
        others."""
        # Chaos hook: an injected fault here surfaces as a coalesced launch
        # error would — the waiter's guard classifies it and fails over on
        # its own, never poisoning the shared launch (JAX executor.py:1450).
        self._fault_check_launch("coalesce")
        with self.tracer.span("coalesce", reduce=reduce, warm=True) as sp:
            if isinstance(ent, _MeshEntry):
                sub = dict(
                    leaf_keys=None,
                    direct=[functools.partial(self._direct_eval, pe, t)
                            for _m, pe, t in ent.live()] if ent.leaf_inputs else None,
                    check=functools.partial(self._fault_check_launch, "collective"))
            else:
                sub = dict(leaf_keys=ent.leaf_keys,
                           direct=functools.partial(self._direct_eval, ent, table)
                           if ent.leaf_inputs else None)
            try:
                fut = self.coalescer.submit(ent.expr, reduce, table, **sub)
            except coalesce_mod.CoalesceClosed:
                sp.annotate(fallback="closed")
                return None
            res, info = self._wait_shared(fut, sp, "coalesced launch")
            sp.annotate(**info)
            if info.get("fused"):
                # This query rode a multi-query interpreter launch: its
                # composition lands in the trace (JAX executor.py:1503).
                keys = ("batch_queries", "programs", "ops", "dedup_hits", "batch_rows",
                        "pad_leaves")
                with self.tracer.span("fuse", **{k: info[k] for k in keys if k in info}):
                    pass
        return res

    def _shared_fetch(self, arrays: list) -> list:
        """Device tensors to host numpy arrays, the blocking copy shared
        with other queries' concurrent fetches through the coalescer's
        fetch lane (JAX ``executor.py:2391``); a direct copy without a
        coalescer or when it is closed."""
        co = self.coalescer
        if co is not None:
            try:
                fut = co.submit_fetch(arrays)
            except coalesce_mod.CoalesceClosed:
                fut = None
            if fut is not None:
                res, _info = self._wait_shared(fut, None, "shared fetch")
                return res
        return [a.cpu().numpy() for a in arrays]

    def _wait_shared(self, fut, sp, what: str):
        """Wait for a shared launch or fetch within the query's deadline
        (JAX ``executor.py:1471-1495``), else ``RESULT_TIMEOUT_S``.  A
        waiter that times out detaches: the launch is not cancelled and
        goes on serving the others, and a late error of it is counted,
        not left unread.  An expired deadline raises DeadlineExceeded."""
        timeout = coalesce_mod.RESULT_TIMEOUT_S
        dl = resilience.current_deadline()
        if dl is not None:
            timeout = dl.clamp(timeout)
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeoutError:
            if sp is not None:
                sp.annotate(deadline="expired")
            fut.add_done_callback(coalesce_mod.consume_abandoned(self.holder.stats))
            if dl is not None and dl.expired:
                raise resilience.DeadlineExceeded(f"deadline expired waiting for {what}") from None
            raise

    # ------------------------------------------------------------------
    # the batch cache (JAX executor.py:1022-1309)
    # ------------------------------------------------------------------

    # Cached batches, most recent last.  An entry names mirror rows in place
    # and owns only its scratch rows and its table, so many fit; under a
    # budget the residency pool's LRU evicts them like any tenant.
    _BATCH_CACHE_CAP = 64

    def _batch_pool_key(self, key: tuple) -> tuple:
        return ("exec", id(self), "batch", key)

    def _evict_batch_key(self, key: tuple) -> bool:
        """The pool's eviction hook for an entry.  Non-blocking: the pool
        calls it under its own lock while request threads may hold
        ``_batch_mu``; a busy cache is skipped."""
        if not self._batch_mu.acquire(blocking=False):
            return False
        try:
            self._batch_cache.pop(key, None)
            return True
        finally:
            self._batch_mu.release()

    def _cached_batch(self, index: str, c: Call, expr: tuple, leaves: list[Call],
                      slices: list[int], cache: bool = True
                      ) -> tuple[_BatchEntry, RowTable | None]:
        """The tree's batch over ``slices`` and a table of it holding its
        rows (None when no slice has a leaf row), cached across queries
        per (index, call, slice list).  A hit costs O(1) while no
        fragment changed and no mirror moved anywhere; otherwise every
        fragment's (serial, version, mirror generation) must still be the
        entry's.  A build applies every queued write first (one K7).
        With ``cache`` False the batch is built for this call alone and
        neither read from nor kept in the cache.

        On a mesh (more than one member in ``bitplane.placement`` of the
        holder's device) the batch is a :class:`_MeshEntry` and its table
        a ``ShardedTable``: the slices group by home member and each group
        is its own cached entry, built over the mirrors homed there and
        keyed by the member's place in the layout, so a node whose member
        layout changed never reuses a table built for the old one."""
        members = bp.placement(self.holder.placed)
        with self.tracer.span("plan", slices=len(slices)) as sp:
            if len(members) < 2:
                return self._cached_batch_lookup(index, c, expr, leaves, slices, sp,
                                                 (0, 1, members[0]), cache)
            sp.annotate(members=len(members))
            n = len(members)
            parts = []
            for m, group in bp.group_by_member(slices, n).items():
                ent, table = self._cached_batch_lookup(index, c, expr, leaves, group, sp,
                                                       (m, n, members[m]), cache)
                parts.append((m, ent, table))
            ent = _MeshEntry.of(expr, parts)
            return ent, ent.table()

    def _cached_batch_lookup(self, index, c, expr, leaves, slices, sp, member: tuple,
                             cache: bool = True):
        """One member's entry (``member`` = (index, members, device)) over
        the slices homed there: the whole batch on one device."""
        device = member[2]
        key = (index, str(c), tuple(slices), (member[0], member[1], str(device)))
        if not cache:
            sp.annotate(batch_cache="off")
            return self._cached_batch_build(index, key, expr, leaves, slices, device)
        with self._batch_mu:
            ent = self._batch_cache.get(key)
        if ent is not None:
            epoch, mepoch = fragment_mod.write_epoch(), fragment_mod.mirror_epoch()
            table = ent.table() if ent.kept else None
            fresh = ent.epoch == epoch and ent.mirror_epoch == mepoch
            if not fresh and ent.versions == self._leaf_versions(index, leaves, slices):
                ent.epoch, ent.mirror_epoch = epoch, mepoch
                fresh = True
            if fresh and (table is not None or not ent.kept):
                with self._batch_mu:
                    if key in self._batch_cache:
                        self._batch_cache.move_to_end(key)
                device_mod.pool().touch(self._batch_pool_key(key))
                sp.annotate(batch_cache="hit")
                self.holder.stats.count("exec.batch.hit")
                return ent, table
        sp.annotate(batch_cache="miss")
        self.holder.stats.count("exec.batch.build")
        ent, table = self._cached_batch_build(index, key, expr, leaves, slices, device)
        displaced = []
        with self._batch_mu:
            self._batch_cache[key] = ent
            while len(self._batch_cache) > self._BATCH_CACHE_CAP:
                displaced.append(self._batch_cache.popitem(last=False)[0])
        # Pool tenancy outside _batch_mu: an admission may evict other
        # tenants, whose callbacks take _batch_mu non-blocking.
        pool = device_mod.pool()
        for k in displaced:
            pool.remove(self._batch_pool_key(k))
        if ent.nbytes:
            pool.admit(self._batch_pool_key(key), {device: ent.nbytes},
                       functools.partial(self._evict_batch_key, key), category="cache",
                       info={"cache": "batch", "index": index, "query": str(c)})
        return ent, table

    def _leaf_targets(self, index: str, leaves: list[Call]) -> list[tuple]:
        """Each leaf's ``(kind, views, row_id, ctx)``: ``"row"`` for a Bitmap
        or time Range leaf (the union of the row over ``views``),
        ``"plane"`` for a BSI plane (its row of the field's view),
        ``"pred"`` (``row_id`` the value) and ``"zero"`` for the
        slice-invariant BSI leaves; ``ctx`` is what the leaf's validity
        depends on besides its fragments — the views' names and, for a time
        Range, the frame's quantum (it decides the views); a predicate's
        value and bucket."""
        out = []
        for leaf in leaves:
            if leaf.name == "BsiPred":
                v, d = leaf.args["v"], leaf.args["d"]
                out.append(("pred", [], v, ("pred", v, d)))
                continue
            if leaf.name == "BsiZero":
                out.append(("zero", [], 0, ("zero",)))
                continue
            kind, target, row_id = self._resolve_leaf(index, leaf)
            views = target if kind == "row" else [] if target is None else [target]
            ctx = tuple(v.name for v in views)
            if leaf.name == "Range":
                f = self.holder.frame(index, leaf.args.get("frame") or DEFAULT_FRAME)
                ctx += (f.time_quantum if f is not None else "",)
            out.append((kind, views, row_id, ctx))
        return out

    def _leaf_versions(self, index: str, leaves: list[Call], slices: list[int]) -> tuple:
        """The validity vector of a batch (JAX ``executor.py:1253``):
        each leaf's context, then per slice and leaf each view's fragment
        state (``Fragment.cache_state``) or None — nothing for the
        slice-invariant BSI leaves.  Dict lookups only."""
        targets = self._leaf_targets(index, leaves)
        maps = {id(v): v.fragment_map() for _, views, _, _ in targets for v in views}
        states = []
        for s in slices:
            for _, views, row_id, _ in targets:
                vstates = []
                for v in views:
                    frag = maps[id(v)].get(s)
                    vstates.append(None if frag is None else frag.cache_state(row_id))
                states.append(tuple(vstates))
        return tuple(t[3] for t in targets), tuple(states)

    def _pred_row(self, value: int, bucket: int, device: torch.device) -> torch.Tensor:
        """A packed predicate row (``bsi.pred_row``) as a one-row base,
        kept per (value, bucket, device): predicates repeat across slices
        and queries, so each uploads once (JAX ``executor.py:702``), and
        equal predicates are one address in a fused launch."""
        key = (value, bucket, device)
        with self._zero_mu:
            row = self._pred_rows.get(key)
            if row is None:
                host = bsi.pred_row(value, bucket).view(np.int32)[None, :]
                row = torch.from_numpy(np.ascontiguousarray(host)).to(device)
                if len(self._pred_rows) >= 256:
                    self._pred_rows.clear()
                self._pred_rows[key] = row
            return row

    @staticmethod
    def _field_leaves(leaves: list[Call], targets: list[tuple]) -> dict[tuple, list[int]]:
        """The plane leaves of each BSI field, in leaf order: exists, sign
        and every magnitude bit, once for each BSI node of the field."""
        fields: dict[tuple, list[int]] = {}
        for j, (kind, _, _, _) in enumerate(targets):
            if kind == "plane":
                fk = (leaves[j].args["frame"], leaves[j].args["field"])
                fields.setdefault(fk, []).append(j)
        for js in fields.values():
            prows = [targets[j][2] for j in js]
            nrows = max(prows) + 1
            if nrows < 3 or prows != list(range(nrows)) * (len(prows) // nrows):
                raise plan.PlanError(
                    "a field's plane leaves must list exists, sign and every bit in order")
        return fields

    def _cached_batch_build(self, index: str, key: tuple, expr: tuple, leaves: list[Call],
                            slices: list[int], device: torch.device | None = None
                            ) -> tuple[_BatchEntry, RowTable | None]:
        """One entry over ``slices``, every mirror it names on ``device``
        (the holder's by default; on a mesh, the member's)."""
        device = self.holder.device if device is None else device
        # The epochs before anything is read: a change during the build
        # leaves the entry conservatively stale.  Each fragment's state is
        # read under its lock with the row it names.
        epoch, mepoch = fragment_mod.write_epoch(), fragment_mod.mirror_epoch()
        targets = self._leaf_targets(index, leaves)
        apply_pending_many(v.fragment(s) for _, views, _, _ in targets for v in views
                           for s in slices)
        fields = self._field_leaves(leaves, targets)
        # Bases: the zero row, the mirrors (held weakly), the predicate rows
        # and the scratch rows (held by the entry).
        bases: list = [self._zero_row(device).view(1, bp.WORDS_PER_SLICE)]
        weak: list[bool] = [False]
        base_of: dict[int, int] = {}
        pred_base: dict[int, int] = {}
        for j, (kind, _, value, ctx) in enumerate(targets):
            if kind == "pred":
                pred_base[j] = len(bases)
                bases.append(self._pred_row(value, ctx[2], device))
                weak.append(False)

        def mirror_base(mirror) -> int:
            b = base_of.get(id(mirror))
            if b is None:
                b = base_of[id(mirror)] = len(bases)
                bases.append(mirror)
                weak.append(True)
            return b

        pin_keys: dict = {self._batch_pool_key(key): None}
        scratch_srcs: list[list] = []
        rows: list[list] = []
        field_rows: dict[int, list] = {fk: [] for fk in fields}
        kept: list[int] = []
        empties: list[int] = []
        states = []
        n_leaves = len(leaves)
        for s in slices:
            row: list = [(0, 0)] * n_leaves
            sstates: list = [()] * n_leaves
            any_set = False
            slice_fields = {}
            for fk, js in fields.items():
                views = targets[js[0]][1]
                frag = views[0].fragment(s) if views else None
                if frag is None:
                    for j in js:
                        sstates[j] = (None,) if views else ()
                    slice_fields[fk] = (-1, [-1] * len(js))
                    continue
                mirror, slots, fstates = frag.device_field_ref([targets[j][2] for j in js])
                b = mirror_base(mirror)
                pin_keys[frag._pool_key] = None
                for j, slot, st in zip(js, slots, fstates):
                    sstates[j] = (st,)
                    if slot >= 0:
                        row[j] = (b, slot)
                        any_set = True
                slice_fields[fk] = (b, slots)
            for j, (kind, views, row_id, _) in enumerate(targets):
                if kind == "pred":
                    row[j] = (pred_base[j], 0)
                if kind != "row":
                    continue
                srcs, vstates = [], []
                for view in views:
                    frag = view.fragment(s)
                    if frag is None:
                        vstates.append(None)
                        continue
                    ref, state = frag.device_row_ref(row_id)
                    vstates.append(state)
                    if ref is not None:
                        srcs.append((frag, ref))
                sstates[j] = tuple(vstates)
                if not srcs:
                    continue
                any_set = True
                if len(srcs) == 1 and srcs[0][1][0] == "plane":
                    frag, (_, mirror, slot) = srcs[0]
                    pin_keys[frag._pool_key] = None
                    row[j] = (mirror_base(mirror), slot)
                else:
                    # A sparse row, or the union of several views' rows.
                    row[j] = (-1, len(scratch_srcs))
                    scratch_srcs.append([ref for _, ref in srcs])
            states.extend(sstates)
            if any_set:
                kept.append(s)
                rows.append(row)
                for fk in fields:
                    field_rows[fk].append(slice_fields[fk])
            else:
                empties.append(s)
        versions = (tuple(t[3] for t in targets), tuple(states))
        nbytes = 0
        idx = np.asarray(rows, dtype=np.int64).reshape(len(kept), n_leaves, 2)
        if scratch_srcs:
            scratch = self._fill_scratch(scratch_srcs, device)
            idx[idx[..., 0] == -1, 0] = len(bases)
            bases.append(scratch)
            weak.append(False)
            nbytes += scratch.nbytes
        table = RowTable(bases, idx) if kept else None
        addrs = None
        leaf_keys: tuple = ()
        leaf_inputs: tuple = ()
        field_data: tuple = ()
        if table is not None:
            # The one full check of the entry's table: every table its
            # hits make is checked by construction.
            table.check()
            ptrs = np.asarray([b.data_ptr() for b in bases], dtype=np.int64)
            flat = ptrs[idx[..., 0]] + idx[..., 1] * bp.WORDS_PER_SLICE * 4
            # Equal row addresses are equal rows ("same address, same
            # register" in a fused launch).
            leaf_keys = tuple(("rows", flat[:, j].tobytes()) for j in range(n_leaves))
            if device.type == "cuda":
                addrs = table.addresses()
                nbytes += addrs.nbytes
            if plan.expr_has_bsi(expr):
                field_data, leaf_inputs = self._field_inputs(targets, fields, field_rows,
                                                             bases, device)
                nbytes += sum(f[3].nbytes for f in field_data)
        refs = [weakref.ref(b) if w else b for b, w in zip(bases, weak)]
        ent = _BatchEntry(
            expr=expr, kept=kept, empties=empties, refs=refs, index=idx, addrs=addrs,
            epoch=epoch, mirror_epoch=mepoch, versions=versions, leaf_keys=leaf_keys,
            pin_keys=tuple(pin_keys), nbytes=nbytes, leaf_inputs=leaf_inputs,
            fields=field_data,
        )
        if table is not None:
            table = RowTable(table.bases, idx, addrs, checked=True)
        return ent, table

    @staticmethod
    def _field_inputs(targets, fields, field_rows, bases, device) -> tuple[tuple, tuple]:
        """A BSI tree's ripple inputs over a batch: per field its mirror
        bases, slots, bucket and the K8 address table of a FieldPlanes
        checked once; per leaf its input kind."""
        field_data, field_of = [], {}
        for fi, (fk, js) in enumerate(fields.items()):
            nrows = max(targets[j][2] for j in js) + 1
            base_idx = np.asarray([b for b, _ in field_rows[fk]], dtype=np.int64)
            slots = np.asarray([sl[:nrows] for _, sl in field_rows[fk]],
                               dtype=np.int64).reshape(len(base_idx), nrows)
            bucket = bsi.pad_depth(nrows - 2)
            fp = bsi_ripple.FieldPlanes([bases[b] if b >= 0 else None for b in base_idx],
                                        slots, bucket, device)
            field_data.append((base_idx, slots, bucket, fp.table()))
            for j in js:
                field_of[j] = fi
        leaf_inputs = []
        for j, (kind, _, value, _) in enumerate(targets):
            if kind == "plane":
                leaf_inputs.append(("plane", field_of[j]))
            elif kind == "pred":
                leaf_inputs.append(("pred", value))
            else:
                leaf_inputs.append((kind,))
        return tuple(field_data), tuple(leaf_inputs)

    def _entry_inputs(self, ent: _BatchEntry, table: RowTable) -> list:
        """A BSI tree's leaf inputs for the ripple route (``plan.eval_expr``,
        ``count_rows``, ``agg_vectors``) from its cached batch: each field's
        FieldPlanes over the mirrors the table holds (its address table
        built once), a predicate's value, None for a pad plane, and a row
        leaf's rows copied out of the table by one K2 launch."""
        device = table.device
        fps = [
            bsi_ripple.FieldPlanes([table.bases[b] if b >= 0 else None for b in base_idx],
                                   slots, bucket, device, addrs=addrs)
            for base_idx, slots, bucket, addrs in ent.fields
        ]
        inputs: list = []
        for j, li in enumerate(ent.leaf_inputs):
            if li[0] == "plane":
                inputs.append(fps[li[1]])
            elif li[0] == "pred":
                inputs.append(plan.PredLeaf(li[1]))
            elif li[0] == "zero":
                inputs.append(None)
            else:
                inputs.append(plan.tree_eval(("leaf", 0), "row",
                                             RowTable.concat_leaves([table], [[j]])))
        return inputs

    def _direct_eval(self, ent: _BatchEntry, table: RowTable, reduce: str) -> torch.Tensor:
        """A cached batch's per-key launch: K2 (``plan.tree_eval``) for a
        bitmap tree; for a tree with a BSI node the ripple route — K8 over
        the cached FieldPlanes, the folds around it as torch ops and a
        Count's last fold one K1 launch."""
        if not ent.leaf_inputs:
            return plan.tree_eval(ent.expr, reduce, table)
        inputs = self._entry_inputs(ent, table)
        if reduce == "row":
            return plan.eval_expr(ent.expr, inputs).contiguous()
        counts = plan.count_rows(ent.expr, inputs)
        if reduce == "count":
            return counts
        return counts.sum(dtype=torch.int64).reshape(1)

    @staticmethod
    def _fill_scratch(srcs: list[list], device: torch.device) -> torch.Tensor:
        """The scratch rows of a batch: row i the union of ``srcs[i]``'s
        rows (plane rows, device payloads), every payload expanded by ONE
        K6 launch and the unions ORed after it."""
        scratch = torch.empty(len(srcs), bp.WORDS_PER_SLICE, dtype=torch.int32, device=device)
        jobs, unions = [], []
        for i, refs in enumerate(srcs):
            if len(refs) == 1:
                _, fmt, payload = refs[0]  # a lone plane row never needs scratch
                jobs.append((fmt, payload, scratch[i]))
                continue
            parts = []
            for ref in refs:
                if ref[0] == "plane":
                    parts.append(ref[1][ref[2]])
                else:
                    tmp = torch.empty(bp.WORDS_PER_SLICE, dtype=torch.int32, device=device)
                    jobs.append((ref[1], ref[2], tmp))
                    parts.append(tmp)
            unions.append((i, parts))
        if jobs:
            expand_payload.expand_payloads(jobs)
        for i, parts in unions:
            acc = parts[0]
            for r in parts[1:]:
                acc = acc | r
            scratch[i] = acc
        return scratch

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
        tie, by ``row_count``) is the anchor; an empty anchor bounds the
        slice at 0.  The anchor goes to the card as the index of its leaf,
        read there from its device form like every other leaf: nothing
        is expanded on the host.  The count is ONE launch of K5
        (``plan.anchored_count``) over every remaining slice, any mix of
        formats; a failure raises."""
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
            for frag, (_, rid) in zip(frags, resolved):
                hp = frag.host_payload(rid) if frag is not None else None
                if hp is not None and hp[0] != bp.FMT_DENSE:
                    any_compressed = True
            picked.append((ai, card, frags, s))
        if not any_compressed:
            return None
        apply_pending_many(f for _, _, frags, _ in picked for f in frags)
        dev_leaves = [
            [frag.device_leaf(rid) if frag is not None else None
             for frag, (_, rid) in zip(frags, resolved)]
            for _, _, frags, _ in picked
        ]
        # One launch a member on a mesh: a launch reads one member's leaves.
        members = bp.placement(self.holder.placed)
        groups = bp.group_by_member(range(len(picked)), len(members), lambda i: picked[i][3])
        t0 = time.monotonic()
        outs = [plan.anchored_count(
            expr, np.array([picked[i][0] for i in idx], dtype=np.int32),
            [dev_leaves[i] for i in idx], members[m]) for m, idx in groups.items()]
        t_disp = time.monotonic()
        n = int(sum(int(o.sum(dtype=torch.int64)) for o in outs))
        if perf_mod.enabled():
            # Logical: every leaf's dense row in every anchored slice;
            # effective: 4 B a position of the anchors and the encoded
            # leaves read once (JAX executor.py:1792).
            eff = 4 * sum(card for _, card, _, _ in picked) + sum(
                int(lf[1].numel() * lf[1].element_size())
                for row in dev_leaves for lf in row if lf is not None
            )
            perf_mod.record_launch(
                "anchored",
                reduce="count",
                rows=len(picked) * len(leaves),
                n_bytes=perf_mod.plane_bytes(len(picked) * len(leaves), bp.WORDS_PER_SLICE),
                eff_bytes=eff,
                dispatch_ms=(t_disp - t0) * 1e3,
                total_ms=(time.monotonic() - t0) * 1e3,
                trace_id=perf_mod.current_trace_id(),
            )
        return n

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
            # The cached batch (JAX executor.py:1037): a repeated aggregate
            # builds nothing; its launch stays per key (K8), off the
            # coalescer.
            if not local_slices:
                return None
            # The health gate as at the Count route (JAX executor.py:2143).
            got: list = []

            def launch(mode: str, retry: bool = False):
                if not got:
                    got.append(self._cached_batch(index, rc, expr, leaves, local_slices))
                ent, table = got[0]
                if table is None:
                    return _NoLaunch(None)
                with device_mod.pool().pinned(*ent.pin_keys), self._device_span("agg"):
                    self._fault_check_launch("direct")
                    if isinstance(ent, _MeshEntry):
                        # One K8 launch a member, the per-slice vectors in
                        # the batch's order.
                        outs = [plan.agg_vectors(expr, self._entry_inputs(pe, t))
                                for _m, pe, t in ent.live()]
                        return np.concatenate([o.cpu().numpy() for o in outs])
                    return plan.agg_vectors(expr, self._entry_inputs(ent, table)).cpu().numpy()

            res = self._launch_guarded(
                launch, retry_fn=functools.partial(launch, retry=True),
                host_fn=lambda: self.hosteval.agg_partials(
                    index, rc, self._host_slices(got, local_slices)))
            if res is None:
                return None
            vecs = res.values() if isinstance(res, dict) else res
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
            groups = self._slices_by_node(self.cluster.route_nodes(), index, slices)
        except SliceUnavailableError:
            return False
        return set(groups) == {self.host}

    def _execute_topn_slices(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> list[Pair]:
        def map_fn(local_slices: list[int]) -> list[Pair]:
            local_slices = self._existing_topn_slices(index, c, local_slices)
            if len(c.children) > 1:
                raise ExecutorError("TopN() can only have one input bitmap")
            if not c.children or not local_slices:
                # Without a src the cached counts answer: no card work.
                return self._topn_slices_leg(index, c, local_slices, host=False)[0]
            # With one: its evaluation, the queued writes, the prep and the
            # scorer under ONE admission to the card.
            def launch(mode: str):
                pairs, launched = self._topn_slices_leg(index, c, local_slices, host=False)
                return pairs if launched else _NoLaunch(pairs)

            return self._launch_guarded(
                launch, retry_fn=launch,
                host_fn=lambda: self._topn_slices_leg(index, c, local_slices, host=True)[0])

        pairs = self._map_reduce(
            index, slices, c, opt, map_fn,
            # A remote leg without pairs arrives as an empty QueryResult,
            # which decodes as 0: it adds no pairs.
            lambda prev, v: cache_mod.add_pairs(prev or [], v or []),
        )
        return cache_mod.sort_pairs(pairs or [])

    def _topn_slices_leg(self, index: str, c: Call, local_slices: list[int],
                         host: bool) -> tuple[list[Pair], bool]:
        """One TopN map leg over its local slices, and whether its scorer
        launched on the card: prepare every local fragment, score them all
        in one launch with one fetch (a round trip per node and phase,
        however many slices it owns), then merge.  ``host``: the src tree,
        the prep and the scores come from the host planes, and no card is
        touched."""
        srcs = self._topn_srcs(index, c, local_slices, host) if c.children else None
        view, template = self._topn_view(index, c), self._topn_template(c)
        self_src = self._topn_self_src(index, c)
        if view is not None and srcs is not None and not host:
            apply_pending_many(view.fragment(s) for s in local_slices)
        states = []
        for s in local_slices:
            prep = self._topn_options_for_slice(view, s, template, srcs)
            if prep is None:
                continue
            frag, topt = prep
            states.append((frag, frag.top_prepare_parts(topt, host)))
        scored = [self._attach_dev_src(frag, part, self_src) for frag, part in states]
        launched = self._score_topn_parts(scored, host)
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
            return [], launched
        return [Pair(int(i), int(cnt)) for i, cnt in zip(*merged)], launched

    def _score_topn_parts(self, parts, host: bool) -> bool:
        """Score the parts — ``(TopState, SubRef or None, src row, src
        slot or None, fragment)`` — of every fragment with a SubRef in ONE
        launch of the cross-fragment scorer and fetch the scores in one
        copy, filling each ``TopState.counts`` (JAX ``executor.py:2281``);
        True when it launched.  The candidate and src rows are read in
        place: a fragment's src is its own mirror's row when ``src slot``
        is set, else the row its src tree was evaluated into.  Only the
        slot lists are ragged; they pad with -1.  ``host``: the host fills
        the same vectors from the fragments' host rows.  The caller holds
        the health gate's admission (``_launch_guarded``)."""
        live = [p for p in parts if p[1] is not None]
        if not live:
            return False
        if host:
            self.hosteval.score_topn_parts(live)
            return False
        self._fault_check_launch("topn")
        # One K4 launch a member group (JAX executor.py:1976-2016): a
        # launch reads planes of one member only.
        n = len(bp.placement(self.holder.placed))
        for grp in bp.group_by_member(live, n, lambda p: p[4].slice).values():
            for lo in range(0, len(grp), score_planes.MAX_FRAGMENTS):
                self._score_topn_group(grp[lo : lo + score_planes.MAX_FRAGMENTS])
        return True

    def _score_topn_group(self, group: list) -> None:
        """One K4 launch over at most ``MAX_FRAGMENTS`` parts, and its
        fetch."""
        subs = [p[1] for p in group]
        t0 = time.monotonic()
        with self.tracer.span("topn.dispatch", groups=1):
            slots = np.full((len(group), max(len(sub.slots) for sub in subs)), -1, np.int64)
            for i, sub in enumerate(subs):
                slots[i, : len(sub.slots)] = sub.slots
            srcs = [src if slot is None else sub.plane[slot] for _, sub, src, slot, _ in group]
            out = score_planes.score_planes([sub.plane for sub in subs], slots, srcs)
        t_disp = time.monotonic()
        with self.tracer.span("topn.fetch", arrays=1):
            (scores,) = self._shared_fetch([out])
        for (st, sub, *_), row in zip(group, scores):
            st.counts = row[: len(sub.slots)]
        if perf_mod.enabled():
            # Logical: each fragment's whole plane snapshot, as the
            # JAX scorer streams it (executor.py:2367); effective: the
            # candidate rows and the src row K4 reads, once each.
            row_bytes = bp.WORDS_PER_SLICE * 4
            perf_mod.record_launch(
                "topn",
                reduce="topn",
                rows=sum(int(sub.plane.shape[0]) for sub in subs),
                n_bytes=sum(perf_mod.plane_bytes(int(sub.plane.shape[0]), bp.WORDS_PER_SLICE)
                            for sub in subs),
                eff_bytes=sum((len(sub.slots) + 1) * row_bytes for sub in subs),
                dispatch_ms=(t_disp - t0) * 1e3,
                total_ms=(time.monotonic() - t0) * 1e3,
                trace_id=perf_mod.current_trace_id(),
            )

    @staticmethod
    def _score_topn_sparse(parts) -> None:
        """Score the sparse-tier candidates of every part on the host
        against its src row's words (JAX ``core/fragment.py:2152``): the
        src rows of every part that has such candidates come to the host
        in ONE copy per node and phase, not one per fragment."""
        live = [p for p in parts if p[0].sparse_pos is not None and len(p[0].sparse_pos)]
        if not live:
            return
        words = bp.to_host(torch.stack([p[2] for p in live]))
        for (st, *_), w in zip(live, words):
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
        evaluated src row.  The fragment comes last, for the host
        scorer."""
        st, sub, src = part
        slot = None
        if sub is not None and sub.plane is not None and self_src is not None:
            view, row_id = self_src
            if view is not None and view.fragment(frag.slice) is frag:
                slot = frag.slot_in(row_id, sub.plane)
        return st, sub, src, slot, frag

    def _topn_srcs(self, index: str, c: Call, slices: list[int],
                   host: bool) -> dict[int, RowBitmap]:
        """The src tree's row per slice as one-segment RowBitmaps, folded
        on the device like a Bitmap() call; slices without a row are
        absent (an empty src there).  A tanimoto selection needs each
        row's count: all of them come from one row-popcount launch.
        ``host``: the host planes evaluate the tree instead (as the JAX
        package always does, ``executor.py:1612``), into CPU segments."""
        if host:
            return {
                s: RowBitmap.from_segment(s, torch.from_numpy(r.view(np.int32)),
                                          hosteval_mod.popcount_words(r),
                                          device=self.holder.device)
                for s, r in self._eval_tree_slices_host(index, c.children[0], slices).items()
                if r is not None
            }
        expr, leaves = plan.decompose(self._rewrite_bsi(index, c.children[0]))
        members = bp.placement(self.holder.placed)
        out = {}
        # On a mesh, each member's slices evaluate on its device, where the
        # fragments' mirrors (and so the scorer's planes) live.
        for m, group in bp.group_by_member(slices, len(members)).items():
            inputs, kept = self.leaf_stacks(index, leaves, group, members[m])
            if not kept:
                continue
            rows = plan.eval_expr(expr, inputs)
            counts = [None] * len(kept)
            if _uint_arg(c, "tanimotoThreshold")[0] > 0:
                counts = [int(x) for x in bp.row_counts(rows).cpu().numpy()]
            for i, s in enumerate(kept):
                out[s] = RowBitmap.from_segment(s, rows[i], counts[i], device=members[m])
        return dict(sorted(out.items()))

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

    def _topn_folded_build(self, index: str, c: Call, slices: list[int], host: bool = False):
        """The folded TopN's prep (JAX ``executor.py:2611``): None when
        nothing can score, ``"two_phase"`` when the union guard trips,
        else ``[(frag, topt, cand_ids, cand_mask, (st, sub, src, src slot,
        frag)), ...]``, the union scoring pass of every slice, not yet
        scored.  ``host``: for the host scorer, touching no card."""
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
            srcs = self._topn_srcs(index, c, slices, host)
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
        if c.children and not host:
            # Only a src brings the mirrors in: the scorer reads them.
            apply_pending_many(frag for frag, *_ in per)
        parts = []
        for frag, topt, cand_ids, cand_cnts in per:
            part = frag.top_prepare_union_parts(union, cand_ids, cand_cnts, topt, host)
            st = part[0]
            cand_mask = (
                np.isin(st.cand_ids, cand_ids, assume_unique=True)
                if st.cand_ids is not None
                else None
            )
            parts.append((frag, topt, cand_ids, cand_mask,
                          self._attach_dev_src(frag, part, self_src)))
        return parts

    # Folded-TopN prep entries kept per (index, canonical query, slice
    # list): a dashboard's working set is a handful of repeated queries
    # (JAX executor.py:2489).
    _TOPN_CACHE_CAP = 8

    def _topn_pool_key(self, key: tuple) -> tuple:
        return ("exec", id(self), "topn", key)

    def _evict_topn_key(self, key: tuple) -> bool:
        """The pool's eviction hook for a TopN prep entry; non-blocking,
        as for batch entries."""
        if not self._batch_mu.acquire(blocking=False):
            return False
        try:
            self._topn_cache.pop(key, None)
            return True
        finally:
            self._batch_mu.release()

    def _drop_topn_keys(self, keys) -> None:
        pool = device_mod.pool()
        for k in keys:
            pool.remove(self._topn_pool_key(k))

    def _drop_closed_fragment(self, frag) -> None:
        """A fragment left service: every TopN entry holding it goes now
        (JAX ``executor.py:411``), with its pool bytes."""
        with self._batch_mu:
            stale = [k for k, e in self._topn_cache.items()
                     if any(p[0] is frag for p in e.parts)]
            for k in stale:
                del self._topn_cache[k]
        self._drop_topn_keys(stale)

    def _topn_versions(self, index: str, c: Call, slices: list[int]) -> tuple:
        """The validity vector of a TopN prep entry (JAX
        ``executor.py:2492``): each slice's TopN fragment as ``(serial,
        version)`` over the ORIGINAL slice list (a fragment springing into
        existence invalidates), then, with a src tree, its leaves'
        fragments' over the same slices (the src rows were evaluated at the
        build).  Mirror moves do not invalidate: the scorer's planes are
        held weakly (an evicted one makes the entry stale by itself), and
        the src rows are the entry's own."""
        view = self._topn_view(index, c)
        have = view.fragment_map() if view is not None else {}
        out: list = []
        for s in slices:
            frag = have.get(s)
            out.append(None if frag is None else (frag._serial, frag._version))
        if len(c.children) == 1:
            try:
                _, leaves = plan.decompose(self._rewrite_bsi(index, c.children[0]))
                targets = self._leaf_targets(index, leaves)
            except (plan.PlanError, ExecutorError):
                targets = []
            maps = [[v.fragment_map() for v in t[1]] for t in targets]
            out.append(tuple(
                tuple(None if f is None else (f._serial, f._version)
                      for f in (m.get(s) for m in vmaps))
                for s in slices for vmaps in maps))
        return tuple(out)

    def _topn_folded_entry(self, index: str, c: Call, slices: list[int], sp) -> tuple:
        """The folded TopN's prep, cached per (index, canonical query, slice
        list) and checked like a batch entry (JAX ``executor.py:2515``): in
        O(1) against the write and mirror epochs, else against the version
        vector.  A hit skips the candidate walks, the union, the src
        evaluation and the gather prep; with scores already fetched for the
        entry it skips the scorer too.  Entries expire with the rank
        caches' re-sort throttle (``cache.RECALCULATE_INTERVAL_S``), whose
        re-sort happens inside the walk a hit skips.  Concurrent misses of
        one key make one build: the others wait for it and look again.  An
        attribute-filtered TopN (``field=``) is not cached: the attribute
        store has no version to check.  Annotates ``sp`` with
        ``prep_cache=hit|miss``.  Returns ``(entry, this query's
        parts)``."""
        key = (index, str(c), tuple(slices))
        if c.args.get("field"):
            return self._topn_build_entry(index, c, slices, key, False, sp)
        hit = self._topn_lookup(index, c, slices, key, sp)
        if hit is not None:
            return hit
        with self._batch_mu:
            ev = self._topn_building.get(key)
            leader = ev is None
            if leader:
                ev = self._topn_building[key] = threading.Event()
        if not leader:
            ev.wait(timeout=coalesce_mod.RESULT_TIMEOUT_S)
            hit = self._topn_lookup(index, c, slices, key, sp)
            if hit is not None:
                return hit
            # The leader failed, or a write came after its build.
            return self._topn_build_entry(index, c, slices, key, True, sp)
        try:
            return self._topn_build_entry(index, c, slices, key, True, sp)
        finally:
            with self._batch_mu:
                self._topn_building.pop(key, None)
            ev.set()

    def _topn_lookup(self, index: str, c: Call, slices: list[int], key: tuple, sp):
        """``(entry, parts)`` of the cached entry of ``key`` while it holds,
        else None; a stale one is dropped before the rebuild, so that a
        failing build cannot leave it behind."""
        now = time.monotonic()
        with self._batch_mu:
            expired = [k for k, e in self._topn_cache.items()
                       if now - e.built_at >= cache_mod.RECALCULATE_INTERVAL_S]
            for k in expired:
                del self._topn_cache[k]
            ent = self._topn_cache.get(key)
        self._drop_topn_keys(expired)
        if ent is None:
            return None
        epoch, mepoch = fragment_mod.write_epoch(), fragment_mod.mirror_epoch()
        fresh = ent.epoch == epoch and ent.mirror_epoch == mepoch
        if not fresh:
            fresh = ent.versions is not None and \
                ent.versions == self._topn_versions(index, c, slices)
        parts = ent.query_parts() if fresh else None
        if parts is not None:
            ent.epoch, ent.mirror_epoch = epoch, mepoch
            with self._batch_mu:
                if key in self._topn_cache:
                    self._topn_cache.move_to_end(key)
            device_mod.pool().touch(self._topn_pool_key(key))
            self.holder.stats.count("exec.topn.prepHit")
            sp.annotate(prep_cache="hit")
            return ent, parts
        with self._batch_mu:
            if self._topn_cache.get(key) is ent:
                del self._topn_cache[key]
        self._drop_topn_keys([key])
        return None

    def _topn_build_entry(self, index: str, c: Call, slices: list[int], key: tuple,
                          cacheable: bool, sp) -> tuple:
        # The epochs before the build; the version vector after it, kept
        # only when no write came anywhere from the build's start to the
        # vector's end (else the entry never validates: conservatively
        # stale).
        epoch, mepoch = fragment_mod.write_epoch(), fragment_mod.mirror_epoch()
        built = self._topn_folded_build(index, c, slices)
        self.holder.stats.count("exec.topn.prepBuild")
        sp.annotate(prep_cache="miss")
        versions = None
        if cacheable:
            versions = self._topn_versions(index, c, slices)
            if fragment_mod.write_epoch() != epoch:
                versions = None
        ent = _TopnEntry.of(built, key, epoch, mepoch, versions)
        # While ``built`` holds the planes, the weak references live.
        parts = ent.query_parts()
        if cacheable:
            displaced = []
            with self._batch_mu:
                self._topn_cache[key] = ent
                while len(self._topn_cache) > self._TOPN_CACHE_CAP:
                    displaced.append(self._topn_cache.popitem(last=False)[0])
            self._drop_topn_keys(displaced)
            if ent.nbytes:
                device_mod.pool().admit(
                    self._topn_pool_key(key), ent.device_bytes,
                    functools.partial(self._evict_topn_key, key), category="cache",
                    info={"cache": "topn", "index": index, "query": str(c)})
        return ent, parts

    def _execute_topn_folded(
        self, index: str, c: Call, slices: list[int], opt: ExecOptions
    ) -> list[Pair]:
        """Both TopN phases from one scoring pass (JAX
        ``executor.py:2715``; reference protocol executor.go:281-321):
        the cross-slice candidate union is known after a host-only cache
        walk, so every slice scores the whole union once — one launch,
        one fetch — and the phase-1 winner selection and the phase-2
        exact counts both read those scores.  The prep comes from the
        cache (``_topn_folded_entry``), and the scores are fetched once
        per entry: concurrent queries of one entry wait for one leader's
        launch and fetch (single flight), later ones reuse its scores
        while the entry holds.  With a src tree, the prep and the scorer
        run under one admission to the card; a denied or failed card has
        the host prepare and score (``_topn_folded_host``)."""
        n = _uint_arg(c, "n")[0]
        if len(c.children) > 1:
            raise ExecutorError("TopN() can only have one input bitmap")
        # The key is the canonical tree: src trees that differ only in the
        # order of commuting children share an entry, bit for bit.
        c = plan.canonicalize_call(c)
        # The mirrors the prep finds stay pinned until the scores are
        # fetched.
        with device_mod.pool().pinned():
            if c.children:
                def launch(mode: str):
                    return self._topn_folded_card(index, c, slices)

                kind, parts = self._launch_guarded(
                    launch, retry_fn=launch,
                    host_fn=lambda: self._topn_folded_host(index, c, slices))
            else:
                # Without a src nothing reaches the card.
                kind, parts = self._topn_folded_card(index, c, slices).value
        if kind == "empty":
            return []
        if kind == "two_phase":
            return self._execute_topn_two_phase(index, c, slices, opt, n)
        with self.tracer.span("topn.select", parts=len(parts)):
            return self._topn_folded_select(parts, n)

    def _topn_folded_card(self, index: str, c: Call, slices: list[int]):
        """The folded TopN's prep and scores through the cache and the
        card: ``(kind, parts)``, wrapped in :class:`_NoLaunch` when the
        scorer did not launch."""
        with self.tracer.span("topn.prep", slices=len(slices)) as sp:
            ent, parts = self._topn_folded_entry(index, c, slices, sp)
        if ent.kind != "parts":
            return _NoLaunch((ent.kind, []))
        with self.tracer.span("topn.score", parts=len(parts)) as sp:
            launched = self._score_topn_entry(ent, parts, sp)
        return ("parts", parts) if launched else _NoLaunch(("parts", parts))

    def _topn_folded_host(self, index: str, c: Call, slices: list[int]):
        """``(kind, parts)`` without the card: from the prep cache where
        it needs none (an empty or two-phase entry, or memoized scores),
        else a prep and scores of the host's own, which the cache does
        not keep (a cached entry's src rows are on the card)."""
        with self.tracer.span("topn.prep", slices=len(slices)) as sp:
            hit = None
            if not c.args.get("field"):
                hit = self._topn_lookup(index, c, slices, (index, str(c), tuple(slices)), sp)
            if hit is not None:
                ent, parts = hit
                if ent.kind != "parts":
                    return ent.kind, []
                with self._batch_mu:
                    scores = ent.scores
                if scores is not None:
                    self._fill_scores(parts, scores, sp)
                    return "parts", parts
            built = self._topn_folded_build(index, c, slices, host=True)
            sp.annotate(prep_cache="host")
        if built is None or built == "two_phase":
            return ("empty" if built is None else built), []
        with self.tracer.span("topn.score", parts=len(built)) as sp:
            scored = [p[4] for p in built]
            self._score_topn_parts(scored, host=True)
            self._score_topn_sparse(scored)
            sp.annotate(score_cache="host")
        return "parts", built

    def _fill_scores(self, parts: list, scores: list, sp) -> None:
        for part, (cnt, sparse) in zip(parts, scores):
            part[4][0].counts, part[4][0].sparse_cnt = cnt, sparse
        sp.annotate(score_cache="shared")
        self.holder.stats.count("exec.topn.scoreShared")

    def _score_topn_entry(self, ent: _TopnEntry, parts: list, sp) -> bool:
        """Fill every part's scores: from the entry's memo, else as the
        leader of one launch and fetch (K4 and the sparse tier on the
        host) that every concurrent query of the entry waits for — on an
        event, never a lock (JAX ``executor.py:2760``).  A leader that
        fails leaves no scores, and a waiter then scores on its own.  True
        when this query launched the scorer."""
        leader = False
        with self._batch_mu:
            scores = ent.scores
            ev = None
            if scores is None:
                ev = ent.score_event
                if ev is None:
                    ev = ent.score_event = threading.Event()
                    leader = True
        if scores is None and not leader:
            ev.wait(timeout=coalesce_mod.RESULT_TIMEOUT_S)
            with self._batch_mu:
                scores = ent.scores
        if scores is not None:
            self._fill_scores(parts, scores, sp)
            return False
        try:
            scored = [p[4] for p in parts]
            pin_keys = [self._topn_pool_key(ent.key)] + [p[0]._pool_key for p in parts]
            with device_mod.pool().pinned(*pin_keys):
                launched = self._score_topn_parts(scored, host=False)
                self._score_topn_sparse(scored)
            with self._batch_mu:
                ent.scores = [(st.counts, st.sparse_cnt) for st, *_ in scored]
            sp.annotate(score_cache="computed")
            return launched
        finally:
            if leader:
                ev.set()

    @staticmethod
    def _topn_folded_select(parts, n: int) -> list[Pair]:
        # Phase-1 winners per slice, from the scores the first round
        # would have given the slice's own candidates (a subset of the
        # union).
        winner_ids, fulls = [], []
        for frag, topt, cand_ids, cand_mask, (st, *_) in parts:
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
        """One view's write on every write owner of its slice (both rings
        during a resize): the local write here when this node owns it,
        the whole call as a remote leg to each other owner unless this is
        itself a remote leg — through the replication's W-of-N
        coordinator where one is wired."""
        slice_i = col_id // bp.SLICE_WIDTH
        targets = self.cluster.write_nodes(index, slice_i) or [Node(host=self.host)]
        if self.replication is not None and not opt.remote:
            return self.replication.coordinate_write(
                self, index, c, opt, view,
                lambda v, r, col: write_fn(f, v, r, col), row_id, col_id, slice_i, targets,
            )
        ret = False
        for node in targets:
            if node.host == self.host:
                ret = write_fn(f, view, row_id, col_id) or ret
            elif not opt.remote:
                res = self._exec_remote(node, index, Query(calls=[c]), None, opt=opt)
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
            with self.tracer.span("ingest"):
                self.ingest.wait_durable()

    # ------------------------------------------------------------------
    # attribute writes (reference: executor.go:843-1040; JAX
    # executor.py:3139-3218)
    # ------------------------------------------------------------------

    @staticmethod
    def _row_attrs_of(c: Call, f, verb: str = "SetRowAttrs()") -> tuple[int, dict]:
        row_id, ok = _uint_arg(c, f.row_label)
        if not ok:
            raise ExecutorError(f"{verb} row field '{f.row_label}' required")
        attrs = dict(c.args)
        attrs.pop("frame", None)
        attrs.pop(f.row_label, None)
        return row_id, attrs

    def _attr_frame(self, index: str, c: Call):
        frame_name = c.args.get("frame")
        if not isinstance(frame_name, str):
            raise ExecutorError("SetRowAttrs() frame required")
        f = self.holder.frame(index, frame_name)
        if f is None:
            raise FrameNotFoundError()
        return f

    def _execute_set_row_attrs(self, index: str, c: Call, opt: ExecOptions) -> None:
        f = self._attr_frame(index, c)
        row_id, attrs = self._row_attrs_of(c, f)
        f.row_attr_store.set_attrs(row_id, attrs)
        if not opt.remote:
            self._broadcast_query(index, Query(calls=[c]))

    def _execute_bulk_set_row_attrs(self, index: str, calls: list[Call],
                                    opt: ExecOptions) -> list:
        """Every frame's rows in one bulk write (reference:
        executor.go:905-985), then one broadcast of the whole query."""
        by_frame: dict[str, tuple] = {}
        for c in calls:
            f = self._attr_frame(index, c)
            # The bulk path's own message (JAX executor.py:3172).
            row_id, attrs = self._row_attrs_of(c, f, verb="SetRowAttrs")
            by_frame.setdefault(f.name, (f, {}))[1].setdefault(row_id, {}).update(attrs)
        for f, attr_sets in by_frame.values():
            f.row_attr_store.set_bulk_attrs(attr_sets)
        if not opt.remote:
            self._broadcast_query(index, Query(calls=calls))
        return [None] * len(calls)

    def _execute_set_column_attrs(self, index: str, c: Call, opt: ExecOptions) -> None:
        """By ``id`` or by the index's column label."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        col_name = "id"
        id_, ok = _uint_arg(c, col_name)
        if not ok:
            col_name = idx.column_label
            id_, ok = _uint_arg(c, col_name)
            if not ok:
                raise ExecutorError("SetColumnAttrs() id required")
        attrs = dict(c.args)
        attrs.pop(col_name, None)
        idx.column_attr_store.set_attrs(id_, attrs)
        if not opt.remote:
            self._broadcast_query(index, Query(calls=[c]))

    def _broadcast_query(self, index: str, q: Query) -> None:
        """The query to every other node as a remote leg, in parallel;
        the first error wins (reference: executor.go:966-985).  During a
        resize the new ring's nodes receive it too."""
        others = [n for n in self.cluster.route_nodes() if n.host != self.host]
        futures = [self._submit(self._exec_remote, n, index, q, None) for n in others]
        for fut in futures:
            fut.result()

    # ------------------------------------------------------------------
    # map/reduce over the cluster (reference: executor.go:1131-1283;
    # JAX executor.py:3203-3500)
    # ------------------------------------------------------------------

    def _slices_by_node(
        self, nodes: list[Node], index: str, slices: list[int], epoch: int | None = None,
    ) -> dict[str, tuple[Node, list[int]]]:
        """Group slices by their first owner among ``nodes`` that is not
        degraded (its card quarantined), the first owner when all are
        (JAX ``executor.py:3236``); cached per (routing version — a ring
        change or a slice's flip during a resize —, replica count,
        replica-health version, node set, index, slice list): placement
        is pure in those, and hashing ~1000 slices per query costs more
        host time than the query's kernels.  ``epoch``, taken when the
        query started routing, must still be the cluster's, or the query
        fails with ``MixedEpochError``.  Callers treat the result as
        read-only."""
        if epoch is not None and self.cluster.epoch != epoch:
            raise MixedEpochError(epoch, self.cluster.epoch)
        if not self.cluster.nodes:
            return {self.host: (Node(host=self.host), list(slices))}
        key = (
            self.cluster.routing_version,
            self.cluster.replica_n,
            self.cluster.health_version,
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
            owner = next((o for o in owners if not o.degraded), owners[0])
            m.setdefault(owner.host, (owner, []))[1].append(s)
        with self._groups_mu:
            self._slice_groups[key] = m
            while len(self._slice_groups) > 8:
                self._slice_groups.popitem(last=False)
        return m

    def _map_reduce(self, index, slices, c, opt, map_fn, reduce_fn):
        """Map ``slices`` over their owners and reduce each answer as it
        lands; a leg that fails for its node (transport error or 5xx)
        has its slices placed again on the remaining owners.  A remote
        leg (``opt.remote``) maps over this node alone.  Every grouping
        checks the epoch taken here; the waits end with the query's
        deadline."""
        epoch0 = self.cluster.epoch
        if opt.remote or not self.cluster.nodes:
            me = self.cluster.node_by_host(self.host) or Node(host=self.host)
            nodes = [me]
        else:
            nodes = self.cluster.route_nodes()
        if not slices:
            # Sliceless execution still runs locally once.
            resp = self._map_node(Node(host=self.host), [], index, c, map_fn, opt)
            if resp.error is not None:
                raise resp.error
            return reduce_fn(None, resp.result)

        inflight: dict = {}
        missing: list[int] = []

        def submit(avail: list[Node], want: list[int]) -> None:
            for node, node_slices in self._slices_by_node(avail, index, want, epoch0).values():
                fut = self._submit(self._map_node, node, node_slices, index, c, map_fn, opt)
                inflight[fut] = avail

        def failover(resp: _MapResponse, avail: list[Node]) -> None:
            if isinstance(resp.error, resilience.DeadlineExceeded) or not is_node_failure(
                resp.error
            ):
                raise resp.error
            remaining = [n for n in avail if n.host != resp.node.host]
            placeable, lost = self.cluster.split_by_owner(
                index, resp.slices, {n.host for n in remaining}
            )
            if lost:
                if not opt.allow_partial:
                    raise SlicesUnavailableError(lost, cause=resp.error)
                missing.extend(lost)
                self.holder.stats.count("exec.partial.slicesDropped", len(lost))
            if placeable:
                submit(remaining, placeable)

        groups = self._slices_by_node(nodes, index, slices, epoch0)
        if len(groups) == 1:
            # One target (the single-node case): run the leg inline.
            ((node, node_slices),) = groups.values()
            resp = self._map_node(node, node_slices, index, c, map_fn, opt)
            if resp.error is None:
                return reduce_fn(None, resp.result)
            failover(resp, nodes)
        else:
            submit(nodes, slices)

        result = None
        while inflight:
            dl = resilience.current_deadline()
            timeout = None if dl is None else dl.remaining()
            if timeout is not None and timeout <= 0:
                raise resilience.DeadlineExceeded("deadline exceeded awaiting map responses")
            done, _ = wait(list(inflight), timeout=timeout, return_when=FIRST_COMPLETED)
            if not done:
                raise resilience.DeadlineExceeded("deadline exceeded awaiting map responses")
            for fut in done:
                avail = inflight.pop(fut)
                resp = fut.result()
                if resp.error is not None:
                    failover(resp, avail)
                    continue
                result = reduce_fn(result, resp.result)
        if missing:
            # A query may map more than once (TopN's two phases).
            opt.missing_slices[:] = sorted(set(opt.missing_slices) | set(missing))
        return result

    def _map_node(self, node: Node, node_slices: list[int], index, c, map_fn,
                  opt: ExecOptions | None = None) -> _MapResponse:
        resp = _MapResponse(node=node, slices=node_slices)
        try:
            # An exhausted budget fails the query (504), never the node.
            resilience.check_deadline("before map")
            if node.host == self.host:
                # Every mirror and sparse payload the leg finds or uploads
                # stays pinned until its launches are enqueued and their
                # results fetched.
                with self.tracer.span("map.local", node=node.host, slices=len(node_slices)):
                    with device_mod.pool().pinned():
                        resp.result = map_fn(node_slices)
            else:
                results = self._exec_remote(node, index, Query(calls=[c]), node_slices,
                                            idempotent=True, opt=opt)
                resp.result = results[0] if results else None
        except resilience.DeadlineExceeded as e:
            resp.error = e
        except Exception as e:  # noqa: BLE001 — failover boundary
            resp.error = e
        return resp

    def _submit(self, fn, *args):
        """``fn(*args)`` on the map pool, inside a copy of the caller's
        context: the query's current span crosses into the worker (JAX
        ``executor.py:254``)."""
        return self._pool.submit(contextvars.copy_context().run, fn, *args)

    def _exec_remote(self, node: Node, index: str, q: Query, slices,
                     extra_headers: dict | None = None, idempotent: bool = False,
                     opt: ExecOptions | None = None) -> list:
        """Forward a query to a peer as a remote leg (reference:
        executor.go:1045-1129).  The rpc span's ids travel as
        ``X-Trace-Id`` / ``X-Span-Id``; the peer continues the trace under
        them and sends its spans back, which the client absorbs into this
        node's trace (JAX ``executor.py:3429``).  ``extra_headers`` ride
        along (the quorum coordinator's write-version stamp);
        ``idempotent`` lets a read leg retry; ``opt.tenant`` travels as
        ``X-Tenant`` (JAX ``executor.py:3452``)."""
        if self.client_factory is None:
            raise ExecutorError(f"no client for remote node {node.host}")
        client = self.client_factory(node)
        with self.tracer.span(
            "rpc.execute", node=node.host, slices=len(slices) if slices else 0
        ) as sp:
            headers = self.tracer.remote_headers(sp)
            if extra_headers:
                headers = {**(headers or {}), **extra_headers}
            if opt is not None and opt.tenant:
                headers = {**(headers or {}), "X-Tenant": opt.tenant}
            if headers:
                return client.execute_query(index, str(q), slices, remote=True,
                                            trace_headers=headers, tracer=self.tracer,
                                            idempotent=idempotent)
            return client.execute_query(index, str(q), slices, remote=True,
                                        idempotent=idempotent)


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
