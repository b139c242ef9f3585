"""HTTP handler: routes, JSON and protobuf bodies, the query endpoint.

The routes of ``pilosa_tpu.net.handler`` that serve the slices this
port covers, with the same paths, status codes and response bodies
(reference: handler.go):

    GET    /version, /status, /schema, /index, /hosts, /slices/max
    GET    /state (the node's NodeStatus protobuf, gossip's stream fallback)
    GET    /index/<i>          POST /index/<i>          DELETE /index/<i>
    POST   /index/<i>/query    PATCH /index/<i>/time-quantum
    POST   /index/<i>/attr/diff
    POST   /index/<i>/frame/<f>                         DELETE /index/<i>/frame/<f>
    PATCH  /index/<i>/frame/<f>/time-quantum            GET /index/<i>/frame/<f>/views
    POST   /index/<i>/frame/<f>/attr/diff               POST /index/<i>/frame/<f>/restore?host=
    GET    /index/<i>/frame/<f>/fields
    POST   /index/<i>/frame/<f>/field/<fld>             DELETE (same path)
    POST   /import             POST /import-value       GET /export
    GET    /fragment/nodes     GET /fragment/data       POST /fragment/data
    GET    /fragment/blocks    POST /fragment/import-view
    GET    /fragment/block/data
    POST   /tier/restore       GET /debug/tier
    POST   /subscribe          GET /subscribe/<sid>/stream
    GET    /subscribe/<sid>/poll                        DELETE /subscribe/<sid>
    GET    /debug/subscriptions
    GET    /debug/hbm          GET /debug/ingest        GET /debug/health
    GET    /debug/tenants      GET /                    GET /assets/<file>
    GET    /metrics            GET /debug/vars          GET /debug/perf
    GET    /debug/traces       GET /debug/stacks        GET /debug/profile
    GET    /debug/pprof[/goroutine|/profile|/heap]

``POST /index/<i>/query`` reads a ``QueryRequest`` protobuf when the
Content-Type is ``application/x-protobuf`` (its ``Slices``,
``ColumnAttrs`` and ``Remote`` fields included) and answers a
``QueryResponse`` protobuf when Accept names it; JSON otherwise.
``POST /import`` takes an ``ImportRequest`` (timestamps included: unix
nanoseconds, written to the frame's time views) and answers an
``ImportResponse``; into an inverse-enabled frame the node imports the
standard half and sends the transposed half of each inverse slice to
that slice's owners as ``POST /import?view=inverse`` (itself where it
owns it), so the inverse view lives where queries look for it;
``GET /slices/max?inverse=true`` answers the inverse slices;
``POST /import-value`` takes one slice's BSI field
values as JSON.

The data plane of backup, restore, export and block sync (JAX
``handler.py:1247-1435``): ``GET /export`` streams one fragment's CSV
(406 without ``Accept: text/csv``, 412 on a node that does not own the
slice); ``GET /fragment/data`` streams its self-verifying tar and
``POST /fragment/data`` restores one from the request body as it
arrives (422 for a torn archive, which changes nothing; ``?stage=true``
hands the fragment to the prefetcher's staging lane);
``GET /fragment/blocks`` answers its block checksums,
``GET /fragment/block/data`` a block's bits (protobuf in and out) and
``POST /fragment/import-view`` sets and clears bits in one view of a
slice this node owns.  Bodies stream both ways: a chunked or
length-bounded request body reaches a ``stream_body`` route as a reader,
and an iterator response goes out with ``Transfer-Encoding: chunked`` in
writes of ``stream_chunk_bytes`` (64 KiB), counted as
``stream.bytesReceived`` / ``stream.bytesSent``.

Admission and tenant QoS (``net/admission.py``; JAX ``handler.py:927-1010,
1110-1195, 1873-1903``): a query is classified from its parsed plan
(``point``, ``heavy``, ``write``; a remote leg ``internal`` when its
``Remote`` flag comes with the cluster's ``X-Internal-Token``, where one
is configured) and charged to a tenant (``X-Api-Key``, a configured
``X-Tenant``, or the forwarded ``X-Tenant`` of a verified leg); an
``admission`` span between ``parse`` and ``execute`` takes a slot or
answers 429 with ``Retry-After`` (whole seconds, at least 1), the JSON
body's ``retryAfterMs`` and, for a quota, ``X-Quota-Limit`` /
``X-Quota-Remaining`` — before any launch.  ``/import`` and
``/import-value`` take the ``write`` lane; ``/fragment/data``,
``/fragment/import-view``, the repair, replication, rebalance and tier
control routes the ``internal`` lane, and ``POST /subscribe`` the
``subscribe`` lane (``admitted``).  ``GET /debug/tenants`` is the
per-tenant table.  ``GET /`` and ``GET /assets/<file>`` serve the web
console (``net/webui.py``).

Index and frame creation and deletion are broadcast to
the cluster; a field's creation and deletion go to every peer as the
same HTTP request with ``?remote=true``, as in the JAX package.
``GET /debug/hbm`` answers the residency pool's snapshot and ``GET
/debug/ingest`` the WAL manager's and the delta-scatter's counters, with
the JAX package's keys.

Observability (JAX ``handler.py:823-898,1849-2143``): every query opens a
root span (continuing a propagated trace on a remote leg, whose spans go
back in ``X-Trace-Spans``) with ``parse`` and ``execute`` children; the
tracer's ring is ``GET /debug/traces``, and a query slower than
``slow_query_ms`` logs one structured line with its per-stage breakdown.
``GET /debug/vars`` is the stats client's snapshot, ``GET /metrics`` its
Prometheus rendering plus the launch telemetry's gauges and the native
latency histograms (per query class and per route), ``GET /debug/perf``
the per-site roofline table against the probed stream floor, ``GET
/debug/profile?seconds=N`` a ``torch.profiler`` trace (CPU and CUDA
activity) tarred under the data dir, one at a time (409 otherwise),
``GET /debug/stacks`` and ``/debug/pprof`` thread stacks, a sampled CPU
profile and tracemalloc.  ``GET /debug/health`` answers the node, the
cluster's node states, the admission gates (``admission``: each class's
width, queue bound, occupancy, EWMA service time, admitted and shed) and
the card's breaker (``device``: each path's state, the watchdog's trips,
the knobs; JAX ``handler.py:1860``), whose gauges ``/metrics`` renders
at scrape time with the admission and tenant gauges.  ``/metrics`` leaves
out the JAX node's ``exec.programCache.*`` gauges (XLA jit caches: the
port builds each kernel once).  The standing queries' ``exec.subscribe.*`` families render as on a JAX
node, with the scrape-time ``exec.subscribe.active`` and
``exec.subscribe.pendingBits`` gauges.

Standing queries (JAX ``handler.py:1702-1811``): ``POST /subscribe``
registers ``{"index", "query"}`` and answers 201 with the registration
snapshot (version 1); ``/subscribe/<sid>/stream`` is SSE (``id:`` the
version, ``?after=`` resumes), ``/poll`` a long-poll (``?after=``,
``?timeout_ms=``; 410 once unsubscribed).  The registration takes a
slot of the ``subscribe`` admission lane, as does each notify batch.
The cold tier (JAX ``handler.py:1528-1572``): ``POST /tier/restore``
restores one fragment from the node's object store (501 without a
tier), and ``GET /debug/tier`` shows the tier manager's snapshot.

Replica agreement (JAX ``handler.py:303-327, 842-960, 1436-1700,
1821-1872``): a query runs under its deadline (``X-Deadline-Ms``, else
the server's ``query_timeout_ms``; an exhausted one answers 504), answers
over the surviving slices with ``allowPartial=true`` (``partial`` and
``missingSlices`` in JSON, ``X-Missing-Slices`` with protobuf), takes
``writeConsistency`` / ``readConsistency`` from the URL or the
``X-Write-Consistency`` / ``X-Read-Consistency`` headers (the header
wins, junk answers 400), and a remote write leg's ``X-Write-Version``
stamp is the replica's self-staleness probe.  Every request passes the
``rpc.recv`` check point of ``testing/faults.py``.  The routes
``POST /replicate/{versions,hint,replay}``, ``POST
/rebalance/{delta,release}``, ``POST /cluster/resize``, ``POST
/cluster/resize/abort``, ``POST /cluster/topology``, ``GET
/fragment/nodes?write=true``, ``GET /debug/replication`` and ``GET
/debug/rebalance`` answer as a JAX node's; ``/debug/health`` carries the
resilience wiring (``queryTimeoutMs``, ``retry``, ``breakers``).
"""

from __future__ import annotations

import base64
import functools
import io
import math
import json
import os
import re
import shutil
import sys
import tarfile
import tempfile
import threading
import time
import traceback
import urllib.parse
from collections.abc import Callable, Iterable
from dataclasses import dataclass, field
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from pilosa_tpu_torch import __version__, bsi
from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch import stream as stream_mod
from pilosa_tpu_torch.core import attr as attr_mod
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.fragment import ArchiveChecksumError
from pilosa_tpu_torch.core.timequantum import parse_time_quantum
from pilosa_tpu_torch.core.view import is_inverse_view
from pilosa_tpu_torch.exec import plan as plan_mod
from pilosa_tpu_torch.exec.executor import ExecOptions, ExecutorError, TooManyWritesError
from pilosa_tpu_torch.ingest import scatter
from pilosa_tpu_torch.net import admission as adm
from pilosa_tpu_torch.net import codec, webui, wire
from pilosa_tpu_torch.net import resilience as rz
from pilosa_tpu_torch.obs import perf as perf_mod
from pilosa_tpu_torch.obs import prom, trace
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.pql.parser import ParseError, parse_string
from pilosa_tpu_torch.replicate import quorum as replicate_mod
from pilosa_tpu_torch.subscribe import registry as subscribe_reg
from pilosa_tpu_torch.subscribe import sse as sse_mod
from pilosa_tpu_torch.testing import faults

PROTOBUF = "application/x-protobuf"
JSON = "application/json"

# Families a JAX node renders on /metrics that the port leaves out, by
# name prefix, and why.
METRICS_LEFT_OUT = {
    "pilosa_exec_programCache_": "XLA jit caches; the port builds each kernel once",
    "pilosa_exec_pool_": "map legs run on the standard library's thread pool",
}


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    # The body still on the socket (a file-like with read(n)), set by the
    # HTTP adapter: a ``stream_body`` route reads it itself, any other
    # route gets ``body`` read whole by dispatch.
    stream: Any = None

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")

    def body_reader(self):
        """The body as a file object: the pending stream, else the bytes."""
        return self.stream if self.stream is not None else io.BytesIO(self.body)

    def read_body(self) -> bytes:
        """Read the body whole (once) and keep it."""
        if self.stream is not None:
            self.body = self.stream.read()
            self.stream = None
        return self.body


def stream_body(fn):
    """Mark a route as reading ``Request.stream`` itself: dispatch does not
    read the body first."""
    fn.streams_body = True
    return fn


def admitted(cls: str, requires: str = ""):
    """Run a non-query route under ``Handler._admit`` of admission class
    ``cls`` (JAX ``handler.py:1165-1195``): a shed answers 429 before the
    route touches anything, and the slot is released when the route
    returns.  ``requires`` names a handler attribute (``rebalance``,
    ``replication``, ``tier``, ``subscribe``) whose absence answers 501
    first, without a slot, as on a JAX node."""

    def wrap(fn):
        @functools.wraps(fn)
        def route(self, req, **kw):
            if requires and getattr(self, requires) is None:
                return Response.error(f"{requires} not configured", 501)
            ticket, shed = self._admit(cls, req)
            if shed is not None:
                return shed
            try:
                return fn(self, req, **kw)
            finally:
                if ticket is not None:
                    ticket.release()

        return route

    return wrap


def _route_template(pattern: str) -> str:
    """Route regex -> bounded metric label: named groups become
    ``{name}`` placeholders (``/index/{index}/query``)."""
    tmpl = re.sub(r"\(\?P<(\w+)>[^)]*\)", r"{\1}", pattern)
    return tmpl.replace("?", "") or "/"


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = JSON
    # An iterator body: the HTTP adapter sends it with chunked transfer
    # encoding in writes of constant size instead of ``body``.
    body_iter: Iterable[bytes] | None = None
    # Extra response headers (the trace span export).
    headers: dict[str, str] = field(default_factory=dict)

    @classmethod
    def stream(cls, chunks: Iterable[bytes], content_type: str, chunk_bytes: int = 0) -> "Response":
        return cls(body_iter=stream_mod.IterBody(chunks, chunk_bytes=chunk_bytes),
                   content_type=content_type)

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(status=status, body=(json.dumps(obj) + "\n").encode())

    @classmethod
    def proto(cls, msg, status: int = 200) -> "Response":
        return cls(status=status, body=msg.encode(), content_type=PROTOBUF)

    @classmethod
    def error(cls, message: str, status: int) -> "Response":
        return cls.json({"error": message}, status=status)


# JSON frame options -> Frame.set_options keywords (reference: handler.go).
_FRAME_OPTIONS = (
    ("rowLabel", "row_label"),
    ("inverseEnabled", "inverse_enabled"),
    ("cacheType", "cache_type"),
    ("cacheSize", "cache_size"),
    ("timeQuantum", "time_quantum"),
    ("rangeEnabled", "range_enabled"),
    ("retentionAgeS", "retention_age_s"),
    ("retentionDeleteS", "retention_delete_s"),
)


class Handler:
    """Routes requests to the holder and executor underneath; schema
    changes go to ``broadcaster`` (``send_sync``), ownership questions
    to the executor's cluster."""

    def __init__(self, holder, executor, broadcaster=None, stats=None, tracer=None,
                 slow_query_ms: float = 0.0, latency_buckets_ms=None, slo_ms: float = 0.0,
                 slo_objective: float = 0.999, logger=None, stream_chunk_bytes: int = 0,
                 admission=None, tenants=None):
        self.holder = holder
        self.executor = executor
        self.broadcaster = broadcaster
        # The write size of streamed bodies (CSV export, archives).
        self.stream_chunk_bytes = stream_chunk_bytes or stream_mod.DEFAULT_CHUNK_BYTES
        # The prefetcher (wired by the server): ``POST /fragment/data
        # ?stage=true`` stages the restored fragment's mirror through it.
        self.prefetcher = None
        self.logger = logger or (lambda msg: print(msg, file=sys.stderr))
        self.stats = stats
        # Every query is traced when a Tracer is wired (the server does).
        self.tracer = tracer or trace.NOP_TRACER
        self.slow_query_ms = slow_query_ms
        self.latency = perf_mod.LatencyHistograms(
            buckets_ms=latency_buckets_ms, slo_ms=slo_ms, slo_objective=slo_objective
        )
        # Base dir of /debug/profile's tarballs (the server's data dir);
        # one profile at a time.
        self.profile_dir = None
        self._profile_mu = threading.Lock()
        self._start_time = time.time()
        # The WAL manager (wired by the server), for /debug/ingest; None
        # when the WAL is off.
        self.ingest = None
        # The server's resilience wiring (deadlines, retry, breakers), its
        # replication and its rebalancer; None answers as a JAX node
        # without them.
        self.resilience = None
        self.replication = None
        self.rebalance = None
        # The node's cold tier, standing-query manager and NodeStatus
        # provider (wired by the server); None answers as a JAX node
        # without them.
        self.tier = None
        self.subscribe = None
        self.state_provider = None
        # Admission control (net/admission.py): the per-class gates in
        # front of the executor; None admits everything (a bare handler).
        # The tenant registry resolves API keys, checks the internal
        # lane's token and backs GET /debug/tenants; None charges every
        # request to no tenant and leaves the internal lane open.
        self.admission = admission
        self.tenants = tenants
        routes: list[tuple[str, str, Callable]] = [
            ("GET", r"/", self.handle_webui),
            ("GET", r"/assets/(?P<file>[^/]+)", self.handle_webui_asset),
            ("GET", r"/schema", self.handle_get_schema),
            ("GET", r"/status", self.handle_get_status),
            ("GET", r"/state", self.handle_get_state),
            ("GET", r"/hosts", self.handle_get_hosts),
            ("GET", r"/version", self.handle_get_version),
            ("GET", r"/slices/max", self.handle_get_slice_max),
            ("GET", r"/index", self.handle_get_schema),
            ("GET", r"/index/(?P<index>[^/]+)", self.handle_get_index),
            ("POST", r"/index/(?P<index>[^/]+)", self.handle_post_index),
            ("DELETE", r"/index/(?P<index>[^/]+)", self.handle_delete_index),
            ("POST", r"/index/(?P<index>[^/]+)/query", self.handle_post_query),
            ("PATCH", r"/index/(?P<index>[^/]+)/time-quantum",
             self.handle_patch_index_time_quantum),
            ("POST", r"/index/(?P<index>[^/]+)/attr/diff", self.handle_post_index_attr_diff),
            ("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)", self.handle_post_frame),
            ("DELETE", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)", self.handle_delete_frame),
            ("PATCH", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/time-quantum",
             self.handle_patch_frame_time_quantum),
            ("GET", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/views",
             self.handle_get_frame_views),
            ("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/attr/diff",
             self.handle_post_frame_attr_diff),
            ("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/restore",
             self.handle_post_frame_restore),
            ("GET", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/fields",
             self.handle_get_frame_fields),
            ("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/field/(?P<fld>[^/]+)",
             self.handle_post_frame_field),
            ("DELETE", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/field/(?P<fld>[^/]+)",
             self.handle_delete_frame_field),
            ("POST", r"/import", self.handle_post_import),
            ("POST", r"/import-value", self.handle_post_import_value),
            ("GET", r"/export", self.handle_get_export),
            ("GET", r"/fragment/nodes", self.handle_get_fragment_nodes),
            ("GET", r"/fragment/data", self.handle_get_fragment_data),
            ("POST", r"/fragment/data", self.handle_post_fragment_data),
            ("GET", r"/fragment/blocks", self.handle_get_fragment_blocks),
            ("POST", r"/fragment/import-view", self.handle_post_import_view),
            ("GET", r"/fragment/block/data", self.handle_get_fragment_block_data),
            ("POST", r"/cluster/resize", self.handle_post_resize),
            ("POST", r"/cluster/resize/abort", self.handle_post_resize_abort),
            ("POST", r"/cluster/topology", self.handle_post_topology),
            ("POST", r"/rebalance/delta", self.handle_post_rebalance_delta),
            ("POST", r"/rebalance/release", self.handle_post_rebalance_release),
            ("POST", r"/tier/restore", self.handle_post_tier_restore),
            ("POST", r"/replicate/versions", self.handle_post_replicate_versions),
            ("POST", r"/replicate/hint", self.handle_post_replicate_hint),
            ("POST", r"/replicate/replay", self.handle_post_replicate_replay),
            ("POST", r"/subscribe", self.handle_post_subscribe),
            ("GET", r"/subscribe/(?P<sid>[^/]+)/stream", self.handle_get_subscribe_stream),
            ("GET", r"/subscribe/(?P<sid>[^/]+)/poll", self.handle_get_subscribe_poll),
            ("DELETE", r"/subscribe/(?P<sid>[^/]+)", self.handle_delete_subscribe),
            ("GET", r"/debug/subscriptions", self.handle_get_subscriptions),
            ("GET", r"/debug/replication", self.handle_get_replication),
            ("GET", r"/debug/tier", self.handle_get_tier),
            ("GET", r"/debug/rebalance", self.handle_get_rebalance),
            ("GET", r"/debug/hbm", self.handle_get_hbm),
            ("GET", r"/debug/ingest", self.handle_get_ingest),
            ("GET", r"/debug/health", self.handle_get_health),
            ("GET", r"/debug/tenants", self.handle_get_tenants),
            ("GET", r"/debug/vars", self.handle_get_vars),
            ("GET", r"/debug/perf", self.handle_get_perf),
            ("GET", r"/debug/profile", self.handle_get_profile),
            ("GET", r"/debug/stacks", self.handle_get_stacks),
            ("GET", r"/debug/traces", self.handle_get_traces),
            ("GET", r"/metrics", self.handle_get_metrics),
            ("GET", r"/debug/pprof(?P<rest>/.*)?", self.handle_get_pprof),
        ]
        self._routes = [(m, re.compile("^" + p + "$"), fn, _route_template(p))
                        for m, p, fn in routes]

    def dispatch(self, req: Request) -> Response:
        t0 = time.monotonic()
        route = None  # the matched route's template (a bounded label)
        try:
            # The serving side's check point: an injected error answers
            # 500, as a node that took the connection but fails inside.
            faults.check("rpc.recv", host=getattr(self.executor, "host", "") or None,
                         path=req.path)
            for method, pattern, fn, tmpl in self._routes:
                m = pattern.match(req.path.rstrip("/") or "/")
                if m and method == req.method:
                    route = tmpl
                    if req.stream is not None and not getattr(fn, "streams_body", False):
                        req.read_body()
                    resp = fn(req, **m.groupdict())
                    break
            else:
                resp = Response.error("not found", 404)
        except Exception as e:  # noqa: BLE001 — API boundary
            self.logger(f"handler error {req.method} {req.path}: {e}\n" + traceback.format_exc())
            resp = Response.error(str(e), 500)
        try:
            elapsed = time.monotonic() - t0
            self._observe_stats(req, elapsed * 1e3, route)
            self._observe_slow_query(req, elapsed)
        except Exception:  # noqa: BLE001 — metrics never drop a response
            pass
        return resp

    def _observe_slow_query(self, req: Request, elapsed: float) -> None:
        """The plain-text slow-query log of ``[cluster] long-query-time``
        (JAX ``handler.py:404-422``; reference: handler.go:158-163):
        a query route slower than it logs its query text."""
        lqt = float(getattr(self.cluster, "long_query_time", 0.0) or 0.0)
        if lqt <= 0 or elapsed <= lqt or req.method != "POST" or not re.match(
                r"^/index/[^/]+/query$", req.path):
            return
        if req.header("Content-Type") == PROTOBUF:
            try:
                query_text = _decode(wire.QueryRequest, req.body).Query
            except Exception:  # noqa: BLE001 — logging only
                query_text = "<unparseable protobuf>"
        else:
            query_text = req.body[:512].decode(errors="replace")
        self.logger(f"slow query {elapsed:.3f}s: {query_text[:512]}")

    def _observe_stats(self, req: Request, ms: float, route: str | None) -> None:
        if self.stats is not None:
            # Per-endpoint latency (reference: handler.go:140-167).
            self.stats.histogram(f"http.{req.method}.{req.path.split('?')[0]}", ms)
        if route is not None:
            self.latency.observe_http(req.method, route, ms)

    # --- the web console (JAX handler.py:428-440) ---

    def handle_webui(self, req: Request) -> Response:
        return Response(body=webui.INDEX_HTML.encode(), content_type="text/html")

    def handle_webui_asset(self, req: Request, file: str) -> Response:
        asset = webui.ASSETS.get(file)
        if asset is None:
            return Response.error("not found", 404)
        body, ctype = asset
        return Response(body=body.encode(), content_type=ctype)

    # --- introspection ---

    def handle_get_schema(self, req: Request) -> Response:
        return Response.json({"indexes": self.holder.schema()})

    @property
    def cluster(self):
        return self.executor.cluster

    def handle_get_status(self, req: Request) -> Response:
        self.cluster.node_states()
        nodes = [
            {
                "Host": n.host,
                "State": n.state,
                "Indexes": self.holder.schema() if n.host == self.executor.host else [],
            }
            for n in self.cluster.nodes
        ]
        return Response.json({"status": {"Nodes": nodes}})

    def handle_get_state(self, req: Request) -> Response:
        """The node's serialized state (a NodeStatus protobuf), which the
        gossip transport's stream fallback pulls when UDP chunking stalls
        or the blob is large (JAX ``handler.py:465``)."""
        if self.state_provider is None:
            return Response.error("state provider not configured", 404)
        return Response(body=self.state_provider(), content_type=PROTOBUF)

    def handle_get_hosts(self, req: Request) -> Response:
        return Response.json([n.to_dict() for n in self.cluster.nodes])

    def handle_get_version(self, req: Request) -> Response:
        return Response.json({"version": __version__})

    def handle_get_slice_max(self, req: Request) -> Response:
        """Per-index max slice, or max inverse slice with
        ``?inverse=true`` (JAX ``handler.py:481-485``)."""
        if req.query.get("inverse") == "true":
            ms = self.holder.max_inverse_slices()
        else:
            ms = self.holder.max_slices()
        if PROTOBUF in req.header("Accept"):
            return Response.proto(wire.MaxSlicesResponse(MaxSlices=ms))
        return Response.json({"maxSlices": ms})

    def handle_get_hbm(self, req: Request) -> Response:
        """Device residency (device/pool.py): per-device budget, resident,
        pinned and high-water bytes with each device's entries in LRU
        order, the per-fragment table, and the counters."""
        return Response.json(device_mod.pool().snapshot())

    def handle_get_ingest(self, req: Request) -> Response:
        """The WAL's group-commit state (per-fragment segment sizes,
        buffered ops, last fsync and group size, appends and fsyncs),
        its replays, and the delta-scatter counters."""
        doc = {"scatter": scatter.counters(), "scatterEnabled": bool(scatter.ENABLED)}
        if self.ingest is None:
            doc["wal"] = {"walEnabled": False, "note": "ingest WAL not configured"}
        else:
            doc["wal"] = self.ingest.snapshot()
        return Response.json(doc)

    # --- observability (JAX handler.py:1849-2143) ---

    def handle_get_vars(self, req: Request) -> Response:
        """expvar equivalent (reference: handler.go:1360-1374)."""
        payload: dict[str, Any] = {
            "uptime_seconds": time.time() - self._start_time,
            "version": __version__,
            "threads": threading.active_count(),
        }
        if self.stats is not None and hasattr(self.stats, "snapshot"):
            payload["stats"] = self.stats.snapshot()
        return Response.json(payload)

    def handle_get_traces(self, req: Request) -> Response:
        """The retained query traces; ``?min_ms=`` filters on the root
        span's duration."""
        try:
            min_ms = float(req.query.get("min_ms", "0"))
        except ValueError:
            return Response.error("invalid min_ms", 400)
        return Response.json({"traces": self.tracer.traces(min_ms=min_ms)})

    def handle_get_metrics(self, req: Request) -> Response:
        """Prometheus text exposition of the stats snapshot, the launch
        telemetry's scrape-time gauges, process gauges and the native
        latency histograms."""
        snap: dict = {}
        if self.stats is not None and hasattr(self.stats, "snapshot"):
            try:
                snap = self.stats.snapshot()
            except Exception:  # noqa: BLE001 — stats must not fail the scrape
                snap = {}
        if self.admission is not None:
            # Scrape-time admission gauges (active, queued, concurrency and
            # EWMA per class; per-tenant queue depth and quota headroom).
            try:
                snap.setdefault("gauges", {}).update(self.admission.gauges())
            except Exception:  # noqa: BLE001 — stats must not fail the scrape
                pass
        dh = getattr(self.executor, "device_health", None)
        if dh is not None:
            # Scrape-time device-health gauges (device.health.state per
            # path, device.health.degraded, device.watchdogTrips).
            try:
                snap.setdefault("gauges", {}).update(dh.gauges())
            except Exception:  # noqa: BLE001 — stats must not fail the scrape
                pass
        if self.subscribe is not None:
            # Scrape-time standing-query gauges (active subscriptions,
            # pending delta bits).
            try:
                snap.setdefault("gauges", {}).update(self.subscribe.gauges())
            except Exception:  # noqa: BLE001 — stats must not fail the scrape
                pass
        try:
            snap.setdefault("gauges", {}).update(perf_mod.registry().gauges())
        except Exception:  # noqa: BLE001 — stats must not fail the scrape
            pass
        body = prom.render(
            snap,
            extra_gauges={
                "uptime_seconds": time.time() - self._start_time,
                "threads": threading.active_count(),
            },
        )
        try:
            body += self.latency.render()
        except Exception:  # noqa: BLE001 — stats must not fail the scrape
            pass
        return Response(body=body.encode(), content_type=prom.CONTENT_TYPE)

    def handle_get_health(self, req: Request) -> Response:
        """This node, the cluster's node states, the resilience wiring,
        the admission gates and the card's breaker (JAX
        ``handler.py:1860``): per path healthy/suspect/quarantined, the
        watchdog's trips and the node-level degraded flag."""
        out: dict[str, Any] = {"node": getattr(self.executor, "host", "")}
        cluster = getattr(self.executor, "cluster", None)
        if cluster is not None:
            out["nodes"] = [{"host": h, "state": st}
                            for h, st in sorted(cluster.node_states().items())]
        if self.resilience is not None:
            out.update(self.resilience.snapshot())
        if self.admission is not None:
            # Per-class gates: widths, queue bounds, occupancy, EWMA
            # service time, admitted and shed totals.
            out["admission"] = self.admission.snapshot()
        dh = getattr(self.executor, "device_health", None)
        if dh is not None:
            out["device"] = dh.snapshot()
        return Response.json(out)

    def handle_get_tenants(self, req: Request) -> Response:
        """The per-tenant QoS table (JAX ``handler.py:1885-1903``): weight,
        admitted, shed and quota-shed counts, the queue-wait EWMA and the
        quotas' headroom per tenant, and each class's queue split by
        tenant while any is backlogged."""
        if self.tenants is None:
            return Response.json({"tenants": {}})
        out: dict = {
            "defaultTenant": self.tenants.default_tenant,
            "tenants": self.tenants.snapshot(),
        }
        if self.admission is not None:
            queued = {cls: snap["queuedByTenant"]
                      for cls, snap in self.admission.snapshot().items()
                      if snap.get("queuedByTenant")}
            if queued:
                out["queuedByClass"] = queued
        return Response.json(out)

    def handle_get_perf(self, req: Request) -> Response:
        """The per-site roofline table (obs/perf.py): launches, logical and
        effective bytes, GB/s, % of the probed stream floor, p50/p99
        launch ms, occupancy, and the slowest recent launches with their
        trace ids.  ``compile_ms`` stays empty: the port builds each
        kernel once, at its first use."""
        snap = perf_mod.registry().snapshot()
        snap["compile_ms"] = {}
        return Response.json(snap)

    def handle_get_stacks(self, req: Request) -> Response:
        """Every thread's stack (``sys._current_frames``)."""
        frames = sys._current_frames()
        out = io.StringIO()
        out.write(f"{len(frames)} threads\n\n")
        for t in threading.enumerate():
            out.write(f"thread {t.name} id={t.ident} (daemon={t.daemon})\n")
            fr = frames.get(t.ident)
            if fr is not None:
                out.write("".join(traceback.format_stack(fr)))
            out.write("\n")
        return Response(body=out.getvalue().encode(), content_type="text/plain")

    def handle_get_profile(self, req: Request) -> Response:
        """On-demand profile: ``torch.profiler`` with CPU and (on a card)
        CUDA activity for ``?seconds=N`` (clamped to [0.05, 60]), its
        Chrome trace tarred under the data dir; the answer names the
        tarball.  One at a time: a concurrent request answers 409."""
        try:
            seconds = max(0.05, min(float(req.query.get("seconds", "3")), 60.0))
        except ValueError:
            return Response.error("invalid seconds", 400)
        if not self._profile_mu.acquire(blocking=False):
            return Response.error("profile already in flight", 409)
        try:
            base = self.profile_dir or tempfile.mkdtemp(prefix="pilosa-profile-")
            trace_dir = os.path.join(base, "profiles", time.strftime("trace-%Y%m%d-%H%M%S"))
            os.makedirs(trace_dir, exist_ok=True)
            try:
                _profile_into(trace_dir, seconds)
            except Exception as e:  # noqa: BLE001 — a runtime without a profiler
                shutil.rmtree(trace_dir, ignore_errors=True)
                return Response.error(f"torch profiler unavailable: {e}", 501)
            tar_path = trace_dir + ".tar.gz"
            with tarfile.open(tar_path, "w:gz") as tf:
                tf.add(trace_dir, arcname=os.path.basename(trace_dir))
            shutil.rmtree(trace_dir, ignore_errors=True)
            return Response.json(
                {"seconds": seconds, "trace": tar_path, "bytes": os.path.getsize(tar_path)}
            )
        finally:
            self._profile_mu.release()

    def handle_get_pprof(self, req: Request, rest: str | None = None) -> Response:
        """The reference's net/http/pprof mount, in Python (reference:
        handler.go:111-112): ``/debug/pprof`` or ``/goroutine`` thread
        stacks; ``/profile?seconds=N`` (default 5, at most 60) every
        thread's stack sampled at ~100 Hz, folded ("f1;f2;f3 count");
        ``/heap`` tracemalloc's top allocations (``?start=1`` /
        ``?stop=1``)."""
        kind = (rest or "/").strip("/") or "goroutine"
        if kind == "goroutine":
            frames = sys._current_frames()
            out = io.StringIO()
            for t in threading.enumerate():
                out.write(f"thread {t.name} (daemon={t.daemon})\n")
                fr = frames.get(t.ident)
                if fr is not None:
                    out.write("".join(traceback.format_stack(fr)))
                out.write("\n")
            return Response(body=out.getvalue().encode(), content_type="text/plain")
        if kind == "profile":
            try:
                seconds = min(float(req.query.get("seconds", "5")), 60.0)
            except ValueError:
                return Response.error("invalid seconds", 400)
            return Response(body=_sample_cpu_profile(seconds).encode(), content_type="text/plain")
        if kind == "heap":
            import tracemalloc

            if req.query.get("start"):
                tracemalloc.start(16)
                return Response(body=b"tracemalloc started\n", content_type="text/plain")
            if req.query.get("stop"):
                tracemalloc.stop()
                return Response(body=b"tracemalloc stopped\n", content_type="text/plain")
            if not tracemalloc.is_tracing():
                return Response(body=b"tracemalloc not tracing; GET ?start=1 first\n",
                                content_type="text/plain")
            out = io.StringIO()
            for stat in tracemalloc.take_snapshot().statistics("lineno")[:50]:
                out.write(f"{stat}\n")
            return Response(body=out.getvalue().encode(), content_type="text/plain")
        return Response.error(f"unknown profile: {kind}", 404)

    # --- the data plane of backup, restore, export and block sync (JAX
    # handler.py:1247-1435) ---

    def handle_get_export(self, req: Request) -> Response:
        """One fragment's CSV, streamed (reference: handler.go:1049-1098)."""
        if "text/csv" not in req.header("Accept"):
            return Response.error("not acceptable", 406)
        index = req.query.get("index", "")
        frame = req.query.get("frame", "")
        view = req.query.get("view", "")
        try:
            slice_i = int(req.query.get("slice", ""))
        except ValueError:
            return Response.error("invalid slice", 400)
        owners = {n.host for n in self.cluster.fragment_nodes(index, slice_i)}
        if self.executor.host not in owners:
            return Response.error("host does not own slice", 412)
        frag = self.holder.fragment(index, frame, view, slice_i)
        if frag is None:
            return Response.error("fragment not found", 404)
        return Response.stream(frag.csv_chunks(), "text/csv", chunk_bytes=self.stream_chunk_bytes)

    def _fragment_from_query(self, req: Request):
        slice_s = req.query.get("slice", "")
        if not slice_s.isdigit():
            return None, Response.error("slice required", 400)
        frag = self.holder.fragment(req.query.get("index", ""), req.query.get("frame", ""),
                                    req.query.get("view", ""), int(slice_s))
        if frag is None:
            return None, Response.error("fragment not found", 404)
        return frag, None

    def handle_get_fragment_data(self, req: Request) -> Response:
        """One fragment's archive, streamed (reference: handler.go:1102-1123)."""
        frag, err = self._fragment_from_query(req)
        if err:
            return err
        return Response.stream(frag.tar_chunks(chunk_bytes=self.stream_chunk_bytes),
                               "application/octet-stream", chunk_bytes=self.stream_chunk_bytes)

    @admitted(adm.CLASS_INTERNAL)
    @stream_body
    def handle_post_fragment_data(self, req: Request) -> Response:
        """Restore one fragment from the archive in the body, read as it
        arrives and verified before anything is applied (422 for a torn
        one); ``?stage=true`` stages the fragment's mirror afterwards."""
        slice_s = req.query.get("slice", "")
        if not slice_s.isdigit():
            return Response.error("slice required", 400)
        f = self.holder.frame(req.query.get("index", ""), req.query.get("frame", ""))
        if f is None:
            return Response.error("frame not found", 404)
        frag = f.create_view_if_not_exists(req.query.get("view", "")).create_fragment_if_not_exists(
            int(slice_s))
        try:
            frag.read_from(req.body_reader())
        except ArchiveChecksumError as e:
            return Response.error(str(e), 422)
        if req.query.get("stage") == "true" and self.prefetcher is not None:
            self.prefetcher.stage([frag])
        return Response.json({})

    def handle_get_fragment_blocks(self, req: Request) -> Response:
        frag, err = self._fragment_from_query(req)
        if err:
            return err
        blocks = [{"id": bid, "checksum": base64.b64encode(chk).decode()}
                  for bid, chk in frag.blocks()]
        return Response.json({"blocks": blocks})

    def handle_get_fragment_block_data(self, req: Request) -> Response:
        """A block's bits, protobuf in and out (reference: handler.go:1213-1246)."""
        try:
            pb = _decode(wire.BlockDataRequest, req.body)
        except _ParseError as e:
            return Response.error(str(e), 400)
        frag = self.holder.fragment(pb.Index, pb.Frame, pb.View, pb.Slice)
        if frag is None:
            return Response.error("fragment not found", 404)
        rows, cols = frag.block_arrays(pb.Block)
        return Response.proto(wire.BlockDataResponse(RowIDs=rows, ColumnIDs=cols))

    @admitted(adm.CLASS_INTERNAL)
    def handle_post_import_view(self, req: Request) -> Response:
        """Sets and clears in one view of one slice — the repair push of
        block sync for any view, time and inverse views included."""
        try:
            pb = _decode(wire.ImportViewRequest, req.body)
        except _ParseError as e:
            return Response.error(str(e), 400)
        if not self.cluster.is_write_owner(self.executor.host, pb.Index, pb.Slice):
            return Response.error(
                f"host does not own slice {self.executor.host} slice={pb.Slice}", 412
            )
        f = self.holder.frame(pb.Index, pb.Frame)
        if f is None:
            return Response.error("frame not found", 404)
        if len(pb.RowIDs) != len(pb.ColumnIDs) or len(pb.ClearRowIDs) != len(pb.ClearColumnIDs):
            return Response.error("row/column id length mismatch", 400)
        try:
            frag = f.create_view_if_not_exists(pb.View).create_fragment_if_not_exists(pb.Slice)
            for r, c in zip(pb.RowIDs, pb.ColumnIDs):
                frag.set_bit(int(r), int(c))
            for r, c in zip(pb.ClearRowIDs, pb.ClearColumnIDs):
                frag.clear_bit(int(r), int(c))
        except Exception as e:  # noqa: BLE001 — write boundary
            return Response.proto(wire.ImportResponse(Err=str(e)), status=500)
        return Response.proto(wire.ImportResponse())

    def handle_get_fragment_nodes(self, req: Request) -> Response:
        """Owners of a slice.  ``?write=true`` asks for the write owners:
        both rings' during a resize, so that an import's fan-out writes
        a moving slice on both."""
        index = req.query.get("index", "")
        try:
            slice_i = int(req.query.get("slice", ""))
        except ValueError:
            return Response.error("invalid slice", 400)
        if req.query.get("write") == "true":
            nodes = self.cluster.write_nodes(index, slice_i)
        else:
            nodes = self.cluster.fragment_nodes(index, slice_i)
        return Response.json([n.to_dict() for n in nodes])

    # --- resize, topology events and the migration's data plane (JAX
    # handler.py:1436-1530) ---

    def handle_post_resize(self, req: Request) -> Response:
        """Start (or resume) a live resize to ``{"hosts": [...]}``, the
        whole target host list; this node coordinates it, and ``GET
        /debug/rebalance`` shows its progress."""
        if self.rebalance is None:
            return Response.error("rebalance not configured", 501)
        try:
            payload = json.loads(req.body or b"{}")
        except json.JSONDecodeError as e:
            return Response.error(str(e), 400)
        hosts = payload.get("hosts")
        if not isinstance(hosts, list) or not all(isinstance(h, str) and h for h in hosts):
            return Response.error("hosts must be a non-empty string list", 400)
        try:
            return Response.json(self.rebalance.start_resize(hosts))
        except Exception as e:  # noqa: BLE001 — operator boundary
            return Response.error(str(e), 409)

    def handle_post_resize_abort(self, req: Request) -> Response:
        if self.rebalance is None:
            return Response.error("rebalance not configured", 501)
        try:
            return Response.json(self.rebalance.abort())
        except Exception as e:  # noqa: BLE001 — operator boundary
            return Response.error(str(e), 409)

    @admitted(adm.CLASS_INTERNAL, requires="rebalance")
    def handle_post_topology(self, req: Request) -> Response:
        """A topology event (begin, flip, unflip, commit, abort) from the
        resize's coordinator."""
        try:
            return Response.json(self.rebalance.apply_event(json.loads(req.body or b"{}")))
        except Exception as e:  # noqa: BLE001 — peer boundary
            return Response.error(str(e), 400)

    @admitted(adm.CLASS_INTERNAL, requires="rebalance")
    def handle_post_rebalance_delta(self, req: Request) -> Response:
        """Migration control on a source (or a checksum on any node):
        start or stop the slice's delta log, copy the slice to a target,
        replay the drained log, or answer per-view checksums."""
        try:
            return Response.json(self.rebalance.delta_action(json.loads(req.body or b"{}")))
        except Exception as e:  # noqa: BLE001 — peer boundary
            return Response.error(str(e), 400)

    @admitted(adm.CLASS_INTERNAL, requires="rebalance")
    def handle_post_rebalance_release(self, req: Request) -> Response:
        """Drop a slice moved away (mirrors and files); refused while
        this node still owns it."""
        try:
            payload = json.loads(req.body or b"{}")
            return Response.json(self.rebalance.release_slice(
                str(payload.get("index", "")), int(payload.get("slice", 0))))
        except Exception as e:  # noqa: BLE001 — peer boundary
            return Response.error(str(e), 409)

    # --- quorum replication: versions, hints, replay (JAX
    # handler.py:1595-1700) ---

    @admitted(adm.CLASS_INTERNAL, requires="replication")
    def handle_post_replicate_versions(self, req: Request) -> Response:
        """``{"index", "slices"}`` answers the slices' write versions;
        ``{"action": "observe", "index", "slice", "version"}`` moves one
        forward (max-merge)."""
        try:
            payload = json.loads(req.body or b"{}")
            index = str(payload.get("index", ""))
            if payload.get("action") == "observe":
                v = self.replication.versions.observe(
                    index, int(payload.get("slice", 0)), int(payload.get("version", 0)))
                return Response.json({"ok": True, "version": v})
            versions = self.replication.versions.get_many(index, payload.get("slices") or [])
            return Response.json({"versions": {str(k): v for k, v in versions.items()}})
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            return Response.error(str(e), 400)

    @admitted(adm.CLASS_INTERNAL, requires="replication")
    def handle_post_replicate_hint(self, req: Request) -> Response:
        """Queue a write on this node as a hint for an unreachable
        replica: ``{"target", "index", "slice", "kind": import |
        import-value | pql, "payload" (base64) | "query", "rows"}``."""
        try:
            payload = json.loads(req.body or b"{}")
            target = str(payload.get("target", ""))
            index = str(payload.get("index", ""))
            slice_i = int(payload.get("slice", 0))
            kind = str(payload.get("kind", ""))
            if not target or not index:
                return Response.error("target and index required", 400)
            hints = self.replication.hints
            if kind == "pql":
                queued = hints.queue_pql(target, index, slice_i, str(payload.get("query", "")))
            else:
                queued = hints.queue_payload(
                    target, index, slice_i, kind,
                    base64.b64decode(payload.get("payload", "")), int(payload.get("rows", 1)))
            if queued:
                self.replication.stats.count("cluster.replication.hintsQueued")
            return Response.json({"queued": bool(queued)})
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            return Response.error(str(e), 400)

    @admitted(adm.CLASS_INTERNAL, requires="replication")
    def handle_post_replicate_replay(self, req: Request) -> Response:
        """Replay hints now (``{"target"?: host}``), past the breaker;
        answers the entries replayed per target."""
        try:
            payload = json.loads(req.body or b"{}")
            target = str(payload.get("target", "")) or None
            return Response.json({"replayed": self.replication.replay_now(target)})
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            return Response.error(str(e), 400)

    def handle_get_replication(self, req: Request) -> Response:
        """The consistency defaults, each replica's hint backlog, the
        local slice versions and the replayer's state."""
        if self.replication is None:
            return Response.json({"hints": {}, "note": "replication not configured"})
        return Response.json(self.replication.snapshot())

    # --- the cold tier (JAX handler.py:1528-1572) ---

    @admitted(adm.CLASS_INTERNAL, requires="tier")
    def handle_post_tier_restore(self, req: Request) -> Response:
        """The target side of a resize's copy through the store: restore
        one fragment from this node's object store instead of a peer's
        stream, and stage its mirror.  501 without a tier, so that the
        source streams instead."""
        try:
            payload = json.loads(req.body or b"{}")
            index = str(payload.get("index", ""))
            frame = str(payload.get("frame", ""))
            view = str(payload.get("view", ""))
            slice_i = int(payload.get("slice", 0))
            nbytes = self.tier.restore_from_store(index, frame, view, slice_i)
            if self.prefetcher is not None:
                frag = self.holder.fragment(index, frame, view, slice_i)
                if frag is not None:
                    self.prefetcher.stage([frag])
            return Response.json({"bytes": nbytes})
        except Exception as e:  # noqa: BLE001 — peer boundary
            return Response.error(str(e), 409)

    def handle_get_tier(self, req: Request) -> Response:
        """Per-fragment tier states with their transition history, counts
        by state, local bytes against the budget, the retention settings
        and the store client's health."""
        if self.tier is None:
            return Response.json({"fragments": {}, "note": "tier not configured"})
        return Response.json(self.tier.snapshot())

    # --- standing queries (JAX handler.py:1702-1811) ---

    @admitted(adm.CLASS_SUBSCRIBE, requires="subscribe")
    def handle_post_subscribe(self, req: Request) -> Response:
        """Register a standing query from JSON ``{"index": ..., "query":
        "Subscribe(Count(...))"}``; answers 201 with the subscription's id
        and its registration snapshot (version 1), from which a client
        streams or long-polls."""
        try:
            payload = json.loads(req.body or b"{}")
        except ValueError as e:
            return Response.error(f"bad request body: {e}", 400)
        if not isinstance(payload, dict):
            return Response.error("bad request body: expected object", 400)
        index = payload.get("index") or req.query.get("index", "")
        query = payload.get("query", "")
        if not index or not query:
            return Response.error("index and query required", 400)
        try:
            sub = self.subscribe.register(index, query)
        except (subscribe_reg.SubscribeError, ParseError, plan_mod.PlanError, ExecutorError) as e:
            # The registration compiles and evaluates the query, so the
            # executor's rejections are the client's errors here.
            return Response.error(str(e), 400)
        return Response.json(
            {
                "id": sub.id,
                "index": sub.index,
                "kind": sub.kind,
                "version": sub.version,
                "epoch": sub.epoch,
                "value": sub.value_json,
            },
            status=201,
        )

    def _subscription_for(self, sid: str):
        if self.subscribe is None:
            return None, Response.error("subscribe not configured", 501)
        sub = self.subscribe.get(sid)
        if sub is None:
            return None, Response.error(f"no such subscription: {sid}", 404)
        return sub, None

    def handle_get_subscribe_stream(self, req: Request, sid: str) -> Response:
        """SSE: every retained update newer than ``?after=`` (version
        order, at least once), then live updates as the notifier
        publishes them, with keepalive comments while idle."""
        sub, err = self._subscription_for(sid)
        if err is not None:
            return err
        try:
            after = int(req.query.get("after", "0"))
        except ValueError:
            return Response.error("invalid after", 400)
        gen = sse_mod.event_stream(self.subscribe, sub, after)
        return Response(body_iter=sse_mod.EventBody(gen), content_type=sse_mod.CONTENT_TYPE)

    def handle_get_subscribe_poll(self, req: Request, sid: str) -> Response:
        """Long-poll: wait until the subscription moves past ``?after=``
        or ``?timeout_ms=`` (at most 120 s) passes; a timeout answers 200
        with ``"timeout": true``, an unsubscribe mid-wait 410."""
        sub, err = self._subscription_for(sid)
        if err is not None:
            return err
        try:
            after = int(req.query.get("after", "0"))
            timeout_ms = float(req.query.get("timeout_ms", "30000"))
        except ValueError:
            return Response.error("invalid after/timeout_ms", 400)
        timeout_ms = max(0.0, min(timeout_ms, 120_000.0))
        upd = self.subscribe.wait_update(sub, after, timeout=timeout_ms / 1000.0)
        if upd is None:
            if sub.closed:
                return Response.error("subscription closed", 410)
            return Response.json({"id": sub.id, "version": after, "timeout": True})
        return Response.json(upd)

    def handle_delete_subscribe(self, req: Request, sid: str) -> Response:
        if self.subscribe is None:
            return Response.error("subscribe not configured", 501)
        if not self.subscribe.unregister(sid):
            return Response.error(f"no such subscription: {sid}", 404)
        return Response.json({"unsubscribed": sid})

    def handle_get_subscriptions(self, req: Request) -> Response:
        """Registry size, pending deltas, notification lag percentiles,
        lifetime counters and the first page of subscriptions."""
        if self.subscribe is None:
            return Response.json({"count": 0, "note": "subscribe not configured"})
        return Response.json(self.subscribe.snapshot())

    def handle_get_rebalance(self, req: Request) -> Response:
        """The topology epoch and transition, the coordinator's per-slice
        states, the delta logs and join candidates."""
        if self.rebalance is None:
            return Response.json({"transition": None, "running": False,
                                  "note": "rebalance not configured"})
        return Response.json(self.rebalance.snapshot())

    def _broadcast(self, msg) -> None:
        if self.broadcaster is not None:
            try:
                self.broadcaster.send_sync(msg)
            except RuntimeError as e:  # peers that missed it learn by polling
                print(f"broadcast error: {e}", file=sys.stderr)

    # --- index CRUD ---

    def handle_get_index(self, req: Request, index: str) -> Response:
        idx = self.holder.index(index)
        if idx is None:
            return Response.error("index not found", 404)
        return Response.json({"index": {"name": idx.name}})

    def handle_post_index(self, req: Request, index: str) -> Response:
        options = {}
        if req.body:
            try:
                payload = json.loads(req.body)
            except json.JSONDecodeError as e:
                return Response.error(str(e), 400)
            options = payload.get("options", {}) or {}
        kwargs = {}
        if "columnLabel" in options:
            kwargs["column_label"] = options["columnLabel"]
        if "timeQuantum" in options:
            kwargs["time_quantum"] = options["timeQuantum"]
        if self.holder.index(index) is not None:
            return Response.error("index already exists", 409)
        try:
            idx = self.holder.create_index(index, **kwargs)
        except ValueError as e:
            return Response.error(str(e), 400)
        self._broadcast(
            wire.CreateIndexMessage(
                Index=index,
                Meta=wire.IndexMeta(ColumnLabel=idx.column_label, TimeQuantum=idx.time_quantum),
            )
        )
        return Response.json({})

    def handle_delete_index(self, req: Request, index: str) -> Response:
        self.holder.delete_index(index)
        self._broadcast(wire.DeleteIndexMessage(Index=index))
        return Response.json({})

    def handle_patch_index_time_quantum(self, req: Request, index: str) -> Response:
        try:
            payload = json.loads(req.body)
        except json.JSONDecodeError as e:
            return Response.error(str(e), 400)
        try:
            q = parse_time_quantum(payload.get("timeQuantum", ""))
        except ValueError:
            return Response.error("invalid time quantum", 400)
        idx = self.holder.index(index)
        if idx is None:
            return Response.error("index not found", 404)
        idx.set_time_quantum(q)
        return Response.json({})

    def handle_post_index_attr_diff(self, req: Request, index: str) -> Response:
        idx = self.holder.index(index)
        if idx is None:
            return Response.error("index not found", 404)
        return self._attr_diff(req, idx.column_attr_store)

    def _attr_diff(self, req: Request, store) -> Response:
        """The attributes of every block whose checksum differs from the
        caller's (reference: handler.go:514-570, 782-838)."""
        try:
            payload = json.loads(req.body)
        except json.JSONDecodeError as e:
            return Response.error(str(e), 400)
        remote = [(b["id"], base64.b64decode(b["checksum"])) for b in payload.get("blocks", [])]
        attrs: dict[str, dict] = {}
        for bid in attr_mod.diff_blocks(store.blocks(), remote):
            for id_, a in store.block_data(bid).items():
                attrs[str(id_)] = a
        return Response.json({"attrs": attrs})

    # --- frame CRUD ---

    def handle_post_frame(self, req: Request, index: str, frame: str) -> Response:
        idx = self.holder.index(index)
        if idx is None:
            return Response.error("index not found", 404)
        options = {}
        if req.body:
            try:
                payload = json.loads(req.body)
            except json.JSONDecodeError as e:
                return Response.error(str(e), 400)
            options = payload.get("options", {}) or {}
        kwargs = {py: options[js] for js, py in _FRAME_OPTIONS if js in options}
        if idx.frame(frame) is not None:
            return Response.error("frame already exists", 409)
        try:
            f = idx.create_frame(frame, **kwargs)
        except (ValueError, RuntimeError) as e:
            return Response.error(str(e), 400)
        # The frame exists and its .meta is written; options the wire
        # cannot carry fail here, on every node, as the JAX package's
        # generated message does (500 through the dispatcher).
        meta = wire.FrameMeta(
            RowLabel=f.row_label,
            InverseEnabled=f.inverse_enabled,
            CacheType=f.cache_type,
            CacheSize=f.cache_size,
            TimeQuantum=f.time_quantum,
        )
        self._broadcast(wire.CreateFrameMessage(Index=index, Frame=frame, Meta=meta))
        return Response.json({})

    def handle_delete_frame(self, req: Request, index: str, frame: str) -> Response:
        idx = self.holder.index(index)
        if idx is None:
            return Response.error("index not found", 404)
        idx.delete_frame(frame)
        self._broadcast(wire.DeleteFrameMessage(Index=index, Frame=frame))
        return Response.json({})

    def handle_patch_frame_time_quantum(self, req: Request, index: str, frame: str) -> Response:
        try:
            payload = json.loads(req.body)
        except json.JSONDecodeError as e:
            return Response.error(str(e), 400)
        try:
            q = parse_time_quantum(payload.get("timeQuantum", ""))
        except ValueError:
            return Response.error("invalid time quantum", 400)
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        f.set_time_quantum(q)
        return Response.json({})

    def handle_get_frame_views(self, req: Request, index: str, frame: str) -> Response:
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        return Response.json({"views": sorted(f.views().keys())})

    def handle_post_frame_attr_diff(self, req: Request, index: str, frame: str) -> Response:
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        return self._attr_diff(req, f.row_attr_store)

    def handle_post_frame_restore(self, req: Request, index: str, frame: str) -> Response:
        """Pull every view and slice of a frame from the node ``?host=``
        (reference: handler.go:1253-1341), each archive read into its
        fragment as it arrives."""
        host = req.query.get("host")
        if not host:
            return Response.error("host required", 400)
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        if self.executor.client_factory is None:
            return Response.error("no client", 500)
        client = self.executor.client_factory(host)
        max_slices = client.max_slice_by_index()
        max_inverse = client.max_slice_by_index(inverse=True)
        for view_name in client.frame_views(index, frame):
            src_max = max_inverse if is_inverse_view(view_name) else max_slices
            for slice_i in range(src_max.get(index, 0) + 1):
                view = f.create_view_if_not_exists(view_name)
                frag = view.create_fragment_if_not_exists(slice_i)
                src = client.stream_backup_slice(index, frame, view_name, slice_i)
                if src is None:
                    continue
                with src:
                    frag.read_from(src)
        return Response.json({})

    # --- BSI fields (JAX handler.py:686-765) ---
    #
    # The protobuf FrameMeta broadcast predates BSI, so a field's creation
    # and deletion go to every peer as the same HTTP request with
    # ``?remote=true``; each node keeps the field in its frame's .meta.

    def handle_get_frame_fields(self, req: Request, index: str, frame: str) -> Response:
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        return Response.json({"fields": [fld.to_dict() for fld in f.bsi_fields()]})

    def handle_post_frame_field(self, req: Request, index: str, frame: str, fld: str) -> Response:
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        try:
            payload = json.loads(req.body) if req.body else {}
        except json.JSONDecodeError as e:
            return Response.error(str(e), 400)
        try:
            lo = int(payload.get("min", 0))
            hi = int(payload.get("max", 0))
        except (TypeError, ValueError):
            return Response.error("min/max must be integers", 400)
        remote = req.query.get("remote") == "true"
        if remote and not f.range_enabled:
            # The relayed leg implies range support: the coordinator
            # validated the schema rules.
            f.set_options(range_enabled=True)
        try:
            f.create_field(fld, lo, hi)
        except bsi.BSIError as e:
            return Response.error(str(e), 400)
        except Exception as e:  # noqa: BLE001 — duplicate / not range-enabled
            return Response.error(str(e), 409)
        if not remote:
            self._fanout_field(
                "POST",
                f"/index/{index}/frame/{frame}/field/{fld}",
                json.dumps({"min": lo, "max": hi}).encode(),
            )
        return Response.json({})

    def handle_delete_frame_field(self, req: Request, index: str, frame: str, fld: str) -> Response:
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        try:
            f.delete_field(fld)
        except Exception as e:  # noqa: BLE001 — unknown field
            return Response.error(str(e), 404)
        if req.query.get("remote") != "true":
            self._fanout_field("DELETE", f"/index/{index}/frame/{frame}/field/{fld}", b"")
        return Response.json({})

    def _fanout_field(self, method: str, path: str, body: bytes) -> None:
        """Relay a field schema change to every other node.  Errors are
        collected and raised as one AFTER every reachable peer got the
        change."""
        factory = self.executor.client_factory
        if factory is None:
            return
        errs = []
        for node in self.cluster.nodes:
            if node.host == self.executor.host:
                continue
            try:
                client = factory(node.host)
                status, data = client._request(method, path, query={"remote": "true"}, body=body)
                client._check(status, data)
            except Exception as e:  # noqa: BLE001 — collect per host
                errs.append(f"{node.host}: {e}")
        if errs:
            raise RuntimeError("field fanout: " + "; ".join(errs))

    @admitted(adm.CLASS_WRITE)
    def handle_post_import_value(self, req: Request) -> Response:
        """Columnar integer import (JAX handler.py:769-815):
        ``{"index","frame","field","slice","columnIDs":[],"values":[]}``
        — one value per column, written as set+clear passes over the
        field's planes (``Frame.import_value``).  Ownership-guarded like
        /import; the client sends a slice's values to every owner."""
        try:
            payload = json.loads(req.body)
        except json.JSONDecodeError as e:
            return Response.error(str(e), 400)
        index = payload.get("index", "")
        frame = payload.get("frame", "")
        field_name = payload.get("field", "")
        slice_i = payload.get("slice", 0)
        cols = payload.get("columnIDs", [])
        vals = payload.get("values", [])
        if not isinstance(cols, list) or not isinstance(vals, list) or len(cols) != len(vals):
            return Response.error("columnIDs/values must be equal-length lists", 400)
        if not self.cluster.is_write_owner(self.executor.host, index, slice_i):
            return Response.error(
                f"host does not own slice {self.executor.host} slice={slice_i}", 412
            )
        f = self.holder.frame(index, frame)
        if f is None:
            return Response.error("frame not found", 404)
        try:
            f.import_value(field_name, cols, vals)
        except Exception as e:  # noqa: BLE001 — unknown field / out of range
            return Response.error(str(e), 400)
        return Response.json({})

    # --- query (reference: handler.go:863-944) ---

    def handle_post_query(self, req: Request, index: str) -> Response:
        """The traced query entry (JAX ``handler.py:823``): the root span
        opens here, continuing a propagated trace on a remote leg; the
        finished trace goes to the ring, back to the coordinator in
        ``X-Trace-Spans`` (a remote leg), or to the slow-query log."""
        in_trace = req.header(trace.TRACE_HEADER)
        root = self.tracer.start_trace(
            "query",
            trace_id=in_trace or None,
            parent_span_id=req.header(trace.SPAN_HEADER) or None,
            index=index,
            node=getattr(self.executor, "host", ""),
        )
        # The request's X-Deadline-Ms (a remote leg, or a client's own)
        # wins over the configured default; every remote leg, retry and
        # wait under execute() takes its timeout from what is left.
        if self.resilience is not None:
            dl = self.resilience.query_deadline(req.header(rz.DEADLINE_HEADER))
        else:
            dl = rz.Deadline.from_header(req.header(rz.DEADLINE_HEADER))
        token = root.activate()
        t0 = time.monotonic()
        try:
            with rz.deadline_scope(dl):
                resp = self._handle_post_query(req, index, root)
        finally:
            root.deactivate(token)
            record = self.tracer.finish_root(root)
            try:
                self.latency.observe_query(
                    str(root.tags.get("cost_class") or "unclassified"),
                    (time.monotonic() - t0) * 1e3,
                    tenant=str(root.tags.get("tenant") or ""),
                )
            except Exception:  # noqa: BLE001 — metrics never drop a response
                pass
        if record is not None:
            if in_trace:
                resp.headers[trace.SPANS_HEADER] = self.tracer.export_payload(record)
            elif self.slow_query_ms > 0 and record["duration_ms"] >= self.slow_query_ms:
                try:
                    self._log_slow_query(index, root, record)
                except Exception:  # noqa: BLE001 — logging never drops a response
                    pass
        return resp

    def _log_slow_query(self, index: str, root, record: dict) -> None:
        """One structured line per slow coordinator query."""
        line = {
            "ms": record["duration_ms"],
            "index": index,
            "query": root.tags.get("query", ""),
            "slices": root.tags.get("slices", "all"),
            "trace_id": record["trace_id"],
            "stages": trace.stage_breakdown(record),
        }
        co = _coalesce_batch_stats(record)
        if co is not None:
            line["coalesce"] = co
        fu = _fuse_batch_stats(record)
        if fu is not None:
            line["fuse"] = fu
        self.logger("slow query " + json.dumps(line, sort_keys=True))

    def _handle_post_query(self, req: Request, index: str, root) -> Response:
        try:
            qreq = self._read_query_request(req)
        except _ParseError as e:  # the JAX package's dispatcher answers it
            return Response.error(str(e), 500)
        except ValueError as e:
            return self._query_error(req, str(e), 400)
        root.annotate(
            query=qreq["query"][:512],
            slices=qreq["slices"] if qreq["slices"] is not None else "all",
            remote=qreq["remote"],
        )
        try:
            with self.tracer.span("parse"):
                q = parse_string(qreq["query"])
        except Exception as e:  # noqa: BLE001 — parser error
            return self._query_error(req, str(e), 400)
        # Per-request consistency: the header wins over the URL; junk is
        # a 400, not a silent default.
        try:
            write_consistency = _consistency_arg(req, "X-Write-Consistency", "writeConsistency")
            read_consistency = _consistency_arg(req, "X-Read-Consistency", "readConsistency")
        except ValueError as e:
            return self._query_error(req, str(e), 400)
        # The Remote flag earns the internal lane only with the cluster's
        # token, where one is configured: a client spoofing it is charged
        # and classified as any client.  A verified leg is charged to the
        # origin tenant its coordinator forwards in X-Tenant.
        internal = qreq["remote"] and self._internal_ok(req)
        tenant = self._resolve_tenant(req, internal)
        opt = ExecOptions(
            remote=qreq["remote"],
            allow_partial=(req.query.get("allowPartial") == "true"
                           or req.header("X-Allow-Partial") in ("1", "true")),
            write_consistency=write_consistency,
            read_consistency=read_consistency,
            tenant=tenant,
        )
        # A remote write leg carries the coordinator's slice version after
        # its own apply.  Applying the same write here should bring this
        # replica's version to the stamp; landing short means it missed
        # earlier writes (cluster.replication.staleSelf).
        stale_probe = None
        if qreq["remote"] and self.replication is not None:
            stamp = req.header(replicate_mod.WRITE_VERSION_HEADER)
            if stamp:
                try:
                    slice_s, _, ver_s = stamp.partition(":")
                    stale_probe = (int(slice_s), int(ver_s))
                except (TypeError, ValueError):
                    pass  # a malformed stamp must not fail the write
        # The admission gate (JAX handler.py:965-1010): the class from the
        # parsed plan (a verified remote leg rides the internal lane), then
        # admit or answer 429 before the executor, the coalescer or the
        # card see the query.  The class also keys the latency histograms,
        # with or without gates.
        cls = adm.CLASS_INTERNAL if internal else plan_mod.cost_class(q.calls)
        root.annotate(cost_class=cls)
        if tenant:
            root.annotate(tenant=tenant)
        ticket = None
        if self.admission is not None:
            try:
                with self.tracer.span("admission", cost_class=cls) as sp:
                    ticket = self.admission.acquire(cls, tenant=tenant,
                                                    nbytes=len(req.body or b""))
                    sp.annotate(wait_ms=round(ticket.wait_ms, 3))
            except rz.ShedError as e:
                root.annotate(shed=True)
                return self._shed_response(req, e)
        try:
            rz.check_deadline("before execute")
            with self.tracer.span("execute"):
                results = self.executor.execute(index, q, qreq["slices"], opt)
        except TooManyWritesError as e:
            return self._query_error(req, str(e), 413)
        except rz.DeadlineExceeded as e:
            root.annotate(error="DeadlineExceeded")
            trace_id = getattr(root, "trace_id", "") or "none"
            return self._query_error(req, f"{e} [trace {trace_id}]", 504)
        except Exception as e:  # noqa: BLE001 — executor boundary
            return self._query_error(req, str(e), 500)
        finally:
            if ticket is not None:
                ticket.release()
        if stale_probe is not None:
            probe_slice, probe_ver = stale_probe
            if self.replication.versions.get(index, probe_slice) < probe_ver:
                self.replication.stats.count("cluster.replication.staleSelf")
                root.annotate(stale_self=True)

        column_attr_sets = None
        if qreq["column_attrs"]:
            idx = self.holder.index(index)
            column_ids: set[int] = set()
            for r in results:
                if isinstance(r, RowBitmap):
                    column_ids |= set(r.bits())
            column_attr_sets = []
            if idx is not None:
                for cid in sorted(column_ids):
                    attrs = idx.column_attr_store.attrs(cid)
                    if attrs:
                        column_attr_sets.append((cid, attrs))
        if PROTOBUF in req.header("Accept"):
            resp = Response.proto(codec.response_to_proto(results, column_attr_sets))
            if opt.missing_slices:
                # The protobuf answer has no partial field: the lost
                # slices travel in a header.
                resp.headers["X-Missing-Slices"] = ",".join(str(s) for s in opt.missing_slices)
            return resp
        payload = codec.response_to_json(results, column_attr_sets)
        if opt.missing_slices:
            payload["partial"] = True
            payload["missingSlices"] = opt.missing_slices
        return Response.json(payload)

    def _query_error(self, req: Request, message: str, status: int) -> Response:
        if PROTOBUF in req.header("Accept"):
            return Response.proto(wire.QueryResponse(Err=message), status=status)
        return Response.error(message, status)

    # --- admission and tenants (JAX handler.py:1110-1195) ---

    def _internal_ok(self, req: Request) -> bool:
        """May this request claim the internal lane?  Open without a
        registry or a token; with a token, only for its holders."""
        if self.tenants is None:
            return True
        return self.tenants.internal_ok(req.header("X-Internal-Token"))

    def _resolve_tenant(self, req: Request, internal: bool = False) -> str:
        """The tenant a request is charged to: a client's by X-Api-Key (a
        bare X-Tenant only for configured tenants); a verified internal
        request's the forwarded X-Tenant, the origin's."""
        if self.tenants is None:
            return ""
        if internal:
            return req.header("X-Tenant") or self.tenants.default_tenant
        return self.tenants.resolve(req.header("X-Api-Key"), req.header("X-Tenant"))

    def _shed_response(self, req: Request, e: rz.ShedError) -> Response:
        """429 with ``Retry-After`` in whole seconds (at least 1) and the
        precise ``retryAfterMs`` in the JSON body; a quota shed adds
        ``X-Quota-Limit`` / ``X-Quota-Remaining`` and the body's
        ``quota``."""
        if PROTOBUF in req.header("Accept"):
            resp = Response.proto(wire.QueryResponse(Err=str(e)), status=429)
        else:
            body = {"error": str(e), "retryAfterMs": round(e.retry_after_s * 1000.0, 1)}
            if isinstance(e, adm.QuotaError):
                body["quota"] = {
                    "tenant": e.tenant,
                    "kind": e.quota_kind,
                    "limit": e.quota_limit,
                    "remaining": round(e.quota_remaining, 3),
                }
            resp = Response.json(body, status=429)
        resp.headers["Retry-After"] = str(max(1, math.ceil(e.retry_after_s)))
        if isinstance(e, adm.QuotaError):
            resp.headers["X-Quota-Limit"] = f"{e.quota_limit:g}"
            resp.headers["X-Quota-Remaining"] = f"{max(0.0, e.quota_remaining):g}"
        return resp

    def _admit(self, cls: str, req: Request):
        """Admission of a non-query route: ``(ticket, None)`` or ``(None,
        429 response)``.  The deadline is the request's header alone (these
        routes run outside the query's deadline scope).  ``X-Internal-Lane``
        moves the request to the internal lane, with the token where one is
        configured: hint replays push queued ``/import`` bodies through the
        client route and must not be shed as a client storm."""
        if self.admission is None:
            return None, None
        internal = False
        if req.header("X-Internal-Lane") in ("1", "true") and self._internal_ok(req):
            cls = adm.CLASS_INTERNAL
            internal = True
        tenant = self._resolve_tenant(req, internal)
        dl = rz.Deadline.from_header(req.header(rz.DEADLINE_HEADER))
        try:
            return self.admission.acquire(cls, deadline=dl, tenant=tenant,
                                          nbytes=len(req.body or b"")), None
        except rz.ShedError as e:
            return None, self._shed_response(req, e)

    def _read_query_request(self, req: Request) -> dict:
        """reference: handler.go:863-944 — a QueryRequest protobuf, or a
        PQL body with URL parameters."""
        if req.header("Content-Type") == PROTOBUF:
            pb = _decode(wire.QueryRequest, req.body)
            return {
                "query": pb.Query,
                "slices": list(pb.Slices) or None,
                "column_attrs": pb.ColumnAttrs,
                "remote": pb.Remote,
            }
        valid = {
            "slices",
            "columnAttrs",
            "time_granularity",
            "allowPartial",
            "writeConsistency",
            "readConsistency",
        }
        for key in req.query:
            if key not in valid:
                raise ValueError("invalid query params")
        slices = None
        if req.query.get("slices"):
            try:
                slices = [int(s) for s in req.query["slices"].split(",")]
            except ValueError:
                raise ValueError("invalid slice argument") from None
        if req.query.get("time_granularity"):
            try:
                parse_time_quantum(req.query["time_granularity"])
            except ValueError:
                raise ValueError("invalid time granularity") from None
        return {
            "query": req.body.decode(),
            "slices": slices,
            "column_attrs": req.query.get("columnAttrs") == "true",
            "remote": False,
        }

    # --- import (reference: handler.go:969-1046) ---

    @admitted(adm.CLASS_WRITE)
    def handle_post_import(self, req: Request) -> Response:
        view = req.query.get("view", "")
        if view not in ("", "inverse"):
            return Response.error(f"invalid view: {view}", 400)
        try:
            pb = _decode(wire.ImportRequest, req.body)
        except _ParseError as e:
            return Response.error(str(e), 400)
        # Ownership guard (reference: handler.go:1004).
        if not self.cluster.is_write_owner(self.executor.host, pb.Index, pb.Slice):
            return Response.error(
                f"host does not own slice {self.executor.host} slice={pb.Slice}", 412
            )
        f = self.holder.frame(pb.Index, pb.Frame)
        if f is None:
            return Response.error("frame not found", 404)
        timestamps = (
            [None if ts == 0 else _dt_from_unix(ts) for ts in pb.Timestamps]
            if pb.Timestamps
            else None
        )
        try:
            rows = np.asarray(pb.RowIDs, dtype=np.int64)
            cols = np.asarray(pb.ColumnIDs, dtype=np.int64)
            if view == "inverse":
                # The inverse half another node sent: pb.Slice is the
                # inverse slice, which the guard above checked.
                f.import_inverse(rows, cols, timestamps)
            elif not f.inverse_enabled:
                f.import_bulk(rows, cols, timestamps)
            else:
                f.import_standard(rows, cols, timestamps)
                self._import_inverse_by_owner(pb.Index, pb.Frame, f, rows, cols, timestamps)
        except Exception as e:  # noqa: BLE001 — import boundary
            return Response.proto(wire.ImportResponse(Err=str(e)), status=500)
        return Response.proto(wire.ImportResponse())

    def _import_inverse_by_owner(self, index: str, frame: str, f, rows, cols, timestamps) -> None:
        """The inverse half of an import, grouped by inverse slice (``row
        // SLICE_WIDTH``): imported here where this node owns the slice,
        sent to every other owner as ``/import?view=inverse``.  A node
        outside any cluster owns every slice."""
        me = self.executor.host
        idx = np.arange(len(rows), dtype=np.int64)
        for s, (r_s, c_s, i_s) in bp.np_group_by(rows // bp.SLICE_WIDTH, rows, cols, idx):
            ts = None if timestamps is None else [timestamps[i] for i in i_s]
            owners = [n.host for n in self.cluster.fragment_nodes(index, s)] or [me]
            for host in owners:
                if host == me:
                    f.import_inverse(r_s, c_s, ts)
                else:
                    self.executor.client_factory(host).import_slice(
                        index, frame, s, r_s, c_s,
                        None if ts is None else [_unix_ns(t) for t in ts],
                        view="inverse", host=host,
                    )


def _consistency_arg(req: Request, header: str, param: str) -> str:
    """A request's consistency level: the header wins over the URL
    parameter; "" is the server's default; anything else must be a level
    (ValueError: 400)."""
    raw = req.header(header) or req.query.get(param, "")
    if not raw:
        return ""
    return replicate_mod.validate_level(raw, param)


class _ParseError(ValueError):
    """A protobuf body that does not decode."""


def _profile_into(trace_dir: str, seconds: float) -> None:
    """Run ``torch.profiler`` over every thread for ``seconds`` and write
    its Chrome trace (``trace.json``) into ``trace_dir``: CPU activity,
    and CUDA activity where a card is present (every kernel of the
    process, the port's own included)."""
    import torch
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=acts) as prof:
        time.sleep(seconds)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _coalesce_batch_stats(record: dict) -> dict | None:
    """The coalescer's batch stats from a trace's ``coalesce`` spans (the
    slow-query line's evidence of a shared launch); None when the query
    never reached the coalescer."""
    spans = [s for s in record.get("spans", ()) if s.get("name") == "coalesce"]
    if not spans:
        return None
    occ = [s["tags"]["batch_queries"] for s in spans
           if isinstance(s.get("tags", {}).get("batch_queries"), (int, float))]
    out: dict = {"launches": len(spans)}
    if occ:
        out["mean_occupancy"] = round(sum(occ) / len(occ), 2)
        out["max_occupancy"] = max(occ)
    return out


def _fuse_batch_stats(record: dict) -> dict | None:
    """The composition of the interpreter launches a query rode, from its
    ``fuse`` spans; None when it fused with none."""
    spans = [s for s in record.get("spans", ()) if s.get("name") == "fuse"]
    if not spans:
        return None
    out: dict = {"launches": len(spans)}
    for tag, label in (("batch_queries", "mean_fused_queries"), ("programs", "mean_programs"),
                       ("ops", "mean_ops"), ("dedup_hits", "mean_dedup_hits")):
        vals = [s["tags"][tag] for s in spans
                if isinstance(s.get("tags", {}).get(tag), (int, float))]
        if vals:
            out[label] = round(sum(vals) / len(vals), 2)
    return out


def _sample_cpu_counts(seconds: float, hz: float = 100.0, stop: threading.Event | None = None,
                       counts: dict[str, int] | None = None) -> dict[str, int]:
    """Sample every other thread's stack at ``hz`` for up to ``seconds``
    (``stop`` ends it early), adding each folded stack's samples to
    ``counts`` in place, so that another thread can read it meanwhile
    (the CLI's ``--cpuprofile``)."""
    if counts is None:
        counts = {}
    me = threading.get_ident()
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and not (stop is not None and stop.is_set()):
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            parts = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{code.co_name} ({code.co_filename}:{f.f_lineno})")
                f = f.f_back
            stack = ";".join(reversed(parts)) or "<idle>"
            counts[stack] = counts.get(stack, 0) + 1
        time.sleep(1.0 / hz)
    return counts


def _fold_counts(counts: dict[str, int]) -> str:
    """One ``frame1;frame2;... count`` line a stack, most sampled first
    (the flamegraph-collapsed form)."""
    lines = [f"{st} {n}" for st, n in sorted(counts.items(), key=lambda kv: -kv[1])]
    return "\n".join(lines) + ("\n" if lines else "")


def _sample_cpu_profile(seconds: float, hz: float = 100.0) -> str:
    """Sample every other thread's stack at ``hz`` for ``seconds`` and
    fold identical stacks, most sampled first."""
    return _fold_counts(_sample_cpu_counts(seconds, hz))


def _decode(cls, body: bytes):
    """``cls.decode(body)``; any failure raises the text the JAX
    package's generated parser gives (the hand-written decoder's own
    texts differ from it)."""
    try:
        return cls.decode(body)
    except Exception:  # noqa: BLE001 — every decode failure is one answer
        raise _ParseError(
            f"Error parsing message with type 'pilosa_tpu.wire.{cls.__name__}'") from None


def _unix_ns(t: datetime | None) -> int:
    """Inverse of :func:`_dt_from_unix` (0 for no timestamp)."""
    if t is None:
        return 0
    return int(round(t.replace(tzinfo=timezone.utc).timestamp() * 1e9))


def _dt_from_unix(ts: int) -> datetime:
    """Unix nanoseconds -> naive UTC datetime (JAX handler.py:2302)."""
    return datetime.fromtimestamp(ts / 1e9, tz=timezone.utc).replace(tzinfo=None)


def make_http_server(handler: Handler, host: str = "127.0.0.1", port: int = 0):
    """Mount a Handler on a ThreadingHTTPServer; returns the server (call
    ``serve_forever()`` in a thread; ``server_address`` has the bound
    port when port=0).  Bodies stream both ways (JAX ``handler.py:
    2310-2406``): a chunked or Content-Length request body reaches the
    handler as a reader, and an iterator response goes out with chunked
    transfer encoding in writes of constant size."""

    class _Adapter(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _run(self):
            parsed = urllib.parse.urlsplit(self.path)
            if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
                body = stream_mod.ChunkedBodyReader(self.rfile)
            else:
                body = stream_mod.LengthBodyReader(
                    self.rfile, int(self.headers.get("Content-Length") or 0))
            req = Request(
                method=self.command,
                path=parsed.path,
                query=dict(urllib.parse.parse_qsl(parsed.query)),
                headers={k.lower(): v for k, v in self.headers.items()},
                stream=body,
            )
            resp = handler.dispatch(req)
            # The unread rest of the body leaves the socket before the
            # answer, or the connection closes when it is too long.
            try:
                if not body.drain():
                    self.close_connection = True
            except (OSError, ValueError):
                self.close_connection = True
            self._count("stream.bytesReceived", body.bytes_read)
            if resp.body_iter is not None:
                self._send_stream(resp)
                return
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.content_type)
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            self.wfile.write(resp.body)

        def _count(self, name: str, n: int) -> None:
            if handler.stats is None or n <= 0:
                return
            try:
                handler.stats.count(name, n)
            except Exception:  # noqa: BLE001 — stats never break the transport
                pass

        def _send_stream(self, resp: Response) -> None:
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.content_type)
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            sent = 0
            try:
                for chunk in resp.body_iter:
                    if chunk:
                        self.wfile.write(stream_mod.encode_chunk(chunk))
                        sent += len(chunk)
                self.wfile.write(stream_mod.CHUNK_TERMINATOR)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
            except Exception as e:  # noqa: BLE001 — the producer failed mid-stream
                # The headers are gone: the body ends without its
                # terminator, which the client sees as an error.
                handler.logger(f"stream error {self.path}: {e}")
                self.close_connection = True
            finally:
                self._count("stream.bytesSent", sent)
                close = getattr(resp.body_iter, "close", None)
                if close is not None:
                    close()

        do_GET = do_POST = do_DELETE = do_PATCH = _run

        def log_message(self, format, *args):  # noqa: A002 — stdlib signature
            pass

    class _Server(ThreadingHTTPServer):
        # socketserver listens with a backlog of 5: a burst of concurrent
        # clients (the coalescer's workload) would be refused.
        request_queue_size = 128

    srv = _Server((host, port), _Adapter)
    srv.daemon_threads = True
    return srv
