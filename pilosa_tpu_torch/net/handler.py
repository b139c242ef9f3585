"""HTTP handler: routes, JSON and protobuf bodies, the query endpoint.

The routes of ``pilosa_tpu.net.handler`` that serve the slices this
port covers, with the same paths, status codes and response bodies
(reference: handler.go):

    GET    /version, /status, /schema, /index, /hosts, /slices/max
    GET    /index/<i>          POST /index/<i>          DELETE /index/<i>
    POST   /index/<i>/frame/<f>                         DELETE /index/<i>/frame/<f>
    GET    /index/<i>/frame/<f>/fields
    POST   /index/<i>/frame/<f>/field/<fld>             DELETE (same path)
    POST   /index/<i>/query    POST /import             POST /import-value
    GET    /fragment/nodes
    GET    /debug/hbm          GET /debug/ingest

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
values as JSON.  Index and frame creation and deletion are broadcast to
the cluster; a field's creation and deletion go to every peer as the
same HTTP request with ``?remote=true``, as in the JAX package.
``GET /debug/hbm`` answers the residency pool's snapshot and ``GET
/debug/ingest`` the WAL manager's and the delta-scatter's counters, with
the JAX package's keys.  Replication, resize and the other debug routes
are not ported yet.
"""

from __future__ import annotations

import json
import re
import sys
import traceback
import urllib.parse
from collections.abc import Callable
from dataclasses import dataclass, field
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from pilosa_tpu_torch import __version__, bsi
from pilosa_tpu_torch import device as device_mod
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.timequantum import parse_time_quantum
from pilosa_tpu_torch.exec.executor import ExecOptions, TooManyWritesError
from pilosa_tpu_torch.ingest import scatter
from pilosa_tpu_torch.net import codec, wire
from pilosa_tpu_torch.ops import bitplane as bp
from pilosa_tpu_torch.pql.parser import parse_string

PROTOBUF = "application/x-protobuf"
JSON = "application/json"


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = JSON

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

    def __init__(self, holder, executor, broadcaster=None):
        self.holder = holder
        self.executor = executor
        self.broadcaster = broadcaster
        # The WAL manager (wired by the server), for /debug/ingest; None
        # when the WAL is off.
        self.ingest = None
        routes: list[tuple[str, str, Callable]] = [
            ("GET", r"/schema", self.handle_get_schema),
            ("GET", r"/status", self.handle_get_status),
            ("GET", r"/hosts", self.handle_get_hosts),
            ("GET", r"/version", self.handle_get_version),
            ("GET", r"/slices/max", self.handle_get_slice_max),
            ("GET", r"/index", self.handle_get_schema),
            ("GET", r"/index/(?P<index>[^/]+)", self.handle_get_index),
            ("POST", r"/index/(?P<index>[^/]+)", self.handle_post_index),
            ("DELETE", r"/index/(?P<index>[^/]+)", self.handle_delete_index),
            ("POST", r"/index/(?P<index>[^/]+)/query", self.handle_post_query),
            ("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)", self.handle_post_frame),
            ("DELETE", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)", self.handle_delete_frame),
            ("GET", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/fields",
             self.handle_get_frame_fields),
            ("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/field/(?P<fld>[^/]+)",
             self.handle_post_frame_field),
            ("DELETE", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/field/(?P<fld>[^/]+)",
             self.handle_delete_frame_field),
            ("POST", r"/import", self.handle_post_import),
            ("POST", r"/import-value", self.handle_post_import_value),
            ("GET", r"/fragment/nodes", self.handle_get_fragment_nodes),
            ("GET", r"/debug/hbm", self.handle_get_hbm),
            ("GET", r"/debug/ingest", self.handle_get_ingest),
        ]
        self._routes = [(m, re.compile("^" + p + "$"), fn) for m, p, fn in routes]

    def dispatch(self, req: Request) -> Response:
        try:
            for method, pattern, fn in self._routes:
                m = pattern.match(req.path.rstrip("/") or "/")
                if m and method == req.method:
                    return fn(req, **m.groupdict())
            return Response.error("not found", 404)
        except Exception as e:  # noqa: BLE001 — API boundary
            print(
                f"handler error {req.method} {req.path}: {e}\n" + traceback.format_exc(),
                file=sys.stderr,
            )
            return Response.error(str(e), 500)

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
        doc = {"scatter": scatter.counters(), "scatterEnabled": True}
        if self.ingest is None:
            doc["wal"] = {"walEnabled": False, "note": "ingest WAL not configured"}
        else:
            doc["wal"] = self.ingest.snapshot()
        return Response.json(doc)

    def handle_get_fragment_nodes(self, req: Request) -> Response:
        """Owners of a slice.  ``?write=true`` asks for the write owners,
        which are the owners while no resize is in flight (resize is not
        ported)."""
        index = req.query.get("index", "")
        try:
            slice_i = int(req.query.get("slice", ""))
        except ValueError:
            return Response.error("invalid slice", 400)
        nodes = self.cluster.fragment_nodes(index, slice_i)
        return Response.json([n.to_dict() for n in nodes])

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
        try:
            qreq = self._read_query_request(req)
        except _ParseError as e:  # the JAX package's dispatcher answers it
            return Response.error(str(e), 500)
        except ValueError as e:
            return self._query_error(req, str(e), 400)
        try:
            q = parse_string(qreq["query"])
        except Exception as e:  # noqa: BLE001 — parser error
            return self._query_error(req, str(e), 400)
        try:
            results = self.executor.execute(
                index, q, qreq["slices"], ExecOptions(remote=qreq["remote"])
            )
        except TooManyWritesError as e:
            return self._query_error(req, str(e), 413)
        except Exception as e:  # noqa: BLE001 — executor boundary
            return self._query_error(req, str(e), 500)

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
            return Response.proto(codec.response_to_proto(results, column_attr_sets))
        return Response.json(codec.response_to_json(results, column_attr_sets))

    def _query_error(self, req: Request, message: str, status: int) -> Response:
        if PROTOBUF in req.header("Accept"):
            return Response.proto(wire.QueryResponse(Err=message), status=status)
        return Response.error(message, status)

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


class _ParseError(ValueError):
    """A protobuf body that does not decode."""


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
    port when port=0)."""

    class _Adapter(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _run(self):
            parsed = urllib.parse.urlsplit(self.path)
            length = int(self.headers.get("Content-Length") or 0)
            req = Request(
                method=self.command,
                path=parsed.path,
                query=dict(urllib.parse.parse_qsl(parsed.query)),
                headers={k.lower(): v for k, v in self.headers.items()},
                body=self.rfile.read(length) if length else b"",
            )
            resp = handler.dispatch(req)
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            self.wfile.write(resp.body)

        do_GET = do_POST = do_DELETE = do_PATCH = _run

        def log_message(self, format, *args):  # noqa: A002 — stdlib signature
            pass

    srv = ThreadingHTTPServer((host, port), _Adapter)
    srv.daemon_threads = True
    return srv
