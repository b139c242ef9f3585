"""HTTP handler: routes, JSON bodies, and the query endpoint.

The JSON routes of ``pilosa_tpu.net.handler`` that serve the slice this
port covers, with the same paths, status codes and response bodies
(reference: handler.go):

    GET    /version, /status, /schema, /index
    GET    /index/<i>          POST /index/<i>          DELETE /index/<i>
    POST   /index/<i>/frame/<f>                         DELETE /index/<i>/frame/<f>
    POST   /index/<i>/query

The protobuf wire, ``/import``, cluster, replication and debug routes
are not ported yet; a protobuf request answers 415.
"""

from __future__ import annotations

import json
import re
import sys
import traceback
import urllib.parse
from collections.abc import Callable
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.core.bitmap import RowBitmap
from pilosa_tpu_torch.core.timequantum import parse_time_quantum
from pilosa_tpu_torch.exec.executor import TooManyWritesError
from pilosa_tpu_torch.pql.parser import parse_string

PROTOBUF = "application/x-protobuf"
JSON = "application/json"

_U64_MASK = (1 << 64) - 1


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
    def error(cls, message: str, status: int) -> "Response":
        return cls.json({"error": message}, status=status)


def result_to_json(result: Any) -> Any:
    """Polymorphic result encoding (reference: handler.go:216-280):
    RowBitmap -> {"attrs", "bits"}; [Pair] -> [{"id", "count"}];
    int -> N; bool -> changed; None -> null."""
    if isinstance(result, RowBitmap):
        return result.to_json_dict()
    if isinstance(result, list):
        return [{"id": p.id & _U64_MASK, "count": p.count & _U64_MASK} for p in result]
    if isinstance(result, int) and not isinstance(result, bool):
        return int(result)
    return result


def response_to_json(results: list[Any], column_attr_sets=None) -> dict:
    out: dict[str, Any] = {"results": [result_to_json(r) for r in results or []]}
    if column_attr_sets is not None:
        out["columnAttrs"] = [
            {"id": id_ & _U64_MASK, "attrs": attrs} for id_, attrs in column_attr_sets
        ]
    return out


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
    """Routes requests to the holder and executor underneath."""

    def __init__(self, holder, executor, host: str = ""):
        self.holder = holder
        self.executor = executor
        self.host = host
        routes: list[tuple[str, str, Callable]] = [
            ("GET", r"/schema", self.handle_get_schema),
            ("GET", r"/status", self.handle_get_status),
            ("GET", r"/version", self.handle_get_version),
            ("GET", r"/index", self.handle_get_schema),
            ("GET", r"/index/(?P<index>[^/]+)", self.handle_get_index),
            ("POST", r"/index/(?P<index>[^/]+)", self.handle_post_index),
            ("DELETE", r"/index/(?P<index>[^/]+)", self.handle_delete_index),
            ("POST", r"/index/(?P<index>[^/]+)/query", self.handle_post_query),
            ("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)", self.handle_post_frame),
            ("DELETE", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)", self.handle_delete_frame),
        ]
        self._routes = [(m, re.compile("^" + p + "$"), fn) for m, p, fn in routes]

    def dispatch(self, req: Request) -> Response:
        try:
            if PROTOBUF in (req.header("Content-Type"), req.header("Accept")):
                return Response.error("protobuf is not supported by this port yet", 415)
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

    def handle_get_status(self, req: Request) -> Response:
        node = {"Host": self.host, "State": "UP", "Indexes": self.holder.schema()}
        return Response.json({"status": {"Nodes": [node]}})

    def handle_get_version(self, req: Request) -> Response:
        return Response.json({"version": __version__})

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
            self.holder.create_index(index, **kwargs)
        except ValueError as e:
            return Response.error(str(e), 400)
        return Response.json({})

    def handle_delete_index(self, req: Request, index: str) -> Response:
        self.holder.delete_index(index)
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
            idx.create_frame(frame, **kwargs)
        except (ValueError, RuntimeError) as e:
            return Response.error(str(e), 400)
        return Response.json({})

    def handle_delete_frame(self, req: Request, index: str, frame: str) -> Response:
        idx = self.holder.index(index)
        if idx is None:
            return Response.error("index not found", 404)
        idx.delete_frame(frame)
        return Response.json({})

    # --- query (reference: handler.go:863-944) ---

    def handle_post_query(self, req: Request, index: str) -> Response:
        try:
            qreq = self._read_query_request(req)
        except ValueError as e:
            return Response.error(str(e), 400)
        try:
            q = parse_string(qreq["query"])
        except Exception as e:  # noqa: BLE001 — parser error
            return Response.error(str(e), 400)
        try:
            results = self.executor.execute(index, q, qreq["slices"])
        except TooManyWritesError as e:
            return Response.error(str(e), 413)
        except Exception as e:  # noqa: BLE001 — executor boundary
            return Response.error(str(e), 500)

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
        return Response.json(response_to_json(results, column_attr_sets))

    def _read_query_request(self, req: Request) -> dict:
        """reference: handler.go:863-944 (JSON/plain-text body)."""
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
        }


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
