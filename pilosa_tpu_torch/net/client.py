"""Internal HTTP client — the inter-node data plane.

The part of ``pilosa_tpu.net.client.InternalClient`` that the port's
cluster needs: protobuf queries (the map legs of a fan-out), schema
calls (BSI fields included), max slices, slice owners, and the
slice-targeted bulk imports that POST each slice's bits — or each
slice's field values — to every owner (reference: client.go:39-476;
JAX ``client.py:422-560``).  Every request carries a socket timeout and is made
once: a dead peer surfaces as an error at once, for the executor's
replica failover to act on; no retry loop hides it.
"""

from __future__ import annotations

import http.client
import json
import urllib.parse
from typing import Any

import numpy as np

from pilosa_tpu_torch.net import codec, wire
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH, np_group_by

PROTOBUF = "application/x-protobuf"

# Failures of the transport itself: the peer is down or unreachable.
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class ClientError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"http {status}: {message}")
        self.status = status


def is_node_failure(exc: BaseException) -> bool:
    """Whether an error from a remote leg indicts the NODE — a transport
    failure or a 5xx answer, eligible for replica failover — rather
    than the query, which would fail the same everywhere (JAX:
    ``net/resilience.py:104``)."""
    if isinstance(exc, TRANSPORT_ERRORS):
        return True
    status = getattr(exc, "status", None)
    return isinstance(status, int) and status >= 500


def _err_text(data: bytes) -> str:
    try:
        return json.loads(data).get("error", "") or data.decode(errors="replace")
    except (ValueError, AttributeError):
        return data.decode(errors="replace")


class InternalClient:
    """HTTP client pinned to one host ("host:port").  ``device`` is where
    decoded Bitmap results land (the calling node's device)."""

    def __init__(self, host: str, timeout: float = 30.0, device=None):
        self.host = host
        self.timeout = timeout
        self.device = device

    def _peer(self, host: str) -> "InternalClient":
        return self if host == self.host else InternalClient(host, self.timeout, self.device)

    # --- plumbing ---

    def _request(
        self,
        method: str,
        path: str,
        query: dict[str, Any] | None = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
    ) -> tuple[int, bytes]:
        status, data, _ = self._request_meta(method, path, query, body, headers)
        return status, data

    def _request_meta(
        self,
        method: str,
        path: str,
        query: dict[str, Any] | None = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
    ) -> tuple[int, bytes, dict[str, str]]:
        """``(status, body, response headers with lower-case names)``."""
        if query:
            path = f"{path}?{urllib.parse.urlencode(query)}"
        conn = http.client.HTTPConnection(self.host, timeout=self.timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, {k.lower(): v for k, v in resp.getheaders()}
        finally:
            conn.close()

    def _check(self, status: int, data: bytes) -> bytes:
        if status >= 400:
            raise ClientError(status, _err_text(data))
        return data

    # --- queries (reference: client.go:223-311) ---

    def execute_query(
        self,
        index: str,
        query: str,
        slices: list[int] | None = None,
        remote: bool = False,
        trace_headers: dict[str, str] | None = None,
        tracer=None,
    ) -> list:
        """Run ``query`` on the host.  ``trace_headers`` (the caller's rpc
        span, ``Tracer.remote_headers``) continue the caller's trace
        there; the spans the host sends back in ``X-Trace-Spans`` go into
        ``tracer`` (JAX ``net/client.py:365``)."""
        pb = wire.QueryRequest(Query=query, Slices=list(slices or []), Remote=remote)
        headers = {"Content-Type": PROTOBUF, "Accept": PROTOBUF}
        if trace_headers:
            headers.update(trace_headers)
        status, data, resp_headers = self._request_meta(
            "POST", f"/index/{index}/query", body=pb.encode(), headers=headers
        )
        if tracer is not None:
            payload = resp_headers.get("x-trace-spans")
            if payload:
                tracer.absorb(payload)
        if status >= 400:
            # A query error comes back as a QueryResponse with Err.
            try:
                err = wire.QueryResponse.decode(data).Err
            except ValueError:
                err = ""
            raise ClientError(status, err or _err_text(data))
        resp = wire.QueryResponse.decode(self._check(status, data))
        if resp.Err:
            raise ClientError(status, resp.Err)
        return [codec.result_from_proto(r, self.device) for r in resp.Results]

    # --- schema (reference: client.go:63-220) ---

    def schema(self) -> list[dict]:
        status, data = self._request("GET", "/schema")
        return json.loads(self._check(status, data))["indexes"]

    def max_slice_by_index(self, inverse: bool = False) -> dict[str, int]:
        """Per-index max slice of the host, or max inverse slice."""
        query = {"inverse": "true"} if inverse else None
        status, data = self._request("GET", "/slices/max", query=query)
        return json.loads(self._check(status, data))["maxSlices"]

    def create_index(self, index: str, options: dict | None = None) -> None:
        body = json.dumps({"options": options or {}}).encode()
        status, data = self._request("POST", f"/index/{index}", body=body)
        self._check(status, data)

    def create_frame(self, index: str, frame: str, options: dict | None = None) -> None:
        body = json.dumps({"options": options or {}}).encode()
        status, data = self._request("POST", f"/index/{index}/frame/{frame}", body=body)
        self._check(status, data)

    def create_field(self, index: str, frame: str, field: str, min: int, max: int) -> None:
        body = json.dumps({"min": int(min), "max": int(max)}).encode()
        path = f"/index/{index}/frame/{frame}/field/{field}"
        status, data = self._request("POST", path, body=body)
        self._check(status, data)

    def delete_field(self, index: str, frame: str, field: str) -> None:
        status, data = self._request("DELETE", f"/index/{index}/frame/{frame}/field/{field}")
        self._check(status, data)

    def frame_fields(self, index: str, frame: str) -> list[dict]:
        status, data = self._request("GET", f"/index/{index}/frame/{frame}/fields")
        return json.loads(self._check(status, data))["fields"]

    def fragment_nodes(self, index: str, slice_i: int) -> list[dict]:
        """Owners of a slice, as ``[{"host", "internalHost"}]``."""
        status, data = self._request(
            "GET", "/fragment/nodes", query={"index": index, "slice": slice_i}
        )
        return json.loads(self._check(status, data))

    # --- import (reference: client.go:314-401) ---

    def import_slice(
        self, index: str, frame: str, slice_i: int, rows, cols, timestamps=None,
        view: str = "", host: str | None = None,
    ) -> None:
        """POST one slice's bits to every owner of the slice, or to
        ``host`` alone.  Every owner must accept them: a failure raises
        naming each host that failed, after the others have received the
        bits.  ``view="inverse"`` sends the inverse half of an import:
        ``slice_i`` is then the inverse slice (``row // SLICE_WIDTH``) and
        the bits are imported into the frame's inverse views only."""
        pb = wire.ImportRequest(
            Index=index,
            Frame=frame,
            Slice=slice_i,
            RowIDs=np.asarray(rows, dtype=np.uint64),
            ColumnIDs=np.asarray(cols, dtype=np.uint64),
            Timestamps=[] if timestamps is None else np.asarray(timestamps, dtype=np.int64),
        )
        path = "/import?view=inverse" if view == "inverse" else "/import"
        self._post_to_owners(
            index, slice_i, path, pb.encode(),
            {"Content-Type": PROTOBUF, "Accept": PROTOBUF}, protobuf=True, host=host,
        )

    def import_value(
        self, index: str, frame: str, field: str, slice_i: int, columns, values
    ) -> None:
        """POST one slice's field values (``/import-value``) to every
        owner of the slice, as :meth:`import_slice` does with bits."""
        payload = json.dumps(
            {
                "index": index,
                "frame": frame,
                "field": field,
                "slice": int(slice_i),
                "columnIDs": np.asarray(columns, dtype=np.int64).tolist(),
                "values": np.asarray(values, dtype=np.int64).tolist(),
            }
        ).encode()
        self._post_to_owners(index, slice_i, "/import-value", payload, {}, protobuf=False)

    def _post_to_owners(
        self, index: str, slice_i: int, path: str, payload: bytes, headers: dict,
        protobuf: bool, host: str | None = None,
    ) -> None:
        nodes = [{"host": host}] if host is not None else self.fragment_nodes(index, slice_i)
        if not nodes:
            raise ClientError(500, f"no nodes for slice {slice_i}")
        errors = []
        for node in nodes:
            peer = self._peer(node["host"])
            try:
                status, data = peer._request("POST", path, body=payload, headers=headers)
                body = peer._check(status, data)
                if protobuf:
                    resp = wire.ImportResponse.decode(body)
                    if resp.Err:
                        raise ClientError(500, resp.Err)
            except TRANSPORT_ERRORS + (ClientError, ValueError) as e:
                errors.append(f"{node['host']}: {e}")
        if errors:
            raise ClientError(500, "import failed on " + "; ".join(errors))

    def import_bits(self, index: str, frame: str, rows, cols, timestamps=None) -> list[int]:
        """Group (row, col[, timestamp]) bits by slice and send each
        slice to all its owners; returns the slices sent."""
        rows = np.asarray(rows, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64)
        if len(rows) != len(cols):
            raise ValueError("rows and cols differ in length")
        arrays = [rows, cols]
        if timestamps is not None:
            arrays.append(np.asarray(timestamps, dtype=np.int64))
        sent = []
        for s, parts in np_group_by(cols // np.uint64(SLICE_WIDTH), *arrays):
            self.import_slice(index, frame, s, *parts)
            sent.append(s)
        return sent

    def import_values(self, index: str, frame: str, field: str, cols, values) -> list[int]:
        """Group (column, value) pairs by slice and send each slice's
        values to all its owners; returns the slices sent."""
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        if len(cols) != len(values):
            raise ValueError("columns and values differ in length")
        sent = []
        for s, (c_s, v_s) in np_group_by(cols // SLICE_WIDTH, cols, values):
            self.import_value(index, frame, field, s, c_s, v_s)
            sent.append(s)
        return sent
