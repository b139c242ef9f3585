"""Internal HTTP client — the inter-node data plane.

The part of ``pilosa_tpu.net.client.InternalClient`` that the port's
cluster needs: protobuf queries (the map legs of a fan-out), schema
calls (BSI fields included), max slices, slice owners, and the
slice-targeted bulk imports that POST each slice's bits — or each
slice's field values — to every owner (reference: client.go:39-476;
JAX ``client.py:422-560``).  Every request carries a socket timeout and is made
once: a dead peer surfaces as an error at once, for the executor's
replica failover to act on; no retry loop hides it.

The data plane of backup, restore, export and block sync (reference:
client.go:403-1010; JAX ``client.py:214-1000``): CSV export with a
redirect to an owner on 412, one fragment's archive as a body stream
and its restore as a chunked POST, the tar of tars of a whole view
(each slice spooled, so memory stays at chunk scale), a frame pulled
from another node, block checksums, block data, view-scoped repair
pushes and attribute diffs.  Only the opening of a streamed GET retries
(``stream/client.py``); a stream that breaks midway raises.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import shutil
import tarfile
import tempfile
import time
import urllib.parse
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from pilosa_tpu_torch import stream as stream_mod
from pilosa_tpu_torch.net import codec, wire
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH, np_group_by

PROTOBUF = "application/x-protobuf"

# Fragment archives in flight at once in a whole-view backup or restore:
# the node's work per fragment (an encode, or a restore's six fsyncs)
# overlaps across requests, and the tar keeps slice order.
VIEW_ARCHIVES_IN_FLIGHT = 16

# Failures of the transport itself: the peer is down or unreachable.
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class ClientError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"http {status}: {message}")
        self.status = status


class PreconditionFailedError(ClientError):
    """412: the node does not own the slice."""

    def __init__(self, message: str = "precondition failed"):
        super().__init__(412, message)


def is_node_failure(exc: BaseException) -> bool:
    """Whether an error from a remote leg indicts the NODE — a transport
    failure or a 5xx answer, eligible for replica failover — rather
    than the query, which would fail the same everywhere (JAX:
    ``net/resilience.py:104``)."""
    if isinstance(exc, TRANSPORT_ERRORS):
        return True
    status = getattr(exc, "status", None)
    return isinstance(status, int) and status >= 500


def _drop(futures) -> None:
    """Cancel the futures not yet started; close what the others made."""
    for fut in futures:
        if fut.cancel():
            continue
        try:
            made = fut.result()
        except BaseException:  # noqa: BLE001 — the first failure is already raised
            continue
        if made is not None:
            made.close()


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
        # Attempts and first backoff of a streamed GET's opening, and the
        # chunk size of streamed bodies.
        self.stream_retries = 3
        self.stream_backoff = 0.1
        self.chunk_bytes = stream_mod.DEFAULT_CHUNK_BYTES

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

    def _request_chunked(
        self, method: str, path: str, reader, query: dict[str, Any] | None = None,
        headers: dict[str, str] | None = None,
    ) -> tuple[int, bytes]:
        """A request whose body streams off ``reader`` with chunked
        transfer encoding, in writes of ``chunk_bytes``; made once (the
        reader cannot be rewound)."""
        if query:
            path = f"{path}?{urllib.parse.urlencode(query)}"

        def chunks():
            while True:
                data = reader.read(self.chunk_bytes)
                if not data:
                    return
                yield data

        conn = http.client.HTTPConnection(self.host, timeout=self.timeout)
        try:
            conn.request(method, path, body=chunks(),
                         headers={**(headers or {}), "Transfer-Encoding": "chunked"},
                         encode_chunked=True)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _open_stream(
        self, method: str, path: str, query: dict[str, Any] | None = None,
        headers: dict[str, str] | None = None,
    ) -> stream_mod.HTTPBodyStream:
        """An error-checked response body stream; its opening (the dial and
        the status line) retries with backoff, the stream itself does not.
        The caller closes it."""
        if query:
            path = f"{path}?{urllib.parse.urlencode(query)}"

        def _open():
            conn = http.client.HTTPConnection(self.host, timeout=self.timeout)
            try:
                conn.request(method, path, headers=headers or {})
                resp = conn.getresponse()
            except BaseException:
                conn.close()
                raise
            return stream_mod.HTTPBodyStream(resp, conn, self.chunk_bytes)

        s = stream_mod.open_with_retry(_open, attempts=self.stream_retries,
                                       backoff=self.stream_backoff)
        if s.status >= 400:
            with s:
                data = s.read()
            self._check(s.status, data)
        return s

    def _check(self, status: int, data: bytes) -> bytes:
        if status == 412:
            raise PreconditionFailedError(_err_text(data))
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

    def frame_views(self, index: str, frame: str) -> list[str]:
        status, data = self._request("GET", f"/index/{index}/frame/{frame}/views")
        return json.loads(self._check(status, data))["views"]

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

    # --- export (reference: client.go:403-476) ---

    def export_csv(self, index: str, frame: str, view: str, slice_i: int) -> str:
        """One fragment's CSV, whole."""
        buf = io.BytesIO()
        self.export_to(buf, index, frame, view, slice_i)
        return buf.getvalue().decode()

    def export_to(self, w, index: str, frame: str, view: str, slice_i: int) -> None:
        """Stream one fragment's CSV into ``w``, from another owner of the
        slice when this node answers 412 (decided on the status line,
        before any body moves)."""
        try:
            src = self._export_stream(index, frame, view, slice_i)
        except PreconditionFailedError:
            src = None
            for node in self.fragment_nodes(index, slice_i):
                if node["host"] == self.host:
                    continue
                try:
                    src = self._peer(node["host"])._export_stream(index, frame, view, slice_i)
                    break
                except PreconditionFailedError:
                    continue
            if src is None:
                raise
        with src:
            for chunk in src:
                w.write(chunk)

    def _export_stream(self, index: str, frame: str, view: str, slice_i: int):
        return self._open_stream(
            "GET", "/export",
            query={"index": index, "frame": frame, "view": view, "slice": slice_i},
            headers={"Accept": "text/csv"},
        )

    # --- backup and restore (reference: client.go:478-738) ---

    def stream_backup_slice(self, index: str, frame: str, view: str, slice_i: int):
        """One fragment's archive as a body stream (the caller closes it),
        or None when the node has no such fragment."""
        try:
            return self._open_stream(
                "GET", "/fragment/data",
                query={"index": index, "frame": frame, "view": view, "slice": slice_i},
            )
        except ClientError as e:
            if e.status == 404:
                return None
            raise

    def backup_slice(self, index: str, frame: str, view: str, slice_i: int) -> bytes | None:
        src = self.stream_backup_slice(index, frame, view, slice_i)
        if src is None:
            return None
        with src:
            return src.read()

    def restore_slice_from(self, index: str, frame: str, view: str, slice_i: int, reader,
                           stage: bool = False) -> None:
        """POST one fragment archive off ``reader`` as a chunked body;
        ``stage=True`` asks the node to stage the fragment's mirror."""
        query: dict = {"index": index, "frame": frame, "view": view, "slice": slice_i}
        if stage:
            query["stage"] = "true"
        status, data = self._request_chunked("POST", "/fragment/data", reader, query=query)
        self._check(status, data)

    def restore_slice(self, index: str, frame: str, view: str, slice_i: int,
                      payload: bytes) -> None:
        self.restore_slice_from(index, frame, view, slice_i, io.BytesIO(payload))

    def backup_to(self, w, index: str, frame: str, view: str) -> None:
        """Write every slice's archive of a view into one tar whose members
        are named by slice, in slice order (reference: client.go:478-560).
        A tar header needs its member's size first and a chunked body has
        none, so each archive spools through a SpooledTemporaryFile (on
        disk past a few chunks): memory stays at chunk scale.  Up to
        ``VIEW_ARCHIVES_IN_FLIGHT`` archives are fetched at once."""
        from pilosa_tpu_torch.core.view import VIEW_INVERSE, is_valid_view

        # A whole-frame backup takes the standard or the inverse view
        # (reference: client.go:491-497); time views move by frame restore.
        if not is_valid_view(view):
            raise ClientError(400, "invalid view")
        max_slices = self.max_slice_by_index(inverse=view == VIEW_INVERSE)

        def fetch(slice_i: int):
            src = self.stream_backup_slice(index, frame, view, slice_i)
            if src is None:
                return None
            spool = tempfile.SpooledTemporaryFile(max_size=4 * self.chunk_bytes)
            try:
                with src:
                    for chunk in src:
                        spool.write(chunk)
            except BaseException:
                spool.close()
                raise
            return spool

        def add(slice_i: int, fut) -> None:
            spool = fut.result()
            if spool is None:
                return
            with spool:
                info = tarfile.TarInfo(str(slice_i))
                info.size = spool.tell()
                info.mtime = int(time.time())
                spool.seek(0)
                tw.addfile(info, spool)

        tw = tarfile.open(fileobj=w, mode="w|")
        with ThreadPoolExecutor(VIEW_ARCHIVES_IN_FLIGHT) as ex:
            pending: deque = deque()
            try:
                for slice_i in range(max_slices.get(index, 0) + 1):
                    pending.append((slice_i, ex.submit(fetch, slice_i)))
                    if len(pending) >= VIEW_ARCHIVES_IN_FLIGHT:
                        add(*pending.popleft())
                while pending:
                    add(*pending.popleft())
            finally:
                _drop(fut for _, fut in pending)
        tw.close()

    def restore_from(self, r, index: str, frame: str, view: str) -> None:
        """Restore a tar of :meth:`backup_to` (reference:
        client.go:562-588): each member spooled (on disk past a few chunks)
        and posted as a chunked body, up to ``VIEW_ARCHIVES_IN_FLIGHT`` at
        once; the first failure raises once the posts in flight end."""

        def post(slice_i: int, spool) -> None:
            with spool:
                self.restore_slice_from(index, frame, view, slice_i, spool)

        tr = tarfile.open(fileobj=r, mode="r|")
        with ThreadPoolExecutor(VIEW_ARCHIVES_IN_FLIGHT) as ex:
            pending: deque = deque()
            try:
                for member in tr:
                    spool = tempfile.SpooledTemporaryFile(max_size=4 * self.chunk_bytes)
                    shutil.copyfileobj(tr.extractfile(member), spool, self.chunk_bytes)
                    spool.seek(0)
                    pending.append(ex.submit(post, int(member.name), spool))
                    if len(pending) >= VIEW_ARCHIVES_IN_FLIGHT:
                        pending.popleft().result()
                while pending:
                    pending.popleft().result()
            finally:
                _drop(pending)
        tr.close()

    def restore_frame(self, host: str, index: str, frame: str) -> None:
        """Ask the node to pull a frame from ``host`` (reference:
        client.go:704-738)."""
        status, data = self._request("POST", f"/index/{index}/frame/{frame}/restore",
                                     query={"host": host})
        self._check(status, data)

    # --- block sync (reference: client.go:828-1010) ---

    def fragment_blocks(self, index: str, frame: str, view: str,
                        slice_i: int) -> list[tuple[int, bytes]]:
        status, data = self._request(
            "GET", "/fragment/blocks",
            query={"index": index, "frame": frame, "view": view, "slice": slice_i},
        )
        blocks = json.loads(self._check(status, data))["blocks"]
        return [(b["id"], base64.b64decode(b["checksum"])) for b in blocks]

    def block_data(self, index: str, frame: str, view: str, slice_i: int,
                   block: int) -> tuple[list[int], list[int]]:
        pb = wire.BlockDataRequest(Index=index, Frame=frame, View=view, Slice=slice_i,
                                   Block=block)
        status, data = self._request(
            "GET", "/fragment/block/data", body=pb.encode(),
            headers={"Content-Type": PROTOBUF, "Accept": PROTOBUF},
        )
        resp = wire.BlockDataResponse.decode(self._check(status, data))
        return (np.asarray(resp.RowIDs, dtype=np.uint64).tolist(),
                np.asarray(resp.ColumnIDs, dtype=np.uint64).tolist())

    def import_view_bits(self, index: str, frame: str, view: str, slice_i: int,
                         sets: tuple, clears: tuple) -> None:
        """Sets and clears, ``(row ids, absolute column ids)`` each, in one
        view of a slice on this node."""
        pb = wire.ImportViewRequest(
            Index=index, Frame=frame, View=view, Slice=slice_i,
            RowIDs=[int(r) for r in sets[0]], ColumnIDs=[int(c) for c in sets[1]],
            ClearRowIDs=[int(r) for r in clears[0]],
            ClearColumnIDs=[int(c) for c in clears[1]],
        )
        status, data = self._request(
            "POST", "/fragment/import-view", body=pb.encode(),
            headers={"Content-Type": PROTOBUF, "Accept": PROTOBUF},
        )
        resp = wire.ImportResponse.decode(self._check(status, data))
        if resp.Err:
            raise ClientError(500, resp.Err)

    def column_attr_diff(self, index: str, blocks: list[tuple[int, bytes]]) -> dict[int, dict]:
        return self._attr_diff(f"/index/{index}/attr/diff", blocks)

    def row_attr_diff(self, index: str, frame: str,
                      blocks: list[tuple[int, bytes]]) -> dict[int, dict]:
        return self._attr_diff(f"/index/{index}/frame/{frame}/attr/diff", blocks)

    def _attr_diff(self, path: str, blocks: list[tuple[int, bytes]]) -> dict[int, dict]:
        body = json.dumps({"blocks": [{"id": bid, "checksum": base64.b64encode(chk).decode()}
                                      for bid, chk in blocks]}).encode()
        status, data = self._request("POST", path, body=body)
        if status == 404:
            raise ClientError(404, "frame not found")
        attrs = json.loads(self._check(status, data))["attrs"]
        return {int(k): v for k, v in attrs.items()}
