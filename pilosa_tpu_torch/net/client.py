"""Internal HTTP client — the inter-node data plane.

The part of ``pilosa_tpu.net.client.InternalClient`` that the port's
cluster needs: protobuf queries (the map legs of a fan-out), schema
calls (BSI fields included), max slices, slice owners, and the
slice-targeted bulk imports that POST each slice's bits — or each
slice's field values — to every owner (reference: client.go:39-476;
JAX ``client.py:422-560``).

Resilience (JAX ``client.py:56-316``): a client may carry the server's
``RetryPolicy`` and ``BreakerRegistry`` (``net/resilience.py``).  Every
request passes the host's breaker (an open one fails at once), takes its
socket timeout from the query's remaining deadline and sends that budget
as ``X-Deadline-Ms``, and hits the ``rpc.send`` check point of
``testing/faults.py``; a transport failure or a 5xx counts against the
breaker.  Only idempotent calls (GETs, and the read legs and version
probes that say so) retry.  A bare client makes each request once.

Imports go to a slice's WRITE owners (both rings during a resize) with
W-of-N acknowledgement: ``consistency`` one, quorum or all sets W, the
payload of every owner that cannot be reached is queued as a hint on
the first owner that took it (``POST /replicate/hint``), and fewer than
W acknowledgements fail, naming each host.

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
from pilosa_tpu_torch.net import codec, resilience, wire
from pilosa_tpu_torch.net.resilience import TRANSPORT_ERRORS, is_node_failure  # noqa: F401
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH, np_group_by
from pilosa_tpu_torch.testing import faults

PROTOBUF = "application/x-protobuf"

# Fragment archives in flight at once in a whole-view backup or restore:
# the node's work per fragment (an encode, or a restore's six fsyncs)
# overlaps across requests, and the tar keeps slice order.
VIEW_ARCHIVES_IN_FLIGHT = 16


class ClientError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"http {status}: {message}")
        self.status = status


class PreconditionFailedError(ClientError):
    """412: the node does not own the slice."""

    def __init__(self, message: str = "precondition failed"):
        super().__init__(412, message)


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
    decoded Bitmap results land (the calling node's device); ``retry``
    and ``breakers`` are the server's shared resilience wiring;
    ``internal_token`` (the cluster's ``tenant-internal-token``) goes out
    as ``X-Internal-Token`` on every request, so map legs, imports and
    repairs keep the internal admission lane where a node requires the
    token (JAX ``net/client.py:55-66``)."""

    def __init__(self, host: str, timeout: float = 30.0, device=None,
                 retry: "resilience.RetryPolicy | None" = None,
                 breakers: "resilience.BreakerRegistry | None" = None,
                 internal_token: str = ""):
        self.host = host
        self.timeout = timeout
        self.device = device
        self.retry = retry
        self.breakers = breakers
        self.internal_token = internal_token
        # Attempts and first backoff of a streamed GET's opening, and the
        # chunk size of streamed bodies.
        self.stream_retries = 3
        self.stream_backoff = 0.1
        self.chunk_bytes = stream_mod.DEFAULT_CHUNK_BYTES

    def _peer(self, host: str) -> "InternalClient":
        """A client of another node with this one's resilience wiring."""
        if host == self.host:
            return self
        return InternalClient(host, self.timeout, self.device,
                              retry=self.retry, breakers=self.breakers,
                              internal_token=self.internal_token)

    # --- plumbing ---

    def _request(
        self,
        method: str,
        path: str,
        query: dict[str, Any] | None = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
        idempotent: bool | None = None,
    ) -> tuple[int, bytes]:
        status, data, _ = self._request_meta(method, path, query, body, headers, idempotent)
        return status, data

    def _request_meta(
        self,
        method: str,
        path: str,
        query: dict[str, Any] | None = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
        idempotent: bool | None = None,
    ) -> tuple[int, bytes, dict[str, str]]:
        """``(status, body, response headers with lower-case names)``.
        ``idempotent`` (default: a GET or HEAD) lets the retry policy
        repeat the request after a transport failure or a shed."""
        bare = path
        if query:
            path = f"{path}?{urllib.parse.urlencode(query)}"
        if idempotent is None:
            idempotent = method in ("GET", "HEAD")

        def attempt():
            return self._attempt(method, bare, path, body, headers)

        if idempotent and self.retry is not None:
            return self.retry.call(
                attempt, retryable=resilience.TRANSPORT_ERRORS + (resilience.ShedError,)
            )
        return attempt()

    def _attempt(self, method: str, bare: str, path: str, body, headers):
        """One request on the wire: the breaker's gate, the deadline's
        socket timeout and header, the ``rpc.send`` check point, and the
        outcome recorded against the breaker (a 429 is a healthy node
        shedding, and does not count)."""
        timeout, hdrs = self._prepare(method, bare, headers)
        conn = None
        try:
            try:
                faults.check("rpc.send", host=self.host, path=bare)
                conn = http.client.HTTPConnection(self.host, timeout=timeout)
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except resilience.TRANSPORT_ERRORS:
                self._record_breaker(False)
                raise
            resp_headers = {k.lower(): v for k, v in resp.getheaders()}
            self._record_breaker(resp.status < 500)
            if resp.status == 429:
                raise _shed_error(self.host, data, resp_headers)
            return resp.status, data, resp_headers
        finally:
            if conn is not None:
                conn.close()

    def _prepare(self, method: str, bare: str, headers) -> tuple[float, dict[str, str]]:
        """Before any socket work: fail an expired deadline and an open
        breaker, bound the timeout by the remaining budget and send that
        budget as ``X-Deadline-Ms``, with the internal-lane token."""
        dl = resilience.current_deadline()
        if dl is not None and dl.expired:
            raise resilience.DeadlineExceeded(
                f"deadline exceeded before {method} {bare} to {self.host}"
            )
        if self.breakers is not None:
            self.breakers.check(self.host)
        hdrs = dict(headers or {})
        if self.internal_token:
            hdrs.setdefault("X-Internal-Token", self.internal_token)
        timeout = self.timeout
        if dl is not None:
            timeout = min(timeout, max(dl.remaining(), 0.001))
            hdrs[resilience.DEADLINE_HEADER] = dl.header_value()
        return timeout, hdrs

    def _record_breaker(self, ok: bool) -> None:
        if self.breakers is not None:
            self.breakers.record(self.host, ok)

    def _request_chunked(
        self, method: str, path: str, reader, query: dict[str, Any] | None = None,
        headers: dict[str, str] | None = None,
    ) -> tuple[int, bytes]:
        """A request whose body streams off ``reader`` with chunked
        transfer encoding, in writes of ``chunk_bytes``; made once (the
        reader cannot be rewound), through the breaker and deadline."""
        bare = path
        if query:
            path = f"{path}?{urllib.parse.urlencode(query)}"

        def chunks():
            while True:
                data = reader.read(self.chunk_bytes)
                if not data:
                    return
                yield data

        timeout, hdrs = self._prepare(method, bare, headers)
        conn = None
        try:
            try:
                faults.check("rpc.send", host=self.host, path=bare)
                conn = http.client.HTTPConnection(self.host, timeout=timeout)
                conn.request(method, path, body=chunks(),
                             headers={**hdrs, "Transfer-Encoding": "chunked"},
                             encode_chunked=True)
                resp = conn.getresponse()
                data = resp.read()
            except resilience.TRANSPORT_ERRORS:
                self._record_breaker(False)
                raise
            self._record_breaker(resp.status < 500)
            if resp.status == 429:
                raise _shed_error(self.host, data, {k.lower(): v for k, v in resp.getheaders()})
            return resp.status, data
        finally:
            if conn is not None:
                conn.close()

    def _open_stream(
        self, method: str, path: str, query: dict[str, Any] | None = None,
        headers: dict[str, str] | None = None,
    ) -> stream_mod.HTTPBodyStream:
        """An error-checked response body stream; its opening (the dial and
        the status line) retries with backoff, the stream itself does not.
        The caller closes it."""
        bare = path
        if query:
            path = f"{path}?{urllib.parse.urlencode(query)}"

        def _open():
            timeout, hdrs = self._prepare(method, bare, headers)
            faults.check("rpc.send", host=self.host, path=bare)
            conn = http.client.HTTPConnection(self.host, timeout=timeout)
            try:
                conn.request(method, path, headers=hdrs)
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
        if status == 429:
            raise resilience.ShedError(_err_text(data))
        if status == 504:
            # The peer's deadline ran out: the coordinator fails the
            # query too, rather than fail over as from a dead node.
            raise resilience.DeadlineExceeded(_err_text(data))
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
        idempotent: bool = False,
    ) -> list:
        """Run ``query`` on the host.  ``trace_headers`` (the caller's rpc
        span, ``Tracer.remote_headers``, and any other header of the leg,
        such as the quorum coordinator's write-version stamp) continue
        the caller's trace there; the spans the host sends back in
        ``X-Trace-Spans`` go into ``tracer`` (JAX ``net/client.py:365``).
        ``idempotent`` lets the retry policy repeat a read leg; a write
        leg is made once."""
        pb = wire.QueryRequest(Query=query, Slices=list(slices or []), Remote=remote)
        headers = {"Content-Type": PROTOBUF, "Accept": PROTOBUF}
        if trace_headers:
            headers.update(trace_headers)
        status, data, resp_headers = self._request_meta(
            "POST", f"/index/{index}/query", body=pb.encode(), headers=headers,
            idempotent=idempotent,
        )
        if tracer is not None:
            payload = resp_headers.get("x-trace-spans")
            if payload:
                tracer.absorb(payload)
        if status in (429, 504):
            self._check(status, data)
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

    def execute_pql(self, index: str, query: str) -> Any:
        """One call's result (reference: client.go:258-281)."""
        results = self.execute_query(index, query)
        if not results:
            raise ClientError(200, "empty response")
        return results[0]

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

    def fragment_nodes(self, index: str, slice_i: int, write: bool = False) -> list[dict]:
        """Owners of a slice, as ``[{"host", "internalHost"}]``;
        ``write=True`` asks for its write owners (both rings during a
        resize)."""
        query: dict = {"index": index, "slice": slice_i}
        if write:
            query["write"] = "true"
        status, data = self._request("GET", "/fragment/nodes", query=query)
        return json.loads(self._check(status, data))

    # --- import (reference: client.go:314-401) ---

    def import_slice(
        self, index: str, frame: str, slice_i: int, rows, cols, timestamps=None,
        view: str = "", host: str | None = None, consistency: str = "quorum",
    ) -> None:
        """POST one slice's bits to every write owner of the slice with
        W-of-N acknowledgement at ``consistency`` (see
        :meth:`_fanout_write`), or to ``host`` alone, which must accept
        them.  ``view="inverse"`` sends the inverse half of an import:
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
        payload = pb.encode()

        def post(client) -> None:
            status, data = client._request(
                "POST", path, body=payload,
                headers={"Content-Type": PROTOBUF, "Accept": PROTOBUF},
            )
            resp = wire.ImportResponse.decode(client._check(status, data))
            if resp.Err:
                raise ClientError(500, resp.Err)

        if host is not None:
            return self._post_one(host, post)
        # A hint replays the whole /import body, so only a standard
        # import is hinted; the inverse half goes to its owners alone.
        self._fanout_write(index, slice_i, post, consistency,
                           "import" if view != "inverse" else "", payload, len(pb.RowIDs))

    def import_value(
        self, index: str, frame: str, field: str, slice_i: int, columns, values,
        consistency: str = "quorum",
    ) -> None:
        """POST one slice's field values (``/import-value``) to every
        write owner of the slice, as :meth:`import_slice` does with
        bits."""
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

        def post(client) -> None:
            status, data = client._request("POST", "/import-value", body=payload)
            client._check(status, data)

        self._fanout_write(index, slice_i, post, consistency, "import-value", payload,
                           len(np.asarray(columns)))

    def _post_one(self, host: str, post) -> None:
        try:
            post(self._peer(host))
        except TRANSPORT_ERRORS + (ClientError, ValueError) as e:
            raise ClientError(500, f"import failed on {host}: {e}") from e

    def _fanout_write(self, index: str, slice_i: int, post, consistency: str,
                      hint_kind: str, payload: bytes, rows: int) -> None:
        """Every write owner of the slice receives the payload; the
        acknowledgements count against W = ``required_acks(consistency,
        N)``; each owner that failed gets the payload queued as a hint on
        the first owner that took it; fewer than W acknowledgements fail,
        naming every host that failed (JAX ``client.py:560-630``)."""
        from pilosa_tpu_torch.replicate.quorum import required_acks, validate_level

        validate_level(consistency)
        nodes = self.fragment_nodes(index, slice_i, write=True)
        if not nodes:
            raise ClientError(500, f"no nodes for slice {slice_i}")
        failures = (ClientError, ValueError, resilience.BreakerOpenError,
                    resilience.ShedError) + TRANSPORT_ERRORS
        acked: list[str] = []
        errs: list[str] = []
        failed: list[str] = []
        for node in nodes:
            try:
                post(self._peer(node["host"]))
                acked.append(node["host"])
            except failures as e:
                errs.append(f"{node['host']}: {e}")
                failed.append(node["host"])
        hint_errs: list[str] = []
        if failed and acked and hint_kind:
            holder = self._peer(acked[0])
            for host in failed:
                try:
                    holder.queue_hint(host, index, slice_i, hint_kind, payload, rows)
                except failures as e:
                    hint_errs.append(f"{host}: {e}")
        need = required_acks(consistency, len(nodes))
        if len(acked) < need:
            raise ClientError(
                500,
                f"import acknowledged by {len(acked)} of {len(nodes)} "
                f"replicas (need {need} at consistency={consistency}): " + "; ".join(errs),
            )
        if hint_errs:
            raise ClientError(500, "import acked but hint queue failed: " + "; ".join(hint_errs))
        if failed and not hint_kind:
            raise ClientError(500, "import failed on " + "; ".join(errs))

    # --- replication (JAX client.py:632-711) ---

    def queue_hint(self, target: str, index: str, slice_i: int, kind: str,
                   payload: bytes, rows: int) -> None:
        """Queue a write payload on this node as a hint for ``target``
        (hinted handoff: any live node may hold hints for a dead one)."""
        body = json.dumps({
            "target": target, "index": index, "slice": int(slice_i), "kind": kind,
            "payload": base64.b64encode(payload).decode(), "rows": int(rows),
        }).encode()
        status, data = self._request("POST", "/replicate/hint", body=body)
        self._check(status, data)

    def replicate_versions(self, index: str, slices) -> dict[int, int]:
        """The node's write versions of ``slices``: a read's staleness
        probe, one call for many slices (a read, so it may retry)."""
        body = json.dumps({"index": index, "slices": [int(s) for s in slices]}).encode()
        status, data = self._request("POST", "/replicate/versions", body=body, idempotent=True)
        versions = json.loads(self._check(status, data))["versions"]
        return {int(k): int(v) for k, v in versions.items()}

    def observe_version(self, index: str, slice_i: int, version: int) -> None:
        """Move the node's slice version forward (max-merge): the mark
        left after a repair or a replay."""
        body = json.dumps({"index": index, "slice": int(slice_i), "version": int(version),
                           "action": "observe"}).encode()
        status, data = self._request("POST", "/replicate/versions", body=body, idempotent=True)
        self._check(status, data)

    def import_raw(self, payload: bytes) -> None:
        """Replay a queued ``/import`` body as it was, on this node."""
        status, data = self._request(
            "POST", "/import", body=payload,
            headers={"Content-Type": PROTOBUF, "Accept": PROTOBUF, "X-Internal-Lane": "1"},
        )
        resp = wire.ImportResponse.decode(self._check(status, data))
        if resp.Err:
            raise ClientError(500, resp.Err)

    def import_value_raw(self, payload: bytes) -> None:
        """Replay a queued ``/import-value`` body as it was."""
        status, data = self._request("POST", "/import-value", body=payload,
                                     headers={"X-Internal-Lane": "1"})
        self._check(status, data)

    def import_bits(self, index: str, frame: str, rows, cols, timestamps=None,
                    consistency: str = "quorum") -> list[int]:
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
            self.import_slice(index, frame, s, *parts, consistency=consistency)
            sent.append(s)
        return sent

    def import_values(self, index: str, frame: str, field: str, cols, values,
                      consistency: str = "quorum") -> list[int]:
        """Group (column, value) pairs by slice and send each slice's
        values to all its owners; returns the slices sent."""
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        if len(cols) != len(values):
            raise ValueError("columns and values differ in length")
        sent = []
        for s, (c_s, v_s) in np_group_by(cols // SLICE_WIDTH, cols, values):
            self.import_value(index, frame, field, s, c_s, v_s, consistency=consistency)
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

    def tier_restore(self, index: str, frame: str, view: str, slice_i: int) -> int:
        """Ask the node to restore one fragment from its own object store
        (the copy of a resize through a shared store, JAX
        ``net/client.py:866``).  Returns the bytes restored; a node with
        no tier answers 501 (``ClientError``), and the caller streams the
        fragment instead."""
        payload = json.dumps(
            {"index": index, "frame": frame, "view": view, "slice": int(slice_i)}
        ).encode()
        status, data = self._request("POST", "/tier/restore", body=payload)
        return int(json.loads(self._check(status, data)).get("bytes", 0))

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


def _shed_error(host: str, data: bytes, headers: dict[str, str]) -> resilience.ShedError:
    """A 429 answer as a ShedError with the server's Retry-After hint:
    the body's milliseconds where present, else the header's seconds,
    else 1 s."""
    retry_after = 1.0
    try:
        retry_after = float(headers.get("retry-after", "") or 1.0)
    except ValueError:
        pass
    try:
        ms = json.loads(data).get("retryAfterMs")
        if ms is not None:
            retry_after = float(ms) / 1000.0
    except (json.JSONDecodeError, AttributeError, TypeError, ValueError):
        pass
    return resilience.ShedError(_err_text(data), retry_after_s=retry_after, host=host)
