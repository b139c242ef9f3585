"""Cluster messaging — schema broadcast between nodes.

The counterpart of ``pilosa_tpu.cluster.broadcast``: five schema
messages travel between nodes as a 1-byte type tag + the protobuf
payload (reference: broadcast.go:26-166), so that every node can route
queries for indexes and frames it has never written:

  CreateSliceMessage  — an index grew a new max slice
  CreateIndexMessage / DeleteIndexMessage
  CreateFrameMessage / DeleteFrameMessage

Two transports, chosen by the cluster type:

  static — ``NopBroadcaster``: nothing is sent (one node, or a fixed
           node list whose schema the operator creates on each node)
  http   — ``HTTPBroadcaster`` POSTs the envelope to every peer's
           ``HTTPBroadcastReceiver`` (reference: httpbroadcast/)

Gossip membership is not ported yet.
"""

from __future__ import annotations

import http.client
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pilosa_tpu_torch.net import wire

# Message type bytes (reference: broadcast.go:109-124)
MSG_CREATE_SLICE = 1
MSG_CREATE_INDEX = 2
MSG_DELETE_INDEX = 3
MSG_CREATE_FRAME = 4
MSG_DELETE_FRAME = 5

_TYPE_OF = {
    wire.CreateSliceMessage: MSG_CREATE_SLICE,
    wire.CreateIndexMessage: MSG_CREATE_INDEX,
    wire.DeleteIndexMessage: MSG_DELETE_INDEX,
    wire.CreateFrameMessage: MSG_CREATE_FRAME,
    wire.DeleteFrameMessage: MSG_DELETE_FRAME,
}
_CLASS_OF = {v: k for k, v in _TYPE_OF.items()}


def marshal_message(msg) -> bytes:
    """type byte + protobuf payload (reference: broadcast.go:126-146)."""
    typ = _TYPE_OF.get(type(msg))
    if typ is None:
        raise ValueError(f"message type not implemented: {type(msg).__name__}")
    return bytes([typ]) + msg.encode()


def unmarshal_message(data: bytes):
    """reference: broadcast.go:148-166"""
    if not data:
        raise ValueError("empty message")
    cls = _CLASS_OF.get(data[0])
    if cls is None:
        raise ValueError(f"invalid message type: {data[0]}")
    return cls.decode(data[1:])


class NopBroadcaster:
    """The static cluster type's broadcaster (reference:
    broadcast.go:70-85)."""

    def send_sync(self, msg) -> None:
        pass

    def send_async(self, msg) -> None:
        pass


class StaticNodeSet:
    """Fixed host list from the configuration (reference:
    broadcast.go:34-58)."""

    def __init__(self, hosts: list[str] | None = None):
        self._hosts = list(hosts or [])

    def nodes(self) -> list[str]:
        return list(self._hosts)

    def open(self) -> None:
        pass


class HTTPBroadcaster:
    """POST the message envelope to every peer's internal listener
    (reference: httpbroadcast/messenger.go:43-122).  ``internal_hosts``
    lists the peers' receivers; the server keeps it current as nodes
    join."""

    def __init__(self, internal_hosts: list[str] | None = None, timeout: float = 10.0):
        self.internal_hosts = list(internal_hosts or [])
        self.timeout = timeout

    def _post(self, host: str, payload: bytes) -> None:
        conn = http.client.HTTPConnection(host, timeout=self.timeout)
        try:
            conn.request(
                "POST",
                "/messages",
                body=payload,
                headers={"Content-Type": "application/octet-stream"},
            )
            resp = conn.getresponse()
            resp.read()
            if resp.status >= 400:
                raise RuntimeError(f"broadcast to {host}: http {resp.status}")
        finally:
            conn.close()

    def send_sync(self, msg) -> None:
        """Deliver to every peer; raise naming every peer that failed."""
        payload = marshal_message(msg)
        errors = []
        for host in list(self.internal_hosts):
            try:
                self._post(host, payload)
            except (OSError, http.client.HTTPException, RuntimeError) as e:
                errors.append(f"{host}: {e}")
        if errors:
            raise RuntimeError("; ".join(errors))

    def send_async(self, msg) -> None:
        """Best-effort delivery on one daemon thread per peer."""
        payload = marshal_message(msg)
        for host in list(self.internal_hosts):
            threading.Thread(
                target=self._safe_post, args=(host, payload), daemon=True,
                name=f"broadcast:{host}",
            ).start()

    def _safe_post(self, host: str, payload: bytes) -> None:
        try:
            self._post(host, payload)
        except (OSError, http.client.HTTPException, RuntimeError):
            pass  # async delivery is best-effort; max-slice polling repairs it


class HTTPBroadcastReceiver:
    """The second HTTP listener, for inter-node messages (reference:
    httpbroadcast/messenger.go:139-175).  ``start(handler)`` binds and
    hands every decoded message to ``handler.receive_message``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def bound_host(self) -> str:
        if self._server is None:
            return f"{self.host}:{self.port}"
        addr = self._server.server_address
        return f"{addr[0]}:{addr[1]}"

    def start(self, handler) -> None:
        class _Receiver(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                if self.path != "/messages":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                data = self.rfile.read(length)
                try:
                    handler.receive_message(unmarshal_message(data))
                except Exception as e:  # noqa: BLE001 — peer boundary
                    print(f"receive message error: {e}", file=sys.stderr)
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, format, *args):  # noqa: A002 — stdlib signature
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), _Receiver)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name=f"receiver:{self.bound_host}"
        )
        self._thread.start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
