"""Pluggable object store for the cold tier.

The counterpart of ``pilosa_tpu/tier/store.py``, with its protocol,
headers and metadata sidecars.  One interface, two backends:

* :class:`LocalFSStore` — objects as files under one root directory
  with a JSON metadata sidecar per object.  The single-machine
  backend, and the durable half of :func:`serve_store`.
* :class:`HTTPStore` — an S3-style HTTP backend: ``PUT/GET/DELETE
  {base}/{key}`` with the content checksum in an ``X-Content-Sha256``
  header and listing via ``GET {base}/?prefix=``.  Unary calls ride
  the shared retry policy and per-host circuit breaker from
  ``net/resilience.py`` — a flapping store fails in microseconds
  instead of burning a socket timeout per op.

Every object carries a SHA-256 content checksum, written at put time
and verified on every get: a torn upload, bit rot, or a truncated
download surfaces as :class:`StoreChecksumError` (a named error) rather
than silently installing bad bytes downstream.

Store ops are timed into per-op latency histograms
(``tier.store.<op>Ms`` — summaries on ``/metrics``) and failures count
``tier.storeErrors``; both through the stats client handed to the
store, so the bare default costs nothing.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Any

from pilosa_tpu_torch.net import resilience as rz
from pilosa_tpu_torch.obs.stats import NopStatsClient

# Metadata sidecar suffix in the local backend; keys may not end with
# it (they would collide with their own sidecar).
META_SUFFIX = ".pmeta"

# Content-checksum and extra-metadata headers in the HTTP protocol.
SHA_HEADER = "X-Content-Sha256"
EXTRA_HEADER = "X-Store-Extra"


class StoreError(RuntimeError):
    """Any object-store failure (transport, protocol, missing key)."""


class StoreChecksumError(StoreError):
    """An object's bytes do not match its recorded content checksum —
    the named torn-bytes error the hydration/restore paths reject on
    instead of installing corrupt state."""


@dataclass
class ObjectMeta:
    """One stored object's identity: size + content checksum + opaque
    uploader-supplied ``extra`` (the tier manager records the
    fragment's logical checksum there so rebalance can judge
    freshness without downloading the tar)."""

    key: str
    size: int
    sha256: str
    mtime: float = 0.0
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "key": self.key,
            "size": self.size,
            "sha256": self.sha256,
            "mtime": self.mtime,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectMeta":
        return cls(
            key=str(d.get("key", "")),
            size=int(d.get("size", 0)),
            sha256=str(d.get("sha256", "")),
            mtime=float(d.get("mtime", 0.0)),
            extra=dict(d.get("extra") or {}),
        )


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def validate_key(key: str) -> str:
    """Store keys are slash-separated relative paths — no traversal,
    no absolute paths, no collision with the local backend's metadata
    sidecars."""
    if (
        not key
        or key.startswith("/")
        or key.endswith(META_SUFFIX)
        or any(part in ("", ".", "..") for part in key.split("/"))
    ):
        raise StoreError(f"invalid store key: {key!r}")
    return key


class ObjectStore:
    """Base class: public ops wrap the backend's ``_op`` methods with
    per-op latency histograms and the shared error counter."""

    #: human-readable backend location, surfaced in /debug/tier
    url: str = ""

    def __init__(self, stats=None):
        self.stats = stats or NopStatsClient()

    # -- public API (timed) -------------------------------------------

    def put(self, key: str, data: bytes, extra: dict | None = None) -> ObjectMeta:
        validate_key(key)
        return self._timed("put", lambda: self._put(key, data, extra or {}))

    def get(self, key: str) -> bytes:
        """Fetch and CHECKSUM-VERIFY one object's bytes."""
        validate_key(key)
        data, meta = self._timed("get", lambda: self._get(key))
        if meta.sha256 and sha256_hex(data) != meta.sha256:
            self.stats.count("tier.storeErrors")
            raise StoreChecksumError(
                f"store object {key!r}: content does not match its "
                f"recorded sha256 ({meta.sha256[:12]}…)"
            )
        return data

    def get_meta(self, key: str) -> ObjectMeta | None:
        """Object metadata without the bytes; None when absent."""
        validate_key(key)
        return self._timed("head", lambda: self._get_meta(key))

    def list(self, prefix: str = "") -> list[ObjectMeta]:
        return self._timed("list", lambda: self._list(prefix))

    def delete(self, key: str) -> bool:
        validate_key(key)
        return self._timed("delete", lambda: self._delete(key))

    def _timed(self, op: str, fn):
        t0 = time.monotonic()
        try:
            return fn()
        except Exception:
            self.stats.count("tier.storeErrors")
            raise
        finally:
            self.stats.histogram(
                f"tier.store.{op}Ms", (time.monotonic() - t0) * 1000.0
            )

    # -- backend hooks -------------------------------------------------

    def _put(self, key: str, data: bytes, extra: dict) -> ObjectMeta:
        raise NotImplementedError

    def _get(self, key: str) -> tuple[bytes, ObjectMeta]:
        raise NotImplementedError

    def _get_meta(self, key: str) -> ObjectMeta | None:
        raise NotImplementedError

    def _list(self, prefix: str) -> list[ObjectMeta]:
        raise NotImplementedError

    def _delete(self, key: str) -> bool:
        raise NotImplementedError

    def snapshot(self) -> dict:
        return {"backend": type(self).__name__, "url": self.url}


# ---------------------------------------------------------------------------
# local filesystem backend
# ---------------------------------------------------------------------------


class LocalFSStore(ObjectStore):
    """Objects as files under ``root`` with a ``<key>.pmeta`` JSON
    sidecar.  Writes are atomic (tmp + rename), and the sidecar is
    written LAST so its presence is the commit marker: a crash
    mid-upload leaves a data file without metadata, which reads as
    absent rather than as a torn object."""

    def __init__(self, root: str, stats=None):
        super().__init__(stats=stats)
        self.root = os.path.abspath(os.path.expanduser(root))
        self.url = f"file://{self.root}"
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def _put(self, key: str, data: bytes, extra: dict) -> ObjectMeta:
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta = ObjectMeta(
            key=key,
            size=len(data),
            sha256=sha256_hex(data),
            mtime=time.time(),
            extra=dict(extra),
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        mtmp = path + META_SUFFIX + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(meta.to_dict(), f)
        os.replace(mtmp, path + META_SUFFIX)
        return meta

    def _read_meta(self, key: str) -> ObjectMeta | None:
        try:
            with open(self._path(key) + META_SUFFIX) as f:
                return ObjectMeta.from_dict(json.load(f))
        except (OSError, ValueError):
            return None

    def _get(self, key: str) -> tuple[bytes, ObjectMeta]:
        meta = self._read_meta(key)
        if meta is None:
            raise StoreError(f"store object not found: {key!r}")
        try:
            with open(self._path(key), "rb") as f:
                return f.read(), meta
        except OSError as e:
            raise StoreError(f"store object unreadable: {key!r}: {e}") from e

    def _get_meta(self, key: str) -> ObjectMeta | None:
        return self._read_meta(key)

    def _list(self, prefix: str) -> list[ObjectMeta]:
        out: list[ObjectMeta] = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if not name.endswith(META_SUFFIX):
                    continue
                full = os.path.join(dirpath, name)
                key = os.path.relpath(
                    full[: -len(META_SUFFIX)], self.root
                ).replace(os.sep, "/")
                if not key.startswith(prefix):
                    continue
                meta = self._read_meta(key)
                if meta is not None:
                    out.append(meta)
        out.sort(key=lambda m: m.key)
        return out

    def _delete(self, key: str) -> bool:
        existed = False
        for path in (self._path(key), self._path(key) + META_SUFFIX):
            try:
                os.unlink(path)
                existed = True
            except OSError:
                pass
        return existed


# ---------------------------------------------------------------------------
# S3-style HTTP backend
# ---------------------------------------------------------------------------


class HTTPStore(ObjectStore):
    """S3-style HTTP object store behind the same interface.

    Protocol (also what :func:`serve_store` serves):

    * ``PUT {base}/{key}`` — body is the object; ``X-Content-Sha256``
      carries the uploader's checksum (the server verifies it) and
      ``X-Store-Extra`` optional JSON metadata.
    * ``GET {base}/{key}`` — 200 body + the same headers back.
    * ``HEAD``-equivalent: ``GET {base}/{key}?meta=true`` — JSON meta.
    * ``DELETE {base}/{key}``.
    * ``GET {base}/?prefix=p`` — JSON ``{"objects": [meta, ...]}``.

    All ops are idempotent (puts replace whole objects), so every call
    rides the retry policy; the per-host breaker makes a down store
    fail fast instead of stalling hydration behind socket timeouts.
    """

    def __init__(
        self,
        base_url: str,
        stats=None,
        retry: "rz.RetryPolicy | None" = None,
        breakers: "rz.BreakerRegistry | None" = None,
        timeout: float = 30.0,
    ):
        super().__init__(stats=stats)
        parsed = urllib.parse.urlparse(base_url)
        if parsed.scheme != "http" or not parsed.netloc:
            raise StoreError(f"invalid http store url: {base_url!r}")
        self.url = base_url.rstrip("/")
        self.host = parsed.netloc
        self.base_path = parsed.path.rstrip("/")
        self.timeout = timeout
        self.retry = retry or rz.RetryPolicy(stats=stats)
        self.breakers = breakers or rz.BreakerRegistry(stats=stats)

    def _request(
        self,
        method: str,
        path: str,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
    ) -> tuple[int, bytes, dict[str, str]]:
        def attempt():
            self.breakers.check(self.host)
            conn = None
            try:
                try:
                    conn = http.client.HTTPConnection(
                        self.host, timeout=self.timeout
                    )
                    conn.request(method, path, body=body, headers=headers or {})
                    resp = conn.getresponse()
                    data = resp.read()
                except rz.TRANSPORT_ERRORS:
                    self.breakers.record(self.host, False)
                    raise
                self.breakers.record(self.host, resp.status < 500)
                return (
                    resp.status,
                    data,
                    {k.lower(): v for k, v in resp.getheaders()},
                )
            finally:
                if conn is not None:
                    conn.close()

        return self.retry.call(attempt)

    def _key_path(self, key: str) -> str:
        return f"{self.base_path}/{urllib.parse.quote(key)}"

    def _put(self, key: str, data: bytes, extra: dict) -> ObjectMeta:
        meta = ObjectMeta(
            key=key, size=len(data), sha256=sha256_hex(data),
            mtime=time.time(), extra=dict(extra),
        )
        headers = {SHA_HEADER: meta.sha256}
        if extra:
            headers[EXTRA_HEADER] = json.dumps(extra, separators=(",", ":"))
        status, body, _ = self._request(
            "PUT", self._key_path(key), body=data, headers=headers
        )
        if status >= 300:
            raise StoreError(
                f"store put {key!r} failed: http {status}: "
                f"{body[:200].decode(errors='replace')}"
            )
        return meta

    @staticmethod
    def _meta_from_headers(key: str, data_len: int, headers: dict) -> ObjectMeta:
        extra: dict = {}
        raw = headers.get(EXTRA_HEADER.lower(), "")
        if raw:
            try:
                extra = json.loads(raw)
            except ValueError:
                extra = {}
        return ObjectMeta(
            key=key,
            size=data_len,
            sha256=headers.get(SHA_HEADER.lower(), ""),
            extra=extra,
        )

    def _get(self, key: str) -> tuple[bytes, ObjectMeta]:
        status, data, headers = self._request("GET", self._key_path(key))
        if status == 404:
            raise StoreError(f"store object not found: {key!r}")
        if status >= 300:
            raise StoreError(f"store get {key!r} failed: http {status}")
        return data, self._meta_from_headers(key, len(data), headers)

    def _get_meta(self, key: str) -> ObjectMeta | None:
        status, data, _ = self._request(
            "GET", self._key_path(key) + "?meta=true"
        )
        if status == 404:
            return None
        if status >= 300:
            raise StoreError(f"store head {key!r} failed: http {status}")
        try:
            return ObjectMeta.from_dict(json.loads(data))
        except ValueError as e:
            raise StoreError(f"store head {key!r}: bad meta: {e}") from e

    def _list(self, prefix: str) -> list[ObjectMeta]:
        q = urllib.parse.urlencode({"prefix": prefix})
        status, data, _ = self._request("GET", f"{self.base_path}/?{q}")
        if status >= 300:
            raise StoreError(f"store list failed: http {status}")
        try:
            doc = json.loads(data)
            return [ObjectMeta.from_dict(d) for d in doc.get("objects", [])]
        except (ValueError, AttributeError) as e:
            raise StoreError(f"store list: bad response: {e}") from e

    def _delete(self, key: str) -> bool:
        status, _, _ = self._request("DELETE", self._key_path(key))
        if status == 404:
            return False
        if status >= 300:
            raise StoreError(f"store delete {key!r} failed: http {status}")
        return True

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["breaker"] = self.breakers.state(self.host)
        return out


# ---------------------------------------------------------------------------
# the serving side of the HTTP protocol (tests and single-machine deployments)
# ---------------------------------------------------------------------------


def serve_store(store: ObjectStore, host: str = "127.0.0.1", port: int = 0):
    """Serve ``store`` over the :class:`HTTPStore` protocol.  Returns a
    ``ThreadingHTTPServer`` (caller starts ``serve_forever`` on a
    thread and owns ``shutdown``): how tests and ``chip_smoke.py``
    drive the S3-style backend for real, and a minimal single-machine
    deployment of a shared store."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _key(self) -> str:
            path = urllib.parse.urlparse(self.path).path
            return urllib.parse.unquote(path.lstrip("/"))

        def _send(self, status: int, body: bytes = b"",
                  headers: dict | None = None) -> None:
            self.send_response(status)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, status: int, obj: Any) -> None:
            self._send(
                status,
                json.dumps(obj).encode(),
                {"Content-Type": "application/json"},
            )

        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            parsed = urllib.parse.urlparse(self.path)
            query = dict(urllib.parse.parse_qsl(parsed.query))
            key = self._key()
            try:
                if not key:
                    objs = store.list(query.get("prefix", ""))
                    self._send_json(200, {"objects": [m.to_dict() for m in objs]})
                    return
                if query.get("meta") == "true":
                    meta = store.get_meta(key)
                    if meta is None:
                        self._send_json(404, {"error": "not found"})
                    else:
                        self._send_json(200, meta.to_dict())
                    return
                meta = store.get_meta(key)
                if meta is None:
                    self._send_json(404, {"error": "not found"})
                    return
                data = store.get(key)
                headers = {SHA_HEADER: meta.sha256}
                if meta.extra:
                    headers[EXTRA_HEADER] = json.dumps(
                        meta.extra, separators=(",", ":")
                    )
                self._send(200, data, headers)
            except StoreChecksumError as e:
                self._send_json(502, {"error": str(e)})
            except StoreError as e:
                self._send_json(400, {"error": str(e)})

        def do_PUT(self) -> None:  # noqa: N802
            key = self._key()
            try:
                n = int(self.headers.get("Content-Length", "0"))
                data = self.rfile.read(n)
                claimed = self.headers.get(SHA_HEADER, "")
                if claimed and sha256_hex(data) != claimed:
                    # reject the torn upload before it becomes an object
                    self._send_json(
                        422, {"error": "content does not match X-Content-Sha256"}
                    )
                    return
                extra: dict = {}
                raw = self.headers.get(EXTRA_HEADER, "")
                if raw:
                    try:
                        extra = json.loads(raw)
                    except ValueError:
                        extra = {}
                meta = store.put(key, data, extra=extra)
                self._send_json(200, meta.to_dict())
            except StoreError as e:
                self._send_json(400, {"error": str(e)})

        def do_DELETE(self) -> None:  # noqa: N802
            try:
                existed = store.delete(self._key())
                self._send_json(200 if existed else 404, {"deleted": existed})
            except StoreError as e:
                self._send_json(400, {"error": str(e)})

    return ThreadingHTTPServer((host, port), _Handler)


class _ServedStore:
    """A LocalFSStore served over HTTP in-process, as one handle —
    convenience for tests and scripts: ``with _ServedStore(root) as url:``."""

    def __init__(self, root: str):
        self.local = LocalFSStore(root)
        self.server = serve_store(self.local)
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True, name="tier-store"
        )

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self) -> str:
        self._thread.start()
        return self.url

    def __exit__(self, *exc) -> None:
        self.server.shutdown()
        self.server.server_close()


def open_store(
    url: str,
    stats=None,
    retry: "rz.RetryPolicy | None" = None,
    breakers: "rz.BreakerRegistry | None" = None,
) -> ObjectStore | None:
    """A store location (``Server(tier_store=...)``) -> backend.  ``""`` -> None (tier off);
    ``http://…`` -> :class:`HTTPStore`; ``file://path`` or a bare path
    -> :class:`LocalFSStore`."""
    if not url:
        return None
    if url.startswith("http://") or url.startswith("https://"):
        if url.startswith("https://"):
            raise StoreError("https store urls are not supported yet")
        return HTTPStore(url, stats=stats, retry=retry, breakers=breakers)
    if url.startswith("file://"):
        url = url[len("file://"):]
    return LocalFSStore(url, stats=stats)
