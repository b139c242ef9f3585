"""Consumer-side streaming: retrying stream opener + chunk iterator.

``http.client`` responses already decode chunked transfer-coding, so
the consuming side only needs (a) a closeable constant-size chunk
iterator that owns the connection, and (b) retry/backoff around
OPENING a stream — the window where retrying an idempotent GET is
always safe.  Mid-stream failures surface to the caller: without range
requests a half-consumed body cannot be resumed transparently.
"""

from __future__ import annotations

import http.client
import time
from collections.abc import Callable, Iterator

# Transient transport failures worth a fresh dial; HTTP-status errors
# (our ClientError) are NOT retried — the server answered.
RETRYABLE = (OSError, http.client.HTTPException)


def open_with_retry(
    open_fn: Callable,
    attempts: int = 3,
    backoff: float = 0.1,
    logger=None,
):
    """Call ``open_fn()`` until it returns, retrying RETRYABLE failures
    with exponential backoff (``backoff``, 2x per attempt).  The last
    failure propagates."""
    delay = backoff
    for attempt in range(attempts):
        try:
            return open_fn()
        except RETRYABLE as e:
            if attempt == attempts - 1:
                raise
            if logger is not None:
                logger(f"stream open failed (attempt {attempt + 1}): {e}")
            time.sleep(delay)
            delay *= 2


class HTTPBodyStream:
    """A response body being consumed incrementally.

    Owns the connection: close() (or exhausting the iterator, or the
    ``with`` block) releases it.  ``read``/``__iter__`` move constant
    ``chunk_bytes`` chunks, whatever the server's frame sizes were.
    """

    def __init__(self, resp, conn, chunk_bytes: int = 0):
        from pilosa_tpu_torch import stream

        self._resp = resp
        self._conn = conn
        self.chunk_bytes = chunk_bytes or stream.DEFAULT_CHUNK_BYTES
        self.status = resp.status
        self.headers = resp.headers

    def read(self, n: int = -1) -> bytes:
        return self._resp.read(n if n is not None and n >= 0 else None)

    def __iter__(self) -> Iterator[bytes]:
        try:
            while True:
                chunk = self._resp.read(self.chunk_bytes)
                if not chunk:
                    return
                yield chunk
        finally:
            self.close()

    def close(self) -> None:
        try:
            self._resp.close()
        finally:
            self._conn.close()

    def __enter__(self) -> "HTTPBodyStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
