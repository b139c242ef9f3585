"""IterBody — iterator response bodies with constant-size chunks.

Producers batch however suits them (csv_chunks yields per row-block,
tar writers per archive entry); the transport wants bounded writes.
IterBody sits between: any iterable of bytes in, fixed-size chunks out,
with ``close()`` teardown reaching the underlying generator so an
abandoned response (client disconnect) releases producer resources.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator


def rechunk(chunks: Iterable[bytes], chunk_bytes: int) -> Iterator[bytes]:
    """Re-slice a byte-chunk stream into chunks of exactly
    ``chunk_bytes`` (except the final tail), buffering at most one
    output chunk plus one input chunk."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    pend: list[bytes] = []
    pend_n = 0
    for data in chunks:
        pend.append(data)
        pend_n += len(data)
        while pend_n >= chunk_bytes:
            buf = b"".join(pend)
            out, rest = buf[:chunk_bytes], buf[chunk_bytes:]
            pend = [rest] if rest else []
            pend_n = len(rest)
            yield out
    if pend_n:
        yield b"".join(pend)


class IterBody:
    """A response body produced incrementally.

    Wraps an iterable of byte chunks; iterating yields constant
    ``chunk_bytes``-sized chunks regardless of producer batching.  The
    HTTP adapter streams these with chunked transfer encoding instead
    of materializing one blob (net/handler.py make_http_server).
    """

    def __init__(self, chunks: Iterable[bytes], chunk_bytes: int = 0):
        from pilosa_tpu_torch import stream

        self._source = chunks
        self.chunk_bytes = chunk_bytes or stream.DEFAULT_CHUNK_BYTES

    def __iter__(self) -> Iterator[bytes]:
        return rechunk(self._source, self.chunk_bytes)

    def close(self) -> None:
        close = getattr(self._source, "close", None)
        if close is not None:
            close()
