"""Streaming data plane — chunked producer/consumer primitives (a copy
of ``pilosa_tpu/stream``, which the port may not import).

The reference moves every large HTTP body incrementally: the CSV export
handler writes rows straight to the ResponseWriter (reference:
handler.go:1049-1098), backup/restore copy fragment archives through
io.Reader/io.Writer pairs (reference: client.go:478-702), and the
importer never materializes a file.  This package gives the Python side
the same shape, so a 1B-column fragment export/backup moves as
constant-size chunks end to end instead of one process-killing blob:

* :class:`ChunkPipe` (pipe.py) — a bounded byte-chunk queue with
  producer backpressure; adapts writer-style producers (``fn(w)``) to
  pull-style chunk iterators via :func:`generate_from_writer`.
* :class:`IterBody` (body.py) — response-body wrapper around any
  iterable of bytes, re-chunked to a constant chunk size so socket
  writes stay bounded no matter how the producer batches.
* chunked.py — HTTP/1.1 chunked transfer-coding framing: the encoder
  used by the server adapter for iterator response bodies, and
  file-like readers that decode chunked (or Content-Length-bounded)
  request bodies incrementally.
* client.py — the consuming side: a retry/backoff-aware stream opener
  for idempotent GETs plus :class:`HTTPBodyStream`, a closeable
  constant-size chunk iterator over an ``http.client`` response.

Everything here is transport-plumbing only: no holder/fragment imports,
so net, cli, sync, and core can all ride it without cycles.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator
from typing import TypeVar

# One knob for every streaming path: response re-chunking, pipe chunk
# assembly, and client-side reads all default to this size.  Configured
# per server via [net] stream-chunk-bytes.
DEFAULT_CHUNK_BYTES = 64 * 1024

from pilosa_tpu_torch.stream.pipe import (  # noqa: E402
    ChunkPipe,
    PipeAbortedError,
    generate_from_writer,
)
from pilosa_tpu_torch.stream.body import IterBody, rechunk  # noqa: E402
from pilosa_tpu_torch.stream.chunked import (  # noqa: E402
    CHUNK_TERMINATOR,
    ChunkedBodyReader,
    LengthBodyReader,
    encode_chunk,
)
from pilosa_tpu_torch.stream.client import HTTPBodyStream, open_with_retry  # noqa: E402

_T = TypeVar("_T")


def batched(items: Iterable[_T], n: int) -> Iterator[list[_T]]:
    """Yield ``items`` in lists of at most ``n`` — the bounded-batch
    analog of rechunk() for non-byte streams (e.g. the syncer's repair
    pushes, which must stay under max-writes-per-request)."""
    if n <= 0:
        raise ValueError("batch size must be positive")
    buf: list[_T] = []
    for item in items:
        buf.append(item)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf


__all__ = [
    "DEFAULT_CHUNK_BYTES",
    "CHUNK_TERMINATOR",
    "ChunkPipe",
    "ChunkedBodyReader",
    "HTTPBodyStream",
    "IterBody",
    "LengthBodyReader",
    "PipeAbortedError",
    "batched",
    "encode_chunk",
    "generate_from_writer",
    "open_with_retry",
    "rechunk",
]
