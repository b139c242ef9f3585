"""ChunkPipe — bounded byte-chunk queue with producer backpressure.

The bridge between writer-style producers (``tarfile`` wants a file
object; ``Fragment.write_to`` takes ``w``) and the pull-style chunk
iterators the HTTP layer streams from.  The queue is bounded, so a
producer running ahead of a slow consumer blocks instead of buffering
the whole body — the in-process analog of the reference handing an
io.PipeWriter to the tar writer while the ResponseWriter drains the
read end (reference: client.go:478-560).
"""

from __future__ import annotations

import threading
from collections import deque
from collections.abc import Callable, Iterator


class PipeAbortedError(RuntimeError):
    """The consumer went away (or the producer failed) mid-stream."""


class ChunkPipe:
    """Bounded queue of byte chunks: file-like on the write side,
    iterator on the read side.

    * ``write`` assembles input into ``chunk_bytes``-sized chunks and
      blocks while ``capacity`` chunks are already queued
      (backpressure); ``close`` flushes the partial tail chunk and
      marks EOF.
    * Iterating yields chunks until EOF; ``abort`` from either side
      unblocks both (the writer raises :class:`PipeAbortedError`, the
      reader raises the given exception — or stops, when aborted
      without one).
    """

    def __init__(self, capacity: int = 8, chunk_bytes: int = 0):
        from pilosa_tpu_torch import stream

        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.chunk_bytes = chunk_bytes or stream.DEFAULT_CHUNK_BYTES
        self.capacity = capacity
        self._chunks: deque[bytes] = deque()
        self._pend: list[bytes] = []  # partial tail, < chunk_bytes total
        self._pend_n = 0
        self._eof = False
        self._exc: BaseException | None = None
        self._aborted = False
        self._cond = threading.Condition()

    # -- writer side (file-like) ---------------------------------------

    def write(self, data) -> int:
        data = bytes(data)
        with self._cond:
            if self._aborted:
                raise PipeAbortedError("pipe aborted")
            if self._eof:
                raise ValueError("write to closed pipe")
            self._pend.append(data)
            self._pend_n += len(data)
            while self._pend_n >= self.chunk_bytes:
                buf = b"".join(self._pend)
                chunk, rest = buf[: self.chunk_bytes], buf[self.chunk_bytes :]
                self._pend = [rest] if rest else []
                self._pend_n = len(rest)
                self._put_locked(chunk)
                if self._aborted:
                    raise PipeAbortedError("pipe aborted")
        return len(data)

    def _put_locked(self, chunk: bytes) -> None:
        while len(self._chunks) >= self.capacity and not self._aborted:
            self._cond.wait()
        if self._aborted:
            return
        self._chunks.append(chunk)
        self._cond.notify_all()

    def flush(self) -> None:  # file-object protocol
        pass

    def close(self) -> None:
        """Producer EOF: flush the partial tail and wake the consumer."""
        with self._cond:
            if self._eof or self._aborted:
                return
            if self._pend_n:
                self._put_locked(b"".join(self._pend))
                self._pend, self._pend_n = [], 0
            self._eof = True
            self._cond.notify_all()

    def abort(self, exc: BaseException | None = None) -> None:
        """Tear the pipe down from either side: pending chunks drop, the
        blocked peer wakes, and (when ``exc`` is given) the consumer
        re-raises it."""
        with self._cond:
            if self._exc is None:
                self._exc = exc
            self._aborted = True
            self._eof = True
            self._chunks.clear()
            self._pend, self._pend_n = [], 0
            self._cond.notify_all()

    # -- reader side ---------------------------------------------------

    def __iter__(self) -> Iterator[bytes]:
        while True:
            with self._cond:
                while not self._chunks and not self._eof:
                    self._cond.wait()
                if self._chunks:
                    chunk = self._chunks.popleft()
                    self._cond.notify_all()
                else:  # EOF (or abort) with nothing queued
                    if self._exc is not None:
                        raise self._exc
                    return
            yield chunk


def generate_from_writer(
    write_fn: Callable, capacity: int = 8, chunk_bytes: int = 0
) -> Iterator[bytes]:
    """Run ``write_fn(pipe)`` on a producer thread and yield its output
    as bounded chunks.

    The producer sees an ordinary writable file object; the caller gets
    a generator.  Closing the generator early (consumer gone) aborts
    the pipe so the producer thread unblocks and exits instead of
    leaking; a producer exception re-raises on the consumer side at the
    point of failure.
    """
    pipe = ChunkPipe(capacity=capacity, chunk_bytes=chunk_bytes)

    def _produce() -> None:
        try:
            write_fn(pipe)
        except PipeAbortedError:
            pass  # consumer went away first; nothing to report
        except BaseException as e:  # noqa: BLE001 — crosses the pipe
            pipe.abort(e)
        else:
            pipe.close()

    t = threading.Thread(target=_produce, daemon=True, name="chunk-pipe")
    t.start()
    try:
        yield from pipe
        t.join(timeout=5.0)
    finally:
        pipe.abort()
        t.join(timeout=1.0)
