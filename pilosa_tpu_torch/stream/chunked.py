"""HTTP/1.1 chunked transfer-coding framing (RFC 7230 §4.1).

The encoder side frames iterator response bodies; the reader side gives
handlers a file object that decodes an incoming chunked request body
incrementally, so a streamed restore never materializes the archive.
``LengthBodyReader`` is the Content-Length twin — same interface, so
handler code is agnostic to how the client framed the body.
"""

from __future__ import annotations

CHUNK_TERMINATOR = b"0\r\n\r\n"

# drain() gives up past this many unread body bytes and tells the
# caller to drop the connection instead: reading a huge abandoned body
# just to keep one keep-alive socket is a bad trade.
_DRAIN_LIMIT = 1 << 20


def encode_chunk(data: bytes) -> bytes:
    """One chunked-coding frame: hex length, CRLF, payload, CRLF."""
    return b"%x\r\n%s\r\n" % (len(data), data)


class LengthBodyReader:
    """File-like over exactly ``length`` bytes of ``fp`` — the
    Content-Length body framing."""

    def __init__(self, fp, length: int):
        self._fp = fp
        self._remaining = max(0, int(length))
        # Total body bytes consumed — the adapter's stream.bytesReceived
        # counter reads this after the request completes.
        self.bytes_read = 0

    def read(self, n: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        want = self._remaining if n is None or n < 0 else min(n, self._remaining)
        data = self._fp.read(want)
        self._remaining -= len(data)
        self.bytes_read += len(data)
        if not data:
            self._remaining = 0  # peer hung up early
        return data

    def drain(self) -> bool:
        """Consume the unread remainder so the connection can be
        reused; False when past the drain budget (caller should close
        the connection instead)."""
        if self._remaining > _DRAIN_LIMIT:
            return False
        while self._remaining > 0:
            if not self.read(min(self._remaining, 64 * 1024)):
                break
        return True


class ChunkedBodyReader:
    """File-like over a chunked-coded body on ``fp``, decoding frames
    incrementally (never more than one frame buffered)."""

    def __init__(self, fp):
        self._fp = fp
        self._chunk_left = 0  # unread bytes of the current frame
        self._done = False
        # Decoded body bytes consumed (frame payloads only, not the
        # chunked framing) — see LengthBodyReader.bytes_read.
        self.bytes_read = 0

    def _next_frame(self) -> None:
        line = self._fp.readline(1024)
        if not line:
            self._done = True
            return
        # Tolerate the CRLF that terminates the previous frame's data.
        if line in (b"\r\n", b"\n"):
            line = self._fp.readline(1024)
        size_s = line.split(b";", 1)[0].strip()  # ignore chunk extensions
        try:
            size = int(size_s, 16)
        except ValueError:
            raise ValueError(f"invalid chunk size: {size_s[:32]!r}") from None
        if size == 0:
            # Trailer section: read through the blank line.
            while True:
                t = self._fp.readline(1024)
                if t in (b"\r\n", b"\n", b""):
                    break
            self._done = True
        else:
            self._chunk_left = size

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = []
            while True:
                part = self.read(64 * 1024)
                if not part:
                    break
                parts.append(part)
            return b"".join(parts)
        out = b""
        while len(out) < n and not self._done:
            if self._chunk_left == 0:
                self._next_frame()
                continue
            want = min(n - len(out), self._chunk_left)
            data = self._fp.read(want)
            if not data:
                self._done = True  # peer hung up mid-frame
                break
            self._chunk_left -= len(data)
            self.bytes_read += len(data)
            out += data
        return out

    def drain(self) -> bool:
        """Read through the terminal frame; False past the budget."""
        seen = 0
        while not self._done:
            seen += len(self.read(64 * 1024))
            if seen > _DRAIN_LIMIT:
                return False
        return True
