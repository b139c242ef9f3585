"""The port's streaming primitives (``pilosa_tpu_torch.stream``) against
``pilosa_tpu.stream`` on the same seeded inputs: re-chunking, the
bounded pipe and its writer adapter (backpressure, producer failure,
early close), the chunked-coding encoder and both body readers (frames
of every size, extensions, trailers, drains past the budget), the
client's body stream and its retried opening.  Byte streams: the
comparison is exact."""

import http.client
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu import stream as jstream  # noqa: E402
from pilosa_tpu_torch import stream as tstream  # noqa: E402

PACKAGES = [jstream, tstream]


def random_chunks(seed: int, n: int, max_len: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, max_len + 1)), dtype=np.uint8).tobytes()
            for _ in range(n)]


def test_default_chunk_size_and_exports():
    assert tstream.DEFAULT_CHUNK_BYTES == jstream.DEFAULT_CHUNK_BYTES == 64 * 1024
    assert sorted(tstream.__all__) == sorted(jstream.__all__)
    assert tstream.CHUNK_TERMINATOR == jstream.CHUNK_TERMINATOR


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chunk_bytes", [1, 7, 64, 4096])
def test_rechunk_and_iterbody(seed, chunk_bytes):
    chunks = random_chunks(seed, 40, 300)
    want = list(jstream.rechunk(chunks, chunk_bytes))
    assert list(tstream.rechunk(chunks, chunk_bytes)) == want
    assert list(tstream.IterBody(chunks, chunk_bytes=chunk_bytes)) == want
    assert b"".join(want) == b"".join(chunks)
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            list(pkg.rechunk(chunks, 0))


def test_iterbody_close_reaches_the_source():
    closed = []

    def gen():
        try:
            yield b"abc"
            yield b"def"
        finally:
            closed.append(True)

    for pkg in PACKAGES:
        g = gen()
        body = pkg.IterBody(g, chunk_bytes=2)
        it = iter(body)
        assert next(it) == b"ab"
        body.close()
    assert closed == [True, True]


@pytest.mark.parametrize("n", [0, 1, 5, 11])
def test_batched(n):
    items = list(range(n))
    for size in (1, 3, 20):
        assert list(tstream.batched(items, size)) == list(jstream.batched(items, size))
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            list(pkg.batched(items, 0))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("capacity", [1, 2, 8])
def test_generate_from_writer(seed, capacity):
    chunks = random_chunks(seed, 60, 500)

    def write_fn(w):
        for c in chunks:
            w.write(c)

    outs = [list(pkg.generate_from_writer(write_fn, capacity=capacity, chunk_bytes=256))
            for pkg in PACKAGES]
    assert outs[1] == outs[0]
    assert b"".join(outs[1]) == b"".join(chunks)


def test_producer_failure_reraises_on_the_consumer():
    def write_fn(w):
        w.write(b"x" * 10)
        raise RuntimeError("producer broke")

    for pkg in PACKAGES:
        with pytest.raises(RuntimeError, match="producer broke"):
            list(pkg.generate_from_writer(write_fn, chunk_bytes=4))


def test_early_close_unblocks_the_producer():
    for pkg in PACKAGES:
        done = threading.Event()

        def write_fn(w, done=done):
            try:
                for _ in range(10_000):
                    w.write(b"y" * 64)
            finally:
                done.set()

        gen = pkg.generate_from_writer(write_fn, capacity=1, chunk_bytes=64)
        assert next(gen) == b"y" * 64
        gen.close()
        assert done.wait(5)


def test_pipe_abort_and_closed_writes():
    for pkg in PACKAGES:
        pipe = pkg.ChunkPipe(capacity=3, chunk_bytes=3)
        pipe.write(b"abcdefg")
        pipe.close()
        assert list(pipe) == [b"abc", b"def", b"g"]
        with pytest.raises(ValueError):
            pipe.write(b"z")
        pipe = pkg.ChunkPipe(capacity=2, chunk_bytes=3)
        pipe.abort(KeyError("gone"))
        with pytest.raises(pkg.PipeAbortedError):
            pipe.write(b"abc")
        with pytest.raises(KeyError):
            list(pipe)
        with pytest.raises(ValueError):
            pkg.ChunkPipe(capacity=0)


@pytest.mark.parametrize("seed", range(4))
def test_chunked_reader_decodes_encoded_bodies(seed):
    chunks = [c for c in random_chunks(seed, 30, 2000) if c]
    wire = b"".join(jstream.encode_chunk(c) for c in chunks) + jstream.CHUNK_TERMINATOR
    assert b"".join(tstream.encode_chunk(c) for c in chunks) + tstream.CHUNK_TERMINATOR == wire
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5000, 50).tolist()
    for pkg in PACKAGES:
        r = pkg.ChunkedBodyReader(io.BytesIO(wire))
        got = []
        for n in sizes:
            part = r.read(n)
            if not part:
                break
            got.append(part)
        got.append(r.read())
        assert b"".join(got) == b"".join(chunks)
        assert r.bytes_read == sum(len(c) for c in chunks)
        assert r.drain()


@pytest.mark.parametrize("wire", [
    b"3;ext=1\r\nabc\r\n0\r\nTrailer: x\r\n\r\n",
    b"5\r\nhello\r\n",           # the peer hung up before the last frame
    b"5\r\nhel",                 # and mid-frame
    b"zz\r\nabc\r\n",            # an invalid size
])
def test_chunked_reader_edges(wire):
    results = []
    for pkg in PACKAGES:
        r = pkg.ChunkedBodyReader(io.BytesIO(wire))
        try:
            results.append((r.read(), r.bytes_read))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[1] == results[0]


def test_length_reader_and_drain_budget():
    body = bytes(range(256)) * 10
    for pkg in PACKAGES:
        r = pkg.LengthBodyReader(io.BytesIO(body + b"next request"), len(body))
        assert r.read(100) == body[:100]
        assert r.read() == body[100:]
        assert r.read() == b""
        assert r.bytes_read == len(body)
        big = pkg.LengthBodyReader(io.BytesIO(b""), (1 << 20) + 1)
        assert big.drain() is False
        short = pkg.LengthBodyReader(io.BytesIO(b"abc"), 10)
        assert short.read() == b"abc" and short.read() == b""
        assert pkg.LengthBodyReader(io.BytesIO(b"x" * 50), 50).drain() is True
        chunked = pkg.ChunkedBodyReader(io.BytesIO(pkg.encode_chunk(b"z" * (1 << 20))
                                                   + pkg.encode_chunk(b"z" * 10)
                                                   + pkg.CHUNK_TERMINATOR))
        assert chunked.drain() is False


class _Body(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    payload = b"".join(random_chunks(7, 20, 5000))

    def do_GET(self):  # noqa: N802 — stdlib signature
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for i in range(0, len(self.payload), 3000):
            self.wfile.write(jstream.encode_chunk(self.payload[i:i + 3000]))
        self.wfile.write(jstream.CHUNK_TERMINATOR)

    def log_message(self, *args):
        pass


def test_http_body_stream_and_retried_open():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Body)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    host = f"127.0.0.1:{srv.server_address[1]}"
    try:
        outs = []
        for pkg in PACKAGES:
            attempts = []

            def open_fn(pkg=pkg, attempts=attempts):
                attempts.append(1)
                if len(attempts) < 3:
                    raise ConnectionRefusedError("not yet")
                conn = http.client.HTTPConnection(host, timeout=10)
                conn.request("GET", "/")
                return pkg.HTTPBodyStream(conn.getresponse(), conn, chunk_bytes=1024)

            with pkg.open_with_retry(open_fn, attempts=3, backoff=0.001) as s:
                chunks = list(s)
            assert len(attempts) == 3
            assert {len(c) for c in chunks[:-1]} == {1024}
            outs.append(b"".join(chunks))
            with pytest.raises(ConnectionRefusedError):
                pkg.open_with_retry(lambda: (_ for _ in ()).throw(ConnectionRefusedError("no")),
                                    attempts=2, backoff=0.001)
        assert outs[1] == outs[0] == _Body.payload
    finally:
        srv.shutdown()
        srv.server_close()
