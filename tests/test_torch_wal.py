"""Recovery on open in the port against the JAX package: a JAX node's
write-ahead log (``<fragment>.wal``) replayed, stale and diverged
segments discarded, no op replayed twice, and an op-log torn by a crash
mid-append cut back to its last whole record — each data directory
opened by a JAX ``Server`` and a port ``Server(device="cpu")`` on
copies, the answers compared byte for byte."""

import os
import shutil
import struct
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu.core.fragment import Fragment as JFragment  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.core import fragment as tfragment  # noqa: E402
from pilosa_tpu_torch.ingest import wal  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.ops import roaring  # noqa: E402

SW = 1 << 20
FRAG = os.path.join("i", "f", "views", "standard", "fragments", "0")
COUNT1 = b"Count(Bitmap(frame=f, rowID=1))"


def http(host: str, method: str, path: str, body: bytes = b""):
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def jax_server(path: str) -> JServer:
    return JServer(data_dir=path, host="127.0.0.1:0", anti_entropy_interval=3600,
                   polling_interval=3600, cache_flush_interval=3600)


def ask(server, queries) -> list:
    server.open()
    try:
        return [http(server.host, "POST", "/index/i/query", q) for q in queries]
    finally:
        server.close()


def both_answer(tmp_path, src: str, queries) -> tuple[list, list]:
    """The answers of a JAX node and of the port, each on its own copy
    of the data directory ``src``."""
    jdir, tdir = str(tmp_path / "jcopy"), str(tmp_path / "tcopy")
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    return ask(jax_server(jdir), queries), ask(TServer(tdir, device="cpu"), queries)


def jax_node_dir(tmp_path, writes, bulk_cols=()) -> str:
    """A JAX node's data directory copied while the node is open (what a
    kill -9 leaves): row 1 of frame f imported at ``bulk_cols`` and the
    fragment snapshotted, then ``writes`` acknowledged one request
    each."""
    live = str(tmp_path / "live")
    j = jax_server(live)
    j.open()
    try:
        for path in ("/index/i", "/index/i/frame/f"):
            assert http(j.host, "POST", path)[0] == 200
        if len(bulk_cols):
            j.holder.frame("i", "f").import_bulk([1] * len(bulk_cols), list(bulk_cols))
            j.holder.fragment("i", "f", "standard", 0).snapshot()
        for q in writes:
            assert http(j.host, "POST", "/index/i/query", q) == (200, b'{"results": [true]}\n')
        copy = str(tmp_path / "copied")
        shutil.copytree(live, copy)
    finally:
        j.close()
    return copy


def test_wal_of_a_jax_node_copied_while_open(tmp_path):
    """ROADMAP fault 1: the bit lives only in the WAL (the fragment file
    is its 8-byte header); both packages answer 1."""
    src = jax_node_dir(tmp_path, [b"SetBit(frame=f, rowID=1, columnID=7)"])
    assert os.path.getsize(os.path.join(src, FRAG)) == 8
    assert wal.load_segment(os.path.join(src, FRAG + ".wal")).n_ops == 1
    before = tfragment.counters()["walReplayedOps"]
    jans, tans = both_answer(tmp_path, src, [COUNT1])
    assert tans == jans == [(200, b'{"results": [1]}\n')]
    assert tfragment.counters()["walReplayedOps"] == before + 1
    # Replayed, snapshotted, and the segment removed.
    assert not os.path.exists(str(tmp_path / "tcopy" / FRAG) + ".wal")


def test_wal_with_a_torn_last_frame(tmp_path):
    writes = [f"SetBit(frame=f, rowID=1, columnID={c})".encode() for c in (7, 8, 9)]
    src = jax_node_dir(tmp_path, writes)
    path = os.path.join(src, FRAG + ".wal")
    assert len(wal.load_segment(path).frames) == 3
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 5)  # cut into the last frame's digest
    seg = wal.load_segment(path)
    assert seg.torn and len(seg.frames) == 2
    jans, tans = both_answer(tmp_path, src, [COUNT1, b"Bitmap(frame=f, rowID=1)"])
    assert tans == jans
    assert jans[0] == (200, b'{"results": [2]}\n')


def _rewrite_header(path: str, snap_size: int) -> None:
    with open(path, "r+b") as fh:
        _, _, base, _ = struct.unpack("<4sIQQ", fh.read(wal.HEADER_SIZE))
        fh.seek(0)
        fh.write(wal.encode_header(base, snap_size))


def test_stale_wal_segment_is_discarded(tmp_path):
    src = jax_node_dir(tmp_path, [b"SetBit(frame=f, rowID=1, columnID=7)"])
    _rewrite_header(os.path.join(src, FRAG + ".wal"), 9)  # another snapshot's size
    jans, tans = both_answer(tmp_path, src, [COUNT1])
    assert tans == jans == [(200, b'{"results": [0]}\n')]
    assert not os.path.exists(str(tmp_path / "tcopy" / FRAG) + ".wal")


def test_diverged_wal_segment_is_discarded(tmp_path):
    """The data op-log holds an op the WAL does not: the histories cannot
    be ordered, and the segment is forfeited; the op-log's op stays."""
    src = jax_node_dir(tmp_path, [b"SetBit(frame=f, rowID=1, columnID=7)"])
    with open(os.path.join(src, FRAG), "ab") as fh:
        fh.write(roaring.encode_op(roaring.OP_ADD, 2 * SW + 9))
    queries = [COUNT1, b"Count(Bitmap(frame=f, rowID=2))"]
    jans, tans = both_answer(tmp_path, src, queries)
    assert tans == jans == [(200, b'{"results": [0]}\n'), (200, b'{"results": [1]}\n')]


def test_wal_is_never_replayed_twice(tmp_path):
    """A JAX node writes into a bitmap container (the snapshot's size
    does not move with its bits), the port opens and replays, clears the
    replayed bit and snapshots — the op count back to 0 and the data
    file's size that of the segment's snapshot — then the directory is
    reopened in both packages: the cleared bit stays cleared."""
    src = jax_node_dir(tmp_path, [b"SetBit(frame=f, rowID=1, columnID=7)"],
                       bulk_cols=range(100, 5100))
    seg = wal.load_segment(os.path.join(src, FRAG + ".wal"))
    assert seg.n_ops == 1
    tdir = str(tmp_path / "port")
    shutil.copytree(src, tdir)
    before = tfragment.counters()["walReplayedOps"]
    t = TServer(tdir, device="cpu")
    t.open()
    try:
        assert http(t.host, "POST", "/index/i/query", COUNT1) == (200, b'{"results": [5001]}\n')
        assert http(t.host, "POST", "/index/i/query",
                    b"ClearBit(frame=f, rowID=1, columnID=7)")[1] == b'{"results": [true]}\n'
        frag = t.holder.fragment("i", "f", "standard", 0)
        frag.snapshot()
        assert frag._op_n == 0
        assert wal._data_state(frag)[0] == seg.snap_size  # the hazard's shape
    finally:
        t.close()
    want = [(200, b'{"results": [5000]}\n')]
    assert ask(TServer(tdir, device="cpu"), [COUNT1]) == want
    jdir = str(tmp_path / "jax_after_port")
    shutil.copytree(tdir, jdir)
    assert ask(jax_server(jdir), [COUNT1]) == want
    assert tfragment.counters()["walReplayedOps"] == before + 1


def port_dir_with_three_ops(tmp_path) -> str:
    d = str(tmp_path / "port_ops")
    t = TServer(d, device="cpu")
    t.open()
    try:
        for path in ("/index/i", "/index/i/frame/f"):
            assert http(t.host, "POST", path)[0] == 200
        for c in (3, 4, 5):
            assert http(t.host, "POST", "/index/i/query",
                        f"SetBit(frame=f, rowID=1, columnID={c})".encode())[0] == 200
    finally:
        t.close()
    assert os.path.getsize(os.path.join(d, FRAG)) == 8 + 3 * roaring.OP_SIZE
    return d


@pytest.mark.parametrize("cut", [1, 3, 13])
def test_torn_op_log_tail_is_repaired(tmp_path, cut):
    """ROADMAP fault 2: a crash mid-append leaves a partial last record;
    both packages open the directory with the two whole records."""
    src = port_dir_with_three_ops(tmp_path)
    path = os.path.join(src, FRAG)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - cut)
    before = tfragment.counters()["oplogRepair"]
    jans, tans = both_answer(tmp_path, src, [COUNT1, b"Bitmap(frame=f, rowID=1)"])
    assert tans == jans
    assert tans[0] == (200, b'{"results": [2]}\n')
    # A cut inside a record is repaired (counted); a cut at a record's
    # boundary leaves a whole log.
    assert tfragment.counters()["oplogRepair"] == before + (cut % roaring.OP_SIZE != 0)
    assert os.path.getsize(str(tmp_path / "tcopy" / FRAG)) == 8 + 2 * roaring.OP_SIZE


def _ops_file(n_ops: int) -> bytes:
    return roaring.encode({}) + b"".join(
        roaring.encode_op(roaring.OP_ADD, SW + i) for i in range(n_ops))


@pytest.mark.parametrize("where", ["before_window", "valid_after_damage"])
def test_damage_outside_the_tail_window_still_raises(tmp_path, where):
    """Damage that is not a torn tail refuses to open in both packages,
    and the file's bytes stay as they were: a bad record before the last
    flush window (with a torn tail after it: the prefix must decode
    before anything is cut), and a bad record followed by valid ones."""
    n = roaring.MAX_TORN_TAIL // roaring.OP_SIZE + 20 if where == "before_window" else 8
    data = bytearray(_ops_file(n))
    data[8 + 2 * roaring.OP_SIZE + 3] ^= 0x40  # the third record's checksum fails
    data = bytes(data[:-3]) if where == "before_window" else bytes(data)
    for k, cls in enumerate((JFragment, tfragment.Fragment)):
        path = str(tmp_path / f"{k}" / "0")
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as fh:
            fh.write(data)
        kw = {"device": "cpu"} if cls is tfragment.Fragment else {}
        with pytest.raises(roaring.CorruptError if k else Exception, match="checksum"):
            cls(path, "i", "f", "standard", 0, **kw).open()
        with open(path, "rb") as fh:
            assert fh.read() == data
