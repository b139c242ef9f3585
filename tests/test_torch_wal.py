"""Recovery on open in the port against the JAX package: a JAX node's
write-ahead log (``<fragment>.wal``) replayed, stale and diverged
segments discarded, no op replayed twice, and an op-log torn by a crash
mid-append cut back to its last whole record — each data directory
opened by a JAX ``Server`` and a port ``Server(device="cpu")`` on
copies, the answers compared byte for byte.  Both servers run with their
WAL on (the default), so each keeps the segment it replayed, restarted
at its checkpoint snapshot; the segments they leave are compared too."""

import json
import os
import shutil
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
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


def jax_server(path: str, wal_on: bool = True) -> JServer:
    return JServer(data_dir=path, host="127.0.0.1:0", anti_entropy_interval=3600,
                   polling_interval=3600, cache_flush_interval=3600, ingest_wal=wal_on)


def seg_left(path: str):
    """The segment a node left beside the data file ``path``: it must
    hold no ops and be cut against the file's snapshot."""
    seg = wal.load_segment(path + ".wal")
    assert seg is not None and seg.n_ops == 0 and not seg.torn
    assert seg.snap_size == os.path.getsize(path)
    with open(path + ".wal", "rb") as fh:
        return fh.read()


def ask(server, queries) -> list:
    server.open()
    try:
        return [http(server.host, "POST", "/index/i/query", q) for q in queries]
    finally:
        server.close()


def both_answer(tmp_path, src: str, queries, wal_on: bool = True) -> tuple[list, list]:
    """The answers of a JAX node and of the port, each on its own copy
    of the data directory ``src``, both with their WAL on or both off."""
    jdir, tdir = str(tmp_path / "jcopy"), str(tmp_path / "tcopy")
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    return (ask(jax_server(jdir, wal_on), queries),
            ask(TServer(tdir, device="cpu", ingest_wal=wal_on), queries))


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
    # Replayed and snapshotted; the segment restarts at the snapshot, as
    # the JAX node's does.
    assert seg_left(str(tmp_path / "tcopy" / FRAG)) == seg_left(str(tmp_path / "jcopy" / FRAG))


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
    # Discarded: a fresh segment, as the JAX node starts.
    assert seg_left(str(tmp_path / "tcopy" / FRAG)) == seg_left(str(tmp_path / "jcopy" / FRAG))


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


def port_dir_with_three_ops(tmp_path, wal_on: bool) -> str:
    d = str(tmp_path / "port_ops")
    t = TServer(d, device="cpu", ingest_wal=wal_on)
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
    without a WAL both packages open the directory with the two whole
    records."""
    src = port_dir_with_three_ops(tmp_path, wal_on=False)
    assert not os.path.exists(os.path.join(src, FRAG + ".wal"))
    path = os.path.join(src, FRAG)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - cut)
    before = tfragment.counters()["oplogRepair"]
    jans, tans = both_answer(tmp_path, src, [COUNT1, b"Bitmap(frame=f, rowID=1)"],
                             wal_on=False)
    assert tans == jans
    assert tans[0] == (200, b'{"results": [2]}\n')
    # A cut inside a record is repaired (counted); a cut at a record's
    # boundary leaves a whole log.
    assert tfragment.counters()["oplogRepair"] == before + (cut % roaring.OP_SIZE != 0)
    assert os.path.getsize(str(tmp_path / "tcopy" / FRAG)) == 8 + 2 * roaring.OP_SIZE


@pytest.mark.parametrize("cut", [1, 3, 13])
def test_torn_op_log_tail_of_a_port_node_with_its_wal(tmp_path, cut):
    """With the WAL on, the three writes were acknowledged after their
    fsync: the op-log's tail is repaired, the third op comes back from
    the port's segment, and both packages answer all three bits."""
    src = port_dir_with_three_ops(tmp_path, wal_on=True)
    seg = wal.load_segment(os.path.join(src, FRAG + ".wal"))
    assert (seg.n_ops, seg.snap_size) == (3, 8)
    path = os.path.join(src, FRAG)
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - cut)
    before = tfragment.counters()["walReplayedOps"]
    jans, tans = both_answer(tmp_path, src, [COUNT1, b"Bitmap(frame=f, rowID=1)"])
    assert tans == jans
    assert tans[0] == (200, b'{"results": [3]}\n')
    # A cut inside the last record leaves its op to the WAL; a cut at a
    # record's boundary (13) leaves it there too.
    assert tfragment.counters()["walReplayedOps"] == before + 1
    assert seg_left(str(tmp_path / "tcopy" / FRAG)) == seg_left(str(tmp_path / "jcopy" / FRAG))


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


# --- the port's own WAL: group commit, the ack after the fsync, the files ---


def _ingest(host) -> dict:
    status, body = http(host, "GET", "/debug/ingest")
    assert status == 200
    return json.loads(body)["wal"]


def _schema(host):
    for path in ("/index/i", "/index/i/frame/f"):
        assert http(host, "POST", path)[0] == 200


def test_group_commit_takes_fewer_fsyncs_than_appends(tmp_path):
    """8 threads writing one fragment: each group commit fsyncs the
    writes of its window once, so fsyncs < appends, and every write is
    acknowledged and present."""
    t = TServer(str(tmp_path / "d"), device="cpu")
    t.open()
    try:
        _schema(t.host)
        cols = [[w * 1000 + k for k in range(40)] for w in range(8)]

        def writer(w):
            for c in cols[w]:
                assert http(t.host, "POST", "/index/i/query",
                            f"SetBit(frame=f, rowID=1, columnID={c})".encode())[0] == 200

        threads = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        doc = _ingest(t.host)
        assert doc["walEnabled"] and doc["totalAppends"] == 320
        assert 0 < doc["totalFsyncs"] < doc["totalAppends"]
        assert http(t.host, "POST", "/index/i/query", COUNT1) == (200, b'{"results": [320]}\n')
    finally:
        t.close()


def test_no_acknowledgement_before_the_fsync(tmp_path, monkeypatch):
    """The committer's fsync is held back: the SetBit does not answer
    until it is let through."""
    gate = threading.Event()
    real_fsync = os.fsync

    def held_fsync(fd):
        if threading.current_thread().name == "ingest-committer":
            assert gate.wait(30)
        return real_fsync(fd)

    t = TServer(str(tmp_path / "d"), device="cpu")
    t.open()
    try:
        _schema(t.host)
        monkeypatch.setattr(os, "fsync", held_fsync)
        answer = []
        th = threading.Thread(target=lambda: answer.append(http(
            t.host, "POST", "/index/i/query", b"SetBit(frame=f, rowID=1, columnID=7)")))
        th.start()
        th.join(0.5)
        assert th.is_alive() and not answer, "acknowledged before its WAL fsync"
        assert _ingest(t.host)["totalFsyncs"] == 0
        gate.set()
        th.join(30)
        assert not th.is_alive()
        assert answer == [(200, b'{"results": [true]}\n')]
        assert _ingest(t.host)["totalFsyncs"] == 1
    finally:
        gate.set()
        t.close()


def test_port_dir_copied_while_open_opens_in_both(tmp_path):
    """A port node takes writes from 4 threads (sets and clears over 3
    slices) and its directory is copied while it is open: the op-log
    lags, the acknowledged bits are in the WAL, and a JAX node and a
    port node each answer every one of them."""
    live = str(tmp_path / "live")
    t = TServer(live, device="cpu")
    t.open()
    want: dict[int, set] = {1: set(), 2: set()}
    try:
        _schema(t.host)
        rng = np.random.default_rng(11)
        plan = [(int(r), int(c)) for r, c in zip(rng.integers(1, 3, 400),
                                                 rng.integers(0, 3 * SW, 400))]

        def writer(k):
            for r, c in plan[k::4]:
                assert http(t.host, "POST", "/index/i/query",
                            f"SetBit(frame=f, rowID={r}, columnID={c})".encode())[0] == 200

        threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        for r, c in plan:
            want[r].add(c)
        for r, c in plan[:20]:  # clears, serially
            assert http(t.host, "POST", "/index/i/query",
                        f"ClearBit(frame=f, rowID={r}, columnID={c})".encode())[0] == 200
            want[r].discard(c)
        for s in range(3):
            path = os.path.join(live, FRAG[:-1] + str(s))
            assert os.path.getsize(path) == 8, "the op-log is buffered while the WAL is on"
        copy = str(tmp_path / "copied")
        shutil.copytree(live, copy)
    finally:
        t.close()
    queries = [f"Bitmap(frame=f, rowID={r})".encode() for r in (1, 2)]
    jans, tans = both_answer(tmp_path, copy, queries)
    assert tans == jans
    for (status, body), r in zip(tans, (1, 2)):
        assert status == 200 and json.loads(body)["results"][0]["bits"] == sorted(want[r])


def _files(d: str) -> dict:
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            if n.isdigit() or n.endswith(".wal"):
                p = os.path.join(root, n)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, d)] = fh.read()
    return out


def test_serial_writes_leave_files_byte_equal_to_jax(tmp_path):
    """The same serial sets and clears over two slices leave the same
    fragment files and WAL segments in both packages, while the nodes
    are open and after they close."""
    writes = [f"SetBit(frame=f, rowID={r}, columnID={c})" for r, c in
              ((1, 3), (1, 4), (2, SW + 9), (1, 3), (3, 70000), (2, 5))]
    writes += ["ClearBit(frame=f, rowID=1, columnID=4)", "ClearBit(frame=f, rowID=9, columnID=4)",
               f"SetBit(frame=f, rowID=1, columnID={SW + 4})"]
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    nodes = {"jax": jax_server(dirs["jax"]), "port": TServer(dirs["port"], device="cpu")}
    answers, open_files = {}, {}
    for name, node in nodes.items():
        node.open()
        try:
            _schema(node.host)
            answers[name] = [http(node.host, "POST", "/index/i/query", q.encode())
                             for q in writes]
            open_files[name] = _files(dirs[name])
        finally:
            node.close()
    assert answers["port"] == answers["jax"]
    assert open_files["port"] == open_files["jax"]
    assert len(open_files["port"]) == 4  # two fragments, two segments
    assert _files(dirs["port"]) == _files(dirs["jax"])


def test_snapshot_truncates_and_size_rolls_over(tmp_path):
    """A snapshot restarts the segment at its new base version; a
    segment past ``ingest_wal_segment_bytes`` rolls over into a snapshot
    from the committer; the bits survive a reopen in both packages."""
    d = str(tmp_path / "d")
    t = TServer(d, device="cpu", ingest_wal_segment_bytes=wal.HEADER_SIZE + 3 * 77)
    t.open()
    try:
        _schema(t.host)
        for c in range(2):
            assert http(t.host, "POST", "/index/i/query",
                        f"SetBit(frame=f, rowID=1, columnID={c})".encode())[0] == 200
        frag = t.holder.fragment("i", "f", "standard", 0)
        seg = wal.load_segment(frag.path + ".wal")
        assert (seg.base_op_version, seg.n_ops) == (0, 2)
        frag.snapshot()
        seg = wal.load_segment(frag.path + ".wal")
        assert (seg.base_op_version, seg.n_ops, seg.snap_size) == (
            2, 0, os.path.getsize(frag.path))
        for c in range(2, 12):  # four frames pass the 3-frame limit
            assert http(t.host, "POST", "/index/i/query",
                        f"SetBit(frame=f, rowID=1, columnID={c})".encode())[0] == 200
        deadline = time.monotonic() + 10
        while wal.load_segment(frag.path + ".wal").base_op_version == 2:
            assert time.monotonic() < deadline, "no rollover"
            time.sleep(0.01)
        assert os.path.getsize(frag.path + ".wal") <= wal.HEADER_SIZE + 3 * 77
    finally:
        t.close()
    jans, tans = both_answer(tmp_path, d, [COUNT1])
    assert tans == jans == [(200, b'{"results": [12]}\n')]


def test_wal_off_writes_each_op_to_the_file(tmp_path):
    """``ingest_wal=False``: no segment, each op in the data file as it is
    written (the port's behaviour without a WAL), /debug/ingest says so."""
    d = str(tmp_path / "d")
    t = TServer(d, device="cpu", ingest_wal=False)
    t.open()
    try:
        _schema(t.host)
        for c in (3, 4):
            assert http(t.host, "POST", "/index/i/query",
                        f"SetBit(frame=f, rowID=1, columnID={c})".encode())[0] == 200
        path = os.path.join(d, FRAG)
        assert os.path.getsize(path) == 8 + 2 * roaring.OP_SIZE
        assert not os.path.exists(path + ".wal")
        assert _ingest(t.host) == {"walEnabled": False, "note": "ingest WAL not configured"}
    finally:
        t.close()
    assert not os.path.exists(os.path.join(d, FRAG + ".wal"))
