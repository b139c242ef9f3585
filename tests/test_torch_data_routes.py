"""The data plane of backup, restore, export and block sync, end to end:
a JAX ``pilosa_tpu`` Server and a port ``Server(device="cpu")`` hold the
same seeded data and answer every new route — ``PATCH .../time-quantum``,
``GET .../views``, ``POST .../attr/diff``, ``POST .../restore``,
``GET /export``, ``GET``/``POST /fragment/data``, ``GET /fragment/blocks``,
``GET /fragment/block/data``, ``POST /fragment/import-view`` and
``GET /state`` — with equal statuses and bodies, asked with a JSON and a
protobuf ``Accept``, error cases included.  Host names may differ; tar
members are compared by payload (their mtimes differ).  Then: a frame
pulled from a node of the other package, whole-view backups restored
across packages, the next query after a restore, an import-view, a block
merge or a time-quantum change with a resident mirror, queued deltas and
a cached batch entry in place, a restore that survives a reopen, and the
``pilosa_stream_`` family on ``/metrics``."""

import base64
import http.client
import io
import json
import re
import tarfile

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.core.fragment import PairSet as JPairSet  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.client import InternalClient as JClient  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu.obs import stats as jstats  # noqa: E402
from pilosa_tpu_torch.core.fragment import PairSet as TPairSet  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient as TClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.obs import stats as tstats  # noqa: E402

SW = 1 << 20
N_SLICES = 3
JSON_ACCEPT = {"Accept": "application/json"}
PROTO = {"Content-Type": "application/x-protobuf", "Accept": "application/x-protobuf"}


def request(host: str, method: str, path: str, body: bytes = b"", headers=None):
    conn = http.client.HTTPConnection(host, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def jax_server(path: str, **kw) -> JServer:
    return JServer(data_dir=path, host="127.0.0.1:0", admission=False, anti_entropy_interval=3600,
                   polling_interval=3600, cache_flush_interval=3600, **kw)


def open_pair(tmp_path, name="a", **kw):
    j = jax_server(str(tmp_path / name / "jax"), stats=jstats.ExpvarStatsClient(), **kw)
    t = TServer(str(tmp_path / name / "torch"), device="cpu", floor_probe=False,
                stats=tstats.ExpvarStatsClient(), **kw)
    j.open()
    t.open()
    return j, t


@pytest.fixture
def servers(tmp_path):
    j, t = open_pair(tmp_path)
    try:
        for s in (j, t):
            populate(s)
        yield j, t
    finally:
        t.close()
        j.close()


def schema(s) -> None:
    for path, body in (
        ("/index/i", b""),
        ("/index/i/frame/f", b'{"options": {"inverseEnabled": true, "cacheSize": 100}}'),
        ("/index/i/frame/g", b""),
        ("/index/i/frame/t", b'{"options": {"timeQuantum": "YMD"}}'),
    ):
        assert request(s.host, "POST", path, body)[0] == 200


def seeded_import(seed: int = 0):
    rng = np.random.default_rng(seed)
    n = 6000
    rows = rng.integers(0, 250, n)
    cols = rng.integers(0, N_SLICES * SW, n)
    keep = rng.random(n) < ((rows % 9) + 1) / 9
    return rows[keep].astype(np.uint64), cols[keep].astype(np.uint64)


def populate(s, seed: int = 0) -> None:
    schema(s)
    rows, cols = seeded_import(seed)
    for sl in range(N_SLICES):
        sel = cols // SW == sl
        for frame in ("f", "g"):
            req = pb.ImportRequest(Index="i", Frame=frame, Slice=sl,
                                   RowIDs=rows[sel].tolist(), ColumnIDs=cols[sel].tolist())
            status, _ = request(s.host, "POST", "/import", req.SerializeToString(), PROTO)
            assert status == 200
    writes = [f"SetBit(frame=t, rowID={r}, columnID={c}, timestamp=\"2017-0{1 + r % 3}-0{1 + c % 5}T00:00\")"
              for r, c in ((1, 3), (2, 5), (1, SW + 7), (3, 2 * SW + 9), (2, 44))]
    writes += ['SetRowAttrs(frame=f, rowID=1, color="red", n=5)',
               'SetRowAttrs(frame=f, rowID=200, color="blue")',
               'SetColumnAttrs(columnID=3, name="x")', f'SetColumnAttrs(columnID={SW + 1}, k=2)',
               f"SetBit(frame=g, rowID=7, columnID={SW - 1})"]
    status, body = request(s.host, "POST", "/index/i/query", " ".join(writes).encode())
    assert status == 200, body


def norm(s, body: bytes) -> bytes:
    return body.replace(s.host.encode(), b"HOST")


def members(archive: bytes) -> dict[str, bytes]:
    tr = tarfile.open(fileobj=io.BytesIO(archive))
    return {m.name: tr.extractfile(m).read() for m in tr}


def nested_members(archive: bytes) -> dict[str, dict[str, bytes]]:
    return {name: members(payload) for name, payload in members(archive).items()}


def torn(archive: bytes) -> bytes:
    """The archive with one byte of its "data" entry flipped."""
    entries = members(archive)
    data = bytearray(entries["data"])
    data[len(data) // 2] ^= 0x55
    entries["data"] = bytes(data)
    buf = io.BytesIO()
    tw = tarfile.open(fileobj=buf, mode="w")
    for name, payload in entries.items():
        info = tarfile.TarInfo(name)
        info.size = len(payload)
        tw.addfile(info, io.BytesIO(payload))
    tw.close()
    return buf.getvalue()


def block_req(index="i", frame="f", view="standard", slc=0, block=0) -> bytes:
    return pb.BlockDataRequest(Index=index, Frame=frame, View=view, Slice=slc,
                               Block=block).SerializeToString()


def view_req(**kw) -> bytes:
    return pb.ImportViewRequest(**kw).SerializeToString()


CASES = [
    # views
    ("GET", "/index/i/frame/f/views", b"", None),
    ("GET", "/index/i/frame/t/views", b"", None),
    ("GET", "/index/i/frame/nope/views", b"", None),
    ("GET", "/index/nope/frame/f/views", b"", None),
    # time quantum
    ("PATCH", "/index/i/time-quantum", b'{"timeQuantum": "YM"}', None),
    ("PATCH", "/index/i/time-quantum", b'{"timeQuantum": ""}', None),
    ("PATCH", "/index/i/time-quantum", b'{"timeQuantum": "XYZ"}', None),
    ("PATCH", "/index/i/time-quantum", b"{bad", None),
    ("PATCH", "/index/nope/time-quantum", b'{"timeQuantum": "Y"}', None),
    ("PATCH", "/index/i/frame/t/time-quantum", b'{"timeQuantum": "YMDH"}', None),
    ("PATCH", "/index/i/frame/t/time-quantum", b'{"timeQuantum": "Q"}', None),
    ("PATCH", "/index/i/frame/nope/time-quantum", b'{"timeQuantum": "Y"}', None),
    ("PATCH", "/index/i/frame/t/time-quantum", b"[1", None),
    # attribute diffs
    ("POST", "/index/i/attr/diff", b'{"blocks": []}', None),
    ("POST", "/index/i/attr/diff", b'{"blocks": [{"id": 0, "checksum": "AAAA"}]}', None),
    ("POST", "/index/i/attr/diff", b"nope", None),
    ("POST", "/index/nope/attr/diff", b'{"blocks": []}', None),
    ("POST", "/index/i/frame/f/attr/diff", b'{"blocks": []}', None),
    ("POST", "/index/i/frame/f/attr/diff", b'{"blocks": [{"id": 9, "checksum": "AAAA"}]}', None),
    ("POST", "/index/i/frame/nope/attr/diff", b'{"blocks": []}', None),
    # export
    ("GET", "/export?index=i&frame=f&view=standard&slice=0", b"", {"Accept": "text/csv"}),
    ("GET", "/export?index=i&frame=f&view=standard&slice=2", b"", {"Accept": "text/csv"}),
    ("GET", "/export?index=i&frame=f&view=inverse&slice=0", b"", {"Accept": "text/csv"}),
    ("GET", "/export?index=i&frame=t&view=standard_2017&slice=0", b"", {"Accept": "text/csv"}),
    ("GET", "/export?index=i&frame=f&view=standard&slice=0", b"", None),
    ("GET", "/export?index=i&frame=f&view=standard&slice=x", b"", {"Accept": "text/csv"}),
    ("GET", "/export?index=i&frame=f&view=standard&slice=9", b"", {"Accept": "text/csv"}),
    # fragment archives
    ("GET", "/fragment/data?index=i&frame=f&view=standard&slice=1", b"", None),
    ("GET", "/fragment/data?index=i&frame=f&view=inverse&slice=0", b"", None),
    ("GET", "/fragment/data?index=i&frame=f&view=standard&slice=7", b"", None),
    ("GET", "/fragment/data?index=i&frame=f&view=standard", b"", None),
    # blocks
    ("GET", "/fragment/blocks?index=i&frame=f&view=standard&slice=0", b"", None),
    ("GET", "/fragment/blocks?index=i&frame=f&view=standard&slice=2", b"", None),
    ("GET", "/fragment/blocks?index=i&frame=f&view=inverse&slice=0", b"", None),
    ("GET", "/fragment/blocks?index=i&frame=g&view=standard&slice=0", b"", None),
    ("GET", "/fragment/blocks?index=i&frame=f&view=standard&slice=5", b"", None),
    ("GET", "/fragment/blocks?index=i&frame=f&view=standard&slice=-1", b"", None),
    ("GET", "/fragment/block/data", block_req(block=0), PROTO),
    ("GET", "/fragment/block/data", block_req(block=2, slc=1), PROTO),
    ("GET", "/fragment/block/data", block_req(block=9), PROTO),
    ("GET", "/fragment/block/data", block_req(view="inverse", block=0), PROTO),
    ("GET", "/fragment/block/data", block_req(slc=8), PROTO),
    ("GET", "/fragment/block/data", b"\xff\xff", PROTO),
    # view-scoped repair
    ("POST", "/fragment/import-view",
     view_req(Index="i", Frame="f", View="standard", Slice=1, RowIDs=[5, 6, (1 << 40)],
              ColumnIDs=[SW + 1, SW + 2, 2 * SW - 1], ClearRowIDs=[1], ClearColumnIDs=[SW + 3]),
     PROTO),
    ("POST", "/fragment/import-view",
     view_req(Index="i", Frame="f", View="inverse", Slice=0, RowIDs=[9], ColumnIDs=[3]), PROTO),
    ("POST", "/fragment/import-view",
     view_req(Index="i", Frame="f", View="standard", Slice=1, RowIDs=[5], ColumnIDs=[3]), PROTO),
    ("POST", "/fragment/import-view",
     view_req(Index="i", Frame="f", View="standard", Slice=0, RowIDs=[5, 6], ColumnIDs=[3]), PROTO),
    ("POST", "/fragment/import-view",
     view_req(Index="i", Frame="nope", View="standard", Slice=0, RowIDs=[5], ColumnIDs=[3]), PROTO),
    ("POST", "/fragment/import-view", b"\x0a\xff", PROTO),
    # restore: a bad slice and a missing frame (archives: below)
    ("POST", "/fragment/data?index=i&frame=f&view=standard", b"", None),
    ("POST", "/fragment/data?index=i&frame=nope&view=standard&slice=0", b"", None),
    # frame restore without a host, from a missing frame
    ("POST", "/index/i/frame/f/restore", b"", None),
    ("POST", "/index/i/frame/nope/restore?host=127.0.0.1:1", b"", None),
]


def _answers_equal(j, t, method, path, body, headers):
    a = request(j.host, method, path, body, headers)
    b = request(t.host, method, path, body, headers)
    assert b[0] == a[0], (path, a, b)
    if a[0] == 200 and path.startswith("/fragment/data") and method == "GET":
        assert members(b[1]) == members(a[1])
    else:
        assert norm(t, b[1]) == norm(j, a[1]), (path, a, b)


@pytest.mark.parametrize("accept", ["json", "protobuf"])
def test_every_route_answers_as_jax(servers, accept):
    j, t = servers
    for method, path, body, headers in CASES:
        h = dict(headers or {})
        if "Accept" not in h:
            h["Accept"] = PROTO["Accept"] if accept == "protobuf" else JSON_ACCEPT["Accept"]
        _answers_equal(j, t, method, path, body, h)
    # Both answer the same queries after the route's writes.
    for pql in ("Count(Bitmap(frame=f, rowID=5))", "Bitmap(frame=f, rowID=6)",
                "Count(Bitmap(frame=f, rowID=1))", 'Range(frame=t, rowID=1, start="2017-01-01T00:00",'
                ' end="2017-04-01T00:00")'):
        _answers_equal(j, t, "POST", "/index/i/query", pql.encode(), None)


def test_attr_diff_of_the_other_nodes_blocks(servers):
    """Each node asked with the other's checksums: nothing differs; with
    one block's checksum changed, that block's attributes come back."""
    j, t = servers
    jblocks = j.holder.frame("i", "f").row_attr_store.blocks()
    tblocks = t.holder.frame("i", "f").row_attr_store.blocks()
    assert tblocks == jblocks and jblocks
    for blocks, want_empty in ((jblocks, True), ([(b, b"\x00" * 20) for b, _ in jblocks], False)):
        payload = json.dumps({"blocks": [{"id": b, "checksum": base64.b64encode(c).decode()}
                                         for b, c in blocks]}).encode()
        for path in ("/index/i/frame/f/attr/diff", "/index/i/attr/diff"):
            _answers_equal(j, t, "POST", path, payload, None)
        got = TClient(t.host).row_attr_diff("i", "f", blocks)
        assert got == JClient(j.host).row_attr_diff("i", "f", blocks)
        assert (got == {}) == want_empty


def test_state_answers_the_jax_404_until_gossip(servers):
    # Both nodes serve their NodeStatus (the gossip stream fallback's
    # blob), equal but for the host; without a provider, both the 404.
    j, t = servers
    a, b = request(j.host, "GET", "/state"), request(t.host, "GET", "/state")
    assert a[0] == b[0] == 200
    sa, sb = pb.NodeStatus(), pb.NodeStatus()
    sa.ParseFromString(a[1])
    sb.ParseFromString(b[1])
    assert (sa.Host, sb.Host) == (j.host, t.host)
    sb.Host = sa.Host
    assert sb.SerializeToString() == sa.SerializeToString()
    j.handler.state_provider = t.handler.state_provider = None
    _answers_equal(j, t, "GET", "/state", b"", None)
    assert request(t.host, "GET", "/state")[0] == 404


def test_archives_restore_across_packages_and_torn_ones_are_refused(servers):
    j, t = servers
    for src, dst in ((j, t), (t, j)):
        archive = request(src.host, "GET", "/fragment/data?index=i&frame=g&view=standard&slice=2")[1]
        path = "/fragment/data?index=i&frame=f&view=standard&slice=0"
        for s in (j, t):
            assert request(s.host, "POST", "/index/i/query", b"Count(Bitmap(frame=f, rowID=3))")[0] == 200
        for body, status in ((torn(archive), 422), (archive, 200)):
            a = request(j.host, "POST", path, body)
            b = request(t.host, "POST", path, body)
            assert a[0] == b[0] == status
            assert b[1] == a[1]
            for pql in ("Count(Bitmap(frame=f, rowID=3))", "Bitmap(frame=f, rowID=7)",
                        "TopN(frame=f, n=5)", "Count(Bitmap(frame=g, rowID=3))"):
                _answers_equal(j, t, "POST", "/index/i/query", pql.encode(), None)
            blocks = "/fragment/blocks?index=i&frame=f&view=standard&slice=0"
            _answers_equal(j, t, "GET", blocks, b"", None)
        assert dst is not None


def _warm_port_state(t, slice_i: int = 1):
    """A Count (mirror resident, batch entry cached) and a SetBit (a
    queued delta) on the port before the write under test."""
    for s in (t,):
        assert request(s.host, "POST", "/index/i/query",
                       b"Count(Intersect(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2)))")[0] == 200
    frag = t.holder.fragment("i", "f", "standard", slice_i)
    assert frag._mirror is not None
    assert t.executor._batch_cache
    return frag


WRITE_OPS = ["restore", "import_view", "merge_block", "time_quantum"]


@pytest.mark.parametrize("op", WRITE_OPS)
def test_next_query_after_a_wholesale_write_equals_jax(servers, op):
    j, t = servers
    queries = ["Count(Intersect(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2)))",
               "Count(Bitmap(frame=f, rowID=1))", "Bitmap(frame=f, rowID=2)",
               "TopN(frame=f, n=4)",
               'Count(Range(frame=t, rowID=1, start="2017-01-01T00:00", end="2017-02-01T00:00"))']
    for s in (j, t):
        for q in queries:
            assert request(s.host, "POST", "/index/i/query", q.encode())[0] == 200
    frag = _warm_port_state(t)
    setbit = f"SetBit(frame=f, rowID=1, columnID={SW + 11}) SetBit(frame=f, rowID=2, columnID={SW + 11})"
    for s in (j, t):
        assert request(s.host, "POST", "/index/i/query", setbit.encode())[0] == 200
    assert frag._mirror is not None and frag._pending_n > 0
    if op == "restore":
        archive = request(j.host, "GET", "/fragment/data?index=i&frame=g&view=standard&slice=1")[1]
        for s in (j, t):
            path = "/fragment/data?index=i&frame=f&view=standard&slice=1"
            assert request(s.host, "POST", path, archive)[0] == 200
        assert frag._mirror is None
    elif op == "import_view":
        body = view_req(Index="i", Frame="f", View="standard", Slice=1, RowIDs=[1, 2, 2],
                        ColumnIDs=[SW + 12, SW + 12, SW + 13], ClearRowIDs=[1],
                        ClearColumnIDs=[SW + 11])
        for s in (j, t):
            assert request(s.host, "POST", "/fragment/import-view", body, PROTO)[0] == 200
        assert frag._pending_n > 0
    elif op == "merge_block":
        jf = j.holder.fragment("i", "f", "standard", 1)
        remote = ([1, 2, 2, 1], [11, 11, 500, 9])
        out_j = jf.merge_block(0, [JPairSet(*map(list, remote))] * 2)
        out_t = frag.merge_block(0, [TPairSet(*map(list, remote))] * 2)
        assert [[(p.row_ids, p.column_ids) for p in side] for side in out_t] == \
            [[(p.row_ids, p.column_ids) for p in side] for side in out_j]
    else:
        for s in (j, t):
            assert request(s.host, "PATCH", "/index/i/frame/t/time-quantum",
                           b'{"timeQuantum": "Y"}')[0] == 200
    for q in queries:
        _answers_equal(j, t, "POST", "/index/i/query", q.encode(), None)
    _answers_equal(j, t, "GET", "/fragment/blocks?index=i&frame=f&view=standard&slice=1", b"", None)


def test_restore_survives_a_reopen_and_stages(tmp_path):
    j, t = open_pair(tmp_path)
    try:
        for s in (j, t):
            populate(s)
        archive = request(j.host, "GET", "/fragment/data?index=i&frame=g&view=standard&slice=0")[1]
        for s in (j, t):
            path = "/fragment/data?index=i&frame=f&view=standard&slice=0&stage=true"
            assert request(s.host, "POST", path, archive) == (200, b"{}\n")
        frag = t.holder.fragment("i", "f", "standard", 0)
        for _ in range(200):
            if frag._mirror is not None:
                break
            import time

            time.sleep(0.01)
        assert frag._mirror is not None  # staged by the prefetcher
    finally:
        t.close()
        j.close()
    j2 = jax_server(str(tmp_path / "a" / "jax"))
    t2 = TServer(str(tmp_path / "a" / "torch"), device="cpu", floor_probe=False)
    j2.open()
    t2.open()
    try:
        for q in ("Count(Bitmap(frame=f, rowID=3))", "Bitmap(frame=f, rowID=7)", "TopN(frame=f, n=3)"):
            _answers_equal(j2, t2, "POST", "/index/i/query", q.encode(), None)
        _answers_equal(j2, t2, "GET", "/fragment/blocks?index=i&frame=f&view=standard&slice=0",
                       b"", None)
    finally:
        t2.close()
        j2.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frame_restore_pulls_from_a_node_of_the_other_package(tmp_path, direction):
    j, t = open_pair(tmp_path, "src")
    j2, t2 = open_pair(tmp_path, "dst")
    try:
        for s in (j, t):
            populate(s, seed=3)
        for s in (j2, t2):
            schema(s)
        src, dst, ref = (j, t2, j2) if direction == "jax_to_port" else (t, j2, t2)
        for node, frm in ((dst, src), (ref, src)):
            for frame in ("f", "t"):
                status, body = request(node.host, "POST",
                                       f"/index/i/frame/{frame}/restore?host={frm.host}")
                assert status == 200, body
        qs = ["Count(Bitmap(frame=f, rowID=3))", "Bitmap(frame=f, rowID=8)", "TopN(frame=f, n=5)",
              'Count(Range(frame=t, rowID=1, start="2017-01-01T00:00", end="2017-04-01T00:00"))']
        for q in qs:
            want = request(src.host, "POST", "/index/i/query", q.encode())
            for node in (dst, ref):
                assert request(node.host, "POST", "/index/i/query", q.encode()) == want, q
        for view, slc in (("standard", 2), ("inverse", 0)):
            path = f"/fragment/blocks?index=i&frame=f&view={view}&slice={slc}"
            assert request(dst.host, "GET", path) == request(src.host, "GET", path)
        assert request(dst.host, "GET", "/index/i/frame/t/views") == \
            request(src.host, "GET", "/index/i/frame/t/views")
        # The port's client asks a JAX node, and the JAX client the port.
        TClient(t2.host).restore_frame(src.host, "i", "g")
        JClient(j2.host).restore_frame(src.host, "i", "g")
        q = "Count(Bitmap(frame=g, rowID=5))"
        assert request(t2.host, "POST", "/index/i/query", q.encode()) == \
            request(j2.host, "POST", "/index/i/query", q.encode())
    finally:
        for s in (t2, j2, t, j):
            s.close()


@pytest.mark.parametrize("view", ["standard", "inverse"])
def test_whole_view_backups_restore_across_packages(tmp_path, view):
    j, t = open_pair(tmp_path, "src")
    j2, t2 = open_pair(tmp_path, "dst")
    try:
        for s in (j, t):
            populate(s, seed=5)
        for s in (j2, t2):
            schema(s)
        jbuf, tbuf = io.BytesIO(), io.BytesIO()
        JClient(j.host).backup_to(jbuf, "i", "f", view)
        TClient(t.host).backup_to(tbuf, "i", "f", view)
        assert nested_members(tbuf.getvalue()) == nested_members(jbuf.getvalue())
        # JAX's backup into the port node, the port's into the JAX node.
        TClient(t2.host).restore_from(io.BytesIO(jbuf.getvalue()), "i", "f", view)
        JClient(j2.host).restore_from(io.BytesIO(tbuf.getvalue()), "i", "f", view)
        for slc in range(N_SLICES):
            path = f"/fragment/blocks?index=i&frame=f&view={view}&slice={slc}"
            assert request(t2.host, "GET", path) == request(j.host, "GET", path)
            assert request(j2.host, "GET", path) == request(j.host, "GET", path)
        for q in ("Count(Bitmap(frame=f, rowID=3))", "TopN(frame=f, n=5)", "Bitmap(frame=f, rowID=4)"):
            _answers_equal(j2, t2, "POST", "/index/i/query", q.encode(), None)
        # Block sync through both clients: equal blocks, equal data (of
        # every 97th block: the inverse view's rows are column ids).
        a, b = JClient(j.host), TClient(t2.host)
        for slc in range(N_SLICES if view == "standard" else 1):
            blocks = a.fragment_blocks("i", "f", view, slc)
            assert b.fragment_blocks("i", "f", view, slc) == blocks
            for bid, _ in blocks[::97]:
                assert b.block_data("i", "f", view, slc, bid) == a.block_data("i", "f", view, slc, bid)
        with pytest.raises(Exception, match="invalid view"):
            TClient(t.host).backup_to(io.BytesIO(), "i", "f", "standard_2017")
    finally:
        for s in (t2, j2, t, j):
            s.close()


def test_repair_pushes_through_both_clients(servers):
    """A block that differs is read through ``block_data`` and pushed
    with ``import_view_bits``: the blocks are equal again."""
    j, t = servers
    tc, jc = TClient(t.host), JClient(j.host)
    for s in (j, t):
        request(s.host, "POST", "/index/i/query",
                f"SetBit(frame=f, rowID=150, columnID={2 * SW + 5})".encode())
    request(t.host, "POST", "/index/i/query", f"ClearBit(frame=f, rowID=150, columnID={2 * SW + 5})".encode())
    jb, tb = dict(jc.fragment_blocks("i", "f", "standard", 2)), dict(tc.fragment_blocks("i", "f", "standard", 2))
    diff = [b for b in jb if jb[b] != tb.get(b)]
    assert diff == [1]
    rows, offs = jc.block_data("i", "f", "standard", 2, 1)
    have = set(zip(*tc.block_data("i", "f", "standard", 2, 1)))
    missing = [(r, c) for r, c in zip(rows, offs) if (r, c) not in have]
    tc.import_view_bits("i", "f", "standard", 2, ([r for r, _ in missing], [2 * SW + c for _, c in missing]),
                        ([], []))
    assert tc.fragment_blocks("i", "f", "standard", 2) == jc.fragment_blocks("i", "f", "standard", 2)
    assert tc.export_csv("i", "f", "standard", 2) == jc.export_csv("i", "f", "standard", 2)


def test_not_owned_slices_answer_412(tmp_path):
    """With a second node in the ring that owns a slice, export and the
    repair push answer 412 on this one, and the client's export goes to
    the owner."""
    j, t = open_pair(tmp_path)
    try:
        for s in (j, t):
            populate(s)
        fake = "127.0.0.1:1"
        for s in (j, t):
            s.cluster.add_node(fake) if s is j else s.cluster.add_node(fake, "")
        for s, other in ((j, t), (t, j)):
            slc = next(i for i in range(64) if s.cluster.fragment_nodes("i", i)[0].host == fake)
            body = view_req(Index="i", Frame="f", View="standard", Slice=slc, RowIDs=[1],
                            ColumnIDs=[slc * SW])
            s.answers = (
                request(s.host, "GET", f"/export?index=i&frame=f&view=standard&slice={slc}",
                        headers={"Accept": "text/csv"}),
                request(s.host, "POST", "/fragment/import-view", body, PROTO),
            )
        for a, b in zip(j.answers, t.answers):
            assert a[0] == b[0] == 412
            assert re.sub(rb"127\.0\.0\.1:\d+ slice=\d+", b"", a[1]) == \
                re.sub(rb"127\.0\.0\.1:\d+ slice=\d+", b"", b[1])
    finally:
        t.close()
        j.close()


def test_stream_family_on_metrics(servers):
    """Streamed bodies count on /metrics as on a JAX node: the
    ``pilosa_stream_`` names of the two nodes are equal."""
    j, t = servers
    for s in (j, t):
        archive = request(s.host, "GET", "/fragment/data?index=i&frame=f&view=standard&slice=0")[1]
        conn = http.client.HTTPConnection(s.host, timeout=60)
        conn.request("POST", "/fragment/data?index=i&frame=f&view=standard&slice=0",
                     body=iter([archive[:5000], archive[5000:]]),
                     headers={"Transfer-Encoding": "chunked"}, encode_chunked=True)
        assert conn.getresponse().status == 200
        conn.close()
    names = []
    for s in (j, t):
        body = request(s.host, "GET", "/metrics")[1].decode()
        names.append(sorted({re.split(r"[{ ]", ln)[0] for ln in body.splitlines()
                             if ln.startswith("pilosa_stream_")}))
    assert names[1] == names[0]
    assert "pilosa_stream_bytesSent_total" in names[1]
    assert "pilosa_stream_bytesReceived_total" in names[1]
