"""Attribute writes: a JAX ``pilosa_tpu`` Server and a port
``pilosa_tpu_torch`` Server(device="cpu") receive the same
``SetRowAttrs`` / ``SetColumnAttrs`` queries — single, bulk, across
frames, by column id and by the index's column label, and every error —
in JSON and in protobuf, and must answer with the same status and the
same bytes; then the reads that return attributes (Bitmap attrs,
``columnAttrs``, TopN ``field``/``filters``) must match byte for byte.
On a 2-node port cluster an attribute write reaches the other node."""

import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.net import wire_pb2 as jwire  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402

SW = 1 << 20
PROTOBUF = "application/x-protobuf"


def raw(host: str, method: str, path: str, body: bytes = b"", headers=None):
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None, method=method
    )
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def query(host: str, pql: str, enc: str, column_attrs: bool = False):
    """POST one query as raw PQL (JSON answer) or as a QueryRequest
    protobuf (protobuf answer); ``(status, body bytes)``."""
    if enc == "json":
        path = "/index/i/query" + ("?columnAttrs=true" if column_attrs else "")
        return raw(host, "POST", path, pql.encode())
    pb = jwire.QueryRequest(Query=pql, ColumnAttrs=column_attrs)
    return raw(host, "POST", "/index/i/query", pb.SerializeToString(),
               {"Content-Type": PROTOBUF, "Accept": PROTOBUF})


def jax_server(path: str) -> JServer:
    return JServer(data_dir=path, host="127.0.0.1:0", anti_entropy_interval=3600,
                   polling_interval=3600, cache_flush_interval=3600)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """One pair for the module: every test sends both nodes the same
    queries in the same order, so their states stay equal."""
    tmp_path = tmp_path_factory.mktemp("attrs")
    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", floor_probe=False)
    j.open()
    t.open()
    try:
        for host in (j.host, t.host):
            assert raw(host, "POST", "/index/i", b'{"options": {"columnLabel": "col"}}')[0] == 200
            assert raw(host, "POST", "/index/i/frame/f", b'{"options": {"rowLabel": "row"}}')[0] == 200
            assert raw(host, "POST", "/index/i/frame/g")[0] == 200
        rng = np.random.default_rng(7)
        calls = []
        for _ in range(200):
            r, c = int(rng.integers(0, 6)), int(rng.integers(0, 2 * SW))
            calls.append(f"SetBit(frame=f, row={r}, col={c})")
            calls.append(f"SetBit(frame=g, rowID={r % 3}, col={c})")
        for k in range(0, len(calls), 50):
            body = " ".join(calls[k : k + 50])
            assert query(j.host, body, "json") == query(t.host, body, "json")
        yield j, t
    finally:
        t.close()
        j.close()


def same(j, t, pql: str, enc: str, column_attrs: bool = False):
    jr = query(j.host, pql, enc, column_attrs)
    tr = query(t.host, pql, enc, column_attrs)
    assert tr == jr, pql
    return jr


WRITES = {
    "single": ['SetRowAttrs(frame=f, row=1, color="red", n=3)'],
    "bulk": [
        'SetRowAttrs(frame=f, row=2, color="blue") SetRowAttrs(frame=f, row=3, active=true)'
        ' SetRowAttrs(frame=f, row=2, weight=1.5)'
    ],
    "multi_frame": [
        'SetRowAttrs(frame=f, row=4, tag="x") SetRowAttrs(frame=g, rowID=1, tag="y")'
        ' SetRowAttrs(frame=g, rowID=2, tag="z")'
    ],
    "overwrite_and_delete": [
        'SetRowAttrs(frame=f, row=1, color="green")',
        "SetRowAttrs(frame=f, row=1, n=null)",
    ],
    "column_by_id": ['SetColumnAttrs(id=5, name="five", rank=2)'],
    "column_by_label": ['SetColumnAttrs(col=7, name="seven")'],
    "mixed_with_reads": [
        'SetColumnAttrs(id=9, k=1) SetRowAttrs(frame=f, row=5, c="q") Count(Bitmap(frame=f, row=5))'
    ],
}

ERRORS = [
    "SetRowAttrs(row=1, x=1)",  # no frame
    "SetRowAttrs(frame=nope, row=1, x=1)",  # unknown frame
    "SetRowAttrs(frame=f, x=1)",  # missing row field
    "SetRowAttrs(frame=f, rowID=1, x=1)",  # not the frame's row label
    "SetRowAttrs(frame=f, row=1, x=1) SetRowAttrs(frame=f, x=2)",  # bulk: missing row
    "SetRowAttrs(frame=f, row=1, x=1) SetRowAttrs(frame=nope, row=1, x=2)",  # bulk: frame
    "SetRowAttrs(frame=f, row=1, x=1) SetRowAttrs(row=1, x=2)",  # bulk: no frame
    "SetColumnAttrs(name=1)",  # no id
    "SetColumnAttrs(columnID=1, name=1)",  # not the index's column label
    'SetRowAttrs(frame=f, row=1, x=[1, 2])',  # not an attribute value
]


@pytest.mark.parametrize("enc", ["json", "proto"])
@pytest.mark.parametrize("case", sorted(WRITES))
def test_attr_writes_answer_as_jax(servers, case, enc):
    j, t = servers
    for pql in WRITES[case]:
        status, _ = same(j, t, pql, enc)
        assert status == 200, pql


@pytest.mark.parametrize("enc", ["json", "proto"])
@pytest.mark.parametrize("pql", ERRORS)
def test_attr_write_errors_answer_as_jax(servers, pql, enc):
    j, t = servers
    status, _ = same(j, t, pql, enc)
    assert status != 200


READS = [
    ("Bitmap(frame=f, row=1)", False),
    ("Bitmap(frame=f, row=2)", True),
    ("Bitmap(frame=g, rowID=1)", True),
    ("Bitmap(frame=f, row=5)", True),
    ("Bitmap(frame=f, row=4) Bitmap(frame=f, row=3)", True),
    ("Union(Bitmap(frame=f, row=1), Bitmap(frame=g, rowID=2))", True),
    ('TopN(frame=f, n=4, field="color", filters=["blue", "green"])', False),
    ('TopN(frame=g, n=3, field="tag", filters=["y"])', False),
    ("TopN(frame=f, n=3)", False),
]


@pytest.mark.parametrize("enc", ["json", "proto"])
def test_attr_reads_after_writes_answer_as_jax(servers, enc):
    j, t = servers
    for case in sorted(WRITES):
        for pql in WRITES[case]:
            assert same(j, t, pql, "json")[0] == 200
    for pql, cols in READS:
        status, _ = same(j, t, pql, enc, column_attrs=cols)
        assert status == 200, pql
    # Column attrs of bits that exist in the results.
    for cid in (5, 7, 9):
        same(j, t, f"SetBit(frame=f, row=1, col={cid})", "json")
    status, body = same(j, t, "Bitmap(frame=f, row=1)", enc, column_attrs=True)
    assert status == 200
    assert b"five" in body and b"seven" in body


def test_attr_write_reaches_the_other_node(tmp_path):
    """A 2-node http cluster: an attribute write at either node is
    broadcast to the other, whose stores then hold it; a remote leg is
    not broadcast again."""
    nodes = [
        TServer(str(tmp_path / f"n{i}"), device="cpu", cluster_type="http", replicas=1,
                internal_port=0, polling_interval=3600, floor_probe=False)
        for i in range(2)
    ]
    for s in nodes:
        s.open()
    try:
        for s in nodes:
            for o in nodes:
                if o is not s:
                    s.add_peer(o.host, o.internal_host)
        assert raw(nodes[0].host, "POST", "/index/i")[0] == 200
        assert raw(nodes[0].host, "POST", "/index/i/frame/f")[0] == 200
        for s in nodes:
            assert s.holder.frame("i", "f") is not None
        assert query(nodes[0].host, 'SetRowAttrs(frame=f, rowID=3, a="x")', "json")[0] == 200
        assert query(nodes[1].host, "SetColumnAttrs(id=4, b=2) SetRowAttrs(frame=f, rowID=8, c=1)"
                     " SetRowAttrs(frame=f, rowID=9, c=2)", "json")[0] == 200
        for s in nodes:
            f = s.holder.frame("i", "f")
            assert f.row_attr_store.attrs(3) == {"a": "x"}
            assert f.row_attr_store.attrs(8) == {"c": 1}
            assert f.row_attr_store.attrs(9) == {"c": 2}
            assert s.holder.index("i").column_attr_store.attrs(4) == {"b": 2}
    finally:
        for s in nodes:
            s.close()
