"""The slice as a whole: a JAX ``pilosa_tpu`` Server and a port
``pilosa_tpu_torch`` Server(device="cpu") receive the same seeded writes
and PQL over HTTP and must answer with equal status codes and JSON
bodies; a data directory either one wrote and closed opens in the other
with identical planes and answers."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402

SW = 1 << 20
N_SLICES = 3


def http(host: str, method: str, path: str, body: bytes = b""):
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def jax_server(path: str) -> JServer:
    return JServer(
        data_dir=path,
        host="127.0.0.1:0",
        anti_entropy_interval=3600,
        polling_interval=3600,
        cache_flush_interval=3600,
    )


def seeded_setbits(seed: int = 0) -> list[str]:
    """Queries of 40 SetBits each: frame f dense-ish rows 0..7 with
    row-dependent density over 3 slices, frame g a few sparse bits, plus
    sign-bit and last-word columns."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(480):
        r = int(rng.integers(0, 8))
        if rng.random() < (r + 1) / 8:
            c = int(rng.integers(0, N_SLICES * SW))
            calls.append(f"SetBit(frame=f, rowID={r}, columnID={c})")
    for c in (31, SW - 1, SW - 32, 2 * SW + 31, N_SLICES * SW - 1):
        calls.append(f"SetBit(frame=f, rowID=2, columnID={c})")
        calls.append(f"SetBit(frame=g, rowID=1, columnID={c})")
    for _ in range(30):
        r, c = int(rng.integers(0, 4)), int(rng.integers(0, N_SLICES * SW))
        calls.append(f"SetBit(frame=g, rowID={r}, columnID={c})")
    return [" ".join(calls[i : i + 40]) for i in range(0, len(calls), 40)]


B = "Bitmap(frame=f, rowID={})"
READS = [
    f"Count({B.format(0)})",
    f"Count(Intersect({B.format(2)}, {B.format(5)}))",
    f"Count(Union({B.format(0)}, {B.format(1)}, {B.format(7)}))",
    f"Count(Difference({B.format(6)}, {B.format(3)}))",
    f"Count(Xor({B.format(4)}, {B.format(2)}))",
    f"Count(Intersect({B.format(2)}, Bitmap(frame=g, rowID=1)))",
    f"Count(Union())",
    "Count(Bitmap(frame=f, rowID=99))",
    "Bitmap(frame=g, rowID=1)",
    f"Intersect({B.format(1)}, {B.format(2)}) Count({B.format(3)})",
    f"Difference(Bitmap(frame=g, rowID=2), {B.format(7)})",
    "TopN(frame=f, n=3)",
    "TopN(frame=f)",
    f"TopN({B.format(0)}, frame=f, n=3)",
    f"TopN(Intersect({B.format(6)}, {B.format(7)}), frame=f, n=4)",
    "TopN(frame=f, n=2, ids=[1, 3, 5])",
    "TopN(frame=f, n=8, threshold=200)",
    f"TopN({B.format(5)}, frame=f, n=5, tanimotoThreshold=20)",
    "TopN(Bitmap(frame=g, rowID=1), frame=g, n=2)",
    # A src tree that is empty on every slice, and one that leaves rows.
    f"TopN(Intersect({B.format(2)}, Bitmap(frame=g, rowID=9)), frame=f, n=3)",
    f"TopN(Difference(Bitmap(frame=g, rowID=1), {B.format(0)}), frame=f, n=3, tanimotoThreshold=10)",
    "TopN(frame=nope, n=2)",
    # Errors: same status and message.
    "Count(Bitmap(frame=nope, rowID=0))",
    "Count()",
    "Foo()",
    "Bitmap(frame=f)",
    "Count(Bitmap(frame=f, rowID=0)",
    "Intersect()",
]


@pytest.fixture
def servers(tmp_path):
    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu")
    j.open()
    t.open()
    try:
        yield j, t
    finally:
        t.close()
        j.close()


def both(j, t, method, path, body=b""):
    return http(j.host, method, path, body), http(t.host, method, path, body)


def setup_and_write(j, t) -> None:
    for path, body in (
        ("/index/i", b""),
        ("/index/i", b""),  # 409 both
        ("/index/i/frame/f", b'{"options": {"cacheSize": 100}}'),
        ("/index/i/frame/g", b""),
        ("/index/nope/frame/x", b""),  # 404 both
    ):
        jr, tr = both(j, t, "POST", path, body)
        assert tr == jr, path
    for q in seeded_setbits():
        jr, tr = both(j, t, "POST", "/index/i/query", q.encode())
        assert tr == jr
        assert jr[0] == 200


def test_same_answers_over_http(servers):
    j, t = servers
    setup_and_write(j, t)
    for path in ("/schema", "/version", "/index/i", "/index/nope", "/nope"):
        jr, tr = both(j, t, "GET", path)
        assert tr == jr, path
    js, ts = both(j, t, "GET", "/status")
    for node in js[1]["status"]["Nodes"] + ts[1]["status"]["Nodes"]:
        node.pop("Host")
    assert ts == js
    for q in READS:
        jr, tr = both(j, t, "POST", "/index/i/query", q.encode())
        assert tr == jr, q
    for path in ("/index/i/query?slices=0,2", "/index/i/query?bogus=1"):
        jr, tr = both(j, t, "POST", path, f"Count({B.format(1)})".encode())
        assert tr == jr, path
    # A clear, then the reads that must see it.
    for q in (
        "ClearBit(frame=f, rowID=2, columnID=31)",
        "ClearBit(frame=f, rowID=2, columnID=31)",
        f"Count({B.format(2)})",
        "Bitmap(frame=g, rowID=1)",
    ):
        jr, tr = both(j, t, "POST", "/index/i/query", q.encode())
        assert tr == jr, q
    jr, tr = both(j, t, "DELETE", "/index/i/frame/g")
    assert tr == jr
    jr, tr = both(j, t, "GET", "/schema")
    assert tr == jr


def test_jax_written_data_dir_opens_in_the_port(tmp_path):
    jdir = str(tmp_path / "jax")
    j = jax_server(jdir)
    t = TServer(str(tmp_path / "torch"), device="cpu")
    j.open()
    t.open()
    try:
        setup_and_write(j, t)
        want = [http(j.host, "POST", "/index/i/query", q.encode()) for q in READS]
        jfrags = {
            (f.name, s): {
                r: j.holder.fragment("i", f.name, "standard", s)._row_words_host(r)
                for r in range(8)
            }
            for f in j.holder.index("i").frames().values()
            for s in range(N_SLICES)
            if j.holder.fragment("i", f.name, "standard", s) is not None
        }
    finally:
        t.close()
        j.close()
    t2 = TServer(jdir, device="cpu")
    t2.open()
    try:
        for (frame, s), rows in jfrags.items():
            frag = t2.holder.fragment("i", frame, "standard", s)
            for r, words in rows.items():
                got = frag.row_words_host(r)
                if words is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, words)
        got = [http(t2.host, "POST", "/index/i/query", q.encode()) for q in READS]
        assert got == want
    finally:
        t2.close()


def test_port_written_data_dir_opens_in_jax(tmp_path):
    tdir = str(tmp_path / "torch")
    t = TServer(tdir, device="cpu")
    j = jax_server(str(tmp_path / "jax"))
    t.open()
    j.open()
    try:
        setup_and_write(j, t)
        want = [http(t.host, "POST", "/index/i/query", q.encode()) for q in READS[:12]]
    finally:
        j.close()
        t.close()
    j2 = jax_server(tdir)
    j2.open()
    try:
        got = [http(j2.host, "POST", "/index/i/query", q.encode()) for q in READS[:12]]
        assert got == want
    finally:
        j2.close()


def raw(host: str, method: str, path: str, body: bytes = b"", headers=None) -> tuple:
    req = urllib.request.Request(f"http://{host}{path}", data=body if method != "GET" else None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_malformed_protobuf_query_answers_as_jax(servers):
    """ROADMAP fault 3: a QueryRequest that does not parse is a 500 in
    JSON with the generated parser's text, whatever Accept says."""
    j, t = servers
    proto = {"Content-Type": "application/x-protobuf", "Accept": "application/x-protobuf"}
    for s in (j, t):
        assert http(s.host, "POST", "/index/i")[0] == 200
    for body in (b"\x08", b"\x0a\x05ab", b"\x0a\x02\xff\xfe"):
        got = [raw(s.host, "POST", "/index/i/query", body, proto) for s in (j, t)]
        assert got[1] == got[0]
        assert got[0][0] == 500


FRAME_OPTIONS = [
    {"cacheSize": -1}, {"cacheSize": 4294967296}, {"cacheSize": "a"}, {"cacheSize": 1.5},
    {"inverseEnabled": "yes"}, {"inverseEnabled": 1.5},
    {"cacheSize": True}, {"inverseEnabled": 1}, {"cacheSize": 4294967295},
    {"inverseEnabled": "yes", "cacheSize": -1},
]


@pytest.mark.parametrize("options", FRAME_OPTIONS, ids=[json.dumps(o) for o in FRAME_OPTIONS])
def test_frame_options_the_wire_cannot_carry(servers, options):
    """ROADMAP fault 6: options that the protobuf FrameMeta cannot hold
    fail after the frame is made, with the generated message's text;
    the schema stays equal."""
    j, t = servers
    body = json.dumps({"options": options}).encode()
    for s in (j, t):
        assert http(s.host, "POST", "/index/i")[0] == 200
    got = [raw(s.host, "POST", "/index/i/frame/f", body) for s in (j, t)]
    assert got[1] == got[0]
    schema = [http(s.host, "GET", "/schema") for s in (j, t)]
    assert schema[1] == schema[0]


def test_frame_options_fail_alike_in_a_cluster(tmp_path):
    """The same options on a node of a port cluster answer what one JAX
    node answers: the meta is checked before the broadcast."""
    j = jax_server(str(tmp_path / "jax"))
    nodes = [TServer(str(tmp_path / f"n{i}"), device="cpu", cluster_type="http", replicas=2,
                     internal_port=0) for i in range(2)]
    j.open()
    for n in nodes:
        n.open()
    try:
        nodes[0].add_peer(nodes[1].host, nodes[1].internal_host)
        nodes[1].add_peer(nodes[0].host, nodes[0].internal_host)
        for s in (j, nodes[0]):
            assert http(s.host, "POST", "/index/i")[0] == 200
        for options in FRAME_OPTIONS[:5]:
            body = json.dumps({"options": options}).encode()
            name = f"f{FRAME_OPTIONS.index(options)}"
            want = raw(j.host, "POST", f"/index/i/frame/{name}", body)
            assert raw(nodes[0].host, "POST", f"/index/i/frame/{name}", body) == want
    finally:
        for n in nodes:
            n.close()
        j.close()
