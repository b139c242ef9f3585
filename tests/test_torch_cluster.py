"""The port's cluster against the JAX package: placement is
hash-identical; a 3-node port cluster (static and http types, 2
replicas) answers Count/Bitmap/TopN/TopN(src)/SetBit exactly as one JAX
node over the same data, in JSON and protobuf (byte for byte); closing
one node changes no answer; and a mixed static cluster of one JAX node
and one port node answers identically from either node."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.cluster import topology as jtopo  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.client import InternalClient as JClient  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.cluster import broadcast as tbc  # noqa: E402
from pilosa_tpu_torch.cluster import topology as ttopo  # noqa: E402
from pilosa_tpu_torch.net import wire  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient as TClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402

SW = 1 << 20
N_SLICES = 5
PROTOBUF = "application/x-protobuf"


# --- placement ---------------------------------------------------------------


@pytest.mark.parametrize("n_nodes", range(1, 6))
@pytest.mark.parametrize("replicas", range(1, 4))
def test_placement_matches_jax(n_nodes, replicas):
    hosts = [f"10.0.0.{i}:10101" for i in (7, 3, 12, 1, 5)[:n_nodes]]
    j = jtopo.Cluster(replica_n=replicas)
    t = ttopo.Cluster(replica_n=replicas)
    for h in hosts:
        j.add_node(h)
        t.add_node(h)
    assert t.hosts() == [n.host for n in j.nodes]
    for index in ("i", "users", "x" * 40):
        for s in range(300):
            assert t.partition(index, s) == j.partition(index, s)
            assert [n.host for n in t.fragment_nodes(index, s)] == [
                n.host for n in j.fragment_nodes(index, s)
            ]
            assert t.is_write_owner(hosts[0], index, s) == j.is_write_owner(hosts[0], index, s)
        for h in hosts:
            assert t.owns_slices(index, 299, h) == j.owns_slices(index, 299, h)
        some = list(range(0, 300, 7))
        alive = set(hosts[1:])
        assert t.split_by_owner(index, some, alive) == j.split_by_owner(index, some, alive)


def test_hash_functions_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        data = rng.bytes(int(rng.integers(0, 40)))
        assert ttopo.fnv64a(data) == jtopo.fnv64a(data)
        key, n = int(rng.integers(0, 2**63)) * 2 + 1, int(rng.integers(1, 100))
        assert ttopo.jump_hash(key, n) == jtopo.jump_hash(key, n)
    assert ttopo.new_cluster(3).hosts() == [n.host for n in jtopo.new_cluster(3).nodes]


def test_broadcast_envelope_matches_jax():
    from pilosa_tpu.cluster import broadcast as jbc

    msgs = [
        (wire.CreateSliceMessage(Index="i", Slice=7), pb.CreateSliceMessage(Index="i", Slice=7)),
        (wire.CreateIndexMessage(Index="i", Meta=wire.IndexMeta(ColumnLabel="c")),
         pb.CreateIndexMessage(Index="i", Meta=pb.IndexMeta(ColumnLabel="c"))),
        (wire.DeleteIndexMessage(Index="i"), pb.DeleteIndexMessage(Index="i")),
        (wire.CreateFrameMessage(Index="i", Frame="f", Meta=wire.FrameMeta(CacheSize=9)),
         pb.CreateFrameMessage(Index="i", Frame="f", Meta=pb.FrameMeta(CacheSize=9))),
        (wire.DeleteFrameMessage(Index="i", Frame="f"),
         pb.DeleteFrameMessage(Index="i", Frame="f")),
    ]
    for ours, theirs in msgs:
        data = tbc.marshal_message(ours)
        assert data == jbc.marshal_message(theirs)
        assert tbc.unmarshal_message(data) == ours
    for bad in (b"", b"\x09abc"):
        with pytest.raises(ValueError):
            tbc.unmarshal_message(bad)
    assert tbc.StaticNodeSet(["a:1", "b:2"]).nodes() == ["a:1", "b:2"]
    tbc.NopBroadcaster().send_sync(msgs[0][0])


# --- HTTP helpers ------------------------------------------------------------


def http(host: str, method: str, path: str, body: bytes = b"", headers=None, timeout=5):
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None,
        method=method, headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def ask_json(host: str, pql: str, timeout=5):
    status, data = http(host, "POST", "/index/i/query", pql.encode(), timeout=timeout)
    return status, json.loads(data)


def ask_protobuf(host: str, pql: str, timeout=5):
    """The raw QueryResponse bytes: the two packages must agree byte for byte."""
    body = pb.QueryRequest(Query=pql).SerializeToString()
    return http(host, "POST", "/index/i/query", body,
                {"Content-Type": PROTOBUF, "Accept": PROTOBUF}, timeout=timeout)


def jax_server(path: str, cluster=None) -> JServer:
    return JServer(
        data_dir=path, host="127.0.0.1:0", cluster=cluster,
        anti_entropy_interval=3600, polling_interval=3600, cache_flush_interval=3600,
    )


B = "Bitmap(frame=f, rowID={})"
READS = [
    f"Count({B.format(0)})",
    f"Count(Intersect({B.format(2)}, {B.format(5)}))",
    f"Count(Union({B.format(0)}, {B.format(1)}, {B.format(7)}))",
    f"Count(Difference({B.format(6)}, {B.format(3)}))",
    f"Count(Xor({B.format(4)}, {B.format(2)}))",
    "Count(Bitmap(frame=f, rowID=99))",
    "Bitmap(frame=g, rowID=1)",
    f"Intersect({B.format(1)}, {B.format(2)})",
    f"Union(Bitmap(frame=g, rowID=2), Bitmap(frame=g, rowID=3)) Count({B.format(3)})",
    "TopN(frame=f, n=3)",
    "TopN(frame=f)",
    f"TopN({B.format(0)}, frame=f, n=3)",
    f"TopN(Intersect({B.format(6)}, {B.format(7)}), frame=f, n=4)",
    "TopN(frame=f, n=2, ids=[1, 3, 5])",
    f"TopN({B.format(5)}, frame=f, n=5, tanimotoThreshold=20)",
    "TopN(Bitmap(frame=g, rowID=1), frame=g, n=2)",
    "Count()",
]


def seeded_writes(seed: int = 0) -> list[str]:
    """SetBit queries: frame f rows 0-7 with row-dependent density over
    N_SLICES slices, frame g a few sparse bits (edge words included)."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(400):
        r = int(rng.integers(0, 8))
        if rng.random() < (r + 1) / 8:
            c = int(rng.integers(0, N_SLICES * SW))
            calls.append(f"SetBit(frame=f, rowID={r}, columnID={c})")
    for c in (31, SW - 1, 2 * SW + 31, N_SLICES * SW - 1):
        calls.append(f"SetBit(frame=g, rowID=1, columnID={c})")
    for _ in range(20):
        r, c = int(rng.integers(0, 4)), int(rng.integers(0, N_SLICES * SW))
        calls.append(f"SetBit(frame=g, rowID={r}, columnID={c})")
    return [" ".join(calls[i : i + 40]) for i in range(0, len(calls), 40)]


def seeded_import(seed: int = 1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 8, 3000), rng.integers(0, N_SLICES * SW, 3000)


def create_schema(host: str) -> None:
    for path, body in (("/index/i", b""), ("/index/i/frame/f", b'{"options": {"cacheSize": 100}}'),
                       ("/index/i/frame/g", b"")):
        assert http(host, "POST", path, body)[0] == 200, path


def load_reference(j: JServer) -> None:
    """The single JAX node every cluster is held against."""
    create_schema(j.host)
    for q in seeded_writes():
        assert ask_json(j.host, q)[0] == 200
    rows, cols = seeded_import()
    j.holder.frame("i", "f").import_bulk(rows, cols)


def assert_same_answers(hosts: list[str], ref: str, queries=READS, timeout=5) -> None:
    for q in queries:
        want_json, want_pb = ask_json(ref, q, timeout), ask_protobuf(ref, q, timeout)
        for h in hosts:
            assert ask_json(h, q, timeout) == want_json, (h, q)
            assert ask_protobuf(h, q, timeout) == want_pb, (h, q)


@pytest.fixture
def reference(tmp_path):
    j = jax_server(str(tmp_path / "ref"))
    j.open()
    try:
        load_reference(j)
        yield j
    finally:
        j.close()


def port_cluster(path, cluster_type: str, replicas: int = 2, n: int = 3) -> list[TServer]:
    nodes = [
        TServer(str(path / f"n{i}"), device="cpu", cluster_type=cluster_type,
                replicas=replicas, internal_port=0, polling_interval=3600)
        for i in range(n)
    ]
    for s in nodes:
        s.open()
    for s in nodes:
        for o in nodes:
            if o is not s:
                s.add_peer(o.host, o.internal_host)
    return nodes


def load_port_cluster(nodes: list[TServer], cluster_type: str) -> None:
    if cluster_type == "http":
        create_schema(nodes[0].host)  # reaches the others by broadcast
        for s in nodes:
            assert [f["name"] for f in s.holder.schema()[0]["frames"]] == ["f", "g"]
    else:
        for s in nodes:
            create_schema(s.host)
    for k, q in enumerate(seeded_writes()):
        assert ask_json(nodes[k % len(nodes)].host, q)[0] == 200
    rows, cols = seeded_import()
    sent = TClient(nodes[1].host, timeout=5).import_bits("i", "f", rows, cols)
    assert sent == list(range(N_SLICES))
    for s in nodes:
        s.tick_max_slices()
        assert s.holder.index("i").max_slice() == N_SLICES - 1


@pytest.mark.parametrize("cluster_type", ["static", "http"])
def test_port_cluster_answers_as_one_jax_node(tmp_path, reference, cluster_type):
    nodes = port_cluster(tmp_path, cluster_type)
    try:
        load_port_cluster(nodes, cluster_type)
        hosts = [s.host for s in nodes]
        # Each slice lives on exactly its two owners.
        for sl in range(N_SLICES):
            owners = {n.host for n in nodes[0].cluster.fragment_nodes("i", sl)}
            holding = {s.host for s in nodes if s.holder.fragment("i", "f", "standard", sl)}
            assert holding == owners and len(owners) == 2
        assert_same_answers(hosts, reference.host)
        # Writes through each node reach every owner; the answers follow.
        writes = [
            "SetBit(frame=f, rowID=3, columnID=17)",
            "SetBit(frame=f, rowID=3, columnID=17)",
            f"ClearBit(frame=f, rowID=0, columnID={N_SLICES * SW - 1})",
            f"SetBit(frame=f, rowID=0, columnID={N_SLICES * SW - 1})",
            f"ClearBit(frame=f, rowID=0, columnID={N_SLICES * SW - 1})",
            f"SetBit(frame=g, rowID=9, columnID={3 * SW + 5})",
        ]
        for k, q in enumerate(writes):
            assert ask_json(hosts[k % 3], q) == ask_json(reference.host, q), q
        assert_same_answers(hosts, reference.host, READS[:3] + ["Bitmap(frame=g, rowID=9)"])
        # Service routes.
        status, data = http(hosts[0], "GET", "/hosts")
        assert status == 200 and [h["host"] for h in json.loads(data)] == sorted(hosts)
        status, data = http(hosts[2], "GET", "/fragment/nodes?index=i&slice=3")
        assert [n["host"] for n in json.loads(data)] == [
            n.host for n in nodes[0].cluster.fragment_nodes("i", 3)
        ]
        assert http(hosts[2], "GET", "/fragment/nodes?index=i&slice=x")[0] == 400
        status, data = http(hosts[1], "GET", "/slices/max", headers={"Accept": PROTOBUF})
        assert wire.MaxSlicesResponse.decode(data).MaxSlices == {"i": N_SLICES - 1}
    finally:
        for s in nodes:
            s.close()


def test_closing_a_node_changes_no_answer(tmp_path, reference):
    nodes = port_cluster(tmp_path, "http")
    try:
        load_port_cluster(nodes, "http")
        hosts = [s.host for s in nodes]
        nodes[2].close()
        assert_same_answers(hosts[:2], reference.host)
        with pytest.raises(OSError):
            TClient(hosts[2], timeout=2).schema()
    finally:
        for s in nodes:
            s.close()


def test_no_replica_left_fails_with_the_slices(tmp_path):
    nodes = port_cluster(tmp_path, "http", replicas=1, n=2)
    try:
        load_port_cluster(nodes, "http")
        lost = nodes[0].cluster.owns_slices("i", N_SLICES - 1, nodes[1].host)
        nodes[1].close()
        status, body = ask_json(nodes[0].host, f"Count({B.format(0)})")
        assert status == 500 and body["error"].startswith(f"slices unavailable: {lost}")
    finally:
        for s in nodes:
            s.close()


def test_mixed_jax_and_port_cluster(tmp_path, reference):
    """One JAX node and one port node in a static cluster (replicas=1):
    writes, imports and reads cross between the two implementations."""
    j = jax_server(str(tmp_path / "jax"), cluster=jtopo.Cluster(replica_n=1))
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()
    try:
        j.cluster.add_node(t.host)
        t.add_peer(j.host)
        assert t.cluster.hosts() == [n.host for n in j.cluster.nodes]
        owners = {s: j.cluster.fragment_nodes("i", s)[0].host for s in range(N_SLICES)}
        assert set(owners.values()) == {j.host, t.host}  # both nodes own slices
        create_schema(j.host)
        create_schema(t.host)
        for k, q in enumerate(seeded_writes()):
            assert ask_json((j.host, t.host)[k % 2], q)[0] == 200
        rows, cols = seeded_import()
        half = cols < 3 * SW
        # The port's client sends slices 0-2, the JAX client slices 3-4.
        TClient(t.host, timeout=5).import_bits("i", "f", rows[half], cols[half])
        jc = JClient(j.host, timeout=5)
        for s in range(3, N_SLICES):
            sel = (cols // SW) == s
            jc.import_bits("i", "f", s, (rows[sel].astype(np.uint64), cols[sel].astype(np.uint64)))
        for s in range(N_SLICES):
            owner = j if owners[s] == j.host else t
            other = t if owner is j else j
            assert owner.holder.fragment("i", "f", "standard", s) is not None
            assert other.holder.fragment("i", "f", "standard", s) is None
        j._tick_max_slices()
        t.tick_max_slices()
        assert_same_answers([t.host], reference.host)
        # A fault of the JAX package (ROADMAP.md C): its TopN reduce
        # cannot take a remote leg without pairs (an empty QueryResult
        # decodes as 0), so a TopN that is empty on the port node fails
        # when the JAX node coordinates.  The port's reduce takes it.
        empty_topn = f"TopN(Intersect({B.format(6)}, {B.format(7)}), frame=f, n=4)"
        assert ask_json(reference.host, empty_topn) == (200, {"results": [[]]})
        assert ask_json(j.host, empty_topn) == (500, {"error": "'int' object is not iterable"})
        assert_same_answers([j.host], reference.host, [q for q in READS if q != empty_topn])
        for k, q in enumerate(["SetBit(frame=f, rowID=3, columnID=17)",
                               f"SetBit(frame=f, rowID=7, columnID={4 * SW + 9})",
                               f"ClearBit(frame=f, rowID=7, columnID={4 * SW + 9})"]):
            assert ask_json((t.host, j.host)[k % 2], q) == ask_json(reference.host, q), q
        # Exact reads only: between its recalculations a rank cache
        # ranks TopN candidates by counts that may predate the writes.
        assert_same_answers([j.host, t.host], reference.host, READS[:3] + [B.format(7)])
    finally:
        t.close()
        j.close()


def test_gossip_and_unknown_cluster_types_raise(tmp_path):
    # The gossip type is ported (cluster/gossip.py): it builds, its node
    # set comes at open; an unknown type still raises.
    s = TServer(str(tmp_path), device="cpu", cluster_type="gossip")
    assert s.cluster_type == "gossip" and s.node_set is None
    with pytest.raises(ValueError):
        TServer(str(tmp_path), device="cpu", cluster_type="nope")


# --- BSI fields over the cluster ---------------------------------------------

# The JAX node compiles a program per BSI query shape inside the request.
BSI_TIMEOUT = 120
RANGE_FRAME = b'{"options": {"rangeEnabled": true}}'
FIELD_V = b'{"min": -1000, "max": 1000}'
BSI_READS = [
    "Count(Range(frame=r, v > 17))",
    "Count(Range(frame=r, v <= -3))",
    "Count(Range(frame=r, v == 0))",
    "Count(Range(frame=r, v != 5))",
    "Count(Range(frame=r, v >< [-100, 250]))",
    "Sum(frame=r, field=v)",
    "Min(frame=r, field=v)",
    "Max(frame=r, field=v)",
    "Sum(Bitmap(frame=r, rowID=1), frame=r, field=v)",
    "Min(Range(frame=r, v > 0), frame=r, field=v)",
    "Max(Bitmap(frame=r, rowID=9), frame=r, field=v)",
    "Count(Intersect(Bitmap(frame=r, rowID=0), Range(frame=r, v >< [-500, 500])))",
    "Range(frame=r, v > 900)",
]


def seeded_values(seed: int = 2):
    """Columns over every slice with values in [-1000, 1000], the bounds
    and 0 among them; bitmap rows 0-1 over the same slices."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(N_SLICES * SW, size=600, replace=False)
    vals = rng.integers(-1000, 1001, size=600)
    vals[:3] = -1000, 1000, 0
    return cols, vals, rng.integers(0, 2, 2000), rng.integers(0, N_SLICES * SW, 2000)


def load_bsi_reference(j: JServer) -> None:
    cols, vals, rows, bcols = seeded_values()
    assert http(j.host, "POST", "/index/i")[0] == 200
    assert http(j.host, "POST", "/index/i/frame/r", RANGE_FRAME)[0] == 200
    assert http(j.host, "POST", "/index/i/frame/r/field/v", FIELD_V)[0] == 200
    f = j.holder.frame("i", "r")
    f.import_value("v", cols, vals)
    f.import_bulk(rows, bcols)


def test_port_cluster_bsi_answers_as_one_jax_node(tmp_path):
    """Field creation on one node reaches the others; /import-value
    through the client reaches every owner; Sum/Min/Max/Count(Range)
    answer from every node as one JAX node does, in JSON and protobuf."""
    j = jax_server(str(tmp_path / "ref"))
    j.open()
    nodes = port_cluster(tmp_path, "http")
    try:
        load_bsi_reference(j)
        h0 = nodes[0].host
        assert http(h0, "POST", "/index/i")[0] == 200
        assert http(h0, "POST", "/index/i/frame/r", RANGE_FRAME)[0] == 200
        assert http(h0, "POST", "/index/i/frame/r/field/v", FIELD_V)[0] == 200
        assert http(h0, "POST", "/index/i/frame/r/field/w", b'{"min": 0, "max": 3}')[0] == 200
        dup = http(nodes[1].host, "POST", "/index/i/frame/r/field/w", b'{"min": 0, "max": 3}')
        assert dup[0] == 409
        assert http(nodes[2].host, "DELETE", "/index/i/frame/r/field/w")[0] == 200
        for s in nodes:
            assert TClient(s.host, timeout=60).frame_fields("i", "r") == [
                {"name": "v", "type": "int", "min": -1000, "max": 1000}]
            assert s.holder.frame("i", "r").view("field_w") is None
        cols, vals, rows, bcols = seeded_values()
        client = TClient(nodes[1].host, timeout=60)
        assert client.import_values("i", "r", "v", cols, vals) == list(range(N_SLICES))
        client.import_bits("i", "r", rows, bcols)
        for sl in range(N_SLICES):
            owners = {n.host for n in nodes[0].cluster.fragment_nodes("i", sl)}
            holding = {s.host for s in nodes if s.holder.fragment("i", "r", "field_v", sl)}
            assert holding == owners
        for s in nodes:
            s.tick_max_slices()
        hosts = [s.host for s in nodes]
        assert_same_answers(hosts, j.host, BSI_READS, BSI_TIMEOUT)
        # An overwrite through the cluster, then the answers again.
        client.import_values("i", "r", "v", cols[:50], -vals[:50])
        j.holder.frame("i", "r").import_value("v", cols[:50], -vals[:50])
        assert_same_answers(hosts, j.host, BSI_READS[5:9], BSI_TIMEOUT)
        with pytest.raises(Exception):
            client.import_values("i", "r", "v", [1], [1001])  # out of range on every owner
        nodes[2].close()
        assert_same_answers(hosts[:2], j.host, BSI_READS[5:8], BSI_TIMEOUT)
    finally:
        for s in nodes:
            s.close()
        j.close()


def test_mixed_cluster_sums_negative_values(tmp_path):
    """One JAX node and one port node (static, replicas=1): the field
    created on the JAX node reaches the port node; values imported to
    each slice's owner; Sum/Min/Max with negative values reduce equally
    whichever node coordinates."""
    ref = jax_server(str(tmp_path / "ref"))
    j = jax_server(str(tmp_path / "jax"), cluster=jtopo.Cluster(replica_n=1))
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    for s in (ref, j, t):
        s.open()
    try:
        load_bsi_reference(ref)
        j.cluster.add_node(t.host)
        t.add_peer(j.host)
        for s in (j, t):
            assert http(s.host, "POST", "/index/i")[0] == 200
            assert http(s.host, "POST", "/index/i/frame/r", RANGE_FRAME)[0] == 200
        assert http(j.host, "POST", "/index/i/frame/r/field/v", FIELD_V)[0] == 200
        assert TClient(t.host, timeout=60).frame_fields("i", "r") == [
            {"name": "v", "type": "int", "min": -1000, "max": 1000}]
        cols, vals, rows, bcols = seeded_values()
        TClient(t.host, timeout=60).import_values("i", "r", "v", cols, vals)
        TClient(t.host, timeout=60).import_bits("i", "r", rows, bcols)
        owners = {s: j.cluster.fragment_nodes("i", s)[0].host for s in range(N_SLICES)}
        assert set(owners.values()) == {j.host, t.host}
        j._tick_max_slices()
        t.tick_max_slices()
        sums = [q for q in BSI_READS if q.startswith(("Sum", "Min", "Max"))]
        assert_same_answers([t.host, j.host], ref.host, sums, BSI_TIMEOUT)
        status, data = ask_json(t.host, "Sum(frame=r, field=v)", BSI_TIMEOUT)
        assert status == 200 and data["results"][0]["value"] == int(vals.sum())
    finally:
        for s in (t, j, ref):
            s.close()
