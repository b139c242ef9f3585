"""Inverse views through the port against a JAX node, on the CPU, exactly
(JSON bodies and protobuf bytes, errors included):

* ``Bitmap(<columnLabel>=c)``, ``Range`` with a column id and
  ``TopN(inverse=true)`` (with a src and a tanimoto threshold) read the
  inverse view over the inverse slice list;
* ``SetBit``/``ClearBit`` fan out to the inverse view, or write it alone
  with ``view=inverse``; ``/import`` into an inverse-enabled frame;
* ``/slices/max?inverse=true``;
* the same on a 3-node port cluster (2 replicas), whose ``/import``
  sends each inverse slice's half to that slice's owners."""

import json
import urllib.error
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pilosa_tpu.core.fragment as jfr  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.core import fragment as tfr  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402

SW = tbp.SLICE_WIDTH
PROTOBUF = "application/x-protobuf"
BUDGET = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def small_budget(monkeypatch):
    """A dense budget of 16 rows in both packages: the inverse
    fragments are tall and live mostly in the sparse tier."""
    orig = jfr.Fragment.__init__

    def small(self, *a, **kw):
        kw.setdefault("dense_row_budget", BUDGET)
        orig(self, *a, **kw)

    monkeypatch.setattr(jfr.Fragment, "__init__", small)
    monkeypatch.setattr(tfr, "DENSE_ROW_BUDGET", BUDGET)


def http(host, method, path, body=b"", headers=None, timeout=60):
    req = urllib.request.Request(f"http://{host}{path}", data=body if method != "GET" else None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def ask(host, pql):
    """(JSON status and body, protobuf status and raw bytes)."""
    js, jb = http(host, "POST", "/index/i/query", pql.encode())
    body = pb.QueryRequest(Query=pql).SerializeToString()
    ps, pbytes = http(host, "POST", "/index/i/query", body,
                      {"Content-Type": PROTOBUF, "Accept": PROTOBUF})
    return (js, json.loads(jb)), (ps, pbytes)


def max_slices(host, inverse):
    path = "/slices/max?inverse=true" if inverse else "/slices/max"
    js = http(host, "GET", path)
    ps = http(host, "GET", path, headers={"Accept": PROTOBUF})
    return js, ps


def create_schema(host):
    for path, opts in (("/index/i", {"columnLabel": "col"}),
                       ("/index/i/frame/f", {"rowLabel": "pos", "inverseEnabled": True}),
                       ("/index/i/frame/t", {"inverseEnabled": True, "timeQuantum": "YMD"}),
                       ("/index/i/frame/g", {})):
        status, body = http(host, "POST", path, json.dumps({"options": opts}).encode())
        assert status == 200, (path, body)


def bits(seed=2):
    """Frame f: ~60 rows (positions) spread over 3 inverse slices, each on
    a few hundred columns over 3 slices, and a few columns in many rows
    (the tall inverse rows the TopN ranks)."""
    rng = np.random.default_rng(seed)
    row_ids = np.unique(rng.integers(0, 3 * SW, 60))
    rows, cols = [], []
    for r in row_ids:
        k = int(rng.integers(50, 400))
        rows.append(np.full(k, r))
        cols.append(rng.integers(0, 3 * SW, k))
    hot = np.array([5, SW + 9, 2 * SW + 1])
    for c in hot:
        sel = row_ids[rng.random(len(row_ids)) < 0.6]
        rows.append(sel)
        cols.append(np.full(len(sel), c))
    return np.concatenate(rows).astype(np.int64), np.concatenate(cols).astype(np.int64), row_ids


def import_request(frame, slice_i, rows, cols, ts=None):
    req = pb.ImportRequest(Index="i", Frame=frame, Slice=int(slice_i),
                           RowIDs=[int(r) for r in rows], ColumnIDs=[int(c) for c in cols])
    if ts is not None:
        req.Timestamps.extend(int(t) for t in ts)
    return req.SerializeToString()


def post_import(host, frame, rows, cols, ts=None):
    for s in np.unique(cols // SW):
        m = cols // SW == s
        body = import_request(frame, s, rows[m], cols[m], None if ts is None else ts[m])
        status, data = http(host, "POST", "/import", body,
                            {"Content-Type": PROTOBUF, "Accept": PROTOBUF})
        assert status == 200, data


def unix_ns(*ymd_hm):
    return int(datetime(*ymd_hm, tzinfo=timezone.utc).timestamp() * 1e9)


def time_bits():
    rows = np.array([1, 1, 2, SW + 3, 2, 7], np.int64)
    cols = np.array([10, SW + 4, 10, 10, 2 * SW + 8, 11], np.int64)
    ts = np.array([unix_ns(2017, 1, 5), unix_ns(2017, 3, 2), unix_ns(2017, 1, 9),
                   unix_ns(2018, 1, 1), unix_ns(2017, 1, 31, 23, 59), 0], np.int64)
    return rows, cols, ts


def queries(row_ids):
    r0, r1 = int(row_ids[0]), int(row_ids[3])
    return [
        "Bitmap(col=5, frame=f)",
        f"Bitmap(col={SW + 9}, frame=f)",
        "Bitmap(col=123456, frame=f)",
        "Count(Bitmap(col=5, frame=f))",
        f"Count(Intersect(Bitmap(col=5, frame=f), Bitmap(col={2 * SW + 1}, frame=f)))",
        f"Bitmap(pos={r0}, frame=f)",
        f"Count(Intersect(Bitmap(pos={r0}, frame=f), Bitmap(pos={r1}, frame=f)))",
        "TopN(frame=f, inverse=true, n=3)",
        "TopN(frame=f, inverse=true)",
        "TopN(Bitmap(col=5, frame=f), frame=f, inverse=true, n=4)",
        f"TopN(Bitmap(col={SW + 9}, frame=f), frame=f, inverse=true, n=5, tanimotoThreshold=20)",
        f"TopN(Bitmap(pos={r0}, frame=f), frame=f, n=3)",
        'Range(frame=t, col=10, start="2017-01-01T00:00", end="2017-02-01T00:00")',
        'Range(frame=t, col=10, start="2017-01-01T00:00", end="2019-01-01T00:00")',
        f'Range(frame=t, rowID=1, start="2017-01-01T00:00", end="2017-12-01T00:00")',
        'Count(Range(frame=t, col=10, start="2016-01-01T00:00", end="2019-01-01T00:00"))',
        "Bitmap(col=11, frame=t)",
        "Bitmap(col=1, frame=g)",  # no inverse storage: the JAX error
        "Bitmap(col=1, pos=2, frame=f)",
        "TopN(frame=g, inverse=true, n=2)",
    ]


WRITES = [
    "SetBit(frame=f, pos=7, col=5)",
    f"SetBit(frame=f, pos={2 * SW + 4}, col={SW + 9})",
    "ClearBit(frame=f, pos=7, col=5)",
    f"SetBit(frame=f, pos=9, col={SW + 2}, view=inverse)",
    f"SetBit(frame=f, pos=12, col={2 * SW}, view=standard)",
    "SetBit(frame=f, pos=12, col=3, view=bogus)",
    'SetBit(frame=t, rowID=4, col=10, timestamp="2017-01-07T10:00")',
    f"ClearBit(frame=f, pos=9, col={SW + 2}, view=inverse)",
]


def check_reads(want_host, hosts, row_ids, errors=True):
    """Every query's answer on ``hosts`` equals ``want_host``'s; with
    ``errors=False`` the queries the JAX node refuses are left out (a
    port cluster reports a remote leg's error as that leg's failure)."""
    for q in queries(row_ids):
        want = ask(want_host, q)
        if not errors and want[0][0] != 200:
            continue
        for h in hosts:
            assert ask(h, q) == want, (h, q)
    for inverse in (False, True):
        want = max_slices(want_host, inverse)
        for h in hosts:
            assert max_slices(h, inverse) == want, (h, inverse)


def test_inverse_views_match_jax(tmp_path):
    j = JServer(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", anti_entropy_interval=3600,
                polling_interval=3600, cache_flush_interval=3600)
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()
    try:
        rows, cols, row_ids = bits()
        trows, tcols, ts = time_bits()
        for s in (j, t):
            create_schema(s.host)
            post_import(s.host, "f", rows, cols)
            post_import(s.host, "t", trows, tcols, ts)
        inv = t.holder.view("i", "f", "inverse")
        assert sorted(inv.fragment_slices()) == [0, 1, 2]
        assert any(len(inv.fragment(s)._sparse) for s in range(3))
        check_reads(j.host, [t.host], row_ids)
        for w in WRITES:
            assert ask(t.host, w) == ask(j.host, w), w
        check_reads(j.host, [t.host], row_ids)
    finally:
        j.close()
        t.close()


def test_port_cluster_inverse_matches_one_jax_node(tmp_path):
    """Three port nodes, 2 replicas: bits imported through the port's
    client land on the owners of their standard slices and, for the
    inverse view, on the owners of their inverse slices; every node
    answers like one JAX node."""
    j = JServer(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", anti_entropy_interval=3600,
                polling_interval=3600, cache_flush_interval=3600)
    j.open()
    nodes = [TServer(str(tmp_path / f"n{i}"), device="cpu", cluster_type="http", replicas=2,
                     internal_port=0, polling_interval=3600) for i in range(3)]
    try:
        rows, cols, row_ids = bits(seed=6)
        trows, tcols, ts = time_bits()
        create_schema(j.host)
        post_import(j.host, "f", rows, cols)
        post_import(j.host, "t", trows, tcols, ts)
        for s in nodes:
            s.open()
        for s in nodes:
            for o in nodes:
                if o is not s:
                    s.add_peer(o.host, o.internal_host)
        create_schema(nodes[0].host)  # reaches the others by broadcast
        client = InternalClient(nodes[1].host)
        client.import_bits("i", "f", rows, cols)
        client.import_bits("i", "t", trows, tcols, ts)
        cluster = nodes[0].cluster
        for s in nodes:
            s.tick_max_slices()
            inv = s.holder.view("i", "f", "inverse")
            held = inv.fragment_slices() if inv is not None else set()
            owned = {k for k in range(3) if cluster.owns_fragment(s.host, "i", k)}
            assert held == owned, (s.host, held, owned)
        check_reads(j.host, [s.host for s in nodes], row_ids, errors=False)
        for k, w in enumerate(WRITES):
            if "bogus" not in w:
                assert ask(nodes[k % 3].host, w) == ask(j.host, w), w
        check_reads(j.host, [s.host for s in nodes], row_ids, errors=False)
    finally:
        for s in nodes:
            s.close()
        j.close()
