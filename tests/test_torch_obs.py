"""The port's observability against the JAX package's.

* ``obs/stats.py``, ``obs/trace.py`` and ``obs/prom.py`` are copies:
  driven with the same call sequences, the port's and the JAX package's
  give the same snapshots, the same datagrams and the same rendered
  bytes.
* The same query on a JAX node (admission off) and on a port node leaves
  the same tree of span names.
* A query on a 3-node port cluster leaves one trace on its coordinator
  that covers every node.
* ``/metrics`` parses, and the families a JAX node renders that the port
  does not are exactly the documented ones (``METRICS_LEFT_OUT``).
* The debug routes answer as the JAX node's.
"""

import json
import re
import socket
import tarfile
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu.obs import prom as jprom  # noqa: E402
from pilosa_tpu.obs import stats as jstats  # noqa: E402
from pilosa_tpu.obs import trace as jtrace  # noqa: E402
from pilosa_tpu_torch.net import handler as thandler  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.obs import prom as tprom  # noqa: E402
from pilosa_tpu_torch.obs import stats as tstats  # noqa: E402
from pilosa_tpu_torch.obs import trace as ttrace  # noqa: E402

SW = 1 << 20


def raw(host: str, method: str, path: str, body: bytes = b""):
    req = urllib.request.Request(
        f"http://{host}{path}", data=body if method != "GET" else None, method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---------------------------------------------------------------------------
# the copies: stats, prom, trace
# ---------------------------------------------------------------------------


def drive_stats(c) -> None:
    """One call sequence over a client and its tagged children."""
    idx = c.with_tags("index:i")
    frag = idx.with_tags("frame:f", "view:standard").with_tags("slice:3")
    c.count("queries")
    c.count("queries", 4)
    idx.count("setBit")
    frag.count("setBit", 2)
    frag.count_with_custom_tags("exec.class", 1, ["class:point", "tenant:t1"])
    c.gauge("threads", 7)
    idx.gauge("maxSlice", 12.0)
    frag.gauge("rows", 3)
    c.set("version", "1.2.3")
    for v in (1.0, 2.0, 3.0, 4.0, 10.0, 0.5, 7.25):
        c.histogram("http.POST./index/i/query", v)
        frag.timing("snapshot", v / 10)
    weird = c.with_tags("odd tag", "a:b:c", "2x:y")
    weird.count("9lives-metric.name")


@pytest.mark.parametrize("store", ["expvar", "multi"])
def test_stats_snapshots_match_jax(store):
    def make(mod):
        if store == "expvar":
            return mod.ExpvarStatsClient()
        return mod.MultiStatsClient([mod.NopStatsClient(), mod.ExpvarStatsClient()])

    j, t = make(jstats), make(tstats)
    drive_stats(j)
    drive_stats(t)
    assert t.snapshot() == j.snapshot()
    assert t.tags() == j.tags()
    assert t.with_tags("b:1", "a:2").tags() == j.with_tags("b:1", "a:2").tags()


def test_histogram_reservoir_matches_jax():
    j, t = jstats.ExpvarStatsClient(), tstats.ExpvarStatsClient()
    for k in range(5000):
        v = (k * 7919) % 1000 / 10.0
        j.histogram("h", v)
        t.histogram("h", v)
    assert t.snapshot() == j.snapshot()


def test_statsd_datagrams_match_jax():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(5)
    host = f"127.0.0.1:{sock.getsockname()[1]}"
    got = {}
    try:
        for name, mod in (("jax", jstats), ("port", tstats)):
            c = mod.StatsDClient(host)
            drive_stats(c)
            c.with_tags("k:" + "v" * 2000).count("big")  # the datagram clamp
            c.count("x" * 3000)
            out = []
            try:
                while True:
                    out.append(sock.recv(65536))
                    sock.settimeout(0.5)
            except TimeoutError:
                pass
            sock.settimeout(5)
            got[name] = out
            c.close()
    finally:
        sock.close()
    assert len(got["jax"]) == 26
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("service", ["", "nop", "none", "expvar", "statsd", "bogus"])
def test_new_stats_client_matches_jax(service):
    def make(mod):
        try:
            return type(mod.new_stats_client(service, "127.0.0.1:9")).__name__
        except ValueError as e:
            return f"ValueError: {e}"

    assert make(tstats) == make(jstats)


def test_prom_render_matches_jax():
    j, t = jstats.ExpvarStatsClient(), tstats.ExpvarStatsClient()
    drive_stats(j)
    drive_stats(t)
    extra = {"uptime_seconds": 12.5, "threads": 9}
    assert tprom.render(t.snapshot(), extra_gauges=extra) == jprom.render(
        j.snapshot(), extra_gauges=extra
    )
    assert tprom.render({}) == jprom.render({})
    assert tprom.CONTENT_TYPE == jprom.CONTENT_TYPE
    for key in ("setBit[frame:f,index:i]", "x[tag]", "a[b:c,]", "plain"):
        assert tprom.parse_key(key) == jprom.parse_key(key)


def _shape(record: dict) -> list:
    """A trace record without its ids and times: (name, parent's position,
    tags) per span, in order."""
    pos = {s["span_id"]: i for i, s in enumerate(record["spans"])}
    return [(s["name"], pos.get(s["parent_id"]), s["tags"]) for s in record["spans"]]


def drive_tracer(mod, capacity: int = 3):
    tr = mod.Tracer(capacity=capacity)
    out = []
    for k in range(5):
        root = tr.start_trace("query", index="i", k=k)
        tok = root.activate()
        with tr.span("parse"):
            pass
        with tr.span("execute") as ex:
            ex.annotate(calls=2)
            try:
                with tr.span("call.Count", index="i"):
                    raise KeyError("x")
            except KeyError:
                pass
            child = tr.span("rpc.execute", node="h:1")
            headers = tr.remote_headers(child)
            assert set(headers) == {mod.TRACE_HEADER, mod.SPAN_HEADER}
            child.finish()
        root.deactivate(tok)
        out.append(tr.finish_root(root))
    lone = tr.span("orphan")  # outside any trace: never retained
    lone.finish()
    return tr, out


def test_tracer_records_match_jax():
    jt, jrecs = drive_tracer(jtrace)
    tt, trecs = drive_tracer(ttrace)
    assert [_shape(r) for r in trecs] == [_shape(r) for r in jrecs]
    assert [_shape(r) for r in tt.traces()] == [_shape(r) for r in jt.traces()]
    assert len(tt.traces()) == 3
    assert tt.late_spans == jt.late_spans
    for tr_, jr in zip(trecs, jrecs):
        assert ttrace.stage_breakdown(tr_).keys() == jtrace.stage_breakdown(jr).keys()
        # Same input record, same breakdown and payload.
        assert ttrace.stage_breakdown(jr) == jtrace.stage_breakdown(jr)
        assert ttrace.Tracer.export_payload(jr) == jtrace.Tracer.export_payload(jr)
    assert (ttrace.TRACE_HEADER, ttrace.SPAN_HEADER, ttrace.SPANS_HEADER) == (
        jtrace.TRACE_HEADER, jtrace.SPAN_HEADER, jtrace.SPANS_HEADER)
    assert ttrace.MAX_SPANS_PER_TRACE == jtrace.MAX_SPANS_PER_TRACE
    assert ttrace.MAX_EXPORT_SPANS == jtrace.MAX_EXPORT_SPANS


def test_tracer_absorbs_a_jax_nodes_spans():
    """A remote leg's exported spans (JAX's export format) land in the
    port tracer's open trace, and junk payloads are ignored alike."""
    jt, jrecs = drive_tracer(jtrace)
    for mod in (ttrace, jtrace):
        tr = mod.Tracer()
        root = tr.start_trace("query", trace_id=jrecs[0]["trace_id"])
        tr.absorb(jtrace.Tracer.export_payload(jrecs[0]))
        tr.absorb("not json")
        tr.absorb({"trace_id": "nope", "spans": []})
        rec = tr.finish_root(root)
        assert [s["name"] for s in rec["spans"][1:]] == [s["name"] for s in jrecs[0]["spans"]]
        assert tr.late_spans == 1


def test_nop_tracer_matches_jax():
    for mod in (ttrace, jtrace):
        nt = mod.NOP_TRACER
        root = nt.start_trace("q")
        assert root is mod.NOP_SPAN
        with nt.span("x") as sp:
            sp.annotate(a=1)
        assert nt.finish_root(root) is None
        assert nt.traces() == [] and nt.remote_headers(root) == {}


# ---------------------------------------------------------------------------
# span trees of the same query on both servers
# ---------------------------------------------------------------------------


def _tree(record: dict) -> list[str]:
    by = {s["span_id"]: s for s in record["spans"]}

    def path(s):
        names = []
        while s is not None:
            names.append(s["name"])
            s = by.get(s["parent_id"])
        return "/".join(reversed(names))

    paths = (path(s) for s in record["spans"])
    return sorted(p for p in paths if not NOT_PORTED_SPANS & set(p.split("/")))


B = "Bitmap(frame=f, rowID={})"
TRACED = [
    f"Count(Intersect({B.format(1)}, {B.format(2)}))",
    f"Count(Union({B.format(1)}, {B.format(2)}, {B.format(3)}))",
    B.format(2),
    f"Difference({B.format(2)}, {B.format(1)})",
    "TopN(frame=f, n=2)",
    f"TopN({B.format(2)}, frame=f, n=2)",
    f"Count({B.format(1)}) TopN(frame=f, n=1)",
    "SetBit(frame=f, rowID=4, columnID=9)",
    "ClearBit(frame=f, rowID=4, columnID=9)",
    'SetRowAttrs(frame=f, rowID=1, a="b")',
    "SetColumnAttrs(id=3, a=1)",
]

# Spans of JAX modules the port does not have (quorum replication).
NOT_PORTED_SPANS = {"replicate", "replicate.read", "admission"}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    j = JServer(str(d / "jax"), host="127.0.0.1:0", admission=False, stats=jstats.ExpvarStatsClient(),
                anti_entropy_interval=3600, polling_interval=3600, cache_flush_interval=3600)
    t = TServer(str(d / "torch"), device="cpu", stats=tstats.ExpvarStatsClient())
    j.open()
    t.open()
    try:
        for s in (j, t):
            assert raw(s.host, "POST", "/index/i")[0] == 200
            assert raw(s.host, "POST", "/index/i/frame/f")[0] == 200
            bits = " ".join(
                f"SetBit(frame=f, rowID={r}, columnID={c})"
                for r, c in ((1, 3), (2, 3), (2, SW + 4), (3, 2 * SW + 1), (1, 2 * SW + 1))
            )
            assert raw(s.host, "POST", "/index/i/query", bits.encode())[0] == 200
        yield j, t
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("pql", TRACED)
def test_span_tree_matches_jax(pair, pql):
    trees = []
    for s in pair:
        status, _ = raw(s.host, "POST", "/index/i/query", pql.encode())
        rec = s.tracer.traces()[-1]
        assert rec["spans"][0]["tags"]["query"] == pql
        trees.append((status, _tree(rec)))
    assert trees[1] == trees[0]


# ---------------------------------------------------------------------------
# /metrics, /debug/vars and the families left out
# ---------------------------------------------------------------------------

_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*\})? -?[0-9.e+\-]+(\.\d+)?$|^.* [+-]?Inf$'
)


def parse_exposition(text: str) -> dict[str, str]:
    """Family -> type; every non-comment line must be a sample of a
    family declared before it."""
    fams: dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ")
            assert name not in fams, f"family declared twice: {name}"
            fams[name] = typ
            continue
        assert _SAMPLE.match(line), line
        name = re.split(r"[{ ]", line, maxsplit=1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        assert name in fams or base in fams, line
    return fams


def test_metrics_parse_and_leave_out_only_the_documented_families(pair):
    j, t = pair
    for pql in TRACED:
        for s in pair:
            raw(s.host, "POST", "/index/i/query", pql.encode())
    fams = {}
    for s in pair:
        status, body = raw(s.host, "GET", "/metrics")
        assert status == 200
        fams[s] = parse_exposition(body.decode())
    jax_only = set(fams[j]) - set(fams[t])
    unexplained = [f for f in jax_only if not f.startswith(tuple(thandler.METRICS_LEFT_OUT))]
    assert unexplained == []
    for fam in ("pilosa_exec_coalesce_launches_total", "pilosa_setBit_total",
                "pilosa_query_latency_ms", "pilosa_http_latency_ms",
                "pilosa_exec_launch_launches", "pilosa_ingest_wal_appends_total",
                "pilosa_device_health_degraded", "pilosa_device_watchdogTrips"):
        assert fam in fams[t], fam
    # A family both render has one type.  (Which of the prefetcher's
    # hit/miss counters appear depends on its timing, in both packages.)
    for fam in set(fams[t]) & set(fams[j]):
        assert fams[t][fam] == fams[j][fam], fam


def test_left_out_families_are_documented():
    import pathlib

    readme = (pathlib.Path(__file__).resolve().parents[1] / "README.md").read_text()
    for prefix in thandler.METRICS_LEFT_OUT:
        assert prefix in readme, prefix


def test_debug_vars_match_jax_keys(pair):
    j, t = pair
    docs = [json.loads(raw(s.host, "GET", "/debug/vars")[1]) for s in pair]
    assert set(docs[1]) == set(docs[0])
    assert set(docs[1]["stats"]) == set(docs[0]["stats"])
    assert docs[1]["stats"]["counts"]["setBit[frame:f,index:i,slice:0,view:standard]"] >= 2


@pytest.mark.parametrize(
    "path",
    ["/debug/traces?min_ms=x", "/debug/traces?min_ms=100000", "/debug/profile?seconds=x",
     "/debug/pprof/nope", "/debug/pprof/heap", "/debug/pprof/heap?start=1",
     "/debug/pprof/heap?stop=1", "/debug/perf", "/debug/stacks", "/debug/pprof",
     "/debug/pprof/goroutine", "/debug/pprof/profile?seconds=0.05"],
)
def test_debug_routes_answer_as_jax(pair, path):
    got = [raw(s.host, "GET", path) for s in pair]
    assert got[1][0] == got[0][0], path
    if path.startswith("/debug/traces?min_ms=1"):
        assert json.loads(got[1][1]) == json.loads(got[0][1]) == {"traces": []}
    if path == "/debug/perf":
        assert set(json.loads(got[1][1])) == set(json.loads(got[0][1]))


def test_debug_profile_tars_a_trace_and_is_single_flight(pair):
    _, t = pair
    status, body = raw(t.host, "GET", "/debug/profile?seconds=0.05")
    assert status == 200
    doc = json.loads(body)
    with tarfile.open(doc["trace"]) as tf:
        names = tf.getnames()
    assert any(n.endswith("trace.json") for n in names)
    assert doc["trace"].startswith(t.data_dir)
    assert t.handler._profile_mu.acquire(blocking=False)
    try:
        assert raw(t.host, "GET", "/debug/profile?seconds=0.05")[0] == 409
    finally:
        t.handler._profile_mu.release()


def test_slow_query_log_line(pair):
    _, t = pair
    lines = []
    prev_log, prev_ms = t.handler.logger, t.handler.slow_query_ms
    t.handler.logger, t.handler.slow_query_ms = lines.append, 1e-6
    try:
        raw(t.host, "POST", "/index/i/query", TRACED[0].encode())
    finally:
        t.handler.logger, t.handler.slow_query_ms = prev_log, prev_ms
    assert len(lines) == 1 and lines[0].startswith("slow query ")
    doc = json.loads(lines[0][len("slow query "):])
    assert doc["query"] == TRACED[0]
    assert {"parse", "execute", "call.Count", "plan", "coalesce"} <= set(doc["stages"])
    assert doc["coalesce"]["launches"] == 1


# ---------------------------------------------------------------------------
# one trace across a cluster
# ---------------------------------------------------------------------------


def test_cluster_query_trace_covers_every_node(tmp_path):
    nodes = [
        TServer(str(tmp_path / f"n{i}"), device="cpu", cluster_type="http", replicas=1,
                internal_port=0, polling_interval=3600, floor_probe=False)
        for i in range(3)
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
        bits = " ".join(f"SetBit(frame=f, rowID={s % 3}, columnID={s * SW + 5})" for s in range(9))
        assert raw(nodes[0].host, "POST", "/index/i/query", bits.encode())[0] == 200
        for s in nodes:
            s.tick_max_slices()
        owners = {n.host for s in range(9) for n in nodes[0].cluster.fragment_nodes("i", s)}
        assert owners == {s.host for s in nodes}
        for pql in ("TopN(frame=f, n=2)", "Count(Bitmap(frame=f, rowID=1))"):
            assert raw(nodes[0].host, "POST", "/index/i/query", pql.encode())[0] == 200
            rec = nodes[0].tracer.traces()[-1]
            assert rec["spans"][0]["tags"]["query"] == pql
            ids = {s["span_id"] for s in rec["spans"]}
            # Every span's parent is in the trace: one tree.
            assert all(s["parent_id"] in ids for s in rec["spans"][1:])
            roots = [s for s in rec["spans"] if s["name"] == "query"]
            assert {s["tags"]["node"] for s in roots} == {s.host for s in nodes}
            rpcs = [s for s in rec["spans"] if s["name"] == "rpc.execute"]
            assert {s["tags"]["node"] for s in rpcs} == {s.host for s in nodes[1:]}
            for r in roots[1:]:
                assert r["tags"]["remote"] is True
                assert r["parent_id"] in {s["span_id"] for s in rpcs}
    finally:
        for s in nodes:
            s.close()
