"""The sparse tier through the port's fragment and executor against the
JAX package, with a small dense budget as ``tests/test_planefmt.py`` and
``tests/test_fragment.py`` set it, on the CPU, exactly:

* the anchored Count route engages (one K5 call per request) and
  declines where the JAX package declines;
* the PQL storm (Count over fold trees, Bitmap, TopN, Range, Sum) with
  ``auto`` formats against ``dense`` and against a JAX node, in JSON and
  protobuf bytes;
* rows that move across formats, promotion, point ops and imports with
  clears on sparse rows;
* a JAX-written tall data directory opens in the port with identical
  bits, and the reverse."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pilosa_tpu.core.fragment as jfr  # noqa: E402
from pilosa_tpu.exec import plan as jplan  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu.ops import bitplane as jbp  # noqa: E402
from pilosa_tpu_torch.core import fragment as tfr  # noqa: E402
from pilosa_tpu_torch.core.holder import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import expand_payload as tep  # noqa: E402

SW = tbp.SLICE_WIDTH
PROTOBUF = "application/x-protobuf"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def auto_format():
    for bp in (jbp, tbp):
        bp.configure_plane_format(mode="auto", sparse_max_bytes=65536, rle_max_bytes=65536)
    yield
    for bp in (jbp, tbp):
        bp.configure_plane_format(mode="auto", sparse_max_bytes=65536, rle_max_bytes=65536)


def set_budget(monkeypatch, budget):
    """Both packages' fragments get ``budget`` dense rows."""
    orig = jfr.Fragment.__init__

    def small(self, *a, **kw):
        kw.setdefault("dense_row_budget", budget)
        orig(self, *a, **kw)

    monkeypatch.setattr(jfr.Fragment, "__init__", small)
    monkeypatch.setattr(tfr, "DENSE_ROW_BUDGET", budget)


def spy(monkeypatch):
    """Calls of the K5 and K6 wrappers (on the CPU each runs the plain
    version; on the card each is one launch), and of JAX's anchored
    program."""
    seen = {"k5": 0, "k6": 0, "jax_anchored": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tplan, "anchored_count", counted("k5", tplan.anchored_count))
    monkeypatch.setattr(tep, "expand_payloads", counted("k6", tep.expand_payloads))
    monkeypatch.setattr(jplan, "anchored_count_exec",
                        counted("jax_anchored", jplan.anchored_count_exec))
    return seen


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


def scattered(rng, card):
    return {int(p) for p in rng.choice(SW, size=card, replace=False)}


def clustered(rng, card, runs=8):
    run_len = max(1, card // runs)
    cols = set()
    for st in rng.choice(SW - run_len, size=runs, replace=False):
        cols.update(range(int(st), int(st) + run_len))
    return cols


def corpus(n_rows=6, slices=2, card=1500, seed=42):
    """Rows of frame f, alternating clustered (RLE) and scattered
    (positions) per slice; row 5 is dense enough for the dense format;
    a BSI field v over row 0's first columns."""
    rng = np.random.default_rng(seed)
    oracle = {}
    for row in range(n_rows):
        cols = set()
        for s in range(slices):
            n = 20_000 if row == 5 else card
            part = scattered(rng, n) if row % 3 == 1 or row == 5 else clustered(rng, n)
            cols.update(p + s * SW for p in part)
        oracle[row] = cols
    return oracle


def load(holder, oracle):
    idx = holder.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("f")
    f.set_options(range_enabled=True)
    if f.bsi_field("v") is None:
        f.create_field("v", 0, 500)
    rows = np.concatenate([np.full(len(c), r, np.int64) for r, c in oracle.items()])
    cols = np.concatenate([np.array(sorted(c), np.int64) for c in oracle.values()])
    f.import_bulk(rows, cols)
    vcols = sorted(oracle[0])[:300]
    f.import_value("v", vcols, [c % 500 for c in vcols])


@pytest.fixture
def node_pair(tmp_path):
    j = JServer(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", anti_entropy_interval=3600,
                polling_interval=3600, cache_flush_interval=3600)
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()

    def setup(oracle):
        for s in (j, t):
            load(s.holder, oracle)
        return j, t

    try:
        yield setup
    finally:
        j.close()
        t.close()


def bm(r):
    return f"Bitmap(rowID={r}, frame=f)"


ANCHORED = [
    (f"Count(Intersect({bm(0)}, {bm(1)}))", lambda o: len(o[0] & o[1])),
    (f"Count(Difference({bm(1)}, {bm(2)}))", lambda o: len(o[1] - o[2])),
    (f"Count(Intersect({bm(3)}, Union({bm(4)}, {bm(5)})))", lambda o: len(o[3] & (o[4] | o[5]))),
    (f"Count(Intersect({bm(0)}, {bm(5)}, {bm(3)}))", lambda o: len(o[0] & o[5] & o[3])),
    (f"Count(Intersect({bm(2)}, Xor({bm(0)}, {bm(1)})))", lambda o: len(o[2] & (o[0] ^ o[1]))),
    (f"Count(Intersect({bm(0)}, {bm(77)}))", lambda o: 0),  # absent row, empty anchor
    (f"Count(Intersect({bm(77)}, {bm(0)}))", lambda o: 0),
    (f"Count(Difference({bm(4)}, {bm(77)}))", lambda o: len(o[4])),
    (f"Count({bm(2)})", lambda o: len(o[2])),
]


def test_anchored_route_engages_and_matches_jax(node_pair, monkeypatch):
    """Budget 0: every row sparse.  Each anchored Count is ONE K5 call on
    the port (JAX launches one program per format signature), and every
    answer equals the oracle and the JAX node in JSON and protobuf."""
    set_budget(monkeypatch, 0)
    oracle = corpus()
    j, t = node_pair(oracle)
    seen = spy(monkeypatch)
    for q, want in ANCHORED:
        before = dict(seen)
        got = ask(t.host, q)
        assert got == ask(j.host, q), q
        assert got[0][1]["results"][0] == want(oracle), q
        engaged = seen["jax_anchored"] > before["jax_anchored"]
        assert seen["k5"] - before["k5"] == (2 if engaged else 0), q
        if engaged:
            assert seen["k6"] == before["k6"], q  # nothing stacked
    assert seen["k5"] >= 2 * 6


DECLINES = [
    # (name, query, plane format, dense budget): each declines on one rule
    ("dense_format", f"Count(Intersect({bm(0)}, {bm(1)}))", "dense", 0),
    ("union_no_anchor", f"Count(Union({bm(0)}, {bm(1)}))", "auto", 0),
    ("bsi_leaf", f"Count(Intersect({bm(0)}, Range(frame=f, v > 10)))", "auto", 0),
    ("dense_anchor", f"Count(Intersect({bm(6)}, {bm(7)}))", "auto", 0),
    ("xor_root", f"Count(Xor({bm(0)}, {bm(1)}))", "auto", 0),
    ("no_compressed_leaf", f"Count(Intersect({bm(0)}, {bm(1)}))", "auto", 1 << 16),
]


@pytest.mark.parametrize("name,q,fmt,budget", DECLINES, ids=[d[0] for d in DECLINES])
def test_anchored_route_declines_where_jax_declines(node_pair, monkeypatch, name, q, fmt,
                                                    budget):
    """Where the JAX route declines, the port's declines too (no K5
    call) and the word-domain path answers the same: a Union of
    compressed rows is expanded by ONE K6 call, at the build of the
    cached batch (the protobuf request after the JSON one hits it)."""
    set_budget(monkeypatch, budget)
    oracle = corpus()
    # Rows 6 and 7: past ANCHORED_MAX_POSITIONS in slice 0.
    rng = np.random.default_rng(3)
    oracle[6] = scattered(rng, 40_000)
    oracle[7] = scattered(rng, 40_000)
    j, t = node_pair(oracle)
    for bp in (jbp, tbp):
        bp.configure_plane_format(mode=fmt)
    seen = spy(monkeypatch)
    got = ask(t.host, q)
    assert got == ask(j.host, q), q
    assert seen["jax_anchored"] == 0 and seen["k5"] == 0, (q, seen)
    if name in ("union_no_anchor", "xor_root"):
        assert seen["k6"] == 1, seen  # the build's; protobuf hits the cache


def storm(host, n_rows):
    out = []
    for a in range(n_rows):
        b = (a + 1) % n_rows
        for q in (f"Count(Intersect({bm(a)}, {bm(b)}))", f"Count(Union({bm(a)}, {bm(b)}))",
                  f"Count(Difference({bm(a)}, {bm(b)}))"):
            out.append(ask(host, q))
    for q in (bm(0), bm(4), "TopN(frame=f, n=4)", f"TopN({bm(1)}, frame=f, n=4)",
              f"TopN({bm(0)}, frame=f, n=3, tanimotoThreshold=1)", "Range(frame=f, v > 250)",
              f"Count(Intersect({bm(0)}, Range(frame=f, v > 250)))", "Sum(frame=f, field=v)",
              f"Sum({bm(3)}, frame=f, field=v)", f"Intersect({bm(2)}, Union({bm(3)}, {bm(1)}))"):
        out.append(ask(host, q))
    return out


def test_pql_storm_auto_vs_dense_matches_jax(node_pair, monkeypatch):
    """The storm over compressed rows equals the forced-dense arm and
    the JAX node, answer for answer, in JSON and protobuf bytes."""
    set_budget(monkeypatch, 2)
    oracle = corpus(slices=3)
    j, t = node_pair(oracle)
    want = storm(j.host, 6)
    auto = storm(t.host, 6)
    assert auto == want
    for bp in (jbp, tbp):
        bp.configure_plane_format(mode="dense")
    assert storm(t.host, 6) == want
    assert auto[0][0][1]["results"][0] == len(oracle[0] & oracle[1])


def test_rows_move_across_formats(tmp_path, monkeypatch):
    """A sparse row rewritten by point writes and imports moves RLE ->
    positions -> dense -> positions exactly as in the JAX package: same
    host payload at every step, and the K6 expansion equals it."""
    set_budget(monkeypatch, 0)
    jf = jfr.Fragment(str(tmp_path / "j"), "i", "f", "standard", 0)
    tf = tfr.Fragment(str(tmp_path / "t"), "i", "f", "standard", 0, device="cpu")
    jf.open()
    tf.open()
    rng = np.random.default_rng(7)
    truth = set()

    def check(fmt=None):
        jp, tp = jf.host_payload(7), tf.host_payload(7)
        assert tp[0] == jp[0] and tp[2:] == jp[2:]
        np.testing.assert_array_equal(tp[1], jp[1])
        assert tp[3] == len(truth)
        if fmt is not None:
            assert tp[0] == fmt
        np.testing.assert_array_equal(tbp.to_host(tf.device_row(7)),
                                      tbp.np_columns_to_row(np.array(sorted(truth))))

    try:
        for col in range(1000, 3000):
            assert jf.set_bit(7, col) == tf.set_bit(7, col)
            truth.add(col)
        check(tbp.FMT_RLE)
        for col in rng.choice(SW, size=3000, replace=False):
            assert jf.set_bit(7, int(col)) == tf.set_bit(7, int(col))
            truth.add(int(col))
        check()
        more = [int(p) for p in rng.choice(SW, size=17_000, replace=False)]
        jf.import_bulk([7] * len(more), more)
        tf.import_bulk([7] * len(more), more)
        truth.update(more)
        check(tbp.FMT_DENSE)
        drop = sorted(truth)[10:]
        jf.import_bulk([], [], [7] * len(drop), drop)
        tf.import_bulk([], [], [7] * len(drop), drop)
        truth = set(sorted(truth)[:10])
        check(tbp.FMT_SPARSE)
        for col in sorted(truth)[:4]:
            assert jf.clear_bit(7, col) == tf.clear_bit(7, col)
            truth.discard(col)
        check(tbp.FMT_SPARSE)
        assert 7 in tf._sparse and tf.row_count(7) == jf.row_count(7) == 6
    finally:
        jf.close()
        tf.close()


def test_point_ops_and_promotion_match_jax(tmp_path, monkeypatch):
    """Budget 4: rows spill to the sparse tier; every point op, the
    counts, rows and TopN equal the JAX fragment's, and a sparse row
    past PROMOTE_BITS moves to the plane while budget remains."""
    set_budget(monkeypatch, 4)
    jf = jfr.Fragment(str(tmp_path / "j"), "i", "f", "standard", 0)
    tf = tfr.Fragment(str(tmp_path / "t"), "i", "f", "standard", 0, device="cpu")
    jf.open()
    tf.open()
    rng = np.random.default_rng(7)
    try:
        rows = rng.integers(0, 40, size=400)
        cols = rng.integers(0, SW, size=400)
        for r, c in zip(rows, cols):
            assert jf.set_bit(int(r), int(c)) == tf.set_bit(int(r), int(c))
        assert len(tf._sparse) > 0 and len(tf._slot_of) == 4
        assert sorted(tf._sparse) == sorted(jf._sparse)
        for r, c in zip(rows[:60], cols[:60]):
            assert tf.contains(int(r), int(c))
            assert jf.clear_bit(int(r), int(c)) == tf.clear_bit(int(r), int(c))
            assert not tf.contains(int(r), int(c))
        assert tf.count() == jf.count()
        for r in range(41):
            assert tf.row(r).bits() == jf.row(r).bits(), r
            assert tf.row_count(r) == jf.row_count(r), r
        assert [(p.id, p.count) for p in tf.top()] == [(p.id, p.count) for p in jf.top()]
        # Promotion: a sparse row crossing PROMOTE_BITS with budget left.
        tf.dense_row_budget = jf.dense_row_budget = 5
        offs = np.arange(tfr.PROMOTE_BITS + 2, dtype=np.int64)
        victim = min(tf._sparse)
        jf.import_bulk(np.full(len(offs), victim), offs)
        tf.import_bulk(np.full(len(offs), victim), offs)
        assert victim in tf._slot_of and victim not in tf._sparse
        assert victim in jf._slot_of
        assert tf.row_count(victim) == jf.row_count(victim)
        assert tf.row(victim).bits() == jf.row(victim).bits()
        np.testing.assert_array_equal(tbp.to_host(tf.device_plane()), tf._plane)
    finally:
        jf.close()
        tf.close()


def tall_bits(seed=5, n_rows=3000):
    """A tall slice-0 fragment: rows with a few bits each, a handful of
    denser rows, a clustered row."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 6, n_rows)
    k[:5] = 900
    rows = np.repeat(np.arange(n_rows, dtype=np.int64) * 7, k)
    cols = rng.integers(0, SW, int(k.sum()))
    rows = np.concatenate([rows, np.full(5000, 21_000)])
    cols = np.concatenate([cols, np.arange(70_000, 75_000)])
    return rows, cols


def assert_same_fragment(a, b, row_ids):
    """Two fragments (either package) hold the same bits and counts."""
    def words(f, r):
        w = f._row_words_host(r) if hasattr(f, "_row_words_host") else f.row_words_host(r)
        return np.zeros(tbp.WORDS_PER_SLICE, np.uint32) if w is None else w
    assert a.count() == b.count()
    for r in row_ids:
        np.testing.assert_array_equal(words(a, int(r)), words(b, int(r)), err_msg=str(r))
        assert a.row_count(int(r)) == b.row_count(int(r))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tall_data_directory_opens_in_the_other_package(tmp_path, monkeypatch, writer):
    """A tall fragment (budget 64, thousands of sparse rows, post-snapshot
    op-log entries on sparse rows) written by either package opens in
    the other with identical bits and counts; the snapshot bytes are the
    same whichever tier holds a row."""
    set_budget(monkeypatch, 64)
    rows, cols = tall_bits()
    path = str(tmp_path / "frag")
    cls = {"jax": jfr.Fragment, "port": tfr.Fragment}
    kw = {"jax": {}, "port": {"device": "cpu"}}
    w = cls[writer](path, "i", "f", "inverse", 0, max_op_n=10**9, **kw[writer])
    w.open()
    w.import_bulk(rows, cols)
    snap = open(path, "rb").read()
    for r, c in ((21, 3), (14_000, 99), (9, SW - 1)):
        w.set_bit(r, c)
    w.clear_bit(0, int(cols[0]))
    other = "port" if writer == "jax" else "jax"
    w.close()
    if writer == "jax":
        w.flush_ops()
    r = cls[other](path, "i", "f", "inverse", 0, max_op_n=10**9, **kw[other])
    w2 = cls[writer](str(tmp_path / "again"), "i", "f", "inverse", 0, **kw[writer])
    r.open()
    w2.open()
    try:
        assert len(r._sparse) > 2000 and len(r._slot_of) == 64
        w2.import_bulk(rows, cols)
        for rr, c in ((21, 3), (14_000, 99), (9, SW - 1)):
            w2.set_bit(rr, c)
        w2.clear_bit(0, int(cols[0]))
        assert_same_fragment(r, w2, np.concatenate([np.unique(rows), [14_000, 77]]))
        # The other package's snapshot of the same content: same bytes.
        r.snapshot()
        j2 = cls[writer](str(tmp_path / "fresh"), "i", "f", "inverse", 0, **kw[writer])
        j2.open()
        j2.import_bulk(rows, cols)
        assert open(str(tmp_path / "fresh"), "rb").read() == snap
        j2.close()
    finally:
        r.close()
        w2.close()


def test_load_planes_carries_both_tiers_and_the_inverse_view(tmp_path, monkeypatch):
    """``convert.load_planes`` installs a JAX fragment's plane rows and
    sparse tier — here of a tall inverse fragment — into the port's
    inverse view: identical bits, counts and TopN, placed densest first."""
    from pilosa_tpu_torch import convert

    set_budget(monkeypatch, 64)
    rows, cols = tall_bits(seed=9)
    j = jfr.Fragment(str(tmp_path / "j"), "i", "f", "inverse", 0)
    j.open()
    j.import_bulk(rows, cols)
    slot_rows = sorted(j._slot_of, key=j._slot_of.get)
    tiers = (np.asarray(slot_rows, np.int64), j._plane[: len(slot_rows)], dict(j._sparse))
    h = THolder(str(tmp_path / "port"), device="cpu")
    h.open()
    try:
        h.create_index("i").create_frame("f", inverse_enabled=True)
        convert.load_planes(h, "i", "f", "inverse", {0: tiers})
        t = h.fragment("i", "f", "inverse", 0)
        assert len(t._slot_of) == 64 and len(t._sparse) == len(j._slot_of) + len(j._sparse) - 64
        assert_same_fragment(j, t, np.unique(rows))
        assert [(p.id, p.count) for p in t.top()] == [(p.id, p.count) for p in j.top()]
        with pytest.raises(ValueError):
            convert.load_planes(h, "i", "g", "inverse", {0: tiers})  # no inverse storage
    finally:
        h.close()
        j.close()


def test_time_range_over_sparse_rows_matches_jax(node_pair, monkeypatch):
    """A time-quantum Range unions a row over several time views; with a
    dense budget of 0 every view's row is a compressed payload, expanded
    into scratch rows by the same single K6 call and OR-ed — answers
    equal the JAX node's.  The scratch rows belong to the cached batch:
    the second request of a query (protobuf after JSON) reuses them."""
    set_budget(monkeypatch, 0)
    j, t = node_pair(corpus(n_rows=2, slices=2, card=300))
    rng = np.random.default_rng(12)
    days = ["2017-01-05T10:00", "2017-01-20T08:00", "2017-02-03T00:00", "2017-03-09T12:30"]
    for s in (j, t):
        status, _ = http(s.host, "POST", "/index/i/frame/t",
                         json.dumps({"options": {"timeQuantum": "YMD"}}).encode())
        assert status == 200
    writes = [(int(rng.integers(0, 3)), int(rng.integers(0, 2 * SW)), days[k % 4])
              for k in range(120)]
    for r, c, ts in writes:
        q = f'SetBit(frame=t, rowID={r}, columnID={c}, timestamp="{ts}")'
        assert ask(t.host, q) == ask(j.host, q), q
    seen = spy(monkeypatch)
    for q in ('Range(frame=t, rowID=1, start="2017-01-01T00:00", end="2017-04-01T00:00")',
              'Count(Range(frame=t, rowID=2, start="2017-01-10T00:00", end="2017-02-10T00:00"))',
              'Count(Union(Range(frame=t, rowID=0, start="2017-01-01T00:00", '
              'end="2017-03-01T00:00"), Bitmap(frame=f, rowID=1)))'):
        before = seen["k6"]
        assert ask(t.host, q) == ask(j.host, q), q
        assert seen["k6"] - before == 1, q  # the build's; protobuf hits the cache
