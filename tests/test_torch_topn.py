"""TopN through the cross-fragment scorer K4 against the JAX package, on
the CPU, exactly:

* the plain K4 (``ops/score_planes.py``) against ``bp.score_planes`` in
  both src modes (a slot of the fragment's own mirror, or a src row),
  with ragged plane-row counts and padded slots;
* the fragment's prepare / score / select split (``top_prepare_parts``,
  ``top_score_arrays``, ``top_prepare_union_parts``) against the JAX
  fragment's;
* the executor's TopN answers, in JSON and protobuf, against a JAX
  node's: the folded single-round-trip path, the two-phase path (the
  union guard tripped, and ``ids`` given) and a 3-node port cluster,
  with n, threshold, tanimoto, attribute filters and ids;
* one TopN(src) over 32 local fragments calls the scorer exactly once."""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.core.bitmap import RowBitmap as JRowBitmap  # noqa: E402
from pilosa_tpu.core.fragment import Fragment as JFragment  # noqa: E402
from pilosa_tpu.core.fragment import TopOptions as JTopOptions  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu.ops import bitplane as jbp  # noqa: E402
from pilosa_tpu_torch.core.bitmap import RowBitmap as TRowBitmap  # noqa: E402
from pilosa_tpu_torch.core.fragment import Fragment as TFragment  # noqa: E402
from pilosa_tpu_torch.core.fragment import TopOptions as TTopOptions  # noqa: E402
from pilosa_tpu_torch.exec import executor as texec  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.ops import bitplane as tbp  # noqa: E402
from pilosa_tpu_torch.ops import fused_popcount, score_planes  # noqa: E402

W = tbp.WORDS_PER_SLICE
SW = tbp.SLICE_WIDTH
PROTOBUF = "application/x-protobuf"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the cores: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- K4: the plain version against bp.score_planes ----------------------------


def ragged_planes(rng, rows_per_frag):
    """uint32 planes with the given row counts: random words, an
    all-zero row, an all-ones row, sign-bit and last-word rows."""
    planes = []
    for rows in rows_per_frag:
        p = rng.integers(0, 2**32, size=(rows, W), dtype=np.uint32)
        special = [np.zeros(W, np.uint32), np.full(W, 0xFFFFFFFF, np.uint32),
                   np.full(W, 0x80000000, np.uint32)]
        for k, row in enumerate(special[: rows - 1]):
            p[k + 1] = row
        p[-1, -1] = 0x80000001
        planes.append(p)
    return planes


@pytest.mark.parametrize("src_mode", ["self", "row"])
@pytest.mark.parametrize("pad", ["edge", "minus_one"])
def test_plain_k4_matches_jax_score_planes(src_mode, pad):
    rng = np.random.default_rng(11)
    rows_per_frag = [1, 8, 64, 65, 9]
    cands = [1, 3, 10, 17, 8]  # ragged; 17 > 8 and not a multiple of it
    planes = ragged_planes(rng, rows_per_frag)
    width = max(cands)
    slots = np.empty((len(planes), width), np.int64)
    for f, (rows, k) in enumerate(zip(rows_per_frag, cands)):
        real = rng.choice(rows, size=k, replace=k > rows)
        slots[f, :k] = real
        slots[f, k:] = real[-1] if pad == "edge" else -1
    jax_slots = np.where(slots < 0, slots.max(axis=1, keepdims=True), slots)
    t_planes = [tbp.to_device(p, "cpu") for p in planes]
    if src_mode == "self":
        src_slots = np.array([rng.integers(0, r) for r in rows_per_frag])
        src_slots[3] = 2  # the all-ones row
        want = jbp.score_planes(tuple(jnp.asarray(p) for p in planes),
                                jnp.asarray(jax_slots, jnp.int32),
                                src_slots=jnp.asarray(src_slots, jnp.int32))
        srcs = [p[s] for p, s in zip(t_planes, src_slots)]
    else:
        src_np = rng.integers(0, 2**32, size=(len(planes), W), dtype=np.uint32)
        src_np[0], src_np[1] = 0, 0xFFFFFFFF  # an all-zero and an all-ones src
        want = jbp.score_planes(tuple(jnp.asarray(p) for p in planes),
                                jnp.asarray(jax_slots, jnp.int32), srcs=jnp.asarray(src_np))
        src_t = tbp.to_device(src_np, "cpu")
        srcs = [src_t[f] for f in range(len(planes))]
    want = np.asarray(want).astype(np.int64)
    before = score_planes.launches
    for fn in (score_planes.plain_score_planes, score_planes.score_planes):
        got = fn(t_planes, slots, srcs)
        assert got.dtype == torch.int32 and tuple(got.shape) == slots.shape
        got = got.numpy().astype(np.int64)
        real = slots >= 0
        np.testing.assert_array_equal(got[real], want[real])
        assert not got[~real].any()
    assert score_planes.launches == before  # the CPU runs the plain version


def test_k4_refuses_what_it_does_not_take():
    plane = torch.zeros(3, W, dtype=torch.int32)
    src = torch.zeros(W, dtype=torch.int32)
    ok = np.array([[0, 2, -1]], np.int64)
    score_planes.score_planes([plane], ok, [src])
    for planes, slots, srcs in (
        ([plane], np.array([[3]], np.int64), [src]),  # past the mirror
        ([plane], np.array([[-2]], np.int64), [src]),
        ([plane], ok.astype(np.int32), [src]),
        ([plane], np.zeros((1, 0), np.int64), [src]),
        ([plane, plane], ok, [src]),
        ([plane], ok, [plane]),  # a plane is no src row
        ([plane[:, :8]], np.array([[0]], np.int64), [src]),
    ):
        with pytest.raises(ValueError):
            score_planes.score_planes(planes, slots, srcs)


def test_k4_raises_off_the_cpu_and_without_its_library(monkeypatch):
    from pilosa_tpu_torch.ops import _build

    meta = torch.empty(4, W, dtype=torch.int32, device="meta")
    before = score_planes.launches
    with pytest.raises(ValueError):
        score_planes.score_planes([meta], np.array([[0]], np.int64), [meta[0]])

    def no_library(name):
        raise _build.KernelBuildError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(score_planes, "_fn", None)
    plane = torch.zeros(4, W, dtype=torch.int32)
    # As for planes on the card: the device check passes, the build fails.
    monkeypatch.setattr(score_planes, "_check", lambda *a: torch.device("cuda"))
    with pytest.raises(_build.KernelBuildError):
        score_planes.score_planes([plane], np.array([[0]], np.int64), [plane[1]])
    assert score_planes.launches == before


# --- the fragment's prepare / score / select split ----------------------------

SLICE = 3


def fragment_pair(tmp_path):
    j = JFragment(str(tmp_path / "jax" / "3"), "i", "f", "standard", SLICE)
    t = TFragment(str(tmp_path / "torch" / "3"), "i", "f", "standard", SLICE, device="cpu")
    j.open()
    t.open()
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 20, 6000)
    keep = rng.random(6000) < (rows + 1) / 20
    cols = SLICE * SW + rng.integers(0, SW, 6000)
    j.import_bulk(rows[keep], cols[keep])
    t.import_bulk(rows[keep], cols[keep])
    for c in (SLICE * SW + 31, SLICE * SW + SW - 1):
        assert j.set_bit(19, c) == t.set_bit(19, c)
    return j, t


def src_pair(j, rows):
    w = j._row_words_host(rows[0]).copy()
    for r in rows[1:]:
        w &= j._row_words_host(r)
    tw = tbp.to_device(w, "cpu")
    return JRowBitmap.from_segment(SLICE, w), TRowBitmap.from_segment(SLICE, tw)


def score_jax(st, sub, src):
    if sub is not None:
        st.counts = np.asarray(jbp.score_planes(
            (sub.plane,), jnp.asarray(sub.slots[None]), srcs=jnp.asarray(src[None])))[0]


def score_port(st, sub, src):
    if sub is not None:
        st.counts = score_planes.score_planes([sub.plane], sub.slots[None], [src]).numpy()[0]


def assert_same_parts(jpart, tpart):
    jst, jsub, _ = jpart
    tst, tsub, _ = tpart
    assert (jsub is None) == (tsub is None)
    if jst.done_ids is not None:
        np.testing.assert_array_equal(tst.done_ids, jst.done_ids)
        np.testing.assert_array_equal(tst.done_cnts, jst.done_cnts)
        return
    for k in ("cand_ids", "cand_cached", "dense_pos"):
        np.testing.assert_array_equal(getattr(tst, k), getattr(jst, k), err_msg=k)
    assert not len(jst.sparse_pos)
    assert (tst.n, tst.tanimoto, tst.src_count, tst.min_threshold) == (
        jst.n, jst.tanimoto, jst.src_count, jst.min_threshold)
    np.testing.assert_array_equal(tsub.slots, jsub.slots[: len(tst.dense_pos)])


def assert_same_scores(j, t, jpart, tpart):
    score_jax(*jpart)
    score_port(*tpart)
    for got, want in zip(t.top_score_arrays(tpart[0]), j.top_score_arrays(jpart[0])):
        np.testing.assert_array_equal(got, want)
    assert [(p.id, p.count) for p in t.top_finish(tpart[0])] == [
        (p.id, p.count) for p in j.top_finish(jpart[0])]


TOP_OPTS = [
    {"n": 4},
    {"n": 0, "src": (5,)},
    {"n": 3, "src": (7, 9)},
    {"n": 0, "src": (12,), "min_threshold": 150},
    {"n": 5, "src": (15,), "tanimoto_threshold": 40},
    {"row_ids": [2, 4, 4, 19, 77], "src": (11,)},
    {"n": 2, "src": (40,)},  # a src row the fragment does not hold: empty
]


@pytest.mark.parametrize("opts", TOP_OPTS)
def test_prepare_and_score_parts_match_jax(tmp_path, opts):
    j, t = fragment_pair(tmp_path)
    kw = dict(opts)
    rows = kw.pop("src", None)
    jsrc = tsrc = None
    if rows is not None:
        if rows == (40,):
            jsrc, tsrc = JRowBitmap(), TRowBitmap("cpu")
        else:
            jsrc, tsrc = src_pair(j, rows)
    jopt, topt = JTopOptions(src=jsrc, **kw), TTopOptions(src=tsrc, **kw)
    jpart, tpart = j.top_prepare_parts(jopt), t.top_prepare_parts(topt)
    assert_same_parts(jpart, tpart)
    assert_same_scores(j, t, jpart, tpart)
    # The union pass: this slice's candidates plus foreign ids (one the
    # fragment holds outside its list, one it does not hold).
    cand_ids, cand_cnts = t.top_candidates_arrays(topt)
    jc_ids, jc_cnts = j.top_candidates_arrays(jopt)
    np.testing.assert_array_equal(cand_ids, jc_ids)
    np.testing.assert_array_equal(cand_cnts, jc_cnts)
    union = np.unique(np.concatenate([cand_ids, [0, 1, 500]]).astype(np.int64))
    jpart = j.top_prepare_union_parts(union, jc_ids, jc_cnts, jopt)
    tpart = t.top_prepare_union_parts(union, cand_ids, cand_cnts, topt)
    assert_same_parts(jpart, tpart)
    assert_same_scores(j, t, jpart, tpart)
    # top() is the three for one fragment.
    assert [(p.id, p.count) for p in t.top(topt)] == [(p.id, p.count) for p in j.top(jopt)]
    j.close()
    t.close()


def test_score_reads_the_captured_mirror(tmp_path):
    """A structural write between the prepare and the scorer leaves the
    captured mirror and its slots as they were."""
    _, t = fragment_pair(tmp_path)
    tsrc = TRowBitmap.from_segment(SLICE, tbp.to_device(t.row_words_host(3), "cpu"))
    st, sub, src = t.top_prepare_parts(TTopOptions(n=3, src=tsrc))
    before = sub.plane.clone()
    for r in range(20, 40):  # rows past the padded plane: a new mirror
        t.set_bit(r, SLICE * SW + r)
    assert t.device_plane() is not sub.plane
    assert torch.equal(sub.plane, before)
    assert t.slot_in(3, sub.plane) is None
    score_port(st, sub, src)
    want = tbp.np_row_counts(tbp.to_host(before)[sub.slots] & tbp.to_host(src))
    np.testing.assert_array_equal(st.counts, want)
    t.close()


# --- the executor's TopN against a JAX node -------------------------------------


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


def jax_server(path):
    return JServer(data_dir=path, host="127.0.0.1:0", anti_entropy_interval=3600,
                   polling_interval=3600, cache_flush_interval=3600)


def create_schema(host):
    for path in ("/index/i", "/index/i/frame/f", "/index/i/frame/g"):
        body = b""
        assert http(host, "POST", path, body)[0] == 200, path


def dense_data(n_slices, seed=3):
    """Frame f: rows 0-15 with row-dependent density (a clear order and
    ties); frame g: a few sparse rows."""
    rng = np.random.default_rng(seed)
    n = 12000 * n_slices
    rows = rng.integers(0, 16, n)
    keep = rng.random(n) < (rows + 1) / 16
    f = (rows[keep], rng.integers(0, n_slices * SW, n)[keep])
    g = (rng.integers(0, 4, 300), rng.integers(0, n_slices * SW, 300))
    return {"f": f, "g": g}


def disjoint_data(n_slices, per_slice=180, seed=4):
    """Frame f where each slice holds its own rows: the candidate union
    (n_slices x per_slice rows) trips the folded path's guard."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for s in range(n_slices):
        ids = s * per_slice + np.arange(per_slice)
        k = rng.integers(1, 40, per_slice)
        rows.append(np.repeat(ids, k))
        cols.append(s * SW + rng.integers(0, SW, int(k.sum())))
    rows.append(np.full(3000, 7))  # one hot row across slices
    cols.append(rng.integers(0, n_slices * SW, 3000))
    g = (rng.integers(0, 2, 200000), rng.integers(0, n_slices * SW, 200000))
    return {"f": (np.concatenate(rows), np.concatenate(cols)), "g": g}


def load(holder, data):
    for frame, (rows, cols) in data.items():
        holder.frame("i", frame).import_bulk(rows, cols)
    store = holder.frame("i", "f").row_attr_store
    for r in range(0, 16, 3):
        store.set_attrs(r, {"cat": "hot" if r % 2 else "cold", "tier": r // 4})


@pytest.fixture
def node_pair(tmp_path):
    """One JAX node and one port node, same data; yields a loader."""
    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    j.open()
    t.open()

    def setup(data):
        for s in (j, t):
            create_schema(s.host)
            load(s.holder, data)
        return j, t

    try:
        yield setup
    finally:
        j.close()
        t.close()


B = "Bitmap(frame=f, rowID={})"
FOLDED = [
    "TopN(frame=f, n=4)",
    "TopN(frame=f)",
    "TopN(frame=f, n=3, threshold=2000)",
    f"TopN({B.format(3)}, frame=f, n=5)",
    f"TopN({B.format(15)}, frame=f)",
    f"TopN(Intersect({B.format(9)}, {B.format(12)}), frame=f, n=4)",
    f"TopN(Intersect({B.format(9)}, {B.format(12)}), frame=f, n=6, threshold=150)",
    f"TopN({B.format(11)}, frame=f, n=5, tanimotoThreshold=30)",
    f"TopN(Union({B.format(2)}, Bitmap(frame=g, rowID=1)), frame=f, n=3, tanimotoThreshold=10)",
    'TopN(frame=f, n=5, field="cat", filters=["hot"])',
    f'TopN({B.format(14)}, frame=f, n=5, field="tier", filters=[1, 3])',
    "TopN(Bitmap(frame=g, rowID=1), frame=f, n=3)",
    "TopN(Bitmap(frame=g, rowID=9), frame=f, n=3)",  # an empty src
    f"TopN({B.format(4)}, frame=f, n=3, tanimotoThreshold=101)",
    f"TopN({B.format(4)}, {B.format(5)}, frame=f, n=3)",
]
IDS = [
    "TopN(frame=f, n=2, ids=[1, 3, 5, 99])",
    f"TopN({B.format(6)}, frame=f, ids=[0, 7, 15])",
    f"TopN({B.format(6)}, frame=f, n=1, ids=[0, 7, 15], threshold=300)",
]


def spy_paths(monkeypatch):
    """Counts of the folded and two-phase TopN paths and scorer calls."""
    seen = {"folded": 0, "two_phase": 0, "scorer": 0, "k1": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapper

    E = texec.Executor
    monkeypatch.setattr(E, "_execute_topn_folded", counted("folded", E._execute_topn_folded))
    monkeypatch.setattr(E, "_execute_topn_two_phase",
                        counted("two_phase", E._execute_topn_two_phase))
    monkeypatch.setattr(score_planes, "score_planes", counted("scorer", score_planes.score_planes))
    monkeypatch.setattr(fused_popcount, "row_popcounts",
                        counted("k1", fused_popcount.row_popcounts))
    return seen


def ask_counting(seen, host, q):
    """ask(), and the scorer calls the query made."""
    before = seen["scorer"]
    got = ask(host, q)
    return got, seen["scorer"] - before


def has_src(q):
    return not q.startswith("TopN(frame=")


def test_folded_topn_matches_jax(node_pair, monkeypatch):
    j, t = node_pair(dense_data(4))
    seen = spy_paths(monkeypatch)
    for q in FOLDED:
        want = ask(j.host, q)
        got, calls = ask_counting(seen, t.host, q)
        assert got == want, q
        # One scoring pass answers both phases: one scorer call for each
        # asking where a src reaches a candidate, none without a src.  The
        # second asking (protobuf) reuses the cached prep entry's scores,
        # but for an attribute-filtered TopN, which is not cached.
        per = 2 if 'field="' in q else 1
        assert calls <= per and (calls == 0 or has_src(q)), (q, calls)
        if has_src(q) and want[0][0] == 200 and want[0][1]["results"][0]:
            assert calls == per, (q, calls)
    assert seen["folded"] == 2 * len(FOLDED) and seen["two_phase"] == 0
    for q in IDS:  # ids=: the two-phase map, without the refetch
        assert ask(t.host, q) == ask(j.host, q), q
    assert seen["folded"] == 2 * len(FOLDED)


def test_two_phase_topn_matches_jax(node_pair, monkeypatch):
    j, t = node_pair(disjoint_data(3))
    seen = spy_paths(monkeypatch)
    # (query, whether the union guard trips): threshold=30 leaves each
    # slice few enough candidates for the folded pass.
    queries = [
        ("TopN(frame=f, n=5)", True),
        ("TopN(frame=f, n=3, threshold=30)", False),
        (f"TopN({B.format(7)}, frame=f, n=4)", True),
        ("TopN(Bitmap(frame=g, rowID=1), frame=f, n=6, threshold=2)", True),
        ("TopN(Bitmap(frame=g, rowID=0), frame=f, n=4, tanimotoThreshold=1)", True),
    ]
    for q, trips in queries:
        want = ask(j.host, q)
        before = seen["two_phase"]
        got, calls = ask_counting(seen, t.host, q)
        assert got == want, q
        assert seen["two_phase"] - before == (2 if trips else 0), q
        # Two rounds, each one scorer call where a src reaches a candidate.
        if has_src(q) and want[0][1]["results"][0]:
            assert calls == 2 * 2, (q, calls)
    assert seen["folded"] == 2 * len(queries)
    for q in ("TopN(frame=f, ids=[1, 7, 200, 400])",
              f"TopN({B.format(7)}, frame=f, n=2, ids=[7, 181, 365])"):
        assert ask(t.host, q) == ask(j.host, q), q


def test_topn_over_32_fragments_calls_the_scorer_once(tmp_path, monkeypatch):
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600)
    t.open()
    try:
        create_schema(t.host)
        rng = np.random.default_rng(9)
        rows = rng.integers(0, 6, 32 * 20000)
        cols = np.repeat(np.arange(32), 20000) * SW + rng.integers(0, SW, 32 * 20000)
        t.holder.frame("i", "f").import_bulk(rows, cols)
        assert len(t.holder.view("i", "f", "standard").fragment_slices()) == 32
        seen = spy_paths(monkeypatch)
        for q, k1 in ((f"TopN({B.format(0)}, frame=f, n=3)", 0),
                      (f"TopN(Intersect({B.format(1)}, {B.format(2)}), frame=f, n=2)", 0),
                      (f"TopN({B.format(5)}, frame=f, n=3, tanimotoThreshold=5)", 1)):
            before = dict(seen)
            status, body = http(t.host, "POST", "/index/i/query", q.encode())
            assert status == 200 and json.loads(body)["results"][0], (q, body)
            assert seen["scorer"] - before["scorer"] == 1, q
            # The src counts a tanimoto window needs: one row-popcount call.
            assert seen["k1"] - before["k1"] == k1, q
    finally:
        t.close()


def test_port_cluster_topn_matches_one_jax_node(tmp_path, monkeypatch):
    """A 3-node port cluster (2 replicas) against one JAX node: the
    two-phase protocol over the map/reduce, one scorer call per node leg
    and phase."""
    data = dense_data(5, seed=8)
    j = jax_server(str(tmp_path / "jax"))
    j.open()
    nodes = [TServer(str(tmp_path / f"n{i}"), device="cpu", cluster_type="http", replicas=2,
                     internal_port=0, polling_interval=3600) for i in range(3)]
    try:
        create_schema(j.host)
        load(j.holder, data)
        for s in nodes:
            s.open()
        for s in nodes:
            for o in nodes:
                if o is not s:
                    s.add_peer(o.host, o.internal_host)
        create_schema(nodes[0].host)  # reaches the others by broadcast
        cluster = nodes[0].cluster
        for s in nodes:
            for frame, (rows, cols) in data.items():
                mine = np.array([s.host in {o.host for o in cluster.fragment_nodes("i", int(c))}
                                 for c in cols // SW], dtype=bool)
                s.holder.frame("i", frame).import_bulk(rows[mine], cols[mine])
            store = s.holder.frame("i", "f").row_attr_store
            for r in range(0, 16, 3):
                store.set_attrs(r, {"cat": "hot" if r % 2 else "cold", "tier": r // 4})
        for s in nodes:
            s.tick_max_slices()
        seen = spy_paths(monkeypatch)
        queries = FOLDED[:-2] + IDS
        for q in queries:
            want = ask(j.host, q)
            for s in nodes:
                assert ask(s.host, q) == want, (s.host, q)
        assert seen["folded"] == 0
        # Per src query from each node: a scorer call per node leg that
        # holds a src row, in each of the two rounds.
        assert seen["scorer"] > 0
        src_q = f"TopN({B.format(3)}, frame=f, n=5)"
        legs = len(nodes[0].executor._slices_by_node(list(cluster.nodes), "i", list(range(5))))
        before = seen["scorer"]
        ask(nodes[0].host, src_q)
        assert seen["scorer"] - before == 2 * 2 * legs  # JSON and protobuf, two rounds
    finally:
        for s in nodes:
            s.close()
        j.close()
