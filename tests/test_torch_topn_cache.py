"""The folded TopN's prep cache with single-flight scoring (JAX
``executor.py:2492-2800``) in the port, against a JAX node on the CPU:

* TopN with n, threshold, ids, srcs, tanimoto and inverse answers equal a
  JAX node's in JSON and protobuf, the first asking building the prep
  entry and scoring once, every repeat a hit that builds nothing and
  scores nothing;
* SetBit, ClearBit, ``/import`` and a fragment's close invalidate the
  entry, and the answer after each equals the JAX node's;
* N threads sending one TopN make one build and one scoring call;
* the entry's device bytes count in the pool's ``"cache"`` category and
  are released when its fragment closes."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu import device as jdevice  # noqa: E402
from pilosa_tpu.device.pool import PlanePool as JPool  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu_torch import device as tdevice  # noqa: E402
from pilosa_tpu_torch.device.pool import PlanePool as TPool  # noqa: E402
from pilosa_tpu_torch.exec import executor as texec  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.obs.stats import ExpvarStatsClient  # noqa: E402
from pilosa_tpu_torch.ops import score_planes  # noqa: E402
from pilosa_tpu_torch.pql.parser import parse_string as parse  # noqa: E402
from test_torch_topn import SW, ask, dense_data, http, jax_server  # noqa: E402

PROTOBUF = "application/x-protobuf"
B = "Bitmap(frame=f, rowID={})"
# Folded, cacheable queries (no ids, no attribute filter).
CACHED = [
    "TopN(frame=f, n=4)",
    "TopN(frame=f, n=3, threshold=2000)",
    f"TopN({B.format(3)}, frame=f, n=5)",
    f"TopN(Intersect({B.format(9)}, {B.format(12)}), frame=f, n=4)",
    f"TopN(Intersect({B.format(12)}, {B.format(9)}), frame=f, n=4)",  # the same, commuted
    f"TopN(Intersect({B.format(9)}, {B.format(12)}), frame=f, n=6, threshold=150)",
    f"TopN({B.format(11)}, frame=f, n=5, tanimotoThreshold=30)",
    f"TopN(Union({B.format(2)}, Bitmap(frame=g, rowID=1)), frame=f, n=3, tanimotoThreshold=10)",
    "TopN(frame=h, n=3, inverse=true)",
    "TopN(Bitmap(frame=h, columnID=5), frame=h, n=4, inverse=true)",
]
UNCACHED = [
    "TopN(frame=f, n=2, ids=[1, 3, 5, 99])",
    f"TopN({B.format(6)}, frame=f, ids=[0, 7, 15])",
    'TopN(frame=f, n=5, field="cat", filters=["hot"])',
]


@pytest.fixture(autouse=True)
def fresh_pools():
    """A pool of its own per test in both packages (the pool is
    process-wide)."""
    old_t, old_j = tdevice._set_pool(TPool()), jdevice._set_pool(JPool())
    yield
    tdevice._set_pool(old_t)
    jdevice._set_pool(old_j)


def load(holder, data):
    for frame, (rows, cols) in data.items():
        holder.frame("i", frame).import_bulk(rows, cols)
    store = holder.frame("i", "f").row_attr_store
    for r in range(0, 16, 3):
        store.set_attrs(r, {"cat": "hot" if r % 2 else "cold", "tier": r // 4})


def inverse_data(n_slices, seed=8):
    """Frame h (inverse storage): 12 rows over the slices, each column in
    a few rows, so the inverse view's TopN ranks columns."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 12, 4000)
    cols = rng.integers(0, 40, 4000) + rng.integers(0, n_slices, 4000) * SW
    return rows, cols


@pytest.fixture
def pair(tmp_path):
    """A JAX node and a port node over the same data."""
    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600, floor_probe=False,
                stats=ExpvarStatsClient())
    j.open()
    t.open()
    data = dense_data(4)
    try:
        for s in (j, t):
            for path, opts in (("/index/i", {}), ("/index/i/frame/f", {}),
                               ("/index/i/frame/g", {}),
                               ("/index/i/frame/h", {"inverseEnabled": True})):
                assert http(s.host, "POST", path, json.dumps({"options": opts}).encode())[0] == 200
            load(s.holder, data)
        for s in (j, t):
            # Frame h through the query path, which writes both views.
            rows, cols = inverse_data(4)
            q = " ".join(f"SetBit(frame=h, rowID={r}, columnID={c})"
                         for r, c in zip(rows[:300], cols[:300]))
            assert http(s.host, "POST", "/index/i/query", q.encode())[0] == 200
        yield j, t
    finally:
        j.close()
        t.close()


def counting(monkeypatch):
    seen = {"scorer": 0, "build": 0}
    E = texec.Executor
    build = E._topn_folded_build

    def b(*a, **kw):
        seen["build"] += 1
        return build(*a, **kw)

    sp = score_planes.score_planes

    def s(*a, **kw):
        seen["scorer"] += 1
        return sp(*a, **kw)

    monkeypatch.setattr(E, "_topn_folded_build", b)
    monkeypatch.setattr(score_planes, "score_planes", s)
    return seen


def test_repeats_hit_the_entry_and_match_jax(pair, monkeypatch):
    j, t = pair
    seen = counting(monkeypatch)
    for q in CACHED:
        want = ask(j.host, q)
        before = dict(seen)
        assert ask(t.host, q) == want, q  # JSON, then protobuf: a hit
        assert seen["build"] - before["build"] <= 1, q
        mid = dict(seen)
        for _ in range(2):
            assert ask(t.host, q) == want, q
        assert seen == mid, q  # repeats: no build, no scorer call
    # Every entry built was hit by the five askings after its first.
    counts = t.holder.stats.snapshot()["counts"]
    assert counts["exec.topn.prepBuild"] == seen["build"]
    assert counts["exec.topn.prepHit"] >= 5 * seen["build"]
    for q in UNCACHED:
        assert ask(t.host, q) == ask(j.host, q), q


def test_commuted_src_trees_share_one_entry(pair, monkeypatch):
    j, t = pair
    seen = counting(monkeypatch)
    a = f"TopN(Intersect({B.format(9)}, {B.format(12)}), frame=f, n=4)"
    b = f"TopN(Intersect({B.format(12)}, {B.format(9)}), frame=f, n=4)"
    assert ask(t.host, a) == ask(j.host, a)
    assert ask(t.host, b) == ask(j.host, b)
    assert seen == {"scorer": 1, "build": 1}


WRITES = [
    ("SetBit", "SetBit(frame=f, rowID=3, columnID={})"),
    ("ClearBit", "ClearBit(frame=f, rowID=15, columnID={})"),
]


@pytest.mark.parametrize("q", [CACHED[0], CACHED[2], CACHED[6]])
def test_writes_and_imports_invalidate_the_entry(pair, monkeypatch, q):
    j, t = pair
    seen = counting(monkeypatch)
    rng = np.random.default_rng(9)
    assert ask(t.host, q) == ask(j.host, q)
    builds = seen["build"]
    rows_f, cols_f = dense_data(4)["f"]
    targets = {"SetBit": rng.integers(0, 4 * SW, 40),  # new bits, nearly all
               "ClearBit": rng.choice(cols_f[rows_f == 15], 40, replace=False)}  # set bits
    for name, w in WRITES:
        for col in targets[name]:
            body = w.format(int(col)).encode()
            for s in (j, t):
                assert http(s.host, "POST", "/index/i/query", body)[0] == 200
        assert ask(t.host, q) == ask(j.host, q), (name, q)
        assert seen["build"] == builds + 1, name
        builds = seen["build"]
    # An /import of rows 3 and 14 into slice 1 (protobuf, as a client sends it).
    cols = (SW + rng.integers(0, SW, 3000)).astype(np.uint64)
    rows = np.where(np.arange(3000) % 2, 3, 14).astype(np.uint64)
    req = pb.ImportRequest(Index="i", Frame="f", Slice=1, RowIDs=rows.tolist(),
                           ColumnIDs=cols.tolist()).SerializeToString()
    for s in (j, t):
        assert http(s.host, "POST", "/import", req, {"Content-Type": PROTOBUF})[0] == 200
    assert ask(t.host, q) == ask(j.host, q)
    assert seen["build"] == builds + 1


def test_a_closing_fragment_drops_its_entries(pair, monkeypatch):
    """Deleting the TopN's frame closes its fragments: the close listener
    drops the entries that hold them at once, with their pool bytes; the
    frame made again answers as the JAX node does."""
    j, t = pair
    seen = counting(monkeypatch)
    q = f"TopN({B.format(3)}, frame=f, n=5)"
    assert ask(t.host, q) == ask(j.host, q)
    ex = t.executor
    assert len(ex._topn_cache) == 1
    pool = tdevice.pool()
    assert pool.snapshot()["cache_bytes"] > 0
    assert any(e.get("cache") == "topn" for d in pool.snapshot()["devices"]
               for e in d["entries"])
    for s in (j, t):
        assert http(s.host, "DELETE", "/index/i/frame/f")[0] == 200
    assert len(ex._topn_cache) == 0
    assert pool.snapshot()["cache_bytes"] == 0
    data = dense_data(4, seed=5)
    for s in (j, t):
        assert http(s.host, "POST", "/index/i/frame/f", b"")[0] == 200
        s.holder.frame("i", "f").import_bulk(*data["f"])
    assert ask(t.host, q) == ask(j.host, q)
    assert seen["build"] == 2


def test_executor_close_releases_the_cache_bytes(pair):
    j, t = pair
    q = f"TopN(Union({B.format(2)}, Bitmap(frame=g, rowID=1)), frame=f, n=3)"
    assert ask(t.host, q) == ask(j.host, q)
    assert tdevice.pool().snapshot()["cache_bytes"] > 0
    t.executor.close()
    assert tdevice.pool().snapshot()["cache_bytes"] == 0


@pytest.mark.parametrize("q", [CACHED[0], CACHED[3], CACHED[7]])
def test_concurrent_identical_topns_build_and_score_once(pair, monkeypatch, q):
    j, t = pair
    want = ask(j.host, q)[0][1]["results"][0]
    seen = counting(monkeypatch)
    calls = parse(q).calls
    n = 8
    start = threading.Barrier(n)
    out: list = [None] * n

    def run(i):
        start.wait(timeout=30)
        out[i] = t.executor.execute("i", parse(q))[0]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert calls and all(not th.is_alive() for th in threads)
    got = [[{"id": p.id, "count": p.count} for p in r] for r in out]
    assert all(g == want for g in got)
    assert seen["build"] == 1
    # A TopN without a src scores nothing on the card.
    assert seen["scorer"] == (1 if "Bitmap" in q else 0)
