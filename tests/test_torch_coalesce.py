"""The port's coalescer (``exec/coalesce.py``) on CPU row tables, case by
case as the JAX package's ``tests/test_coalesce.py`` and
``tests/test_fuse.py``: concatenation, identity dedup, immediate
dispatch, close, a launch error crossing the future, distinct trees in
one fused launch, union-leaf sharing, an oversized tree falling back,
fusion off, "total" drains, the shared fetch — and the executor wired to
it.  Every result is held against numpy over the same rows; every wait
has a timeout and every scheduler is closed by its fixture."""

import concurrent.futures
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu_torch.core.holder import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.exec import coalesce as co_mod  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.exec.coalesce import CoalesceClosed, CoalesceScheduler  # noqa: E402
from pilosa_tpu_torch.exec.executor import Executor  # noqa: E402
from pilosa_tpu_torch.ops import tree_eval as te  # noqa: E402
from pilosa_tpu_torch.pql import parse_string  # noqa: E402

W = 32768
SW = 1 << 20
TIMEOUT = 60
# A generous accumulation window makes batching deterministic under test:
# the dispatcher lingers for company instead of racing the submitters.
WAIT_US = 200_000


@pytest.fixture
def scheduler():
    made = []

    def make(**kw):
        kw.setdefault("max_wait_us", WAIT_US)
        co = CoalesceScheduler(**kw)
        made.append(co)
        return co

    yield make
    for co in made:
        co.close()


def rows_table(words: np.ndarray) -> te.RowTable:
    """A row table over uint32 ``[S, L, W]`` rows (one base)."""
    s, n, _ = words.shape
    base = torch.from_numpy(np.ascontiguousarray(words).view(np.int32).reshape(s * n, W))
    idx = np.zeros((s, n, 2), dtype=np.int64)
    idx[..., 1] = np.arange(s * n).reshape(s, n)
    return te.RowTable([base], idx)


def rand_words(rng, s: int, n: int) -> np.ndarray:
    return rng.integers(0, 2**32, size=(s, n, W), dtype=np.uint32)


def np_eval(expr, words: np.ndarray) -> np.ndarray:
    """uint32 [S, W] result rows of ``expr`` over ``words`` [S, L, W]."""
    out = []
    for s in range(words.shape[0]):
        r = tplan.eval_expr_np(expr, list(words[s]), W)
        out.append(np.zeros(W, np.uint32) if r is None else r)
    return np.stack(out)


def pc(rows: np.ndarray) -> np.ndarray:
    return np.bitwise_count(rows).sum(axis=-1)


def u32(t) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


AND01 = ("Intersect", ("leaf", 0), ("leaf", 1))
EXPRS = [
    AND01,
    ("Union", ("leaf", 0), ("leaf", 1)),
    ("Difference", ("leaf", 1), ("leaf", 0)),
    ("Xor", ("Intersect", ("leaf", 0), ("leaf", 1)), ("leaf", 1)),
]


# --- the scheduler -------------------------------------------------------------


def test_concat_tables_one_launch_correct_scatter(scheduler):
    co = scheduler()
    rng = np.random.default_rng(1)
    words = [rand_words(rng, 1, 1) for _ in range(5)]
    futs = [co.submit(("leaf", 0), "count", rows_table(w)) for w in words]
    results = [f.result(timeout=TIMEOUT) for f in futs]
    for w, (res, info) in zip(words, results):
        assert res.shape == (1,) and int(res[0]) == int(pc(w[:, 0])[0])
    assert len({info["launch"] for _, info in results}) == 1
    info = results[0][1]
    assert (info["batch_segments"], info["batch_rows"], info["pad_rows"]) == (5, 5, 0)
    snap = co.snapshot()
    assert (snap["launches"], snap["queries"], snap["pad_rows"]) == (1, 5, 0)


def test_identity_dedup_shares_one_segment(scheduler):
    """Tables made from one cached entry (one index array) are one
    segment: the launch runs on that table as it is."""
    co = scheduler()
    words = rand_words(np.random.default_rng(2), 4, 2)
    t = rows_table(words)
    tables = [t] * 3 + [te.RowTable(t.bases, t.index) for _ in range(3)]
    futs = [co.submit(AND01, "row", x) for x in tables]
    want = words[:, 0] & words[:, 1]
    for f in futs:
        res, info = f.result(timeout=TIMEOUT)
        np.testing.assert_array_equal(u32(res), want)
        assert info["batch_segments"] == 1 and info["pad_rows"] == 0
    snap = co.snapshot()
    assert snap["launches"] < len(futs) and snap["max_occupancy"] > 1


def test_immediate_dispatch_without_wait_window(scheduler):
    co = scheduler(max_wait_us=0)
    t = rows_table(rand_words(np.random.default_rng(3), 1, 1))
    for _ in range(3):
        _res, info = co.submit(("leaf", 0), "count", t).result(timeout=TIMEOUT)
        assert info["batch_queries"] == 1
    assert co.snapshot()["launches"] == 3


def test_close_rejects_submissions(scheduler):
    co = scheduler()
    co.close()
    t = rows_table(np.zeros((1, 1, W), np.uint32))
    with pytest.raises(CoalesceClosed):
        co.submit(("leaf", 0), "count", t)
    with pytest.raises(CoalesceClosed):
        co.submit_fetch([torch.zeros(3)])
    assert not co._thread.is_alive()


def test_launch_error_crosses_future(scheduler):
    co = scheduler(max_wait_us=0)
    t = rows_table(np.zeros((1, 1, W), np.uint32))
    with pytest.raises(tplan.PlanError):
        co.submit(("Bogus",), "count", t).result(timeout=TIMEOUT)
    ok, _ = co.submit(("leaf", 0), "count", t).result(timeout=TIMEOUT)
    assert int(ok[0]) == 0


@pytest.mark.parametrize("reduce", ["count", "row", "total"])
def test_distinct_trees_one_fused_launch(scheduler, reduce):
    """Four distinct trees over four tables of the same slice count ride
    ONE interpreter launch; each waiter gets its own tree's result."""
    co = scheduler()
    rng = np.random.default_rng(4)
    words = [rand_words(rng, 3, 2) for _ in EXPRS]
    futs = [co.submit(e, reduce, rows_table(w)) for e, w in zip(EXPRS, words)]
    for e, w, f in zip(EXPRS, words, futs):
        res, info = f.result(timeout=TIMEOUT)
        want = np_eval(e, w)
        if reduce == "row":
            np.testing.assert_array_equal(u32(res), want)
        elif reduce == "count":
            np.testing.assert_array_equal(np.asarray(res), pc(want))
        else:
            assert res == int(pc(want).sum())
        assert info["fused"] and info["programs"] == 4
    snap = co.snapshot()
    assert (snap["launches"], snap["fused_launches"], snap["fused_queries"]) == (1, 1, 4)


def test_identical_queries_share_one_program(scheduler):
    co = scheduler()
    rng = np.random.default_rng(5)
    t, u = rows_table(rand_words(rng, 2, 2)), rows_table(rand_words(rng, 2, 2))
    futs = [co.submit(AND01, "count", t) for _ in range(3)]
    futs.append(co.submit(EXPRS[1], "count", u))
    infos = [f.result(timeout=TIMEOUT)[1] for f in futs]
    assert {i["programs"] for i in infos} == {2}
    assert co.snapshot()["fused_queries"] == 4


def test_union_leaf_sharing_collapses_columns(scheduler):
    """Columns with equal row identities are one register: two tables
    sharing their leaf 0 stream it once, and the shared AND dedups."""
    co = scheduler()
    rng = np.random.default_rng(6)
    shared = rand_words(rng, 2, 1)
    w1 = np.concatenate([shared, rand_words(rng, 2, 1)], axis=1)
    w2 = np.concatenate([shared, rand_words(rng, 2, 1)], axis=1)
    k = ("rows", b"shared")
    f1 = co.submit(AND01, "count", rows_table(w1), leaf_keys=(k, ("rows", b"a")))
    f2 = co.submit(EXPRS[1], "count", rows_table(w2), leaf_keys=(k, ("rows", b"b")))
    (r1, i1), (r2, _) = f1.result(timeout=TIMEOUT), f2.result(timeout=TIMEOUT)
    np.testing.assert_array_equal(np.asarray(r1), pc(np_eval(AND01, w1)))
    np.testing.assert_array_equal(np.asarray(r2), pc(np_eval(EXPRS[1], w2)))
    assert (i1["leaf_rows"], i1["shared_leaves"]) == (3, 1)
    assert co.snapshot()["fuse_shared_leaves"] == 1


def test_oversized_tree_falls_back_to_its_own_launch(scheduler):
    """A tree past the op budget rolls back and runs through the concat
    path (K2); the other trees still fuse; every answer is right."""
    co = scheduler()
    rng = np.random.default_rng(7)
    big = ("Xor",) + tuple(("leaf", i % 2) for i in range(300))
    exprs = [big, AND01, EXPRS[1]]
    words = [rand_words(rng, 2, 2) for _ in exprs]
    futs = [co.submit(e, "count", rows_table(w)) for e, w in zip(exprs, words)]
    for e, w, f in zip(exprs, words, futs):
        res, _ = f.result(timeout=TIMEOUT)
        np.testing.assert_array_equal(np.asarray(res), pc(np_eval(e, w)))
    snap = co.snapshot()
    assert snap["fuse_fallbacks"] == 1 and snap["fused_launches"] == 1


def test_fuse_disabled_keeps_concat_semantics(scheduler):
    co = scheduler(fuse=False)
    rng = np.random.default_rng(8)
    words = [rand_words(rng, 2, 2) for _ in EXPRS]
    futs = [co.submit(e, "count", rows_table(w)) for e, w in zip(EXPRS, words)]
    for e, w, f in zip(EXPRS, words, futs):
        res, info = f.result(timeout=TIMEOUT)
        assert "fused" not in info
        np.testing.assert_array_equal(np.asarray(res), pc(np_eval(e, w)))
    snap = co.snapshot()
    assert snap["fused_launches"] == 0 and snap["launches"] == len(EXPRS)


def test_total_over_distinct_tables_and_one_table(scheduler):
    """"total" never concatenates: waiters of one table share one K2
    launch, distinct tables of one tree run as distinct programs of one
    interpreter launch."""
    co = scheduler()
    rng = np.random.default_rng(9)
    w = rand_words(rng, 3, 2)
    t = rows_table(w)
    futs = [co.submit(AND01, "total", t) for _ in range(3)]
    for f in futs:
        res, info = f.result(timeout=TIMEOUT)
        assert res == int(pc(np_eval(AND01, w)).sum()) and info["total"]
    assert co.snapshot()["launches"] == 1
    ws = [rand_words(rng, 3, 2) for _ in range(3)]
    futs = [co.submit(AND01, "total", rows_table(x)) for x in ws]
    for x, f in zip(ws, futs):
        res, info = f.result(timeout=TIMEOUT)
        assert res == int(pc(np_eval(AND01, x)).sum()) and info["fused"]
    assert co.snapshot()["fused_launches"] == 1


def test_shared_fetch_batches_round_trips(scheduler):
    co = scheduler()
    arrays = [torch.arange(i + 1, dtype=torch.int32) for i in range(6)]
    futs = [co.submit_fetch([a, a * 2]) for a in arrays]
    for a, f in zip(arrays, futs):
        (x, y), info = f.result(timeout=TIMEOUT)
        np.testing.assert_array_equal(x, a.numpy())
        np.testing.assert_array_equal(y, 2 * a.numpy())
    snap = co.snapshot()
    assert snap["fetch_arrays"] == 12 and snap["fetch_launches"] < len(futs)


def test_abandoned_waiter_error_is_consumed():
    seen = []

    class Stats:
        def count(self, name):
            seen.append(name)

    fut = concurrent.futures.Future()
    fut.add_done_callback(co_mod.consume_abandoned(Stats()))
    fut.set_exception(RuntimeError("launch failed"))
    assert seen == ["exec.coalesce.abandonedErrors"]


# --- the executor wired to it --------------------------------------------------


@pytest.fixture
def holder(tmp_path):
    h = THolder(str(tmp_path / "data"), device="cpu")
    h.open()
    f = h.create_index("i").create_frame("f", cache_size=64)
    rng = np.random.default_rng(10)
    for _ in range(400):
        f.set_bit("standard", int(rng.integers(0, 6)), int(rng.integers(0, 3 * SW)))
    yield h
    h.close()


B = "Bitmap(frame=f, rowID={})"
MIX = [
    f"Count(Intersect({B.format(1)}, {B.format(2)}))",
    f"Count(Union({B.format(1)}, {B.format(3)}))",
    f"Count(Difference({B.format(0)}, {B.format(4)}, {B.format(5)}))",
    f"Count(Xor({B.format(2)}, {B.format(5)}))",
    B.format(1),
    f"Union({B.format(2)}, {B.format(3)})",
    f"Intersect({B.format(0)}, Union({B.format(4)}, {B.format(5)}))",
    "TopN(frame=f, n=3)",
    f"TopN({B.format(1)}, frame=f, n=2)",
    f"Count({B.format(99)})",
]


def canon(result):
    if hasattr(result, "bits"):
        return ("bits", tuple(result.bits()))
    if isinstance(result, list):
        return ("pairs", tuple((p.id, p.count) for p in result))
    return ("val", int(result))


def run_mix(ex, queries):
    return [canon(ex.execute("i", parse_string(q))[0]) for q in queries]


def test_coalesce_on_off_identical_results(holder, scheduler):
    direct = Executor(holder)
    coalesced = Executor(holder, coalescer=scheduler(max_wait_us=0))
    try:
        assert run_mix(coalesced, MIX) == run_mix(direct, MIX)
        assert coalesced.coalescer.snapshot()["launches"] > 0
        assert coalesced.coalescer.snapshot()["fetch_launches"] > 0  # TopN(src)'s scores
    finally:
        direct.close()
        coalesced.close()


def test_concurrent_storm_fewer_launches_than_queries(holder, scheduler):
    co = scheduler(max_wait_us=2000)
    ex = Executor(holder, coalescer=co)
    direct = Executor(holder)
    try:
        queries = [q for q in MIX if not q.startswith("TopN")] * 6
        want = dict(zip(queries, run_mix(direct, queries)))
        start = threading.Barrier(8)

        def client(k):
            start.wait(timeout=TIMEOUT)
            return [(q, canon(ex.execute("i", parse_string(q))[0]))
                    for q in queries[k::8]]

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = [r for f in [pool.submit(client, k) for k in range(8)]
                   for r in f.result(timeout=TIMEOUT)]
        assert all(res == want[q] for q, res in got)
        snap = co.snapshot()
        assert snap["queries"] == sum(1 for q in queries if "99" not in q)
        assert snap["launches"] < snap["queries"]
    finally:
        ex.close()
        direct.close()


def test_closed_coalescer_falls_back_to_direct_path(holder, scheduler):
    co = scheduler()
    ex = Executor(holder, coalescer=co)
    direct = Executor(holder)
    try:
        co.close()
        assert run_mix(ex, MIX) == run_mix(direct, MIX)
        assert co.snapshot()["launches"] == 0
    finally:
        ex.close()
        direct.close()


def test_prewarm_launches_each_query_kernel_once(monkeypatch):
    """``warmup.prewarm`` runs K2's and K3's three reduces and K1 once on
    zero rows (on the CPU, their plain versions; nothing to build)."""
    from pilosa_tpu_torch.exec import warmup
    from pilosa_tpu_torch.ops import fused_popcount as fp
    from pilosa_tpu_torch.ops import interp as it

    seen: list = []
    for mod, name in ((te, "plain_tree_eval"), (it, "plain_interp"),
                      (fp, "plain_row_popcounts")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (seen.append(_n),
                                                                           _r(*a, **k))[1])
    assert warmup.prewarm("cpu") == 7
    assert sorted(seen) == (["plain_interp"] * 3 + ["plain_row_popcounts"]
                            + ["plain_tree_eval"] * 3)
    t = warmup.prewarm_async("cpu")
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()


@pytest.mark.parametrize("fuse", [True, False])
def test_dispatcher_keeps_no_table_after_its_launch(scheduler, fuse):
    """A drained table holds every mirror it names: once its launch is
    done the dispatcher, waiting for work, must hold none of them (an
    evicted mirror would stay allocated)."""
    import gc
    import time
    import weakref

    co = scheduler(max_wait_us=0, fuse=fuse)
    words = rand_words(np.random.default_rng(11), 2, 2)
    table = rows_table(words)
    ref = weakref.ref(table.bases[0])
    fut = co.submit(AND01, "count", table)
    fut.result(timeout=TIMEOUT)
    del table, fut
    deadline = time.monotonic() + TIMEOUT
    while ref() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert ref() is None
