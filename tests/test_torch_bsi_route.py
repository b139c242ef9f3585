"""BSI trees on the port's main route — the batch cache and the coalescer
(JAX ``executor.py:1037-1060``, ``plan.py:529-556``) — against the JAX
package on the CPU:

* ``Count``, ``Bitmap`` and ``Range`` (every comparison and ``><``) and
  ``Sum`` / ``Min`` / ``Max``, with and without a filter, answer a JAX
  node's bytes in JSON and protobuf;
* a repeated query is a batch-cache hit that builds nothing on the host
  (no build, no leaf stacks), and an ``/import-value`` invalidates it;
* a mix of BSI and row trees through the coalescer answers as the JAX
  executor does, the row trees fused into interpreter launches (the plain
  K3 here) and each BSI tree on its per-key ripple launch; the mix
  lowered into one interpreter program, BSI comparisons included, answers
  the same."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu import device as jdevice  # noqa: E402
from pilosa_tpu.core.holder import Holder as JHolder  # noqa: E402
from pilosa_tpu.device.pool import PlanePool as JPool  # noqa: E402
from pilosa_tpu.exec.executor import Executor as JExecutor  # noqa: E402
from pilosa_tpu.pql import parse_string as jparse  # noqa: E402
from pilosa_tpu_torch import device as tdevice  # noqa: E402
from pilosa_tpu_torch.core.holder import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.device.pool import PlanePool as TPool  # noqa: E402
from pilosa_tpu_torch.exec import coalesce as co_mod  # noqa: E402
from pilosa_tpu_torch.exec import executor as texec  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.obs.stats import ExpvarStatsClient  # noqa: E402
from pilosa_tpu_torch.ops.tree_eval import RowTable  # noqa: E402
from pilosa_tpu_torch.pql import parse_string as tparse  # noqa: E402
from test_torch_bsi_exec import norm  # noqa: E402
from test_torch_topn import ask, http, jax_server  # noqa: E402

SW = 1 << 20
N_SLICES = 3
OPS = ("<", "<=", "==", "!=", ">=", ">")
R = "Range(frame=f, v {} {})"
B = "Bitmap(frame=f, rowID={})"


@pytest.fixture(autouse=True)
def fresh_pools():
    old_t, old_j = tdevice._set_pool(TPool()), jdevice._set_pool(JPool())
    yield
    tdevice._set_pool(old_t)
    jdevice._set_pool(old_j)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data(seed=3):
    """A signed field v over three slices and rows 0-2 of frame f, row 1
    meeting valued columns."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(N_SLICES * SW, size=600, replace=False).astype(np.int64)
    vals = rng.integers(-1000, 1001, size=600).astype(np.int64)
    vals[:3] = (-1000, 1000, 0)
    rows = rng.integers(0, 3, 3000).astype(np.int64)
    bcols = rng.integers(0, N_SLICES * SW, 3000).astype(np.int64)
    rows = np.concatenate([rows, np.ones(120, np.int64)])
    bcols = np.concatenate([bcols, cols[:120]])
    return cols, vals, rows, bcols


def load(holder, d):
    cols, vals, rows, bcols = d
    f = holder.create_index_if_not_exists("i").create_frame_if_not_exists("f")
    f.set_options(range_enabled=True)
    f.create_field("v", -1000, 1000)
    f.import_value("v", cols, vals)
    f.import_bulk(rows, bcols)


QUERIES = (
    [f"Count({R.format(op, p)})" for op in OPS for p in (-1001, -7, 0, 500)]
    + [f"Count({R.format('><', '[-300, 300]')})", f"Count({R.format('><', '[5, -5]')})"]
    + [f"Count(Intersect({B.format(1)}, {R.format('>', 10)}))",
       f"Count(Union({R.format('<', -500)}, {R.format('>=', 900)}, {B.format(2)}))",
       f"Count(Difference({B.format(1)}, {R.format('><', '[-50, 50]')}))",
       R.format("==", 0), R.format("><", "[-20, 40]"),
       f"Intersect({B.format(1)}, {R.format('!=', 3)})"]
    + [f"{agg}(frame=f, field=v)" for agg in ("Sum", "Min", "Max")]
    + [f"{agg}({B.format(1)}, frame=f, field=v)" for agg in ("Sum", "Min", "Max")]
    + [f"{agg}(Intersect({B.format(1)}, {R.format('>', 0)}), frame=f, field=v)"
       for agg in ("Sum", "Max")]
)


@pytest.fixture
def nodes(tmp_path):
    j = jax_server(str(tmp_path / "jax"))
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600, floor_probe=False)
    j.open()
    t.open()
    d = data()
    try:
        for s in (j, t):
            load(s.holder, d)
        yield j, t
    finally:
        j.close()
        t.close()


def spy(monkeypatch):
    seen = {"build": 0, "stacks": 0}
    E = texec.Executor
    build, stacks = E._cached_batch_build, E.leaf_stacks

    def b(*a, **kw):
        seen["build"] += 1
        return build(*a, **kw)

    def st(*a, **kw):
        seen["stacks"] += 1
        return stacks(*a, **kw)

    monkeypatch.setattr(E, "_cached_batch_build", b)
    monkeypatch.setattr(E, "leaf_stacks", st)
    return seen


def test_bsi_queries_match_jax_and_repeat_from_the_cache(nodes, monkeypatch):
    j, t = nodes
    seen = spy(monkeypatch)
    for q in QUERIES:
        want = ask(j.host, q)
        assert ask(t.host, q) == want, q  # JSON, then protobuf: a hit
        before = dict(seen)
        assert ask(t.host, q) == want, q
        assert seen == before, q  # repeats build nothing, stack nothing
    # One build a query at most: out-of-window predicates clamp to one
    # rewritten tree, which two queries then share.
    assert seen["stacks"] == 0 and 0 < seen["build"] <= len(QUERIES)


@pytest.mark.parametrize("q", [f"Count({R.format('>', 10)})", R.format("<=", -3),
                               "Sum(frame=f, field=v)",
                               f"Max(Intersect({B.format(1)}, {R.format('>', 0)}), frame=f, field=v)"])
def test_import_value_invalidates_the_entry(nodes, monkeypatch, q):
    j, t = nodes
    seen = spy(monkeypatch)
    assert ask(t.host, q) == ask(j.host, q)
    rng = np.random.default_rng(11)
    cols = rng.choice(SW, size=50, replace=False)
    vals = rng.integers(-1000, 1001, size=50)
    body = json.dumps({"index": "i", "frame": "f", "field": "v", "slice": 0,
                       "columnIDs": cols.tolist(), "values": vals.tolist()}).encode()
    for s in (j, t):
        assert http(s.host, "POST", "/import-value", body)[0] == 200
    builds = seen["build"]
    assert ask(t.host, q) == ask(j.host, q)
    assert seen["build"] == builds + 1
    assert ask(t.host, q) == ask(j.host, q)
    assert seen["build"] == builds + 1


FUSED_MIX = [
    f"Count({R.format('>', 10)})",
    f"Count({R.format('><', '[-300, 300]')})",
    f"Count(Intersect({B.format(1)}, {R.format('<=', 0)}))",
    f"Count(Intersect({B.format(0)}, {B.format(2)}))",
    f"Count(Union({B.format(1)}, {B.format(2)}))",
    R.format("!=", 7),
    f"Difference({B.format(1)}, {R.format('>=', -100)})",
    f"Xor({B.format(0)}, {B.format(1)})",
]


@pytest.fixture
def exec_pair(tmp_path):
    th, jh = THolder(str(tmp_path / "torch"), device="cpu"), JHolder(str(tmp_path / "jax"))
    th.open()
    jh.open()
    d = data(5)
    load(th, d)
    load(jh, d)
    jex = JExecutor(jh)
    made = []

    def port():
        co = co_mod.CoalesceScheduler(max_wait_us=1_000_000)
        ex = texec.Executor(th, coalescer=co)
        made.append((ex, co))
        return ex, co

    try:
        yield port, jex
    finally:
        for ex, co in made:
            co.close()
            ex.close()
        jex.close()
        th.close()
        jh.close()


def run_together(ex, queries):
    """Every query on its own thread at once: they drain together."""
    out = [None] * len(queries)
    start = threading.Barrier(len(queries))

    def run(i):
        start.wait(timeout=30)
        out[i] = [norm(r) for r in ex.execute("i", tparse(queries[i]))]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(queries))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert all(not th.is_alive() for th in threads)
    return out


def test_mix_of_bsi_and_row_trees_through_the_coalescer_matches_jax(exec_pair, monkeypatch):
    """Drained together, the row trees fuse into interpreter launches and
    every BSI tree takes its per-key ripple launch."""
    port, jex = exec_pair
    want = [[norm(r) for r in jex.execute("i", jparse(q))] for q in FUSED_MIX]
    ex, co = port()
    for q in FUSED_MIX:  # build every entry first: the drains then launch only
        ex.execute("i", tparse(q))
    calls = {"direct": 0}
    direct = texec.Executor._direct_eval

    def d(*a, **kw):
        calls["direct"] += 1
        return direct(*a, **kw)

    monkeypatch.setattr(texec.Executor, "_direct_eval", d)
    before = co.snapshot()
    assert run_together(ex, FUSED_MIX) == want
    snap = co.snapshot()
    n_bsi = sum("Range" in q for q in FUSED_MIX)
    assert calls["direct"] == n_bsi
    assert snap["fused_launches"] > before["fused_launches"]
    assert snap["fused_queries"] - before["fused_queries"] <= len(FUSED_MIX) - n_bsi


def test_lowered_mix_of_bsi_and_row_trees_matches_jax(exec_pair):
    """The Counts of the mix lowered into one program over their union
    leaves (BSI comparisons included, as ``plan.lower_expr`` emits them)
    and run by the plain interpreter answer as the JAX executor does."""
    port, jex = exec_pair
    counts = [q for q in FUSED_MIX if q.startswith("Count(")]
    want = [jex.execute("i", jparse(q))[0] for q in counts]
    ex, _co = port()
    slices = list(range(N_SLICES))
    ents = []
    for q in counts:
        child = ex._rewrite_bsi("i", tparse(q).calls[0].children[0])
        expr, leaves = tplan.decompose(child)
        ents.append(ex._cached_batch("i", child, expr, leaves, slices))
    union, src_of, maps = {}, [], []
    for i, (ent, _table) in enumerate(ents):
        lmap = []
        for j, k in enumerate(ent.leaf_keys):
            if k not in union:
                union[k] = len(src_of)
                src_of.append((i, j))
            lmap.append(union[k])
        maps.append(lmap)
    em = tplan.FuseEmitter(len(src_of), 1 << 14)
    regs = [tplan.lower_expr(ent.expr, lmap, em) for (ent, _t), lmap in zip(ents, maps)]
    cols: dict = {}
    for i, j in src_of:
        cols.setdefault(i, []).append(j)
    combined = RowTable.concat_leaves([ents[i][1] for i in sorted(cols)],
                                      [cols[i] for i in sorted(cols)])
    got = tplan.interp_exec("total", combined, em.table(), np.asarray(regs, dtype=np.int32))
    assert [int(x) for x in got] == want


def test_per_key_route_launches_the_ripple_over_the_cached_batch(exec_pair, monkeypatch):
    """Without a coalescer a BSI tree's launch is K8's over the cached
    FieldPlanes (the plain version here), built once."""
    from pilosa_tpu_torch.ops import bsi_ripple as br

    port, jex = exec_pair
    th = port()[0].holder
    th.stats = ExpvarStatsClient()
    ex = texec.Executor(th)
    try:
        made = []
        orig = br.FieldPlanes.__post_init__

        def post(self):
            made.append(self.addrs is not None)
            orig(self)

        monkeypatch.setattr(br.FieldPlanes, "__post_init__", post)
        q = f"Count(Intersect({B.format(1)}, {R.format('>', 10)}))"
        want = [norm(r) for r in jex.execute("i", jparse(q))]
        for _ in range(3):
            assert [norm(r) for r in ex.execute("i", tparse(q))] == want
        # One FieldPlanes checked at the build; each launch reuses its table.
        assert made[0] is False and made[1:] == [True] * 3
        assert th.stats.snapshot()["counts"]["exec.batch.build"] == 1
    finally:
        ex.close()
