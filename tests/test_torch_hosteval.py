"""The port's host fallback (``pilosa_tpu_torch/exec/hosteval.py``) and
the health gate at every launch site of its executor, held against the
JAX package on the same seeded numpy data on the CPU:

* ``HostEvaluator.rows`` / ``counts`` / ``count_total`` /
  ``agg_partials`` / ``score_topn_parts`` give the JAX evaluator's
  arrays byte for byte;
* a JAX ``Executor`` and a port ``Executor`` under the same
  ``device.launch`` plans (an error once, an error until quarantined, an
  OOM on the TopN scorer, a fault on the coalesced launch under
  concurrent waiters) give equal answers, walk the same breaker states
  and count the same retries and host queries; a quarantined port node
  launches no kernel at all; a build error, or a kernel's own fault on
  the card, fails the query instead of falling back; a real OOM anywhere
  in a TopN(src)'s card work (its src, the queued writes, the scorer) is
  answered from the host;
* ``_slices_by_node`` prefers a replica that is not degraded;
* a two-node port cluster with one node's card flapping answers right
  every time and heals through a probe;
* ``GET /debug/health``'s ``device`` section equals a JAX node's in the
  same state."""

import concurrent.futures
import json
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu import device as jdevice  # noqa: E402
from pilosa_tpu.cluster.topology import new_cluster as jnew_cluster  # noqa: E402
from pilosa_tpu.core.holder import Holder as JHolder  # noqa: E402
from pilosa_tpu.device import health as jhealth  # noqa: E402
from pilosa_tpu.device.pool import PlanePool as JPool  # noqa: E402
from pilosa_tpu.exec.coalesce import CoalesceScheduler as JCoalesce  # noqa: E402
from pilosa_tpu.exec.executor import Executor as JExecutor  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu.obs.stats import ExpvarStatsClient as JStats  # noqa: E402
from pilosa_tpu.ops import bitplane as jbp  # noqa: E402
from pilosa_tpu.pql import parse_string as jparse  # noqa: E402
from pilosa_tpu.testing import faults as jfaults  # noqa: E402
from pilosa_tpu_torch import device as tdevice  # noqa: E402
from pilosa_tpu_torch.cluster.topology import Cluster as TCluster  # noqa: E402
from pilosa_tpu_torch.cluster.topology import new_cluster as tnew_cluster  # noqa: E402
from pilosa_tpu_torch.core.holder import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.device import health as thealth  # noqa: E402
from pilosa_tpu_torch.device.pool import PlanePool as TPool  # noqa: E402
from pilosa_tpu_torch.exec import plan as tplan  # noqa: E402
from pilosa_tpu_torch.exec import executor as texecutor  # noqa: E402
from pilosa_tpu_torch.exec.coalesce import CoalesceScheduler as TCoalesce  # noqa: E402
from pilosa_tpu_torch.exec.executor import Executor as TExecutor  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.obs.stats import ExpvarStatsClient as TStats  # noqa: E402
from pilosa_tpu_torch.ops import _build  # noqa: E402
from pilosa_tpu_torch.ops import bsi_ripple, expand_payload, score_planes, tree_eval  # noqa: E402
from pilosa_tpu_torch.ops import delta_scatter, interp  # noqa: E402
from pilosa_tpu_torch.pql import parse_string as tparse  # noqa: E402
from pilosa_tpu_torch.testing import faults as tfaults  # noqa: E402
from test_torch_bsi_exec import norm  # noqa: E402
from test_torch_topn import http  # noqa: E402

SW = 1 << 20
N_SLICES = 3
VMIN, VMAX = -128, 127

MIXED = [
    "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))",
    "Count(Union(Bitmap(rowID=1, frame=f), Bitmap(rowID=3, frame=f)))",
    "Count(Difference(Bitmap(rowID=2, frame=f), Bitmap(rowID=4, frame=f)))",
    "Bitmap(rowID=1, frame=f)",
    "Union(Bitmap(rowID=2, frame=f), Bitmap(rowID=3, frame=f))",
    f"Count(Range(frame=f, v > {VMIN}))",
    f"Count(Range(frame=f, v <= {VMAX}))",
    "Count(Range(frame=f, v == 0))",
    f"Count(Range(frame=f, v >< [{VMIN}, {VMAX}]))",
    "Count(Intersect(Bitmap(rowID=1, frame=f), Range(frame=f, v < -5)))",
    "Range(frame=f, v > 40)",
    "Sum(frame=f, field=v)",
    "Sum(Bitmap(rowID=1, frame=f), frame=f, field=v)",
    "Min(frame=f, field=v)",
    "Max(frame=f, field=v)",
    "TopN(Bitmap(rowID=0, frame=t), frame=t, n=3)",
    "TopN(Bitmap(rowID=2, frame=f), frame=t, n=4, threshold=2)",
    "TopN(frame=t, n=2)",
]
AGGS = ("Sum(", "Min(", "Max(")


def data(seed=11):
    """Frame f: rows 1-4 over three slices and a signed field v; frame t:
    rows 0-5 over two slices, row-dependent density (a clear TopN
    order)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 5, 4000)
    cols = rng.integers(0, N_SLICES * SW, 4000)
    vcols = rng.choice(N_SLICES * SW, 400, replace=False)
    vals = rng.integers(VMIN, VMAX + 1, 400)
    vals[:3] = (VMIN, VMAX, 0)
    trows = rng.integers(0, 6, 6000)
    keep = rng.random(6000) < (trows + 1) / 6
    tcols = rng.integers(0, 2 * SW, 6000)
    # Row 2 of f meets frame t's columns, for the cross-frame src.
    rows = np.concatenate([rows, np.full(300, 2)])
    cols = np.concatenate([cols, tcols[:300]])
    return (rows, cols, vcols, vals, trows[keep], tcols[keep])


def load(holder, d):
    rows, cols, vcols, vals, trows, tcols = d
    idx = holder.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("f", cache_size=64)
    f.import_bulk(rows, cols)
    f.set_options(range_enabled=True)
    f.create_field("v", VMIN, VMAX)
    f.import_value("v", vcols, vals)
    idx.create_frame_if_not_exists("t", cache_size=64).import_bulk(trows, tcols)


@pytest.fixture(autouse=True)
def env():
    """Fresh pools, no fault plan, and one JAX device: the port runs on
    one card, so the JAX breaker must gate one device path too."""
    old_t, old_j = tdevice._set_pool(TPool()), jdevice._set_pool(JPool())
    old_mesh = jbp._MESH_DEVICES_OVERRIDE
    jbp.configure_mesh_devices(1)
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()
    jbp.configure_mesh_devices(old_mesh)
    tdevice._set_pool(old_t)
    jdevice._set_pool(old_j)


@pytest.fixture
def holders(tmp_path):
    j, t = JHolder(str(tmp_path / "jax")), THolder(str(tmp_path / "torch"), device="cpu")
    j.stats, t.stats = JStats(), TStats()
    j.open()
    t.open()
    d = data()
    load(j, d)
    load(t, d)
    yield j, t
    j.close()
    t.close()


class Pair:
    """A JAX and a port executor, each with its own breaker (threshold 2,
    a long open window unless asked) and optionally a coalescer."""

    def __init__(self, holders, coalesce=False, open_ms=3_600_000.0, threshold=2):
        self.jh, self.th = holders
        self.jdh = jhealth.DeviceHealth(quarantine_threshold=threshold, open_ms=open_ms,
                                        watchdog_ms=0, stats=self.jh.stats)
        self.tdh = thealth.DeviceHealth(quarantine_threshold=threshold, open_ms=open_ms,
                                        watchdog_ms=0, stats=self.th.stats, device="cpu")
        self.jco = JCoalesce(max_wait_us=20_000, health=self.jdh) if coalesce else None
        self.tco = TCoalesce(max_wait_us=20_000) if coalesce else None
        jc, tc = jnew_cluster(1), tnew_cluster(1)
        host = jc.nodes[0].host
        self.jex = JExecutor(self.jh, host=host, cluster=jc, coalescer=self.jco,
                             device_health=self.jdh)
        self.tex = TExecutor(self.th, host=host, cluster=tc, coalescer=self.tco,
                             device_health=self.tdh)

    def close(self):
        for x in (self.jex, self.tex, self.jco, self.tco, self.jdh, self.tdh):
            if x is not None:
                x.close()

    def ask(self, q):
        return (norm(self.jex.execute("i", jparse(q))[0]),
                norm(self.tex.execute("i", tparse(q))[0]))

    def states(self):
        return tuple(dh.snapshot()["paths"].get("device:0", {}).get("state")
                     for dh in (self.jdh, self.tdh))

    def counts(self):
        out = []
        for h in (self.jh, self.th):
            c = h.stats.snapshot()["counts"]
            out.append({k: v for k, v in c.items()
                        if k.startswith(("device.launch.retries", "exec.hostEval.queries",
                                         "device.health."))})
        return out

    def install(self, spec):
        jfaults.install(spec)
        tfaults.install(spec)

    def clear(self):
        jfaults.clear()
        tfaults.clear()


@pytest.fixture
def pair(holders):
    p = Pair(holders)
    yield p
    p.close()


def expected(holders):
    p = Pair(holders)
    try:
        out = []
        for q in MIXED:
            j, t = p.ask(q)
            assert j == t, q
            out.append(j)
        return out
    finally:
        p.close()


# ---------------------------------------------------------------------------
# the evaluator alone
# ---------------------------------------------------------------------------

TREES = [q for q in MIXED if not q.startswith(("TopN", "Sum", "Min", "Max"))]


def _tree(parse, q):
    c = parse(q).calls[0]
    return c.children[0] if c.name == "Count" else c


def _same_rows(a: dict, b: dict, dtype=None) -> None:
    """Equal bytes per slice, in ``dtype`` when given."""
    assert a.keys() == b.keys()
    for s in a:
        assert (a[s] is None) == (b[s] is None), s
        if a[s] is not None:
            x, y = np.asarray(a[s], dtype=dtype), np.asarray(b[s], dtype=dtype)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), s


@pytest.mark.parametrize("q", TREES)
def test_hosteval_rows_and_counts_equal_jax(pair, q):
    slices = list(range(N_SLICES))
    jc, tc = _tree(jparse, q), _tree(tparse, q)
    _same_rows(pair.jex.hosteval.rows("i", jc, slices), pair.tex.hosteval.rows("i", tc, slices))
    assert pair.jex.hosteval.counts("i", jc, slices) == pair.tex.hosteval.counts("i", tc, slices)
    assert (pair.jex.hosteval.count_total("i", jc, slices)
            == pair.tex.hosteval.count_total("i", tc, slices))


@pytest.mark.parametrize("q", [q for q in MIXED if q.startswith(AGGS)])
def test_hosteval_agg_partials_equal_jax(pair, q):
    slices = list(range(N_SLICES))
    jrc = pair.jex._rewrite_bsi_agg("i", jparse(q).calls[0])
    trc = pair.tex._rewrite_bsi_agg("i", tparse(q).calls[0])
    # The JAX numpy ripple's Sum popcounts are int64, the port's int32:
    # both exact (a slice has 2^20 columns), the same vectors in int64.
    _same_rows(pair.jex.hosteval.agg_partials("i", jrc, slices),
               pair.tex.hosteval.agg_partials("i", trc, slices), dtype=np.int64)


def _capture_host_scores(monkeypatch, ex, seen):
    real = type(ex.hosteval).score_topn_parts

    def spy(self, parts):
        real(self, parts)
        for p in parts:
            st, frag = p[0], p[-1]
            seen[(frag.slice, tuple(st.cand_ids[st.dense_pos]))] = np.asarray(st.counts).tobytes()

    monkeypatch.setattr(type(ex.hosteval), "score_topn_parts", spy)


@pytest.mark.parametrize("q", [q for q in MIXED if q.startswith("TopN(Bitmap")])
def test_hosteval_score_topn_parts_equal_jax(pair, monkeypatch, q):
    jseen, tseen = {}, {}
    _capture_host_scores(monkeypatch, pair.jex, jseen)
    _capture_host_scores(monkeypatch, pair.tex, tseen)
    for dh, health in ((pair.jdh, jhealth), (pair.tdh, thealth)):
        dh.failure(dh.device_paths(), health.KIND_OOM)
        dh.failure(dh.device_paths(), health.KIND_OOM)
    j, t = pair.ask(q)
    assert j == t
    assert jseen and jseen == tseen


# ---------------------------------------------------------------------------
# the executors under the same fault plans
# ---------------------------------------------------------------------------


def _count_plain_launches(monkeypatch):
    """On the CPU every wrapper takes its plain version: count those calls
    as the kernels' launches (K2, K3, K4, K5, K6, K7, K8)."""
    from pilosa_tpu_torch.ops import anchored_count

    seen = {}
    for mod, name in ((tree_eval, "plain_tree_eval"), (interp, "plain_interp"),
                      (score_planes, "score_planes"), (anchored_count, "anchored_count"),
                      (expand_payload, "expand_payloads"),
                      (delta_scatter, "plain_delta_scatter_many"),
                      (bsi_ripple, "bsi_cmp"), (bsi_ripple, "bsi_sum"),
                      (bsi_ripple, "bsi_minmax")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _key=f"{mod.__name__}.{name}", **k):
            seen[_key] = seen.get(_key, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return seen


def test_quarantined_port_serves_from_host_and_launches_nothing(holders, monkeypatch):
    want = expected(holders)
    p = Pair(holders)
    try:
        for dh, health in ((p.jdh, jhealth), (p.tdh, thealth)):
            dh.failure(dh.device_paths(), health.KIND_OOM)
            dh.failure(dh.device_paths(), health.KIND_OOM)
        seen = _count_plain_launches(monkeypatch)
        for q, w in zip(MIXED, want):
            before = dict(seen)
            j, t = p.ask(q)
            assert j == w and t == w, q
            made = {k: v - before.get(k, 0) for k, v in seen.items() if v != before.get(k, 0)}
            # TopN too: its src, its prep and its scores come from the host.
            assert made == {}, (q, made)
        assert p.states() == ("quarantined", "quarantined")
        jc, tc = p.counts()
        assert {k: v for k, v in jc.items() if "hostEval" in k} == \
            {k: v for k, v in tc.items() if "hostEval" in k}
        assert tc["exec.hostEval.queries[kind:count]"] >= 7
    finally:
        p.close()


PLANS = {
    # One transient error: retried once, answered by the card.
    "error-once": ("device.launch:kind=error,times=1", 2),
    # A card that fails every launch: suspect, then quarantined; every
    # answer from the host.
    "error-until-quarantined": ("device.launch:mode=error", 2),
    # An OOM on the scorer: never retried, counted against the breaker.
    "oom-on-topn": ("device.launch:kind=oom,path=topn", 3),
    # Every second direct launch fails (a flapping card).
    "flapping": ("device.launch:path=direct,kind=error,prob=0.5,seed=3", 4),
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_executors_agree_under_the_same_fault_plan(holders, plan):
    want = expected(holders)
    spec, threshold = PLANS[plan]
    p = Pair(holders, threshold=threshold)
    try:
        p.install(spec)
        states = []
        for q, w in zip(MIXED, want):
            j, t = p.ask(q)
            assert j == w and t == w, q
            states.append(p.states())
        assert [s[0] for s in states] == [s[1] for s in states]
        jc, tc = p.counts()
        assert jc == tc
        if plan == "error-once":
            assert tc["device.launch.retries"] == 1
            assert not any("hostEval" in k for k in tc)
        if plan == "error-until-quarantined":
            assert states[-1] == ("quarantined", "quarantined")
        if plan == "oom-on-topn":
            assert "device.launch.retries" not in tc
            assert tc["exec.hostEval.queries[kind:topn]"] == 2
    finally:
        p.close()


def test_probe_heals_and_first_read_applies_the_queued_writes(holders):
    p = Pair(holders, open_ms=150.0)
    try:
        before = p.ask(MIXED[0])
        p.install("device.launch:mode=error")
        for q in MIXED[:4]:
            p.ask(q)
        assert p.states() == ("quarantined", "quarantined")
        # Writes during the quarantine queue on the host; the host answers
        # them at once.
        for ex, parse in ((p.jex, jparse), (p.tex, tparse)):
            for col in (5, SW + 6, 2 * SW + 7):
                ex.execute("i", parse(f"SetBit(frame=f, rowID=1, columnID={col})"))
                ex.execute("i", parse(f"SetBit(frame=f, rowID=2, columnID={col})"))
        quarantined = p.ask(MIXED[0])
        assert quarantined[0] == quarantined[1] > before[0]
        p.clear()
        time.sleep(0.2)
        healed = p.ask(MIXED[0])  # the probe: the card applies the queue first
        assert healed == quarantined
        assert p.states() == ("healthy", "healthy")
        jc, tc = p.counts()
        assert jc["device.health.heals"] == tc["device.health.heals"] == 1
        assert jc == tc
    finally:
        p.close()


def test_coalesced_fault_fails_over_per_waiter(holders):
    """A fault on every coalesced launch under concurrent waiters: each
    waiter retries directly on its own — the same answers and the same
    retry count as a JAX executor, nothing quarantined; then a card that
    fails everything under the same storm: zero wrong answers, and a
    heal after the fault clears."""
    want = dict(zip(MIXED, expected(holders)))
    # The port launches aggregates per key, off the coalescer: a
    # ``coalesce`` rule never reaches them (JAX coalesces them too).
    queries = [q for q in MIXED if not q.startswith(AGGS)]
    p = Pair(holders, coalesce=True, open_ms=100.0, threshold=3)
    try:
        p.install("device.launch:path=coalesce,kind=error")

        def run_mix(t):
            order = queries[t:] + queries[:t]
            return {q: p.ask(q) for q in order}

        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            for got in pool.map(run_mix, range(6)):
                for q, (j, t) in got.items():
                    assert j == want[q] and t == want[q], q
        jc, tc = p.counts()
        assert jc == tc and tc["device.launch.retries"] > 0
        assert p.states() == ("healthy", "healthy")
        p.install("device.launch:mode=error")
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            for got in pool.map(run_mix, range(6)):
                for q, (j, t) in got.items():
                    assert j == want[q] and t == want[q], q
        assert p.jdh.degraded() and p.tdh.degraded()
        p.clear()
        time.sleep(0.13)
        assert [p.ask(q)[1] for q in MIXED] == list(want.values())
        assert not p.tdh.degraded()
    finally:
        p.close()


def test_build_error_fails_the_query_loudly(pair, monkeypatch):
    """A kernel that cannot build is no device fault: the query fails and
    the breaker never moves — no quiet host answer."""
    def broken(*a, **k):
        raise _build.KernelBuildError("tree_eval: nvcc exited 1")

    monkeypatch.setattr(tplan, "tree_eval", broken)
    with pytest.raises(_build.KernelBuildError):
        pair.tex.execute("i", tparse(MIXED[0]))
    assert pair.tdh.snapshot()["paths"]["device:0"] == {
        "state": "healthy", "consecutiveFailures": 0, "quarantines": 0}
    assert not any("hostEval" in k for k in pair.counts()[1])


def _kernel_fault(*a, **k):
    raise getattr(torch, "AcceleratorError", RuntimeError)(
        "CUDA error: an illegal memory access was encountered")


def test_kernel_fault_on_the_card_fails_the_query_loudly(holders, monkeypatch):
    """A hand-written kernel's own fault on the card (an illegal address,
    which leaves the context unusable) is no device fault: the query
    fails, the breaker does not move and the host answers nothing — also
    when the failing launch is a half-open probe, which it releases, so
    that the next query probes again instead of the node staying on the
    host."""
    accel = getattr(torch, "AcceleratorError", RuntimeError)
    p = Pair(holders, open_ms=50.0)
    try:
        monkeypatch.setattr(tplan, "tree_eval", _kernel_fault)
        with pytest.raises(accel):
            p.tex.execute("i", tparse(MIXED[0]))
        assert p.tdh.snapshot()["paths"]["device:0"] == {
            "state": "healthy", "consecutiveFailures": 0, "quarantines": 0}
        # Quarantined, the window past: the failing launch is the probe.
        p.tdh.failure(p.tdh.device_paths(), thealth.KIND_OOM)
        p.tdh.failure(p.tdh.device_paths(), thealth.KIND_OOM)
        time.sleep(0.08)
        with pytest.raises(accel):
            p.tex.execute("i", tparse(MIXED[0]))
        path = p.tdh.snapshot()["paths"]["device:0"]
        assert (path["state"], path["probing"], path["failures"]) == (
            "quarantined", False, {"oom": 2})
        assert not any("hostEval" in k for k in p.counts()[1])
        monkeypatch.undo()
        j, t = p.ask(MIXED[0])  # the next query is the probe, and heals
        assert j == t
        assert p.tdh.snapshot()["paths"]["device:0"]["state"] == "healthy"
        assert not any("hostEval" in k for k in p.counts()[1])
    finally:
        p.close()


def _real_oom(*a, **k):
    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("where", ["leaf_stacks", "apply_pending_many", "score_planes"])
@pytest.mark.parametrize("q", [
    "TopN(Bitmap(rowID=2, frame=f), frame=t, n=4, threshold=2)",
    "TopN(Bitmap(rowID=0, frame=t), frame=t, ids=[0, 1, 2, 3, 4, 5])",
], ids=["folded", "map-leg"])
def test_topn_card_fault_in_its_prep_answers_from_the_host(pair, monkeypatch, where, q):
    """A real OOM from any card work of a TopN(src) — its src tree's leaf
    stacks (K6), the queued writes' apply (K7) or the scorer (K4), on the
    folded route and on a map leg — is classified, counted once against
    the breaker and answered from the host, equal to the JAX
    executor's answer."""
    target = {"leaf_stacks": (TExecutor, "leaf_stacks"),
              "apply_pending_many": (texecutor, "apply_pending_many"),
              "score_planes": (score_planes, "score_planes")}[where]
    monkeypatch.setattr(*target, _real_oom)
    j, t = pair.ask(q)
    assert j == t and j
    path = pair.tdh.snapshot()["paths"]["device:0"]
    assert (path["state"], path["failures"]) == ("suspect", {"oom": 1})
    assert pair.counts()[1] == {"device.health.failures[kind:oom]": 1,
                                "exec.hostEval.queries[kind:topn]": 1}


def test_memoized_topn_does_not_heal_the_card(holders):
    """A TopN(src) answered from its prep entry's memoized scores makes no
    launch: past the quarantine window it neither heals the card nor
    holds the probe (the JAX executor does not even ask), and the next
    Count is the probe that heals both."""
    q = "TopN(Bitmap(rowID=0, frame=t), frame=t, n=3)"
    p = Pair(holders, open_ms=50.0)
    try:
        first = p.ask(q)
        for dh, health in ((p.jdh, jhealth), (p.tdh, thealth)):
            dh.failure(dh.device_paths(), health.KIND_OOM)
            dh.failure(dh.device_paths(), health.KIND_OOM)
        time.sleep(0.08)
        assert p.ask(q) == first
        assert p.states() == ("quarantined", "quarantined")
        assert p.tdh.snapshot()["paths"]["device:0"]["probing"] is False
        j, t = p.ask(MIXED[0])
        assert j == t and p.states() == ("healthy", "healthy")
        jc, tc = p.counts()
        assert jc == tc and tc["device.health.heals"] == 1
        assert not any("hostEval" in k for k in tc)
    finally:
        p.close()


# ---------------------------------------------------------------------------
# degraded replicas
# ---------------------------------------------------------------------------


def test_slices_by_node_prefers_non_degraded_replica(tmp_path):
    h = THolder(str(tmp_path / "d"), device="cpu")
    h.open()
    try:
        cluster = TCluster(replica_n=2)
        cluster.add_node("127.0.0.1:1")
        cluster.add_node("127.0.0.1:2")
        h.create_index("i")
        ex = TExecutor(h, host="127.0.0.1:1", cluster=cluster)
        try:
            slices = [0, 1, 2, 3]
            base = ex._slices_by_node(cluster.nodes, "i", slices)
            assert sum(len(v[1]) for v in base.values()) == len(slices)
            # Degrade node 1: everything routes to node 2, and the health
            # version bump invalidates the routing cache.
            assert cluster.note_degraded("127.0.0.1:1", True)
            m = ex._slices_by_node(cluster.nodes, "i", slices)
            assert set(m) == {"127.0.0.1:2"}
            # Both degraded: primary-order routing again.
            assert cluster.note_degraded("127.0.0.1:2", True)
            assert ex._slices_by_node(cluster.nodes, "i", slices).keys() == base.keys()
            assert cluster.note_degraded("127.0.0.1:1", False)
            assert cluster.note_degraded("127.0.0.1:2", False)
            assert ex._slices_by_node(cluster.nodes, "i", slices).keys() == base.keys()
            assert not cluster.note_degraded("127.0.0.1:2", False)  # no-op
            assert not cluster.note_degraded("127.0.0.1:9", True)  # unknown host
        finally:
            ex.close()
    finally:
        h.close()


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _query(host, q):
    status, body = http(host, "POST", "/index/i/query", q.encode())
    assert status == 200, body
    return json.loads(body)["results"][0]


def _health(host):
    status, body = http(host, "GET", "/debug/health")
    assert status == 200
    return json.loads(body)


def test_two_node_cluster_with_a_flapping_card(tmp_path):
    """One node's card fails every launch (a ``host=`` rule): queries
    through the healthy coordinator stay right while that node
    quarantines and answers its slices from its host planes; it heals
    through a probe once the fault clears."""
    hosts = sorted(f"127.0.0.1:{_free_port()}" for _ in range(2))
    servers = [TServer(str(tmp_path / f"n{i}"), host=h, device="cpu", hosts=hosts,
                       polling_interval=3600, floor_probe=False, quarantine_threshold=2,
                       quarantine_open_ms=200.0, launch_watchdog_ms=0.0)
               for i, h in enumerate(hosts)]
    for s in servers:
        s.open()
    s0, s1 = servers
    try:
        n_slices = 4
        for s in servers:
            s.holder.create_index_if_not_exists("i").create_frame_if_not_exists("f")
        for sl in range(n_slices):
            owner = s0.cluster.fragment_nodes("i", sl)[0].host
            srv = s0 if owner == s0.host else s1
            f = srv.holder.frame("i", "f")
            for row in (1, 2):
                f.set_bit("standard", row, sl * SW + row)
            f.set_bit("standard", 1, sl * SW + 7)
        for s in servers:
            s.holder.index("i").set_remote_max_slice(n_slices - 1)
        assert {s0.cluster.fragment_nodes("i", sl)[0].host for sl in range(n_slices)} == set(hosts)
        queries = [
            "Count(Bitmap(rowID=1, frame=f))",
            "Count(Union(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))",
            "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))",
            "Bitmap(rowID=2, frame=f)",
        ]
        want = [_query(s1.host, q) for q in queries]
        assert want[0] == 2 * n_slices
        tfaults.install(f"device.launch:mode=error,host={s0.host}")
        for _ in range(4):
            assert [_query(s1.host, q) for q in queries] == want
        h0 = _health(s0.host)
        assert h0["node"] == s0.host and [n["host"] for n in h0["nodes"]] == hosts
        assert h0["device"]["degraded"] is True
        assert h0["device"]["paths"]["device:0"]["state"] == "quarantined"
        assert s0.cluster.node_by_host(s0.host).degraded
        assert _health(s1.host)["device"]["degraded"] is False
        tfaults.clear()
        time.sleep(0.25)
        assert [_query(s1.host, q) for q in queries] == want
        assert _health(s0.host)["device"]["degraded"] is False
        assert not s0.cluster.node_by_host(s0.host).degraded
    finally:
        for s in servers:
            s.close()


def test_debug_health_device_section_equals_jax(tmp_path):
    j = JServer(data_dir=str(tmp_path / "jax"), host="127.0.0.1:0", anti_entropy_interval=3600,
                polling_interval=3600, cache_flush_interval=3600, admission=False,
                mesh_devices=1, quarantine_threshold=2, launch_watchdog_ms=0.0)
    t = TServer(str(tmp_path / "torch"), device="cpu", polling_interval=3600,
                floor_probe=False, quarantine_threshold=2, launch_watchdog_ms=0.0)
    j.open()
    t.open()
    try:
        d = data()
        load(j.holder, d)
        load(t.holder, d)
        sections = []
        for s in (j, t):
            for q in MIXED[:2]:
                _query(s.host, q)
        spec = "device.launch:kind=error,times=1;device.launch:kind=oom"
        jfaults.install(spec)
        tfaults.install(spec)
        for s in (j, t):
            for q in MIXED[:5]:
                _query(s.host, q)
            dev = _health(s.host)["device"]
            for st in dev["paths"].values():
                assert st.pop("sinceQuarantineMs") >= 0
            sections.append(dev)
        assert sections[0] == sections[1]
        assert sections[1]["paths"]["device:0"]["state"] == "quarantined"
    finally:
        j.close()
        t.close()
