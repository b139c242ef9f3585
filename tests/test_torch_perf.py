"""Launch telemetry, latency histograms and the stream-floor probe of the
port against the JAX package's.

* ``PerfRegistry`` and ``LatencyHistograms`` of both packages, fed the
  same records under one fixed clock, give the same snapshot, gauges and
  rendered bytes.
* A fixed request sequence on a port node records, per launch site, as
  many launches as the kernels' wrappers ran.
* K11's plain version equals JAX's ``jnp.sum(a.astype(jnp.int32))``
  exactly on the sizes and patterns ``chip_smoke.py`` phase 3 checks on
  the card.
* The probe's caches, key, size rule, switch and failures.
* Telemetry on costs at most 5% of p99 against telemetry off.
"""

import gc
import json
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.obs import perf as jperf
from pilosa_tpu_torch.device import floorprobe
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.net.server import Server as TServer
from pilosa_tpu_torch.obs import perf as tperf
from pilosa_tpu_torch.obs import stats as tstats
from pilosa_tpu_torch.ops import anchored_count as ac
from pilosa_tpu_torch.ops import interp as interp_mod
from pilosa_tpu_torch.ops import score_planes as sp
from pilosa_tpu_torch.ops import stream_sum as ss
from pilosa_tpu_torch.ops import tree_eval as te
from pilosa_tpu_torch.pql.parser import parse_string

SW = 1 << 20


@pytest.fixture(autouse=True)
def _fresh_registry():
    """The registry is process-global: isolate every test."""
    for r in (tperf.registry(), jperf.registry()):
        r.reset()
        r.set_floor(0.0)
        r.configure(enabled=True)
    yield
    for r in (tperf.registry(), jperf.registry()):
        r.reset()
        r.set_floor(0.0)
        r.configure(enabled=True)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


RECORDS = [
    ("coalesce", dict(reduce="count", queries=4, rows=954, n_bytes=250_000_000,
                      dispatch_ms=0.02, total_ms=0.12, trace_id="t1")),
    ("coalesce", dict(reduce="row", queries=1, rows=16, n_bytes=4_194_304,
                      dispatch_ms=0.01, total_ms=0.0, trace_id="t2")),
    ("interp", dict(reduce="count", queries=9, rows=954 * 8, n_bytes=1_000_000_000,
                    dispatch_ms=0.05, total_ms=0.55, trace_id="t3")),
    ("topn", dict(reduce="topn", rows=954 * 8, n_bytes=1_000_000_000,
                  eff_bytes=900_000_000, dispatch_ms=1.2, total_ms=3.4, trace_id="t4")),
    ("anchored", dict(reduce="count", rows=10, n_bytes=1_310_720, eff_bytes=4096,
                      dispatch_ms=0.3, total_ms=0.9)),
    ("fetch", dict(reduce="fetch", queries=3, n_bytes=12_345, total_ms=0.05)),
    ("total", dict(reduce="total", rows=954, n_bytes=250_000_000, dispatch_ms=0.01,
                   total_ms=0.2)),
]


@pytest.mark.parametrize("floor", [0.0, 3000.0])
def test_registry_matches_jax(floor):
    regs = (jperf.PerfRegistry(), tperf.PerfRegistry())
    for r in regs:
        r.set_floor(floor)
        for _ in range(3):
            for site, kw in RECORDS:
                r.record_launch(site, **kw)
    snaps = [r.snapshot() for r in regs]
    assert json.dumps(snaps[1], sort_keys=True) == json.dumps(snaps[0], sort_keys=True)
    assert regs[1].gauges() == regs[0].gauges()
    off = [jperf.PerfRegistry(enabled=False), tperf.PerfRegistry(enabled=False)]
    for r in off:
        r.record_launch("direct", n_bytes=5, total_ms=1.0)
    assert off[1].snapshot() == off[0].snapshot()
    assert tperf.plane_bytes(3, 64) == jperf.plane_bytes(3, 64) == 768


@pytest.mark.parametrize("slo_ms", [0.0, 25.0])
def test_latency_histograms_match_jax(monkeypatch, slo_ms):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    hists = [mod.LatencyHistograms(buckets_ms=[1, 5, 10, 50], slo_ms=slo_ms, slo_objective=0.99)
             for mod in (jperf, tperf)]
    rng = np.random.default_rng(3)
    for k in range(400):
        ms = float(rng.exponential(12.0))
        cls = ("point", "heavy", "write", "internal")[k % 4]
        for h in hists:
            h.observe_query(cls, ms)
            h.observe_http("POST", "/index/{index}/query", ms / 2)
            if k % 7 == 0:
                h.observe_http("GET", "/metrics", 0.3)
        clock.t += 0.4
    assert hists[1].render() == hists[0].render()
    default = [mod.LatencyHistograms() for mod in (jperf, tperf)]
    assert default[1].buckets == default[0].buckets
    assert default[1].render() == default[0].render() == ""


def test_current_trace_id_outside_and_inside_a_trace():
    from pilosa_tpu_torch.obs import trace

    assert tperf.current_trace_id() == ""
    tr = trace.Tracer()
    root = tr.start_trace("q")
    tok = root.activate()
    try:
        assert tperf.current_trace_id() == root.trace_id
    finally:
        root.deactivate(tok)


# ---------------------------------------------------------------------------
# launch sites
# ---------------------------------------------------------------------------


@pytest.fixture
def spies(monkeypatch):
    """Count every plain-version call of the kernels the sites record:
    on the CPU each wrapper call is one such call."""
    counts = {"K2": 0, "K3": 0, "K4": 0, "K5": 0}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def spy(*a, **kw):
            counts[key] += 1
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)

    wrap(te, "plain_tree_eval", "K2")
    wrap(interp_mod, "plain_interp", "K3")
    wrap(sp, "plain_score_planes", "K4")
    wrap(ac, "plain_anchored_count", "K5")
    return counts


def _post(host, pql, path="/index/i/query"):
    req = urllib.request.Request(f"http://{host}{path}", data=pql.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


B = "Bitmap(frame=f, rowID={})"
SEQUENCE = [
    f"Count(Intersect({B.format(0)}, {B.format(1)}))",
    f"Count(Union({B.format(0)}, {B.format(2)}))",
    f"Intersect({B.format(0)}, {B.format(2)})",
    "TopN(frame=f, n=2)",
    f"TopN({B.format(1)}, frame=f, n=2)",
    f"Count(Intersect({B.format(0)}, {B.format(1)}))",
    f"Count(Intersect({B.format(0)}, {B.format(5)}))",
]


@pytest.mark.parametrize("coalesce", [True, False])
def test_site_launches_equal_kernel_calls(tmp_path, spies, coalesce):
    s = TServer(str(tmp_path / "d"), device="cpu", coalesce=coalesce, floor_probe=False)
    s.open()
    try:
        _post(s.host, "", "/index/i")
        _post(s.host, "", "/index/i/frame/f")
        _post(s.host, " ".join(f"SetBit(frame=f, rowID={r}, columnID={c})"
                               for r in range(3) for c in (1, 5, SW + 9, 2 * SW + 3)))
        # A sparse row beside a dense one: the anchored route (K5).
        _post(s.host, f"SetBit(frame=f, rowID=5, columnID={SW + 9})")
        for k, v in list(spies.items()):
            spies[k] = 0
        tperf.registry().reset()
        for pql in SEQUENCE:
            _post(s.host, pql)
        sites = tperf.registry().snapshot()["sites"]
    finally:
        s.close()
    launches = {k: v["launches"] for k, v in sites.items()}
    k2 = sum(launches.get(k, 0) for k in ("direct", "total", "coalesce"))
    assert k2 == spies["K2"] > 0
    assert launches.get("interp", 0) == spies["K3"]
    assert launches.get("topn", 0) == spies["K4"] >= 1
    assert launches.get("anchored", 0) == spies["K5"]
    if coalesce:
        assert "coalesce" in launches and "direct" not in launches
        assert "fetch" in launches  # the TopN scores through the fetch lane
    else:
        assert launches["total"] >= 3 and launches["direct"] == 1


# ---------------------------------------------------------------------------
# K11: the stream-floor read-sum
# ---------------------------------------------------------------------------

PATTERNS = ["zeros", "ones", "max", "random"]
SIZES = [1, 7, 1023, (1 << 20) + 7, floorprobe.CPU_PROBE_BYTES // 4]


def _words(n: int, pattern: str) -> np.ndarray:
    if pattern == "zeros":
        return np.zeros(n, np.uint32)
    if pattern == "ones":
        return np.ones(n, np.uint32)
    if pattern == "max":
        return np.full(n, 0xFFFFFFFF, np.uint32)
    return np.random.default_rng(n).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n", SIZES)
def test_k11_plain_equals_jax_sum(n, pattern):
    host = _words(n, pattern)
    want = int(jnp.sum(jnp.asarray(host).astype(jnp.int32)))
    x = torch.from_numpy(host.view(np.int32).copy())
    got = ss.plain_stream_sum(x)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want
    assert int(ss.stream_sum(x)) == want  # the CPU wrapper takes the plain version
    assert int(ss.stream_sum(x.view(torch.uint32))) == want
    assert int(ss.library_stream_sum(x)) == want


@pytest.mark.parametrize(
    "bad", [torch.zeros(0, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int64), torch.zeros(8, dtype=torch.int32)[::2]],
)
def test_k11_rejects_outside_its_domain(bad):
    with pytest.raises(ValueError):
        ss.stream_sum(bad)
    with pytest.raises(ValueError):
        ss.plain_stream_sum(bad)


def test_k11_cpu_calls_launch_nothing():
    before = ss.launches
    ss.stream_sum(torch.ones(64, dtype=torch.int32))
    assert ss.launches == before


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def test_probe_measures_and_caches(tmp_path, monkeypatch):
    floorprobe.reset_cache()
    calls = []
    real = floorprobe._measure

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(floorprobe, "_measure", counting)
    stats = tstats.ExpvarStatsClient()
    fp = floorprobe.probe(artifact_dir=str(tmp_path), stats=stats, logger=lambda m: None,
                          device="cpu")
    assert fp["key"] == "cpu:cpu:1"
    assert fp["probe_bytes"] == floorprobe.CPU_PROBE_BYTES
    assert fp["iters"] == floorprobe.TIMED_ITERS
    assert fp["mean_gbps"] > 0 and list(fp["gbps"]) == ["0"]
    assert fp["launches"] == 0  # the CPU's plain version launches nothing
    assert len(calls) == 1
    gauges = stats.snapshot()["gauges"]
    assert gauges["device.streamFloorGbps"] == pytest.approx(fp["mean_gbps"])
    assert gauges["device.streamFloorGbps[device:0]"] == pytest.approx(fp["mean_gbps"])
    # The process cache: no second measurement.
    assert floorprobe.probe(artifact_dir=str(tmp_path), device="cpu")["mean_gbps"] == fp["mean_gbps"]
    assert len(calls) == 1
    # A new process (cache cleared): the disk cache.
    floorprobe.reset_cache()
    assert floorprobe.probe(artifact_dir=str(tmp_path), device="cpu")["mean_gbps"] == \
        pytest.approx(fp["mean_gbps"])
    assert len(calls) == 1
    doc = json.loads((tmp_path / floorprobe.CACHE_FILE).read_text())
    assert set(doc) == {"cpu:cpu:1"}
    floorprobe.probe(artifact_dir=str(tmp_path), force=True, device="cpu")
    assert len(calls) == 2


def test_probe_tolerates_an_unwritable_cache(tmp_path):
    floorprobe.reset_cache()
    blocker = tmp_path / "file"
    blocker.write_text("x")
    fp = floorprobe.probe(artifact_dir=str(blocker / "sub"), device="cpu")
    assert fp["mean_gbps"] > 0
    (tmp_path / floorprobe.CACHE_FILE).write_text("{not json")
    floorprobe.reset_cache()
    assert floorprobe.probe(artifact_dir=str(tmp_path), device="cpu")["mean_gbps"] > 0


def test_probe_raises_when_k11_fails(tmp_path, monkeypatch):
    floorprobe.reset_cache()

    def broken(x):
        raise RuntimeError("stream_sum launch failed: cudaError 209")

    monkeypatch.setattr(ss, "stream_sum", broken)
    with pytest.raises(RuntimeError, match="cudaError"):
        floorprobe.probe(artifact_dir=str(tmp_path), device="cpu")
    assert not (tmp_path / floorprobe.CACHE_FILE).exists()
    s = TServer(str(tmp_path / "d"), device="cpu")
    with pytest.raises(RuntimeError, match="cudaError"):
        s.open()
    s.close()


def test_probe_raises_on_a_wrong_sum(tmp_path, monkeypatch):
    floorprobe.reset_cache()
    monkeypatch.setattr(ss, "stream_sum", lambda x: torch.tensor(5, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="summed"):
        floorprobe.probe(artifact_dir=str(tmp_path), device="cpu")


def test_probe_size_rule(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert floorprobe.probe_bytes(cpu) == 4 << 20

    class Props:
        L2_cache_size = 50 << 20  # an H100's

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    assert floorprobe.probe_bytes(cuda) == 512 << 20
    Props.L2_cache_size = 2 << 20
    assert floorprobe.probe_bytes(cuda) == floorprobe.DEFAULT_PROBE_BYTES
    monkeypatch.setenv(floorprobe.ENV_BYTES, "12345")
    assert floorprobe.probe_bytes(cuda) == floorprobe.probe_bytes(cpu) == 12345
    monkeypatch.setenv(floorprobe.ENV_BYTES, "junk")
    assert floorprobe.probe_bytes(cpu) == 4 << 20


def test_server_open_sets_the_floor_and_the_switch_disables_it(tmp_path):
    floorprobe.reset_cache()
    s = TServer(str(tmp_path / "a"), device="cpu")
    s.open()
    try:
        assert tperf.registry().floor_gbps() > 0
        assert (tmp_path / "a" / floorprobe.CACHE_FILE).exists()
    finally:
        s.close()
    tperf.registry().set_floor(0.0)
    s = TServer(str(tmp_path / "b"), device="cpu", floor_probe=False)
    s.open()
    try:
        assert tperf.registry().floor_gbps() == 0.0
        assert not (tmp_path / "b" / floorprobe.CACHE_FILE).exists()
    finally:
        s.close()


# ---------------------------------------------------------------------------
# the overhead guard
# ---------------------------------------------------------------------------


def test_telemetry_overhead_within_5pct(tmp_path):
    """A Bitmap on the uncoalesced path: the launch and its record run on
    the query thread.  Telemetry on must stay within 5% (+0.1 ms) of off
    at p99, measured as in the JAX package's guard: interleaved batches,
    the calmest round per mode, up to three passes."""
    h = Holder(str(tmp_path / "h"), device="cpu")
    h.open()
    try:
        f = h.create_index("i").create_frame("f")
        for c in list(range(0, 64, 3)) + [SW + 7]:
            f.set_bit("standard", 1, c)
        ex = Executor(h)
        q = parse_string("Bitmap(frame=f, rowID=1)")

        def batch(enabled: bool, n: int, sink: list) -> None:
            tperf.registry().configure(enabled=enabled)
            for _ in range(n):
                t0 = time.perf_counter()
                ex.execute("i", q)
                sink.append(time.perf_counter() - t0)

        def p99(samples: list) -> float:
            return sorted(samples)[int(len(samples) * 0.99)]

        def measure():
            on_p99s, off_p99s = [], []
            gc.collect()
            gc.disable()
            try:
                for _ in range(6):
                    a, b = [], []
                    batch(True, 60, a)
                    batch(False, 60, b)
                    on_p99s.append(p99(a))
                    off_p99s.append(p99(b))
            finally:
                gc.enable()
            return min(on_p99s), min(off_p99s)

        batch(True, 30, [])
        batch(False, 30, [])
        results = []
        for _ in range(3):
            on, off = measure()
            results.append((on, off))
            if on <= off * 1.05 + 100e-6:
                return
        pytest.fail("telemetry overhead too high: " + ", ".join(
            f"on {a * 1e3:.3f} ms vs off {b * 1e3:.3f} ms" for a, b in results))
    finally:
        tperf.registry().configure(enabled=True)
        ex.close()
        h.close()
