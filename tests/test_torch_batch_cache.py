"""The executor's batch cache and the coalesced query path, on the CPU,
against the JAX package and numpy: a hit reuses the entry, a write (even
one only queued for K7) makes the same Count rebuild and change, a mirror
evicted under an entry is freed and the next query rebuilds, a time
Range leaf follows a quantum change, the ``"cache"`` bytes stay under a
budget, and a port ``Server(device="cpu")`` and a JAX ``Server`` answer
one concurrent storm of distinct Count and Bitmap trees byte for byte, in
JSON and protobuf, with coalescing on and off."""

import concurrent.futures
import gc
import importlib
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu import device as jdevice  # noqa: E402
from pilosa_tpu.core.holder import Holder as JHolder  # noqa: E402
from pilosa_tpu.exec.executor import Executor as JExecutor  # noqa: E402
from pilosa_tpu.net import wire_pb2 as pb  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu.pql.parser import parse_string as jparse  # noqa: E402
from pilosa_tpu_torch import device as tdevice  # noqa: E402
from pilosa_tpu_torch.core import fragment as tfr  # noqa: E402
from pilosa_tpu_torch.core.holder import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.exec.executor import Executor  # noqa: E402
from pilosa_tpu_torch.net.server import Server as TServer  # noqa: E402
from pilosa_tpu_torch.pql import parse_string  # noqa: E402

tpool = importlib.import_module("pilosa_tpu_torch.device.pool")
jpool = importlib.import_module("pilosa_tpu.device.pool")

SW = 1 << 20
N_SLICES = 3
TIMEOUT = 60
PROTOBUF = "application/x-protobuf"
B = "Bitmap(frame=f, rowID={})"


@pytest.fixture(autouse=True)
def fresh_pools():
    """A pool of its own per test in both packages (the pool is
    process-wide)."""
    old_t = tdevice._set_pool(tpool.PlanePool())
    old_j = jdevice._set_pool(jpool.PlanePool())
    yield
    tdevice._set_pool(old_t)
    jdevice._set_pool(old_j)


def seeded_bits(seed: int = 0, n: int = 600, rows: int = 8):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, rows)), int(rng.integers(0, N_SLICES * SW))) for _ in range(n)]


@pytest.fixture
def holders(tmp_path):
    """A port Holder(device="cpu") and a JAX Holder with the same bits in
    frame f (rows 0-7) over 3 slices."""
    t = THolder(str(tmp_path / "t"), device="cpu")
    j = JHolder(str(tmp_path / "j"))
    t.open()
    j.open()
    for h in (t, j):
        f = h.create_index("i").create_frame("f")
        for r, c in seeded_bits():
            f.set_bit("standard", r, c)
    yield t, j
    t.close()
    j.close()


def count(ex, pql: str) -> int:
    return int(ex.execute("i", parse_string(pql))[0])


def jcount(ex, pql: str) -> int:
    return int(ex.execute("i", jparse(pql))[0])


def builds(monkeypatch) -> dict:
    seen = {"n": 0}
    orig = Executor._cached_batch_build

    def counted(self, *a, **kw):
        seen["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(Executor, "_cached_batch_build", counted)
    return seen


Q = f"Count(Intersect({B.format(0)}, {B.format(1)}))"


def test_hit_reuses_the_entry(holders, monkeypatch):
    t, j = holders
    ex, jex = Executor(t), JExecutor(j)
    seen = builds(monkeypatch)
    try:
        want = jcount(jex, Q)
        assert [count(ex, Q) for _ in range(3)] == [want] * 3
        assert seen["n"] == 1
        (key,) = list(ex._batch_cache)
        ent = ex._batch_cache[key]
        assert ent.kept == list(range(N_SLICES)) and ent.index.shape == (N_SLICES, 2, 2)
        # Another slice list is another entry.
        ex.execute("i", parse_string(Q), slices=[0, 2])
        assert seen["n"] == 2
    finally:
        ex.close()
        jex.close()


def test_setbit_after_a_cached_count_rebuilds_and_changes(holders, monkeypatch):
    """The SetBit only queues its bit for K7 (the mirror is resident): the
    queue bumps the fragment's version, so the next Count rebuilds,
    applies the queue and sees the bit."""
    t, j = holders
    ex, jex = Executor(t), JExecutor(j)
    seen = builds(monkeypatch)
    try:
        before = count(ex, Q)
        assert before == jcount(jex, Q)
        frag = t.fragment("i", "f", "standard", 1)
        col = next(c for c in range(SW, 2 * SW)
                   if not frag.contains(0, c) and not frag.contains(1, c))
        for h in (t, j):
            h.frame("i", "f").set_bit("standard", 0, col)
            h.frame("i", "f").set_bit("standard", 1, col)
        assert frag._pending_n == 2  # queued, not yet on the mirror
        assert count(ex, Q) == before + 1 == jcount(jex, Q)
        assert frag._pending_n == 0 and seen["n"] == 2
    finally:
        ex.close()
        jex.close()


def test_evicted_mirror_under_an_entry_is_freed_and_rebuilt(holders, monkeypatch):
    """The pool evicts a mirror a cached entry names: the entry holds it
    only weakly, so its memory goes; the next query finds the entry
    stale, uploads the mirror again and answers right."""
    t, j = holders
    ex, jex = Executor(t), JExecutor(j)
    seen = builds(monkeypatch)
    try:
        want = jcount(jex, Q)
        assert count(ex, Q) == want
        frag = t.fragment("i", "f", "standard", 2)
        old = frag._mirror
        ref = torch.utils.weak.WeakTensorKeyDictionary()
        ref[old] = True
        gen = frag._mirror_gen
        assert frag._evict_mirror()
        tdevice.pool().remove(frag._pool_key)
        del old
        gc.collect()
        assert len(ref) == 0, "the cached entry kept an evicted mirror alive"
        assert frag._mirror is None and frag._mirror_gen == gen + 1
        assert count(ex, Q) == want
        assert seen["n"] == 2 and frag._mirror is not None
        assert count(ex, Q) == want and seen["n"] == 2
    finally:
        ex.close()
        jex.close()


def test_time_range_leaf_follows_a_quantum_change(tmp_path):
    """A Range leaf's views depend on the frame's quantum: after a change
    the cached Count rebuilds and equals the JAX node's."""
    t = THolder(str(tmp_path / "t"), device="cpu")
    j = JHolder(str(tmp_path / "j"))
    t.open()
    j.open()
    ex, jex = Executor(t), JExecutor(j)
    try:
        from datetime import datetime
        rng = np.random.default_rng(3)
        days = [datetime(2017, m, d) for m, d in ((1, 5), (1, 20), (2, 3), (3, 9), (3, 30))]
        for h in (t, j):
            h.create_index("i").create_frame("t", time_quantum="YMD")
        for k in range(200):
            r, c = int(rng.integers(0, 3)), int(rng.integers(0, 2 * SW))
            for h in (t, j):
                h.frame("i", "t").set_bit("standard", r, c, days[k % 5])
        qs = ['Count(Range(frame=t, rowID=1, start="2017-01-01T00:00", end="2017-03-10T00:00"))',
              'Count(Union(Range(frame=t, rowID=0, start="2017-01-10T00:00", '
              'end="2017-03-31T00:00"), Range(frame=t, rowID=2, start="2017-01-01T00:00", '
              'end="2018-01-01T00:00")))']
        for quantum in ("YMD", "YM", "Y", "MD"):
            t.frame("i", "t").set_options(time_quantum=quantum)
            j.frame("i", "t").set_time_quantum(quantum)
            for q in qs:
                assert count(ex, q) == jcount(jex, q), (quantum, q)
    finally:
        ex.close()
        jex.close()
        t.close()
        j.close()


def test_cache_bytes_stay_under_a_budget(tmp_path, monkeypatch):
    """With every row in the sparse tier, entries own scratch rows (one
    K6 expansion each): they count as "cache" bytes, and under a budget
    the pool evicts them; every answer stays right."""
    monkeypatch.setattr(tfr, "DENSE_ROW_BUDGET", 0)
    t = THolder(str(tmp_path / "t"), device="cpu")
    t.open()
    ex = Executor(t)
    try:
        f = t.create_index("i").create_frame("f")
        truth: dict[int, set] = {}
        for r, c in seeded_bits(5, n=300):
            f.set_bit("standard", r, c)
            truth.setdefault(r, set()).add(c)
        pool = tdevice.pool()
        queries = [(f"Count(Union({B.format(a)}, {B.format(a + 1)}))",
                    len(truth[a] | truth[a + 1])) for a in range(6)]
        for q, want in queries:
            assert count(ex, q) == want
        row = 32768 * 4
        assert pool.snapshot()["cache_bytes"] == 6 * 2 * N_SLICES * row
        budget = pool.resident_bytes() - pool.snapshot()["cache_bytes"] + 2 * 2 * N_SLICES * row
        pool.configure(budget_bytes=budget)
        for q, want in queries + queries:
            assert count(ex, q) == want
            assert pool.resident_bytes() <= budget
            assert pool.snapshot()["cache_bytes"] <= 2 * 2 * N_SLICES * row
        assert pool.counters()["evictions"] > 0
    finally:
        ex.close()
        t.close()


# --- one storm, two servers ---------------------------------------------------


def http(host, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def ask(host, pql):
    js = http(host, "/index/i/query", pql.encode())
    ps = http(host, "/index/i/query", pb.QueryRequest(Query=pql).SerializeToString(),
              {"Content-Type": PROTOBUF, "Accept": PROTOBUF})
    return js, ps


TREES = [
    f"Intersect({B.format(0)}, {B.format(1)})",
    f"Union({B.format(2)}, {B.format(3)})",
    f"Difference({B.format(4)}, {B.format(5)})",
    f"Xor({B.format(6)}, {B.format(7)})",
    f"Intersect({B.format(0)}, {B.format(1)}, {B.format(2)})",
    f"Union(Intersect({B.format(0)}, {B.format(3)}), {B.format(5)})",
    f"Difference(Union({B.format(1)}, {B.format(2)}), {B.format(7)})",
    f"Xor(Intersect({B.format(2)}, {B.format(4)}), Intersect({B.format(3)}, {B.format(5)}))",
    f"Intersect(Union({B.format(0)}, {B.format(1)}), Union({B.format(6)}, {B.format(7)}))",
    f"Difference({B.format(6)}, {B.format(0)}, {B.format(1)}, {B.format(2)})",
    f"Union({B.format(4)}, {B.format(5)}, {B.format(6)}, {B.format(7)})",
    f"Intersect(Xor({B.format(0)}, {B.format(2)}), Difference({B.format(3)}, {B.format(1)}))",
    B.format(5),
    f"Intersect({B.format(1)}, {B.format(99)})",
    "Union()",
    f"Union(Difference({B.format(0)}, {B.format(4)}), Xor({B.format(5)}, {B.format(6)}))",
]
STORM = [f"Count({t})" for t in TREES] + TREES


@pytest.mark.parametrize("coalesce", [True, False])
def test_concurrent_storm_byte_equal_to_jax(tmp_path, coalesce):
    """8 client threads send the 32 queries (16 distinct trees, Count and
    Bitmap) in a seeded order, each in JSON and protobuf, to both nodes:
    every answer equal byte for byte; with coalescing on, the port's
    launches stay below its queries."""
    j = JServer(data_dir=str(tmp_path / "j"), host="127.0.0.1:0", anti_entropy_interval=3600,
                polling_interval=3600, cache_flush_interval=3600, coalesce=coalesce)
    t = TServer(str(tmp_path / "t"), device="cpu", polling_interval=3600, coalesce=coalesce,
                coalesce_max_wait_us=2000 if coalesce else 0)
    j.open()
    t.open()
    try:
        for s in (j, t):
            assert http(s.host, "/index/i")[0] == 200
            assert http(s.host, "/index/i/frame/f")[0] == 200
            calls = [f"SetBit(frame=f, rowID={r}, columnID={c})" for r, c in seeded_bits(1)]
            for k in range(0, len(calls), 100):
                assert http(s.host, "/index/i/query", " ".join(calls[k:k + 100]).encode())[0] == 200
        rng = np.random.default_rng(2)
        order = [STORM[int(i)] for i in rng.integers(0, len(STORM), size=96)]
        start = threading.Barrier(8)

        def client(k):
            start.wait(timeout=TIMEOUT)
            return [(q, ask(t.host, q)) for q in order[k::8]]

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = [r for f in [pool.submit(client, k) for k in range(8)]
                   for r in f.result(timeout=4 * TIMEOUT)]
        want = {q: ask(j.host, q) for q in STORM}
        for q, answer in got:
            assert answer == want[q], q
            assert answer[0][0] == 200
        if coalesce:
            snap = t.coalescer.snapshot()
            assert 0 < snap["launches"] < snap["queries"]
        else:
            assert t.coalescer is None and t.executor.coalescer is None
    finally:
        j.close()
        t.close()
