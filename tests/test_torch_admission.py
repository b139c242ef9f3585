"""The JAX package's admission suite, run against the port.

``tests/test_admission.py``'s classes with their assertions unchanged,
over the port's ``net/admission.py``, ``exec/plan.py``, ``config.py`` and
port nodes on the CPU (``Server(device="cpu")``): cost classes, the class
gate (fast path, queue-full and deadline-aware sheds, a queued admit,
expiry in the queue, the EWMA), the ``[net] admission-*`` keys, a
saturated node answering 429 with ``Retry-After`` before the coalescer
launches anything, independent class gates, ``/import-value`` on the
write lane, ``/debug/health`` and ``/metrics``, the ``admission`` span, a
shed that trips no breaker, and two nodes whose map legs ride the
internal lane past saturated client gates (or, with that lane full too,
degrade an ``allowPartial`` query).  Only the harness differs: the port's
``Server`` takes its ring as ``hosts=``.  ``TestNoLaunchOnShed`` adds the
port's own check: a shed Count, TopN(src) or SetBit runs none of K2, K4
and K7 (their plain versions, counted on the CPU).  ``TestAgainstJax``
holds the port's module against the JAX package's on the same inputs:
tenant specs and resolution, ``cost_class`` over a drawn query corpus,
and one seeded sequence of acquires, releases, ended deadlines and clock
steps driven through both controllers on one fake clock, compared after
every step.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch import config as config_mod  # noqa: E402
from pilosa_tpu_torch.exec import plan  # noqa: E402
from pilosa_tpu_torch.net import admission as adm  # noqa: E402
from pilosa_tpu_torch.net import resilience as rz  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.obs.stats import ExpvarStatsClient  # noqa: E402
from pilosa_tpu_torch.ops import delta_scatter as ds  # noqa: E402
from pilosa_tpu_torch.ops import score_planes as sp  # noqa: E402
from pilosa_tpu_torch.ops import tree_eval as te  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.pql.parser import parse_string  # noqa: E402

_QUIET = dict(anti_entropy_interval=3600, polling_interval=3600, device="cpu",
              floor_probe=False)


# ---------------------------------------------------------------------------
# cost classes
# ---------------------------------------------------------------------------


_COST_CASES = [
    ('Count(Bitmap(frame="f", rowID=1))', plan.COST_POINT),
    ('Bitmap(frame="f", rowID=1)', plan.COST_POINT),
    (
        'Intersect(Bitmap(rowID=1), Union(Bitmap(rowID=2), Bitmap(rowID=3)))',
        plan.COST_POINT,
    ),
    ('TopN(frame="f", n=5)', plan.COST_HEAVY),
    ('Sum(frame="f", field="v")', plan.COST_HEAVY),
    ('Min(frame="f", field="v")', plan.COST_HEAVY),
    # Range nested anywhere makes the tree heavy.
    ('Count(Range(frame="f", v > 3))', plan.COST_HEAVY),
    (
        'Count(Intersect(Bitmap(rowID=1), Range(frame="f", v > 3)))',
        plan.COST_HEAVY,
    ),
    ('SetBit(frame="f", rowID=1, columnID=2)', plan.COST_WRITE),
    # write wins over heavy in a mixed batch
    (
        'SetBit(frame="f", rowID=1, columnID=2) TopN(frame="f", n=5)',
        plan.COST_WRITE,
    ),
]


class TestCostClass:
    @pytest.mark.parametrize("pql,want", _COST_CASES)
    def test_classification(self, pql, want):
        assert plan.cost_class(parse_string(pql).calls) == want


# ---------------------------------------------------------------------------
# gate unit behavior
# ---------------------------------------------------------------------------


class TestGate:
    def test_fast_path_admit_and_release(self):
        ac = adm.AdmissionController(point_concurrency=2, queue_depth=4)
        t1 = ac.acquire(adm.CLASS_POINT)
        t2 = ac.acquire(adm.CLASS_POINT)
        snap = ac.snapshot()[adm.CLASS_POINT]
        assert snap["active"] == 2 and snap["admitted"] == 2
        t1.release()
        t2.release()
        t2.release()  # idempotent
        assert ac.snapshot()[adm.CLASS_POINT]["active"] == 0

    def test_queue_full_sheds_with_retry_after(self):
        ac = adm.AdmissionController(point_concurrency=1, queue_depth=0)
        t = ac.acquire(adm.CLASS_POINT)
        with pytest.raises(rz.ShedError) as ei:
            ac.acquire(adm.CLASS_POINT)
        assert ei.value.retry_after_s > 0
        assert ei.value.cost_class == adm.CLASS_POINT
        assert ac.snapshot()[adm.CLASS_POINT]["shed"] == 1
        t.release()
        ac.acquire(adm.CLASS_POINT).release()

    def test_deadline_aware_shed_before_queueing(self):
        ac = adm.AdmissionController(point_concurrency=1, queue_depth=64)
        gate = ac.gate(adm.CLASS_POINT)
        gate._ewma_ms = 1000.0  # pretend service takes a second
        t = ac.acquire(adm.CLASS_POINT)
        # 50 ms of budget cannot cover a ~1 s predicted wait: shed NOW.
        with pytest.raises(rz.ShedError):
            ac.acquire(adm.CLASS_POINT, deadline=rz.Deadline.after_ms(50))
        t.release()

    def test_queue_wait_then_admit(self):
        ac = adm.AdmissionController(point_concurrency=1, queue_depth=4)
        t = ac.acquire(adm.CLASS_POINT)
        got = {}

        def waiter():
            tk = ac.acquire(adm.CLASS_POINT)
            got["wait_ms"] = tk.wait_ms
            tk.release()

        th = threading.Thread(target=waiter)
        th.start()
        deadline = time.time() + 2.0
        while time.time() < deadline:
            if ac.snapshot()[adm.CLASS_POINT]["queued"] == 1:
                break
            time.sleep(0.005)
        time.sleep(0.05)
        t.release()
        th.join(timeout=2.0)
        assert not th.is_alive()
        assert got["wait_ms"] >= 40.0

    def test_deadline_expiry_in_queue_sheds(self):
        ac = adm.AdmissionController(point_concurrency=1, queue_depth=4)
        t = ac.acquire(adm.CLASS_POINT)
        gate = ac.gate(adm.CLASS_POINT)
        gate._ewma_ms = 0.1  # prediction says the wait is tiny...
        t0 = time.monotonic()
        with pytest.raises(rz.ShedError):
            # ...but nobody releases: the waiter sheds at ITS deadline,
            # not after burning any work.
            ac.acquire(adm.CLASS_POINT, deadline=rz.Deadline.after_ms(80))
        assert time.monotonic() - t0 < 1.0
        assert ac.snapshot()[adm.CLASS_POINT]["queued"] == 0
        t.release()

    def test_ewma_feedback(self):
        ac = adm.AdmissionController(point_concurrency=1, queue_depth=0)
        gate = ac.gate(adm.CLASS_POINT)
        before = gate._ewma_ms
        t = ac.acquire(adm.CLASS_POINT)
        time.sleep(0.05)
        t.release()
        assert gate._ewma_ms != before  # observed service time folded in


# ---------------------------------------------------------------------------
# config knobs
# ---------------------------------------------------------------------------


class TestConfig:
    def test_toml_roundtrip(self):
        cfg = config_mod.from_toml(
            "[net]\n"
            "admission = false\n"
            "admission-point-concurrency = 3\n"
            "admission-heavy-concurrency = 2\n"
            "admission-write-concurrency = 4\n"
            "admission-internal-concurrency = 9\n"
            "admission-queue-depth = 7\n"
        )
        assert cfg.net.admission is False
        assert cfg.net.admission_point_concurrency == 3
        assert cfg.net.admission_internal_concurrency == 9
        assert "admission-queue-depth = 7" in cfg.to_toml()
        cfg.validate()

    def test_validation(self):
        cfg = config_mod.Config()
        cfg.net.admission_point_concurrency = 0
        with pytest.raises(config_mod.ConfigError):
            cfg.validate()

    def test_env_overlay(self):
        cfg = config_mod.apply_env(
            config_mod.Config(),
            environ={"PILOSA_NET_ADMISSION_QUEUE_DEPTH": "5"},
        )
        assert cfg.net.admission_queue_depth == 5


# ---------------------------------------------------------------------------
# single node over HTTP: shed before any device work
# ---------------------------------------------------------------------------


@pytest.fixture
def tight_server(tmp_path):
    """One-slot gates, zero queue: the second concurrent request of any
    client class MUST shed."""
    s = Server(
        str(tmp_path / "data"),
        host="127.0.0.1:0",
        stats=ExpvarStatsClient(),
        admission_point_concurrency=1,
        admission_heavy_concurrency=1,
        admission_write_concurrency=1,
        admission_queue_depth=0,
        **_QUIET,
    )
    s.open()
    s.holder.create_index_if_not_exists("i")
    s.holder.index("i").create_frame_if_not_exists("f")
    s.holder.frame("i", "f").set_bit("standard", 1, 10)
    yield s
    s.close()


def _raw_query(host: str, pql: str, headers: dict | None = None):
    """(status, headers, parsed-json-body) without the client's
    ShedError translation — tests assert the raw HTTP contract."""
    req = urllib.request.Request(
        f"http://{host}/index/i/query", data=pql.encode(), method="POST",
        headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


class TestServerShedding:
    def _counts(self, server) -> dict:
        return server.stats.snapshot()["counts"]

    def test_saturated_sheds_429_before_coalescer(self, tight_server):
        s = tight_server
        q = 'Count(Bitmap(frame="f", rowID=1))'
        # Warm once so the coalescer counter is live.
        status, _, body = _raw_query(s.host, q)
        assert status == 200 and body["results"] == [1]
        launches_before = self._counts(s).get("exec.coalesce.launches", 0)

        ticket = s.admission.acquire(adm.CLASS_POINT)
        try:
            status, headers, body = _raw_query(s.host, q)
        finally:
            ticket.release()
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        assert body["retryAfterMs"] > 0
        assert "admission" in body["error"]
        # The shed happened BEFORE the executor/coalescer: no launch.
        counts = self._counts(s)
        assert counts.get("exec.coalesce.launches", 0) == launches_before
        assert counts.get("net.admission.shed[class:point]", 0) == 1

        # Slot free again: the same query succeeds.
        status, _, body = _raw_query(s.host, q)
        assert status == 200 and body["results"] == [1]

    def test_classes_gate_independently(self, tight_server):
        s = tight_server
        ticket = s.admission.acquire(adm.CLASS_POINT)
        try:
            # point saturated; heavy still admits
            status, _, _ = _raw_query(s.host, 'TopN(frame="f", n=2)')
            assert status == 200
        finally:
            ticket.release()

    def test_import_value_sheds_write_class(self, tight_server):
        s = tight_server
        payload = json.dumps(
            {
                "index": "i", "frame": "f", "field": "x",
                "slice": 0, "columnIDs": [1], "values": [2],
            }
        ).encode()
        ticket = s.admission.acquire(adm.CLASS_WRITE)
        try:
            req = urllib.request.Request(
                f"http://{s.host}/import-value", data=payload, method="POST"
            )
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == 429
            assert "Retry-After" in dict(ei.value.headers)
        finally:
            ticket.release()

    def test_health_and_metrics_surface_queue_state(self, tight_server):
        s = tight_server
        with urllib.request.urlopen(
            f"http://{s.host}/debug/health", timeout=10
        ) as resp:
            health = json.loads(resp.read())
        assert set(health["admission"]) == set(adm.CLASSES)
        assert health["admission"]["point"]["concurrency"] == 1
        with urllib.request.urlopen(
            f"http://{s.host}/metrics", timeout=10
        ) as resp:
            metrics = resp.read().decode()
        assert 'net_admission_active{class="point"}' in metrics
        assert 'net_admission_queued{class="heavy"}' in metrics

    def test_admission_span_in_trace(self, tight_server):
        s = tight_server
        _raw_query(s.host, 'Count(Bitmap(frame="f", rowID=1))')
        names = {
            sp["name"]
            for tr in s.tracer.traces()
            for sp in tr["spans"]
        }
        assert "admission" in names

    def test_shed_does_not_trip_breaker(self, tight_server):
        """A healthy-but-busy host answering 429 must stay breaker-
        closed on the caller side, even with a hair-trigger breaker."""
        s = tight_server
        breakers = rz.BreakerRegistry(failure_threshold=1)
        client = InternalClient(s.host, timeout=10.0, breakers=breakers)
        ticket = s.admission.acquire(adm.CLASS_POINT)
        try:
            for _ in range(3):
                with pytest.raises(rz.ShedError) as ei:
                    client.execute_query(
                        "i", 'Count(Bitmap(frame="f", rowID=1))'
                    )
                assert ei.value.retry_after_s > 0
            assert breakers.state(s.host) == rz.STATE_CLOSED
        finally:
            ticket.release()
        # And the host still serves: shed never poisoned anything.
        assert client.execute_pql(
            "i", 'Count(Bitmap(frame="f", rowID=1))'
        ) == 1


class TestNoLaunchOnShed:
    """A shed request runs no kernel: K2 for a Count, K4 for a TopN(src),
    K7 for the read after a write (their plain versions on the CPU,
    counted), the fragment untouched by a shed ``/import``."""

    @pytest.fixture
    def counted(self, monkeypatch):
        calls = {"k2": 0, "k4": 0, "k7": 0}

        def spy(mod, name, key):
            real = getattr(mod, name)

            def counting(*a, **kw):
                calls[key] += 1
                return real(*a, **kw)

            monkeypatch.setattr(mod, name, counting)

        spy(te, "plain_tree_eval", "k2")
        spy(sp, "plain_score_planes", "k4")
        spy(ds, "plain_delta_scatter_many", "k7")
        return calls

    def test_shed_count_topn_and_write_launch_nothing(self, tmp_path, counted):
        s = Server(str(tmp_path / "data"), host="127.0.0.1:0", coalesce=False,
                   admission_point_concurrency=1, admission_heavy_concurrency=1,
                   admission_write_concurrency=1, admission_queue_depth=0, **_QUIET)
        s.open()
        try:
            for q in ('SetBit(frame="f", rowID=1, columnID=10)',
                      'SetBit(frame="f", rowID=2, columnID=10)'):
                s.holder.create_index_if_not_exists("i")
                s.holder.index("i").create_frame_if_not_exists("f")
                assert _raw_query(s.host, q)[0] == 200
            count = 'Count(Intersect(Bitmap(frame="f", rowID=1), Bitmap(frame="f", rowID=2)))'
            topn = 'TopN(Bitmap(frame="f", rowID=1), frame="f", n=2)'
            for q in (count, topn):  # mirrors resident, the first builds done
                assert _raw_query(s.host, q)[0] == 200
            for cls, q in ((adm.CLASS_POINT, count), (adm.CLASS_HEAVY, topn),
                           (adm.CLASS_WRITE, 'SetBit(frame="f", rowID=1, columnID=11)')):
                before = dict(counted)
                ticket = s.admission.acquire(cls)
                try:
                    status, headers, _ = _raw_query(s.host, q)
                finally:
                    ticket.release()
                assert status == 429 and int(headers["Retry-After"]) >= 1
                # The shed write queued nothing: the next read applies no
                # delta (no K7) and answers as before.
                assert _raw_query(s.host, count)[2]["results"] == [1]
                assert counted["k7"] == before["k7"]
                assert counted["k4"] == before["k4"]
            # An admitted Count launches K2; a shed one does not.
            before = counted["k2"]
            assert _raw_query(s.host, count)[2]["results"] == [1]
            assert counted["k2"] == before + 1
            ticket = s.admission.acquire(adm.CLASS_POINT)
            try:
                assert _raw_query(s.host, count)[0] == 429
            finally:
                ticket.release()
            assert counted["k2"] == before + 1
        finally:
            s.close()

    def test_shed_import_leaves_the_fragment_and_wal(self, tmp_path, counted):
        from pilosa_tpu_torch.net import wire

        s = Server(str(tmp_path / "data"), host="127.0.0.1:0",
                   admission_write_concurrency=1, admission_queue_depth=0, **_QUIET)
        s.open()
        try:
            s.holder.create_index_if_not_exists("i")
            s.holder.index("i").create_frame_if_not_exists("f")
            frame = s.holder.frame("i", "f")
            frame.set_bit("standard", 1, 10)
            appends0 = s.ingest.snapshot()["totalAppends"]
            body = wire.ImportRequest(Index="i", Frame="f", Slice=0, RowIDs=[3],
                                      ColumnIDs=[77]).encode()
            ticket = s.admission.acquire(adm.CLASS_WRITE)
            try:
                req = urllib.request.Request(
                    f"http://{s.host}/import", data=body, method="POST",
                    headers={"Content-Type": "application/x-protobuf"})
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=10)
                assert ei.value.code == 429
            finally:
                ticket.release()
            assert _raw_query(s.host, 'Count(Bitmap(frame="f", rowID=3))')[2]["results"] == [0]
            assert s.ingest.snapshot()["totalAppends"] == appends0
        finally:
            s.close()


# ---------------------------------------------------------------------------
# two real HTTP nodes: internal priority + degraded reads
# ---------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def two_tight_servers(tmp_path):
    ports: set[int] = set()
    while len(ports) < 2:
        ports.add(_free_port())
    hosts = sorted(f"127.0.0.1:{p}" for p in ports)
    servers = []
    for i, host in enumerate(hosts):
        s = Server(
            str(tmp_path / f"n{i}"),
            host=host,
            hosts=hosts,
            stats=ExpvarStatsClient(),
            retry_backoff_ms=10,
            admission_point_concurrency=1,
            admission_heavy_concurrency=1,
            admission_write_concurrency=1,
            admission_queue_depth=0,
            admission_internal_concurrency=2,
            **_QUIET,
        )
        s.open()
        servers.append(s)
    s0, s1 = servers
    yield s0, s1
    s0.close()
    s1.close()


def _seed_distributed(s0, s1, n_slices=6):
    for s in (s0, s1):
        s.holder.create_index_if_not_exists("i")
        s.holder.index("i").create_frame_if_not_exists("f")
    for sl in range(n_slices):
        owner = s0.cluster.fragment_nodes("i", sl)[0].host
        srv = s0 if owner == s0.host else s1
        srv.holder.frame("i", "f").set_bit("standard", 1, sl * SLICE_WIDTH)
    for s in (s0, s1):
        s.holder.index("i").set_remote_max_slice(n_slices - 1)
    # sanity: both nodes own something
    owned1 = [
        sl for sl in range(n_slices)
        if s0.cluster.fragment_nodes("i", sl)[0].host == s1.host
    ]
    assert owned1, "placement gave node 1 nothing; widen n_slices"
    return n_slices, owned1


class TestInternalPriority:
    def test_map_legs_never_shed_behind_client_traffic(
        self, two_tight_servers
    ):
        """Livelock regression: every CLIENT gate on the remote node is
        saturated, yet a coordinator fan-out still answers — remote map
        legs ride the internal lane."""
        s0, s1 = two_tight_servers
        n_slices, _ = _seed_distributed(s0, s1)
        tickets = [
            s1.admission.acquire(cls)
            for cls in (adm.CLASS_POINT, adm.CLASS_HEAVY, adm.CLASS_WRITE)
        ]
        try:
            c0 = InternalClient(s0.host, timeout=15.0)
            got = c0.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))')
            assert got == n_slices
        finally:
            for t in tickets:
                t.release()
        # the remote legs really did admit through the internal lane
        counts = s1.stats.snapshot()["counts"]
        assert counts.get("net.admission.admitted[class:internal]", 0) >= 1

    def test_internal_shed_degrades_allow_partial(self, two_tight_servers):
        """A node saturated PAST its internal lane sheds map legs; the
        coordinator treats that as a node failure: allowPartial reduces
        over the survivors, and the shed never trips s1's breaker."""
        s0, s1 = two_tight_servers
        n_slices, owned1 = _seed_distributed(s0, s1)
        # Saturate the internal lane for an immediate shed (no queue).
        s1.admission.gate(adm.CLASS_INTERNAL).queue_depth = 0
        tickets = [
            s1.admission.acquire(adm.CLASS_INTERNAL) for _ in range(2)
        ]
        try:
            status, headers, body = _raw_query(
                s0.host,
                'Count(Bitmap(frame="f", rowID=1))',
                headers={"X-Allow-Partial": "true"},
            )
            assert status == 200
            assert body["partial"] is True
            assert sorted(body["missingSlices"]) == sorted(owned1)
            assert body["results"] == [n_slices - len(owned1)]
            # shedding is not a breaker event on the coordinator
            assert (
                s0.resilience.breakers.state(s1.host) == rz.STATE_CLOSED
            )
        finally:
            for t in tickets:
                t.release()
        # Lane free again: the same query is whole.
        status, _, body = _raw_query(
            s0.host, 'Count(Bitmap(frame="f", rowID=1))'
        )
        assert status == 200 and body["results"] == [n_slices]


# ---------------------------------------------------------------------------
# the port against the JAX package, on one sequence of events
# ---------------------------------------------------------------------------
#
# Both packages' controllers, registries and class gates take the same
# seeded sequence of acquires, releases, ended deadlines and clock steps
# on one fake monotonic clock, and are compared after every step: each
# request's outcome (its wait, or its shed with message, Retry-After,
# class and quota fields), the order of admissions out of the queues,
# ``snapshot()``, ``tenants_snapshot()``, ``gauges()`` and the stats
# counts.  A queued acquire waits on a thread of its own; the main thread
# waits for each step to settle before the next, so both sides see the
# same state.

_TENANTS = ["gold:3", "silver:2:2", "bronze:1:20:4000"]
_KEYS = ["k-gold:gold", "k-silver:silver", "k-bronze:bronze"]
_SETTLE_S = 10.0


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


class _Deadline:
    """A request's budget, fixed until the test ends it.  While it lasts,
    a queued waiter wakes every 2 ms of real time to look again."""

    def __init__(self, ms: float):
        self.ms = ms
        self.ended = False

    def remaining_ms(self) -> float:
        return 0.0 if self.ended else self.ms

    def remaining(self) -> float:
        return 0.0 if self.ended else 0.002


def _wait_for(cond, what: str) -> None:
    end = time.monotonic() + _SETTLE_S
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"not settled: {what}")
        time.sleep(0.0005)


class _Side:
    """One package's controller under the shared clock."""

    def __init__(self, adm_mod, rz_mod, stats_mod):
        self.adm, self.rz = adm_mod, rz_mod
        self.stats = stats_mod.ExpvarStatsClient()
        self.ctl = adm_mod.AdmissionController(
            point_concurrency=2, heavy_concurrency=1, write_concurrency=1,
            internal_concurrency=1, subscribe_concurrency=1, queue_depth=2,
            stats=self.stats,
            tenants=adm_mod.TenantRegistry(_TENANTS, _KEYS, default_tenant="anon",
                                           internal_token="tok", stats=self.stats),
        )
        self.tickets: dict = {}  # request id -> Ticket
        self.queued: dict = {}  # request id -> its class, while it waits
        self.deadlines: dict = {}  # request id -> _Deadline
        self.out: dict = {}  # request id -> outcome
        self.order: list = []  # request ids in the order they were admitted
        self._mu = threading.Lock()

    def _record(self, rid, outcome, ticket=None) -> None:
        with self._mu:
            if ticket is not None:
                self.tickets[rid] = ticket
                self.order.append(rid)
            self.out[rid] = outcome

    def _waiting(self, cls) -> int:
        gate = self.ctl.gate(cls)
        with gate._mu:
            return sum(len(dq) for dq in gate._waiting.values())

    def _settle(self, cls) -> None:
        """Wait until every waiter of ``cls`` that left the queue (granted,
        or shed at its ended deadline) has its outcome."""
        def settled():
            with self._mu:
                left = sum(1 for r, c in self.queued.items() if c == cls and r not in self.out)
            return left == self._waiting(cls) and \
                self.ctl.gate(cls).snapshot()["queued"] == left
        _wait_for(settled, cls)
        with self._mu:
            for r in [r for r in self.queued if r in self.out]:
                del self.queued[r]

    def acquire(self, rid, cls, tenant, deadline_ms, nbytes):
        dl = None if deadline_ms is None else _Deadline(deadline_ms)
        before = self.ctl.gate(cls).snapshot()["queued"]

        def run():
            try:
                tk = self.ctl.acquire(cls, deadline=dl, tenant=tenant, nbytes=nbytes)
            except self.rz.ShedError as e:
                self._record(rid, ("shed", type(e).__name__, str(e), e.retry_after_s,
                                   e.cost_class, getattr(e, "tenant", None),
                                   getattr(e, "quota_kind", None),
                                   getattr(e, "quota_limit", None),
                                   getattr(e, "quota_remaining", None)))
            else:
                self._record(rid, ("admitted", tk.wait_ms, tk.tenant), tk)

        threading.Thread(target=run, daemon=True).start()
        _wait_for(lambda: rid in self.out or self.ctl.gate(cls).snapshot()["queued"] > before,
                  f"acquire {rid}")
        if rid in self.out:
            return self.out[rid]
        with self._mu:
            self.queued[rid] = cls
        if dl is not None:
            self.deadlines[rid] = dl
        return ("queued",)

    def release(self, rid, cls):
        self.tickets.pop(rid).release()
        self._settle(cls)

    def end(self, rid, cls):
        self.deadlines.pop(rid).ended = True
        _wait_for(lambda: rid in self.out, f"end {rid}")
        self._settle(cls)

    def state(self) -> dict:
        return {"out": dict(self.out), "order": list(self.order),
                "snapshot": self.ctl.snapshot(), "tenants": self.ctl.tenants_snapshot(),
                "gauges": self.ctl.gauges(), "counts": self.stats.snapshot()["counts"]}


_CLASSES = ["point", "point", "heavy", "heavy", "write", "internal", "subscribe"]
_REQ_TENANTS = ["gold", "silver", "bronze", "anon", "", "visitor"]
_DEADLINES = [None, None, 1.0, 10.0, 30.0, 100.0, 1000.0, 1e5]


def _events(seed: int, n: int):
    """``n`` steps of (kind, args), drawn from ``seed``: the held
    tickets and the queued requests are tracked here, so every release
    and ended deadline names one that exists."""
    import numpy as np

    rng = np.random.default_rng(seed)
    held, waiting, rid = {}, {}, 0
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            rid += 1
            yield "acquire", (rid, _CLASSES[rng.integers(len(_CLASSES))],
                              _REQ_TENANTS[rng.integers(len(_REQ_TENANTS))],
                              _DEADLINES[rng.integers(len(_DEADLINES))],
                              int(rng.choice([0, 100, 3000]))), held, waiting
        elif r < 0.75 and held:
            yield "release", (sorted(held)[rng.integers(len(held))],
                              float(rng.choice([0.001, 0.02, 0.2]))), held, waiting
        elif r < 0.85 and waiting:
            yield "end", (sorted(waiting)[rng.integers(len(waiting))],), held, waiting
        else:
            yield "tick", (float(rng.choice([0.001, 0.01, 0.1, 2.0])),), held, waiting


def _random_pql(rng, depth: int = 0) -> str:
    """One random call of the PQL grammar: row calls, set operations,
    Range, Count, TopN, the aggregates and the writes."""
    bitmap = f"Bitmap(frame=f, rowID={rng.integers(8)})"
    if depth >= 3:
        return bitmap
    r = rng.integers(12)
    if r < 3:
        return bitmap
    if r < 6:
        op = ["Intersect", "Union", "Difference", "Xor"][rng.integers(4)]
        kids = ", ".join(_random_pql(rng, depth + 1) for _ in range(rng.integers(1, 4)))
        return f"{op}({kids})"
    if r == 6:
        cmp_ = ["<", "<=", "==", "!=", ">=", ">"][rng.integers(6)]
        return f"Range(frame=f, v {cmp_} {rng.integers(-50, 50)})"
    if r == 7 and depth == 0:
        return f"Count({_random_pql(rng, depth + 1)})"
    if r == 8 and depth == 0:
        src = f"{_random_pql(rng, 1)}, " if rng.random() < 0.5 else ""
        return f"TopN({src}frame=f, n={rng.integers(1, 9)})"
    if r == 9 and depth == 0:
        agg = ["Sum", "Min", "Max"][rng.integers(3)]
        src = f"{_random_pql(rng, 1)}, " if rng.random() < 0.5 else ""
        return f"{agg}({src}frame=f, field=v)"
    if r == 10 and depth == 0:
        return [f"SetBit(frame=f, rowID=1, columnID={rng.integers(99)})",
                f"ClearBit(frame=f, rowID=1, columnID={rng.integers(99)})",
                "SetRowAttrs(frame=f, rowID=1, x=1)",
                "SetColumnAttrs(columnID=1, x=1)"][rng.integers(4)]
    return bitmap


class TestAgainstJax:
    @pytest.fixture
    def sides(self, monkeypatch):
        from pilosa_tpu.net import admission as jadm
        from pilosa_tpu.net import resilience as jrz
        from pilosa_tpu.obs import stats as jstats
        from pilosa_tpu_torch.obs import stats as tstats

        clock = _Clock()
        fake = type("fake_time", (), {"monotonic": staticmethod(clock.monotonic)})
        for mod in (jadm, adm):
            monkeypatch.setattr(mod, "time", fake)
        pair = [_Side(jadm, jrz, jstats), _Side(adm, rz, tstats)]
        yield clock, pair
        for side in pair:  # free every waiter still queued
            for dl in side.deadlines.values():
                dl.ended = True
            for tk in side.tickets.values():
                tk.release()

    def test_cost_class_over_a_query_corpus(self):
        """TestCostClass's queries and 600 drawn ones (one to three calls
        each), parsed by each package's parser and classified by each
        package's ``cost_class``."""
        import numpy as np

        from pilosa_tpu.exec import plan as jplan
        from pilosa_tpu.pql.parser import parse_string as jparse

        rng = np.random.default_rng(19)
        corpus = [pql for pql, _ in _COST_CASES]
        corpus += [" ".join(_random_pql(rng) for _ in range(rng.integers(1, 4)))
                   for _ in range(600)]
        got = [(plan.cost_class(parse_string(q).calls), jplan.cost_class(jparse(q).calls))
               for q in corpus]
        assert [g[0] for g in got] == [g[1] for g in got]
        assert {g[0] for g in got} == {plan.COST_POINT, plan.COST_HEAVY, plan.COST_WRITE}

    def test_tenant_specs_and_resolution(self):
        from pilosa_tpu.net import admission as jadm

        def parsed(mod, spec):
            try:
                t = mod.Tenant.parse(spec)
            except ValueError as e:
                return str(e)
            return (t.name, t.weight, t.qps, t.bytes_per_s)

        specs = ["gold", "gold:3", " gold : 3 : 2.5 ", "b:0:0:0", "b:-2:-1:-5", "b::7",
                 "b:1:x", "b:y", ":3", "", "b:1:2:3:4", "b:2.5"]
        assert [parsed(adm, s_) for s_ in specs] == [parsed(jadm, s_) for s_ in specs]
        regs = [m.TenantRegistry(_TENANTS, _KEYS, default_tenant="anon", internal_token="tok")
                for m in (jadm, adm)]
        asks = [(k, h) for k in ("", "k-gold", "k-bronze", "nope")
                for h in ("", "gold", "silver", "visitor", "anon")]
        assert [regs[1].resolve(*a) for a in asks] == [regs[0].resolve(*a) for a in asks]
        tokens = ["", "tok", "tok ", "TOK"]
        assert [regs[1].internal_ok(t_) for t_ in tokens] == \
            [regs[0].internal_ok(t_) for t_ in tokens]
        assert regs[1].tenant_names() == regs[0].tenant_names()
        for bad in (["nocolon"], [":gold"], ["key:"]):
            with pytest.raises(ValueError) as je:
                jadm.TenantRegistry(keys=bad)
            with pytest.raises(ValueError) as te_:
                adm.TenantRegistry(keys=bad)
            assert str(te_.value) == str(je.value)

    # Seeds whose sequences reach every kind of shed (the last asserts).
    @pytest.mark.parametrize("seed", [1, 2, 5, 7])
    def test_one_event_sequence(self, sides, seed):
        clock, (j, t) = sides
        classes, queued = {}, 0
        for kind, args, held, waiting in _events(seed, 240):
            if kind == "acquire":
                rid, cls, deadline_ms = args[0], args[1], args[3]
                classes[rid] = cls
                got = [side.acquire(*args) for side in (j, t)]
                assert got[1] == got[0], (kind, args)
                if got[0] == ("queued",):
                    queued += 1
            elif kind == "release":
                rid, dt = args
                clock.t += dt
                for side in (j, t):
                    side.release(rid, classes[rid])
            elif kind == "end":
                rid = args[0]
                for side in (j, t):
                    side.end(rid, classes[rid])
            else:
                clock.t += args[0]
            assert t.state() == j.state(), (kind, args)
            # The tickets held now, and the queued requests with a deadline
            # to end, for the next steps.
            held.clear()
            held.update({r: classes[r] for r in j.tickets})
            waiting.clear()
            waiting.update({r: classes[r] for r in j.deadlines if r not in j.out})
        outs = list(j.out.values())
        # The sequence reached every path it is meant to compare.
        assert queued and j.order
        assert any(o[0] == "shed" and o[1] == "QuotaError" for o in outs)
        assert any(o[0] == "shed" and "queue full" in o[2] for o in outs)
        assert any(o[0] == "shed" and "exceeds deadline" in o[2] for o in outs)
        assert any(o[0] == "shed" and "expired in queue" in o[2] for o in outs)
