"""The JAX package's resilience suite, run against the port.

``tests/test_resilience.py``'s classes with their assertions unchanged:
deadlines, the retry policy, circuit breakers and the fault plans
(``pilosa_tpu_torch/net/resilience.py``, ``testing/faults.py``), a
coalesced waiter whose deadline runs out, and two-node HTTP clusters of
port nodes on the CPU (``Server(device="cpu")``) where breakers open under
injected transport faults and close through a half-open probe, expired
deadlines answer 504 with the trace id, ``allowPartial`` answers over
the surviving slices, and retries keep to their caps.  Only the harness
differs: the port's ``Server`` takes its ring as ``hosts=``, and its
coalescer takes a row table.
"""

import json
import socket
import threading
import time
from concurrent.futures import Future
from contextlib import suppress
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from pilosa_tpu_torch.cluster.topology import Cluster  # noqa: E402
from pilosa_tpu_torch.exec.executor import Executor  # noqa: E402
from pilosa_tpu_torch.net import resilience as rz  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.obs.stats import NopStatsClient  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.testing import faults  # noqa: E402


@pytest.fixture(autouse=True)
def _no_faults():
    """Every test starts and ends fault-free (the plan is process
    global)."""
    faults.clear()
    yield
    faults.clear()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


class TestDeadline:
    def test_remaining_and_expiry(self):
        dl = rz.Deadline.after_ms(10_000)
        assert 9.0 < dl.remaining() <= 10.0
        assert not dl.expired
        assert rz.Deadline.after_ms(0).expired

    def test_clamp_bounds_timeout_by_budget(self):
        dl = rz.Deadline.after_ms(1_000)
        assert dl.clamp(30.0) <= 1.0
        assert dl.clamp(0.1) == pytest.approx(0.1, abs=0.01)
        assert rz.Deadline.after_ms(0).clamp(30.0) == 0.0

    def test_header_roundtrip(self):
        dl = rz.Deadline.after_ms(5_000)
        back = rz.Deadline.from_header(dl.header_value())
        assert 4.0 < back.remaining() <= 5.0
        assert rz.Deadline.from_header("") is None
        assert rz.Deadline.from_header("not-a-number") is None
        # An about-to-expire deadline still travels as >= 1 ms.
        assert int(rz.Deadline.after_ms(0.01).header_value()) >= 1

    def test_scope_and_check(self):
        assert rz.current_deadline() is None
        rz.check_deadline()  # no deadline -> no-op
        with rz.deadline_scope(rz.Deadline.after_ms(10_000)):
            assert rz.current_deadline() is not None
            rz.check_deadline()
        assert rz.current_deadline() is None
        with rz.deadline_scope(rz.Deadline.after_ms(0)):
            with pytest.raises(rz.DeadlineExceeded):
                rz.check_deadline("unit")

    def test_scope_crosses_threads_via_contextvars(self):
        """The executor pool copies contextvars into workers — the
        mechanism deadline propagation rides."""
        import contextvars

        seen = []
        with rz.deadline_scope(rz.Deadline.after_ms(10_000)):
            ctx = contextvars.copy_context()
        t = threading.Thread(
            target=lambda: seen.append(ctx.run(rz.current_deadline))
        )
        t.start()
        t.join()
        assert seen[0] is not None and not seen[0].expired


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


class TestRetryPolicy:
    def test_transient_failure_retried_to_success(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return 7

        policy = rz.RetryPolicy(attempts=3, backoff=0.001)
        assert policy.call(flaky) == 7
        assert len(calls) == 3

    def test_attempt_cap_respected(self):
        calls = []

        def dead():
            calls.append(1)
            raise OSError("down")

        policy = rz.RetryPolicy(attempts=3, backoff=0.001)
        with pytest.raises(OSError):
            policy.call(dead)
        assert len(calls) == 3

    def test_non_retryable_propagates_immediately(self):
        calls = []

        def bad():
            calls.append(1)
            raise ValueError("semantic")

        policy = rz.RetryPolicy(attempts=5, backoff=0.001)
        with pytest.raises(ValueError):
            policy.call(bad)
        assert len(calls) == 1
        # BreakerOpen and DeadlineExceeded are never retried either.
        for exc in (rz.BreakerOpenError("h:1"), rz.DeadlineExceeded()):
            calls.clear()

            def gated(exc=exc):
                calls.append(1)
                raise exc

            with pytest.raises(type(exc)):
                policy.call(gated)
            assert len(calls) == 1

    def test_expired_deadline_stops_retries_as_504_shape(self):
        policy = rz.RetryPolicy(attempts=5, backoff=0.001)
        calls = []

        def dead():
            calls.append(1)
            raise OSError("down")

        with rz.deadline_scope(rz.Deadline.after_ms(0)):
            with pytest.raises(rz.DeadlineExceeded):
                policy.call(dead)
        assert len(calls) == 1

    def test_sleep_never_exceeds_budget(self):
        policy = rz.RetryPolicy(attempts=2, backoff=5.0, jitter=0.0)
        t0 = time.monotonic()
        with rz.deadline_scope(rz.Deadline.after_ms(100)):
            with pytest.raises((OSError, rz.DeadlineExceeded)):
                policy.call(lambda: (_ for _ in ()).throw(OSError("x")))
        # A 5 s base backoff must have been clamped to the ~0.1 s budget.
        assert time.monotonic() - t0 < 1.0

    def test_shed_retried_honoring_retry_after(self):
        """A 429 shed retries like a transport failure, but never
        sooner than the server's Retry-After hint."""
        calls = []

        def busy():
            calls.append(time.monotonic())
            if len(calls) < 3:
                raise rz.ShedError("busy", retry_after_s=0.05)
            return "ok"

        policy = rz.RetryPolicy(attempts=3, backoff=0.001, jitter=0.0)
        t0 = time.monotonic()
        assert policy.call(
            busy, retryable=rz.TRANSPORT_ERRORS + (rz.ShedError,)
        ) == "ok"
        assert len(calls) == 3
        # Two waits, each at least the 50 ms hint.
        assert time.monotonic() - t0 >= 0.09

    def test_shed_beyond_budget_propagates_for_failover(self):
        """Retry-After longer than the remaining deadline: propagate
        the ShedError immediately (the caller fails over to a replica)
        instead of sleeping into a guaranteed 504."""
        calls = []

        def busy():
            calls.append(1)
            raise rz.ShedError("busy", retry_after_s=10.0)

        policy = rz.RetryPolicy(attempts=5, backoff=0.001, jitter=0.0)
        t0 = time.monotonic()
        with rz.deadline_scope(rz.Deadline.after_ms(200)):
            with pytest.raises(rz.ShedError):
                policy.call(
                    busy, retryable=rz.TRANSPORT_ERRORS + (rz.ShedError,)
                )
        assert len(calls) == 1
        assert time.monotonic() - t0 < 1.0

    def test_shed_is_node_failure_but_not_5xx(self):
        e = rz.ShedError("busy", retry_after_s=0.5)
        assert rz.is_node_failure(e)  # eligible for replica failover
        assert e.status == 429
        assert e.retry_after_s == 0.5


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------


class TestCircuitBreaker:
    def test_opens_after_consecutive_failures(self):
        b = rz.CircuitBreaker("h:1", failure_threshold=3, open_s=60)
        for _ in range(2):
            b.record_failure()
        assert b.state == rz.STATE_CLOSED and b.allow()
        b.record_failure()
        assert b.state == rz.STATE_OPEN
        assert not b.allow()

    def test_success_resets_consecutive_count(self):
        b = rz.CircuitBreaker("h:1", failure_threshold=2, open_s=60)
        b.record_failure()
        b.record_success()
        b.record_failure()
        assert b.state == rz.STATE_CLOSED

    def test_half_open_probe_then_close(self):
        b = rz.CircuitBreaker("h:1", failure_threshold=1, open_s=0.05)
        b.record_failure()
        assert b.state == rz.STATE_OPEN and not b.allow()
        time.sleep(0.06)
        assert b.allow()  # the half-open probe
        assert b.state == rz.STATE_HALF_OPEN
        assert not b.allow()  # one probe at a time
        b.record_success()
        assert b.state == rz.STATE_CLOSED and b.allow()

    def test_half_open_probe_failure_reopens(self):
        b = rz.CircuitBreaker("h:1", failure_threshold=1, open_s=0.05)
        b.record_failure()
        time.sleep(0.06)
        assert b.allow()
        b.record_failure()
        assert b.state == rz.STATE_OPEN
        assert not b.allow()
        assert b.opens == 2

    def test_stale_probe_expires_instead_of_wedging(self):
        b = rz.CircuitBreaker("h:1", failure_threshold=1, open_s=0.05)
        b.record_failure()
        time.sleep(0.06)
        assert b.allow()  # probe taken... and its caller vanishes
        time.sleep(0.06)
        assert b.allow()  # a fresh probe is admitted

    def test_registry_check_and_snapshot(self):
        reg = rz.BreakerRegistry(failure_threshold=2, open_s=60)
        reg.check("a:1")  # closed -> admitted
        reg.record("a:1", False)
        reg.record("a:1", False)
        with pytest.raises(rz.BreakerOpenError):
            reg.check("a:1")
        snap = reg.snapshot()
        assert snap["a:1"]["state"] == rz.STATE_OPEN
        assert snap["a:1"]["opens"] == 1
        assert reg.state("missing:1") == rz.STATE_CLOSED


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


class TestFaults:
    def test_parse_spec(self):
        plan = faults.parse(
            "rpc.send:host=h:1,path=/index/*/query,nth=2,mode=error;"
            "rpc.recv:prob=0.5,seed=42,mode=delay,delay-ms=15,times=3"
        )
        r0, r1 = plan.rules
        assert (r0.stage, r0.host, r0.path, r0.nth, r0.mode) == (
            "rpc.send", "h:1", "/index/*/query", 2, "error",
        )
        assert (r1.stage, r1.prob, r1.delay_ms, r1.times) == (
            "rpc.recv", 0.5, 15.0, 3,
        )

    def test_parse_rejects_garbage(self):
        for bad in ("noseparator", "rpc.send:frobnicate=1",
                    "rpc.send:mode=implode", "rpc.send:nth"):
            with pytest.raises(faults.FaultSpecError):
                faults.parse(bad)

    def test_nth_fires_exactly_once(self):
        plan = faults.install("rpc.send:nth=2,mode=error")
        plan.check("rpc.send")  # call 1: no fire
        with pytest.raises(faults.FaultError):
            plan.check("rpc.send")  # call 2: fires
        plan.check("rpc.send")  # call 3: no fire
        assert plan.rules[0].hits == 1 and plan.rules[0].calls == 3

    def test_times_caps_total_fires(self):
        plan = faults.install("rpc.send:times=2,mode=error")
        for _ in range(2):
            with pytest.raises(faults.FaultError):
                plan.check("rpc.send")
        plan.check("rpc.send")
        assert plan.rules[0].hits == 2

    def test_window_opens_and_closes(self):
        """after-ms/until-ms bound a rule to a timeline window measured
        from plan install — the gameday's composed-failure clock."""
        plan = faults.install(
            "rpc.send:mode=error,after-ms=40,until-ms=120"
        )
        plan.check("rpc.send")  # t≈0: window not open yet
        time.sleep(0.06)
        with pytest.raises(faults.FaultError):
            plan.check("rpc.send")  # inside [40, 120)
        time.sleep(0.09)
        plan.check("rpc.send")  # window closed again
        assert plan.rules[0].hits == 1
        # outside-window calls don't advance nth/times accounting
        assert plan.rules[0].calls == 1

    def test_window_rearm_resets_epoch(self):
        plan = faults.install("rpc.send:mode=error,after-ms=40")
        time.sleep(0.05)
        with pytest.raises(faults.FaultError):
            plan.check("rpc.send")
        plan.rearm()
        plan.check("rpc.send")  # epoch reset: window closed again
        snap = plan.snapshot()[0]
        assert snap["afterMs"] == 40.0 and "untilMs" not in snap

    def test_window_rejects_inverted_bounds(self):
        with pytest.raises(faults.FaultSpecError):
            faults.parse("rpc.send:after-ms=200,until-ms=100")

    def test_host_and_path_filters(self):
        plan = faults.install(
            "rpc.send:host=a:1,path=/index/*/query,mode=error"
        )
        plan.check("rpc.send", host="b:2", path="/index/i/query")
        plan.check("rpc.send", host="a:1", path="/schema")
        plan.check("rpc.recv", host="a:1", path="/index/i/query")
        assert plan.rules[0].hits == 0
        with pytest.raises(faults.FaultError):
            plan.check("rpc.send", host="a:1", path="/index/i/query")

    def test_prob_is_seed_deterministic(self):
        def decisions(seed):
            plan = faults.parse(f"device.launch:prob=0.5,seed={seed}")
            out = []
            for _ in range(32):
                try:
                    plan.check("device.launch")
                    out.append(False)
                except faults.FaultError:
                    out.append(True)
            return out

        a, b = decisions(7), decisions(7)
        assert a == b
        assert any(a) and not all(a)
        assert decisions(8) != a

    def test_delay_mode_sleeps_then_continues(self):
        plan = faults.install("rpc.recv:mode=delay,delay-ms=30")
        t0 = time.monotonic()
        plan.check("rpc.recv")
        assert time.monotonic() - t0 >= 0.025

    def test_drop_mode_raises_socket_timeout(self):
        plan = faults.install("rpc.send:mode=drop")
        with pytest.raises(socket.timeout):
            plan.check("rpc.send")

    def test_clear_disables_and_module_check_routes(self):
        faults.install("rpc.send:mode=error")
        with pytest.raises(faults.FaultError):
            faults.check("rpc.send")
        faults.clear()
        faults.check("rpc.send")  # no-op


# ---------------------------------------------------------------------------
# coalesce waiter regression: deadline expiry detaches, never poisons
# ---------------------------------------------------------------------------


class _StubCoalescer:
    """A coalescer whose launch never completes until the test says so —
    the shared-batch stand-in for a slow fused program."""

    def __init__(self):
        self.fut = Future()
        self.submits = 0

    def submit(self, expr, reduce, batch, leaf_keys=None, direct=None, check=None):
        self.submits += 1
        return self.fut


class TestCoalesceWaiterDeadline:
    def _executor(self):
        ex = Executor(
            holder=SimpleNamespace(stats=NopStatsClient(), placed=torch.device("cpu")),
            host="h:1",
            cluster=Cluster(),
        )
        ex.coalescer = _StubCoalescer()
        return ex

    @staticmethod
    def _entry():
        # The port's batch entry: the tree and its leaves' keys; the row
        # table itself goes to the coalescer untouched.
        return SimpleNamespace(expr=("leaf", 0), leaf_keys=None, leaf_inputs=False)

    def test_expired_waiter_detaches_without_poisoning_shared_batch(self):
        ex = self._executor()
        stub = ex.coalescer
        ent = self._entry()
        t0 = time.monotonic()
        with rz.deadline_scope(rz.Deadline.after_ms(60)):
            with pytest.raises(rz.DeadlineExceeded):
                ex._coalesce_eval(ent, None, "count")
        assert time.monotonic() - t0 < 5.0  # not the flat 600 s wait
        # The shared launch was NOT cancelled by the departing waiter...
        assert not stub.fut.cancelled()
        # ...so a surviving waiter of the same launch still gets rows.
        stub.fut.set_result(
            (np.array([3, 4], dtype=np.int32), {"batch_queries": 2})
        )
        res = ex._coalesce_eval(ent, None, "count")
        assert list(res) == [3, 4]
        assert stub.submits == 2
        ex.close()

    def test_flat_backstop_timeout_preserved_without_deadline(self, monkeypatch):
        """No deadline -> the RESULT_TIMEOUT_S backstop still applies
        (shrunk here) and surfaces as the original TimeoutError."""
        from concurrent.futures import TimeoutError as FuturesTimeoutError

        from pilosa_tpu_torch.exec import coalesce as coalesce_mod

        ex = self._executor()
        monkeypatch.setattr(coalesce_mod, "RESULT_TIMEOUT_S", 0.05)
        with pytest.raises(FuturesTimeoutError):
            ex._coalesce_eval(self._entry(), None, "count")
        ex.close()


# ---------------------------------------------------------------------------
# end-to-end chaos over two real HTTP nodes
# ---------------------------------------------------------------------------

_QUIET = dict(
    anti_entropy_interval=3600,
    polling_interval=3600,
    device="cpu",
    floor_probe=False,
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_servers(tmp_path, replicas=1, **server_kw):
    """Two fixed-port nodes sharing a static cluster map (no broadcast
    machinery — remote max slices are set explicitly by the tests)."""
    kw = dict(_QUIET)
    kw.update(server_kw)
    ports: set[int] = set()
    while len(ports) < 2:
        ports.add(_free_port())
    hosts = sorted(f"127.0.0.1:{p}" for p in ports)

    def make(name, host):
        s = Server(
            str(tmp_path / name), host=host, hosts=hosts, replicas=replicas, **kw
        )
        s.open()
        return s

    s0, s1 = make("n0", hosts[0]), make("n1", hosts[1])
    for s in (s0, s1):
        s.holder.create_index_if_not_exists("i")
        s.holder.index("i").create_frame_if_not_exists("f")
    return s0, s1


def _seed_slices(s0, s1, n_slices=6, row=1):
    """One bit per slice, written straight into the owning holder, and
    both nodes told the cluster max slice (no broadcast wait)."""
    for sl in range(n_slices):
        owner = s0.cluster.fragment_nodes("i", sl)[0].host
        srv = s0 if owner == s0.host else s1
        srv.holder.frame("i", "f").set_bit("standard", row, sl * SLICE_WIDTH)
    for s in (s0, s1):
        s.holder.index("i").set_remote_max_slice(n_slices - 1)


def _owned_by(s0, host, n_slices=6):
    return [
        sl
        for sl in range(n_slices)
        if s0.cluster.fragment_nodes("i", sl)[0].host == host
    ]


def _query_json(client, index, q, slices=None, allow_partial=False, headers=None):
    params = {}
    if slices is not None:
        params["slices"] = ",".join(str(s) for s in slices)
    if allow_partial:
        params["allowPartial"] = "true"
    status, data, _ = client._request_meta(
        "POST",
        f"/index/{index}/query",
        query=params or None,
        body=q.encode(),
        headers=headers or {},
    )
    return status, json.loads(data)


COUNT_Q = 'Count(Bitmap(frame="f", rowID=1))'

def _until(pred, timeout: float = 30.0, what: str = "condition") -> None:
    """Wait for ``pred()`` by a bounded poll (never a bare sleep)."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _breaker_ready(server, host: str) -> bool:
    """The server's breaker for ``host`` admits a call: closed, or open
    for its whole ``open_s`` (the next call is the half-open probe)."""
    b = server.resilience.breakers.for_host(host)
    snap = b.snapshot()
    return snap["state"] == "closed" or snap.get("sinceOpenMs", 0.0) >= b.open_s * 1000.0

BITMAP_Q = 'Bitmap(frame="f", rowID=1)'


class TestChaosEndToEnd:
    def test_partial_results_byte_identical_and_fail_fast(self, tmp_path):
        s0, s1 = _two_servers(
            tmp_path, replicas=1, retry_attempts=2, retry_backoff_ms=5
        )
        try:
            _seed_slices(s0, s1)
            lost = _owned_by(s0, s1.host)
            surviving = _owned_by(s0, s0.host)
            assert lost and surviving, "placement must split across nodes"
            c0 = InternalClient(s0.host, timeout=10.0)

            # Fault-free baselines RESTRICTED to the surviving slices.
            st, base_bm = _query_json(c0, "i", BITMAP_Q, slices=surviving)
            assert st == 200
            st, base_ct = _query_json(c0, "i", COUNT_Q, slices=surviving)
            assert st == 200

            s1.close()  # hard-down node; replicas=1 -> its slices are lost

            # Without the flag: fail fast, naming exactly the lost slices.
            st, err = _query_json(c0, "i", COUNT_Q)
            assert st == 500
            assert "slices unavailable" in err["error"]
            assert str(sorted(lost)) in err["error"]

            # With allowPartial: byte-identical to the restricted run,
            # missingSlices exactly the lost ones.
            st, part_bm = _query_json(c0, "i", BITMAP_Q, allow_partial=True)
            assert st == 200
            assert part_bm["partial"] is True
            assert part_bm["missingSlices"] == sorted(lost)
            assert part_bm["results"] == base_bm["results"]

            st, part_ct = _query_json(c0, "i", COUNT_Q, allow_partial=True)
            assert st == 200
            assert part_ct["results"] == base_ct["results"]
            assert part_ct["missingSlices"] == sorted(lost)
        finally:
            with suppress(Exception):
                s0.close()
            with suppress(Exception):
                s1.close()

    def test_breaker_opens_under_faults_then_recovers(self, tmp_path):
        s0, s1 = _two_servers(
            tmp_path,
            replicas=1,
            retry_attempts=1,
            breaker_failure_threshold=3,
            breaker_open_ms=250,
        )
        try:
            _seed_slices(s0, s1)
            c0 = InternalClient(s0.host, timeout=10.0)
            plan = faults.install(
                f"rpc.send:host={s1.host},path=/index/*/query,mode=error"
            )

            # Each query's s1 leg fails once (retry_attempts=1); after
            # the threshold the breaker opens.
            for _ in range(3):
                st, payload = _query_json(
                    c0, "i", COUNT_Q, allow_partial=True
                )
                assert st == 200 and payload.get("partial") is True
            assert s0.resilience.breakers.state(s1.host) == rz.STATE_OPEN

            # Surfaced at /debug/health.
            st, data = c0._request("GET", "/debug/health")
            health = json.loads(data)
            assert health["breakers"][s1.host]["state"] == rz.STATE_OPEN

            # While open: straight to failover, no wire attempt burned.
            hits = plan.rules[0].hits
            st, payload = _query_json(c0, "i", COUNT_Q, allow_partial=True)
            assert st == 200 and payload.get("partial") is True
            assert plan.rules[0].hits == hits

            # Heal the network; after open_ms the half-open probe
            # succeeds, the breaker closes, and results are whole again.
            faults.clear()
            _until(lambda: _breaker_ready(s0, s1.host), what="the breaker's open period")
            st, payload = _query_json(c0, "i", COUNT_Q, allow_partial=True)
            assert st == 200
            assert "partial" not in payload
            assert payload["results"][0] == 6
            assert s0.resilience.breakers.state(s1.host) == rz.STATE_CLOSED
        finally:
            faults.clear()
            with suppress(Exception):
                s0.close()
            with suppress(Exception):
                s1.close()

    def test_retries_respect_caps(self, tmp_path):
        s0, s1 = _two_servers(
            tmp_path,
            replicas=1,
            retry_attempts=2,
            retry_backoff_ms=5,
            breaker_failure_threshold=100,
        )
        try:
            _seed_slices(s0, s1)
            c0 = InternalClient(s0.host, timeout=10.0)
            plan = faults.install(
                f"rpc.send:host={s1.host},path=/index/*/query,mode=error"
            )
            st, payload = _query_json(c0, "i", COUNT_Q, allow_partial=True)
            assert st == 200 and payload.get("partial") is True
            # Exactly `retry_attempts` wire tries for the failing leg.
            assert plan.rules[0].hits == 2
        finally:
            faults.clear()
            with suppress(Exception):
                s0.close()
            with suppress(Exception):
                s1.close()

    def test_transient_fault_retried_transparently(self, tmp_path):
        s0, s1 = _two_servers(
            tmp_path, replicas=1, retry_attempts=3, retry_backoff_ms=5
        )
        try:
            _seed_slices(s0, s1)
            c0 = InternalClient(s0.host, timeout=10.0)
            plan = faults.install(
                f"rpc.send:host={s1.host},path=/index/*/query,nth=1,mode=error"
            )
            st, payload = _query_json(c0, "i", COUNT_Q)
            assert st == 200
            assert "partial" not in payload
            assert payload["results"][0] == 6
            assert plan.rules[0].hits == 1  # failed once, retried, healed
        finally:
            faults.clear()
            with suppress(Exception):
                s0.close()
            with suppress(Exception):
                s1.close()

    def test_deadline_504_coordinator_and_remote_leg(self, tmp_path):
        s0, s1 = _two_servers(
            tmp_path, replicas=1, retry_attempts=2, retry_backoff_ms=5
        )
        try:
            _seed_slices(s0, s1)
            c0 = InternalClient(s0.host, timeout=10.0)
            c1 = InternalClient(s1.host, timeout=10.0)

            # Coordinator: an expired per-request deadline answers 504
            # with the trace id.
            st, err = _query_json(
                c0, "i", COUNT_Q, headers={rz.DEADLINE_HEADER: "0"}
            )
            assert st == 504
            assert "deadline" in err["error"]
            assert "trace" in err["error"]

            # Remote leg served directly: same contract on any node.
            st, err = _query_json(
                c1, "i", COUNT_Q, headers={rz.DEADLINE_HEADER: "0"}
            )
            assert st == 504

            # Propagation: a delayed remote leg blows the coordinator's
            # budget -> the coordinator 504s (never a bogus failover
            # answer), and the lost budget is not misread as a dead node.
            faults.install(
                f"rpc.recv:host={s1.host},path=/index/*/query,"
                "mode=delay,delay-ms=600"
            )
            t0 = time.monotonic()
            st, err = _query_json(
                c0, "i", COUNT_Q, headers={rz.DEADLINE_HEADER: "200"}
            )
            assert st == 504
            assert "trace" in err["error"]
            assert time.monotonic() - t0 < 5.0
        finally:
            faults.clear()
            with suppress(Exception):
                s0.close()
            with suppress(Exception):
                s1.close()

    def test_device_fault_serves_whole_via_host_fallback(self, tmp_path):
        """An injected device-launch fault no longer turns the node
        into a brick the cluster must route around: the device-health
        layer (device/health.py) classifies the failure, retries once,
        and answers the SAME query byte-identically from the
        authoritative host planes — whole, not partial — and the next
        fault-free query rides the device path again."""
        s0, s1 = _two_servers(
            tmp_path, replicas=1, retry_attempts=1
        )
        try:
            _seed_slices(s0, s1)
            c0 = InternalClient(s0.host, timeout=10.0)
            # Persistent while installed: initial launch + the health
            # layer's single retry both fault on every mapper.
            faults.install("device.launch:mode=error")
            st, payload = _query_json(c0, "i", COUNT_Q, allow_partial=True)
            assert st == 200
            assert payload.get("partial") is not True
            assert payload["results"][0] == 6
            faults.clear()
            st, payload = _query_json(c0, "i", COUNT_Q)
            assert st == 200 and payload["results"][0] == 6
        finally:
            faults.clear()
            with suppress(Exception):
                s0.close()
            with suppress(Exception):
                s1.close()
