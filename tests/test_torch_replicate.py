"""The JAX package's quorum-replication suite, run against the port.

``tests/test_replicate.py``'s classes with their assertions unchanged:
W-of-N levels, the version store and the hint log
(``pilosa_tpu_torch/replicate/``), and three-replica clusters of port
nodes over HTTP on the CPU (``Server(device="cpu")``): a replica killed
under sustained quorum writes converges from hint replay alone, a
partition injected at ``rpc.send`` queues hints that a forced replay
drains, a quorum read through a stale replica repairs it first (read your
writes), writes and imports below W fail loudly and still queue hints,
the syncer skips slices whose versions agree, and versions survive a
clean restart.  Only the harness differs: the port's ``Server`` takes its
ring as ``hosts=``, peers that bound port 0 meet through ``add_peer``,
clients decode Bitmaps on the CPU, and the port's client sends one
slice's import as ``import_slice(index, frame, slice, rows, cols)``.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.cluster.topology import Cluster  # noqa: E402,F401
from pilosa_tpu_torch.net.client import ClientError, InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.replicate import hints as hints_mod  # noqa: E402
from pilosa_tpu_torch.replicate import (  # noqa: E402
    HintLog,
    VersionStore,
    required_acks,
    validate_level,
)

# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


class TestRequiredAcks:
    def test_levels(self):
        assert required_acks("one", 3) == 1
        assert required_acks("quorum", 1) == 1
        assert required_acks("quorum", 2) == 2
        assert required_acks("quorum", 3) == 2
        assert required_acks("quorum", 4) == 3
        assert required_acks("quorum", 5) == 3
        assert required_acks("all", 3) == 3
        assert required_acks("all", 0) == 1  # clamped to >= 1 replica

    def test_unknown_level_raises(self):
        with pytest.raises(ValueError):
            required_acks("most", 3)
        with pytest.raises(ValueError):
            validate_level("banana")


class TestVersionStore:
    def test_bump_is_monotonic_per_slice(self):
        vs = VersionStore()
        assert vs.bump("i", 0) == 1
        assert vs.bump("i", 0) == 2
        assert vs.bump("i", 1) == 1
        assert vs.get("i", 0) == 2
        assert vs.get_many("i", [0, 1, 2]) == {0: 2, 1: 1, 2: 0}

    def test_observe_max_merges(self):
        vs = VersionStore()
        vs.bump("i", 0)
        assert vs.observe("i", 0, 9) == 9
        # never backwards
        assert vs.observe("i", 0, 3) == 9
        assert vs.get("i", 0) == 9

    def test_doc_roundtrip(self):
        vs = VersionStore()
        vs.bump("i", 0)
        vs.observe("i", 5, 7)
        vs2 = VersionStore()
        vs2.load_doc(vs.to_doc())
        assert vs2.get("i", 0) == 1
        assert vs2.get("i", 5) == 7

    def test_snapshot_summarizes(self):
        vs = VersionStore()
        for s in range(4):
            vs.observe("i", s, s + 1)
        snap = vs.snapshot()
        assert snap["i"]["slices"] == 4
        assert snap["i"]["max"] == 4


class _Frag:
    def __init__(self, index="i", frame="f", view="standard", slice_i=0):
        self.index, self.frame, self.view, self.slice = index, frame, view, slice_i
        self.path = "/data/n0/i/f/standard/0"


class TestHintLog:
    def test_capture_scope_records_local_writes(self):
        buf: list = []
        with hints_mod.capture(buf):
            hints_mod.record_local_write(_Frag(), (1,), (10,), (), ())
        # outside the scope: no-op
        hints_mod.record_local_write(_Frag(), (2,), (20,), (), ())
        assert buf == [("i", 0, "f", "standard", [1], [10], [], [])]

    def test_queue_drain_order_and_requeue(self):
        log = HintLog(cap=100)
        assert log.queue_pql("h1", "i", 0, "SetBit(...)")
        log.queue_views(
            "h1", [("i", 0, "f", "standard", [2], [20], [], [])]
        )
        assert log.backlog("h1") == 2
        groups = log.drain("h1")
        assert [(g[0], g[1], len(g[2])) for g in groups] == [("i", 0, 2)]
        assert groups[0][2][0][0] == "pql"
        assert log.backlog("h1") == 0
        # a dead push requeues head-first
        log.queue_pql("h1", "i", 0, "later")
        log.requeue("h1", "i", 0, groups[0][2])
        drained = log.drain("h1")[0][2]
        assert [e[0] for e in drained] == ["pql", "views", "pql"]

    def test_cap_overflow_drops_slice_and_counts(self):
        log = HintLog(cap=3)
        for k in range(5):
            log.queue_views(
                "h1", [("i", 0, "f", "standard", [k], [k], [], [])]
            )
        assert log.dropped > 0
        # the overflowed slice refuses further hints (a partial stream
        # replays to a state that is neither old nor new)...
        assert not log.queue_pql("h1", "i", 0, "x")
        # ...but other slices are unaffected
        assert log.queue_pql("h1", "i", 1, "x")
        assert log.backlog("h1") == 1
        # the drain reports the overflow so the replayer reconciles by
        # checksum instead of trusting the stream; afterwards the slice
        # accepts hints again
        over = {(g[0], g[1]): g[3] for g in log.drain("h1")}
        assert over[("i", 0)] is True and over[("i", 1)] is False
        assert log.queue_pql("h1", "i", 0, "y")

    def test_payload_kind_validated(self):
        log = HintLog()
        with pytest.raises(ValueError):
            log.queue_payload("h1", "i", 0, "csv", b"x", 1)

    def test_note_replay_tracks_outcome(self):
        log = HintLog()
        log.queue_pql("h1", "i", 0, "x")
        log.drain("h1")
        log.note_replay("h1", 1)
        snap = log.snapshot()
        assert snap["targets"]["h1"]["replayed"] == 1
        assert "lastError" not in snap["targets"]["h1"]
        log.note_replay("h1", 0, error="boom")
        assert log.snapshot()["targets"]["h1"]["lastError"] == "boom"


# ---------------------------------------------------------------------------
# end-to-end: 3 replicas over real HTTP nodes
# ---------------------------------------------------------------------------

N_SLICES = 4


def _boot(tmp_path, name, host="127.0.0.1:0", ring=(), replay_s=0.2, **kw):
    s = Server(
        str(tmp_path / name),
        host=host,
        hosts=list(ring),
        replicas=3,
        device="cpu",
        floor_probe=False,
        anti_entropy_interval=3600,  # anti-entropy NEVER ticks in tests
        polling_interval=3600,
        breaker_open_ms=300.0,
        **kw,
    )
    s.replication.replay_interval_s = replay_s
    s.open()
    return s


def _wire(servers, hosts):
    for s in servers:
        for h in hosts:
            s.add_peer(h)


def _schema(servers):
    for s in servers:
        s.holder.create_index_if_not_exists("i")
        s.holder.index("i").create_frame_if_not_exists("f")


def _seed(client, servers):
    for sl in range(N_SLICES):
        client.execute_query(
            "i", f'SetBit(frame="f", rowID=1, columnID={sl * SLICE_WIDTH + sl})'
        )
    for s in servers:
        s.tick_max_slices()


def _checksums(server, sl):
    return server.rebalance.delta_action(
        {"index": "i", "slice": sl, "action": "checksum"}
    )["checksums"]


def _local_row_bits(server, row):
    total = 0
    view = server.holder.index("i").frame("f").view("standard")
    for sl in range(N_SLICES):
        frag = view.fragment(sl)
        if frag is not None:
            total += frag._count_of.get(row, 0)
    return total


def _debug_replication(host):
    client = InternalClient(host, timeout=10.0, device="cpu")
    status, data = client._request("GET", "/debug/replication")
    return json.loads(client._check(status, data))


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


class TestChaosKillRestartConverge:
    def test_zero_lost_writes_without_anti_entropy(self, tmp_path):
        """Kill a replica under sustained quorum
        writes, restart it, and every write converges onto it from
        HINT REPLAY alone — checksum agreement across all replicas with
        the anti-entropy loop disabled (interval 3600 s)."""
        servers = [_boot(tmp_path, f"n{i}") for i in range(3)]
        stop = threading.Event()
        try:
            hosts = sorted(s.host for s in servers)
            _wire(servers, hosts)
            _schema(servers)
            s0 = servers[0]
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            _seed(c0, servers)

            victim = servers[2]
            victim_host = victim.host

            errors: list[str] = []
            written: list[int] = []

            def writer():
                cw = InternalClient(s0.host, timeout=10.0, device="cpu")
                k = 0
                while not stop.is_set():
                    col = (k % N_SLICES) * SLICE_WIDTH + 100 + k // N_SLICES
                    try:
                        cw.execute_query(
                            "i", f'SetBit(frame="f", rowID=3, columnID={col})'
                        )
                        written.append(col)
                    except (ClientError, ConnectionError) as e:
                        errors.append(f"writer: {e}")
                        return
                    k += 1
                    time.sleep(0.005)

            t = threading.Thread(target=writer, daemon=True)
            t.start()
            _until(lambda: written or errors, what="the writer's first write")

            # KILL the replica mid-storm: quorum (2 of 3) writes keep
            # succeeding, each queuing a hint for the dead host.
            victim.close()
            deadline = time.time() + 20
            while (
                time.time() < deadline
                and s0.replication.hints.backlog(victim_host) < 5
            ):
                time.sleep(0.05)
            assert s0.replication.hints.backlog(victim_host) >= 5, (
                "sustained writes queued no hints for the dead replica"
            )
            snap = _debug_replication(s0.host)
            assert victim_host in snap["hints"]["targets"]

            # RESTART it (same identity/dir) while writes continue; the
            # breaker's open->half-open transition triggers replay.
            victim = _boot(tmp_path, "n2", host=victim_host, ring=hosts)
            servers[2] = victim
            deadline = time.time() + 30
            while (
                time.time() < deadline
                and s0.replication.hints.backlog(victim_host) > 0
            ):
                time.sleep(0.1)
            stop.set()
            t.join(timeout=10.0)
            assert not errors, errors
            assert written, "writer made no progress"
            # Drain hints for writes issued after the join as well;
            # backlog==0 only means "drained", so convergence is
            # polled on the authoritative signal: checksum agreement
            # (a drained hint may still be applying over HTTP).
            deadline = time.time() + 30
            while time.time() < deadline:
                if s0.replication.hints.backlog(victim_host) == 0 and all(
                    _checksums(s0, sl) == _checksums(victim, sl)
                    for sl in range(N_SLICES)
                ):
                    break
                time.sleep(0.1)
            assert s0.replication.hints.backlog(victim_host) == 0

            # ZERO lost writes, converged WITHOUT anti-entropy: the
            # restarted replica's LOCAL fragments carry every confirmed
            # write and checksum-agree with the survivors.
            expect = len(set(written))
            assert _local_row_bits(victim, 3) == expect
            for sl in range(N_SLICES):
                assert _checksums(s0, sl) == _checksums(victim, sl), (
                    f"slice {sl} diverged after hint replay"
                )
        finally:
            stop.set()
            for s in servers:
                s.close()


class TestFaultInjectedPartition:
    def test_injected_write_leg_errors_queue_hints(self, tmp_path):
        """testing/faults.py chaos: the replica PROCESS stays up but its
        write legs error at the rpc.send boundary (a partitioned
        network, not a dead node) — quorum writes still succeed, hints
        queue, and a forced replay after the partition heals converges
        the replica without anti-entropy."""
        from pilosa_tpu_torch.testing import faults

        servers = [_boot(tmp_path, f"n{i}", replay_s=3600.0) for i in range(3)]
        try:
            hosts = sorted(s.host for s in servers)
            _wire(servers, hosts)
            _schema(servers)
            s0 = servers[0]
            victim = servers[2]
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            _seed(c0, servers)

            faults.install(
                f"rpc.send:host={victim.host},path=/index/*/query,mode=error"
            )
            try:
                cols = [SLICE_WIDTH * 2 + 300 + k for k in range(5)]
                for col in cols:
                    c0.execute_query(
                        "i", f'SetBit(frame="f", rowID=4, columnID={col})'
                    )
            finally:
                faults.clear()
            assert s0.replication.hints.backlog(victim.host) >= len(cols)
            assert _local_row_bits(victim, 4) == 0

            # partition healed: once the victim's breaker re-admits
            # traffic (open -> half-open after breaker_open_ms), the
            # replay — which IS the half-open probe — converges it.
            _until(lambda: _breaker_ready(s0, victim.host), what="the breaker's open period")
            replayed = s0.replication.replay_now(victim.host)
            assert replayed[victim.host] >= len(cols)
            assert _local_row_bits(victim, 4) == len(cols)
            for sl in range(N_SLICES):
                assert _checksums(s0, sl) == _checksums(victim, sl)
        finally:
            faults.clear()
            for s in servers:
                s.close()


class TestReadYourWrites:
    def test_quorum_read_repairs_stale_replica(self, tmp_path):
        """W=quorum + R=quorum overlap: a write acked while one replica
        was down MUST be visible to a quorum read coordinated by that
        stale replica — the version check detects the lag and the
        synchronous read-repair converges it before serving."""
        # Replay disabled (huge interval): the stale replica stays
        # stale unless the READ path repairs it.
        servers = [
            _boot(tmp_path, f"n{i}", replay_s=3600.0) for i in range(3)
        ]
        try:
            hosts = sorted(s.host for s in servers)
            _wire(servers, hosts)
            _schema(servers)
            s0 = servers[0]
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            _seed(c0, servers)

            victim = servers[2]
            victim_host = victim.host
            # A slice whose PRIMARY is the victim: the default "one"
            # read through the victim serves its own (stale) fragment.
            target_slice = next(
                sl
                for sl in range(N_SLICES)
                if s0.cluster.fragment_nodes("i", sl)[0].host == victim_host
            )
            col = target_slice * SLICE_WIDTH + 777

            victim.close()
            # Quorum write while the replica is down: 2 of 3 ack.
            c0.execute_query(
                "i", f'SetBit(frame="f", rowID=7, columnID={col})'
            )

            victim = _boot(
                tmp_path, "n2", host=victim_host, ring=hosts,
                replay_s=3600.0,
            )
            servers[2] = victim
            cv = InternalClient(victim.host, timeout=30.0, device="cpu")

            # At consistency "one" the victim serves its own stale
            # fragment: the write is invisible.
            got = cv.execute_query(
                "i",
                'Count(Bitmap(frame="f", rowID=7))',
                slices=[target_slice],
            )
            assert got[0] == 0, "victim unexpectedly already converged"

            # At quorum the version check sees the lag, read-repair
            # pushes newest -> stale, and the SAME coordinator answers
            # with the write: read-your-writes.
            got = cv.execute_query(
                "i",
                'Count(Bitmap(frame="f", rowID=7))',
                slices=[target_slice],
                trace_headers={"X-Read-Consistency": "quorum"},
            )
            assert got[0] == 1
            # ...and the repair actually converged the local fragment,
            # so even "one" reads see it now.
            got = cv.execute_query(
                "i",
                'Count(Bitmap(frame="f", rowID=7))',
                slices=[target_slice],
            )
            assert got[0] == 1
        finally:
            for s in servers:
                s.close()


class TestSubQuorumFailsLoudly:
    def test_write_below_w_raises_and_queues_hint(self, tmp_path):
        """A write that cannot gather W acks
        FAILS the request loudly (naming the counts) instead of
        reporting success because someone acked — and the failed
        replica's hint is queued regardless."""
        servers = [_boot(tmp_path, f"n{i}") for i in range(3)]
        try:
            hosts = sorted(s.host for s in servers)
            _wire(servers, hosts)
            _schema(servers)
            s0 = servers[0]
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            _seed(c0, servers)

            victim_host = servers[2].host
            servers[2].close()

            # consistency=all with a dead replica: loud failure.
            with pytest.raises(ClientError) as ei:
                c0.execute_query(
                    "i",
                    f'SetBit(frame="f", rowID=5, columnID={SLICE_WIDTH + 9})',
                    trace_headers={"X-Write-Consistency": "all"},
                )
            assert "2 of 3" in str(ei.value) and "need 3" in str(ei.value)
            assert s0.replication.hints.backlog(victim_host) >= 1

            # default quorum still succeeds (2 of 3) and hints too.
            before = s0.replication.hints.backlog(victim_host)
            c0.execute_query(
                "i",
                f'SetBit(frame="f", rowID=5, columnID={SLICE_WIDTH + 10})',
            )
            assert s0.replication.hints.backlog(victim_host) > before

            # junk consistency is a 400, not a silent default.
            with pytest.raises(ClientError) as ei:
                c0.execute_query(
                    "i",
                    'Count(Bitmap(frame="f", rowID=1))',
                    trace_headers={"X-Read-Consistency": "banana"},
                )
            assert ei.value.status == 400
        finally:
            for s in servers[:2]:
                s.close()

    def test_import_fanout_w_of_n(self, tmp_path):
        """Client import fan-out under the same contract: sub-W raises
        naming the dead host; at a met W the dead replica's payload is
        queued as a hint on an acked node and replays on recovery."""
        import numpy as np

        servers = [_boot(tmp_path, f"n{i}") for i in range(3)]
        try:
            hosts = sorted(s.host for s in servers)
            _wire(servers, hosts)
            _schema(servers)
            s0 = servers[0]
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            _seed(c0, servers)

            victim = servers[2]
            victim_host = victim.host
            victim.close()

            bits = (
                np.asarray([9, 9, 9], dtype=np.uint64),
                np.asarray([11, 12, 13], dtype=np.uint64),
            )
            with pytest.raises(ClientError) as ei:
                c0.import_slice("i", "f", 0, *bits, consistency="all")
            assert victim_host in str(ei.value)
            assert "need 3" in str(ei.value)

            # quorum succeeds and the dead host's payload parks as a
            # hint on one of the acked nodes.
            c0.import_slice("i", "f", 0, *bits, consistency="quorum")
            holder = next(
                s
                for s in servers[:2]
                if s.replication.hints.backlog(victim_host) > 0
            )

            victim = _boot(tmp_path, "n2", host=victim_host, ring=hosts)
            servers[2] = victim
            deadline = time.time() + 20
            while (
                time.time() < deadline
                and holder.replication.hints.backlog(victim_host) > 0
            ):
                time.sleep(0.1)
            assert holder.replication.hints.backlog(victim_host) == 0
            assert _local_row_bits(victim, 9) == 3
        finally:
            for s in servers:
                s.close()


class TestSyncerVersionSkip:
    def test_in_sync_slices_skip_and_lag_attributes_cause(self, tmp_path):
        """Anti-entropy becomes the backstop: replica-agreed versions
        skip the block checksum walk; a lagging replica attributes the
        sweep to cause:missed-hint; full=True never skips."""
        from pilosa_tpu_torch.sync.syncer import HolderSyncer

        servers = [_boot(tmp_path, f"n{i}") for i in range(3)]
        try:
            hosts = sorted(s.host for s in servers)
            _wire(servers, hosts)
            _schema(servers)
            s0 = servers[0]
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            _seed(c0, servers)

            syncer = HolderSyncer(
                holder=s0.holder,
                host=s0.host,
                cluster=s0.cluster,
                replication=s0.replication,
            )
            idx_max = N_SLICES - 1
            # every replica applied every write: versions agree -> skip
            for sl in range(N_SLICES):
                assert syncer.slice_cause("i", sl, idx_max) is None

            # lag one replica's version: provably missed writes
            servers[2].replication.versions.observe("i", 0, 999)
            syncer2 = HolderSyncer(
                holder=s0.holder,
                host=s0.host,
                cluster=s0.cluster,
                replication=s0.replication,
            )
            assert syncer2.slice_cause("i", 0, idx_max) == "missed-hint"

            # full sweep: never skips, cause is plain drift
            syncer3 = HolderSyncer(
                holder=s0.holder,
                host=s0.host,
                cluster=s0.cluster,
                replication=s0.replication,
                full=True,
            )
            assert syncer3.slice_cause("i", 0, idx_max) == "drift"
            # without replication wired: legacy behavior (always walk)
            syncer4 = HolderSyncer(
                holder=s0.holder, host=s0.host, cluster=s0.cluster
            )
            assert syncer4.slice_cause("i", 0, idx_max) == "drift"
        finally:
            for s in servers:
                s.close()


class TestVersionPersistence:
    def test_versions_survive_clean_restart(self, tmp_path):
        s = _boot(tmp_path, "n0")
        try:
            host = s.host
            s.holder.create_index_if_not_exists("i")
            s.holder.index("i").create_frame_if_not_exists("f")
            c = InternalClient(s.host, timeout=10.0, device="cpu")
            c.execute_query("i", 'SetBit(frame="f", rowID=1, columnID=3)')
            v = s.replication.versions.get("i", 0)
            assert v >= 1
        finally:
            s.close()
        s = _boot(tmp_path, "n0", host=host, ring=[host])
        try:
            assert s.replication.versions.get("i", 0) >= v
        finally:
            s.close()


# ---------------------------------------------------------------------------
# side by side: a JAX cluster and a port cluster, one seeded sequence
# ---------------------------------------------------------------------------

_SBS_SLICES = 6


def _free_hosts(n: int) -> list[str]:
    import socket

    ports: set[int] = set()
    while len(ports) < n:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.add(s.getsockname()[1])
        s.close()
    return sorted(f"127.0.0.1:{p}" for p in ports)


class _Side:
    """One cluster of the comparison: three nodes, 2 replicas, breakers
    that never open (so every failure reads the same in both runs), hint
    replay driven by the test."""

    QUIET = dict(anti_entropy_interval=3600, polling_interval=3600,
                 breaker_failure_threshold=1_000_000, retry_backoff_ms=5.0,
                 rebalance_release_delay_ms=0.0)

    def __init__(self, kind: str, tmp_path):
        self.kind = kind
        self.tmp = tmp_path / kind
        self.hosts = _free_hosts(3)
        self.nodes = [self.boot(i) for i in range(3)]

    def boot(self, i: int):
        host = self.hosts[i]
        if self.kind == "jax":
            from pilosa_tpu.cluster.topology import Cluster as JCluster
            from pilosa_tpu.net.server import Server as JServer

            c = JCluster(replica_n=2)
            for h in self.hosts:
                c.add_node(h)
            s = JServer(data_dir=str(self.tmp / f"n{i}"), host=host, cluster=c,
                        cache_flush_interval=3600, **self.QUIET)
        else:
            s = Server(str(self.tmp / f"n{i}"), host=host, hosts=self.hosts, replicas=2,
                       device="cpu", floor_probe=False, **self.QUIET)
        s.replication.replay_interval_s = 3600.0
        s.open()
        return s

    def norm(self, data: bytes) -> str:
        text = data.decode()
        for i, h in enumerate(self.hosts):
            text = text.replace(h, f"node{i}")
        return text

    def request(self, i: int, method: str, path: str, body: bytes = b"",
                headers: dict | None = None) -> tuple[int, str]:
        import http.client

        conn = http.client.HTTPConnection(self.hosts[i], timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, self.norm(resp.read())
        finally:
            conn.close()

    def tick_full_anti_entropy(self) -> None:
        for s in self.nodes:
            s._ae_ticks = s.FULL_SYNC_EVERY - 1
            (s._tick_anti_entropy if self.kind == "jax" else s.tick_anti_entropy)()

    def checksums(self) -> dict:
        out = {}
        for i, s in enumerate(self.nodes):
            idx = s.holder.index("i")
            if idx is None:
                continue
            for v in idx.frame("f").views().values():
                for frag in v.fragments():
                    out[(i, v.name, frag.slice)] = frag.checksum()
        return out

    def close(self) -> None:
        for s in self.nodes:
            try:
                s.close()
            except Exception:
                pass


def _shape(doc):
    """The keys of a JSON document, recursively (values dropped)."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_shape(v) for v in doc[:1]]
    return type(doc).__name__


def test_side_by_side_with_a_jax_cluster(tmp_path):
    """A JAX 3-node cluster and a port 3-node cluster (2 replicas) take the
    same seeded sequence — writes at each level, a node killed and
    restarted, hint replay, a forced divergence and a full anti-entropy
    sweep, reads at each level, junk levels, and a drain 3->2 then a
    grow 2->3 — and answer every request with the same status and body
    (host names normalised); at the end every fragment's checksum is the
    same and /debug/replication and /debug/rebalance have one shape."""
    sides = [_Side("jax", tmp_path), _Side("port", tmp_path)]
    rng = np.random.default_rng(2026)

    def both(i, method, path, body=b"", headers=None, want=None):
        got = [side.request(i, method, path, body, headers) for side in sides]
        assert got[1] == got[0], (method, path, body, headers)
        if want is not None:
            assert got[0][0] == want, got[0]
        return got[0]

    def q(i, pql, params="", headers=None, want=None):
        return both(i, "POST", f"/index/i/query{params}", pql.encode(), headers, want)

    try:
        for i in range(3):
            both(i, "POST", "/index/i", want=200)
            both(i, "POST", "/index/i/frame/f", want=200)
        levels = ("one", "quorum", "all")
        bits = set()
        for k in range(18):
            col = int(rng.integers(0, _SBS_SLICES * SLICE_WIDTH))
            bits.add((1, col))
            q(k % 3, f'SetBit(frame="f", rowID=1, columnID={col})',
              f"?writeConsistency={levels[k % 3]}", want=200)
        for side in sides:
            for s in side.nodes:
                (s._tick_max_slices if side.kind == "jax" else s.tick_max_slices)()
        # Node 2 down in both clusters.
        for side in sides:
            side.nodes[2].close()
        for k in range(12):
            col = int(rng.integers(0, _SBS_SLICES * SLICE_WIDTH))
            level = levels[k % 3]
            status, _ = q(k % 2, f'SetBit(frame="f", rowID=2, columnID={col})',
                          headers={"X-Write-Consistency": level})
            owners = {n.host for n in sides[0].nodes[0].cluster.fragment_nodes(
                "i", col // SLICE_WIDTH)}
            assert status == (500 if level != "one" and sides[0].hosts[2] in owners else 200)
        for level in levels:
            for i in (0, 1):
                # N = 2: quorum and all both need node 2's version.
                q(i, 'Count(Bitmap(frame="f", rowID=1))', f"?readConsistency={level}",
                  want=200 if level == "one" else 500)
        q(0, 'Count(Bitmap(frame="f", rowID=1))', "?readConsistency=banana", want=400)
        q(0, 'SetBit(frame="f", rowID=1, columnID=1)', headers={"X-Write-Consistency": "most"},
          want=400)
        # Restart node 2 and replay every hint.
        for side in sides:
            side.nodes[2] = side.boot(2)
        for i in (0, 1):
            both(i, "POST", "/replicate/replay", b"{}", want=200)
        for side in sides:
            assert all(s.replication.hints.backlog() == 0 for s in side.nodes)
            docs = [json.loads(side.request(i, "GET", "/debug/replication")[1])
                    for i in range(3)]
            side.replication_shape = [sorted(d) for d in docs]
        assert sides[1].replication_shape == sides[0].replication_shape
        for level in levels:
            for i in range(3):
                q(i, 'Count(Bitmap(frame="f", rowID=1))', f"?readConsistency={level}", want=200)
                q(i, 'Bitmap(frame="f", rowID=2)', f"?readConsistency={level}", want=200)
        # A forced divergence on node 0 of each cluster, then one full
        # anti-entropy sweep on every node.
        owned = next(sl for sl in range(_SBS_SLICES)
                     if sides[0].nodes[0].cluster.owns_fragment(sides[0].hosts[0], "i", sl))
        for side in sides:
            frag = side.nodes[0].holder.fragment("i", "f", "standard", owned)
            frag.set_bit(7, owned * SLICE_WIDTH + 4242)
            for r, c in sorted(bits):
                if c // SLICE_WIDTH == owned:
                    frag.clear_bit(r, c)
                    break
        for side in sides:
            side.tick_full_anti_entropy()
        for level in levels:
            for i in range(3):
                q(i, 'Count(Bitmap(frame="f", rowID=7))', f"?readConsistency={level}", want=200)
                q(i, 'Count(Bitmap(frame="f", rowID=1))', f"?readConsistency={level}", want=200)
        # Drain node 2, then grow back to three.
        for hosts_of in (lambda side: side.hosts[:2], lambda side: side.hosts):
            for side in sides:
                st, _ = side.request(0, "POST", "/cluster/resize",
                                     json.dumps({"hosts": hosts_of(side)}).encode())
                assert st == 200
                _until(lambda side=side: not json.loads(
                    side.request(0, "GET", "/debug/rebalance")[1]).get("running"),
                    what="the resize")
            for i in range(2):
                q(i, 'Count(Bitmap(frame="f", rowID=1))', "?readConsistency=all", want=200)
                q(i, 'Bitmap(frame="f", rowID=2)', want=200)
        for i in range(3):
            q(i, 'Bitmap(frame="f", rowID=1)', "?readConsistency=all", want=200)
        assert sides[1].checksums() == sides[0].checksums()
        shapes = [_shape(json.loads(side.request(0, "GET", "/debug/rebalance")[1]))
                  for side in sides]
        assert shapes[1] == shapes[0]
    finally:
        for side in sides:
            side.close()
