"""The JAX package's rebalancing suite, run against the port.

``tests/test_rebalance.py``'s classes with their assertions unchanged:
versioned topology epochs and transitions (``cluster/topology.py``), the
migration planner and the delta log (``rebalance/``), and live resizes
over real HTTP port nodes on the CPU (``Server(device="cpu")``): grow
2->3 under a concurrent reader and writer, grow with the mesh data plane
(eight CPU members, ``bitplane.set_local_members``), drain 3->2, a
coordinator killed mid-copy and resumed, and an abort that reverses
flipped slices.  Only the harness differs: the port's ``Server`` takes a
configured ring as ``hosts=`` (a node outside it joins), peers that
bound port 0 meet through ``add_peer``, and the port's placement names a
slice's home member by index where the JAX test names its device (eight
CPU members are one device name).
"""

from __future__ import annotations

import json
import threading
import time

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.cluster.topology import (  # noqa: E402
    Cluster,
    MixedEpochError,
    TopologyError,
    new_cluster,
)
from pilosa_tpu_torch.net.client import ClientError, InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.rebalance.deltalog import DeltaLog  # noqa: E402
from pilosa_tpu_torch.rebalance.plan import compute_plan  # noqa: E402


# ---------------------------------------------------------------------------
# versioned topology epochs
# ---------------------------------------------------------------------------


class TestTopologyEpochs:
    def test_add_node_bumps_epoch(self):
        c = Cluster()
        e0 = c.epoch
        c.add_node("a:1")
        assert c.epoch == e0 + 1
        # idempotent re-add does not bump
        c.add_node("a:1")
        assert c.epoch == e0 + 1

    def test_add_node_rejected_during_transition(self):
        c = new_cluster(2)
        c.begin_transition(["host0:0", "host1:0", "host2:0"])
        with pytest.raises(TopologyError):
            c.add_node("host3:0")

    def test_reads_route_old_ring_until_flip(self):
        c = new_cluster(2)
        t = c.begin_transition(["host0:0", "host1:0", "host2:0"])
        moved = [
            s
            for s in range(16)
            if {n.host for n in c.new_ring_nodes("i", s)}
            != {n.host for n in c.partition_nodes(c.partition("i", s))}
        ]
        assert moved, "grow must move some slices"
        s = moved[0]
        before = [n.host for n in c.fragment_nodes("i", s)]
        assert "host2:0" not in before
        # writes already dual-target both rings
        assert {n.host for n in c.write_nodes("i", s)} >= set(before)
        assert c.flip_slice("i", s, t.epoch)
        after = [n.host for n in c.fragment_nodes("i", s)]
        assert after == [n.host for n in c.new_ring_nodes("i", s)]

    def test_commit_swaps_ring_and_bumps_epoch(self):
        c = new_cluster(2)
        t = c.begin_transition(["host0:0", "host1:0", "host2:0"])
        e = c.epoch
        c.commit_transition(t.epoch)
        assert c.hosts() == ["host0:0", "host1:0", "host2:0"]
        assert c.epoch > e
        assert c.transition is None

    def test_abort_refused_with_flipped_slices(self):
        c = new_cluster(2)
        t = c.begin_transition(["host0:0", "host1:0", "host2:0"])
        c.flip_slice("i", 0, t.epoch)
        with pytest.raises(TopologyError):
            c.abort_transition(t.epoch)
        c.unflip_slice("i", 0, t.epoch)
        c.abort_transition(t.epoch)
        assert c.transition is None
        assert c.hosts() == ["host0:0", "host1:0"]

    def test_snapshot_restore_roundtrip(self):
        c = new_cluster(2)
        t = c.begin_transition(["host0:0", "host1:0", "host2:0"])
        c.flip_slice("i", 3, t.epoch)
        snap = c.transition_snapshot()
        c2 = new_cluster(2)
        c2.restore_transition(snap)
        assert c2.transition_snapshot() == snap
        assert [n.host for n in c2.fragment_nodes("i", 3)] == [
            n.host for n in c.fragment_nodes("i", 3)
        ]

    def test_mixed_epoch_route_fails_loudly(self):
        from pilosa_tpu_torch.core.holder import Holder
        from pilosa_tpu_torch.exec.executor import Executor

        c = new_cluster(2)
        ex = Executor(Holder("/tmp/_nope", device="cpu"), host="host0:0", cluster=c)
        epoch0 = c.epoch
        ex._slices_by_node(list(c.nodes), "i", [0, 1], epoch=epoch0)  # fine
        c.add_node("host2:0")  # ring mutates mid-query
        with pytest.raises(MixedEpochError):
            ex._slices_by_node(list(c.nodes), "i", [0, 1], epoch=epoch0)

    def test_flip_invalidates_routing_cache(self):
        from pilosa_tpu_torch.core.holder import Holder
        from pilosa_tpu_torch.exec.executor import Executor

        c = new_cluster(2)
        t = c.begin_transition(["host0:0", "host1:0", "host2:0"])
        ex = Executor(Holder("/tmp/_nope", device="cpu"), host="host0:0", cluster=c)
        moved = next(
            s
            for s in range(16)
            if {n.host for n in c.new_ring_nodes("i", s)}
            != {n.host for n in c.fragment_nodes("i", s)}
        )
        m0 = ex._slices_by_node(c.route_nodes(), "i", [moved])
        owner0 = next(iter(m0))
        c.flip_slice("i", moved, t.epoch)
        m1 = ex._slices_by_node(c.route_nodes(), "i", [moved])
        owner1 = next(iter(m1))
        assert owner0 != owner1


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


class TestPlan:
    def test_grow_plan_targets_only_new_host(self):
        c = new_cluster(2)
        c.begin_transition(["host0:0", "host1:0", "host2:0"])
        moves = compute_plan(c, {"i": 31})
        assert moves, "a grow must move slices"
        for m in moves:
            assert m.targets == ("host2:0",)
            assert m.releases == m.sources  # replica_n=1: old owner leaves
        # only slices whose owner set changed appear
        keys = {m.slice for m in moves}
        for s in range(32):
            old = {n.host for n in c.partition_nodes(c.partition("i", s))}
            new = {n.host for n in c.new_ring_nodes("i", s)}
            assert (s in keys) == (old != new)

    def test_drain_plan_is_inverse_of_grow(self):
        c3 = new_cluster(3)
        c3.begin_transition(["host0:0", "host1:0"])
        moves = compute_plan(c3, {"i": 31})
        assert moves
        for m in moves:
            assert m.sources == ("host2:0",) or "host2:0" in m.releases

    def test_no_transition_no_plan(self):
        assert compute_plan(new_cluster(3), {"i": 31}) == []


# ---------------------------------------------------------------------------
# delta log
# ---------------------------------------------------------------------------


class _Frag:
    def __init__(self, index="i", frame="f", view="standard", slice_i=0):
        self.index, self.frame, self.view, self.slice = index, frame, view, slice_i


class TestDeltaLog:
    def test_order_preserved_and_drain_resets(self):
        log = DeltaLog(cap=100)
        log.start("i", 0)
        f = _Frag()
        log.record(f, (1,), (10,), (), ())
        log.record(f, (), (), (1,), (10,))
        entries, overflowed = log.drain("i", 0)
        assert not overflowed
        assert [(e[2], e[4]) for e in entries] == [([1], []), ([], [1])]
        assert log.drain("i", 0) == ([], False)

    def test_inactive_slice_records_nothing(self):
        log = DeltaLog()
        log.record(_Frag(), (1,), (10,), (), ())
        assert log.drain("i", 0) == ([], False)

    def test_overflow_drops_and_flags(self):
        log = DeltaLog(cap=3)
        log.start("i", 0)
        f = _Frag()
        for k in range(5):
            log.record(f, (k,), (k,), (), ())
        entries, overflowed = log.drain("i", 0)
        assert overflowed and entries == []
        # drain resets the flag; logging resumes
        log.record(f, (9,), (9,), (), ())
        entries, overflowed = log.drain("i", 0)
        assert not overflowed and len(entries) == 1

    def test_requeue_preserves_head_order(self):
        log = DeltaLog(cap=100)
        log.start("i", 0)
        f = _Frag()
        log.record(f, (1,), (1,), (), ())
        entries, _ = log.drain("i", 0)
        log.record(f, (2,), (2,), (), ())
        log.requeue("i", 0, entries)
        drained, _ = log.drain("i", 0)
        assert [e[2] for e in drained] == [[1], [2]]

    def test_start_resets_stale_entries(self):
        log = DeltaLog(cap=100)
        log.start("i", 0)
        log.record(_Frag(), (1,), (1,), (), ())
        log.start("i", 0)  # fresh copy window
        assert log.drain("i", 0) == ([], False)


# ---------------------------------------------------------------------------
# end-to-end: live resize over real HTTP nodes
# ---------------------------------------------------------------------------

N_SLICES = 6


def _boot(tmp_path, name, host="127.0.0.1:0", ring=()):
    """One real node.  ``ring``: pre-configured host list — a node NOT
    in it boots as a JOINER (no self-registration)."""
    s = Server(
        str(tmp_path / name),
        host=host,
        hosts=list(ring),
        device="cpu",
        floor_probe=False,
        anti_entropy_interval=3600,
        polling_interval=3600,
        rebalance_release_delay_ms=0.0,
    )
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


def _seed(client, servers, row=1):
    """One bit per slice (deterministic corpus); returns expected count.
    Runs every node's max-slice polling tick afterwards (the fixtures
    disable the periodic loop)."""
    for sl in range(N_SLICES):
        client.execute_query(
            "i", f'SetBit(frame="f", rowID={row}, columnID={sl * SLICE_WIDTH + sl})'
        )
    for s in servers:
        s.tick_max_slices()
    return N_SLICES


def _count(client, row=1, retries=8):
    """Count with retry over the two loud-but-transient windows (the
    mixed-epoch guard at begin/commit, a breaker warming up)."""
    last = None
    for _ in range(retries):
        try:
            return client.execute_pql("i", f'Count(Bitmap(frame="f", rowID={row}))')
        except (ClientError, ConnectionError) as e:
            last = e
            time.sleep(0.1)
    raise last


def _bits(client, row=1, retries=8):
    from pilosa_tpu_torch.net import codec

    last = None
    for _ in range(retries):
        try:
            rb = client.execute_pql("i", f'Bitmap(frame="f", rowID={row})')
            return codec.result_to_json(rb)["bits"]
        except (ClientError, ConnectionError) as e:
            last = e
            time.sleep(0.1)
    raise last


def _debug_rebalance(host):
    client = InternalClient(host, timeout=10.0, device="cpu")
    status, data = client._request("GET", "/debug/rebalance")
    return json.loads(client._check(status, data))


def _resize(host, hosts):
    client = InternalClient(host, timeout=30.0)
    status, data = client._request(
        "POST", "/cluster/resize", body=json.dumps({"hosts": hosts}).encode()
    )
    return json.loads(client._check(status, data))


def _wait_complete(host, timeout=90.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = _debug_rebalance(host)
        if not snap.get("running") and snap.get("transition") is None:
            return snap
        coord = snap.get("coordinator") or {}
        if not snap.get("running") and (coord.get("error") or snap.get("lastError")):
            raise AssertionError(
                f"migration stopped: {coord.get('error') or snap.get('lastError')}"
            )
        time.sleep(0.1)
    raise AssertionError(f"resize did not complete: {_debug_rebalance(host)}")


def _local_fragments(server, index="i"):
    idx = server.holder.index(index)
    if idx is None:
        return []
    return [
        (f.name, v.name, frag.slice)
        for f in idx.frames().values()
        for v in f.views().values()
        for frag in v.fragments()
    ]


@pytest.fixture
def eight_cpu_members():
    """Eight CPU members stand in for the JAX test's eight forced CPU
    devices (the mesh data plane engages on every node)."""
    from pilosa_tpu_torch.ops import bitplane as bp

    bp.set_local_members(["cpu"] * 8)
    try:
        yield
    finally:
        bp.set_local_members(None)


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


class TestResizeE2E:
    def test_grow_2_to_3_under_concurrent_load(self, tmp_path):
        s0 = _boot(tmp_path, "n0")
        s1 = _boot(tmp_path, "n1")
        servers = [s0, s1]
        s2 = None
        stop = threading.Event()
        try:
            hosts2 = sorted([s0.host, s1.host])
            _wire(servers, hosts2)
            _schema(servers)
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            want = _seed(c0, servers)
            assert _count(c0) == want
            baseline_bits = _bits(c0)

            # The joining node: configured with the OLD ring, own host
            # not in it — it must NOT insert itself into placement.
            s2 = _boot(tmp_path, "n2", ring=hosts2)
            assert s2.cluster.node_by_host(s2.host) is None

            # Background load: readers assert byte-identical results on
            # every observation; a writer streams new bits (row 3) the
            # whole time — zero of them may be lost.
            errors: list[str] = []
            written: list[int] = []

            def reader():
                # A WRONG result is an immediate failure; a transient
                # transport error under a loaded CI machine is retried
                # (consecutive-failure bound, not one-strike).
                misses = 0
                while not stop.is_set():
                    try:
                        if _bits(c0) != baseline_bits:
                            errors.append("reader observed wrong bits")
                            return
                        misses = 0
                    except Exception as e:  # noqa: BLE001
                        misses += 1
                        if misses >= 5:
                            errors.append(f"reader: {e}")
                            return
                    time.sleep(0.02)

            def writer():
                cw = InternalClient(s0.host, timeout=10.0, device="cpu")
                k = 0
                while not stop.is_set():
                    col = (k % N_SLICES) * SLICE_WIDTH + 100 + k // N_SLICES
                    # Writes are briefly blocked during migration
                    # critical phases; on a loaded machine those
                    # phases stretch, so the retry budget must be
                    # seconds wide, not the happy-path 0.5 s.
                    give_up = time.monotonic() + 30.0
                    while True:
                        try:
                            cw.execute_query(
                                "i",
                                f'SetBit(frame="f", rowID=3, columnID={col})',
                            )
                            written.append(col)
                            break
                        except (ClientError, ConnectionError):
                            if stop.is_set():
                                # unacked in-flight write at shutdown:
                                # not in the oracle, not an error
                                return
                            if time.monotonic() > give_up:
                                errors.append(f"writer gave up on col {col}")
                                return
                            time.sleep(0.1)
                    k += 1
                    time.sleep(0.01)

            threads = [
                threading.Thread(target=reader, daemon=True),
                threading.Thread(target=writer, daemon=True),
            ]
            for t in threads:
                t.start()
            _until(lambda: written, what="the writer's first write")

            hosts3 = sorted(hosts2 + [s2.host])
            _resize(s0.host, hosts3)
            _wait_complete(s0.host)
            # Let a write land after the commit (and any in flight settle).
            n_done = len(written)
            _until(lambda: len(written) > n_done or errors, what="a write after the commit")
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
            assert not errors, errors

            # Ring committed everywhere.
            for s in [s0, s1, s2]:
                assert s.cluster.hosts() == hosts3, s.host
                assert s.cluster.transition is None

            # Byte-identical results from every coordinator, including
            # the joined node.
            for s in [s0, s1, s2]:
                cc = InternalClient(s.host, timeout=10.0, device="cpu")
                assert _count(cc) == want, s.host
                assert _bits(cc) == baseline_bits, s.host

            # Zero dropped writes: every bit the writer confirmed is
            # countable after the cutover.
            assert written, "writer made no progress during migration"
            expect3 = len(set(written))
            for s in [s0, s1, s2]:
                cc = InternalClient(s.host, timeout=10.0, device="cpu")
                assert _count(cc, row=3) == expect3, s.host

            # The joined node actually owns slices; the sources
            # RELEASED them (fragments gone => HBM/disk returned).
            owned2 = {
                sl
                for sl in range(N_SLICES)
                if s2.cluster.fragment_nodes("i", sl)[0].host == s2.host
            }
            assert owned2, "grow moved no slices to the new node"
            got2 = {sl for (_, _, sl) in _local_fragments(s2)}
            assert owned2 <= got2
            for s in (s0, s1):
                stale = {
                    sl
                    for (_, _, sl) in _local_fragments(s)
                    if sl in owned2
                }
                assert not stale, f"{s.host} kept released slices {stale}"

            # Migration observability surfaced.
            snap = _debug_rebalance(s0.host)
            assert snap["transition"] is None and not snap["running"]
        finally:
            stop.set()
            for s in servers + ([s2] if s2 else []):
                s.close()

    def test_grow_mesh_sharded_slices_land_on_target_shard(self, tmp_path, eight_cpu_members):
        """Rebalance composed with the mesh data plane.  Every
        node runs the >1-device virtual mesh (conftest forces 8 CPU
        devices), so migrated slices must re-materialize on the TARGET
        node's correct mesh shard (slice mod n_devices), with results
        byte-identical across every coordinator and zero lost writes
        from a writer racing the migration."""
        from pilosa_tpu_torch.ops import bitplane as bp
        from pilosa_tpu_torch.parallel import mesh as pmesh

        assert pmesh.default_slices_mesh() is not None, (
            "the mesh data plane must be engaged on every node"
        )
        s0 = _boot(tmp_path, "n0")
        s1 = _boot(tmp_path, "n1")
        servers = [s0, s1]
        s2 = None
        stop = threading.Event()
        try:
            hosts2 = sorted([s0.host, s1.host])
            _wire(servers, hosts2)
            _schema(servers)
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            want = _seed(c0, servers)
            assert _count(c0) == want
            baseline_bits = _bits(c0)

            s2 = _boot(tmp_path, "n2", ring=hosts2)

            errors: list[str] = []
            written: list[int] = []

            def writer():
                cw = InternalClient(s0.host, timeout=10.0, device="cpu")
                k = 0
                while not stop.is_set():
                    col = (k % N_SLICES) * SLICE_WIDTH + 200 + k // N_SLICES
                    give_up = time.monotonic() + 30.0
                    while True:
                        try:
                            cw.execute_query(
                                "i",
                                f'SetBit(frame="f", rowID=5, columnID={col})',
                            )
                            written.append(col)
                            break
                        except (ClientError, ConnectionError):
                            if stop.is_set():
                                return
                            if time.monotonic() > give_up:
                                errors.append(f"writer gave up on col {col}")
                                return
                            time.sleep(0.1)
                    k += 1
                    time.sleep(0.01)

            t = threading.Thread(target=writer, daemon=True)
            t.start()
            _until(lambda: written, what="the writer's first write")

            hosts3 = sorted(hosts2 + [s2.host])
            _resize(s0.host, hosts3)
            _wait_complete(s0.host)
            n_done = len(written)
            _until(lambda: len(written) > n_done or errors, what="a write after the commit")
            stop.set()
            t.join(timeout=10.0)
            assert not errors, errors

            # Byte-identical results through every coordinator —
            # including the joined node, whose local map leg runs the
            # mesh-sharded batch path over its migrated slices.
            for s in [s0, s1, s2]:
                cc = InternalClient(s.host, timeout=10.0, device="cpu")
                assert _count(cc) == want, s.host
                assert _bits(cc) == baseline_bits, s.host
            assert written, "writer made no progress during migration"
            expect5 = len(set(written))
            for s in [s0, s1, s2]:
                cc = InternalClient(s.host, timeout=10.0, device="cpu")
                assert _count(cc, row=5) == expect5, s.host

            # Migrated slices landed on the target — and their restored
            # HBM mirrors sit on the slice's OWNING mesh shard (the
            # ?stage=true restore lane hands them to the prefetcher,
            # which places via home_device).
            owned2 = {
                sl
                for sl in range(N_SLICES)
                if s2.cluster.fragment_nodes("i", sl)[0].host == s2.host
            }
            assert owned2, "grow moved no slices to the new node"
            view = s2.holder.index("i").frame("f").view("standard")
            for sl in owned2:
                frag = view.fragment(sl)
                assert frag is not None, f"slice {sl} missing on target"
                # The restore lane stages asynchronously; a direct
                # device_plane() is placement-deterministic either way.
                mirror = frag.device_plane()
                dev = mirror.device
                assert dev == bp.home_device(sl, s2.holder.placed), (
                    f"slice {sl} on {dev}, owning shard "
                    f"{bp.home_device(sl, s2.holder.placed)}"
                )
            # Zero lost writes is already asserted via expect5 above;
            # finally, the target's shard spread is real (mesh engaged,
            # not everything on device 0) whenever it owns >1 slice
            # with distinct home shards.
            homes = {bp.home_member(sl, bp.mesh_device_count()) for sl in owned2}
            assert len(homes) == len(
                {sl % bp.mesh_device_count() for sl in owned2}
            )
        finally:
            stop.set()
            for s in servers + ([s2] if s2 else []):
                s.close()

    def test_drain_3_to_2_releases_and_preserves_results(self, tmp_path):
        servers = [_boot(tmp_path, f"n{i}") for i in range(3)]
        try:
            hosts3 = sorted(s.host for s in servers)
            _wire(servers, hosts3)
            _schema(servers)
            c0 = InternalClient(servers[0].host, timeout=10.0, device="cpu")
            want = _seed(c0, servers)
            baseline = _bits(c0)

            victim = max(servers, key=lambda s: s.host)
            keep = sorted(h for h in hosts3 if h != victim.host)
            coord = next(s for s in servers if s.host == keep[0])
            _resize(coord.host, keep)
            _wait_complete(coord.host)

            for s in servers:
                assert s.cluster.hosts() == keep, s.host
            for h in keep:
                cc = InternalClient(h, timeout=10.0, device="cpu")
                assert _count(cc) == want
                assert _bits(cc) == baseline
            # The drained node holds NOTHING afterwards.
            assert _local_fragments(victim) == []
        finally:
            for s in servers:
                s.close()

    def test_kill_coordinator_mid_copy_then_resume(self, tmp_path):
        s0 = _boot(tmp_path, "n0")
        s1 = _boot(tmp_path, "n1")
        s2 = None
        try:
            hosts2 = sorted([s0.host, s1.host])
            _wire([s0, s1], hosts2)
            _schema([s0, s1])
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            want = _seed(c0, [s0, s1])
            baseline = _bits(c0)

            s2 = _boot(tmp_path, "n2", ring=hosts2)
            hosts3 = sorted(hosts2 + [s2.host])

            # Slow the coordinator down so the kill lands mid-plan.
            s0.rebalance.step_delay_s = 0.5
            _resize(s0.host, hosts3)
            deadline = time.time() + 60
            while time.time() < deadline:
                snap = _debug_rebalance(s0.host)
                done = (snap.get("coordinator") or {}).get("sliceStates", {}).get(
                    "done", 0
                )
                if done >= 1:
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("no slice completed before kill")

            # KILL the coordinator mid-migration.
            s0_host, s0_dir = s0.host, s0.data_dir
            s0.close()

            # Both rings remain valid on the surviving peers: a flipped
            # slice answers from its NEW owner.
            peer_snap = _debug_rebalance(s1.host)
            assert peer_snap["transition"] is not None
            moved = peer_snap["transition"]["moved"]
            assert moved, "peer lost the flipped-slice set"
            # A grow can also move slices between EXISTING nodes; probe
            # a flipped slice whose NEW owner survived the kill.
            probe = None
            for idx_name, moved_slice in moved:
                owner = s1.cluster.fragment_nodes(idx_name, int(moved_slice))[0]
                if owner.host != s0_host:
                    probe = (idx_name, int(moved_slice))
                    break
            if probe is not None:
                c1 = InternalClient(s1.host, timeout=10.0, device="cpu")
                got = c1.execute_query(
                    probe[0],
                    'Count(Bitmap(frame="f", rowID=1))',
                    slices=[probe[1]],
                )
                assert got[0] == 1  # the seeded bit of that slice

            # RESTART the coordinator on its old identity: the
            # persisted transition restores at boot...
            s0 = _boot(tmp_path, "n0", host=s0_host, ring=hosts2)
            assert s0.data_dir == s0_dir
            assert s0.cluster.transition is not None
            done_before = len(
                (
                    (self_state := _debug_rebalance(s0.host)).get("coordinator")
                    or {}
                ).get("slices", {})
            )
            assert done_before >= 1, self_state

            # ...and a re-issued resize picks up from the per-slice
            # migration state and completes.
            _resize(s0.host, hosts3)
            _wait_complete(s0.host)

            for s in [s0, s1, s2]:
                assert s.cluster.hosts() == hosts3
                cc = InternalClient(s.host, timeout=10.0, device="cpu")
                assert _count(cc) == want
                assert _bits(cc) == baseline
        finally:
            for s in (s0, s1, s2):
                if s is not None:
                    s.close()

    def test_abort_reverses_flipped_slices(self, tmp_path):
        s0 = _boot(tmp_path, "n0")
        s1 = _boot(tmp_path, "n1")
        s2 = None
        try:
            hosts2 = sorted([s0.host, s1.host])
            _wire([s0, s1], hosts2)
            _schema([s0, s1])
            c0 = InternalClient(s0.host, timeout=10.0, device="cpu")
            want = _seed(c0, [s0, s1])
            baseline = _bits(c0)

            s2 = _boot(tmp_path, "n2", ring=hosts2)
            hosts3 = sorted(hosts2 + [s2.host])
            s0.rebalance.step_delay_s = 5.0  # pause after each slice
            _resize(s0.host, hosts3)
            deadline = time.time() + 60
            while time.time() < deadline:
                snap = _debug_rebalance(s0.host)
                if (snap.get("coordinator") or {}).get("sliceStates", {}).get(
                    "done", 0
                ) >= 1:
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("no slice completed before abort")

            client = InternalClient(s0.host, timeout=120.0)
            status, data = client._request("POST", "/cluster/resize/abort")
            client._check(status, data)

            # Old ring restored everywhere, results intact, the
            # would-be joiner holds nothing.
            for s in [s0, s1, s2]:
                assert s.cluster.transition is None, s.host
            assert s0.cluster.hosts() == hosts2
            assert s1.cluster.hosts() == hosts2
            for s in (s0, s1):
                cc = InternalClient(s.host, timeout=10.0, device="cpu")
                assert _count(cc) == want
                assert _bits(cc) == baseline
            assert _local_fragments(s2) == []
        finally:
            for s in (s0, s1, s2):
                if s is not None:
                    s.close()
