"""Gossip membership (``pilosa_tpu_torch/cluster/gossip.py``), with the
JAX package's gossip cases run against the port: ``tests/test_cli.py``'s
``TestGossip``, ``TestGossipCluster``, ``TestGossipStreamFallback`` and
``/state`` case, ``tests/test_churn.py``, the hot-slice piggyback of
``tests/test_cold_restart.py`` and ``tests/test_net.py``'s
``TestGossipCluster``.  Only the harness differs: a port node is
``Server(cluster_type="gossip", device="cpu", gossip_bind=...,
gossip_seed=...)`` with its ring as ``hosts=``, where the JAX test wires a
``GossipNodeSet`` into a ``Cluster`` by hand; user messages are the
port's hand-written wire messages; and every wait polls with a deadline.

Then the cross-package checks: a JAX and a port ``GossipNodeSet`` in one
membership exchange user messages and state blobs both ways, and a mixed
JAX-and-port gossip cluster replicates a schema and answers a Count the
same from every node."""

from __future__ import annotations

import socket
import time

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.cluster import gossip as gmod  # noqa: E402
from pilosa_tpu_torch.cluster.gossip import GossipNodeSet  # noqa: E402
from pilosa_tpu_torch.net import wire  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.obs.stats import ExpvarStatsClient  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402
from pilosa_tpu_torch.testing import faults  # noqa: E402


def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _free_tcp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_for(pred, timeout=5.0, every=0.02) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(every)
    return pred()


class _Recorder:
    def __init__(self):
        self.received = []

    def receive_message(self, msg):
        self.received.append(msg)


def _pair(interval=0.05, suspect=1.0, **kw_b):
    a = GossipNodeSet(host="127.0.0.1:1", gossip_interval=interval, suspect_after=suspect)
    a.bind = ("127.0.0.1", _free_udp_port())
    b = GossipNodeSet(host="127.0.0.1:2", seed=f"{a.bind[0]}:{a.bind[1]}",
                      gossip_interval=interval, suspect_after=suspect, **kw_b)
    b.bind = ("127.0.0.1", _free_udp_port())
    return a, b


def _joined(a, b) -> bool:
    return b.host in a.nodes() and a.host in b.nodes()


# ---------------------------------------------------------------------------
# tests/test_cli.py TestGossip
# ---------------------------------------------------------------------------


class TestGossip:
    def test_membership_and_user_messages(self):
        ha, hb = _Recorder(), _Recorder()
        a, b = _pair()
        a.start(ha)
        a.open()
        b.start(hb)
        b.open()
        try:
            assert wait_for(lambda: _joined(a, b))
            # user message broadcast reaches the peer's handler
            a.send_sync(wire.DeleteIndexMessage(Index="y"))
            assert wait_for(lambda: hb.received, 3.0)
            assert hb.received[0].Index == "y"
        finally:
            a.close()
            b.close()

    def test_send_sync_survives_dropped_datagram(self):
        """send_sync is reliable over lossy UDP: the first USER datagram
        is dropped and the ack-and-retry loop still delivers it, once."""
        hb = _Recorder()
        a, b = _pair(suspect=5.0)
        a.start(_Recorder())
        a.open()
        b.start(hb)
        b.open()
        dropped = []
        orig_send = a._send

        def lossy_send(addr, obj):
            if obj.get("t") == "user" and not dropped:
                dropped.append(obj)  # swallow the first USER datagram
                return
            orig_send(addr, obj)

        a._send = lossy_send
        try:
            assert wait_for(lambda: _joined(a, b))
            a.send_sync(wire.DeleteIndexMessage(Index="y"))
            assert dropped, "drop injection never triggered"
            assert len(hb.received) == 1 and hb.received[0].Index == "y"
        finally:
            a.close()
            b.close()

    def test_large_state_sync_chunked(self):
        """A state blob far beyond one datagram converges through
        STATE-REQ/STATE-CHUNK."""
        blob = bytes(range(256)) * 600  # 150 KB, deterministic
        merged = []
        a = GossipNodeSet(host="127.0.0.1:1", gossip_interval=0.05, suspect_after=5.0,
                          state_provider=lambda: blob)
        a.bind = ("127.0.0.1", _free_udp_port())
        a.open()
        b = GossipNodeSet(host="127.0.0.1:2", seed=f"{a.bind[0]}:{a.bind[1]}",
                          gossip_interval=0.05, suspect_after=5.0, state_merger=merged.append)
        b.bind = ("127.0.0.1", _free_udp_port())
        b.open()
        try:
            assert wait_for(lambda: merged, 10.0)
            assert merged[0] == blob
            assert "127.0.0.1:1" in b.nodes()
        finally:
            a.close()
            b.close()

    def test_send_failure_is_logged(self):
        logs = []
        a = GossipNodeSet(host="127.0.0.1:1", gossip_interval=0.05, suspect_after=5.0,
                          logger=logs.append)
        a.bind = ("127.0.0.1", _free_udp_port())
        a.open()

        def broken_send(addr, obj):
            raise OSError("Message too long")

        a._send = broken_send
        a._register("127.0.0.1:9", ("127.0.0.1", _free_udp_port()))  # a peer to ping
        try:
            assert wait_for(lambda: any("failed" in e and "Message too long" in e for e in logs)), logs
        finally:
            a.close()

    def test_down_detection(self):
        a, b = _pair(suspect=0.3)
        a.open()
        b.open()
        try:
            assert wait_for(lambda: "127.0.0.1:2" in a.nodes())
            b.close()
            assert wait_for(lambda: a.member_states().get("127.0.0.1:2") == "DOWN", every=0.05)
        finally:
            a.close()

    def _three(self, suspect):
        nodes = []
        for i in range(3):
            n = GossipNodeSet(host=f"127.0.0.1:{i + 1}", gossip_interval=0.05, suspect_after=suspect)
            n.bind = ("127.0.0.1", _free_udp_port())
            if nodes:
                n.seed = f"{nodes[0].bind[0]}:{nodes[0].bind[1]}"
            nodes.append(n)
        for n in nodes:
            n.open()
        assert wait_for(lambda: all(len(n.nodes()) == 3 for n in nodes))
        return nodes

    def test_asymmetric_partition_no_false_down(self):
        """SWIM: with A<->B cut while both reach C, neither marks the
        other DOWN (indirect confirmation through C)."""
        nodes = self._three(0.4)
        a, b, c = nodes
        try:
            def drop_to(node, blocked_addr):
                orig = node._send

                def filtered(addr, obj):
                    if tuple(addr) == tuple(blocked_addr):
                        return
                    orig(addr, obj)

                node._send = filtered

            drop_to(a, b.bind)
            drop_to(b, a.bind)
            end = time.monotonic() + 5 * 0.4 + 1.0
            while time.monotonic() < end:  # observe > 5 suspect windows
                assert a.member_states().get(b.host) != "DOWN", "A declared B DOWN"
                assert b.member_states().get(a.host) != "DOWN", "B declared A DOWN"
                assert c.member_states().get(a.host) != "DOWN"
                assert c.member_states().get(b.host) != "DOWN"
                time.sleep(0.05)
            assert len(a.nodes()) == 3 and len(b.nodes()) == 3 and len(c.nodes()) == 3
        finally:
            for n in nodes:
                n.close()

    def test_ping_req_relay_legs(self):
        """With vouching off at A and A<->B cut, only ping-req -> relay
        ping -> ack -> ind-ack can refresh B at A."""
        nodes = self._three(0.4)
        a, b, c = nodes
        try:
            a._merge_members = lambda members: None
            orig_send = a._send
            ping_reqs = []

            def filtered(addr, obj):
                if obj.get("t") == "ping-req" and obj.get("target") == b.host:
                    ping_reqs.append(obj)
                if tuple(addr) == tuple(b.bind):
                    return
                orig_send(addr, obj)

            a._send = filtered
            orig_b = b._send

            def filtered_b(addr, obj):
                if tuple(addr) == tuple(a.bind):
                    return
                orig_b(addr, obj)

            b._send = filtered_b
            end = time.monotonic() + 5 * 0.4 + 2.0
            while time.monotonic() < end:
                assert a.member_states().get(b.host) != "DOWN", "relay failed: B declared DOWN"
                time.sleep(0.02)
            assert ping_reqs, "A never issued an indirect probe for B"
            assert a.member_states().get(b.host) in ("UP", "SUSPECT")
        finally:
            for n in nodes:
                n.close()

    def test_send_sync_reaches_suspect_member(self):
        """A SUSPECT member is still live: send_sync delivers to it."""
        hb = _Recorder()
        stats = ExpvarStatsClient()
        a, b = _pair(suspect=5.0)
        a.stats = stats
        a.start(_Recorder())
        a.open()
        b.start(hb)
        b.open()
        try:
            assert wait_for(lambda: "127.0.0.1:2" in a.nodes()), "join timed out"
            # Quiesce the traffic so that nothing flips the forced state
            # back to UP before send_sync reads it: wait until A receives
            # nothing for a few former intervals.
            a.gossip_interval = b.gossip_interval = 60.0
            seen = [-1]

            def quiet():
                n = stats.snapshot()["counts"].get("gossip.recv", 0)
                same = n == seen[0]
                seen[0] = n
                return same

            assert wait_for(quiet, 5.0, every=0.15)
            with a._mu:
                a._members["127.0.0.1:2"]["state"] = "SUSPECT"
            a.send_sync(wire.DeleteIndexMessage(Index="x"))
            assert hb.received and hb.received[-1].Index == "x"
            with a._mu:
                state = a._members["127.0.0.1:2"]["state"]
            assert state == "SUSPECT", "state flipped mid-test; not exercised"
        finally:
            a.close()
            b.close()

    def test_bind_to_port_zero_advertises_the_bound_port(self):
        a = GossipNodeSet(host="127.0.0.1:1", bind="127.0.0.1:0", gossip_interval=0.05)
        a.open()
        try:
            assert a.bind[1] != 0 and a.advertise == ("127.0.0.1", a.bind[1])
        finally:
            a.close()


# ---------------------------------------------------------------------------
# tests/test_cli.py TestGossipStreamFallback and the /state route
# ---------------------------------------------------------------------------


class TestGossipStreamFallback:
    def test_large_blob_streams_instead_of_chunking(self):
        blob = bytes(range(256)) * 1200  # 300 KB > STREAM_STATE_CHUNKS
        merged, fetched_from, reqs = [], [], []
        a = GossipNodeSet(host="127.0.0.1:1", gossip_interval=0.05, suspect_after=5.0,
                          state_provider=lambda: blob)
        a.bind = ("127.0.0.1", _free_udp_port())
        real_serve = a._serve_state_req
        a._serve_state_req = lambda addr: (reqs.append(1), real_serve(addr))
        a.open()
        b = GossipNodeSet(host="127.0.0.1:2", seed=f"{a.bind[0]}:{a.bind[1]}",
                          gossip_interval=0.05, suspect_after=5.0, state_merger=merged.append,
                          state_fetcher=lambda host: (fetched_from.append(host), blob)[1])
        b.bind = ("127.0.0.1", _free_udp_port())
        b.open()
        try:
            assert wait_for(lambda: merged, 10.0)
            assert merged[0] == blob
            assert fetched_from and fetched_from[0] == "127.0.0.1:1"
            assert reqs == []  # no UDP chunk transfer even started
        finally:
            a.close()
            b.close()

    def test_stalled_udp_transfer_flips_to_stream(self, monkeypatch):
        monkeypatch.setattr(gmod, "_ASSEMBLY_TTL", 0.4)
        blob = bytes(range(256)) * 300  # 75 KB: above inline, below stream
        merged, fetched = [], []
        a = GossipNodeSet(host="127.0.0.1:1", gossip_interval=0.05, suspect_after=30.0,
                          state_provider=lambda: blob)
        a.bind = ("127.0.0.1", _free_udp_port())
        real_send = a._send
        chunk_sends = []

        def lossy_send(addr, obj):
            if obj.get("t") == "state-chunk":
                chunk_sends.append(1)
                if obj.get("seq", 0) > 0:
                    return
            real_send(addr, obj)

        a._send = lossy_send
        a.open()
        b = GossipNodeSet(host="127.0.0.1:2", seed=f"{a.bind[0]}:{a.bind[1]}",
                          gossip_interval=0.05, suspect_after=30.0, state_merger=merged.append,
                          state_fetcher=lambda host: (fetched.append(host), blob)[1])
        b.bind = ("127.0.0.1", _free_udp_port())
        b.open()
        try:
            assert wait_for(lambda: merged, 15.0)
            assert merged[0] == blob
            assert fetched, "stream fallback never engaged"
            assert len(chunk_sends) <= 4 * len(blob) // (32 * 1024) + 8
        finally:
            a.close()
            b.close()

    def test_failed_stream_falls_back_to_udp_chunks(self):
        blob = bytes(range(256)) * 1200  # 300 KB: size-triggered stream
        merged, attempts = [], []

        def broken_fetch(host):
            attempts.append(host)
            raise OSError("connection refused")

        a = GossipNodeSet(host="127.0.0.1:1", gossip_interval=0.05, suspect_after=30.0,
                          state_provider=lambda: blob)
        a.bind = ("127.0.0.1", _free_udp_port())
        a.open()
        b = GossipNodeSet(host="127.0.0.1:2", seed=f"{a.bind[0]}:{a.bind[1]}",
                          gossip_interval=0.05, suspect_after=30.0, state_merger=merged.append,
                          state_fetcher=broken_fetch)
        b.bind = ("127.0.0.1", _free_udp_port())
        b.open()
        try:
            assert wait_for(lambda: merged, 15.0), "UDP fallback never converged"
            assert merged[0] == blob
            assert len(attempts) >= 2  # the streams were tried first
        finally:
            a.close()
            b.close()


def test_state_endpoint_serves_node_status(tmp_path):
    """GET /state answers the NodeStatus blob the stream fallback pulls;
    the generated JAX message parses it."""
    import urllib.request

    from pilosa_tpu.net import wire_pb2 as jwire

    s = Server(str(tmp_path / "d"), device="cpu", floor_probe=False,
               anti_entropy_interval=3600, polling_interval=3600)
    s.open()
    try:
        s.holder.create_index_if_not_exists("i")
        s.holder.index("i").create_frame_if_not_exists("f", cache_size=500)
        with urllib.request.urlopen(f"http://{s.host}/state", timeout=10) as r:
            blob = r.read()
        st = jwire.NodeStatus()
        st.ParseFromString(blob)
        assert st.Host == s.host
        assert [i.Name for i in st.Indexes] == ["i"]
        assert st.Indexes[0].Frames[0].Meta.CacheSize == 500
        assert st.SerializeToString() == blob  # byte for byte the generated encoding
        assert wire.NodeStatus.decode(blob).Indexes[0].Frames[0].Name == "f"
    finally:
        s.close()


# ---------------------------------------------------------------------------
# tests/test_cold_restart.py TestGossipHotPiggyback
# ---------------------------------------------------------------------------


class TestGossipHotPiggyback:
    def test_hot_field_and_merge_roundtrip(self):
        a = GossipNodeSet(host="127.0.0.1:1", bind="127.0.0.1:0",
                          hot_provider=lambda: {"i": [4, 1], "j": [0]})
        b = GossipNodeSet(host="127.0.0.1:2", bind="127.0.0.1:0")
        field = a._hot_field()
        assert field == {"hot": {"i": [4, 1], "j": [0]}}
        b._merge_hot("127.0.0.1:1", field)
        assert b.remote_hot_slices() == {"i": [4, 1], "j": [0]}

    def test_merge_hot_ignores_garbage(self):
        b = GossipNodeSet(host="127.0.0.1:2", bind="127.0.0.1:0")
        b._merge_hot("peer", {"hot": "nope"})
        b._merge_hot("peer", {"hot": {"i": ["x", 3, None]}})
        assert b.remote_hot_slices() == {"i": [3]}

    def test_hot_announcements_expire(self, monkeypatch):
        b = GossipNodeSet(host="127.0.0.1:2", bind="127.0.0.1:0")
        b._merge_hot("peer", {"hot": {"i": [1]}})
        assert b.remote_hot_slices() == {"i": [1]}
        monkeypatch.setattr(gmod, "HOT_TTL_S", -1.0)
        assert b.remote_hot_slices() == {}

    def test_holder_hot_slices_reads_pool_mru(self, tmp_path):
        from pilosa_tpu_torch.core.holder import Holder

        holder = Holder(str(tmp_path / "h"), device="cpu")
        holder.open()
        fr = holder.create_index("gossiphot").create_frame("f")
        for s in range(10):
            fr.set_bit("standard", 1, s * SLICE_WIDTH + 3)
        frags = {f.slice: f for f in fr.view("standard").fragments()}
        frags[2].device_plane()
        frags[8].device_plane()
        assert holder.hot_slices(limit=2) == {"gossiphot": [8, 2]}  # MRU first
        holder.close()


# ---------------------------------------------------------------------------
# tests/test_churn.py
# ---------------------------------------------------------------------------


N_NODES = 8
LOSS = 0.20  # seeded per rule, deterministic
INTERVAL = 0.05
SUSPECT = 0.6


def _mk(i: int, port: int, seed_addr: str = "") -> GossipNodeSet:
    ns = GossipNodeSet(host=f"127.0.0.1:{9000 + i}", seed=seed_addr,  # identity, never dialed
                       gossip_interval=INTERVAL, suspect_after=SUSPECT)
    ns.bind = ("127.0.0.1", port)
    ns.advertise = ("127.0.0.1", port)
    return ns


def _live_view_converged(nodes: dict) -> bool:
    want = set(nodes)
    return all(set(ns.nodes()) == want for ns in nodes.values())


def test_churn_converges_without_false_down_storm():
    faults.install(f"gossip.send:prob={LOSS},seed=42,mode=drop")
    ports = {i: _free_udp_port() for i in range(N_NODES)}
    nodes: dict[str, GossipNodeSet] = {}
    try:
        seed_addr = ""
        for i in range(N_NODES):
            ns = _mk(i, ports[i], seed_addr)
            ns.open()
            if not seed_addr:
                seed_addr = f"127.0.0.1:{ports[i]}"
            nodes[ns.host] = ns
        # Lossy but stable: full membership converges and no live member
        # is ever confirmed DOWN.
        assert wait_for(lambda: _live_view_converged(nodes), 20.0, 0.1), {
            h: ns.nodes() for h, ns in nodes.items()}
        t_end = time.monotonic() + 4 * SUSPECT
        while time.monotonic() < t_end:
            for h, ns in nodes.items():
                downs = [m for m, st in ns.member_states().items() if st == "DOWN" and m in nodes]
                assert not downs, f"false-DOWN storm: {h} marked live members {downs} DOWN"
            time.sleep(0.1)
        # Flap: two members die; the survivors confirm them DOWN.
        flapped = sorted(nodes)[-2:]
        flap_ports = {}
        for h in flapped:
            ns = nodes.pop(h)
            flap_ports[h] = ns.bind[1]
            ns.close()
        assert wait_for(lambda: _live_view_converged(nodes), 20.0, 0.1), {
            h: ns.nodes() for h, ns in nodes.items()}
        # Rejoin on the same identities: membership heals.
        for h in flapped:
            i = int(h.rsplit(":", 1)[1]) - 9000
            ns = _mk(i, flap_ports[h], seed_addr)
            ns.open()
            nodes[h] = ns
        assert wait_for(lambda: _live_view_converged(nodes), 20.0, 0.1), {
            h: ns.nodes() for h, ns in nodes.items()}
        # The check point fired: datagrams were dropped.
        assert any(r.snapshot()["hits"] for r in faults.active().rules)
    finally:
        faults.reset()
        for ns in nodes.values():
            ns.close()


# ---------------------------------------------------------------------------
# gossip clusters of port servers (tests/test_net.py, tests/test_cli.py)
# ---------------------------------------------------------------------------


def gossip_server(tmp_path, name, host, hosts, gport, seed="", suspect=5.0, **kw) -> Server:
    return Server(str(tmp_path / name), host=host, device="cpu", floor_probe=False,
                  cluster_type="gossip", hosts=hosts, gossip_bind=f"127.0.0.1:{gport}",
                  gossip_seed=seed, gossip_interval=0.05, gossip_suspect_after=suspect,
                  anti_entropy_interval=3600, polling_interval=3600, **kw)


class TestGossipCluster:
    def test_three_nodes_discover_replicate_and_answer(self, tmp_path):
        hosts = sorted(f"127.0.0.1:{_free_tcp_port()}" for _ in range(3))
        gports = [_free_udp_port() for _ in range(3)]
        servers = []
        try:
            # Boot the first two; the third joins late.
            for i in range(2):
                seed = "" if i == 0 else f"127.0.0.1:{gports[0]}"
                s = gossip_server(tmp_path, f"n{i}", hosts[i], hosts, gports[i], seed)
                s.open()
                servers.append(s)
            c0 = InternalClient(servers[0].host, timeout=10.0, device="cpu")
            c0.create_index("i")
            c0.create_frame("i", "f")
            # Schema reaches node 1 through gossip state sync alone.
            assert wait_for(lambda: servers[1].holder.frame("i", "f") is not None, 10.0, 0.05)
            s2 = gossip_server(tmp_path, "n2", hosts[2], hosts, gports[2], f"127.0.0.1:{gports[0]}")
            s2.open()
            servers.append(s2)
            assert wait_for(lambda: s2.holder.frame("i", "f") is not None
                            and len(servers[0].node_set.nodes()) == 3, 10.0, 0.05), \
                "late joiner never synced schema"
            assert sorted(servers[0].node_set.nodes()) == hosts
            cols = [s * SLICE_WIDTH + s for s in range(6)]
            for col in cols:
                c0.execute_query("i", f'SetBit(frame="f", rowID=1, columnID={col})')
            assert wait_for(lambda: all(s.holder.index("i").max_slice() >= 5 for s in servers),
                            10.0, 0.05)
            for s in servers:
                client = InternalClient(s.host, timeout=10.0, device="cpu")
                (n,) = client.execute_query("i", 'Count(Bitmap(rowID=1, frame="f"))')
                assert int(n) == len(cols), f"count from {s.host}"
        finally:
            for s in servers:
                s.close()

    def test_four_node_gossip_cluster(self, tmp_path):
        n = 4
        gports = [_free_udp_port() for _ in range(n)]
        hosts = [f"127.0.0.1:{_free_tcp_port()}" for _ in range(n)]
        servers = [gossip_server(tmp_path, f"g{i}", hosts[i], sorted(hosts), gports[i],
                                 "" if i == 0 else f"127.0.0.1:{gports[0]}") for i in range(n)]
        try:
            for s in servers:
                s.open()
            assert wait_for(lambda: all(len(s.node_set.nodes()) == n for s in servers), 10.0, 0.05), \
                [s.node_set.nodes() for s in servers]
            c0 = InternalClient(servers[0].host, timeout=10.0, device="cpu")
            c0.create_index("i")
            c0.create_frame("i", "f")
            assert wait_for(lambda: all(s.holder.frame("i", "f") is not None for s in servers),
                            10.0, 0.05)
            for sl in range(8):
                c0.execute_query("i", f'SetBit(frame="f", rowID=1, columnID={sl * SLICE_WIDTH})')
            c3 = InternalClient(servers[3].host, timeout=10.0, device="cpu")
            assert wait_for(lambda: c3.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))') == 8,
                            10.0, 0.1)
        finally:
            for s in servers:
                s.close()

    def test_membership_states_degraded_flag_and_join_candidates(self, tmp_path):
        """Node states follow gossip (a closed node goes DOWN on /status),
        a peer's degraded flag reaches the others' routing table, and a
        gossiping host outside the ring is a join candidate."""
        import json
        import urllib.request

        hosts = sorted(f"127.0.0.1:{_free_tcp_port()}" for _ in range(3))
        gports = [_free_udp_port() for _ in range(4)]
        servers = []
        try:
            for i in range(3):
                s = gossip_server(tmp_path, f"n{i}", hosts[i], hosts, gports[i],
                                  "" if i == 0 else f"127.0.0.1:{gports[0]}",
                                  suspect=0.5)
                s.open()
                servers.append(s)
            late = gossip_server(tmp_path, "late", f"127.0.0.1:{_free_tcp_port()}", hosts, gports[3],
                                 f"127.0.0.1:{gports[0]}")
            late.open()
            servers.append(late)

            def rebalance(s):
                with urllib.request.urlopen(f"http://{s.host}/debug/rebalance", timeout=10) as r:
                    return json.loads(r.read())

            assert wait_for(lambda: late.host in rebalance(servers[0])["joinCandidates"], 10.0, 0.05)
            # Quarantine node 1's device through launch faults aimed at it.
            c0 = InternalClient(hosts[0], timeout=10.0, device="cpu")
            c0.create_index("i")
            c0.create_frame("i", "f")
            assert wait_for(lambda: all(x.holder.frame("i", "f") is not None for x in servers), 10.0, 0.05)
            for sl in range(6):
                c0.execute_query("i", f'SetBit(frame="f", rowID=1, columnID={sl * SLICE_WIDTH})')
            c1 = InternalClient(hosts[1], timeout=10.0, device="cpu")
            faults.install(f"device.launch:host={hosts[1]},kind=error")
            try:
                def quarantined():
                    c1.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))')
                    return servers[1].device_health.degraded()

                assert wait_for(quarantined, 10.0, 0.05)
                assert wait_for(lambda: servers[0].cluster.node_by_host(hosts[1]).degraded
                                and servers[2].cluster.node_by_host(hosts[1]).degraded, 10.0, 0.05)
            finally:
                faults.clear()
            servers[2].close()
            servers.remove(servers[2])

            def state_of(h):
                with urllib.request.urlopen(f"http://{servers[0].host}/status", timeout=10) as r:
                    nodes = json.loads(r.read())["status"]["Nodes"]
                return {n["Host"]: n["State"] for n in nodes}.get(h)

            assert wait_for(lambda: state_of(hosts[2]) == "DOWN", 10.0, 0.05)
        finally:
            for s in servers:
                s.close()


# ---------------------------------------------------------------------------
# cross-package membership
# ---------------------------------------------------------------------------


class TestCrossPackageGossip:
    def test_jax_and_port_node_sets_exchange_messages_and_state(self):
        from pilosa_tpu.cluster.gossip import GossipNodeSet as JNodeSet
        from pilosa_tpu.net import wire_pb2 as jwire

        blob_j = bytes(range(256)) * 40  # inline
        blob_t = bytes(range(255, -1, -1)) * 300  # chunked
        merged_j, merged_t = [], []
        hj, ht = _Recorder(), _Recorder()
        j = JNodeSet(host="127.0.0.1:1", gossip_interval=0.05, suspect_after=5.0,
                     state_provider=lambda: blob_j, state_merger=merged_j.append)
        j.bind = ("127.0.0.1", _free_udp_port())
        j.start(hj)
        j.open()
        t = GossipNodeSet(host="127.0.0.1:2", seed=f"127.0.0.1:{j.bind[1]}", gossip_interval=0.05,
                          suspect_after=5.0, state_provider=lambda: blob_t,
                          state_merger=merged_t.append)
        t.bind = ("127.0.0.1", _free_udp_port())
        t.start(ht)
        t.open()
        try:
            assert wait_for(lambda: _joined(j, t))
            j.send_sync(jwire.CreateIndexMessage(Index="from-jax", Meta=jwire.IndexMeta(TimeQuantum="YM")))
            t.send_sync(wire.CreateFrameMessage(Index="x", Frame="from-port",
                                                Meta=wire.FrameMeta(CacheSize=7)))
            assert len(ht.received) == 1 and ht.received[0].Index == "from-jax"
            assert ht.received[0].Meta.TimeQuantum == "YM"
            assert len(hj.received) == 1 and hj.received[0].Frame == "from-port"
            assert hj.received[0].Meta.CacheSize == 7
            assert wait_for(lambda: merged_j and merged_t, 10.0)
            assert merged_t[0] == blob_j and merged_j[0] == blob_t
        finally:
            t.close()
            j.close()

    def test_mixed_cluster_replicates_schema_and_counts(self, tmp_path):
        from pilosa_tpu.cluster.gossip import GossipNodeSet as JNodeSet
        from pilosa_tpu.cluster.topology import Cluster as JCluster
        from pilosa_tpu.net.client import InternalClient as JClient
        from pilosa_tpu.net.server import Server as JServer

        hosts = sorted(f"127.0.0.1:{_free_tcp_port()}" for _ in range(3))
        gports = [_free_udp_port() for _ in range(3)]
        # hosts[0] is a JAX node, hosts[1] and hosts[2] port nodes.
        ns = JNodeSet(host=hosts[0], gossip_interval=0.05, suspect_after=5.0)
        ns.bind = ("127.0.0.1", gports[0])
        jc = JCluster(replica_n=2)
        jc.node_set = ns
        for h in hosts:
            jc.add_node(h)
        j = JServer(data_dir=str(tmp_path / "j"), host=hosts[0], cluster=jc, broadcaster=ns,
                    broadcast_receiver=ns, admission=False, anti_entropy_interval=3600,
                    polling_interval=3600, cache_flush_interval=3600)
        nodes = [j]
        try:
            j.open()
            for i in (1, 2):
                s = gossip_server(tmp_path, f"t{i}", hosts[i], hosts, gports[i],
                                  f"127.0.0.1:{gports[0]}", replicas=2)
                s.open()
                nodes.append(s)
            assert wait_for(lambda: len(ns.nodes()) == 3
                            and all(len(s.node_set.nodes()) == 3 for s in nodes[1:]), 10.0, 0.05)
            JClient(hosts[0], timeout=10.0).create_index("i")
            InternalClient(hosts[1], timeout=10.0, device="cpu").create_frame("i", "f")
            assert wait_for(lambda: all(s.holder.frame("i", "f") is not None for s in nodes), 10.0, 0.05)
            cols = [s * SLICE_WIDTH + 11 * s for s in range(6)]
            for k, col in enumerate(cols):
                host = hosts[k % 3]
                if k % 3 == 0:
                    JClient(host, timeout=10.0).execute_query("i", f'SetBit(frame="f", rowID=1, columnID={col})')
                else:
                    InternalClient(host, timeout=10.0, device="cpu").execute_query(
                        "i", f'SetBit(frame="f", rowID=1, columnID={col})')
            assert wait_for(lambda: all(s.holder.index("i").max_slice() >= 5 for s in nodes), 10.0, 0.05)
            counts = [int(JClient(hosts[0], timeout=10.0).execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))'))]
            counts += [int(InternalClient(h, timeout=10.0, device="cpu").execute_pql(
                "i", 'Count(Bitmap(frame="f", rowID=1))')) for h in hosts[1:]]
            assert counts == [len(cols)] * 3
        finally:
            for s in nodes:
                s.close()


def test_cli_server_flags_reach_the_server(monkeypatch):
    """The CLI's gossip, tier and subscribe flags reach ``Server`` with
    the JAX package's defaults when absent."""
    import importlib

    server_mod = importlib.import_module("pilosa_tpu_torch.net.server")
    # the package's ``main`` (the function) shadows the module's name
    cli_main = importlib.import_module("pilosa_tpu_torch.cli.main")

    got: dict = {}

    class Stop(Exception):
        pass

    class Capture:
        def __init__(self, *args, **kw):
            got.update(kw)
            raise Stop

    monkeypatch.setattr(server_mod, "Server", Capture)
    argv = ["server", "--device", "cpu", "--cluster-type", "gossip", "--gossip-seed", "10.0.0.1:11101",
            "--gossip-bind", "0.0.0.0:11102", "--tier-store", "file:///s",
            "--tier-disk-budget-bytes", "42", "--subscribe", "false", "--rebalance-on-join", "true"]
    with pytest.raises(Stop):
        cli_main.run_server(cli_main.build_parser().parse_args(argv))
    assert (got["cluster_type"], got["gossip_seed"], got["gossip_bind"]) == (
        "gossip", "10.0.0.1:11101", "0.0.0.0:11102")
    assert (got["tier_store"], got["tier_disk_budget_bytes"]) == ("file:///s", 42)
    assert got["subscribe_enabled"] is False and got["rebalance_on_join"] is True
    got.clear()
    with pytest.raises(Stop):
        cli_main.run_server(cli_main.build_parser().parse_args(["server", "--device", "cpu"]))
    assert {k: got[k] for k in ("tier_store", "tier_hydrate_throttle_mbps", "tier_sweep_interval_s",
                                "subscribe_enabled", "subscribe_delta_cap", "subscribe_coalesce_ms",
                                "gossip_ack_timeout_ms", "gossip_stream_timeout_ms")} == {
        "tier_store": "", "tier_hydrate_throttle_mbps": 0.0, "tier_sweep_interval_s": 60.0,
        "subscribe_enabled": True, "subscribe_delta_cap": 50_000, "subscribe_coalesce_ms": 5.0,
        "gossip_ack_timeout_ms": 250.0, "gossip_stream_timeout_ms": 10_000.0}
