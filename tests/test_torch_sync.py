"""Anti-entropy and a mixed JAX/port cluster's replica agreement.

* ``tests/test_net.py``'s syncer tests, run against the port with their
  assertions unchanged (``TestAntiEntropy``: a diverged fragment, a
  diverged inverse view and attribute stores converge through
  ``sync/syncer.py``; ``TestClusterFailure``: a node killed and
  restarted converges through each node's sweep, byte for byte).  Only
  the harness differs: port nodes on the CPU (``Server(device="cpu")``)
  in an http cluster, peers meeting through ``add_peer``.
* A cluster of one JAX node and one port node (2 replicas): a port
  coordinator's hints replay onto a JAX replica and a JAX coordinator's
  onto a port replica; a grow coordinated by the JAX node moves slices
  onto a joining port node and a drain coordinated by a port node moves
  them back, every fragment's checksum unchanged (ROADMAP constraint e).
"""

from __future__ import annotations

import json
import socket
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu.cluster import topology as jtopo  # noqa: E402
from pilosa_tpu.net.server import Server as JServer  # noqa: E402
from pilosa_tpu_torch.net.client import InternalClient  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402


def _client(host: str) -> InternalClient:
    return InternalClient(host, timeout=10.0, device="cpu")


@pytest.fixture
def two_servers(tmp_path):
    """Two port nodes of an http cluster (replicas=1): schema messages
    reach the peer's internal listener."""
    servers = [
        Server(str(tmp_path / f"n{i}"), device="cpu", cluster_type="http", internal_port=0,
               floor_probe=False, anti_entropy_interval=3600, polling_interval=3600)
        for i in range(2)
    ]
    for s in servers:
        s.open()
    for s in servers:
        for o in servers:
            if o is not s:
                s.add_peer(o.host, o.internal_host)
    yield tuple(servers)
    for s in servers:
        s.close()


# ---------------------------------------------------------------------------
# tests/test_net.py's anti-entropy tests
# ---------------------------------------------------------------------------


class TestAntiEntropy:
    def test_fragment_sync_converges(self, two_servers):
        from pilosa_tpu_torch.sync.syncer import HolderSyncer

        s0, s1 = two_servers
        self._diverge(s0, s1)
        # Run the syncer from each node; replicas converge to majority.
        HolderSyncer(
            holder=s0.holder, host=s0.host, cluster=s0.cluster
        ).sync_holder()
        HolderSyncer(
            holder=s1.holder, host=s1.host, cluster=s1.cluster
        ).sync_holder()
        c = _client(s0.host)
        n = c.execute_pql("i", 'Count(Bitmap(frame="f", rowID=0))')
        assert n == 3

    def _diverge(self, s0, s1):
        # replica_n=1: each slice owned by exactly one node; write bits
        # directly into one node's fragment for a slice the *other* node
        # owns, so sync must repair it.
        for s in (s0, s1):
            s.holder.create_index_if_not_exists("i")
            s.holder.index("i").create_frame_if_not_exists("f")
        # find a slice owned by s0
        owned_by_0 = next(
            sl for sl in range(8) if s0.cluster.owns_fragment(s0.host, "i", sl)
        )
        # write the authoritative copy on the owner
        c0 = _client(s0.host)
        base = owned_by_0 * SLICE_WIDTH
        for col in (base + 1, base + 2, base + 3):
            c0.execute_query("i", f'SetBit(frame="f", rowID=0, columnID={col})')

    def test_inverse_view_divergence_converges(self, tmp_path):
        """Divergence introduced DIRECTLY in a derived (inverse) view is
        detected and repaired through the view-scoped sync path."""
        from pilosa_tpu_torch.sync.syncer import HolderSyncer

        servers = [
            Server(str(tmp_path / f"r{i}"), device="cpu", replicas=2, floor_probe=False,
                   anti_entropy_interval=3600, polling_interval=3600)
            for i in range(2)
        ]
        for s in servers:
            s.open()
        try:
            hosts = sorted(s.host for s in servers)
            for s in servers:
                for h in hosts:
                    s.add_peer(h)
            s0, s1 = servers
            for s in servers:
                s.holder.create_index_if_not_exists("i")
                s.holder.index("i").create_frame_if_not_exists(
                    "f", inverse_enabled=True
                )
            # Identical data on both replicas through the write fan-out.
            c0 = _client(s0.host)
            c0.execute_query("i", 'SetBit(frame="f", rowID=3, columnID=9)')
            # Diverge ONLY s1's inverse view: direct fragment write that
            # no broadcast or standard-view checksum can observe.
            frag1 = s1.holder.fragment("i", "f", "inverse", 0)
            assert frag1 is not None
            frag1.set_bit(42, 7)
            # ...and s0's, in the other direction — this one must be
            # PUSHED to s1 over the view-scoped import endpoint.
            frag0 = s0.holder.fragment("i", "f", "inverse", 0)
            frag0.set_bit(43, 8)
            # Standard views still agree everywhere.
            std0 = dict(s0.holder.fragment("i", "f", "standard", 0).blocks())
            std1 = dict(s1.holder.fragment("i", "f", "standard", 0).blocks())
            assert std0 == std1
            # Anti-entropy from s0 pulls the diverged inverse bit.
            HolderSyncer(
                holder=s0.holder, host=s0.host, cluster=s0.cluster
            ).sync_holder()
            assert frag0.contains(42, 7)  # pulled from s1
            assert frag1.contains(43, 8)  # pushed to s1
            assert dict(frag0.blocks()) == dict(frag1.blocks())
        finally:
            for s in servers:
                s.close()

    def test_attr_sync(self, two_servers):
        from pilosa_tpu_torch.sync.syncer import HolderSyncer

        s0, s1 = two_servers
        for s in (s0, s1):
            s.holder.create_index_if_not_exists("i")
            s.holder.index("i").create_frame_if_not_exists("f")
        # set attrs only on s0 (bypassing broadcast)
        s0.holder.index("i").column_attr_store.set_attrs(1, {"color": "red"})
        s0.holder.frame("i", "f").row_attr_store.set_attrs(2, {"tag": "x"})
        # sync from s1 pulls the diff
        HolderSyncer(
            holder=s1.holder, host=s1.host, cluster=s1.cluster
        ).sync_holder()
        assert s1.holder.index("i").column_attr_store.attrs(1) == {"color": "red"}
        assert s1.holder.frame("i", "f").row_attr_store.attrs(2) == {"tag": "x"}


class TestClusterFailure:
    """3 real servers, replica_n=2: kill a node mid-stream, assert exact
    answers via query-time failover re-map, restart it, repair via the
    syncer, and assert byte-identical fragment checksums."""

    N_SLICES = 8

    def _boot(self, tmp_path, name, host="127.0.0.1:0", ring=()):
        s = Server(str(tmp_path / name), host=host, hosts=list(ring), replicas=2,
                   device="cpu", floor_probe=False, anti_entropy_interval=3600,
                   polling_interval=3600)
        s.open()
        return s

    def _wire(self, servers, hosts):
        """Give every server the same ordered node list."""
        for s in servers:
            for h in hosts:
                s.add_peer(h)

    def test_kill_failover_restart_converge(self, tmp_path):
        servers = [self._boot(tmp_path, f"n{i}") for i in range(3)]
        try:
            hosts = sorted(s.host for s in servers)
            self._wire(servers, hosts)
            for s in servers:
                s.holder.create_index_if_not_exists("i")
                s.holder.index("i").create_frame_if_not_exists("f")

            c0 = _client(servers[0].host)
            total = 0
            for sl in range(self.N_SLICES):
                for c in range(sl + 1):
                    c0.execute_query(
                        "i",
                        f'SetBit(frame="f", rowID=1, columnID={sl * SLICE_WIDTH + c})',
                    )
                    total += 1
            want = total  # 1+2+..+8 = 36

            for s in servers:
                s.tick_max_slices()

            # sanity: every coordinator answers exactly
            for s in servers:
                cc = _client(s.host)
                assert cc.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))') == want

            # ---- kill one node that owns data ----
            victim = servers[1]
            victim_host = victim.host
            victim.close()

            # Queries from the surviving coordinators still answer
            # EXACTLY: the executor re-maps the dead node's slices to
            # replicas.
            for s in (servers[0], servers[2]):
                cc = _client(s.host)
                assert cc.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))') == want

            # Divergence the victim will have to repair: row-2 bits
            # applied directly on the surviving replica of each slice.
            extra = 0
            for sl in range(self.N_SLICES):
                owners = [
                    n.host
                    for n in servers[0].cluster.fragment_nodes("i", sl)
                ]
                for s in (servers[0], servers[2]):
                    if s.host in owners:
                        s.holder.index("i").frame("f").set_bit(
                            "standard", 2, sl * SLICE_WIDTH + 99
                        )
                        extra += 1
                        break

            # ---- restart the victim on its old host:port ----
            revived = self._boot(tmp_path, "n1", host=victim_host, ring=hosts)
            servers[1] = revived
            self._wire(servers, hosts)
            revived.holder.create_index_if_not_exists("i")
            revived.holder.index("i").create_frame_if_not_exists("f")
            revived.tick_max_slices()

            # anti-entropy runs on EVERY node — run each node's syncer once.
            from pilosa_tpu_torch.sync.syncer import HolderSyncer

            for s in servers:
                HolderSyncer(s.holder, s.host, s.cluster).sync_holder()

            # Convergence: every fragment's checksum is byte-identical
            # across the replicas that own it.
            for sl in range(self.N_SLICES):
                owners = {
                    n.host
                    for n in servers[0].cluster.fragment_nodes("i", sl)
                }
                sums = {}
                for s in servers:
                    if s.host not in owners:
                        continue
                    frag = s.holder.fragment("i", "f", "standard", sl)
                    assert frag is not None, (s.host, sl)
                    sums[s.host] = frag.checksum()
                assert len(sums) == 2, (sl, owners)
                assert len(set(sums.values())) == 1, (sl, sums)

            # And the revived coordinator answers exactly.
            cr = _client(revived.host)
            assert cr.execute_pql("i", 'Count(Bitmap(frame="f", rowID=1))') == want
            assert cr.execute_pql("i", 'Count(Bitmap(frame="f", rowID=2))') == extra
        finally:
            for s in servers:
                try:
                    s.close()
                except Exception:
                    pass


def test_write_listener_unregisters_a_bound_method():
    """A closed server's listener leaves the registry (a bound method is
    compared by equality, not identity)."""
    from pilosa_tpu_torch.core import fragment as tfragment

    class Holder:
        def listen(self, *args):
            pass

    h = Holder()
    before = len(tfragment._write_listeners)
    tfragment.register_write_listener(h.listen)
    tfragment.register_write_listener(h.listen)
    assert len(tfragment._write_listeners) == before + 1
    tfragment.unregister_write_listener(h.listen)
    assert len(tfragment._write_listeners) == before


# ---------------------------------------------------------------------------
# a mixed JAX/port cluster
# ---------------------------------------------------------------------------

N_MIXED = 6
_QUIET_J = dict(anti_entropy_interval=3600, polling_interval=3600, cache_flush_interval=3600,
                breaker_open_ms=200.0, rebalance_release_delay_ms=0.0)
_QUIET_T = dict(device="cpu", floor_probe=False, anti_entropy_interval=3600,
                polling_interval=3600, breaker_open_ms=200.0, rebalance_release_delay_ms=0.0)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax(tmp_path, name, host, ring, replicas):
    c = jtopo.Cluster(replica_n=replicas)
    for h in ring:
        c.add_node(h)
    s = JServer(data_dir=str(tmp_path / name), host=host, cluster=c, **_QUIET_J)
    s.replication.replay_interval_s = 3600.0  # replays are driven by the test
    s.open()
    return s


def _port(tmp_path, name, host, ring, replicas):
    s = Server(str(tmp_path / name), host=host, hosts=list(ring), replicas=replicas, **_QUIET_T)
    s.replication.replay_interval_s = 3600.0
    s.open()
    return s


def _until(pred, timeout: float = 60.0, what: str = "condition") -> None:
    """Wait for ``pred()`` by a bounded poll."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _breaker_ready(server, host: str) -> bool:
    b = server.resilience.breakers.for_host(host)
    snap = b.snapshot()
    return snap["state"] == "closed" or snap.get("sinceOpenMs", 0.0) >= b.open_s * 1000.0


def _post(host: str, path: str, body: bytes = b"") -> tuple[int, dict]:
    c = _client(host)
    status, data = c._request("POST", path, body=body)
    return status, json.loads(data or b"{}")


def _schema(servers):
    for s in servers:
        s.holder.create_index_if_not_exists("i")
        s.holder.index("i").create_frame_if_not_exists("f")


def _checksums(servers, index="i"):
    """(slice -> checksum) of each slice's owner, from whichever node of
    ``servers`` owns it now."""
    out = {}
    for s in servers:
        idx = s.holder.index(index)
        if idx is None:
            continue
        for v in idx.frame("f").views().values():
            for frag in v.fragments():
                if s.cluster.owns_fragment(s.host, index, frag.slice):
                    out.setdefault((v.name, frag.slice), set()).add(frag.checksum())
    return out


def _count(host, row):
    st, body = _post(host, "/index/i/query", f'Count(Bitmap(frame="f", rowID={row}))'.encode())
    assert st == 200, body
    return body["results"][0]


def test_mixed_cluster_hints_replay_across_packages(tmp_path):
    """2 replicas over one JAX and one port node: with the JAX node down a
    write at writeConsistency=one through the port node queues a hint
    that replays onto the restarted JAX node, and the same the other way
    round; both replicas end with equal checksums."""
    hosts = sorted(f"127.0.0.1:{_free_port()}" for _ in range(2))
    jh, th = hosts
    j = _jax(tmp_path, "j", jh, hosts, 2)
    t = _port(tmp_path, "t", th, hosts, 2)
    try:
        _schema([j, t])
        for sl in range(N_MIXED):
            assert _post(th, "/index/i/query",
                         f'SetBit(frame="f", rowID=1, columnID={sl * SLICE_WIDTH})'.encode())[0] == 200
        # The JAX replica down: the port coordinator queues its hints.
        j.close()
        cols = [sl * SLICE_WIDTH + 50 for sl in range(N_MIXED)]
        for col in cols:
            st, body = _post(th, "/index/i/query?writeConsistency=one",
                             f'SetBit(frame="f", rowID=2, columnID={col})'.encode())
            assert st == 200, body
        assert t.replication.hints.backlog(jh) == len(cols)
        j = _jax(tmp_path, "j", jh, hosts, 2)
        _until(lambda: _breaker_ready(t, jh), what="the port node's breaker")
        assert t.replication.replay_now(jh)[jh] == len(cols)
        assert t.replication.hints.backlog(jh) == 0
        assert _count(jh, 2) == len(cols)
        # The port replica down: the JAX coordinator queues its hints.
        t.close()
        for col in cols:
            st, body = _post(jh, "/index/i/query?writeConsistency=one",
                             f'SetBit(frame="f", rowID=3, columnID={col})'.encode())
            assert st == 200, body
        # The restarted JAX node queues each write twice: the JAX package
        # never unregisters a closed server's write listener (ROADMAP
        # §C), and the first node on this data dir still records.  A
        # replay applies each twice, which changes nothing.
        assert j.replication.hints.backlog(th) >= len(cols)
        t = _port(tmp_path, "t", th, hosts, 2)
        _until(lambda: _breaker_ready(j, th), what="the JAX node's breaker")
        assert j.replication.replay_now(th)[th] >= len(cols)
        assert _count(th, 3) == len(cols)
        for sl in range(N_MIXED):
            fj = j.holder.fragment("i", "f", "standard", sl)
            ft = t.holder.fragment("i", "f", "standard", sl)
            assert fj.checksum() == ft.checksum(), sl
    finally:
        for s in (j, t):
            try:
                s.close()
            except Exception:
                pass


def _wait_resize(host: str) -> None:
    def done():
        c = _client(host)
        st, data = c._request("GET", "/debug/rebalance")
        snap = json.loads(data)
        err = (snap.get("coordinator") or {}).get("error") or snap.get("lastError")
        if not snap.get("running") and err:
            raise AssertionError(f"migration stopped: {err}")
        return not snap.get("running") and snap.get("transition") is None

    _until(done, what="the resize")


def test_mixed_cluster_resize_moves_slices_between_packages(tmp_path):
    """A JAX node and a port node (replicas=1); a port node joins through
    a resize the JAX node coordinates (slices move JAX -> port), then
    leaves through a drain a port node coordinates (port -> JAX).  Every
    slice's checksum is the one it had before, and every node counts
    every bit."""
    hosts = sorted(f"127.0.0.1:{_free_port()}" for _ in range(3))
    ring2 = hosts[:2]
    # The JAX node is the first of the ring, the joiner the last host.
    j = _jax(tmp_path, "j", hosts[0], ring2, 1)
    t = _port(tmp_path, "t", hosts[1], ring2, 1)
    t2 = None
    try:
        _schema([j, t])
        rng = np.random.default_rng(17)
        cols = np.unique(rng.integers(0, N_MIXED * SLICE_WIDTH, 600))
        for col in cols.tolist():
            assert _post(hosts[1], "/index/i/query",
                         f'SetBit(frame="f", rowID=1, columnID={col})'.encode())[0] == 200
        j._tick_max_slices()
        t.tick_max_slices()
        before = _checksums([j, t])
        assert all(len(v) == 1 for v in before.values())
        t2 = _port(tmp_path, "t2", hosts[2], ring2, 1)
        st, body = _post(hosts[0], "/cluster/resize", json.dumps({"hosts": hosts}).encode())
        assert st == 200, body
        _wait_resize(hosts[0])
        nodes = [j, t, t2]
        for s in nodes:
            assert s.cluster.hosts() == hosts, s.host
        moved_in = {sl for sl in range(N_MIXED)
                    if t2.cluster.fragment_nodes("i", sl)[0].host == t2.host}
        assert moved_in, "the grow moved no slice onto the port node"
        assert _checksums(nodes) == before
        for s in nodes:
            assert _count(s.host, 1) == len(cols), s.host
        # Drain the joiner again, coordinated by the port node.
        st, body = _post(hosts[1], "/cluster/resize", json.dumps({"hosts": ring2}).encode())
        assert st == 200, body
        _wait_resize(hosts[1])
        assert t2.holder.index("i") is None or not any(
            v.fragments() for v in t2.holder.index("i").frame("f").views().values())
        assert _checksums([j, t]) == before
        for s in (j, t):
            assert _count(s.host, 1) == len(cols), s.host
    finally:
        for s in (j, t, t2):
            if s is not None:
                try:
                    s.close()
                except Exception:
                    pass
