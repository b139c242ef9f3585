"""The JAX package's tenant QoS suite, run against the port.

``tests/test_tenants.py``'s classes with their assertions unchanged, over
the port's ``net/admission.py`` and port nodes on the CPU
(``Server(device="cpu")``): tenant specs and resolution, the weighted-fair
queue (deficit rotation, the starvation bound, FIFO within a tenant),
quota accounting and refill, the 429 contract with ``X-Quota-Limit`` /
``X-Quota-Remaining`` in JSON and protobuf, ``GET /debug/tenants``, the
per-tenant counters, internal-lane spoofing, and two nodes whose remote
legs charge the origin tenant.  Only the harness differs: the port's
``Server`` takes its ring as ``hosts=``, and its wire messages encode by
hand.  ``TestMixedCluster`` adds a JAX coordinator over a port node: with
a shared ``tenant-internal-token`` the legs ride the port node's internal
lane, charged to the origin tenant; without the token they do not.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from pilosa_tpu_torch.net import admission as adm  # noqa: E402
from pilosa_tpu_torch.net import resilience as rz  # noqa: E402, F401
from pilosa_tpu_torch.net import wire  # noqa: E402
from pilosa_tpu_torch.net.server import Server  # noqa: E402
from pilosa_tpu_torch.obs.stats import ExpvarStatsClient  # noqa: E402
from pilosa_tpu_torch.ops.bitplane import SLICE_WIDTH  # noqa: E402

_QUIET = dict(anti_entropy_interval=3600, polling_interval=3600, device="cpu",
              floor_probe=False)

# ---------------------------------------------------------------------------
# spec parsing + resolution
# ---------------------------------------------------------------------------


class TestTenantSpec:
    def test_parse_full(self):
        t = adm.Tenant.parse("gold:8:100:1e6")
        assert (t.name, t.weight, t.qps, t.bytes_per_s) == ("gold", 8, 100.0, 1e6)

    def test_parse_defaults(self):
        t = adm.Tenant.parse("bronze")
        assert (t.weight, t.qps, t.bytes_per_s) == (1, 0.0, 0.0)

    @pytest.mark.parametrize("bad", ["", ":3", "x:lots", "x:1:fast"])
    def test_parse_rejects(self, bad):
        with pytest.raises(ValueError):
            adm.Tenant.parse(bad)


class TestResolution:
    def _reg(self):
        return adm.TenantRegistry(
            tenants=["gold:4", "bronze:1"],
            keys=["sekret:gold"],
            internal_token="tok",
        )

    def test_api_key_wins_over_header(self):
        reg = self._reg()
        assert reg.resolve("sekret", "bronze") == "gold"

    def test_bare_header_only_for_configured_tenants(self):
        reg = self._reg()
        assert reg.resolve("", "bronze") == "bronze"
        # arbitrary client-chosen names must NOT mint tenants
        assert reg.resolve("", "made-up") == adm.DEFAULT_TENANT

    def test_unknown_key_falls_to_default(self):
        reg = self._reg()
        assert reg.resolve("wrong", "") == adm.DEFAULT_TENANT

    def test_internal_token_gate(self):
        reg = self._reg()
        assert reg.internal_ok("tok")
        assert not reg.internal_ok("")
        assert not reg.internal_ok("guess")
        # no token configured: lane is open (pre-tenant deployments)
        assert adm.TenantRegistry().internal_ok("")


# ---------------------------------------------------------------------------
# weighted-fair queueing
# ---------------------------------------------------------------------------


def _drain_in_order(ac, arrivals):
    """Enqueue ``arrivals`` — (tenant, tag) pairs — one at a time
    behind a held slot (concurrency=1), release the slot, and return
    the tags in grant order.  Serial releases make the DRR schedule
    the only ordering force."""
    blocker = ac.acquire(adm.CLASS_POINT, tenant="blocker")
    gate = ac.gate(adm.CLASS_POINT)
    order, olock = [], threading.Lock()
    threads = []

    def waiter(tenant, tag):
        tk = ac.acquire(adm.CLASS_POINT, tenant=tenant)
        with olock:
            order.append(tag)
        tk.release()

    for tenant, tag in arrivals:
        before = gate.snapshot()["queued"]
        th = threading.Thread(target=waiter, args=(tenant, tag))
        th.start()
        threads.append(th)
        deadline = 200
        while gate.snapshot()["queued"] != before + 1 and deadline:
            threading.Event().wait(0.01)
            deadline -= 1
        assert deadline, "waiter never queued"
    blocker.release()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    return order


class TestWeightedFairQueue:
    def _controller(self, tenants):
        reg = adm.TenantRegistry(tenants=tenants)
        return adm.AdmissionController(
            point_concurrency=1, queue_depth=64, tenants=reg
        )

    def test_deficit_rotation_serves_weight_per_round(self):
        """hot(weight 3) vs victim(weight 1): each rotation grants ~3
        hot then 1 victim — victims appear every ≤4 grants, not after
        the hot backlog drains."""
        ac = self._controller(["hot:3", "victim:1"])
        arrivals = [("hot", f"h{i}") for i in range(12)]
        arrivals += [("victim", f"v{i}") for i in range(4)]
        order = _drain_in_order(ac, arrivals)
        assert len(order) == 16
        v_positions = [i for i, tag in enumerate(order) if tag[0] == "v"]
        # i-th victim grant within (i+1) rotations of (3 hot + 1 victim)
        for i, pos in enumerate(v_positions):
            assert pos <= (i + 1) * 4, f"victim {i} starved: order={order}"

    def test_starvation_bound_one_rotation(self):
        """A victim's FIRST request waits at most ~one rotation (hot's
        weight grants), no matter how deep hot's backlog is."""
        ac = self._controller(["hot:8", "victim:1"])
        arrivals = [("hot", f"h{i}") for i in range(24)]
        arrivals += [("victim", "v0")]
        order = _drain_in_order(ac, arrivals)
        assert order.index("v0") <= 9, f"victim starved: order={order}"

    def test_single_tenant_degenerates_to_fifo(self):
        ac = self._controller(["solo:1"])
        arrivals = [("solo", f"s{i}") for i in range(6)]
        order = _drain_in_order(ac, arrivals)
        assert order == [f"s{i}" for i in range(6)]

    def test_fifo_within_one_tenant_under_contention(self):
        """DRR must preserve arrival order INSIDE each tenant."""
        ac = self._controller(["hot:2", "cold:1"])
        arrivals = [("hot", "h0"), ("cold", "c0"), ("hot", "h1"),
                    ("cold", "c1"), ("hot", "h2")]
        order = _drain_in_order(ac, arrivals)
        assert [t for t in order if t[0] == "h"] == ["h0", "h1", "h2"]
        assert [t for t in order if t[0] == "c"] == ["c0", "c1"]


# ---------------------------------------------------------------------------
# quotas: accounting + refill
# ---------------------------------------------------------------------------


class TestQuotaAccounting:
    def test_qps_bucket_debits_then_sheds(self):
        reg = adm.TenantRegistry(tenants=["metered:1:3"])
        for _ in range(3):
            reg.check_quota("metered", adm.CLASS_POINT)
        with pytest.raises(adm.QuotaError) as ei:
            reg.check_quota("metered", adm.CLASS_POINT)
        e = ei.value
        assert e.status == 429
        assert e.tenant == "metered"
        assert e.quota_kind == "qps"
        assert e.quota_limit == 3.0
        assert e.quota_remaining < 1.0
        assert e.retry_after_s > 0

    def test_bucket_refills_over_time(self):
        reg = adm.TenantRegistry(tenants=["metered:1:2"])
        reg.check_quota("metered", adm.CLASS_POINT)
        reg.check_quota("metered", adm.CLASS_POINT)
        with pytest.raises(adm.QuotaError):
            reg.check_quota("metered", adm.CLASS_POINT)
        # rewind the bucket clock one second: full refill, admits again
        st = reg._state["metered"]
        st.qps_bucket.t_last -= 1.0
        reg.check_quota("metered", adm.CLASS_POINT)

    def test_bytes_quota_charges_ingress(self):
        reg = adm.TenantRegistry(tenants=["bulk:1:0:100"])
        reg.check_quota("bulk", adm.CLASS_WRITE, nbytes=60)
        with pytest.raises(adm.QuotaError) as ei:
            reg.check_quota("bulk", adm.CLASS_WRITE, nbytes=60)
        assert ei.value.quota_kind == "bytes"
        assert ei.value.quota_limit == 100.0

    def test_unmetered_tenant_never_sheds(self):
        reg = adm.TenantRegistry(tenants=["free:1"])
        for _ in range(100):
            reg.check_quota("free", adm.CLASS_POINT)

    def test_internal_lane_is_quota_exempt(self):
        """The controller skips quota for CLASS_INTERNAL: map legs were
        paid for at the coordinator's front door."""
        reg = adm.TenantRegistry(tenants=["metered:1:1"])
        ac = adm.AdmissionController(tenants=reg)
        for _ in range(5):
            ac.acquire(adm.CLASS_INTERNAL, tenant="metered").release()
        # client class still meters
        ac.acquire(adm.CLASS_POINT, tenant="metered").release()
        with pytest.raises(adm.QuotaError):
            ac.acquire(adm.CLASS_POINT, tenant="metered")

    def test_quota_shed_counts_in_snapshot(self):
        reg = adm.TenantRegistry(tenants=["metered:1:1"])
        ac = adm.AdmissionController(tenants=reg)
        ac.acquire(adm.CLASS_POINT, tenant="metered").release()
        with pytest.raises(adm.QuotaError):
            ac.acquire(adm.CLASS_POINT, tenant="metered")
        snap = ac.tenants_snapshot()["metered"]
        assert snap["quotaShed"] == 1
        assert snap["shed"] == 1
        assert snap["admitted"] == 1
        assert snap["quota"]["qps"]["limit"] == 1.0


# ---------------------------------------------------------------------------
# HTTP contract: one node
# ---------------------------------------------------------------------------


@pytest.fixture
def tenant_server(tmp_path):
    """Tenants: hot is API-keyed with a 3 qps quota; victim and the
    default tenant are unmetered."""
    s = Server(
        str(tmp_path / "data"),
        host="127.0.0.1:0",
        stats=ExpvarStatsClient(),
        tenants=["hot:8:3", "victim:1"],
        tenant_keys=["sekret:hot"],
        tenant_internal_token="tok",
        **_QUIET,
    )
    s.open()
    s.holder.create_index_if_not_exists("i")
    s.holder.index("i").create_frame_if_not_exists("f")
    s.holder.frame("i", "f").set_bit("standard", 1, 10)
    yield s
    s.close()


def _raw(host, path, data=b"", headers=None, method="POST"):
    """(status, headers, raw body) — no client-side translation."""
    req = urllib.request.Request(
        f"http://{host}{path}", data=data, method=method,
        headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


_Q = b'Count(Bitmap(frame="f", rowID=1))'


def _storm_until_429(host, headers, n=6):
    """Fire up to ``n`` queries; return the first 429 triple."""
    for _ in range(n):
        status, hdrs, body = _raw(host, "/index/i/query", _Q, headers)
        if status == 429:
            return status, hdrs, body
        assert status == 200, body
    raise AssertionError("quota never tripped")


class TestQuotaHTTPContract:
    def test_json_429_with_quota_headers(self, tenant_server):
        s = tenant_server
        status, hdrs, body = _storm_until_429(
            s.host, {"X-Api-Key": "sekret"}
        )
        assert status == 429
        assert hdrs["X-Quota-Limit"] == "3"
        assert float(hdrs["X-Quota-Remaining"]) < 1.0
        assert int(hdrs["Retry-After"]) >= 1
        parsed = json.loads(body)
        assert parsed["quota"]["tenant"] == "hot"
        assert parsed["quota"]["kind"] == "qps"
        assert parsed["quota"]["limit"] == 3.0
        assert parsed["retryAfterMs"] > 0

    def test_protobuf_429_with_quota_headers(self, tenant_server):
        s = tenant_server
        status, hdrs, body = _storm_until_429(
            s.host,
            {"X-Api-Key": "sekret", "Accept": "application/x-protobuf"},
        )
        assert status == 429
        assert hdrs["X-Quota-Limit"] == "3"
        assert "X-Quota-Remaining" in hdrs
        resp = wire.QueryResponse.decode(body)
        assert "quota" in resp.Err

    def test_other_tenants_admit_while_hot_sheds(self, tenant_server):
        """The acceptance-criteria shape: saturate hot's quota, then
        victim and the default tenant both still answer 200."""
        s = tenant_server
        _storm_until_429(s.host, {"X-Api-Key": "sekret"})
        status, _, _ = _raw(s.host, "/index/i/query", _Q,
                            {"X-Tenant": "victim"})
        assert status == 200
        status, _, _ = _raw(s.host, "/index/i/query", _Q)
        assert status == 200
        # and hot is STILL shedding (bucket not magically reset)
        status, _, _ = _raw(s.host, "/index/i/query", _Q,
                            {"X-Api-Key": "sekret"})
        assert status == 429

    def test_debug_tenants_table(self, tenant_server):
        s = tenant_server
        _storm_until_429(s.host, {"X-Api-Key": "sekret"})
        _raw(s.host, "/index/i/query", _Q, {"X-Tenant": "victim"})
        status, _, body = _raw(s.host, "/debug/tenants", method="GET")
        assert status == 200
        table = json.loads(body)
        assert table["defaultTenant"] == "default"
        hot = table["tenants"]["hot"]
        assert hot["quotaShed"] >= 1
        assert hot["admitted"] >= 1
        assert hot["quota"]["qps"]["limit"] == 3.0
        assert table["tenants"]["victim"]["admitted"] >= 1
        assert table["tenants"]["victim"]["quotaShed"] == 0

    def test_per_tenant_counters_emitted(self, tenant_server):
        s = tenant_server
        _storm_until_429(s.host, {"X-Api-Key": "sekret"})
        counts = s.stats.snapshot()["counts"]
        # ExpvarStatsClient renders tags sorted
        assert counts.get("net.admission.tenantAdmitted[class:point,tenant:hot]", 0) >= 1
        assert counts.get("net.admission.quotaShed[kind:qps,tenant:hot]", 0) >= 1
        # the executor also labels its class counter with the tenant
        assert counts.get("exec.class[class:point,tenant:hot]", 0) >= 1


class TestInternalLaneSpoofing:
    def _pb_query(self, host, token=""):
        pb = wire.QueryRequest(Query=_Q.decode(), Remote=True)
        headers = {
            "Content-Type": "application/x-protobuf",
            "Accept": "application/x-protobuf",
        }
        if token:
            headers["X-Internal-Token"] = token
        return _raw(host, "/index/i/query", pb.encode(), headers)

    def test_spoofed_remote_flag_charged_as_client(self, tenant_server):
        """Remote=true WITHOUT the internal token: classified and
        metered as ordinary client traffic."""
        s = tenant_server
        before = s.stats.snapshot()["counts"]
        status, _, _ = self._pb_query(s.host)
        assert status == 200
        after = s.stats.snapshot()["counts"]
        key_int = "net.admission.admitted[class:internal]"
        key_pt = "net.admission.admitted[class:point]"
        assert after.get(key_int, 0) == before.get(key_int, 0)
        assert after.get(key_pt, 0) == before.get(key_pt, 0) + 1

    def test_token_holder_rides_internal_lane(self, tenant_server):
        s = tenant_server
        before = s.stats.snapshot()["counts"]
        status, _, _ = self._pb_query(s.host, token="tok")
        assert status == 200
        after = s.stats.snapshot()["counts"]
        key_int = "net.admission.admitted[class:internal]"
        assert after.get(key_int, 0) == before.get(key_int, 0) + 1


# ---------------------------------------------------------------------------
# two real HTTP nodes: remote legs charge the originating tenant
# ---------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ring(n: int = 2) -> list[str]:
    ports: set[int] = set()
    while len(ports) < n:
        ports.add(_free_port())
    return sorted(f"127.0.0.1:{p}" for p in ports)


@pytest.fixture
def two_tenant_servers(tmp_path):
    """Tenant 'gold' is configured (with its API key) on the
    COORDINATOR only — the remote node must still charge 'gold' via
    the forwarded X-Tenant on the verified internal lane."""
    hosts = _ring()
    servers = []
    for i, host in enumerate(hosts):
        s = Server(
            str(tmp_path / f"n{i}"),
            host=host,
            hosts=hosts,
            stats=ExpvarStatsClient(),
            retry_backoff_ms=10,
            tenants=["gold:4"] if i == 0 else [],
            tenant_keys=["goldkey:gold"] if i == 0 else [],
            tenant_internal_token="fleet-tok",
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
    owned1 = [
        sl for sl in range(n_slices)
        if s0.cluster.fragment_nodes("i", sl)[0].host == s1.host
    ]
    assert owned1, "placement gave node 1 nothing; widen n_slices"
    return n_slices, owned1


class TestRemoteLegCharging:
    def test_fanout_charged_to_origin_tenant_on_remote_node(
        self, two_tenant_servers
    ):
        s0, s1 = two_tenant_servers
        n_slices, _ = _seed_distributed(s0, s1)
        status, _, body = _raw(
            s0.host, "/index/i/query", _Q, {"X-Api-Key": "goldkey"}
        )
        assert status == 200
        assert json.loads(body)["results"] == [n_slices]
        # Coordinator charged gold on the client lane...
        snap0 = s0.admission.tenants_snapshot()
        assert snap0["gold"]["admitted"] >= 1
        assert "point" in snap0["gold"]["classes"]
        # ...and the REMOTE node charged the forwarded tenant on the
        # internal lane — auto-created, since s1 never configured gold.
        snap1 = s1.admission.tenants_snapshot()
        assert snap1["gold"]["admitted"] >= 1
        assert snap1["gold"]["classes"]["internal"]["admitted"] >= 1

    def test_untagged_fanout_charges_default(self, two_tenant_servers):
        s0, s1 = two_tenant_servers
        n_slices, _ = _seed_distributed(s0, s1)
        status, _, body = _raw(s0.host, "/index/i/query", _Q)
        assert status == 200
        assert json.loads(body)["results"] == [n_slices]
        snap1 = s1.admission.tenants_snapshot()
        assert snap1["default"]["classes"]["internal"]["admitted"] >= 1


# ---------------------------------------------------------------------------
# a mixed cluster: a JAX coordinator and a port node
# ---------------------------------------------------------------------------


def _mixed(tmp_path, jax_token: str, port_token: str):
    """A JAX node (the coordinator: gold and its key configured) and a
    port node with a static ring of both; the tokens may differ."""
    from pilosa_tpu.cluster import topology as jtopo
    from pilosa_tpu.net.server import Server as JServer
    from pilosa_tpu.obs import stats as jstats

    hosts = _ring()
    jhost, thost = hosts
    c = jtopo.Cluster(replica_n=1)
    for h in hosts:
        c.add_node(h)
    j = JServer(data_dir=str(tmp_path / "j"), host=jhost, cluster=c,
                anti_entropy_interval=3600, polling_interval=3600, cache_flush_interval=3600,
                stats=jstats.ExpvarStatsClient(), retry_backoff_ms=10,
                tenants=["gold:4"], tenant_keys=["goldkey:gold"],
                tenant_internal_token=jax_token)
    j.open()
    t = Server(str(tmp_path / "t"), host=thost, hosts=hosts, stats=ExpvarStatsClient(),
               retry_backoff_ms=10, tenant_internal_token=port_token, **_QUIET)
    t.open()
    for s in (j, t):
        s.holder.create_index_if_not_exists("i")
        s.holder.index("i").create_frame_if_not_exists("f")
    owned_t = []
    for sl in range(6):
        owner = j.cluster.fragment_nodes("i", sl)[0].host
        assert owner == t.cluster.fragment_nodes("i", sl)[0].host
        srv = j if owner == jhost else t
        srv.holder.frame("i", "f").set_bit("standard", 1, sl * SLICE_WIDTH)
        if owner == thost:
            owned_t.append(sl)
    assert owned_t, "placement gave the port node nothing; widen the slices"
    for s in (j, t):
        s.holder.index("i").set_remote_max_slice(5)
    return j, t


class TestMixedCluster:
    def test_shared_token_charges_the_origin_tenant_on_the_port_node(self, tmp_path):
        j, t = _mixed(tmp_path, "fleet-tok", "fleet-tok")
        try:
            status, _, body = _raw(j.host, "/index/i/query", _Q, {"X-Api-Key": "goldkey"})
            assert status == 200
            assert json.loads(body)["results"] == [6]
            snap = t.admission.tenants_snapshot()
            assert snap["gold"]["classes"]["internal"]["admitted"] >= 1
            counts = t.stats.snapshot()["counts"]
            assert counts.get("net.admission.admitted[class:internal]", 0) >= 1
            assert counts.get("net.admission.tenantAdmitted[class:internal,tenant:gold]", 0) >= 1
        finally:
            t.close()
            j.close()

    def test_without_the_token_legs_are_client_traffic(self, tmp_path):
        j, t = _mixed(tmp_path, "jax-tok", "port-tok")
        try:
            status, _, body = _raw(j.host, "/index/i/query", _Q, {"X-Api-Key": "goldkey"})
            assert status == 200
            assert json.loads(body)["results"] == [6]
            snap = t.admission.tenants_snapshot()
            assert "gold" not in snap
            assert snap["default"]["classes"]["point"]["admitted"] >= 1
            assert "internal" not in snap["default"]["classes"]
            counts = t.stats.snapshot()["counts"]
            assert counts.get("net.admission.admitted[class:internal]", 0) == 0
        finally:
            t.close()
            j.close()
