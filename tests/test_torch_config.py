"""The port's configuration against the JAX package's.

``pilosa_tpu_torch/config.py`` is a copy of ``pilosa_tpu/config.py``: the
same TOML text for any ``Config`` (``to_toml``, the ``generate-config``
and ``config`` output), the same parse of any text, the same
``PILOSA_*`` environment, the same errors with the same messages, and
``flag > env > file > default`` through the port's ``server`` command.
``build_server`` hands every key to the port's ``Server``: a key added
to ``Config`` without a keyword fails ``test_every_key_reaches_the_server``.
"""

import dataclasses
import importlib
import inspect
import os
import string

import numpy as np
import pytest

pytest.importorskip("torch")

from pilosa_tpu import config as jconfig  # noqa: E402
from pilosa_tpu.cli import main as jmain  # noqa: E402
from pilosa_tpu_torch import config as tconfig  # noqa: E402
from pilosa_tpu_torch.cli.main import main as tmain  # noqa: E402

tcli = importlib.import_module("pilosa_tpu_torch.cli.main")


def leaves(cfg) -> list[tuple[str, object]]:
    """Every ``(dotted key, value)`` of a ``Config``."""
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out += [(f"{f.name}.{g.name}", getattr(v, g.name)) for g in dataclasses.fields(v)]
        else:
            out.append((f.name, v))
    return out


def set_dotted(cfg, dotted: str, value) -> None:
    *parents, leaf = dotted.split(".")
    obj = cfg
    for p in parents:
        obj = getattr(obj, p)
    setattr(obj, leaf, value)


def _word(rng, n: int = 8) -> str:
    return "".join(rng.choice(list(string.ascii_lowercase + string.digits), size=n))


def draw(rng, key: str, default):
    """A value of ``default``'s type for ``key``, valid or not (to_toml
    and from_toml do not validate)."""
    if key == "obs.latency_buckets_ms":
        return sorted({float(x) for x in rng.integers(1, 10_000, size=rng.integers(0, 5))})
    if key == "net.tenants":
        return [f"{_word(rng, 4)}:{rng.integers(1, 9)}:{rng.integers(0, 50)}"
                for _ in range(rng.integers(0, 4))]
    if key == "net.tenant_keys":
        return [f"{_word(rng)}:{_word(rng, 4)}" for _ in range(rng.integers(0, 3))]
    if isinstance(default, bool):
        return bool(rng.integers(0, 2))
    if isinstance(default, int):
        return int(rng.integers(0, 1 << 30))
    if isinstance(default, float):
        return float(rng.integers(0, 1 << 20)) / 8.0
    if isinstance(default, list):
        return [f"{_word(rng)}:{rng.integers(1, 65536)}" for _ in range(rng.integers(0, 4))]
    return _word(rng, int(rng.integers(0, 12)))


def random_pair(seed: int):
    """A JAX and a port ``Config`` with every key drawn, equal."""
    rng = np.random.default_rng(seed)
    j, t = jconfig.Config(), tconfig.Config()
    for key, default in leaves(t):
        v = draw(rng, key, default)
        set_dotted(j, key, v)
        set_dotted(t, key, list(v) if isinstance(v, list) else v)
    return j, t


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_default_toml_is_the_jax_text():
    assert tconfig.Config().to_toml() == jconfig.Config().to_toml()
    assert leaves(tconfig.Config()) == leaves(jconfig.Config())
    assert tconfig._KNOWN_KEYS == jconfig._KNOWN_KEYS


@pytest.mark.parametrize("seed", range(50))
def test_random_config_toml_is_the_jax_text(seed):
    j, t = random_pair(seed)
    assert t.to_toml() == j.to_toml()


@pytest.mark.parametrize("seed", range(50))
def test_jax_text_parses_to_equal_settings(seed):
    j, _ = random_pair(seed)
    text = j.to_toml()
    got, want = tconfig.from_toml(text), jconfig.from_toml(text)
    assert as_dict(got) == as_dict(want)
    assert got.to_toml() == text


def _env_value(typ, key: str, default) -> str:
    if typ == "csv":
        return "a:1, b:2,,c:3"
    if typ == "bool":
        return "off" if default else "on"
    if typ is int:
        return "7"
    if typ is float:
        return "2.5"
    if typ is str:
        return f"v-{key.lower()}"
    return "3, 1.5,, 12"  # the lambdas: lists of floats or of strings


@pytest.mark.parametrize("env_key", sorted(jconfig._ENV_MAP))
def test_env_key_gives_equal_settings(env_key):
    assert tconfig._ENV_MAP.keys() == jconfig._ENV_MAP.keys()
    dotted, typ = jconfig._ENV_MAP[env_key]
    assert tconfig._ENV_MAP[env_key][0] == dotted
    default = dict(leaves(tconfig.Config()))[dotted]
    environ = {env_key: _env_value(typ, env_key, default)}
    got = tconfig.apply_env(tconfig.Config(), environ)
    want = jconfig.apply_env(jconfig.Config(), environ)
    assert as_dict(got) == as_dict(want)
    assert as_dict(got) != as_dict(tconfig.Config())


def _raise_of(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("text", [
    "nope = 1\n",
    "[cluster]\nnope = 1\n",
    "[tpu]\ncompile = true\n",
    "[net]\nadmission-pointconcurrency = 3\n",
    "data-dir = \n",
    "[cluster\nreplicas = 2\n",
    "host = 'a'\nhost = 'b'\n",
])
def test_unknown_keys_and_bad_toml_raise_the_jax_error(text):
    got = _raise_of(lambda: tconfig.from_toml(text))
    want = _raise_of(lambda: jconfig.from_toml(text))
    assert want is not None and want[0] == "ConfigError"
    assert got == want


@pytest.mark.parametrize("text", [
    "[cluster]\nreplicas = \"two\"\n",
    "[net]\nretry-attempts = \"x\"\n",
    "[obs]\nslow-query-ms = \"fast\"\n",
    "[exec]\ncoalesce-max-batch = 1.5\n",
    "[net]\ntenants = \"gold:1\"\n",
])
def test_bad_types_fail_as_in_jax(text):
    def load(mod):
        cfg = mod.from_toml(text)
        cfg.validate()
        return cfg

    got, want = _raise_of(lambda: load(tconfig)), _raise_of(lambda: load(jconfig))
    assert got == want


# One invalid setting per validate() rule.
INVALID = [
    ("cluster.type", "mesh"), ("cluster.replicas", 0), ("net.stream_chunk_bytes", -1),
    ("net.query_timeout_ms", -1.0), ("net.broadcast_timeout_ms", 0.0),
    ("net.retry_attempts", 0), ("net.retry_backoff_ms", -1.0),
    ("net.breaker_failure_threshold", 0), ("net.breaker_open_ms", 0.0),
    ("net.admission_point_concurrency", 0), ("net.admission_heavy_concurrency", 0),
    ("net.admission_write_concurrency", 0), ("net.admission_internal_concurrency", 0),
    ("net.admission_subscribe_concurrency", 0), ("net.admission_queue_depth", -1),
    ("net.tenants", ["gold:x"]), ("net.tenants", [":3"]), ("net.tenant_keys", ["nokey"]),
    ("net.tenant_keys", ["k:ghost"]), ("net.tenant_default", ""),
    ("cluster.rebalance_throttle_mbps", -1.0), ("cluster.rebalance_verify_rounds", 0),
    ("cluster.rebalance_delta_cap", 0), ("cluster.rebalance_release_delay_ms", -1.0),
    ("cluster.write_consistency", "most"), ("cluster.read_consistency", "any"),
    ("cluster.hint_cap", 0), ("cluster.hint_replay_throttle_mbps", -1.0),
    ("gossip.ack_timeout_ms", 0.0), ("gossip.stream_timeout_ms", 0.0),
    ("obs.slow_query_ms", -1.0), ("obs.trace_ring", 0), ("obs.latency_buckets_ms", [0.0]),
    ("obs.latency_buckets_ms", [5.0, 1.0]), ("obs.latency_buckets_ms", [1.0, 1.0]),
    ("obs.slo_ms", -1.0), ("obs.slo_objective", 1.0), ("device.mesh_devices", -1),
    ("device.hbm_budget_bytes", -1), ("device.stage_throttle_ms", -1.0),
    ("device.launch_watchdog_ms", -1.0), ("device.quarantine_threshold", 0),
    ("device.quarantine_open_ms", 0.0), ("device.quarantine_probe_successes", 0),
    ("device.plane_format", "sparse"), ("device.plane_sparse_max_bytes", -1),
    ("device.plane_rle_max_bytes", -1), ("tier.hydrate_throttle_mbps", -1.0),
    ("tier.disk_budget_bytes", -1), ("tier.retention_age_s", -1.0),
    ("tier.retention_delete_s", -1.0), ("tier.sweep_interval_s", 0.0),
    ("tier.retention_delete_s", 5.0), ("subscribe.max_subscriptions", 0),
    ("subscribe.queue_cap", 0), ("subscribe.delta_cap", 0), ("subscribe.coalesce_ms", -1.0),
    ("subscribe.refresh_interval_ms", 0.0), ("ingest.group_commit_ms", -1.0),
    ("ingest.group_commit_max", 0), ("ingest.wal_segment_bytes", 0),
    ("exec.coalesce_max_batch", 0), ("exec.coalesce_max_wait_us", -1),
    ("exec.fuse_max_programs", 0),
]


@pytest.mark.parametrize("key,value", INVALID, ids=[f"{k}={v}" for k, v in INVALID])
def test_validate_raises_the_jax_message(key, value):
    errs = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        set_dotted(cfg, key, value)
        with pytest.raises(mod.ConfigError) as ei:
            cfg.validate()
        errs.append(str(ei.value))
    assert errs[1] == errs[0]


def test_retention_order_and_store_rules_match():
    for age, delete, store in ((10.0, 5.0, "s"), (0.0, 5.0, "")):
        errs = []
        for mod in (jconfig, tconfig):
            cfg = mod.Config()
            cfg.tier.retention_age_s, cfg.tier.retention_delete_s = age, delete
            cfg.tier.store = store
            errs.append(_raise_of(cfg.validate))
        assert errs[0] is not None and errs[1] == errs[0]


def test_use_pallas_is_accepted_and_ignored():
    text = "[tpu]\nuse-pallas = true\n"
    got = tconfig.from_toml(text)
    assert as_dict(got) == as_dict(jconfig.from_toml(text)) == as_dict(tconfig.Config())
    got.validate()


def test_flag_over_env_over_file_over_default(tmp_path, monkeypatch):
    path = tmp_path / "pilosa.toml"
    path.write_text(
        'data-dir = "/from/file"\nhost = "file:1"\n'
        "[cluster]\nreplicas = 3\nhint-cap = 77\n"
        "[exec]\ncoalesce = false\n"
        "[net]\nadmission-queue-depth = 9\n"
    )
    environ = {"PILOSA_HOST": "env:2", "PILOSA_CLUSTER_REPLICAS": "2",
               "PILOSA_NET_ADMISSION_QUEUE_DEPTH": "4"}
    overrides = {"cluster.replicas": 5, "host": None}
    for mod in (jconfig, tconfig):
        cfg = mod.load(str(path), environ=environ, overrides=overrides)
        assert cfg.data_dir == "/from/file"                    # file
        assert cfg.host == "env:2"                             # env over file
        assert cfg.cluster.replicas == 5                       # flag over env
        assert cfg.cluster.hint_cap == 77                      # file over default
        assert cfg.exec.coalesce is False
        assert cfg.net.admission_queue_depth == 4
        assert cfg.net.admission_point_concurrency == 32       # default
    # Through the port's server command: the flags are the overrides.
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    args = tcli.build_parser().parse_args(
        ["server", "-c", str(path), "--replicas", "5", "-d", "/from/flag", "--coalesce", "true"])
    cfg = tcli.load_config(args)
    assert (cfg.data_dir, cfg.host, cfg.cluster.replicas, cfg.cluster.hint_cap,
            cfg.exec.coalesce, cfg.net.admission_queue_depth) == (
        "/from/flag", "env:2", 5, 77, True, 4)


def _cli(main, argv, capsys):
    code = main(argv)
    cap = capsys.readouterr()
    return code, cap.out


def test_generate_config_is_the_jax_output(capsys):
    j = _cli(jmain, ["generate-config"], capsys)
    t = _cli(tmain, ["generate-config"], capsys)
    assert t == j and j[0] == 0 and j[1] == jconfig.Config().to_toml()


@pytest.mark.parametrize("seed", range(3))
def test_config_command_is_the_jax_output(tmp_path, capsys, monkeypatch, seed):
    for k in list(jconfig._ENV_MAP):
        monkeypatch.delenv(k, raising=False)
    j, _ = random_pair(100 + seed)
    # A file that validates: the drawn values of the validated keys set
    # back to the defaults.
    ok = jconfig.Config()
    for key, value in leaves(j):
        set_dotted(ok, key, value)
        try:
            ok.validate()
        except (jconfig.ConfigError, TypeError):
            set_dotted(ok, key, dict(leaves(jconfig.Config()))[key])
    ok.validate()
    path = tmp_path / "pilosa.toml"
    path.write_text(ok.to_toml())
    got = _cli(tmain, ["config", "-c", str(path)], capsys)
    want = _cli(jmain, ["config", "-c", str(path)], capsys)
    assert got == want and want == (0, ok.to_toml())
    monkeypatch.setenv("PILOSA_NET_TENANT_DEFAULT", "")
    got = (tmain(["config", "-c", str(path)]), capsys.readouterr().err)
    want = (jmain(["config", "-c", str(path)]), capsys.readouterr().err)
    assert got == want == (1, "error: net tenant-default must be non-empty\n")


def test_config_error_prints_error_and_exits_1(tmp_path, capsys):
    path = tmp_path / "bad.toml"
    path.write_text("[cluster]\nbogus = 1\n")
    for argv in (["config", "-c", str(path)],
                 ["server", "-c", str(path), "--device", "cpu", "--dry-run"]):
        got = (tmain(argv), capsys.readouterr().err)
        assert got == (1, "error: unknown config key: 'cluster.bogus'\n")
    got = (tmain(["warm", "-c", str(path), "--device", "cpu"]), capsys.readouterr().err)
    assert got[0] == 1


def test_server_dry_run_exits_0(tmp_path, capsys):
    path = tmp_path / "pilosa.toml"
    path.write_text(f'data-dir = "{tmp_path / "data"}"\nhost = "127.0.0.1:0"\n'
                    "[obs]\nfloor-probe = false\n")
    assert tmain(["server", "-c", str(path), "--device", "cpu", "--dry-run"]) == 0
    assert "dry-run: config ok" in capsys.readouterr().err


def test_warm_builds_and_launches(tmp_path, capsys):
    path = tmp_path / "pilosa.toml"
    path.write_text("[exec]\ncoalesce = false\n")
    assert tmain(["warm", "-c", str(path), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert err.startswith("warmed ") and " kernel launches in " in err


# Each key of the file and the Server keyword it reaches; None: it acts
# before the Server (the log, the stats client, the mesh environment), or,
# for compilation-cache-dir, nowhere in the port.
REACHES = {
    "data_dir": "data_dir", "host": "host", "log_path": None,
    "max_writes_per_request": "max_writes_per_request",
    "anti_entropy_interval": "anti_entropy_interval",
    "cluster.replicas": "replicas", "cluster.type": "cluster_type", "cluster.hosts": "hosts",
    "cluster.internal_hosts": "internal_hosts", "cluster.polling_interval": "polling_interval",
    "cluster.internal_port": "internal_port", "cluster.gossip_seed": "gossip_seed",
    "cluster.long_query_time": "long_query_time",
    "cluster.rebalance_throttle_mbps": "rebalance_throttle_mbps",
    "cluster.rebalance_verify_rounds": "rebalance_verify_rounds",
    "cluster.rebalance_delta_cap": "rebalance_delta_cap",
    "cluster.rebalance_release_delay_ms": "rebalance_release_delay_ms",
    "cluster.rebalance_on_join": "rebalance_on_join",
    "cluster.write_consistency": "write_consistency",
    "cluster.read_consistency": "read_consistency", "cluster.hint_cap": "hint_cap",
    "cluster.hint_replay_throttle_mbps": "hint_replay_throttle_mbps",
    "metrics.service": None, "metrics.host": None,
    "obs.slow_query_ms": "slow_query_ms", "obs.trace_ring": "trace_ring",
    "obs.latency_buckets_ms": "latency_buckets_ms", "obs.slo_ms": "slo_ms",
    "obs.slo_objective": "slo_objective", "obs.floor_probe": "floor_probe",
    "net.stream_chunk_bytes": "stream_chunk_bytes", "net.query_timeout_ms": "query_timeout_ms",
    "net.broadcast_timeout_ms": "broadcast_timeout_ms",
    "net.retry_attempts": "retry_attempts", "net.retry_backoff_ms": "retry_backoff_ms",
    "net.breaker_failure_threshold": "breaker_failure_threshold",
    "net.breaker_open_ms": "breaker_open_ms", "net.admission": "admission",
    "net.admission_point_concurrency": "admission_point_concurrency",
    "net.admission_heavy_concurrency": "admission_heavy_concurrency",
    "net.admission_write_concurrency": "admission_write_concurrency",
    "net.admission_internal_concurrency": "admission_internal_concurrency",
    "net.admission_queue_depth": "admission_queue_depth",
    "net.admission_subscribe_concurrency": "admission_subscribe_concurrency",
    "net.tenants": "tenants", "net.tenant_keys": "tenant_keys",
    "net.tenant_default": "tenant_default", "net.tenant_internal_token": "tenant_internal_token",
    "gossip.ack_timeout_ms": "gossip_ack_timeout_ms",
    "gossip.stream_timeout_ms": "gossip_stream_timeout_ms",
    "device.mesh_devices": "mesh_devices", "device.hbm_budget_bytes": "hbm_budget_bytes",
    "device.prefetch": "device_prefetch", "device.stage": "device_stage",
    "device.stage_throttle_ms": "stage_throttle_ms",
    "device.launch_watchdog_ms": "launch_watchdog_ms",
    "device.quarantine_threshold": "quarantine_threshold",
    "device.quarantine_open_ms": "quarantine_open_ms",
    "device.quarantine_probe_successes": "quarantine_probe_successes",
    "device.plane_format": "plane_format",
    "device.plane_sparse_max_bytes": "plane_sparse_max_bytes",
    "device.plane_rle_max_bytes": "plane_rle_max_bytes",
    "tier.store": "tier_store", "tier.hydrate_throttle_mbps": "tier_hydrate_throttle_mbps",
    "tier.disk_budget_bytes": "tier_disk_budget_bytes",
    "tier.retention_age_s": "tier_retention_age_s",
    "tier.retention_delete_s": "tier_retention_delete_s",
    "tier.sweep_interval_s": "tier_sweep_interval_s",
    "subscribe.enabled": "subscribe_enabled",
    "subscribe.max_subscriptions": "subscribe_max_subscriptions",
    "subscribe.queue_cap": "subscribe_queue_cap", "subscribe.delta_cap": "subscribe_delta_cap",
    "subscribe.coalesce_ms": "subscribe_coalesce_ms",
    "subscribe.refresh_interval_ms": "subscribe_refresh_ms",
    "ingest.wal": "ingest_wal", "ingest.group_commit_ms": "ingest_group_commit_ms",
    "ingest.group_commit_max": "ingest_group_commit_max", "ingest.scatter": "ingest_scatter",
    "ingest.wal_segment_bytes": "ingest_wal_segment_bytes",
    "exec.coalesce": "coalesce", "exec.coalesce_max_batch": "coalesce_max_batch",
    "exec.coalesce_max_wait_us": "coalesce_max_wait_us", "exec.fuse": "fuse",
    "exec.fuse_max_programs": "fuse_max_programs",
    "tpu.mesh_shape": None, "tpu.compilation_cache_dir": None, "tpu.prewarm": "prewarm",
}


def test_every_key_reaches_the_server(monkeypatch, tmp_path):
    from pilosa_tpu_torch.net import server as server_mod

    assert set(REACHES) == {k for k, _ in leaves(tconfig.Config())}
    seen = {}

    class Capture:
        def __init__(self, **kw):
            seen.update(kw)

    monkeypatch.setattr(server_mod, "Server", Capture)
    # build_server writes the mesh shape into os.environ: this records the
    # variable's state so that undo() puts it back.
    monkeypatch.setenv("PILOSA_TPU_MESH_SHAPE", "")
    _, cfg = random_pair(7)
    cfg.cluster.internal_hosts = cfg.cluster.hosts[:]
    cfg.log_path = str(tmp_path / "node.log")
    cfg.metrics.service, cfg.metrics.host = "expvar", ""
    cfg.tpu.mesh_shape = "2x2"
    tcli.build_server(cfg, device="cpu")
    for key, value in leaves(cfg):
        kw = REACHES[key]
        if kw is None:
            continue
        want = os.path.expanduser(value) if key == "data_dir" else value
        if key == "obs.latency_buckets_ms":
            want = value or None
        if key == "cluster.internal_hosts":
            want = value or None
        assert seen[kw] == want, key
    assert seen["device"] == "cpu"
    assert "compilation_cache_dir" not in seen
    assert os.environ["PILOSA_TPU_MESH_SHAPE"] == "2x2"
    seen["logger"]("one line")
    assert (tmp_path / "node.log").read_text() == "one line\n"
    assert type(seen["stats"]).__name__ == "ExpvarStatsClient"
    # Every keyword build_server passes is one the real Server takes.
    monkeypatch.undo()
    assert "PILOSA_TPU_MESH_SHAPE" not in os.environ or os.environ["PILOSA_TPU_MESH_SHAPE"] != "2x2"
    real = inspect.signature(server_mod.Server.__init__).parameters
    assert set(seen) <= set(real), set(seen) - set(real)
