"""The port's device health (``pilosa_tpu_torch/device/health.py``) and
fault grammar (``pilosa_tpu_torch/testing/faults.py``), case for case as
``tests/test_device_health.py`` holds the JAX package's: classification
(and that torch's build, load and argument errors are no device fault),
the threshold and the half-open probe, a failed probe re-arming the
clock, a hang quarantining at once, a fault narrowed to one device, the
state-change callback, the watchdog and ``run_collective``, and the
``kind=`` / per-device grammar.  Each case runs against both packages'
modules, which must agree."""

import subprocess
import time

import pytest

torch = pytest.importorskip("torch")

from pilosa_tpu.device import health as jhealth  # noqa: E402
from pilosa_tpu.exec import plan as jplan  # noqa: E402,F401 — imported before a watched body needs it
from pilosa_tpu.net import resilience as rz  # noqa: E402
from pilosa_tpu.testing import faults as jfaults  # noqa: E402
from pilosa_tpu_torch.device import health as thealth  # noqa: E402
from pilosa_tpu_torch.ops._build import KernelBuildError  # noqa: E402
from pilosa_tpu_torch.testing import faults as tfaults  # noqa: E402

PKGS = pytest.mark.parametrize(
    "health,faults", [(thealth, tfaults), (jhealth, jfaults)], ids=["torch", "jax"]
)


class _Stats:
    def __init__(self):
        self.counts: dict = {}

    def count(self, name, value=1, rate=1.0):
        self.counts[name] = self.counts.get(name, 0) + value

    def count_with_custom_tags(self, name, value, tags):
        key = name + "".join(f"[{t}]" for t in sorted(tags))
        self.counts[key] = self.counts.get(key, 0) + value

    def gauge(self, *a, **k):
        pass

    def histogram(self, *a, **k):
        pass


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


@PKGS
def test_classify_kinds(health, faults):
    assert health.classify(health.LaunchWatchdogTimeout("x")) == health.KIND_HANG
    assert health.classify(faults.FaultOOM("injected oom")) == health.KIND_OOM
    assert health.classify(faults.FaultError("injected")) == health.KIND_ERROR
    assert health.classify(RuntimeError("RESOURCE_EXHAUSTED: out of memory")) == health.KIND_OOM
    # Non-device exceptions must re-raise at the launch sites.
    assert health.classify(ValueError("bad frame")) is None
    assert health.classify(rz.DeadlineExceeded("budget")) is None
    assert health.classify(KeyError("x")) is None


def _accelerator_error(msg):
    cls = getattr(torch, "AcceleratorError", None)
    if cls is None:
        pytest.skip("this torch has no AcceleratorError")
    return cls(msg)


@pytest.mark.parametrize("exc,kind", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB"), "oom"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "oom"),
    # A kernel's own fault on the card is no device fault: it leaves the
    # context unusable, so its query fails instead of moving to the host.
    ("accel", None),
    ("accel-oom", "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
], ids=["OutOfMemoryError", "cuda.OutOfMemoryError", "AcceleratorError",
        "AcceleratorError-oom", "RuntimeError-oom-text"])
def test_classify_torch_device_errors(exc, kind):
    if exc == "accel":
        exc = _accelerator_error("CUDA error: an illegal memory access was encountered")
    elif exc == "accel-oom":
        exc = _accelerator_error("CUDA error: out of memory")
    assert thealth.classify(exc) == kind


@pytest.mark.parametrize("exc", [
    KernelBuildError("tree_eval: nvcc exited 1\nfatal error: out of memory"),
    RuntimeError("Error building extension 'tree_eval': out of memory"),
    ImportError("libcudart.so.12: cannot open shared object file"),
    OSError("build/torch_kernels/tree_eval-0.so: cannot open shared object file"),
    subprocess.CalledProcessError(1, ["nvcc"], output="out of memory"),
    ValueError("a row table's leaves must be int32 [n, 32768]"),
    TypeError("tree_eval() takes 3 positional arguments"),
    RuntimeError("tree_eval launch failed: cudaError 9"),
    IndexError("slot 9 out of range"),
], ids=["KernelBuildError", "cpp_extension", "ImportError", "OSError", "CalledProcessError",
        "ValueError", "TypeError", "RuntimeError", "IndexError"])
def test_classify_build_load_and_argument_errors_are_not_device_faults(exc):
    assert thealth.classify(exc) is None


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------


@PKGS
def test_quarantine_threshold_and_halfopen_probe_recovery(health, faults):
    h = health.DeviceHealth(quarantine_threshold=2, open_ms=80, probe_successes=2,
                            watchdog_ms=0)
    p = ["device:0"]
    assert h.acquire(p) == health.MODE_OK
    h.failure(p, health.KIND_ERROR)
    assert h.snapshot()["paths"]["device:0"]["state"] == health.STATE_SUSPECT
    assert h.acquire(p) == health.MODE_OK  # suspect still launches
    h.failure(p, health.KIND_ERROR)
    assert h.snapshot()["paths"]["device:0"]["state"] == health.STATE_QUARANTINED
    assert h.degraded() and h.snapshot()["degraded"]
    assert h.acquire(p) == health.MODE_DENY
    time.sleep(0.1)
    # Past the open window: exactly ONE probe is admitted.
    assert h.acquire(p) == health.MODE_PROBE
    assert h.acquire(p) == health.MODE_DENY  # probe exclusive
    # probe_successes=2: still quarantined, the next probe at once.
    h.success(p, probe=True)
    assert h.snapshot()["paths"]["device:0"]["state"] == health.STATE_QUARANTINED
    assert h.acquire(p) == health.MODE_PROBE
    h.success(p, probe=True)
    assert h.snapshot()["paths"]["device:0"]["state"] == health.STATE_HEALTHY
    assert h.acquire(p) == health.MODE_OK
    assert not h.degraded()


@PKGS
def test_failed_probe_rearms_quarantine_clock(health, faults):
    h = health.DeviceHealth(quarantine_threshold=1, open_ms=60, watchdog_ms=0)
    p = ["device:0"]
    h.failure(p, health.KIND_OOM)
    assert h.acquire(p) == health.MODE_DENY
    time.sleep(0.08)
    assert h.acquire(p) == health.MODE_PROBE
    h.failure(p, health.KIND_OOM, probe=True)
    assert h.acquire(p) == health.MODE_DENY  # clock re-armed
    time.sleep(0.08)
    assert h.acquire(p) == health.MODE_PROBE


@PKGS
def test_hang_quarantines_immediately_and_success_resets_suspect(health, faults):
    h = health.DeviceHealth(quarantine_threshold=5, open_ms=1000, watchdog_ms=0)
    p = ["device:0"]
    h.failure(p, health.KIND_ERROR)
    h.success(p)
    assert h.snapshot()["paths"]["device:0"]["state"] == health.STATE_HEALTHY
    assert h.snapshot()["paths"]["device:0"]["consecutiveFailures"] == 0
    h.failure(p, health.KIND_HANG)  # one hang is enough
    assert h.snapshot()["paths"]["device:0"]["state"] == health.STATE_QUARANTINED


@PKGS
def test_failure_with_fault_device_narrows_blame(health, faults):
    h = health.DeviceHealth(quarantine_threshold=1, watchdog_ms=0)
    h.failure(["device:0", "device:1"], health.KIND_ERROR, device=1)
    snap = h.snapshot()["paths"]
    assert snap["device:1"]["state"] == health.STATE_QUARANTINED
    assert "device:0" not in snap or snap["device:0"]["state"] == health.STATE_HEALTHY


@PKGS
def test_state_change_callback_fires_on_quarantine_and_heal(health, faults):
    events = []
    h = health.DeviceHealth(quarantine_threshold=1, open_ms=40, watchdog_ms=0,
                            on_state_change=lambda p, s: events.append((p, s)))
    h.failure(["device:0"], health.KIND_ERROR)
    time.sleep(0.06)
    assert h.acquire(["device:0"]) == health.MODE_PROBE
    h.success(["device:0"], probe=True)
    assert events == [("device:0", health.STATE_QUARANTINED), ("device:0", health.STATE_HEALTHY)]


@pytest.mark.parametrize("device,path", [(None, "device:0"), ("cpu", "device:0"),
                                         (torch.device("cuda", 3), "device:3")])
def test_device_path_is_the_cards_ordinal(device, path):
    assert thealth.DeviceHealth(watchdog_ms=0, device=device).device_paths() == [path]


def test_snapshot_and_gauges_match_jax_in_the_same_state():
    snaps = []
    for health in (thealth, jhealth):
        h = health.DeviceHealth(quarantine_threshold=2, open_ms=3_600_000, watchdog_ms=0)
        h.failure(["device:0"], health.KIND_ERROR)
        h.failure(["device:0"], health.KIND_OOM)
        h.failure([health.COLLECTIVE], health.KIND_HANG)
        snap = h.snapshot()
        for st in snap["paths"].values():
            st.pop("sinceQuarantineMs", None)
        snaps.append((snap, h.gauges()))
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------


@PKGS
def test_watchdog_trips_and_abandons_then_recovers(health, faults):
    stats = _Stats()
    r = health._WatchdogRunner(stats=stats)
    try:
        with pytest.raises(health.LaunchWatchdogTimeout):
            r.run(lambda: time.sleep(0.4) or "late", timeout_s=0.05)
        # A fresh runner serves the next call while the old one sleeps.
        assert r.run(lambda: "ok", timeout_s=5.0) == "ok"
        time.sleep(0.45)
        assert stats.counts.get("device.watchdog.abandonedCompletions") == 1
    finally:
        r.close()


@PKGS
def test_run_collective_hang_trips_watchdog_and_quarantines_collective_path(health, faults):
    stats = _Stats()
    h = health.DeviceHealth(watchdog_ms=60, open_ms=50, stats=stats)
    try:
        with pytest.raises(health.LaunchWatchdogTimeout):
            h.run_collective(lambda: time.sleep(0.3))
        assert stats.counts.get("device.watchdogTrips") == 1
        assert h.snapshot()["paths"][health.COLLECTIVE]["state"] == health.STATE_QUARANTINED
        assert not h.collective_allowed()
        with pytest.raises(health.CollectiveUnavailable):
            h.run_collective(lambda: "never runs")
        # Past the open window the next collective IS the probe; the
        # abandoned sleeper releases the lock first.
        time.sleep(0.3)
        assert h.collective_allowed()
        assert h.run_collective(lambda: 42) == 42
        assert h.snapshot()["paths"][health.COLLECTIVE]["state"] == health.STATE_HEALTHY
    finally:
        h.close()


@PKGS
def test_run_collective_error_counts_against_collective_path(health, faults):
    h = health.DeviceHealth(watchdog_ms=0, quarantine_threshold=1)
    with pytest.raises(faults.FaultError):
        h.run_collective(lambda: (_ for _ in ()).throw(faults.FaultError("x")))
    assert h.snapshot()["paths"][health.COLLECTIVE]["state"] == health.STATE_QUARANTINED
    # Non-device exceptions propagate unrecorded.
    h2 = health.DeviceHealth(watchdog_ms=0, quarantine_threshold=1)
    with pytest.raises(ValueError):
        h2.run_collective(lambda: (_ for _ in ()).throw(ValueError("x")))
    assert health.COLLECTIVE not in h2.snapshot()["paths"] or (
        h2.snapshot()["paths"][health.COLLECTIVE]["state"] == health.STATE_HEALTHY
    )


def test_run_collective_build_error_is_not_counted():
    h = thealth.DeviceHealth(watchdog_ms=0, quarantine_threshold=1)
    with pytest.raises(KernelBuildError):
        h.run_collective(lambda: (_ for _ in ()).throw(KernelBuildError("nvcc not found")))
    assert not h.degraded()


# ---------------------------------------------------------------------------
# fault grammar
# ---------------------------------------------------------------------------


@PKGS
def test_fault_kind_grammar_and_validation(health, faults):
    plan = faults.parse("device.launch:kind=oom,times=1")
    with pytest.raises(faults.FaultOOM):
        plan.check("device.launch")
    plan.check("device.launch")  # times exhausted
    with pytest.raises(faults.FaultSpecError):
        faults.parse("device.launch:kind=frobnicate")
    with pytest.raises(faults.FaultSpecError):
        faults.parse("rpc.send:kind=oom")
    with pytest.raises(faults.FaultSpecError):
        faults.parse("rpc.recv:device=1")


@PKGS
def test_fault_per_device_matching(health, faults):
    plan = faults.parse("device.launch:kind=error,device=3")
    plan.check("device.launch", device=2)  # no fire
    plan.check("device.launch")  # no device info: no fire
    with pytest.raises(faults.FaultError):
        plan.check("device.launch", device=3)
    assert plan.rules[0].hits == 1


@PKGS
def test_fault_hang_sleeps_then_returns(health, faults):
    plan = faults.parse("device.launch:kind=hang,delay-ms=30,times=1")
    t0 = time.monotonic()
    plan.check("device.launch")  # returns (after the sleep), no raise
    assert time.monotonic() - t0 >= 0.025


SPECS = [
    "rpc.send:host=127.0.0.1:5001,path=/index/*/query,nth=1,mode=error;"
    "rpc.recv:path=/index/*/query,mode=delay,delay-ms=100,times=1;"
    "device.launch:kind=oom,device=3,times=4",
    "gossip.send:prob=0.25,seed=9,mode=drop,after-ms=5,until-ms=900",
    "device.launch:path=topn,kind=error,host=127.0.0.1:1",
]


@pytest.mark.parametrize("spec", SPECS, ids=["three-stages", "gossip", "topn"])
def test_every_stage_parses_as_in_jax(spec):
    assert tfaults.parse(spec).snapshot() == jfaults.parse(spec).snapshot()


@pytest.mark.parametrize("spec", ["device.launch", "device.launch:mode", "bogus:nth=x",
                                  "device.launch:colour=red", "device.launch:until-ms=1,after-ms=2"])
def test_bad_specs_fail_loudly(spec):
    with pytest.raises(tfaults.FaultSpecError):
        tfaults.parse(spec)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.parse(spec)


def test_env_plan_is_read_lazily_and_install_clear_reset(monkeypatch):
    monkeypatch.setenv("PILOSA_FAULTS", "device.launch:kind=error,times=1")
    tfaults.reset()
    try:
        with pytest.raises(tfaults.FaultError):
            tfaults.check("device.launch", path="direct")
        tfaults.check("device.launch", path="direct")  # times exhausted
        plan = tfaults.install("device.launch:path=topn,kind=oom")
        tfaults.check("device.launch", path="direct")
        with pytest.raises(tfaults.FaultOOM):
            tfaults.check("device.launch", path="topn")
        assert tfaults.active() is plan and plan.rules[0].hits == 1
        tfaults.clear()
        assert tfaults.active() is None
        tfaults.check("device.launch", path="topn")
    finally:
        tfaults.reset()
        monkeypatch.delenv("PILOSA_FAULTS")
        tfaults.clear()
