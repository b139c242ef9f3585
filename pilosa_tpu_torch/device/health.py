"""Device health — the card's own fault domain.

The port's copy of ``pilosa_tpu/device/health.py``: a breaker for each
launch path plus a watchdog for hung cross-device launches, so that a
misbehaving card degrades the node to the host (numpy) evaluator
(``exec/hosteval.py``) instead of failing its queries:

* **Classification.**  :func:`classify` maps a launch exception to a
  failure kind — ``oom``, ``hang`` (a watchdog trip), ``error`` — or
  None for exceptions that are not device faults at all, which the
  launch sites re-raise unchanged.  This is where the port differs from
  the JAX package, which lets its own runtime's errors through by
  module: here the injected faults, :class:`LaunchWatchdogTimeout`,
  ``torch.OutOfMemoryError`` and an out-of-memory error in any other
  form (``oom``: a ``torch.AcceleratorError`` or ``RuntimeError`` whose
  text carries an out-of-memory marker) count.  Any other error from the
  card — an illegal address or a failed launch of a hand-written kernel,
  which leaves the CUDA context unusable — is not one: it fails its
  query loudly instead of moving the work to the host while the data is
  on the card.  A kernel that fails to build or to load and a wrapper's
  shape or argument error are never device faults either: the health
  gate must not turn a broken kernel into a quiet host answer.

* **State machine.**  Each path — ``device:<ordinal>`` for the node's
  card, plus ``collective`` for cross-device launches — moves healthy →
  suspect (first failure) → quarantined (``quarantine_threshold``
  consecutive failures, or ONE hang).  A quarantined path denies
  launches (callers answer from the host planes, byte for byte) until
  ``open_ms`` elapses, then admits exactly one half-open PROBE launch;
  ``probe_successes`` successful probes heal it (and fire
  ``on_state_change`` — the server stages the mirrors again), a failed
  probe re-arms the quarantine clock.

* **Watchdog.**  :meth:`DeviceHealth.run_collective` runs a
  cross-device dispatch+fetch on a dedicated runner thread and waits at
  most ``watchdog_ms``: a hang trips :class:`LaunchWatchdogTimeout`
  (counted as ``device.watchdogTrips``), quarantines the ``collective``
  path, and the caller falls back to the per-device launch or the host
  evaluator — the process never wedges.  The hung runner thread is
  abandoned (its eventual completion is discarded and counted) and a
  fresh runner serves the next collective.  No port launch crosses
  devices yet: the cross-device Count/TopN will run through it.

Surfaced at ``GET /debug/health`` (``device`` section) and ``/metrics``
(``device.health.*`` gauges, ``device.watchdogTrips``); the server sets
its node's ``degraded`` flag from it, and coordinators prefer a
non-degraded replica (``executor._slices_by_node``).
"""

from __future__ import annotations

import queue
import threading
import time

STATE_HEALTHY = "healthy"
STATE_SUSPECT = "suspect"
STATE_QUARANTINED = "quarantined"

KIND_OOM = "oom"
KIND_ERROR = "error"
KIND_HANG = "hang"

MODE_OK = "ok"
MODE_PROBE = "probe"
MODE_DENY = "deny"

# The cross-device launch path is tracked as its own breaker path: a
# hang there indicts the collective rendezvous, not the devices —
# single-device and host execution keep working.
COLLECTIVE = "collective"

DEFAULT_QUARANTINE_THRESHOLD = 3
DEFAULT_OPEN_MS = 10_000.0
DEFAULT_PROBE_SUCCESSES = 1
DEFAULT_WATCHDOG_MS = 60_000.0

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OUT_OF_MEMORY")

# One collective launch in flight per process: the body of
# :meth:`DeviceHealth.run_collective` holds it on the runner thread.
_COLLECTIVE_MU = threading.Lock()


class LaunchWatchdogTimeout(RuntimeError):
    """A device launch exceeded the watchdog deadline — the shape of a
    hung collective rendezvous or a wedged device runtime."""


class CollectiveUnavailable(RuntimeError):
    """The collective launch path is quarantined; callers fall back to
    the per-slice (non-collective) launch or the host evaluator."""


def _build_or_load_error(exc: BaseException) -> bool:
    """A kernel that failed to build or to load: never a device fault,
    whatever its text says (a compiler's log may well mention memory)."""
    import subprocess

    from pilosa_tpu_torch.ops._build import KernelBuildError

    if isinstance(exc, (ImportError, OSError, subprocess.CalledProcessError,
                        KernelBuildError)):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("Error building extension")


def classify(exc: BaseException) -> str | None:
    """Failure kind of a device-launch exception, or None when the
    exception is NOT a device fault (a build or load error, a wrapper's
    argument error, a deadline, anything else) and must propagate
    unchanged.

    The allowlist is deliberately narrow: the watchdog's own timeout,
    the chaos layer's injected faults, ``torch.OutOfMemoryError``, and a
    ``torch.AcceleratorError`` or ``RuntimeError`` carrying an
    out-of-memory marker — anything else, a kernel's own failure on the
    card included, fails the query loudly rather than rerouting a fault
    of the program through the host path."""
    if isinstance(exc, LaunchWatchdogTimeout):
        return KIND_HANG
    from pilosa_tpu_torch.testing import faults

    if isinstance(exc, faults.FaultOOM):
        return KIND_OOM
    if isinstance(exc, faults.FaultError):
        return KIND_ERROR
    if _build_or_load_error(exc):
        return None
    import torch

    oom = getattr(torch, "OutOfMemoryError", None) or torch.cuda.OutOfMemoryError
    if isinstance(exc, oom):
        return KIND_OOM
    # torch.AcceleratorError is a RuntimeError.
    if isinstance(exc, RuntimeError) and any(m in str(exc) for m in _OOM_MARKERS):
        return KIND_OOM
    return None


class _PathState:
    __slots__ = (
        "state",
        "failures",
        "opens",
        "quarantined_at",
        "probing",
        "probe_ok",
        "last_kind",
        "kinds",
    )

    def __init__(self):
        self.state = STATE_HEALTHY
        self.failures = 0  # consecutive
        self.opens = 0
        self.quarantined_at = 0.0
        self.probing = False
        self.probe_ok = 0
        self.last_kind = ""
        self.kinds: dict[str, int] = {}

    def snapshot(self, now: float) -> dict:
        out = {
            "state": self.state,
            "consecutiveFailures": self.failures,
            "quarantines": self.opens,
        }
        if self.last_kind:
            out["lastKind"] = self.last_kind
        if self.kinds:
            out["failures"] = dict(self.kinds)
        if self.state == STATE_QUARANTINED:
            out["sinceQuarantineMs"] = round(
                (now - self.quarantined_at) * 1000.0, 1
            )
            out["probing"] = self.probing
        return out


class _WatchdogRunner:
    """Runs collective launch bodies on a dedicated daemon thread with a
    wait deadline.  A timed-out body is ABANDONED: its generation goes
    stale, its eventual completion (or error) is discarded and counted,
    and the next submission spawns a fresh runner — so one wedged
    collective can never hold the watchdog hostage.  (The abandoned
    thread may still hold the process collective-launch mutex until the
    wedged call returns; that is exactly the window the quarantine
    covers — no new collective launches are attempted until a probe,
    by which time a recovered backend has released it.)"""

    def __init__(self, stats=None, name: str = "device-watchdog"):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.stats = stats or NopStatsClient()
        self._name = name
        self._mu = threading.Lock()
        self._gen = 0
        self._q: "queue.SimpleQueue | None" = None
        self._thread: threading.Thread | None = None

    def _ensure_worker_locked(self) -> "queue.SimpleQueue":
        if self._q is None or self._thread is None or not self._thread.is_alive():
            self._q = queue.SimpleQueue()
            self._thread = threading.Thread(
                target=self._worker, args=(self._q,), daemon=True,
                name=self._name,
            )
            self._thread.start()
        return self._q

    def _worker(self, q: "queue.SimpleQueue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            gen, fn, box = item
            try:
                res, err = fn(), None
            except BaseException as e:  # noqa: BLE001 — crosses threads
                res, err = None, e
            with self._mu:
                stale = gen != self._gen
            if stale:
                # Abandoned by a timeout: nobody is waiting.  Count it
                # so a recovered-but-late launch is visible, and never
                # let its error escape into a log-spam path.
                self.stats.count("device.watchdog.abandonedCompletions")
                continue
            box["result"], box["error"] = res, err
            box["done"].set()

    def run(self, fn, timeout_s: float):
        """``fn()`` with a deadline; raises :class:`LaunchWatchdogTimeout`
        (and abandons the in-flight call) when it does not return in
        ``timeout_s``."""
        box: dict = {"result": None, "error": None, "done": threading.Event()}
        with self._mu:
            q = self._ensure_worker_locked()
            gen = self._gen
        q.put((gen, fn, box))
        if not box["done"].wait(timeout=timeout_s):
            with self._mu:
                # Stale-mark the in-flight call and retire this runner:
                # the next submission gets a fresh thread.
                self._gen += 1
                self._q = None
                self._thread = None
            raise LaunchWatchdogTimeout(
                f"device launch exceeded watchdog deadline ({timeout_s:.3f}s)"
            )
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def close(self) -> None:
        with self._mu:
            q, self._q, self._thread = self._q, None, None
        if q is not None:
            q.put(None)


class DeviceHealth:
    """Per-path device breaker + the collective launch watchdog.

    One instance per node (the Server wires a configured one into its
    executor; a bare library executor builds a default), tracking the
    ``device:<ordinal>`` path of the node's card (``device``) and the
    ``collective`` cross-device path."""

    def __init__(
        self,
        quarantine_threshold: int = DEFAULT_QUARANTINE_THRESHOLD,
        open_ms: float = DEFAULT_OPEN_MS,
        probe_successes: int = DEFAULT_PROBE_SUCCESSES,
        watchdog_ms: float = DEFAULT_WATCHDOG_MS,
        stats=None,
        logger=None,
        on_state_change=None,
        device=None,
    ):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.quarantine_threshold = max(1, int(quarantine_threshold))
        self.open_s = float(open_ms) / 1000.0
        self.probe_successes = max(1, int(probe_successes))
        self.watchdog_s = float(watchdog_ms) / 1000.0
        self.stats = stats or NopStatsClient()
        self.logger = logger or (lambda m: None)
        # on_state_change(path, state) fires OUTSIDE the health lock on
        # every quarantine and heal — the server sets its node's
        # degraded flag (degraded-replica deprioritization) and stages
        # the mirrors again here.
        self.on_state_change = on_state_change
        self._mu = threading.Lock()
        self._paths: dict[str, _PathState] = {}
        self.watchdog_trips = 0
        self._runner = _WatchdogRunner(stats=self.stats)
        # The node's card (a torch device or its name): its ordinal names
        # the one device path.
        self.device = device
        self._ordinal = 0
        if device is not None:
            import torch

            self._ordinal = torch.device(device).index or 0

    # ------------------------------------------------------------------
    # paths
    # ------------------------------------------------------------------

    def device_paths(self) -> list[str]:
        """One path per participating device: a port node launches on
        its one card, ``device:<its ordinal>`` (``device:0`` on the
        CPU)."""
        return [f"device:{self._ordinal}"]

    def _path(self, name: str) -> _PathState:
        st = self._paths.get(name)
        if st is None:
            st = self._paths[name] = _PathState()
        return st

    # ------------------------------------------------------------------
    # the gate
    # ------------------------------------------------------------------

    def acquire(self, paths: list[str]) -> str:
        """Launch admission over ``paths``: ``ok`` (all healthy or
        suspect), ``probe`` (some quarantined path past its open window
        — this caller carries the half-open probe), or ``deny``.  A
        granted probe is exclusive until :meth:`success` /
        :meth:`failure` / :meth:`cancel_probe` resolves it."""
        now = time.monotonic()
        granted: list[_PathState] = []
        with self._mu:
            quarantined = [
                st
                for st in (self._path(p) for p in paths)
                if st.state == STATE_QUARANTINED
            ]
            if not quarantined:
                return MODE_OK
            for st in quarantined:
                if st.probing:
                    return MODE_DENY
                if now - st.quarantined_at < self.open_s:
                    return MODE_DENY
            for st in quarantined:
                st.probing = True
                granted.append(st)
        return MODE_PROBE

    def cancel_probe(self, paths: list[str]) -> None:
        """Release a granted probe that never launched (empty batch)."""
        with self._mu:
            for p in paths:
                st = self._paths.get(p)
                if st is not None:
                    st.probing = False

    def denied(self, paths: list[str] | None = None) -> bool:
        """Whether a launch over ``paths`` (default: every device path)
        would be denied right now — a peek that consumes no probe."""
        paths = paths if paths is not None else self.device_paths()
        now = time.monotonic()
        with self._mu:
            for p in paths:
                st = self._paths.get(p)
                if st is None or st.state != STATE_QUARANTINED:
                    continue
                if st.probing or now - st.quarantined_at < self.open_s:
                    return True
        return False

    def degraded(self) -> bool:
        """Any path quarantined — the node-level flag that makes
        coordinators deprioritize this replica."""
        with self._mu:
            return any(
                st.state == STATE_QUARANTINED for st in self._paths.values()
            )

    # ------------------------------------------------------------------
    # outcomes
    # ------------------------------------------------------------------

    def success(self, paths: list[str], probe: bool = False) -> None:
        events: list[tuple[str, str]] = []
        with self._mu:
            for p in paths:
                st = self._path(p)
                if st.state == STATE_QUARANTINED and (probe or st.probing):
                    st.probing = False
                    st.probe_ok += 1
                    if st.probe_ok >= self.probe_successes:
                        st.state = STATE_HEALTHY
                        st.failures = 0
                        st.probe_ok = 0
                        events.append((p, STATE_HEALTHY))
                    # else: stay quarantined, but past the open window —
                    # the next acquire() probes again immediately.
                elif st.state != STATE_QUARANTINED:
                    st.failures = 0
                    st.state = STATE_HEALTHY
        for p, state in events:
            self.stats.count("device.health.heals")
            self.logger(
                f"device health: {p} healed (half-open probe succeeded)"
            )
            self._notify(p, state)

    def failure(
        self,
        paths: list[str],
        kind: str,
        probe: bool = False,
        device: int | None = None,
    ) -> None:
        """Record a classified launch failure.  ``device`` (when the
        fault named one — per-device chaos targeting) narrows the blame
        to that ordinal's path; a real launch error indicts every
        participating path."""
        if device is not None:
            narrowed = [p for p in paths if p == f"device:{device}"]
            if narrowed:
                paths = narrowed
        events: list[tuple[str, str]] = []
        with self._mu:
            for p in paths:
                st = self._path(p)
                st.failures += 1
                st.last_kind = kind
                st.kinds[kind] = st.kinds.get(kind, 0) + 1
                if st.state == STATE_QUARANTINED:
                    # A failed probe (or a straggler failure) re-arms
                    # the quarantine clock.
                    st.probing = False
                    st.probe_ok = 0
                    st.quarantined_at = time.monotonic()
                    continue
                if kind == KIND_HANG or st.failures >= self.quarantine_threshold:
                    st.state = STATE_QUARANTINED
                    st.opens += 1
                    st.probing = False
                    st.probe_ok = 0
                    st.quarantined_at = time.monotonic()
                    events.append((p, STATE_QUARANTINED))
                else:
                    st.state = STATE_SUSPECT
        self.stats.count_with_custom_tags(
            "device.health.failures", 1, [f"kind:{kind}"]
        )
        for p, state in events:
            self.stats.count("device.health.quarantines")
            self.logger(
                f"device health: {p} QUARANTINED after {kind!r} failure(s) "
                "— serving from host planes until a half-open probe heals it"
            )
            self._notify(p, state)

    def _notify(self, path: str, state: str) -> None:
        cb = self.on_state_change
        if cb is None:
            return
        try:
            cb(path, state)
        except Exception as e:  # noqa: BLE001 — advisory hook
            self.logger(f"device health callback error: {e}")

    # ------------------------------------------------------------------
    # the collective path (cross-device launches) + watchdog
    # ------------------------------------------------------------------

    def collective_allowed(self) -> bool:
        """Peek: would a collective launch be admitted (possibly as a
        probe)?  Callers use this to pick the cross-device reduce or the
        per-device partials before assembling a launch."""
        return not self.denied([COLLECTIVE])

    def _locked_body(self, fn):
        """The watched payload: the process's collective-launch lock is
        taken ON THE RUNNER THREAD, so a hang observed by the watchdog
        leaves the lock with the abandoned runner — quarantine keeps new
        collectives away until a probe, by which time a recovered
        runtime has released it."""
        with _COLLECTIVE_MU:
            return self._dispatch_body(fn)

    def _dispatch_body(self, fn):
        """The caller's dispatch+fetch body, running under the
        collective lock."""
        return fn()

    def run_collective(self, fn):
        """Run a cross-device dispatch+fetch (``fn`` does NOT take the
        collective lock itself) under the collective path's breaker and
        the launch watchdog.  Raises :class:`CollectiveUnavailable` when
        quarantined and :class:`LaunchWatchdogTimeout` on a trip —
        callers fall back to the per-device launch or the host
        evaluator.  Device-fault
        errors from ``fn`` count against the collective path too (the
        caller's guard additionally classifies them for the device
        paths); non-device exceptions propagate unrecorded."""
        mode = self.acquire([COLLECTIVE])
        if mode == MODE_DENY:
            raise CollectiveUnavailable("collective launch path quarantined")
        probe = mode == MODE_PROBE
        try:
            if self.watchdog_s > 0:
                res = self._runner.run(
                    lambda: self._locked_body(fn), self.watchdog_s
                )
            else:
                res = self._locked_body(fn)
        except LaunchWatchdogTimeout:
            with self._mu:
                self.watchdog_trips += 1
            self.stats.count("device.watchdogTrips")
            self.logger(
                "device health: collective launch watchdog TRIPPED "
                f"({self.watchdog_s:.3f}s) — quarantining the collective path"
            )
            self.failure([COLLECTIVE], KIND_HANG, probe=probe)
            raise
        except Exception as e:
            kind = classify(e)
            if kind is not None:
                self.failure([COLLECTIVE], kind, probe=probe)
            elif probe:
                self.cancel_probe([COLLECTIVE])
            raise
        self.success([COLLECTIVE], probe=probe)
        return res

    def close(self) -> None:
        self._runner.close()

    # ------------------------------------------------------------------
    # surfaces
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._mu:
            paths = {p: st.snapshot(now) for p, st in sorted(self._paths.items())}
            trips = self.watchdog_trips
        return {
            "degraded": any(
                p["state"] == STATE_QUARANTINED for p in paths.values()
            ),
            "paths": paths,
            "watchdogTrips": trips,
            "quarantineThreshold": self.quarantine_threshold,
            "openMs": round(self.open_s * 1000.0, 1),
            "probeSuccesses": self.probe_successes,
            "watchdogMs": round(self.watchdog_s * 1000.0, 1),
        }

    _STATE_GAUGE = {STATE_HEALTHY: 0.0, STATE_SUSPECT: 1.0, STATE_QUARANTINED: 2.0}

    def gauges(self) -> dict:
        """Scrape-time /metrics gauges (rendered even without a stats
        backend, like the program-cache and admission gauges)."""
        with self._mu:
            out = {
                f"device.health.state[path:{p}]": self._STATE_GAUGE[st.state]
                for p, st in sorted(self._paths.items())
            }
            out["device.health.degraded"] = float(
                any(
                    st.state == STATE_QUARANTINED
                    for st in self._paths.values()
                )
            )
            out["device.watchdogTrips"] = float(self.watchdog_trips)
            return out
