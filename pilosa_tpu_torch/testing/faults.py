"""Deterministic fault injection: the chaos layer that drives the
device-health tests and a node's quarantine by hand.

The port's copy of ``pilosa_tpu/testing/faults.py`` (all of it: the spec
grammar, :class:`FaultRule` / :class:`FaultPlan`, :func:`parse`,
:func:`install`, :func:`clear`, :func:`reset`, :func:`active`,
:func:`check`, the lazily read ``PILOSA_FAULTS`` variable, and
:class:`FaultError` / :class:`FaultOOM` / :class:`FaultSpecError`).  A
plan is a list of match-and-fire rules checked at four stages by
:func:`check` calls in the hot paths.  Every stage parses; in this port
only ``device.launch`` has a check point so far:

* ``device.launch`` — in the executor, before a kernel launch of the
  query path (``exec/executor.py``'s ``_fault_check_launch``).  ``host``
  is the node's identity (so chaos can target one NODE of an in-process
  cluster), ``path`` names the launch site — ``direct`` (the executor's
  own launch), ``coalesce`` (a coalesced launch's waiter), ``topn`` (the
  cross-fragment scorer), ``collective`` (inside a mesh's cross-member
  Count, the body the launch watchdog watches, so that a hang there
  trips it) — and the check fires once per participating device (a
  mesh member) with ``device`` = its ordinal, so a
  ``device=`` rule can target ONE device;
* ``rpc.send`` / ``rpc.recv`` — the internal client's send and the
  handler's dispatch in the JAX package; they get their check points
  with the port of its ``net/resilience.py``;
* ``gossip.send`` — each gossip datagram in the JAX package; it gets its
  check point with the port of ``cluster/gossip.py``.

The plan comes from the ``PILOSA_FAULTS`` environment variable (read
lazily on first check) or from :func:`install` (tests, soak runs).
Spec grammar — semicolon-separated rules, each ``stage:key=value,...``::

    PILOSA_FAULTS='device.launch:kind=error,times=1;
                   device.launch:kind=oom,path=topn,times=4'

Match keys (all optional; a rule with none matches every call at its
stage):

* ``path``  — fnmatch glob against the request path (no query string);
  for ``device.launch``, the launch site (``direct`` / ``coalesce`` /
  ``collective`` / ``topn``)
* ``host``  — exact ``host:port`` (the TARGET host for rpc.send, the
  SERVING node for rpc.recv and device.launch)
* ``device``— device ordinal (``device.launch`` only): fire only when
  this device participates in the launch
* ``nth``   — fire only on the Nth statically-matching call (1-based)
* ``times`` — stop firing after this many hits
* ``prob``  — fire with this probability, drawn from a per-rule RNG
  seeded by ``seed`` (default 0) — a seeded run is fully deterministic
* ``after-ms`` / ``until-ms`` — activation window measured from the
  moment the plan was installed (:func:`install` / first env read): the
  rule matches only while ``after_ms <= elapsed < until_ms``.  Windowed
  calls don't advance ``nth`` outside the window.

Actions: ``mode=delay`` sleeps ``delay-ms`` and continues; ``mode=error``
raises :class:`FaultError` (a ``ConnectionError``, so a retry policy
sees a transport failure); ``mode=drop`` sleeps ``delay-ms`` then raises
``socket.timeout`` — a request that vanished into a dead network.

``kind=`` (``device.launch`` only) picks the device-failure shape the
health layer classifies (device/health.py) and overrides ``mode``:

* ``kind=error`` — raises :class:`FaultError`, the shape of a transient
  runtime error (the executor retries once);
* ``kind=oom``   — raises :class:`FaultOOM` with RESOURCE_EXHAUSTED
  text, the shape of a device allocator failure;
* ``kind=hang``  — sleeps ``delay-ms`` (default 60000) and then
  RETURNS: a launch that wedged.  Inside a ``collective`` site this is
  what trips the launch watchdog.

When no plan is installed, :func:`check` is one module-global read.
"""

from __future__ import annotations

import fnmatch
import os
import random
import socket
import threading
import time

STAGES = ("rpc.send", "rpc.recv", "device.launch", "gossip.send")
MODES = ("delay", "error", "drop")
# device.launch failure shapes (see module docstring); classified by
# device/health.py at the launch sites.
KINDS = ("oom", "error", "hang")
# How long an injected hang sleeps when the rule gives no delay-ms:
# long enough that any sane launch watchdog trips first.
DEFAULT_HANG_MS = 60_000.0


class FaultError(ConnectionError):
    """An injected transport error."""


class FaultOOM(RuntimeError):
    """An injected device out-of-memory: its message carries the
    RESOURCE_EXHAUSTED / out-of-memory markers of a real allocator
    failure, so the health classifier treats both identically."""


class FaultSpecError(ValueError):
    pass


class FaultRule:
    def __init__(
        self,
        stage: str,
        path: str | None = None,
        host: str | None = None,
        device: int | None = None,
        nth: int | None = None,
        times: int | None = None,
        prob: float | None = None,
        seed: int | None = None,
        mode: str = "error",
        kind: str | None = None,
        delay_ms: float = 0.0,
        after_ms: float | None = None,
        until_ms: float | None = None,
    ):
        if mode not in MODES:
            raise FaultSpecError(f"unknown fault mode: {mode!r}")
        if kind is not None and kind not in KINDS:
            raise FaultSpecError(f"unknown fault kind: {kind!r}")
        if kind is not None and stage != "device.launch":
            raise FaultSpecError("kind= applies only to device.launch rules")
        if device is not None and stage != "device.launch":
            raise FaultSpecError("device= applies only to device.launch rules")
        self.stage = stage
        self.path = path
        self.host = host
        self.device = int(device) if device is not None else None
        self.nth = int(nth) if nth is not None else None
        self.times = int(times) if times is not None else None
        self.prob = float(prob) if prob is not None else None
        self.mode = mode
        self.kind = kind
        self.delay_ms = float(delay_ms)
        self.after_ms = float(after_ms) if after_ms is not None else None
        self.until_ms = float(until_ms) if until_ms is not None else None
        if (
            self.after_ms is not None
            and self.until_ms is not None
            and self.until_ms <= self.after_ms
        ):
            raise FaultSpecError("until-ms must be > after-ms")
        # Timeline epoch: set when the rule joins an installed plan, so
        # after-ms/until-ms windows count from plan installation, not
        # rule construction.
        self._t0 = time.monotonic()
        self._rng = random.Random(seed if seed is not None else 0)
        self._mu = threading.Lock()
        # calls: invocations passing the STATIC filters (stage/host/
        # path/device) — the counter ``nth`` indexes; hits: times fired.
        self.calls = 0
        self.hits = 0

    def _static_match(
        self,
        stage: str,
        host: str | None,
        path: str | None,
        device: int | None,
    ) -> bool:
        if stage != self.stage:
            return False
        if self.host is not None and host != self.host:
            return False
        if self.device is not None and device != self.device:
            return False
        if self.path is not None and not fnmatch.fnmatchcase(
            path or "", self.path
        ):
            return False
        if self.after_ms is not None or self.until_ms is not None:
            elapsed_ms = (time.monotonic() - self._t0) * 1000.0
            if self.after_ms is not None and elapsed_ms < self.after_ms:
                return False
            if self.until_ms is not None and elapsed_ms >= self.until_ms:
                return False
        return True

    def consider(
        self,
        stage: str,
        host: str | None,
        path: str | None,
        device: int | None = None,
    ) -> bool:
        """Count the call against the rule and decide whether to fire."""
        if not self._static_match(stage, host, path, device):
            return False
        with self._mu:
            self.calls += 1
            if self.nth is not None and self.calls != self.nth:
                return False
            if self.times is not None and self.hits >= self.times:
                return False
            if self.prob is not None and self._rng.random() >= self.prob:
                return False
            self.hits += 1
            return True

    def fire(self) -> None:
        if self.kind is not None:
            if self.kind == "hang":
                # A launch that wedged: sleep (default long enough for
                # any watchdog to trip) and then RETURN — the hang, not
                # an error, is the injected fault.
                time.sleep((self.delay_ms or DEFAULT_HANG_MS) / 1000.0)
                return
            if self.kind == "oom":
                raise FaultOOM(
                    f"injected oom ({self.stage}): RESOURCE_EXHAUSTED: "
                    "out of memory while trying to allocate"
                )
            raise FaultError(f"injected error ({self.stage})")
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1000.0)
        if self.mode == "delay":
            return
        if self.mode == "drop":
            raise socket.timeout(f"injected drop ({self.stage})")
        raise FaultError(f"injected error ({self.stage})")

    def snapshot(self) -> dict:
        with self._mu:
            out = {
                "stage": self.stage,
                "mode": self.mode,
                "calls": self.calls,
                "hits": self.hits,
            }
        for k in ("path", "host", "device", "nth", "times", "prob", "kind"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.delay_ms:
            out["delayMs"] = self.delay_ms
        if self.after_ms is not None:
            out["afterMs"] = self.after_ms
        if self.until_ms is not None:
            out["untilMs"] = self.until_ms
        return out


class FaultPlan:
    def __init__(self, rules):
        self.rules = list(rules)

    def rearm(self) -> None:
        """Restart every rule's timeline epoch — after-ms/until-ms
        windows count from NOW.  Called by :func:`install` so a plan
        built ahead of time starts its timeline at installation."""
        now = time.monotonic()
        for rule in self.rules:
            rule._t0 = now

    def check(
        self,
        stage: str,
        host: str | None = None,
        path: str | None = None,
        device: int | None = None,
    ) -> None:
        for rule in self.rules:
            if rule.consider(stage, host, path, device):
                rule.fire()

    def snapshot(self) -> list[dict]:
        return [r.snapshot() for r in self.rules]


_INT_KEYS = {"nth", "times", "seed", "device"}
_FLOAT_KEYS = {"prob", "delay_ms", "after_ms", "until_ms"}
_STR_KEYS = {"path", "host", "mode", "kind"}


def parse(spec: str) -> FaultPlan:
    """Parse a ``PILOSA_FAULTS`` spec string into a plan.  Raises
    :class:`FaultSpecError` on malformed input — a chaos run with a
    typo'd spec must fail loudly, not silently inject nothing."""
    rules = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        stage, sep, opts = part.partition(":")
        stage = stage.strip()
        if not sep or not stage:
            raise FaultSpecError(f"fault rule needs 'stage:opts': {part!r}")
        kwargs: dict = {}
        for opt in (o.strip() for o in opts.split(",")):
            if not opt:
                continue
            key, sep, value = opt.partition("=")
            if not sep:
                raise FaultSpecError(f"fault option needs key=value: {opt!r}")
            key = key.strip().replace("-", "_")
            value = value.strip()
            try:
                if key in _INT_KEYS:
                    kwargs[key] = int(value)
                elif key in _FLOAT_KEYS:
                    kwargs[key] = float(value)
                elif key in _STR_KEYS:
                    kwargs[key] = value
                else:
                    raise FaultSpecError(f"unknown fault option: {key!r}")
            except ValueError as e:
                raise FaultSpecError(f"bad fault option {opt!r}: {e}") from e
        rules.append(FaultRule(stage, **kwargs))
    return FaultPlan(rules)


# ---------------------------------------------------------------------------
# process-global plan
# ---------------------------------------------------------------------------

_UNSET = object()  # env not consulted yet
_plan = _UNSET
_mu = threading.Lock()


def install(plan: "FaultPlan | str") -> FaultPlan:
    """Install a plan (or spec string) process-wide; returns it so tests
    can assert on per-rule hit counts."""
    global _plan
    if isinstance(plan, str):
        plan = parse(plan)
    plan.rearm()
    _plan = plan
    return plan


def clear() -> None:
    """Deactivate fault injection (and stop consulting the env)."""
    global _plan
    _plan = None


def reset() -> None:
    """Forget any installed plan AND re-arm the lazy env read — the
    fresh-process state."""
    global _plan
    _plan = _UNSET


def active() -> FaultPlan | None:
    global _plan
    if _plan is _UNSET:
        with _mu:
            if _plan is _UNSET:
                spec = os.environ.get("PILOSA_FAULTS", "")
                _plan = parse(spec) if spec else None
    return _plan


def check(
    stage: str,
    host: str | None = None,
    path: str | None = None,
    device: int | None = None,
) -> None:
    """The injection point: no-op (one global read) unless a plan with
    matching rules is installed."""
    plan = _plan
    if plan is _UNSET:
        plan = active()
    if plan is not None:
        plan.check(stage, host=host, path=path, device=device)
