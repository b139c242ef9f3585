"""Cluster resilience primitives: deadlines, retries, circuit breakers.

The distributed read path (executor map/reduce + InternalClient) used to
ride flat timeouts: a 30 s socket timeout per unary RPC, zero retries,
and nothing that remembered a host was down — one flapping node made
every fan-out burn a full timeout before failover.  This module supplies
the three mechanisms the rest of ``net/`` and ``exec/`` compose:

* **Deadlines.**  A query carries one absolute deadline (``[net]
  query-timeout-ms``, overridable per request via the ``X-Deadline-Ms``
  header).  The deadline lives in a ``contextvars.ContextVar`` — the
  executor's pool already copies the submitting context into workers, so
  every remote leg, retry sleep, and coalesce wait derives its timeout
  from the REMAINING budget.  Each outbound RPC re-exports the remaining
  milliseconds as ``X-Deadline-Ms`` so the peer inherits the budget
  (measured at send time; network delay grants the peer slack rather
  than double-charging it).  An expired deadline raises
  :class:`DeadlineExceeded`, which the handler maps to HTTP 504.

* **Retries.**  :class:`RetryPolicy` is capped jittered-exponential
  backoff over transport failures (the policy shape of
  ``stream/client.py:open_with_retry``): transient dial/read errors on
  IDEMPOTENT calls get ``attempts`` tries; a retry never sleeps past the
  deadline; writes stay single-shot unless explicitly marked idempotent.

* **Circuit breakers.**  One :class:`CircuitBreaker` per remote host
  (closed → open after ``failure_threshold`` consecutive transport
  failures → half-open probe every ``open_s`` → closed on probe
  success).  While open, calls fail in microseconds with
  :class:`BreakerOpenError` — the executor's failover then skips
  straight to replicas instead of burning a timeout per query.  State is
  surfaced at ``GET /debug/health`` and as ``net.breaker.*`` counters.
"""

from __future__ import annotations

import contextvars
import http.client
import random
import threading
import time
from collections.abc import Callable
from contextlib import contextmanager
from typing import Any

# Header carrying the REMAINING deadline budget in milliseconds at send
# time.  The receiver restarts the clock on receipt.
DEADLINE_HEADER = "X-Deadline-Ms"

# Transient transport failures worth a retry and worth counting against
# a host's breaker; HTTP-status errors mean the server answered and are
# judged separately (see is_node_failure).  Same shape as
# stream/client.py RETRYABLE.
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class DeadlineExceeded(RuntimeError):
    """The query's deadline expired.  The HTTP handler maps this to 504
    (with the trace id); it must never be swallowed into replica
    failover — an exhausted budget fails the query, not the node."""

    def __init__(self, message: str = "deadline exceeded"):
        super().__init__(message)


class ShedError(RuntimeError):
    """The request was shed by admission control (HTTP 429): the server
    is healthy but at capacity, and predicted queue wait would not fit
    the request's remaining deadline budget — so it answered before
    burning any executor/coalescer/device work.

    Carries the server's ``Retry-After`` hint in seconds.  A shed must
    NOT count against the host's circuit breaker (the node answered,
    quickly and deliberately), but IS a node failure for the purposes
    of replica failover: another replica may have capacity right now.
    """

    status = 429

    def __init__(
        self,
        message: str = "request shed",
        retry_after_s: float = 1.0,
        host: str = "",
        cost_class: str = "",
    ):
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)
        self.host = host
        self.cost_class = cost_class


class BreakerOpenError(RuntimeError):
    """Fast-fail for a host whose circuit breaker is open.  Deliberately
    NOT a transport error: retrying against an open breaker is pointless
    (it would fail just as fast), but the executor's failover treats it
    as a node failure — which is the point."""

    def __init__(self, host: str):
        super().__init__(f"circuit breaker open for {host}")
        self.host = host


def is_node_failure(exc: BaseException) -> bool:
    """Whether an error from a remote leg indicts the NODE (transport
    failure, open breaker, or a 5xx answer) — eligible for replica
    failover and, under ``allow_partial``, for dropping the slice —
    as opposed to a semantic error that would fail identically
    everywhere."""
    if isinstance(exc, BreakerOpenError):
        return True
    if isinstance(exc, DeadlineExceeded):
        return False
    # A shed leg (429) indicts the node only in the failover sense:
    # this replica is at capacity, another may not be.  It never counts
    # against the breaker (see InternalClient._attempt).
    if isinstance(exc, ShedError):
        return True
    if isinstance(exc, TRANSPORT_ERRORS):
        return True
    status = getattr(exc, "status", None)
    return isinstance(status, int) and status >= 500


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


class Deadline:
    """An absolute point on the monotonic clock.  Cheap value object —
    every remote leg reads it, so no locks, no allocation beyond the
    float."""

    __slots__ = ("_at",)

    def __init__(self, at: float):
        self._at = at

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + ms / 1000.0)

    @classmethod
    def from_header(cls, value: str) -> "Deadline | None":
        """Parse an ``X-Deadline-Ms`` header value; None when absent or
        malformed (a garbage header must not 500 the request)."""
        if not value:
            return None
        try:
            return cls.after_ms(float(value))
        except (TypeError, ValueError):
            return None

    def remaining(self) -> float:
        """Seconds of budget left (negative when expired)."""
        return self._at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining() * 1000.0

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def clamp(self, timeout: float) -> float:
        """``timeout`` bounded by the remaining budget (never below 0)."""
        return max(min(timeout, self.remaining()), 0.0)

    def header_value(self) -> str:
        """The remaining budget as an ``X-Deadline-Ms`` value (floored
        at 1 ms so an about-to-expire deadline still travels as a
        deadline rather than vanishing)."""
        return str(max(1, int(self.remaining_ms())))


_current_deadline: "contextvars.ContextVar[Deadline | None]" = (
    contextvars.ContextVar("pilosa_deadline", default=None)
)


def current_deadline() -> Deadline | None:
    return _current_deadline.get()


@contextmanager
def deadline_scope(dl: Deadline | None):
    """Install ``dl`` as the current deadline for the dynamic extent.
    ``None`` is a no-op scope (no deadline)."""
    if dl is None:
        yield None
        return
    token = _current_deadline.set(dl)
    try:
        yield dl
    finally:
        _current_deadline.reset(token)


def check_deadline(what: str = "") -> None:
    """Raise :class:`DeadlineExceeded` when the current deadline has
    expired; no-op without a deadline."""
    dl = _current_deadline.get()
    if dl is not None and dl.expired:
        raise DeadlineExceeded(
            f"deadline exceeded{f' ({what})' if what else ''}"
        )


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------


class RetryPolicy:
    """Capped jittered-exponential retry for idempotent unary RPCs.

    ``attempts`` total tries; sleeps ``backoff * 2^i`` capped at
    ``max_backoff``, each shrunk by up to ``jitter`` (fraction) so a
    fan-out's retries don't stampede in lockstep.  Deadline-aware: a
    retry whose sleep would outlive the current deadline raises
    :class:`DeadlineExceeded` instead of sleeping into a guaranteed
    failure."""

    def __init__(
        self,
        attempts: int = 3,
        backoff: float = 0.1,
        max_backoff: float = 2.0,
        jitter: float = 0.5,
        stats=None,
        seed: int | None = None,
    ):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.attempts = max(1, int(attempts))
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.stats = stats or NopStatsClient()
        self._rng = random.Random(seed)

    def call(
        self,
        fn: Callable[[], Any],
        retryable: tuple[type[BaseException], ...] = TRANSPORT_ERRORS,
    ) -> Any:
        """Run ``fn()`` with up to ``attempts`` tries.  Only
        ``retryable`` exceptions retry; everything else (including
        DeadlineExceeded and BreakerOpenError) propagates at once."""
        from pilosa_tpu_torch.obs import trace as trace_mod

        delay = self.backoff
        for attempt in range(self.attempts):
            try:
                result = fn()
            except retryable as e:
                if attempt == self.attempts - 1:
                    self.stats.count("net.retry.exhausted")
                    raise
                dl = current_deadline()
                if dl is not None and dl.expired:
                    raise DeadlineExceeded(
                        f"deadline exceeded after transport error: {e}"
                    ) from e
                sleep_s = min(delay, self.max_backoff)
                sleep_s *= 1.0 - self.jitter * self._rng.random()
                # A shed (429) carries the server's Retry-After hint:
                # honor it — retrying sooner would just be shed again.
                # When the hint outlives the remaining budget, surface
                # the shed NOW so the caller can fail over to a replica
                # instead of sleeping into a guaranteed 504.
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    sleep_s = max(sleep_s, float(retry_after))
                    self.stats.count("net.retry.shed")
                    if dl is not None and dl.remaining() < sleep_s:
                        raise
                if dl is not None:
                    sleep_s = dl.clamp(sleep_s)
                self.stats.count("net.retry.attempt")
                sp = trace_mod.current_span()
                if sp is not None:
                    sp.annotate(retries=attempt + 1)
                time.sleep(sleep_s)
                delay = min(delay * 2, self.max_backoff)
                continue
            return result

    def snapshot(self) -> dict:
        return {
            "attempts": self.attempts,
            "backoffMs": round(self.backoff * 1000.0, 3),
            "maxBackoffMs": round(self.max_backoff * 1000.0, 3),
            "jitter": self.jitter,
        }


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-host closed/open/half-open state machine.

    ``failure_threshold`` consecutive transport failures trip the
    breaker open; after ``open_s`` the next ``allow()`` admits exactly
    ONE half-open probe (a stale probe — its caller died without
    recording an outcome — expires after another ``open_s`` so the
    breaker can never wedge); the probe's success closes the breaker,
    its failure re-opens it."""

    def __init__(
        self,
        host: str,
        failure_threshold: int = 5,
        open_s: float = 10.0,
        stats=None,
    ):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.host = host
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_s = float(open_s)
        self.stats = stats or NopStatsClient()
        self._mu = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0  # consecutive
        self._opened_at = 0.0
        self._probe_started: float | None = None
        self.opens = 0

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def allow(self) -> bool:
        """Whether a call to this host may proceed right now.  In the
        open state this is where the half-open transition happens."""
        with self._mu:
            if self._state == STATE_CLOSED:
                return True
            now = time.monotonic()
            if self._state == STATE_OPEN:
                if now - self._opened_at < self.open_s:
                    return False
                self._state = STATE_HALF_OPEN
                self._probe_started = now
                self.stats.count("net.breaker.halfOpen")
                return True
            # half-open: one probe in flight at a time; a probe whose
            # caller vanished expires so the breaker cannot wedge.
            if (
                self._probe_started is not None
                and now - self._probe_started < self.open_s
            ):
                return False
            self._probe_started = now
            return True

    def record_success(self) -> None:
        with self._mu:
            self._failures = 0
            self._probe_started = None
            if self._state != STATE_CLOSED:
                self._state = STATE_CLOSED
                self.stats.count("net.breaker.close")

    def record_failure(self) -> None:
        with self._mu:
            self._probe_started = None
            self._failures += 1
            if self._state == STATE_HALF_OPEN:
                self._trip_locked()
            elif (
                self._state == STATE_CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._trip_locked()

    def _trip_locked(self) -> None:
        self._state = STATE_OPEN
        self._opened_at = time.monotonic()
        self.opens += 1
        self.stats.count("net.breaker.open")

    def snapshot(self) -> dict:
        with self._mu:
            out = {
                "state": self._state,
                "consecutiveFailures": self._failures,
                "opens": self.opens,
            }
            if self._state != STATE_CLOSED:
                out["sinceOpenMs"] = round(
                    (time.monotonic() - self._opened_at) * 1000.0, 1
                )
            return out


class BreakerRegistry:
    """Lazily-created breaker per remote host, shared by every client a
    server hands out.  ``check`` is the single call-site gate: it either
    admits the call or raises :class:`BreakerOpenError` in microseconds."""

    def __init__(
        self, failure_threshold: int = 5, open_s: float = 10.0, stats=None
    ):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.failure_threshold = max(1, int(failure_threshold))
        self.open_s = float(open_s)
        self.stats = stats or NopStatsClient()
        self._mu = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def for_host(self, host: str) -> CircuitBreaker:
        with self._mu:
            b = self._breakers.get(host)
            if b is None:
                b = self._breakers[host] = CircuitBreaker(
                    host,
                    failure_threshold=self.failure_threshold,
                    open_s=self.open_s,
                    stats=self.stats,
                )
            return b

    def check(self, host: str) -> None:
        if not self.for_host(host).allow():
            self.stats.count("net.breaker.rejected")
            raise BreakerOpenError(host)

    def record(self, host: str, ok: bool) -> None:
        b = self.for_host(host)
        if ok:
            b.record_success()
        else:
            b.record_failure()

    def state(self, host: str) -> str:
        return self.for_host(host).state

    def snapshot(self) -> dict:
        with self._mu:
            breakers = dict(self._breakers)
        return {host: b.snapshot() for host, b in sorted(breakers.items())}


# ---------------------------------------------------------------------------
# bundle
# ---------------------------------------------------------------------------


class Resilience:
    """The server's resilience wiring in one handle: the retry policy
    and breaker registry its clients share, plus the default query
    deadline.  Handed to the Handler for ``GET /debug/health``."""

    def __init__(
        self,
        retry: RetryPolicy | None = None,
        breakers: BreakerRegistry | None = None,
        query_timeout_ms: float = 0.0,
        stats=None,
    ):
        self.retry = retry or RetryPolicy(stats=stats)
        self.breakers = breakers or BreakerRegistry(stats=stats)
        self.query_timeout_ms = float(query_timeout_ms)

    def query_deadline(self, header_value: str = "") -> Deadline | None:
        """The deadline for one query: the request's ``X-Deadline-Ms``
        when present, else the configured default (0 = none)."""
        dl = Deadline.from_header(header_value)
        if dl is not None:
            return dl
        if self.query_timeout_ms > 0:
            return Deadline.after_ms(self.query_timeout_ms)
        return None

    def snapshot(self) -> dict:
        return {
            "queryTimeoutMs": self.query_timeout_ms,
            "retry": self.retry.snapshot(),
            "breakers": self.breakers.snapshot(),
        }
