"""Server-side admission control: cost classes, bounded queues,
deadline-aware load shedding, per-tenant weighted fairness + quotas.

The port's own copy of ``pilosa_tpu/net/admission.py``: the same
classes, knobs, stats names and snapshots, over the port's
``net/resilience.ShedError``.  A shed happens before any kernel launch
(K2, K4, K7 and the rest), so a 429 costs the card nothing.

The HTTP adapter (``ThreadingHTTPServer``) admits every connection
unconditionally, so under overload a node queues work it can never
finish inside its deadline and answers 504 *after* burning device time
— the classic overload failure mode (see Facebook's "Fail at Scale"
adaptive-LIFO/CoDel design).  This layer sits in FRONT of the
executor/coalescer and decides, per request, in microseconds:

* **Cost classes.**  Every query is classified from its parsed plan
  (``exec.plan.cost_class``): ``point`` (Count/Bitmap algebra),
  ``heavy`` (TopN / Sum / Min / Max / Range), ``write`` (PQL writes and
  bulk imports) — plus ``internal`` for the remote legs of another
  node's map/reduce (``QueryRequest.Remote``) and anti-entropy repair.
  Each class gets its own concurrency gate and bounded queue, so a
  storm of TopNs cannot starve point lookups and vice versa.

* **Deadline-aware shedding.**  A request that cannot be served within
  its remaining ``X-Deadline-Ms`` budget — the queue is full, or the
  predicted queue wait (queue position x EWMA service time / gate
  width) exceeds the budget — is answered ``429 + Retry-After``
  immediately, BEFORE any coalescer/device work.  The Retry-After hint
  is the predicted drain time of the queue ahead.

* **Internal priority.**  The ``internal`` lane is a separate gate:
  client traffic can never occupy its slots, so a saturated cluster
  cannot distributed-livelock (every node's client gates full, every
  node's map legs starving behind them).  The lane is still *bounded* —
  a truly saturated node sheds internal legs too, which the
  coordinator's failover treats as a node failure (try a replica, or
  degrade under ``allowPartial``) rather than a breaker trip.

* **Tenant fairness.**  Requests carry a tenant tag (``X-Api-Key`` →
  tenant via :class:`TenantRegistry`, or a configured ``X-Tenant``
  name; untagged traffic rides the default tenant).  Inside each class
  gate the queue is weighted-fair (deficit round-robin over per-tenant
  FIFOs): one hot tenant's backlog occupies only its own per-tenant
  queue slots and its weighted share of grants, so another tenant's
  point queries keep admitting with near-empty-queue latency.  The
  internal lane is exempt — remote map legs are *charged* to the
  originating tenant (the coordinator forwards ``X-Tenant``) but never
  queued behind a tenant boundary.

* **Tenant quotas.**  Optional per-tenant token buckets for request
  rate (QPS) and ingress bytes/s.  Exhaustion answers ``429`` with
  ``X-Quota-Limit`` / ``X-Quota-Remaining`` / ``Retry-After`` via
  :class:`QuotaError` (a :class:`~pilosa_tpu_torch.net.resilience.ShedError`,
  so the existing retry/breaker algebra applies: clients back off,
  breakers never trip).

Observability: ``net.admission.admitted|shed|queueTimeout`` counters
(``class:`` tag), per-tenant ``net.admission.tenantAdmitted|tenantShed|
quotaShed`` counters (``tenant:``/``class:`` tags),
``net.admission.queueWaitMs`` histogram, scrape-time
``net.admission.active|queueDepth|ewmaServiceMs`` (+ per-tenant
``tenantQueued``/``quotaRemaining``) gauges on /metrics, the per-class
queue state on ``GET /debug/health``, the per-tenant table on
``GET /debug/tenants``, and an ``admission`` span in every query trace.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from pilosa_tpu_torch.net import resilience as rz

# Class names (the first three mirror exec.plan.COST_*; admission owns
# the internal lane, which is a transport property, not a plan one).
CLASS_POINT = "point"
CLASS_HEAVY = "heavy"
CLASS_WRITE = "write"
CLASS_INTERNAL = "internal"
# Standing-query notification batches (pilosa_tpu_torch/subscribe): a
# dedicated bounded lane so push evaluation can never occupy a query
# slot — subscribers starve before queries do, by construction.
CLASS_SUBSCRIBE = "subscribe"

CLASSES = (
    CLASS_POINT,
    CLASS_HEAVY,
    CLASS_WRITE,
    CLASS_INTERNAL,
    CLASS_SUBSCRIBE,
)

# The tenant untagged traffic is charged to.  Always registered, weight
# 1, no quota — a single-tenant deployment behaves exactly as before
# tenants existed.
DEFAULT_TENANT = "default"

# EWMA smoothing for observed service times: new = a*obs + (1-a)*old.
_EWMA_ALPHA = 0.2
# Service-time estimate before the first observation (ms).  Deliberately
# modest: the first storm against a cold gate should shed on queue
# depth, not on a wild wait prediction.
_EWMA_INIT_MS = 25.0
# Retry-After hints are clamped to this window.
_MIN_RETRY_AFTER_S = 0.05
_MAX_RETRY_AFTER_S = 30.0


class QuotaError(rz.ShedError):
    """A tenant exhausted its configured QPS or bytes/s budget.  Still
    a shed (429, Retry-After, no breaker trip) — but carries the quota
    headers so a well-behaved client can pace itself instead of
    retry-hammering."""

    def __init__(
        self,
        message: str,
        retry_after_s: float,
        tenant: str,
        kind: str,
        limit: float,
        remaining: float,
    ):
        super().__init__(message, retry_after_s=retry_after_s)
        self.tenant = tenant
        self.quota_kind = kind  # "qps" | "bytes"
        self.quota_limit = limit
        self.quota_remaining = remaining


class Tenant:
    """One configured tenant: fair-queue weight + optional quotas.
    Spec grammar (config ``[net] tenants``): ``name:weight[:qps
    [:bytes_per_s]]`` — 0 means unlimited."""

    __slots__ = ("name", "weight", "qps", "bytes_per_s")

    def __init__(
        self,
        name: str,
        weight: int = 1,
        qps: float = 0.0,
        bytes_per_s: float = 0.0,
    ):
        if not name:
            raise ValueError("tenant name must be non-empty")
        self.name = name
        self.weight = max(1, int(weight))
        self.qps = max(0.0, float(qps))
        self.bytes_per_s = max(0.0, float(bytes_per_s))

    @classmethod
    def parse(cls, spec: str) -> "Tenant":
        parts = [p.strip() for p in spec.strip().split(":")]
        if not parts or not parts[0]:
            raise ValueError(f"bad tenant spec {spec!r}")
        name = parts[0]
        try:
            weight = int(parts[1]) if len(parts) > 1 and parts[1] else 1
            qps = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
            byps = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
        except ValueError as e:
            raise ValueError(f"bad tenant spec {spec!r}: {e}") from e
        return cls(name, weight, qps, byps)


class _TokenBucket:
    """Continuous-refill token bucket; capacity = one second of burst.
    Caller holds the registry lock."""

    __slots__ = ("rate", "capacity", "tokens", "t_last")

    def __init__(self, rate: float):
        self.rate = float(rate)
        self.capacity = max(self.rate, 1.0)
        self.tokens = self.capacity
        self.t_last = time.monotonic()

    def _refill(self) -> None:
        now = time.monotonic()
        self.tokens = min(
            self.capacity, self.tokens + (now - self.t_last) * self.rate
        )
        self.t_last = now

    def try_take(self, n: float) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after_s(self, n: float) -> float:
        if self.rate <= 0:
            return _MAX_RETRY_AFTER_S
        want = min(n, self.capacity)
        return min(
            max((want - self.tokens) / self.rate, _MIN_RETRY_AFTER_S),
            _MAX_RETRY_AFTER_S,
        )


class _TenantState:
    """Registry-lock-guarded per-tenant accounting + quota buckets."""

    __slots__ = (
        "tenant",
        "qps_bucket",
        "bytes_bucket",
        "admitted",
        "shed",
        "quota_shed",
        "wait_ewma_ms",
        "by_class",
    )

    def __init__(self, tenant: Tenant):
        self.tenant = tenant
        self.qps_bucket = _TokenBucket(tenant.qps) if tenant.qps else None
        self.bytes_bucket = (
            _TokenBucket(tenant.bytes_per_s) if tenant.bytes_per_s else None
        )
        self.admitted = 0
        self.shed = 0
        self.quota_shed = 0
        self.wait_ewma_ms = 0.0
        # class -> [admitted, shed]
        self.by_class: dict[str, list[int]] = {}


class TenantRegistry:
    """API-key → tenant resolution, WFQ weights, quota buckets, and the
    per-tenant counters behind ``GET /debug/tenants``.

    Unknown tenants resolve to ``default_tenant``; unknown *names* in a
    forwarded ``X-Tenant`` on the internal lane are still recorded (the
    coordinator already authenticated the originating key), so a
    fan-out is charged to its origin on every node it touches."""

    def __init__(
        self,
        tenants: "list[str | Tenant] | None" = None,
        keys: "list[str] | None" = None,
        default_tenant: str = DEFAULT_TENANT,
        internal_token: str = "",
        stats=None,
    ):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.default_tenant = default_tenant or DEFAULT_TENANT
        self.internal_token = internal_token or ""
        self.stats = stats or NopStatsClient()
        self._mu = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self._state: dict[str, _TenantState] = {}
        for spec in tenants or ():
            t = spec if isinstance(spec, Tenant) else Tenant.parse(spec)
            self._tenants[t.name] = t
            self._state[t.name] = _TenantState(t)
        if self.default_tenant not in self._tenants:
            t = Tenant(self.default_tenant)
            self._tenants[t.name] = t
            self._state[t.name] = _TenantState(t)
        # "apikey:tenant" pairs.  Keys mapping to unconfigured tenants
        # are a config error (caught by Config.validate too).
        self._keys: dict[str, str] = {}
        for pair in keys or ():
            key, sep, tname = pair.strip().partition(":")
            if not sep or not key or not tname:
                raise ValueError(f"bad tenant key spec {pair!r}")
            self._keys[key] = tname

    # -- resolution ----------------------------------------------------

    def resolve(self, api_key: str, tenant_header: str) -> str:
        """Tenant for a client request.  API key wins; a bare
        ``X-Tenant`` is honored only for configured tenants (arbitrary
        client-chosen names would be unbounded metric cardinality and a
        free quota reset)."""
        if api_key and api_key in self._keys:
            return self._keys[api_key]
        if tenant_header and tenant_header in self._tenants:
            return tenant_header
        return self.default_tenant

    def internal_ok(self, token: str) -> bool:
        """May this request claim the internal lane?  With no token
        configured the lane is open (trusted network / tests); with one
        configured, only holders of the token — clients cannot spoof
        X-Internal-Lane or the Remote flag to dodge tenant QoS."""
        return not self.internal_token or token == self.internal_token

    def weight(self, tenant: str) -> int:
        t = self._tenants.get(tenant)
        return t.weight if t is not None else 1

    def tenant_names(self) -> list[str]:
        return sorted(self._tenants)

    # -- quotas --------------------------------------------------------

    def check_quota(self, tenant: str, cls: str, nbytes: int = 0) -> None:
        """Debit one request (+ ``nbytes`` ingress) from the tenant's
        buckets or raise :class:`QuotaError`.  The internal lane is
        exempt (callers skip it): a coordinator's map legs were already
        paid for at the coordinator's front door."""
        st = self._state.get(tenant)
        if st is None or (st.qps_bucket is None and st.bytes_bucket is None):
            return
        with self._mu:
            if st.qps_bucket is not None and not st.qps_bucket.try_take(1.0):
                err = QuotaError(
                    f"quota: tenant {tenant!r} over {st.tenant.qps:g} qps",
                    retry_after_s=st.qps_bucket.retry_after_s(1.0),
                    tenant=tenant,
                    kind="qps",
                    limit=st.tenant.qps,
                    remaining=max(0.0, st.qps_bucket.tokens),
                )
            elif st.bytes_bucket is not None and nbytes > 0 and not (
                st.bytes_bucket.try_take(float(nbytes))
            ):
                err = QuotaError(
                    f"quota: tenant {tenant!r} over "
                    f"{st.tenant.bytes_per_s:g} bytes/s",
                    retry_after_s=st.bytes_bucket.retry_after_s(
                        float(nbytes)
                    ),
                    tenant=tenant,
                    kind="bytes",
                    limit=st.tenant.bytes_per_s,
                    remaining=max(0.0, st.bytes_bucket.tokens),
                )
            else:
                return
            err.cost_class = cls
            st.quota_shed += 1
            st.shed += 1
            st.by_class.setdefault(cls, [0, 0])[1] += 1
        self.stats.count_with_custom_tags(
            "net.admission.quotaShed",
            1,
            [f"tenant:{tenant}", f"kind:{err.quota_kind}"],
        )
        raise err

    # -- accounting ----------------------------------------------------

    def note_admitted(self, tenant: str, cls: str, wait_ms: float) -> None:
        st = self._state.get(tenant)
        if st is None:  # forwarded origin tenant not configured here
            st = self._state.setdefault(
                tenant, _TenantState(Tenant(tenant))
            )
        with self._mu:
            st.admitted += 1
            st.by_class.setdefault(cls, [0, 0])[0] += 1
            st.wait_ewma_ms = (
                _EWMA_ALPHA * wait_ms + (1.0 - _EWMA_ALPHA) * st.wait_ewma_ms
            )
        self.stats.count_with_custom_tags(
            "net.admission.tenantAdmitted",
            1,
            [f"tenant:{tenant}", f"class:{cls}"],
        )

    def note_shed(self, tenant: str, cls: str) -> None:
        st = self._state.get(tenant)
        if st is None:
            st = self._state.setdefault(
                tenant, _TenantState(Tenant(tenant))
            )
        with self._mu:
            st.shed += 1
            st.by_class.setdefault(cls, [0, 0])[1] += 1
        self.stats.count_with_custom_tags(
            "net.admission.tenantShed",
            1,
            [f"tenant:{tenant}", f"class:{cls}"],
        )

    # -- introspection -------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /debug/tenants`` table."""
        out: dict = {}
        with self._mu:
            for name in sorted(self._state):
                st = self._state[name]
                t = st.tenant
                quota: dict = {}
                if st.qps_bucket is not None:
                    st.qps_bucket._refill()
                    quota["qps"] = {
                        "limit": t.qps,
                        "remaining": round(st.qps_bucket.tokens, 3),
                    }
                if st.bytes_bucket is not None:
                    st.bytes_bucket._refill()
                    quota["bytesPerS"] = {
                        "limit": t.bytes_per_s,
                        "remaining": round(st.bytes_bucket.tokens, 3),
                    }
                out[name] = {
                    "weight": t.weight,
                    "admitted": st.admitted,
                    "shed": st.shed,
                    "quotaShed": st.quota_shed,
                    "queueWaitEwmaMs": round(st.wait_ewma_ms, 3),
                    "quota": quota,
                    "classes": {
                        cls: {"admitted": a, "shed": s}
                        for cls, (a, s) in sorted(st.by_class.items())
                    },
                }
        return out

    def gauges(self) -> dict[str, float]:
        out: dict[str, float] = {}
        with self._mu:
            for name in sorted(self._state):
                st = self._state[name]
                if st.qps_bucket is not None:
                    st.qps_bucket._refill()
                    out[
                        f"net.admission.quotaRemaining[tenant:{name},kind:qps]"
                    ] = round(st.qps_bucket.tokens, 3)
                if st.bytes_bucket is not None:
                    st.bytes_bucket._refill()
                    out[
                        f"net.admission.quotaRemaining[tenant:{name},kind:bytes]"
                    ] = round(st.bytes_bucket.tokens, 3)
        return out


class Ticket:
    """One admitted request's slot in a class gate.  ``release()``
    returns the slot and feeds the observed service time back into the
    gate's EWMA (which drives the NEXT request's wait prediction)."""

    __slots__ = ("_gate", "wait_ms", "tenant", "_t_admit", "_released")

    def __init__(self, gate: "_ClassGate", wait_ms: float, tenant: str):
        self._gate = gate
        self.wait_ms = wait_ms
        self.tenant = tenant
        self._t_admit = time.monotonic()
        self._released = False

    def release(self) -> None:
        if self._released:  # idempotent — finally blocks may race close
            return
        self._released = True
        self._gate._release(time.monotonic() - self._t_admit)


class _Waiter:
    """One queued request.  ``cv`` shares the gate lock, so the
    scheduler wakes exactly the granted waiter — no thundering herd."""

    __slots__ = ("tenant", "granted", "cv")

    def __init__(self, tenant: str, mu: threading.RLock):
        self.tenant = tenant
        self.granted = False
        self.cv = threading.Condition(mu)


class _ClassGate:
    """Concurrency gate + bounded weighted-fair queue for one cost
    class.  The queue is a deficit-round-robin scheduler over
    per-tenant FIFOs: each backlogged tenant accrues ``weight`` grants
    per rotation, so a hot tenant's 64-deep backlog delays another
    tenant's first request by at most ~one grant, not 64.  With a
    single tenant (every pre-tenant deployment) the schedule degenerates
    to the original global FIFO, byte-for-byte."""

    def __init__(
        self,
        name: str,
        concurrency: int,
        queue_depth: int,
        stats,
        weight_of=None,
    ):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.name = name
        self.concurrency = max(1, int(concurrency))
        self.queue_depth = max(0, int(queue_depth))
        self.stats = stats or NopStatsClient()
        self._weight_of = weight_of or (lambda tenant: 1)
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self._active = 0
        self._queued = 0
        # tenant -> FIFO of waiters; _rr is the DRR rotation order over
        # tenants with backlog; _deficits the per-tenant grant credit.
        self._waiting: dict[str, deque] = {}
        self._rr: deque = deque()
        self._deficits: dict[str, float] = {}
        self._ewma_ms = _EWMA_INIT_MS
        # Lifetime counters for snapshot() — kept locally so
        # /debug/health reports them even without a stats backend.
        self.admitted = 0
        self.shed = 0

    # -- prediction ----------------------------------------------------

    def _predicted_wait_ms(self, ahead: int) -> float:
        """Expected queue wait for a request with ``ahead`` requests in
        front of it: the gate drains ``concurrency`` requests per EWMA
        service time."""
        return ahead * self._ewma_ms / self.concurrency

    def _predicted_ahead_locked(self, tenant: str) -> int:
        """How many grants land before a new arrival of ``tenant``
        under the DRR schedule.  Sole-tenant: everyone queued (the
        legacy global prediction).  Multi-tenant: the tenant's own
        backlog plus each other tenant's share over the rounds ours
        needs — a victim tenant's first request predicts a short wait
        even when a hot tenant has the queue deep."""
        own_q = self._waiting.get(tenant)
        own = len(own_q) if own_q else 0
        others = len(self._waiting) - (1 if own_q else 0)
        if others <= 0:
            return self._queued
        weight = max(1, int(self._weight_of(tenant)))
        rounds = own // weight + 1
        ahead = own
        for t, dq in self._waiting.items():
            if t != tenant:
                ahead += min(
                    len(dq), rounds * max(1, int(self._weight_of(t)))
                )
        return ahead

    def _retry_after_s(self, predicted_ms: float) -> float:
        return min(
            max(predicted_ms / 1000.0, _MIN_RETRY_AFTER_S),
            _MAX_RETRY_AFTER_S,
        )

    def _shed_locked(self, predicted_ms: float, reason: str) -> "rz.ShedError":
        self.shed += 1
        return rz.ShedError(
            f"admission: {self.name} {reason} "
            f"(active={self._active}/{self.concurrency} "
            f"queued={self._queued}/{self.queue_depth} "
            f"predicted_wait_ms={predicted_ms:.0f})",
            retry_after_s=self._retry_after_s(predicted_ms),
            cost_class=self.name,
        )

    # -- admission -----------------------------------------------------

    def acquire(
        self,
        deadline: "rz.Deadline | None",
        tenant: str = DEFAULT_TENANT,
    ) -> Ticket:
        """Admit (possibly after a bounded, deadline-clamped queue wait)
        or raise :class:`ShedError` without blocking on anything but
        this gate's own lock.  Stats emit OUTSIDE the critical section
        — this lock sits on every request's path."""
        t0 = time.monotonic()
        try:
            wait_ms = self._acquire_locked(deadline, t0, tenant)
        except rz.ShedError:
            self.stats.count_with_custom_tags(
                "net.admission.shed", 1, [f"class:{self.name}"]
            )
            raise
        self.stats.count_with_custom_tags(
            "net.admission.admitted", 1, [f"class:{self.name}"]
        )
        if wait_ms > 0:
            self.stats.histogram("net.admission.queueWaitMs", wait_ms)
        return Ticket(self, wait_ms, tenant)

    def _acquire_locked(
        self, deadline: "rz.Deadline | None", t0: float, tenant: str
    ) -> float:
        """The lock-held admission decision; returns the queue wait in
        ms or raises :class:`ShedError`."""
        with self._mu:
            if self._active < self.concurrency and self._queued == 0:
                self._active += 1
                self.admitted += 1
                return 0.0
            own_q = self._waiting.get(tenant)
            own = len(own_q) if own_q else 0
            predicted_ms = self._predicted_wait_ms(
                self._predicted_ahead_locked(tenant) + 1
            )
            # The queue bound is PER TENANT: a hot tenant filling its
            # allotment cannot consume another tenant's right to queue.
            if own >= self.queue_depth:
                raise self._shed_locked(predicted_ms, "queue full")
            if (
                deadline is not None
                and deadline.remaining_ms() < predicted_ms + self._ewma_ms
            ):
                # Queuing would only produce a 504 after the fact —
                # answer 429 now, before any work happens.
                raise self._shed_locked(
                    predicted_ms, "predicted wait exceeds deadline"
                )
            w = _Waiter(tenant, self._mu)
            self._enqueue_locked(w)
            self._queued += 1
            try:
                while not w.granted:
                    timeout = None
                    if deadline is not None:
                        timeout = deadline.remaining()
                        if timeout <= 0:
                            self._remove_waiter_locked(w)
                            raise self._shed_locked(
                                self._predicted_wait_ms(self._queued),
                                "deadline expired in queue",
                            )
                    w.cv.wait(timeout)
            finally:
                self._queued -= 1
            # _active was taken on our behalf by the scheduler at grant
            # time, so the slot is never double-issued.
            self.admitted += 1
            return (time.monotonic() - t0) * 1000.0

    # -- weighted-fair queue (lock held) -------------------------------

    def _enqueue_locked(self, w: _Waiter) -> None:
        dq = self._waiting.get(w.tenant)
        if dq is None:
            dq = self._waiting[w.tenant] = deque()
            self._rr.append(w.tenant)
            # Arrive with a full round's credit: a fresh tenant is
            # servable at its first rotation slot.
            self._deficits.setdefault(
                w.tenant, float(max(1, int(self._weight_of(w.tenant))))
            )
        dq.append(w)

    def _drop_tenant_locked(self, tenant: str) -> None:
        self._waiting.pop(tenant, None)
        try:
            self._rr.remove(tenant)
        except ValueError:
            pass
        self._deficits.pop(tenant, None)

    def _remove_waiter_locked(self, w: _Waiter) -> None:
        dq = self._waiting.get(w.tenant)
        if dq is None:
            return
        try:
            dq.remove(w)
        except ValueError:
            return
        if not dq:
            self._drop_tenant_locked(w.tenant)

    def _next_waiter_locked(self) -> "_Waiter | None":
        """Deficit round-robin: serve the head tenant while it has
        credit; otherwise top its deficit up by its weight and rotate.
        Weight >= 1 guarantees progress within one full rotation, so
        the starvation bound for any backlogged tenant is one rotation
        of grants, independent of other tenants' backlog depth."""
        while self._rr:
            t = self._rr[0]
            dq = self._waiting.get(t)
            if not dq:
                self._rr.popleft()
                self._deficits.pop(t, None)
                continue
            if self._deficits.get(t, 0.0) >= 1.0:
                self._deficits[t] -= 1.0
                w = dq.popleft()
                if not dq:
                    self._drop_tenant_locked(t)
                return w
            self._deficits[t] = self._deficits.get(t, 0.0) + float(
                max(1, int(self._weight_of(t)))
            )
            self._rr.rotate(-1)
        return None

    def _schedule_locked(self) -> None:
        while self._active < self.concurrency:
            w = self._next_waiter_locked()
            if w is None:
                return
            self._active += 1
            w.granted = True
            w.cv.notify()

    def _release(self, service_s: float) -> None:
        with self._mu:
            self._active -= 1
            self._ewma_ms = (
                _EWMA_ALPHA * service_s * 1000.0
                + (1.0 - _EWMA_ALPHA) * self._ewma_ms
            )
            self._schedule_locked()

    # -- introspection -------------------------------------------------

    def snapshot(self) -> dict:
        with self._mu:
            out = {
                "concurrency": self.concurrency,
                "queueDepth": self.queue_depth,
                "active": self._active,
                "queued": self._queued,
                "ewmaServiceMs": round(self._ewma_ms, 3),
                "admitted": self.admitted,
                "shed": self.shed,
            }
            if self._waiting:
                out["queuedByTenant"] = {
                    t: len(dq) for t, dq in sorted(self._waiting.items())
                }
            return out


class AdmissionController:
    """Per-class gates behind one handle.  The Handler acquires a
    ticket per request (query routes classify from the parsed plan;
    import routes are ``write``; remote legs are ``internal``) and
    releases it when the response is computed.  With a
    :class:`TenantRegistry` attached, acquisition also debits the
    tenant's quota (client classes only) and queues through the
    weighted-fair scheduler."""

    def __init__(
        self,
        point_concurrency: int = 32,
        heavy_concurrency: int = 8,
        write_concurrency: int = 16,
        internal_concurrency: int = 128,
        subscribe_concurrency: int = 4,
        queue_depth: int = 64,
        stats=None,
        tenants: "TenantRegistry | None" = None,
    ):
        self.tenants = tenants
        weight_of = tenants.weight if tenants is not None else None
        self._gates = {
            CLASS_POINT: _ClassGate(
                CLASS_POINT, point_concurrency, queue_depth, stats, weight_of
            ),
            CLASS_HEAVY: _ClassGate(
                CLASS_HEAVY, heavy_concurrency, queue_depth, stats, weight_of
            ),
            CLASS_WRITE: _ClassGate(
                CLASS_WRITE, write_concurrency, queue_depth, stats, weight_of
            ),
            # The internal lane's queue is as wide as its gate: a map
            # leg briefly over the limit should wait (its coordinator
            # holds budget), but a pile-up twice the gate deep means
            # the node is genuinely saturated and must shed so the
            # coordinator can fail over.  No WFQ here — legs are
            # charged to their origin tenant but never queued behind a
            # tenant boundary.
            CLASS_INTERNAL: _ClassGate(
                CLASS_INTERNAL,
                internal_concurrency,
                max(1, int(internal_concurrency)),
                stats,
            ),
            # The subscribe lane gates standing-query work — the
            # registration snapshot and the notifier's batch
            # evaluation.  Narrow by design: push freshness degrades
            # under load, pull latency doesn't.
            CLASS_SUBSCRIBE: _ClassGate(
                CLASS_SUBSCRIBE, subscribe_concurrency, queue_depth, stats
            ),
        }

    def gate(self, cls: str) -> _ClassGate:
        return self._gates[cls]

    def acquire(
        self,
        cls: str,
        deadline: "rz.Deadline | None" = None,
        tenant: str = "",
        nbytes: int = 0,
    ) -> Ticket:
        """Admit a request of class ``cls`` or raise
        :class:`resilience.ShedError`.  ``deadline`` defaults to the
        contextvar-current one (the handler's deadline scope).
        ``tenant`` defaults to the registry's default tenant;
        ``nbytes`` is the request's ingress size for the bytes/s
        quota."""
        if deadline is None:
            deadline = rz.current_deadline()
        reg = self.tenants
        t = tenant or (
            reg.default_tenant if reg is not None else DEFAULT_TENANT
        )
        if reg is not None and cls != CLASS_INTERNAL:
            reg.check_quota(t, cls, nbytes)
        try:
            ticket = self._gates[cls].acquire(deadline, tenant=t)
        except QuotaError:
            raise
        except rz.ShedError as e:
            e.tenant = t
            if reg is not None:
                reg.note_shed(t, cls)
            raise
        if reg is not None:
            reg.note_admitted(t, cls, ticket.wait_ms)
        return ticket

    def snapshot(self) -> dict:
        return {name: g.snapshot() for name, g in self._gates.items()}

    def tenants_snapshot(self) -> dict:
        """The ``GET /debug/tenants`` body."""
        if self.tenants is None:
            return {}
        return self.tenants.snapshot()

    def gauges(self) -> dict[str, float]:
        """Scrape-time gauges for /metrics (net.admission.* per class,
        plus per-tenant queue depth and quota headroom)."""
        out: dict[str, float] = {}
        for name, g in self._gates.items():
            snap = g.snapshot()
            out[f"net.admission.active[class:{name}]"] = snap["active"]
            out[f"net.admission.queued[class:{name}]"] = snap["queued"]
            out[f"net.admission.concurrency[class:{name}]"] = snap[
                "concurrency"
            ]
            out[f"net.admission.ewmaServiceMs[class:{name}]"] = snap[
                "ewmaServiceMs"
            ]
            for tname, depth in snap.get("queuedByTenant", {}).items():
                out[
                    f"net.admission.tenantQueued[class:{name},tenant:{tname}]"
                ] = depth
        if self.tenants is not None:
            out.update(self.tenants.gauges())
        return out
