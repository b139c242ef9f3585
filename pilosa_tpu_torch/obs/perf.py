"""Per-launch device telemetry and roofline accounting.

The port's copy of the JAX package's ``obs/perf.py``.  Every device
launch site — the executor's direct K2 launch (``direct``), a Count's
total (``total``), the coalescer's shared K2 launch (``coalesce``), the
fused interpreter K3 (``interp``), the fetch lane (``fetch``), the TopN
scorer K4 (``topn``) and the anchored count K5 (``anchored``) — records a
:class:`LaunchRecord` into a lock-light per-site accumulator, and the
derived per-site achieved GB/s is compared against the stream floor the
one-shot probe measured at server open (``device/floorprobe.py``, K11).

Roofline model (Williams et al., CACM 2009): the bitmap kernels are
memory-bound, so "how fast could this go" is the stream floor and
"how fast does it go" is logical plane bytes streamed / launch time.
``GET /debug/perf`` renders the table; ``exec.launch.gbps[site:*]`` /
``exec.launch.floorPct[site:*]`` / ``device.streamFloorGbps`` land on
/metrics as scrape-time gauges.

A launch's ``total_ms`` runs from its enqueue to the end of the host
copy that already waits for its result; no launch site adds a
``torch.cuda.synchronize`` to time it.  So ``total_ms`` includes the
host's own share of a launch (the queue wait on a busy card too), and a
site's GB/s is a lower bound on the kernel's.

Discipline (Dapper-style always-on): ``record_launch`` must stay OFF
every launch path's critical section — per-site locks guard only plain
counter increments, never device work, stats emission, or allocation
beyond one small dict.  ``tests/test_torch_perf.py`` asserts
telemetry-on query p99 within 5% of telemetry-off.

Also here: :class:`LatencyHistograms` — native fixed-bucket cumulative
Prometheus HISTOGRAM families (per query class and per HTTP route,
``[obs] latency-buckets-ms``) with SLO burn-rate gauges against
``[obs] slo-ms`` / ``slo-objective``.  The Expvar reservoir summaries
stay for everything else; these families exist because bucketed
cumulative histograms aggregate across replicas and feed
``histogram_quantile()`` where summaries cannot.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

WORD_BYTES = 4  # uint32 planes

# Rolling per-site launch-duration window (percentiles are a recent
# view, like the Expvar reservoir); lifetime byte/time counters are
# monotonic.
WINDOW = 512
# Recent launches retained for the /debug/perf slowest-launch table.
RECENT = 256
SLOWEST = 16

# Default latency buckets (ms): roughly log-spaced from sub-ms point
# reads to the 60 s query-timeout tail.
DEFAULT_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

# SLO burn-rate window (seconds): the "fast burn" window alerting
# rules page on.  Kept short so a soak shows the burn move.
BURN_WINDOW_S = 300.0


def plane_bytes(rows: int, words: int) -> int:
    """Logical plane bytes streamed for ``rows`` slice-rows of
    ``words`` uint32 words each (slices x leaves x words geometry) —
    the roofline numerator.  Logical means PRE-padding: pad rows are
    bucketing overhead, not useful bytes."""
    return int(rows) * int(words) * WORD_BYTES


class LaunchRecord(dict):
    """One device launch: site, reduce kind, batch occupancy, logical
    bytes streamed, dispatch-vs-completion split, and the submitting
    query's trace id.  A dict subclass so /debug/perf serializes it
    as-is."""

    __slots__ = ()

    def __init__(
        self,
        site: str,
        *,
        reduce: str = "",
        queries: int = 1,
        rows: int = 0,
        n_bytes: int = 0,
        eff_bytes: int = 0,
        dispatch_ms: float = 0.0,
        total_ms: float = 0.0,
        trace_id: str = "",
    ):
        super().__init__(
            site=site,
            reduce=reduce,
            queries=int(queries),
            rows=int(rows),
            bytes=int(n_bytes),
            # Effective bytes actually read by the launch — smaller
            # than the logical geometry for compressed-container
            # launches; defaults to logical for dense launches.
            eff_bytes=int(eff_bytes) or int(n_bytes),
            dispatch_ms=round(float(dispatch_ms), 3),
            total_ms=round(float(total_ms), 3),
            trace_id=trace_id,
        )


class _Site:
    """One launch site's accumulator.  The lock is a LEAF: nothing is
    called while holding it."""

    __slots__ = (
        "lock", "launches", "queries", "rows", "n_bytes", "eff_bytes",
        "dispatch_ms", "total_ms", "window", "reduces",
    )

    def __init__(self):
        self.lock = threading.Lock()
        self.launches = 0
        self.queries = 0
        self.rows = 0
        self.n_bytes = 0
        self.eff_bytes = 0
        self.dispatch_ms = 0.0
        self.total_ms = 0.0
        self.window: deque = deque(maxlen=WINDOW)
        self.reduces: dict[str, int] = {}


def _percentile(sorted_values: list[float], q: float) -> float:
    n = len(sorted_values)
    if n == 1:
        return sorted_values[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


class PerfRegistry:
    """Process-wide launch-telemetry registry (like device.pool(), the
    launch sites it instruments are process-global device state)."""

    def __init__(self, enabled: bool = True):
        self._mu = threading.Lock()  # sites map + recent ring + floor
        self._enabled = enabled
        self._floor_gbps = 0.0
        self._sites: dict[str, _Site] = {}
        self._recent: deque = deque(maxlen=RECENT)

    # -- configuration -------------------------------------------------

    def configure(self, enabled: bool | None = None) -> None:
        if enabled is not None:
            with self._mu:
                self._enabled = bool(enabled)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_floor(self, gbps: float) -> None:
        with self._mu:
            self._floor_gbps = float(gbps)

    def floor_gbps(self) -> float:
        return self._floor_gbps

    def reset(self) -> None:
        """Drop accumulated launches (tests/bench tiers)."""
        with self._mu:
            self._sites = {}
            self._recent = deque(maxlen=RECENT)

    # -- hot path ------------------------------------------------------

    def record_launch(
        self,
        site: str,
        *,
        reduce: str = "",
        queries: int = 1,
        rows: int = 0,
        n_bytes: int = 0,
        eff_bytes: int = 0,
        dispatch_ms: float = 0.0,
        total_ms: float = 0.0,
        trace_id: str = "",
    ) -> None:
        if not self._enabled:
            return
        # Dense launches read exactly their logical geometry; only the
        # compressed-container sites pass a smaller eff_bytes.
        eff = eff_bytes or n_bytes
        st = self._sites.get(site)
        if st is None:
            with self._mu:
                st = self._sites.setdefault(site, _Site())
        with st.lock:
            st.launches += 1
            st.queries += queries
            st.rows += rows
            st.n_bytes += n_bytes
            st.eff_bytes += eff
            st.dispatch_ms += dispatch_ms
            st.total_ms += total_ms
            st.window.append(total_ms)
            if reduce:
                st.reduces[reduce] = st.reduces.get(reduce, 0) + 1
        # Raw tuple, not a LaunchRecord: the dict (with its casts and
        # rounding) is built lazily at snapshot time — the record path
        # runs on launch worker threads whose latency serializes
        # straight into query time.
        with self._mu:
            self._recent.append(
                (site, reduce, queries, rows, n_bytes,
                 dispatch_ms, total_ms, trace_id, eff)
            )

    # -- derived views -------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/perf document: per-site roofline table + the
        slowest recent launches (with trace ids) + the probed floor."""
        with self._mu:
            floor = self._floor_gbps
            enabled = self._enabled
            sites = list(self._sites.items())
            recent = list(self._recent)
        table: dict[str, dict] = {}
        for name, st in sites:
            with st.lock:
                launches = st.launches
                queries = st.queries
                rows = st.rows
                n_bytes = st.n_bytes
                eff_bytes = st.eff_bytes
                dispatch_ms = st.dispatch_ms
                total_ms = st.total_ms
                window = sorted(st.window)
                reduces = dict(st.reduces)
            device_s = total_ms / 1e3
            gbps = (n_bytes / 1e9 / device_s) if device_s > 0 else 0.0
            eff_gbps = (eff_bytes / 1e9 / device_s) if device_s > 0 else 0.0
            row = {
                "launches": launches,
                "queries": queries,
                "rows": rows,
                "bytes": n_bytes,
                "eff_bytes": eff_bytes,
                "occupancy": round(queries / launches, 2) if launches else 0.0,
                "dispatch_ms": round(dispatch_ms, 3),
                "device_ms": round(total_ms, 3),
                "gbps": round(gbps, 3),
                "eff_gbps": round(eff_gbps, 3),
                "reduces": reduces,
            }
            if floor > 0:
                # %-of-floor from EFFECTIVE bytes: a compressed launch
                # reading 1% of its logical geometry must not claim the
                # logical GB/s against the stream floor.  Dense sites
                # (eff == logical) are unchanged.
                row["floor_pct"] = round(100.0 * eff_gbps / floor, 1)
            if window:
                row["p50_ms"] = round(_percentile(window, 0.5), 3)
                row["p99_ms"] = round(_percentile(window, 0.99), 3)
            table[name] = row
        slowest = [
            LaunchRecord(
                t[0], reduce=t[1], queries=t[2], rows=t[3],
                n_bytes=t[4], dispatch_ms=t[5], total_ms=t[6],
                trace_id=t[7], eff_bytes=t[8],
            )
            for t in sorted(recent, key=lambda t: t[6], reverse=True)[:SLOWEST]
        ]
        return {
            "enabled": enabled,
            "floor_gbps": round(floor, 3),
            "sites": table,
            "slowest": slowest,
        }

    def gauges(self) -> dict[str, float]:
        """Scrape-time gauges for /metrics (injected like the
        program-cache gauges, so they render without a stats
        backend)."""
        snap = self.snapshot()
        out: dict[str, float] = {}
        if snap["floor_gbps"] > 0:
            out["device.streamFloorGbps"] = snap["floor_gbps"]
        for site, row in snap["sites"].items():
            out[f"exec.launch.gbps[site:{site}]"] = row["gbps"]
            out[f"exec.launch.effGbps[site:{site}]"] = row["eff_gbps"]
            if "floor_pct" in row:
                out[f"exec.launch.floorPct[site:{site}]"] = row["floor_pct"]
            out[f"exec.launch.launches[site:{site}]"] = row["launches"]
            out[f"exec.launch.bytes[site:{site}]"] = row["bytes"]
            out[f"exec.launch.effBytes[site:{site}]"] = row["eff_bytes"]
        return out


_REGISTRY = PerfRegistry()


def registry() -> PerfRegistry:
    return _REGISTRY


def enabled() -> bool:
    """Cheap pre-flight for the launch sites: record_launch() already
    no-ops when disabled, but the CALLER builds its argument dict
    (plane-byte geometry, np.prod over batch shapes) before the call —
    gating on this keeps telemetry-off truly free on the hot path."""
    return _REGISTRY._enabled


def record_launch(site: str, **kw) -> None:
    """Module-level shorthand the launch sites call."""
    _REGISTRY.record_launch(site, **kw)


def current_trace_id() -> str:
    """Trace id of the caller's active span ("" outside a trace) — for
    launch sites running on the submitting query's thread."""
    from pilosa_tpu_torch.obs import trace

    sp = trace.current_span()
    return getattr(sp, "trace_id", "") or "" if sp is not None else ""


# ---------------------------------------------------------------------------
# native Prometheus histogram families + SLO burn rate
# ---------------------------------------------------------------------------


class _Series:
    __slots__ = ("counts", "sum", "count", "over_slo", "burn", "burn_t")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +Inf tail bucket
        self.sum = 0.0
        self.count = 0
        self.over_slo = 0
        # (monotonic, cumulative count, cumulative over-slo) ring for
        # the windowed burn rate; appended at most ~1/s.
        self.burn: deque = deque(maxlen=int(BURN_WINDOW_S) + 8)
        self.burn_t = 0.0


class LatencyHistograms:
    """Fixed-bucket cumulative latency histograms, rendered as native
    Prometheus ``histogram`` families (``_bucket{le=}``/``_sum``/
    ``_count``) — NOT reservoir summaries: bucket counts are lifetime
    monotonic, so ``rate()``/``histogram_quantile()`` work across
    scrapes and replicas.

    Two families: ``pilosa_query_latency_ms{class=...}`` per admission
    class and ``pilosa_http_latency_ms{method=...,path=...}`` per HTTP
    route template.  With ``slo_ms > 0``, query observations over the
    target count as SLO errors and the windowed burn rate
    (error rate / error budget over the last 5 min) renders as
    ``pilosa_obs_slo_burn_rate{class=...}``."""

    def __init__(
        self,
        buckets_ms=DEFAULT_BUCKETS_MS,
        slo_ms: float = 0.0,
        slo_objective: float = 0.999,
    ):
        bl = sorted(float(b) for b in (buckets_ms or DEFAULT_BUCKETS_MS))
        if not bl:
            bl = list(DEFAULT_BUCKETS_MS)
        self.buckets = tuple(bl)
        self.slo_ms = float(slo_ms)
        self.slo_objective = float(slo_objective)
        self._mu = threading.Lock()  # leaf lock: plain increments only
        # family -> {labels tuple -> _Series}
        self._fams: dict[str, dict[tuple, _Series]] = {
            "query": {}, "http": {}, "tenant": {},
        }

    # -- hot path ------------------------------------------------------

    def observe_query(self, cls: str, ms: float, tenant: str = "") -> None:
        self._observe("query", (("class", cls),), ms)
        if tenant:
            # Separate family, not an extra label on "query": the
            # per-class series (and its SLO burn math) stays exactly
            # what single-tenant dashboards already chart, while
            # tenants get their own histogram + SLO series.
            self._observe(
                "tenant", (("class", cls), ("tenant", tenant)), ms
            )

    def observe_http(self, method: str, path: str, ms: float) -> None:
        self._observe("http", (("method", method), ("path", path)), ms)

    def _observe(self, family: str, labels: tuple, ms: float) -> None:
        i = bisect.bisect_left(self.buckets, ms)
        now = time.monotonic()
        with self._mu:
            fam = self._fams[family]
            s = fam.get(labels)
            if s is None:
                s = fam[labels] = _Series(len(self.buckets))
            if family in ("query", "tenant") and self.slo_ms > 0:
                # Checkpoint the totals BEFORE folding in this sample:
                # the entry marks the window boundary, and the sample
                # itself belongs inside the window.
                if now - s.burn_t >= 1.0:
                    s.burn.append((now, s.count, s.over_slo))
                    s.burn_t = now
                if ms > self.slo_ms:
                    s.over_slo += 1
            s.counts[i] += 1
            s.sum += ms
            s.count += 1

    # -- exposition ----------------------------------------------------

    def _burn(self, s: _Series, now: float) -> tuple[float, float]:
        """(windowed error rate, burn rate) over the last BURN_WINDOW_S."""
        base_count, base_over = 0, 0
        for t, c, o in s.burn:
            if now - t <= BURN_WINDOW_S:
                base_count, base_over = c, o
                break
        d_count = s.count - base_count
        d_over = s.over_slo - base_over
        if d_count <= 0:
            return 0.0, 0.0
        err = d_over / d_count
        budget = 1.0 - self.slo_objective
        return err, (err / budget) if budget > 0 else 0.0

    def render(self) -> str:
        """Exposition text block appended to /metrics (one ``# TYPE``
        per family; cumulative ``le`` buckets per the text-format
        histogram contract)."""
        from pilosa_tpu_torch.obs.prom import _escape, _fmt_value

        with self._mu:
            snap = {
                fam: {
                    labels: (list(s.counts), s.sum, s.count, s.over_slo,
                             list(s.burn))
                    for labels, s in series.items()
                }
                for fam, series in self._fams.items()
            }
        now = time.monotonic()
        out: list[str] = []
        names = {"query": "pilosa_query_latency_ms",
                 "http": "pilosa_http_latency_ms",
                 "tenant": "pilosa_tenant_query_latency_ms"}
        for fam in ("query", "http", "tenant"):
            series = snap[fam]
            if not series:
                continue
            name = names[fam]
            out.append(f"# TYPE {name} histogram")
            for labels in sorted(series):
                counts, total, count, _over, _burn = series[labels]
                lbl = ",".join(
                    f'{k}="{_escape(str(v))}"' for k, v in labels
                )
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    le = _fmt_value(b)
                    out.append(
                        f'{name}_bucket{{{lbl},le="{le}"}} {cum}'
                    )
                cum += counts[-1]
                out.append(f'{name}_bucket{{{lbl},le="+Inf"}} {cum}')
                out.append(f"{name}_sum{{{lbl}}} {_fmt_value(total)}")
                out.append(f"{name}_count{{{lbl}}} {count}")
        if self.slo_ms > 0 and snap["query"]:
            out.append("# TYPE pilosa_obs_slo_target_ms gauge")
            out.append(f"pilosa_obs_slo_target_ms {_fmt_value(self.slo_ms)}")
            out.append("# TYPE pilosa_obs_slo_objective gauge")
            out.append(
                f"pilosa_obs_slo_objective {_fmt_value(self.slo_objective)}"
            )
            err_lines: list[str] = []
            burn_lines: list[str] = []
            slo_series = [("query", ls) for ls in sorted(snap["query"])]
            slo_series += [("tenant", ls) for ls in sorted(snap["tenant"])]
            for fam, labels in slo_series:
                counts, total, count, over, burn = snap[fam][labels]
                s = _Series(len(self.buckets))
                s.count, s.over_slo = count, over
                s.burn = deque(burn)
                err, rate = self._burn(s, now)
                lbl = ",".join(
                    f'{k}="{_escape(str(v))}"' for k, v in labels
                )
                err_lines.append(
                    f"pilosa_obs_slo_error_rate{{{lbl}}} {_fmt_value(round(err, 6))}"
                )
                burn_lines.append(
                    f"pilosa_obs_slo_burn_rate{{{lbl}}} {_fmt_value(round(rate, 4))}"
                )
            out.append("# TYPE pilosa_obs_slo_error_rate gauge")
            out.extend(err_lines)
            out.append("# TYPE pilosa_obs_slo_burn_rate gauge")
            out.extend(burn_lines)
        return "\n".join(out) + ("\n" if out else "")
