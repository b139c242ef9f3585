"""Observability: stats clients, hierarchical tags, latency histograms,
query-path distributed tracing, Prometheus exposition.

reference: stats.go (StatsClient interface + nop/expvar/multi impls),
statsd/statsd.go (DataDog dogstatsd client).  trace.py (Span/Tracer with
X-Trace-Id/X-Span-Id propagation) and prom.py (/metrics rendering) are
pilosa_tpu extensions.

The port keeps its own copies of the JAX package's ``obs/stats.py``,
``obs/trace.py`` and ``obs/prom.py`` (none of them imports JAX), so that
it imports nothing of that package; ``obs/perf.py`` is the JAX package's
launch telemetry with the port's launch sites (``exec/executor.py``,
``exec/coalesce.py``).  The tests hold each copy against its original.
"""

from pilosa_tpu_torch.obs.stats import (
    ExpvarStatsClient,
    MultiStatsClient,
    NopStatsClient,
    StatsDClient,
    new_stats_client,
)
from pilosa_tpu_torch.obs.trace import NOP_TRACER, NopTracer, Span, Tracer

__all__ = [
    "ExpvarStatsClient",
    "MultiStatsClient",
    "NOP_TRACER",
    "NopStatsClient",
    "NopTracer",
    "Span",
    "StatsDClient",
    "Tracer",
    "new_stats_client",
]
