"""StatsClient — metrics with hierarchical tags.

Interface parity with the reference (reference: stats.go:34-61):
``tags / with_tags / count / count_with_custom_tags / gauge / histogram /
set / timing``; tag propagation is hierarchical — holder tags
``index:<n>``, then ``frame:<n>``, ``view:<n>``, ``slice:<n>`` via
``with_tags`` (reference: holder.go:259, index.go:443, frame.go:438,
view.go:257).

Implementations: Nop (default), Expvar (in-memory snapshot served by
/debug/vars, reference: stats.go:78-150), StatsD (dogstatsd datagram
format over UDP, reference: statsd/statsd.go), Multi fan-out
(reference: stats.go:152-219).
"""

from __future__ import annotations

import socket
import threading
from collections import defaultdict


def union_string_slice(a: list[str], b: list[str]) -> list[str]:
    """Sorted union (reference: stats.go:222-247)."""
    return sorted(set(a) | set(b))


def _percentile(sorted_values: list[float], q: float) -> float:
    """Linear-interpolated quantile of SORTED ``sorted_values`` (numpy's
    default method): position ``q * (n - 1)`` interpolates between its
    neighbors, so small samples aren't biased the way plain index
    truncation is (``[1,2,3,4]`` p50 = 2.5, not 3)."""
    n = len(sorted_values)
    if n == 1:
        return sorted_values[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


class NopStatsClient:
    """reference: stats.go:66-76"""

    def tags(self) -> list[str]:
        return []

    def with_tags(self, *tags: str) -> "NopStatsClient":
        return self

    def count(self, name: str, value: int = 1) -> None:
        pass

    def count_with_custom_tags(self, name: str, value: int, tags: list[str]) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def histogram(self, name: str, value: float) -> None:
        pass

    def set(self, name: str, value: str) -> None:
        pass

    def timing(self, name: str, value: float) -> None:
        pass

    def close(self) -> None:
        pass


class _ExpvarStore:
    """The shared mutable state behind one Expvar client family
    (``with_tags`` children share their parent's store).  A real class
    rather than a dict so the lock is a named attribute the
    concurrency analyzer (pilosa_tpu/analyze) can track."""

    __slots__ = ("lock", "counts", "gauges", "sets", "histograms",
                 "hist_totals")

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = defaultdict(int)
        self.gauges: dict = {}
        self.sets: dict = {}
        self.histograms = defaultdict(list)
        # Lifetime monotonic [count, sum] per histogram key.  The
        # reservoir above is bounded at 4096 samples, so anything
        # derived from it slides; Prometheus ``rate()`` over ``_count``
        # and ``_sum`` needs monotonic lifetime totals.
        self.hist_totals = defaultdict(lambda: [0, 0.0])


class ExpvarStatsClient:
    """In-memory counters/gauges keyed by tag-qualified names, readable
    as one JSON snapshot from /debug/vars (reference: stats.go:78-150)."""

    def __init__(self, _store: _ExpvarStore | None = None,
                 _tags: list[str] | None = None):
        self._store = _store if _store is not None else _ExpvarStore()
        self._tags = _tags or []

    def _key(self, name: str, tags: list[str] | None = None) -> str:
        all_tags = union_string_slice(self._tags, tags or [])
        if all_tags:
            return f"{name}[{','.join(all_tags)}]"
        return name

    def tags(self) -> list[str]:
        return list(self._tags)

    def with_tags(self, *tags: str) -> "ExpvarStatsClient":
        return ExpvarStatsClient(
            self._store, union_string_slice(self._tags, list(tags))
        )

    def count(self, name: str, value: int = 1) -> None:
        with self._store.lock:
            self._store.counts[self._key(name)] += value

    def count_with_custom_tags(self, name: str, value: int, tags: list[str]) -> None:
        with self._store.lock:
            self._store.counts[self._key(name, tags)] += value

    def gauge(self, name: str, value: float) -> None:
        with self._store.lock:
            self._store.gauges[self._key(name)] = value

    def histogram(self, name: str, value: float) -> None:
        with self._store.lock:
            key = self._key(name)
            h = self._store.histograms[key]
            h.append(value)
            if len(h) > 4096:  # bound memory (percentiles are windowed)
                del h[: len(h) - 4096]
            tot = self._store.hist_totals[key]
            tot[0] += 1
            tot[1] += value

    def set(self, name: str, value: str) -> None:
        with self._store.lock:
            self._store.sets[self._key(name)] = value

    def timing(self, name: str, value: float) -> None:
        self.histogram(name, value)

    def close(self) -> None:
        pass

    def snapshot(self) -> dict:
        """For /debug/vars (and the /metrics Prometheus rendering)."""
        with self._store.lock:
            out: dict = {
                "counts": dict(self._store.counts),
                "gauges": dict(self._store.gauges),
                "sets": dict(self._store.sets),
            }
            hists = {}
            for k, values in self._store.histograms.items():
                if not values:
                    continue
                s = sorted(values)
                tot = self._store.hist_totals.get(k)
                hists[k] = {
                    # Windowed view (last <=4096 samples): min/max/mean
                    # and the percentiles.
                    "n": len(s),
                    "min": s[0],
                    "max": s[-1],
                    "mean": sum(s) / len(s),
                    "p50": _percentile(s, 0.5),
                    "p90": _percentile(s, 0.9),
                    "p99": _percentile(s, 0.99),
                    "p999": _percentile(s, 0.999),
                    # Lifetime monotonic totals (what _count/_sum in the
                    # Prometheus exposition must come from).
                    "count": tot[0] if tot else len(s),
                    "sum": tot[1] if tot else sum(s),
                }
            out["histograms"] = hists
            return out


class StatsDClient:
    """dogstatsd datagram client (reference: statsd/statsd.go:30-127):
    ``pilosa.<name>:<value>|<type>|#tag1,tag2`` over UDP; prefix
    ``pilosa.``, fire-and-forget."""

    PREFIX = "pilosa."
    # Datagram clamp: a metric+tags payload past this many bytes would
    # hit EMSGSIZE (or fragment) on typical MTUs; oversize datagrams
    # drop the tag suffix first, then truncate (dogstatsd servers skip
    # a malformed line; an EMSGSIZE loses it silently either way).
    MAX_PAYLOAD = 1432

    def __init__(self, host: str = "127.0.0.1:8125", _tags: list[str] | None = None):
        self.host = host
        self._tags = _tags or []
        addr, _, port = host.partition(":")
        self._addr = (addr or "127.0.0.1", int(port or 8125))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _send(self, name: str, payload: str, tags: list[str] | None = None) -> None:
        all_tags = union_string_slice(self._tags, tags or [])
        base = f"{self.PREFIX}{name}:{payload}"
        msg = base
        if all_tags:
            msg += f"|#{','.join(all_tags)}"
        data = msg.encode()
        if len(data) > self.MAX_PAYLOAD:
            data = base.encode()
            if len(data) > self.MAX_PAYLOAD:
                # Truncate on a codepoint boundary: a blind byte slice
                # can cut a multi-byte UTF-8 sequence mid-rune, and a
                # malformed datagram is dropped wholesale by dogstatsd.
                cut = self.MAX_PAYLOAD
                while cut > 0 and (data[cut] & 0xC0) == 0x80:
                    cut -= 1
                data = data[:cut]
        try:
            self._sock.sendto(data, self._addr)
        except OSError:
            pass  # fire-and-forget

    def tags(self) -> list[str]:
        return list(self._tags)

    def with_tags(self, *tags: str) -> "StatsDClient":
        c = StatsDClient.__new__(StatsDClient)
        c.host = self.host
        c._tags = union_string_slice(self._tags, list(tags))
        c._addr = self._addr
        c._sock = self._sock
        return c

    def count(self, name: str, value: int = 1) -> None:
        self._send(name, f"{value}|c")

    def count_with_custom_tags(self, name: str, value: int, tags: list[str]) -> None:
        self._send(name, f"{value}|c", tags)

    def gauge(self, name: str, value: float) -> None:
        self._send(name, f"{value}|g")

    def histogram(self, name: str, value: float) -> None:
        self._send(name, f"{value}|h")

    def set(self, name: str, value: str) -> None:
        self._send(name, f"{value}|s")

    def timing(self, name: str, value: float) -> None:
        self._send(name, f"{value}|ms")

    def close(self) -> None:
        """Release the UDP socket.  with_tags children share the parent
        socket, so closing any one releases it for all."""
        self._sock.close()


class MultiStatsClient:
    """Fan-out to several clients (reference: stats.go:152-219)."""

    def __init__(self, clients: list):
        self.clients = list(clients)

    def tags(self) -> list[str]:
        # Union over ALL children, not just the first (parity with
        # reference stats.go MultiStatsClient.Tags).
        out: list[str] = []
        for c in self.clients:
            out = union_string_slice(out, c.tags())
        return out

    def with_tags(self, *tags: str) -> "MultiStatsClient":
        return MultiStatsClient([c.with_tags(*tags) for c in self.clients])

    def count(self, name: str, value: int = 1) -> None:
        for c in self.clients:
            c.count(name, value)

    def count_with_custom_tags(self, name: str, value: int, tags: list[str]) -> None:
        for c in self.clients:
            c.count_with_custom_tags(name, value, tags)

    def gauge(self, name: str, value: float) -> None:
        for c in self.clients:
            c.gauge(name, value)

    def histogram(self, name: str, value: float) -> None:
        for c in self.clients:
            c.histogram(name, value)

    def set(self, name: str, value: str) -> None:
        for c in self.clients:
            c.set(name, value)

    def timing(self, name: str, value: float) -> None:
        for c in self.clients:
            c.timing(name, value)

    def close(self) -> None:
        for c in self.clients:
            close = getattr(c, "close", None)
            if close is not None:
                close()

    def snapshot(self) -> dict:
        for c in self.clients:
            if hasattr(c, "snapshot"):
                return c.snapshot()
        return {}


def new_stats_client(service: str, host: str = ""):
    """reference: server/server.go:236-245"""
    if service in ("", "nop", "none"):
        return NopStatsClient()
    if service == "expvar":
        return ExpvarStatsClient()
    if service == "statsd":
        return StatsDClient(host or "127.0.0.1:8125")
    raise ValueError(f"unknown metrics service: {service!r}")
