"""Query-path distributed tracing — Span/Tracer with cross-node links.

Dapper-model tracing (low-overhead, always-on, sampled retention): every
query gets a trace; the last ``capacity`` finished traces are retained in
a ring buffer served as JSON by ``GET /debug/traces``.

A trace is a tree of :class:`Span` objects sharing one ``trace_id``.
Spans time with ``time.monotonic()`` and link parent→child two ways:

* in-process via a ``contextvars.ContextVar`` holding the active span —
  crossing threads works because the executor's pool captures the
  submitting context (``contextvars.copy_context``);
* across nodes via W3C-style headers: the coordinator's rpc span id
  travels as ``X-Trace-Id``/``X-Span-Id`` on the fan-out request, the
  remote handler continues the trace under that parent, and the remote's
  finished spans return in an ``X-Trace-Spans`` response header that the
  client absorbs back into the coordinator's open trace — so ONE trace
  on the coordinator covers parse, plan, local slice execution, and
  every remote node's leg.

``NOP_TRACER`` is the disabled implementation: components constructed
without a tracer (unit tests, embedders) pay one no-op method call per
span site.
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
import uuid
from collections import deque

# Propagation headers (W3C trace-context shaped: 16-byte trace id,
# 8-byte span id, hex).
TRACE_HEADER = "X-Trace-Id"
SPAN_HEADER = "X-Span-Id"
SPANS_HEADER = "X-Trace-Spans"

# Bounds: spans retained per trace and spans exported in the response
# header — a pathological query cannot balloon memory or the header.
MAX_SPANS_PER_TRACE = 512
MAX_EXPORT_SPANS = 128

_current_span: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "pilosa_current_span", default=None
)


def current_span() -> "Span | None":
    """The context-current span (None outside any trace) — lets layers
    without a Tracer handle (retry policy, clients) annotate the span
    they run under."""
    return _current_span.get()


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 16 bytes hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]  # 8 bytes hex


class Span:
    """One timed operation within a trace.

    Usable as a context manager (activates itself as the current span
    for the dynamic extent, finishes on exit, and records the exception
    type on error paths).
    """

    __slots__ = (
        "tracer",
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "start",
        "_t0",
        "duration_ms",
        "tags",
        "_token",
    )

    def __init__(self, tracer, name: str, trace_id: str, parent_id: str | None,
                 tags: dict | None = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.start = time.time()
        self._t0 = time.monotonic()
        self.duration_ms: float | None = None
        self.tags = dict(tags) if tags else {}
        self._token = None

    def annotate(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def activate(self):
        """Make this the current span; returns a token for deactivate()."""
        return _current_span.set(self)

    def deactivate(self, token) -> None:
        _current_span.reset(token)

    def finish(self) -> None:
        if self.duration_ms is None:
            self.duration_ms = (time.monotonic() - self._t0) * 1000.0
            self.tracer._record(self)

    def __enter__(self) -> "Span":
        self._token = self.activate()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            self.deactivate(self._token)
            self._token = None
        if exc_type is not None:
            self.tags.setdefault("error", exc_type.__name__)
        self.finish()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_ms": round(self.duration_ms, 3)
            if self.duration_ms is not None
            else None,
            "tags": self.tags,
        }


class Tracer:
    """Collects spans into traces; retains finished traces in a ring."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._mu = threading.Lock()
        # trace_id -> {"root": Span, "spans": [span dicts], "started": t}
        self._open: dict[str, dict] = {}
        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        # Spans that finished after their trace was finalized (debug aid).
        self.late_spans = 0

    # -- span creation --------------------------------------------------

    def current(self) -> Span | None:
        return _current_span.get()

    def start_trace(
        self,
        name: str,
        trace_id: str | None = None,
        parent_span_id: str | None = None,
        **tags,
    ) -> Span:
        """Open a trace root.  ``trace_id``/``parent_span_id`` continue a
        propagated trace (the remote leg of a fan-out); both None starts
        a fresh trace."""
        span = Span(self, name, trace_id or new_trace_id(), parent_span_id, tags)
        with self._mu:
            self._open[span.trace_id] = {"root": span, "spans": []}
        return span

    def span(self, name: str, parent: Span | None = None, **tags) -> Span:
        """A child of ``parent`` (default: the context-current span).
        Without any active trace the span still times and works as a
        context manager, but is never retained."""
        parent = parent or _current_span.get()
        if parent is None:
            return Span(self, name, new_trace_id(), None, tags)
        return Span(self, name, parent.trace_id, parent.span_id, tags)

    # -- recording ------------------------------------------------------

    def _record(self, span: Span) -> None:
        with self._mu:
            ent = self._open.get(span.trace_id)
            if ent is None:
                self.late_spans += 1
                return
            if ent["root"] is span:
                return  # the root records at finish_root
            if len(ent["spans"]) < MAX_SPANS_PER_TRACE:
                ent["spans"].append(span.to_dict())

    def absorb(self, payload: "str | dict") -> None:
        """Merge a remote node's exported spans (the ``X-Trace-Spans``
        response header) into the matching open trace."""
        try:
            if isinstance(payload, str):
                payload = json.loads(payload)
            trace_id = payload["trace_id"]
            spans = payload["spans"]
        except (ValueError, KeyError, TypeError):
            return
        with self._mu:
            ent = self._open.get(trace_id)
            if ent is None:
                self.late_spans += 1
                return
            room = MAX_SPANS_PER_TRACE - len(ent["spans"])
            ent["spans"].extend(
                s for s in spans[:room] if isinstance(s, dict)
            )

    def finish_root(self, root: Span) -> dict | None:
        """Finish the trace root, finalize the trace, retain it in the
        ring, and return the trace record."""
        if root.duration_ms is None:
            root.duration_ms = (time.monotonic() - root._t0) * 1000.0
        with self._mu:
            ent = self._open.pop(root.trace_id, None)
            if ent is None:
                return None
            record = {
                "trace_id": root.trace_id,
                "name": root.name,
                "start": root.start,
                "duration_ms": round(root.duration_ms, 3),
                "spans": [root.to_dict()] + ent["spans"],
            }
            self._ring.append(record)
            return record

    # -- consumption ----------------------------------------------------

    def traces(self, min_ms: float = 0.0) -> list[dict]:
        """Retained traces, most recent last; ``min_ms`` filters on the
        root duration."""
        with self._mu:
            out = list(self._ring)
        if min_ms > 0:
            out = [t for t in out if t["duration_ms"] >= min_ms]
        return out

    def remote_headers(self, span: Span) -> dict[str, str]:
        """Headers that continue ``span``'s trace on a remote node."""
        return {TRACE_HEADER: span.trace_id, SPAN_HEADER: span.span_id}

    @staticmethod
    def export_payload(record: dict) -> str:
        """Compact JSON for the ``X-Trace-Spans`` response header."""
        return json.dumps(
            {
                "trace_id": record["trace_id"],
                "spans": record["spans"][:MAX_EXPORT_SPANS],
            },
            separators=(",", ":"),
        )


def stage_breakdown(record: dict) -> dict[str, float]:
    """Total milliseconds per span name — the slow-query log's per-stage
    breakdown.  The root span is excluded (it IS the total)."""
    root_id = record["spans"][0]["span_id"] if record["spans"] else None
    out: dict[str, float] = {}
    for s in record["spans"]:
        if s["span_id"] == root_id:
            continue
        if s["duration_ms"] is not None:
            out[s["name"]] = round(out.get(s["name"], 0.0) + s["duration_ms"], 3)
    return out


class _NopSpan(Span):
    """Inert span: annotate/finish/context-manager are no-ops beyond
    context activation (children of a nop span are nop spans)."""

    def __init__(self):  # noqa: D107 — singleton, no tracer
        pass

    def annotate(self, **tags):
        return self

    def activate(self):
        return None

    def deactivate(self, token):
        pass

    def finish(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


NOP_SPAN = _NopSpan()


class NopTracer(Tracer):
    """Tracing disabled: every span site costs one method call."""

    def __init__(self):
        super().__init__(capacity=1)

    def start_trace(self, name, trace_id=None, parent_span_id=None, **tags):
        return NOP_SPAN

    def span(self, name, parent=None, **tags):
        return NOP_SPAN

    def absorb(self, payload):
        pass

    def finish_root(self, root):
        return None

    def traces(self, min_ms: float = 0.0):
        return []

    def remote_headers(self, span):
        return {}


NOP_TRACER = NopTracer()
