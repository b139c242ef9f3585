"""SSE framing for standing-query delivery, on the stream plane.

Server-Sent Events over the existing chunked-transfer machinery
(net/handler.py ``Response.stream`` → ``stream.body.IterBody``), with
one deliberate difference: IterBody re-slices producer chunks into
fixed-size output chunks, buffering until one fills — correct for bulk
export, fatal for push delivery (an update would sit in the buffer
until enough LATER updates arrive to flush it).  :class:`EventBody`
therefore passes producer chunks through verbatim: every yielded SSE
event is written (and flushed) as its own chunk the moment it exists.

Wire format (one event per notification)::

    event: update
    id: <version>
    data: {"id": "...", "version": N, "epoch": E, "value": ...}

plus ``: keepalive`` comment lines while idle, so intermediaries don't
reap the connection and clients can distinguish "quiet" from "dead".
"""

from __future__ import annotations

import json
from collections.abc import Iterable

from pilosa_tpu_torch.stream.body import IterBody

CONTENT_TYPE = "text/event-stream"
KEEPALIVE = b": keepalive\n\n"


class EventBody(IterBody):
    """IterBody that does NOT rechunk — each produced event flushes
    immediately as its own transfer chunk."""

    def __init__(self, chunks: Iterable[bytes]):
        super().__init__(chunks, chunk_bytes=1)

    def __iter__(self):
        return iter(self._source)


def format_event(update: dict) -> bytes:
    """One ``update`` event: the SSE ``id:`` field carries the
    subscription version, so a reconnecting client resumes with
    ``?after=<last id>`` (at-least-once, version-monotonic)."""
    data = json.dumps(update, separators=(",", ":"))
    return (
        f"id: {update['version']}\nevent: update\ndata: {data}\n\n"
    ).encode()


def event_stream(manager, sub, after: int, keepalive_s: float = 15.0):
    """Generator of SSE frames for one subscription: every retained
    update newer than ``after`` (or the current snapshot when the
    queue rotated past it), then live updates as the engine publishes
    them; keepalive comments while idle.  Ends when the subscription
    is unregistered or the manager shuts down.  The ``finally`` leg
    runs on client disconnect too (IterBody.close reaches the
    generator), so stream accounting can't leak."""
    with sub.cv:
        sub.streams += 1
    try:
        yield b": subscribed\n\n"
        while True:
            upd = manager.wait_update(sub, after, timeout=keepalive_s)
            if upd is None:
                if sub.closed:
                    return
                yield KEEPALIVE
                continue
            after = upd["version"]
            yield format_event(upd)
    finally:
        with sub.cv:
            sub.streams -= 1
