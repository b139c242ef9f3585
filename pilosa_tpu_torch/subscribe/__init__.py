"""Standing queries: push-based PQL subscriptions.

The counterpart of ``pilosa_tpu/subscribe``, with its routes, update
documents and SSE frames.

Clients register ``Subscribe(Count(Intersect(...)))`` / ``Subscribe(
TopN(...))`` / ``Subscribe(Range(...))`` via ``POST /subscribe`` and
receive updates over SSE or long-poll as imports land, instead of
polling the pull path.  The registry compiles each subscription's
expression tree once (``exec.plan.decompose`` after the BSI rewrite)
and indexes it by the (index, frame, row) leaves it touches; a delta
engine fed by the fragment write listeners applies incremental updates
(a changed bit moves a single-leaf Count by exactly ±1; compound trees
re-evaluate only the touched slices, one K2 launch over them; a full
re-run happens only when a touched slice's delta budget
overflows or a TopN ranking may have shifted).  Notification batches
ride the "subscribe" admission lane when an admission controller is
given (the port's waits for ``net/admission.py``), and subscriptions
follow their slices across rebalance
via the topology routing version (snapshot re-evaluation on every
flip, so no update is lost across the cutover).
"""

from pilosa_tpu_torch.subscribe.registry import (  # noqa: F401
    KIND_COUNT,
    KIND_TOPN,
    SubscribeError,
    compile_subscription,
)
from pilosa_tpu_torch.subscribe.engine import (  # noqa: F401,E402
    Subscription,
    SubscriptionManager,
)
