"""Tiered storage — the cold tier below the device mirror and the disk.

The counterpart of ``pilosa_tpu/tier``: a shared OBJECT STORE holds each
fragment as the archive of ``Fragment.write_to`` (the format of the JAX
package's, so a store written by either package serves the other).

* :mod:`pilosa_tpu_torch.tier.store` — the pluggable object store: a
  local-filesystem backend and an S3-style HTTP backend behind one
  interface, with a content checksum on every object and the retry and
  breakers of ``net/resilience.py``.
* :mod:`pilosa_tpu_torch.tier.manager` — the node-side policy: demand
  hydration of ``cold`` fragments (metadata resident, bytes in the
  store) on first touch, throttled, on the prefetcher's hydrate lane;
  a disk budget with LRU demotion back to the store; time-quantum
  retention (age expired views to the store, delete past a second
  horizon); and the cold boot of a node whose data dir is empty.

The ``[tier]`` section of the JAX package's configuration file waits for
the port of ``config.py``; a port node takes the same settings as
``Server`` arguments and CLI flags.
"""

from __future__ import annotations

from pilosa_tpu_torch.tier.store import (  # noqa: F401
    HTTPStore,
    LocalFSStore,
    ObjectMeta,
    ObjectStore,
    StoreChecksumError,
    StoreError,
    open_store,
    serve_store,
)
from pilosa_tpu_torch.tier.manager import (  # noqa: F401
    HydrationError,
    TierError,
    TierManager,
    fragment_store_key,
    parse_fragment_store_key,
)

__all__ = [
    "HTTPStore",
    "HydrationError",
    "LocalFSStore",
    "ObjectMeta",
    "ObjectStore",
    "StoreChecksumError",
    "StoreError",
    "TierError",
    "TierManager",
    "fragment_store_key",
    "open_store",
    "parse_fragment_store_key",
    "serve_store",
]
