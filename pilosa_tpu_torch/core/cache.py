"""Row caches: the TopN ranked cache, an LRU cache, and Pair merging.

Reference behavior being reproduced (reference: cache.go):

* ``RankCache`` — keeps the top ``max_entries`` (row, count) pairs with a
  threshold floor so cold rows are rejected cheaply; re-sorts lazily at
  most every 10 s; trims at 1.1x capacity (reference: cache.go:29-32,
  136-286).
* ``LRUCache`` — plain bounded LRU (reference: cache.go:58-133).
* ``Pairs`` helpers — sorted (id, count) merging used in the TopN reduce
  (reference: cache.go:301-423).

The ranked cache is host-side control metadata: it chooses *candidate*
rows; the actual scoring runs as one launch of the cross-fragment scorer
over every fragment of a node (ops.score_planes) instead of the
reference's per-row sequential loop with threshold pruning.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from collections.abc import Iterable
from typing import Protocol

from pilosa_tpu_torch.obs.stats import NopStatsClient

# reference: cache.go:29-32
DEFAULT_CACHE_SIZE = 50000
THRESHOLD_FACTOR = 1.1
RECALCULATE_INTERVAL_S = 10.0

TYPE_RANKED = "ranked"
TYPE_LRU = "lru"


@dataclass(frozen=True)
class Pair:
    """(row id, count) result pair (reference: cache.go:301-304)."""

    id: int
    count: int


def add_pairs(a: list[Pair], b: list[Pair]) -> list[Pair]:
    """Merge two pair lists summing counts by id (reference: Pairs.Add,
    cache.go:312-334) — the TopN reduce function."""
    counts: dict[int, int] = {}
    for p in a:
        counts[p.id] = counts.get(p.id, 0) + p.count
    for p in b:
        counts[p.id] = counts.get(p.id, 0) + p.count
    return [Pair(i, c) for i, c in counts.items()]


def sort_pairs(pairs: Iterable[Pair]) -> list[Pair]:
    """Count descending, then id ascending — the canonical TopN order."""
    return sorted(pairs, key=lambda p: (-p.count, p.id))


class Cache(Protocol):
    """Row-count cache interface (reference: cache.go:35-55)."""

    def add(self, row_id: int, n: int) -> None: ...
    def bulk_add(self, row_id: int, n: int) -> None: ...
    def get(self, row_id: int) -> int: ...
    def len(self) -> int: ...
    def ids(self) -> list[int]: ...
    def invalidate(self) -> None: ...
    def top(self) -> list[Pair]: ...
    def top_arrays(self): ...
    def recalculate(self) -> None: ...


class LRUCache:
    """Bounded LRU of (row -> count) (reference: cache.go:58-133)."""

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE):
        self.max_entries = max_entries or DEFAULT_CACHE_SIZE
        self._od: OrderedDict[int, int] = OrderedDict()
        # Re-tagged by the owning fragment (index:/frame:/view:/slice:).
        self.stats = NopStatsClient()

    def add(self, row_id: int, n: int) -> None:
        self._od[row_id] = n
        self._od.move_to_end(row_id)
        while len(self._od) > self.max_entries:
            self._od.popitem(last=False)
            self.stats.count("cacheEvict")

    bulk_add = add

    def get(self, row_id: int) -> int:
        if row_id in self._od:
            self._od.move_to_end(row_id)
            self.stats.count("cacheHit")
            return self._od[row_id]
        self.stats.count("cacheMiss")
        return 0

    def len(self) -> int:
        return len(self._od)

    def ids(self) -> list[int]:
        return sorted(self._od.keys())

    def invalidate(self) -> None:
        pass

    def recalculate(self) -> None:
        pass

    def top(self) -> list[Pair]:
        return sort_pairs(Pair(i, c) for i, c in self._od.items())

    def top_arrays(self):
        """(ids, counts) int64 ndarrays in canonical (-count, id) order —
        the array-native twin of top() (LRU caches are small; built on
        demand)."""
        import numpy as np

        pairs = self.top()
        n = len(pairs)
        return (
            np.fromiter((p.id for p in pairs), np.int64, n),
            np.fromiter((p.count for p in pairs), np.int64, n),
        )


class RankCache:
    """Threshold-pruned ranked cache (reference: cache.go:136-286).

    Keeps every row seen until ``max_entries`` is exceeded, then prunes to
    the top ``max_entries`` and records ``threshold_value`` = the smallest
    kept count: later adds below the threshold are rejected without
    touching the rankings.  Rankings are recomputed lazily, at most every
    RECALCULATE_INTERVAL_S unless invalidated.
    """

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE):
        self.max_entries = max_entries or DEFAULT_CACHE_SIZE
        self.entries: dict[int, int] = {}
        self._rankings: list[Pair] = []
        self._arrays = None  # (ids, counts) mirror of _rankings
        self._updated_at = 0.0
        self._stale = True
        self.threshold_value = 0
        # Re-tagged by the owning fragment (index:/frame:/view:/slice:).
        self.stats = NopStatsClient()

    def add(self, row_id: int, n: int) -> None:
        # Reject values below the established floor unless already present
        # (reference: cache.go:171-185).
        if (
            self.threshold_value
            and n < self.threshold_value
            and row_id not in self.entries
        ):
            return
        if n == 0:
            self.entries.pop(row_id, None)
        else:
            self.entries[row_id] = n
        self._stale = True
        if len(self.entries) > self.max_entries * THRESHOLD_FACTOR:
            self._prune()

    bulk_add = add

    def get(self, row_id: int) -> int:
        n = self.entries.get(row_id)
        if n is None:
            self.stats.count("cacheMiss")
            return 0
        self.stats.count("cacheHit")
        return n

    def len(self) -> int:
        return len(self.entries)

    def ids(self) -> list[int]:
        return sorted(self.entries.keys())

    def invalidate(self) -> None:
        """Mark rankings stale.  The actual re-sort stays throttled to
        RECALCULATE_INTERVAL_S (reference: cache.go:236-241) — call
        recalculate() to force it."""
        self._stale = True

    def recalculate(self) -> None:
        self._recompute(force=True)

    def top(self) -> list[Pair]:
        self._recompute()
        return list(self._rankings)

    def top_arrays(self):
        """(ids, counts) int64 ndarrays mirroring top()'s ranking order,
        cached until the next re-sort — the folded TopN path consumes
        candidates array-native, so the per-query cost is two array
        reads instead of an O(cache) Pair walk."""
        import numpy as np

        self._recompute()
        if self._arrays is None:
            n = len(self._rankings)
            self._arrays = (
                np.fromiter((p.id for p in self._rankings), np.int64, n),
                np.fromiter((p.count for p in self._rankings), np.int64, n),
            )
        return self._arrays

    def _recompute(self, force: bool = False) -> None:
        now = time.monotonic()
        if not self._stale:
            return
        if not force and self._rankings and (
            now - self._updated_at < RECALCULATE_INTERVAL_S
        ):
            return
        import numpy as np

        ids = np.fromiter(self.entries.keys(), np.int64, len(self.entries))
        cnts = np.fromiter(self.entries.values(), np.int64, len(self.entries))
        order = np.lexsort((ids, -cnts))[: self.max_entries]  # sort_pairs' order
        self._arrays = (ids[order], cnts[order])
        self._rankings = [Pair(i, c) for i, c in zip(*(a.tolist() for a in self._arrays))]
        self._updated_at = now
        self._stale = False

    def _prune(self) -> None:
        import numpy as np

        ids = np.fromiter(self.entries.keys(), np.int64, len(self.entries))
        cnts = np.fromiter(self.entries.values(), np.int64, len(self.entries))
        keep = np.lexsort((ids, -cnts))[: self.max_entries]  # sort_pairs' order
        dropped = len(ids) - len(keep)
        self.entries = dict(zip(ids[keep].tolist(), cnts[keep].tolist()))
        if dropped > 0:
            self.stats.count("cacheEvict", dropped)
        if len(keep) == self.max_entries and len(keep):
            self.threshold_value = int(cnts[keep[-1]])
        self._stale = True


def new_cache(cache_type: str, size: int):
    if cache_type == TYPE_LRU:
        return LRUCache(size)
    if cache_type == TYPE_RANKED:
        return RankCache(size)
    raise ValueError(f"unknown cache type: {cache_type!r}")
