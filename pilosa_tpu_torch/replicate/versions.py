"""Per-slice monotonic write versions — the replication staleness oracle.

Every locally-applied fragment write bumps the owning (index, slice)'s
version; the quorum coordinator stamps its post-apply version onto each
remote write leg (``X-Write-Version``), and replicas MAX-MERGE the stamp
into their own counter.  Two replicas that received the same write
stream therefore converge to the same number, and a replica that missed
writes (down, partitioned, shed) sits visibly behind — the read path's
version check and the syncer's skip-if-agree fast path both key on
exactly this comparison, and hint replay closes the gap it exposes.

Versions are advisory (checksums stay the authoritative divergence
detector): equal versions short-circuit work, unequal versions trigger a
checksum comparison, never a blind copy.  The store persists to
``<data-dir>/.replication.json`` at close and on replay ticks so a
cleanly-restarted replica still compares; a crash resets to the last
flush, which reads as stale and costs one checksum agreement round.
"""

from __future__ import annotations

import threading


class VersionStore:
    """Monotonic per-(index, slice) write version counters.

    ``_mu`` is a LEAF lock: bump/observe run inside the fragment write
    path (under the fragment lock via the write-listener hook), so this
    store must never call out while holding it.
    """

    def __init__(self, stats=None):
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self._mu = threading.Lock()
        self._versions: dict[tuple[str, int], int] = {}
        self.stats = stats or NopStatsClient()

    def bump(self, index: str, slice_i: int) -> int:
        """One locally-applied write: advance and return the version."""
        key = (index, int(slice_i))
        with self._mu:
            v = self._versions.get(key, 0) + 1
            self._versions[key] = v
            return v

    def bump_many(self, index: str, slice_i: int, n: int) -> int:
        """Advance by ``n`` locally-applied writes under ONE lock
        acquisition — WAL recovery replays thousands of ops and stamps
        them in a single call so quorum accounting catches up without
        a per-op lock storm.  Returns the resulting version."""
        if n <= 0:
            return self.get(index, slice_i)
        key = (index, int(slice_i))
        with self._mu:
            v = self._versions.get(key, 0) + int(n)
            self._versions[key] = v
            return v

    def observe(self, index: str, slice_i: int, version: int) -> int:
        """Max-merge a coordinator-stamped (or repair-pushed) version;
        returns the resulting local version.  Never moves backwards."""
        key = (index, int(slice_i))
        version = int(version)
        with self._mu:
            v = self._versions.get(key, 0)
            if version > v:
                v = version
                self._versions[key] = v
            return v

    def get(self, index: str, slice_i: int) -> int:
        with self._mu:
            return self._versions.get((index, int(slice_i)), 0)

    def get_many(self, index: str, slices) -> dict[int, int]:
        with self._mu:
            return {
                int(s): self._versions.get((index, int(s)), 0) for s in slices
            }

    def drop_index(self, index: str) -> None:
        with self._mu:
            self._versions = {
                k: v for k, v in self._versions.items() if k[0] != index
            }

    # -- persistence (.replication.json) -------------------------------

    def to_doc(self) -> dict:
        with self._mu:
            return {f"{i}/{s}": v for (i, s), v in self._versions.items()}

    def load_doc(self, doc: dict) -> None:
        """Restore persisted versions (max-merged, so a partial flush
        can never regress a live counter)."""
        for key, v in (doc or {}).items():
            index, _, slice_s = key.rpartition("/")
            try:
                self.observe(index, int(slice_s), int(v))
            except (TypeError, ValueError):
                continue

    def snapshot(self, per_slice_cap: int = 256) -> dict:
        """The ``/debug/replication`` versions block: per-index summary
        plus the per-slice map (capped — a 10k-slice index summarizes)."""
        with self._mu:
            items = sorted(self._versions.items())
        by_index: dict[str, dict] = {}
        for (index, slice_i), v in items:
            ent = by_index.setdefault(
                index, {"slices": 0, "max": 0, "bySlice": {}}
            )
            ent["slices"] += 1
            ent["max"] = max(ent["max"], v)
            if len(ent["bySlice"]) < per_slice_cap:
                ent["bySlice"][str(slice_i)] = v
        return by_index
