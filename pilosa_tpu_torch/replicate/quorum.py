"""Quorum replication coordinator — tunable W-of-N writes.

The counterpart of ``pilosa_tpu.replicate.quorum``, with the same wire
(headers, hint kinds, ``/debug/replication`` document).

One :class:`Replication` per server composes the subsystem: the
per-slice version store (``versions.py``), the hinted-handoff log
(``hints.py``), the background hint replayer, and the read-repair
code (``repair.py``).  The executor's write fan-out routes through
:meth:`Replication.coordinate_write`; reads at quorum/all consistency
route through :meth:`ensure_read_consistency`.

Write contract (Dynamo-style, DeCandia et al. SOSP'07):

* N = the slice's replica set; W = ``required_acks(consistency, N)``
  with consistency one/quorum/all (``[cluster] write-consistency``,
  per-request ``X-Write-Consistency``).
* The coordinator applies locally first (capturing the exact per-view
  deltas), stamps its post-apply slice version onto every remote leg
  (``X-Write-Version`` — replicas max-merge), and fans out.
* Every UNREACHABLE replica gets the write queued as a hint; acks <
  W raises :class:`QuorumWriteError` LOUDLY — but the hints are already
  queued, so a failed request that partially applied still converges.
* Hints replay when the target's circuit breaker re-admits traffic
  (open -> half-open, ``net/resilience.py``), on the internal admission
  lane, throttled by ``[cluster] hint-replay-throttle-mbps``; each
  drained slice checksum-verifies against the target and escalates to
  a full delta-machinery push on disagreement.
"""

from __future__ import annotations

import json
import os
import threading
import time

from pilosa_tpu_torch.net import resilience
from pilosa_tpu_torch.replicate import hints as hints_mod
from pilosa_tpu_torch.replicate import repair as repair_mod
from pilosa_tpu_torch.replicate.hints import HintLog
from pilosa_tpu_torch.replicate.versions import VersionStore

CONSISTENCY_LEVELS = ("one", "quorum", "all")

# Remote write legs carry the coordinator's post-apply slice version as
# "<slice>:<version>"; the replica handler max-merges it.
WRITE_VERSION_HEADER = "X-Write-Version"
# Per-request consistency overrides on /query (and the import client).
WRITE_CONSISTENCY_HEADER = "X-Write-Consistency"
READ_CONSISTENCY_HEADER = "X-Read-Consistency"


def required_acks(level: str, n: int) -> int:
    """W for a consistency level over ``n`` replicas: one=1,
    quorum=floor(n/2)+1, all=n (never below 1, never above n)."""
    n = max(int(n), 1)
    if level == "one":
        return 1
    if level == "all":
        return n
    if level == "quorum":
        return n // 2 + 1
    raise ValueError(f"unknown consistency level: {level!r}")


def validate_level(level: str, what: str = "consistency") -> str:
    if level not in CONSISTENCY_LEVELS:
        raise ValueError(
            f"invalid {what}: {level!r} (expected one of "
            f"{'/'.join(CONSISTENCY_LEVELS)})"
        )
    return level


class QuorumWriteError(RuntimeError):
    """A write gathered fewer than W acknowledgements.  The acked
    replicas (and the coordinator's hints for the failed ones) keep the
    write durable — the request fails loudly so the CLIENT knows the
    consistency contract was not met and can retry (replays are
    idempotent set/clear)."""

    def __init__(self, level: str, acks: int, needed: int, n: int, failures):
        self.level = level
        self.acks = acks
        self.needed = needed
        self.replicas = n
        self.failures = list(failures)
        detail = "; ".join(f"{h}: {e}" for h, e in self.failures)
        super().__init__(
            f"write acknowledged by {acks} of {n} replicas "
            f"(need {needed} at consistency={level})"
            + (f": {detail}" if detail else "")
        )


class ReadConsistencyError(RuntimeError):
    """Fewer than R replicas answered a version-checked read."""

    def __init__(self, level: str, index: str, slice_i: int, got: int, need: int):
        super().__init__(
            f"read at consistency={level} reached {got} of {need} required "
            f"replicas for {index}/{slice_i}"
        )


class Replication:
    """The server's replication wiring in one handle."""

    def __init__(
        self,
        host: str = "",
        cluster=None,
        holder=None,
        client_factory=None,
        rebalancer=None,
        tracer=None,
        stats=None,
        logger=None,
        data_dir: str = "",
        write_consistency: str = "quorum",
        read_consistency: str = "one",
        hint_cap: int = 10_000,
        hint_replay_throttle_mbps: float = 0.0,
    ):
        from pilosa_tpu_torch.obs import trace
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.host = host
        self.cluster = cluster
        self.holder = holder
        self.client_factory = client_factory
        # The server's Rebalancer: its transition-independent
        # /rebalance/delta actions (start/copy/replay/checksum/stop)
        # ARE the repair data plane — read-repair and hint-replay
        # escalation drive them instead of growing a second one.
        self.rebalancer = rebalancer
        self.tracer = tracer or trace.NOP_TRACER
        self.stats = stats or NopStatsClient()
        self.logger = logger or (lambda m: None)
        self.data_dir = data_dir
        self.write_consistency = validate_level(
            write_consistency, "write-consistency"
        )
        self.read_consistency = validate_level(
            read_consistency, "read-consistency"
        )
        self.versions = VersionStore(stats=self.stats)
        self.hints = HintLog(cap=hint_cap, stats=self.stats)
        self.hint_replay_throttle_mbps = float(hint_replay_throttle_mbps)
        # Hint replay cadence; the breaker's open->half-open transition
        # gates the actual push, this only bounds discovery latency.
        self.replay_interval_s = 2.0
        self._closing = threading.Event()
        self._replay_thread: threading.Thread | None = None
        self._replay_mu = threading.Lock()  # one replay pass at a time
        self._versions_flushed = 0  # bump-count at last persist

    # -- lifecycle -----------------------------------------------------

    def _state_path(self) -> str:
        return os.path.join(self.data_dir, ".replication.json")

    def open(self) -> None:
        """Restore persisted versions and start the replayer."""
        if self.data_dir:
            try:
                with open(self._state_path()) as f:
                    self.versions.load_doc(json.load(f).get("versions", {}))
            except (OSError, ValueError):
                pass
        self._closing.clear()
        self._replay_thread = threading.Thread(
            target=self._replay_loop, daemon=True, name=f"hint-replay:{self.host}"
        )
        self._replay_thread.start()

    def close(self) -> None:
        self._closing.set()
        self._persist_versions()

    def _persist_versions(self) -> None:
        if not self.data_dir:
            return
        try:
            os.makedirs(self.data_dir, exist_ok=True)
            tmp = self._state_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"versions": self.versions.to_doc()}, f)
            os.replace(tmp, self._state_path())
        except OSError as e:
            self.logger(f"replicate: version persist failed: {e}")

    # -- write-listener leg (registered by the server) -----------------

    def on_local_write(
        self, frag, set_rows, set_cols, clear_rows, clear_cols, exact=True
    ):
        """Fragment write hook: advance the slice's version and feed the
        coordinator's capture scope (``exact`` is irrelevant: version
        bumps and hint capture are idempotent per bit).  Called under
        the fragment lock — leaf locks only.

        The listener registry is PROCESS-global while servers are
        per-node: in-process multi-server setups (tests, benches) would
        otherwise count every server's writes in every store — only
        fragments under THIS node's data dir are ours."""
        if self.data_dir and not str(getattr(frag, "path", "")).startswith(
            self.data_dir
        ):
            return
        self.versions.bump(frag.index, frag.slice)
        hints_mod.record_local_write(
            frag, set_rows, set_cols, clear_rows, clear_cols
        )

    # -- the quorum write path (executor._write_one_view) --------------

    def write_consistency_for(self, opt) -> str:
        level = getattr(opt, "write_consistency", "") or self.write_consistency
        return validate_level(level, "write-consistency")

    def coordinate_write(
        self, executor, index, c, opt, view, write_fn, row_id, col_id,
        slice_i, targets,
    ) -> bool:
        """W-of-N write: local apply (captured) -> stamped remote
        fan-out -> hints for unreachable replicas -> loud sub-W failure.
        Returns the write's changed-bit like the legacy path."""
        from pilosa_tpu_torch.pql.parser import Query

        level = self.write_consistency_for(opt)
        # W derives from the slice's replica set; during a rebalance
        # transition ``targets`` additionally carries the new ring's
        # owners (dual-write) whose acks count toward W.
        n = len(self.cluster.fragment_nodes(index, slice_i)) or len(targets)
        need = required_acks(level, n)
        acks = 0
        ret = False
        failures: list[tuple[str, Exception]] = []
        captured: list = []
        local = next((nd for nd in targets if nd.host == self.host), None)
        remotes = [nd for nd in targets if nd.host != self.host]
        with self.tracer.span(
            "replicate", consistency=level, replicas=n, targets=len(targets)
        ) as sp:
            if local is not None:
                with hints_mod.capture(captured):
                    if write_fn(view, row_id, col_id):
                        ret = True
                acks += 1
            # Stamp AFTER the local apply so the version covers it.
            ver = self.versions.get(index, slice_i)
            headers = {WRITE_VERSION_HEADER: f"{slice_i}:{ver}"}
            for node in remotes:
                try:
                    res = executor._exec_remote(
                        node, index, Query(calls=[c]), None,
                        extra_headers=headers, opt=opt,
                    )
                    acks += 1
                    if res and res[0]:
                        ret = True
                except resilience.DeadlineExceeded:
                    raise
                except Exception as e:  # noqa: BLE001 — replica boundary
                    if not resilience.is_node_failure(e):
                        raise
                    failures.append((node.host, e))
            for host, _e in failures:
                if captured:
                    queued = self.hints.queue_views(host, captured)
                else:
                    # Coordinator does not replicate the slice: queue
                    # the call itself; PQL replays through the target's
                    # whole write path (all views, timestamps intact).
                    queued = int(
                        self.hints.queue_pql(host, index, slice_i, str(c))
                    )
                if queued:
                    self.stats.count(
                        "cluster.replication.hintsQueued", queued
                    )
            sp.annotate(acks=acks, needed=need, hinted=len(failures))
            self.stats.count_with_custom_tags(
                "cluster.replication.acks", acks, [f"class:{level}"]
            )
            if acks < need:
                self.stats.count("cluster.replication.writeFailures")
                sp.annotate(error="sub-quorum")
                raise QuorumWriteError(level, acks, need, n, failures)
        return ret

    # -- version-checked reads (executor.execute) ----------------------

    def read_consistency_for(self, opt) -> str:
        level = getattr(opt, "read_consistency", "") or self.read_consistency
        return validate_level(level, "read-consistency")

    def ensure_read_consistency(self, index: str, slices, level: str) -> int:
        """Version-check ``slices`` across their replica sets at R =
        required_acks(level); synchronously read-repair any diverged
        slice (push newest -> stale through the delta machinery) so the
        serving replica — whichever the router picks — answers with the
        quorum-agreed state.  Returns the number of slices repaired."""
        diverged = repair_mod.check_versions(self, index, slices, level)
        repaired = 0
        for slice_i, owners, by_host in diverged:
            self.stats.count("cluster.replication.divergence")
            repair_mod.repair_slice(self, index, slice_i, owners, by_host)
            repaired += 1
        return repaired

    # -- delta-machinery access (shared with repair.py) ----------------

    def _delta(self, host: str, payload: dict) -> dict:
        """One /rebalance/delta action against ``host`` — direct when it
        is this node (no self-HTTP), POSTed otherwise."""
        if host == self.host and self.rebalancer is not None:
            return self.rebalancer.delta_action(payload)
        client = self.client_factory(host)
        client.timeout = max(client.timeout, 600.0)
        status, data = client._request(
            "POST", "/rebalance/delta", body=json.dumps(payload).encode()
        )
        return json.loads(client._check(status, data) or b"{}")

    def local_checksums(self, index: str, slice_i: int) -> dict[str, str]:
        if self.rebalancer is not None:
            return self.rebalancer.delta_action(
                {"index": index, "slice": slice_i, "action": "checksum"}
            )["checksums"]
        return {}

    def replicates_locally(self, index: str, slice_i: int) -> bool:
        """Whether this node holds fragments of the slice (a hint holder
        that does can checksum-verify its replay)."""
        idx = self.holder.index(index) if self.holder is not None else None
        if idx is None:
            return False
        for frame in idx.frames().values():
            for view in frame.views().values():
                if view.fragment(slice_i) is not None:
                    return True
        return False

    # -- hint replay ---------------------------------------------------

    def _replay_loop(self) -> None:
        while not self._closing.wait(self.replay_interval_s):
            try:
                self.replay_tick()
            except Exception as e:  # noqa: BLE001 — replayer must survive
                self.logger(f"replicate: replay tick error: {e}")

    def replay_tick(self) -> dict[str, int]:
        """One discovery pass: attempt a replay for every target with a
        backlog.  The first RPC rides the shared per-host breaker gate
        (``InternalClient._prepare``), so while the target's breaker is
        OPEN the attempt fails in microseconds — and the attempt that
        lands after ``open_s`` IS the half-open probe: the breaker's
        open -> half-open transition is the replay trigger, and a
        successful replay doubles as the probe that closes the breaker.
        Persists versions opportunistically."""
        out: dict[str, int] = {}
        for target in self.hints.targets():
            if self._closing.is_set():
                break
            out[target] = self.replay_target(target)
        self._persist_versions()
        return out

    def replay_now(self, target: str | None = None) -> dict[str, int]:
        """Synchronous replay (ops / tests): bypasses the breaker gate —
        the operator asserted the target is back."""
        out = {}
        for t in [target] if target else self.hints.targets():
            out[t] = self.replay_target(t)
        return out

    def replay_target(self, target: str) -> int:
        """Drain and push one target's hints in application order on the
        internal admission lane; a push that dies mid-way requeues the
        unapplied tail.  After each slice drains, checksum-verify
        against the target (when this node replicates the slice) and
        escalate to a full delta-machinery push on disagreement; then
        stamp the target's version forward."""
        with self._replay_mu:
            return self._replay_target_locked(target)

    def _replay_target_locked(self, target: str) -> int:
        client = self.client_factory(target)
        replayed = 0
        throttle = _Throttle(self.hint_replay_throttle_mbps * 1e6 / 8.0)
        groups = self.hints.drain(target)
        for g, (index, slice_i, entries, overflowed) in enumerate(groups):
            for i, entry in enumerate(entries):
                try:
                    throttle.charge(_entry_bytes(entry))
                    self._apply_entry(client, index, slice_i, entry)
                except Exception as e:  # noqa: BLE001 — target boundary
                    # A dead push must not lose ANYTHING drained: the
                    # current group's unapplied tail AND every
                    # not-yet-touched group go back head-first.
                    self.hints.requeue(target, index, slice_i, entries[i:])
                    for r_index, r_slice, r_entries, _r_of in groups[g + 1 :]:
                        self.hints.requeue(target, r_index, r_slice, r_entries)
                    self.hints.note_replay(target, replayed, error=str(e))
                    self.stats.count(
                        "cluster.replication.hintsReplayed", replayed
                    )
                    return replayed
            replayed += len(entries)
            try:
                # An overflowed group lost hints: force the checksum
                # reconciliation (full push on disagreement) instead of
                # trusting the partial stream.
                self._verify_replay(
                    client, target, index, slice_i, force=overflowed
                )
            except Exception as e:  # noqa: BLE001 — verification is additive
                self.logger(
                    f"replicate: post-replay verify of {index}/{slice_i} "
                    f"on {target} failed: {e}"
                )
        self.hints.note_replay(target, replayed)
        if replayed:
            self.stats.count("cluster.replication.hintsReplayed", replayed)
            self.logger(
                f"replicate: replayed {replayed} hint(s) to {target}"
            )
        return replayed

    def _apply_entry(self, client, index: str, slice_i: int, entry: tuple):
        kind = entry[0]
        if kind == "views":
            _, frame, view, sr, sc, cr, cc = entry
            client.import_view_bits(
                index, frame, view, slice_i, (sr, sc), (cr, cc)
            )
        elif kind == "pql":
            client.execute_query(index, entry[1], remote=True)
        elif kind == "import":
            client.import_raw(entry[1])
        elif kind == "import-value":
            client.import_value_raw(entry[1])
        else:
            raise ValueError(f"unknown hint entry kind: {kind!r}")

    def _verify_replay(
        self, client, target: str, index: str, slice_i: int,
        force: bool = False,
    ):
        """Replay-to-checksum-agreement: when this node replicates the
        slice, its state is the reference — disagreement after a full
        drain means the target missed MORE than the hints covered
        (overflow, pre-hint divergence), so escalate to the full
        delta-machinery push.  ``force`` marks an overflowed group
        (hints were dropped): verification is mandatory there."""
        if not force and not self.replicates_locally(index, slice_i):
            return
        if force and not self.replicates_locally(index, slice_i):
            # Nothing local to compare against: hand convergence to
            # anti-entropy/read-repair, loudly.
            self.logger(
                f"replicate: hint overflow for {index}/{slice_i} on "
                f"{target} with no local replica; anti-entropy owns it"
            )
            return
        local = self.local_checksums(index, slice_i)
        remote = self._delta(
            target, {"index": index, "slice": slice_i, "action": "checksum"}
        )["checksums"]
        if any(remote.get(k) != v for k, v in local.items()):
            repair_mod.push_slice(self, self.host, target, index, slice_i)
            self.stats.count("cluster.replication.replayEscalations")
        client.observe_version(
            index, slice_i, self.versions.get(index, slice_i)
        )

    # -- observability -------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /debug/replication`` document."""
        t = self._replay_thread
        return {
            "node": self.host,
            "writeConsistency": self.write_consistency,
            "readConsistency": self.read_consistency,
            "hints": self.hints.snapshot(),
            "versions": self.versions.snapshot(),
            "replay": {
                "intervalS": self.replay_interval_s,
                "throttleMbps": self.hint_replay_throttle_mbps,
                "running": bool(t is not None and t.is_alive()),
            },
        }


class _Throttle:
    """Token throttle on replay bytes (``hint-replay-throttle-mbps``):
    bulk hint drains must not saturate a recovering node's uplink."""

    def __init__(self, bytes_per_sec: float):
        self._rate = float(bytes_per_sec)
        self._sent = 0
        self._t0 = time.monotonic()

    def charge(self, nbytes: int) -> None:
        if self._rate <= 0:
            return
        self._sent += nbytes
        ahead = self._sent / self._rate - (time.monotonic() - self._t0)
        if ahead > 0:
            time.sleep(min(ahead, 1.0))


def _entry_bytes(entry: tuple) -> int:
    kind = entry[0]
    if kind == "views":
        return 16 * (len(entry[3]) + len(entry[5])) or 16
    if kind in ("import", "import-value"):
        return len(entry[1])
    return len(entry[1])
