"""Read-repair — version-checked replica reads, convergence on demand.

A read at consistency quorum/all version-checks each touched slice
across its replica set BEFORE executing: R replicas must answer, and if
their per-slice write versions disagree the coordinator synchronously
repairs — checksum comparison first (equal checksums mean only the
version counters drifted: stamp them forward, copy nothing), then a
newest->stale push through the rebalance subsystem's transition-
independent delta machinery (bulk fragment tar over the chunked data
plane + delta-log replay to checksum agreement) when content actually
diverged.  The router may then hand the slice to ANY replica — all of
them now carry the quorum-agreed state, which is what makes
read-your-writes hold at W+R > N.

The same ``push_slice`` is the hint replayer's escalation path when a
drained hint stream fails its post-replay checksum verification.
"""

from __future__ import annotations

from pilosa_tpu_torch.net import resilience

# Replay-verify rounds per repair push before giving up (mirrors the
# rebalance coordinator's copy loop).
_REPAIR_ROUNDS = 3


class RepairError(RuntimeError):
    pass


def check_versions(rep, index: str, slices, level: str):
    """Version-check ``slices`` at R = required_acks(level, N).

    Returns ``[(slice, owners, versions_by_host), ...]`` for slices
    whose reachable replicas DISAGREE; raises
    :class:`~pilosa_tpu_torch.replicate.quorum.ReadConsistencyError` when
    fewer than R replicas of some slice answer.  One versions RPC per
    replica host covers every slice it owns (batched, not per-slice).
    """
    from pilosa_tpu_torch.replicate.quorum import ReadConsistencyError, required_acks

    owners_of: dict[int, list] = {}
    host_slices: dict[str, list[int]] = {}
    for s in slices:
        owners = rep.cluster.fragment_nodes(index, s)
        if len(owners) < 2:
            continue  # single replica: nothing to agree with
        owners_of[int(s)] = owners
        for node in owners:
            host_slices.setdefault(node.host, []).append(int(s))
    if not owners_of:
        return []

    got: dict[str, dict[int, int]] = {}
    for host, hs in host_slices.items():
        if host == rep.host:
            got[host] = rep.versions.get_many(index, hs)
            continue
        try:
            got[host] = rep.client_factory(host).replicate_versions(index, hs)
        except Exception as e:  # noqa: BLE001 — replica boundary
            if not resilience.is_node_failure(e):
                raise
            rep.stats.count("cluster.replication.versionCheckFailures")

    diverged = []
    for s, owners in sorted(owners_of.items()):
        need = required_acks(level, len(owners))
        by_host = {
            n.host: got[n.host][s]
            for n in owners
            if n.host in got and s in got[n.host]
        }
        if len(by_host) < need:
            raise ReadConsistencyError(level, index, s, len(by_host), need)
        if len(set(by_host.values())) > 1:
            diverged.append((s, owners, by_host))
    rep.stats.count("cluster.replication.versionChecks", len(owners_of))
    return diverged


def repair_slice(rep, index: str, slice_i: int, owners, by_host) -> str:
    """Converge one diverged slice; returns the repair cause
    (``"version-only"`` or ``"content"``).

    Checksums gate the copy: replicas whose version counters drifted
    (crash-reset, missed stamp) but whose CONTENT agrees just get their
    versions stamped forward — no bytes move.  Real divergence copies
    newest -> each stale replica through the delta machinery.
    """
    reachable = [h for h in by_host]
    checks: dict[str, dict[str, str]] = {}
    for host in reachable:
        try:
            if host == rep.host:
                checks[host] = rep.local_checksums(index, slice_i)
            else:
                checks[host] = rep._delta(
                    host,
                    {"index": index, "slice": slice_i, "action": "checksum"},
                )["checksums"]
        except Exception as e:  # noqa: BLE001 — replica boundary
            if not resilience.is_node_failure(e):
                raise

    max_ver = max(by_host.values())
    distinct = {tuple(sorted(c.items())) for c in checks.values()}
    if len(distinct) <= 1:
        cause = "version-only"
    else:
        cause = "content"
        # Newest replica wins; break version ties toward the replica-set
        # order (the primary).
        source = next(
            h
            for h in sorted(
                by_host, key=lambda h: (-by_host[h], _owner_rank(owners, h))
            )
            if h in checks
        )
        for target in reachable:
            if target == source or checks.get(target) == checks.get(source):
                continue
            push_slice(rep, source, target, index, slice_i)
    for host in reachable:
        _stamp_version(rep, host, index, slice_i, max_ver)
    rep.stats.count_with_custom_tags(
        "cluster.replication.readRepairs", 1, [f"cause:{cause}"]
    )
    rep.logger(
        f"replicate: read-repair of {index}/{slice_i} ({cause}; "
        f"versions {by_host})"
    )
    return cause


def push_slice(rep, src: str, dst: str, index: str, slice_i: int) -> None:
    """Push ``src``'s slice state onto ``dst`` to checksum agreement:
    open the copy window (delta log) on the source, stream every view's
    fragment tar through the chunked data plane, then replay writes that
    raced the stream until source/target checksums agree — the
    rebalancer's migration copy loop, scoped to one repair."""
    base = {"index": index, "slice": int(slice_i)}
    throttle = rep.hint_replay_throttle_mbps * 1e6 / 8.0
    try:
        for _attempt in range(2):
            rep._delta(src, {**base, "action": "start"})
            rep._delta(
                src,
                {
                    **base,
                    "action": "copy",
                    "target": dst,
                    "throttleBytesPerSec": throttle,
                },
            )
            for _round in range(_REPAIR_ROUNDS):
                r = rep._delta(
                    src, {**base, "action": "replay", "target": dst}
                )
                if r.get("overflowed"):
                    break  # write storm outran the log: recopy
                cks = rep._delta(src, {**base, "action": "checksum"})[
                    "checksums"
                ]
                ckt = rep._delta(dst, {**base, "action": "checksum"})[
                    "checksums"
                ]
                if all(ckt.get(k) == v for k, v in cks.items()):
                    rep.stats.count("cluster.replication.repairPushes")
                    return
        raise RepairError(
            f"repair push {index}/{slice_i} {src} -> {dst} failed to "
            "checksum-verify"
        )
    finally:
        try:
            rep._delta(src, {**base, "action": "stop"})
        except Exception:  # noqa: BLE001 — window close is best-effort
            pass


def _stamp_version(rep, host: str, index: str, slice_i: int, version: int):
    try:
        if host == rep.host:
            rep.versions.observe(index, slice_i, version)
        else:
            rep.client_factory(host).observe_version(index, slice_i, version)
    except Exception as e:  # noqa: BLE001 — stamping is additive
        if not resilience.is_node_failure(e):
            raise


def _owner_rank(owners, host: str) -> int:
    for i, n in enumerate(owners):
        if n.host == host:
            return i
    return len(owners)
