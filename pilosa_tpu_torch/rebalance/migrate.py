"""Rebalancer — per-node topology-event application plus the
coordinator state machine that migrates slices in the background.

Every node runs a :class:`Rebalancer` (the server owns it).  Topology
events (begin / flip / unflip / commit / abort) arrive over HTTP
fan-out at ``POST /cluster/topology`` and apply to the local
:class:`~pilosa_tpu_torch.cluster.topology.Cluster`; each application
persists the transition snapshot to ``<data-dir>/.topology.json`` so a
node that crashes mid-transition reboots with both rings intact.

The node that receives ``POST /cluster/resize`` becomes the
COORDINATOR: it computes the slice-ownership diff
(:func:`pilosa_tpu_torch.rebalance.plan.compute_plan`), fans the transition
to every member, and drives each slice through

    copy window opens (source starts its delta log)
      -> bulk copy: source streams every view's fragment tar to the
         target through the chunked data plane, bandwidth-throttled,
         on the internal admission lane
      -> replay rounds: the delta log drains to the target until the
         source and target fragment checksums agree
      -> FLIP: ownership cuts over atomically per slice via a
         synchronous topology fan-out (reads now route to the target)
      -> final replay drains writes that raced the flip
      -> release: sources not in the new ring drop the slice's
         fragments (device memory and disk returned)

Per-slice progress persists to ``<data-dir>/.rebalance.json`` after
every state change, so a crashed coordinator resumes from the last
completed slice when the operator re-issues the resize.  Abort
reverse-migrates any flipped slices (same machinery, rings swapped)
and then drops the transition — the old ring was never invalidated.

The counterpart of ``pilosa_tpu.rebalance.migrate``.  A copied slice
lands in the target's staged restore (``?stage=true``), which uploads
its mirrors to the target's card.  With a tier store, a fragment whose
store copy is checksum-fresh is copied through the store instead
(``POST /tier/restore`` on the target), and a released fragment uploads
first when its store copy is stale.  Hosts that gossip announces outside
the ring are join candidates (``note_membership``), admitted by a resize
of their own when ``rebalance_on_join`` is set.
"""

from __future__ import annotations

import json
import os
import threading
import time

from pilosa_tpu_torch.rebalance.deltalog import DeltaLog
from pilosa_tpu_torch.rebalance.plan import SliceMove, compute_plan

EVENTS = ("begin", "flip", "unflip", "commit", "abort")

# Per-event fan-out attempts before the coordinator gives up (the slice
# stays in its current state — resumable).
_FANOUT_ATTEMPTS = 3
# Bulk-copy attempts per (slice, target) before the slice fails.
_COPY_ATTEMPTS = 3


class RebalanceError(RuntimeError):
    pass


class _ThrottledChunkReader:
    """File-like over a chunk generator with a bytes/sec ceiling — the
    bandwidth throttle that keeps bulk migration from starving client
    traffic on the source's uplink."""

    def __init__(self, chunks, bytes_per_sec: float = 0.0):
        self._chunks = iter(chunks)
        self._rate = float(bytes_per_sec)
        self._buf = b""
        self._sent = 0
        self._t0 = time.monotonic()
        self.bytes = 0

    def read(self, n: int = -1) -> bytes:
        while n < 0 or len(self._buf) < n:
            try:
                self._buf += next(self._chunks)
            except StopIteration:
                break
        if n < 0:
            out, self._buf = self._buf, b""
        else:
            out, self._buf = self._buf[:n], self._buf[n:]
        self.bytes += len(out)
        if self._rate > 0 and out:
            self._sent += len(out)
            ahead = self._sent / self._rate - (time.monotonic() - self._t0)
            if ahead > 0:
                time.sleep(min(ahead, 1.0))
        return out


class Rebalancer:
    """Topology-event application (every node) + migration coordination
    (the node that received the resize request)."""

    def __init__(self, server):
        self._server = server
        self.delta_log = DeltaLog(
            cap=getattr(server, "rebalance_delta_cap", 50_000),
            stats=server.holder.stats,
        )
        self._mu = threading.Lock()
        self._thread: threading.Thread | None = None
        self._starting = False  # excludes concurrent start_resize entry
        self._stop = threading.Event()
        self._state: dict | None = None  # coordinator per-slice state
        self._last_error = ""
        self._candidates: set[str] = set()  # gossip-announced non-members
        # Test seam: extra pause between slice migrations (lets tests
        # kill the coordinator mid-plan deterministically).
        self.step_delay_s = 0.0

    # -- plumbing ------------------------------------------------------

    @property
    def _cluster(self):
        return self._server.cluster

    @property
    def _holder(self):
        return self._server.holder

    @property
    def _host(self) -> str:
        return self._server.host

    @property
    def _stats(self):
        return self._holder.stats

    def _log(self, msg: str) -> None:
        self._server.logger(f"rebalance: {msg}")

    def _client(self, host: str, timeout: float | None = None):
        client = self._server._client(host)
        if timeout is not None:
            client.timeout = timeout
        return client

    def _post_json(self, host: str, path: str, payload: dict) -> dict:
        client = self._client(host, timeout=600.0)
        status, data = client._request(
            "POST", path, body=json.dumps(payload).encode()
        )
        return json.loads(client._check(status, data) or b"{}")

    # -- persistence ---------------------------------------------------

    def _topology_path(self) -> str:
        return os.path.join(self._server.data_dir, ".topology.json")

    def _state_path(self) -> str:
        return os.path.join(self._server.data_dir, ".rebalance.json")

    @staticmethod
    def _write_json(path: str, doc: dict) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    @staticmethod
    def _read_json(path: str) -> dict | None:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _persist_topology(self) -> None:
        snap = self._cluster.transition_snapshot()
        if snap is None:
            try:
                os.unlink(self._topology_path())
            except OSError:
                pass
        else:
            self._write_json(self._topology_path(), snap)

    def _persist_state(self) -> None:
        if self._state is not None:
            self._write_json(self._state_path(), self._state)

    def _clear_state(self) -> None:
        self._state = None
        try:
            os.unlink(self._state_path())
        except OSError:
            pass

    def resume_from_disk(self) -> None:
        """Restore a persisted transition at boot: both rings (and the
        flipped-slice set) come back before the first query routes, so
        a node that crashed mid-migration neither loses the new ring
        nor routes reads at released fragments.  Migration itself
        resumes when the operator re-issues the resize."""
        snap = self._read_json(self._topology_path())
        if snap:
            try:
                self._cluster.restore_transition(snap)
                self._log(
                    f"restored in-flight transition epoch {snap['epoch']} "
                    f"({len(snap.get('moved', []))} slices already flipped)"
                )
            except Exception as e:  # noqa: BLE001 — boot must proceed
                self._log(f"transition restore failed: {e}")
        self._state = self._read_json(self._state_path())

    # -- topology events (every node) ----------------------------------

    def apply_event(self, ev: dict) -> dict:
        """Apply one fanned-out topology event to the local cluster.
        Idempotent per event; persists the transition snapshot."""
        kind = ev.get("event")
        epoch = int(ev.get("epoch", 0))
        if kind == "begin":
            self._cluster.begin_transition(list(ev["new"]), epoch=epoch)
            self._stats.count("cluster.rebalance.begin")
        elif kind == "flip":
            if self._cluster.flip_slice(str(ev["index"]), int(ev["slice"]), epoch):
                self._stats.count("cluster.rebalance.flips")
        elif kind == "unflip":
            self._cluster.unflip_slice(str(ev["index"]), int(ev["slice"]), epoch)
        elif kind == "commit":
            self._cluster.commit_transition(epoch)
            self._stats.count("cluster.rebalance.commit")
            if self._host not in self._cluster.hosts():
                self._log(
                    "this node left the serving ring at commit; it can "
                    "be shut down once drained traffic stops"
                )
            else:
                # A joining node needs the cluster max-slice picture
                # NOW, not at the next polling tick — a query it
                # coordinates would otherwise undercount remote-only
                # slices.
                poll = getattr(self._server, "tick_max_slices", None)
                if poll is not None:
                    threading.Thread(
                        target=self._safe_poll, args=(poll,), daemon=True,
                        name="rebalance-maxslice-poll",
                    ).start()
        elif kind == "abort":
            self._cluster.abort_transition(epoch)
            self._stats.count("cluster.rebalance.abort")
        else:
            raise RebalanceError(f"unknown topology event: {kind!r}")
        self._persist_topology()
        return {"ok": True, "epoch": self._cluster.epoch}

    @staticmethod
    def _safe_poll(poll) -> None:
        try:
            poll()
        except Exception:  # noqa: BLE001 — advisory refresh
            pass

    def _fanout_event(self, ev: dict, hosts: list[str]) -> None:
        """Apply an event locally, then deliver it SYNCHRONOUSLY to
        every other member — correctness events (begin/flip/commit)
        must reach the whole ring before the coordinator proceeds."""
        self.apply_event(ev)
        errs = []
        for host in hosts:
            if host == self._host:
                continue
            last: Exception | None = None
            for _ in range(_FANOUT_ATTEMPTS):
                try:
                    self._post_json(host, "/cluster/topology", ev)
                    last = None
                    break
                except Exception as e:  # noqa: BLE001 — per-host retry
                    last = e
                    time.sleep(0.2)
            if last is not None:
                errs.append(f"{host}: {last}")
        if errs:
            raise RebalanceError(
                f"topology {ev.get('event')} fanout failed: " + "; ".join(errs)
            )

    # -- gossip join candidates (JAX migrate.py:282-318) ---------------

    def note_membership(self, host: str, state: str) -> None:
        """Track hosts gossip announces outside the serving ring; with
        ``rebalance_on_join`` the lowest-host ring member starts the
        resize that admits them."""
        ring = set(self._cluster.hosts())
        t = self._cluster.transition
        if t is not None:
            ring |= set(t.new_hosts)
        if state != "UP" or host in ring:
            self._candidates.discard(host)
            return
        if host in self._candidates:
            return
        self._candidates.add(host)
        self._log(f"gossip announced non-member {host} (join candidate)")
        if (
            getattr(self._server, "rebalance_on_join", False)
            and t is None
            and self._cluster.hosts()
            and self._host == min(self._cluster.hosts())
        ):
            target = sorted(set(self._cluster.hosts()) | self._candidates)
            threading.Thread(target=self._auto_resize, args=(target,), daemon=True,
                             name="rebalance-on-join").start()

    def _auto_resize(self, hosts: list[str]) -> None:
        try:
            self.start_resize(hosts)
        except Exception as e:  # noqa: BLE001 — advisory trigger
            self._log(f"auto resize to {hosts} failed: {e}")

    # -- coordinator ---------------------------------------------------

    def start_resize(self, hosts: list[str]) -> dict:
        """Begin (or resume) a migration to ``hosts``.  Returns the
        status snapshot; the migration itself runs in the background.

        ``_mu`` only guards entry/exit bookkeeping — the schema push
        and begin fan-out are network round trips and run UNLOCKED
        (the ``_starting`` flag excludes concurrent entries)."""
        hosts = sorted(dict.fromkeys(hosts))
        if not hosts:
            raise RebalanceError("resize needs at least one host")
        with self._mu:
            if self._thread is not None and self._thread.is_alive():
                raise RebalanceError("a resize is already running")
            if self._starting:
                raise RebalanceError("a resize is already starting")
            self._starting = True
        try:
            t = self._cluster.transition
            old_hosts = (
                list(t.old_hosts) if t is not None else self._cluster.hosts()
            )
            if t is not None and t.new_hosts != hosts:
                raise RebalanceError(
                    f"transition to {t.new_hosts} in flight; abort it "
                    "before resizing to a different host set"
                )
            if t is None and hosts == sorted(old_hosts):
                raise RebalanceError("topology unchanged")
            state = self._state or self._read_json(self._state_path())
            if state is not None and (
                state.get("new") != hosts or state.get("completed")
            ):
                state = None
            if t is None:
                epoch = (
                    int(state["epoch"])
                    if state is not None
                    else self._cluster.epoch + 1
                )
                # Joining nodes need the schema BEFORE the transition
                # begins: dual-writes and bulk-copy restores land on
                # them from the first post-begin write.
                for host in hosts:
                    if host not in old_hosts and host != self._host:
                        self._push_schema(host)
                self._fanout_event(
                    {"event": "begin", "epoch": epoch, "new": hosts},
                    sorted(set(old_hosts) | set(hosts)),
                )
            else:
                epoch = t.epoch
            if state is None:
                state = {
                    "epoch": epoch,
                    "old": old_hosts,
                    "new": hosts,
                    "slices": {},
                    "completed": False,
                }
            state.pop("error", None)
            with self._mu:
                self._state = state
                self._last_error = ""
                self._persist_state()
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="rebalance-coordinator"
                )
                self._thread.start()
        finally:
            with self._mu:
                self._starting = False
        return self.snapshot()

    def abort(self) -> dict:
        """Stop migrating, reverse-migrate any flipped slices back to
        the old ring, and drop the transition — the cluster returns to
        its pre-resize topology with no data loss."""
        with self._mu:
            thread = self._thread
            self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=60.0)
        # The reversal below reuses the copy machinery, which honors
        # the stop flag — re-arm it now that the forward run is down.
        self._stop.clear()
        t = self._cluster.transition
        if t is None:
            self._clear_state()
            return self.snapshot()
        epoch = t.epoch
        all_hosts = sorted(set(t.old_hosts) | set(t.new_hosts))
        # Reverse every flipped slice: same per-slice machinery with
        # the rings swapped (the new-ring owner streams back to the
        # old-ring owners that released), then unflip.  Releases of the
        # reverse targets wait until the transition is dropped — while
        # it is active they still count as write owners.
        pending_releases: list[SliceMove] = []
        for index, s in sorted(t.moved):
            move = self._plan_for_slice(index, s)
            if move is None:
                continue
            rev = SliceMove(
                index=index,
                slice=s,
                sources=tuple(
                    h for h in move.sources if h not in move.releases
                ) + move.targets,
                targets=move.releases,
                releases=move.targets,
            )
            self._copy_slice_to_targets(rev, epoch)
            self._fanout_event(
                {"event": "unflip", "epoch": epoch, "index": index, "slice": s},
                all_hosts,
            )
            self._finalize_slice(rev, epoch, release=False)
            pending_releases.append(rev)
        self._fanout_event({"event": "abort", "epoch": epoch}, all_hosts)
        for rev in pending_releases:
            self._release_from(rev)
        self._clear_state()
        self._log("resize aborted; old ring restored")
        return self.snapshot()

    def close(self) -> None:
        self._stop.set()

    def _push_schema(self, host: str) -> None:
        """Replicate the full local schema (indexes, frames, BSI
        fields) to a JOINING node — already-existing objects are
        fine (409s pass)."""
        from pilosa_tpu_torch.net.client import ClientError

        client = self._client(host)

        def _ignore_conflict(fn, *args) -> None:
            try:
                fn(*args)
            except ClientError as e:
                if e.status != 409 and "exists" not in str(e):
                    raise

        for name, idx in self._holder.indexes().items():
            opts: dict = {"columnLabel": idx.column_label}
            if idx.time_quantum:
                opts["timeQuantum"] = idx.time_quantum
            _ignore_conflict(client.create_index, name, opts)
            for fname, f in idx.frames().items():
                fopts: dict = {
                    "rowLabel": f.row_label,
                    "inverseEnabled": f.inverse_enabled,
                    "cacheType": f.cache_type,
                    "cacheSize": f.cache_size,
                }
                if f.time_quantum:
                    fopts["timeQuantum"] = f.time_quantum
                if f.range_enabled:
                    fopts["rangeEnabled"] = True
                _ignore_conflict(client.create_frame, name, fname, fopts)
                for fld in f.bsi_fields():
                    _ignore_conflict(
                        client.create_field,
                        name, fname, fld.name, fld.min, fld.max,
                    )
        self._log(f"schema pushed to joining node {host}")

    def _plan_for_slice(self, index: str, slice_i: int) -> SliceMove | None:
        for m in compute_plan(self._cluster, {index: slice_i}):
            if m.index == index and m.slice == slice_i:
                return m
        return None

    def _index_max_slices(self) -> dict[str, int]:
        out = {}
        for name, idx in self._holder.indexes().items():
            out[name] = max(idx.max_slice(), idx.max_inverse_slice())
        return out

    def _run(self) -> None:
        state = self._state
        try:
            # The plan must cover the CLUSTER's slice range, not just
            # what this node has seen locally — refresh the remote
            # max-slice picture synchronously before planning.
            poll = getattr(self._server, "tick_max_slices", None)
            if poll is not None:
                self._safe_poll(poll)
            moves = compute_plan(self._cluster, self._index_max_slices())
            self._stats.gauge("cluster.rebalance.slicesPlanned", len(moves))
            self._log(
                f"epoch {state['epoch']}: {len(moves)} slice(s) to migrate "
                f"({state['old']} -> {state['new']})"
            )
            for move in moves:
                if self._stop.is_set():
                    self._log("stopped; migration state persisted for resume")
                    return
                entry = state["slices"].setdefault(move.key, {})
                if entry.get("state") == "done":
                    continue
                self._migrate_slice(move, int(state["epoch"]), entry)
                if self.step_delay_s > 0:
                    self._stop.wait(self.step_delay_s)
            if self._stop.is_set():
                return
            all_hosts = sorted(set(state["old"]) | set(state["new"]))
            self._fanout_event(
                {
                    "event": "commit",
                    "epoch": int(state["epoch"]),
                    "new": list(state["new"]),
                },
                all_hosts,
            )
            state["completed"] = True
            self._clear_state()
            self._log(f"resize complete; ring is now {state['new']}")
        except Exception as e:  # noqa: BLE001 — coordinator boundary
            self._last_error = str(e)
            if self._state is not None:
                self._state["error"] = str(e)
                self._persist_state()
            self._log(f"migration error (resumable): {e}")

    # -- per-slice state machine ---------------------------------------

    def _set_slice_state(self, entry: dict, move: SliceMove, st: str) -> None:
        entry["state"] = st
        entry["targets"] = list(move.targets)
        entry["releases"] = list(move.releases)
        self._persist_state()

    def _migrate_slice(self, move: SliceMove, epoch: int, entry: dict) -> None:
        all_hosts = sorted(
            set(self._state["old"]) | set(self._state["new"])
        )
        if entry.get("state") != "flipped":
            # A slice that crashed mid-copy restarts its copy from
            # scratch (idempotent: restore replaces the target state);
            # one that already flipped skips straight to finalize.
            self._set_slice_state(entry, move, "copying")
            self._copy_slice_to_targets(move, epoch)
        # Atomic per-slice cutover: every member flips read routing to
        # the new ring for this slice, synchronously (idempotent on
        # resume).
        self._fanout_event(
            {
                "event": "flip",
                "epoch": epoch,
                "index": move.index,
                "slice": move.slice,
            },
            all_hosts,
        )
        self._set_slice_state(entry, move, "flipped")
        self._finalize_slice(move, epoch)
        self._set_slice_state(entry, move, "done")
        self._stats.count("cluster.rebalance.slicesDone")

    def _copy_slice_to_targets(self, move: SliceMove, epoch: int) -> None:
        src = self._pick_source(move)
        for tgt in move.targets:
            self._copy_one(move, src, tgt)

    def _pick_source(self, move: SliceMove) -> str:
        states = self._cluster.node_states()
        for h in move.sources:
            if states.get(h, "UP") == "UP":
                return h
        return move.sources[0]

    def _copy_one(self, move: SliceMove, src: str, tgt: str) -> None:
        """Bulk copy + replay-until-checksums-agree for one target."""
        throttle = float(getattr(self._server, "rebalance_throttle_mbps", 0.0))
        rounds = int(getattr(self._server, "rebalance_verify_rounds", 3))
        base = {"index": move.index, "slice": move.slice}
        for _attempt in range(_COPY_ATTEMPTS):
            if self._stop.is_set():
                raise RebalanceError("stopped mid-copy")
            # (Re)open the copy window: the source logs every write to
            # this slice from before the snapshot streams.
            self._post_json(src, "/rebalance/delta", {**base, "action": "start"})
            r = self._post_json(
                src,
                "/rebalance/delta",
                {
                    **base,
                    "action": "copy",
                    "target": tgt,
                    # megabits/s -> bytes/s; 0 = unthrottled
                    "throttleBytesPerSec": throttle * 1e6 / 8.0,
                },
            )
            self._stats.count(
                "cluster.rebalance.bytesStreamed", int(r.get("bytes", 0))
            )
            for _round in range(max(rounds, 1)):
                rep = self._post_json(
                    src, "/rebalance/delta", {**base, "action": "replay", "target": tgt}
                )
                self._stats.count(
                    "cluster.rebalance.deltaReplayed", int(rep.get("entries", 0))
                )
                if rep.get("overflowed"):
                    break  # write storm outran the log: redo the copy
                cks = self._post_json(
                    src, "/rebalance/delta", {**base, "action": "checksum"}
                )["checksums"]
                ckt = self._post_json(
                    tgt, "/rebalance/delta", {**base, "action": "checksum"}
                )["checksums"]
                if all(ckt.get(k) == v for k, v in cks.items()):
                    return
                self._stats.count("cluster.rebalance.checksumRetries")
            else:
                continue  # checksums never agreed this attempt: recopy
        raise RebalanceError(
            f"slice {move.key}: copy to {tgt} failed to checksum-verify "
            f"after {_COPY_ATTEMPTS} attempts"
        )

    def _finalize_slice(
        self, move: SliceMove, epoch: int, release: bool = True
    ) -> None:
        """Post-flip: drain writes that raced the cutover, close the
        copy window, and release the slice from hosts leaving it."""
        src = self._pick_source(move)
        base = {"index": move.index, "slice": move.slice}
        for tgt in move.targets:
            self._post_json(
                src, "/rebalance/delta", {**base, "action": "replay", "target": tgt}
            )
        self._post_json(src, "/rebalance/delta", {**base, "action": "stop"})
        if release:
            self._release_from(move)

    def _release_from(self, move: SliceMove) -> None:
        delay = float(getattr(self._server, "rebalance_release_delay_ms", 0.0))
        if move.releases and delay > 0:
            # Let in-flight old-ring reads drain before their data goes.
            self._stop.wait(delay / 1000.0)
        for host in move.releases:
            try:
                self._post_json(
                    host,
                    "/rebalance/release",
                    {"index": move.index, "slice": move.slice},
                )
                self._stats.count("cluster.rebalance.releases")
            except Exception as e:  # noqa: BLE001 — release is best-effort
                # The slice is already flipped; a failed release leaves
                # orphaned (but harmless) data the operator can clean.
                self._log(f"release of {move.key} on {host} failed: {e}")

    # -- source/target-side operations (handler-invoked) ----------------

    def delta_action(self, payload: dict) -> dict:
        index = str(payload.get("index", ""))
        slice_i = int(payload.get("slice", 0))
        action = payload.get("action")
        if action == "start":
            self.delta_log.start(index, slice_i)
            return {"ok": True}
        if action == "stop":
            self.delta_log.stop(index, slice_i)
            return {"ok": True}
        if action == "replay":
            return self._replay(index, slice_i, str(payload.get("target", "")))
        if action == "copy":
            return self._copy_local_slice(
                index,
                slice_i,
                str(payload.get("target", "")),
                float(payload.get("throttleBytesPerSec", 0) or 0),
            )
        if action == "checksum":
            return {"checksums": self._checksums(index, slice_i)}
        raise RebalanceError(f"unknown delta action: {action!r}")

    def _slice_fragments(self, index: str, slice_i: int):
        idx = self._holder.index(index)
        if idx is None:
            return
        for frame in idx.frames().values():
            for view in frame.views().values():
                frag = view.fragment(slice_i)
                if frag is not None:
                    yield frame.name, view.name, frag

    def _checksums(self, index: str, slice_i: int) -> dict[str, str]:
        return {
            f"{frame}/{view}": frag.checksum().hex()
            for frame, view, frag in self._slice_fragments(index, slice_i)
        }

    def _copy_local_slice(
        self, index: str, slice_i: int, target: str, bytes_per_sec: float
    ) -> dict:
        """SOURCE side of the bulk copy: stream every view's fragment
        tar for the slice straight to the target's staged restore —
        chunked, throttled, never materialized.

        With a tier store, a fragment whose store copy carries a
        checksum-fresh logical checksum is restored by the target from
        the store (``POST /tier/restore``) and the source sends nothing
        (``fromStore``).  A stale or missing copy, or a target without a
        tier (501), falls back to the stream; the delta-log replay rounds
        close any gap either way (JAX ``migrate.py:717-760``)."""
        if not target:
            raise RebalanceError("copy needs a target host")
        tier = getattr(self._server, "tier", None)
        client = self._client(target, timeout=600.0)
        views = 0
        nbytes = 0
        from_store = 0
        for frame, view, frag in list(self._slice_fragments(index, slice_i)):
            if tier is not None:
                restored = self._restore_via_store(client, tier, index, frame, view, slice_i, frag)
                if restored is not None:
                    views += 1
                    nbytes += restored
                    from_store += 1
                    continue
            reader = _ThrottledChunkReader(
                frag.tar_chunks(chunk_bytes=self._server.stream_chunk_bytes),
                bytes_per_sec=bytes_per_sec,
            )
            client.restore_slice_from(
                index, frame, view, slice_i, reader, stage=True
            )
            views += 1
            nbytes += reader.bytes
        if from_store:
            self._stats.count("cluster.rebalance.storeRestores", from_store)
        return {"views": views, "bytes": nbytes, "fromStore": from_store}

    def _restore_via_store(self, client, tier, index: str, frame: str, view: str,
                           slice_i: int, frag) -> int | None:
        """One fragment's copy through the store: None sends it by the
        peer stream instead (store copy stale or missing, target without
        a tier, or the restore failed)."""
        try:
            if tier.store_fresh_meta(frag) is None:
                return None
            return client.tier_restore(index, frame, view, slice_i)
        except Exception as e:  # noqa: BLE001 — fall back to streaming
            self._log(f"store-riding copy of {index}/{slice_i} {frame}/{view} "
                      f"fell back to peer stream: {e}")
            return None

    def _replay(self, index: str, slice_i: int, target: str) -> dict:
        """Drain the slice's delta log to the target in application
        order (cutover-scoped anti-entropy)."""
        entries, overflowed = self.delta_log.drain(index, slice_i)
        if overflowed:
            return {"entries": 0, "overflowed": True}
        if entries and not target:
            raise RebalanceError("replay needs a target host")
        client = self._client(target, timeout=600.0) if target else None
        for i, (frame, view, srows, scols, crows, ccols) in enumerate(entries):
            try:
                client.import_view_bits(
                    index, frame, view, slice_i, (srows, scols), (crows, ccols)
                )
            except Exception:
                # A push that dies mid-way must not lose the tail:
                # requeue everything unreplayed and let the coordinator
                # retry the round.
                self.delta_log.requeue(index, slice_i, entries[i:])
                raise
        return {"entries": len(entries), "overflowed": False}

    def release_slice(self, index: str, slice_i: int) -> dict:
        """Drop every local fragment of a slice this node no longer
        owns: the mirrors leave the residency pool and the files leave
        the disk.  With a tier store, a fragment whose store copy is
        stale or absent uploads first (``uploaded``), so the store stays
        a fresh archive of released slices; a failed upload logs and
        counts but never blocks the release."""
        if self._cluster.is_write_owner(self._host, index, slice_i):
            raise RebalanceError(
                f"refusing to release {index}/{slice_i}: this node still "
                "owns it"
            )
        tier = getattr(self._server, "tier", None)
        released = 0
        uploaded = 0
        idx = self._holder.index(index)
        if idx is not None:
            for frame in idx.frames().values():
                for view in frame.views().values():
                    frag = view._fragment_raw(slice_i) if tier is not None else None
                    if frag is not None:
                        try:
                            if tier.store_fresh_meta(frag) is None:
                                tier.upload_fragment(frag)
                                uploaded += 1
                        except Exception as e:  # noqa: BLE001
                            self._stats.count("cluster.rebalance.releaseUploadErrors")
                            self._log(f"release upload of {index}/{slice_i} "
                                      f"{frame.name}/{view.name} failed: {e}")
                    if view.remove_fragment(slice_i):
                        released += 1
        self._stats.count("cluster.rebalance.fragmentsReleased", released)
        return {"released": released, "uploaded": uploaded}

    # -- observability --------------------------------------------------

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def snapshot(self) -> dict:
        """The ``GET /debug/rebalance`` document."""
        out: dict = {
            "node": self._host,
            "epoch": self._cluster.epoch,
            "routingVersion": self._cluster.routing_version,
            "transition": self._cluster.transition_snapshot(),
            "running": self.running(),
            "deltaLog": self.delta_log.snapshot(),
            "deltaOverflows": self.delta_log.overflow_counts(),
            "joinCandidates": sorted(self._candidates),
        }
        if self._last_error:
            out["lastError"] = self._last_error
        state = self._state
        if state is not None:
            slices = state.get("slices", {})
            by_state: dict[str, int] = {}
            for s in slices.values():
                by_state[s.get("state", "?")] = by_state.get(s.get("state", "?"), 0) + 1
            out["coordinator"] = {
                "epoch": state.get("epoch"),
                "old": state.get("old"),
                "new": state.get("new"),
                "completed": state.get("completed", False),
                "sliceStates": by_state,
                "slices": slices,
            }
            if state.get("error"):
                out["coordinator"]["error"] = state["error"]
        return out
