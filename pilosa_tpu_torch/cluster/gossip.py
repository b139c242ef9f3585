"""Gossip membership — UDP gossip NodeSet + broadcaster.

The port of ``pilosa_tpu/cluster/gossip.py``: the same JSON datagrams,
message types, timers and state blobs (a ``NodeStatus`` protobuf), so a
JAX node and a port node gossip in one membership.

The counterpart of the reference's memberlist-based gossip backend
(reference: gossip/gossip.go:31-222 on hashicorp/memberlist), built on a
small UDP protocol instead of an external library:

  JOIN      → seed replies JOIN-ACK with its member list
  PING      → periodic probe to a random member, piggybacking the local
              member list and (optionally) serialized node state; the
              receiver merges both and replies ACK
  USER      → application messages (the 5 schema broadcast messages,
              type-byte envelope from cluster/broadcast.py)

send_sync delivers a USER datagram to every live member and blocks
until each peer ACKs it, retrying with backoff and raising on peers
that never confirm — the UDP equivalent of the reference's reliable
errgroup-TCP SendSync with error propagation (reference:
gossip.go:124-149).  Receivers dedup message ids so retries stay
exactly-once.  send_async sends to ``gossip_fanout`` random members
and relies on periodic exchange for convergence (reference:
TransmitLimitedQueue, gossip.go:152-164).
Liveness is SWIM-shaped, like memberlist's: a member silent past
``suspect_after`` becomes SUSPECT — still live — and triggers one more
direct PING plus ``indirect_probes`` PING-REQ messages through random
third parties (relay pings the target; the target's ACK at the relay
produces an IND-ACK back to the requester, refreshing the suspect
without direct contact).  Only continued silence on BOTH paths for
another ``suspect_after`` confirms DOWN, so an asymmetric partition
(A↔B blocked, both reach C) never flaps placement (reference surface:
memberlist indirect probing + NotifyLeave → node state DOWN,
gossip/gossip.go:31-45, cluster.go:161-173).

State sync piggybacks a ``state_provider()`` blob on PING/ACK and feeds
received blobs to ``state_merger(blob)`` — the server wires these to
LocalStatus/HandleRemoteStatus so schemas replicate like the
reference's LocalState/MergeRemoteState (reference: gossip.go:191-222,
server.go:382-412).  Small blobs inline in the datagram; blobs too big
for one UDP packet travel as a digest instead, and a receiver that
hasn't merged that digest pulls the state through a chunked
STATE-REQ/STATE-CHUNK exchange — the UDP analog of memberlist's TCP
push/pull state transfer (reference: gossip.go:191-222), so a large
schema can never silently stop syncing at the datagram size limit.
"""

from __future__ import annotations

import base64
import hashlib
import itertools
import json
import random
import socket
import threading
import time
import uuid
from collections import OrderedDict

from pilosa_tpu_torch.testing import faults

# State blobs up to this many raw bytes inline in PING/ACK datagrams;
# larger ones are advertised by digest and fetched chunked (a single UDP
# datagram tops out at ~65507 bytes and base64 inflates 4/3).
INLINE_STATE_MAX = 16 * 1024
# Raw bytes per STATE-CHUNK datagram (b64 -> ~44 KB on the wire).
STATE_CHUNK_SIZE = 32 * 1024
# Partial chunk assemblies are dropped after this long.
_ASSEMBLY_TTL = 30.0
# Hot-slice piggyback caps: slices announced per index per datagram and
# how long a peer's announcement stays fresh enough to steer staging.
HOT_SLICES_MAX = 32
HOT_TTL_S = 120.0
# Blobs larger than this many chunks skip UDP and stream over the
# peer's HTTP listener (the analog of memberlist's TCP push/pull,
# reference: gossip/gossip.go:191-222): a large schema under sustained
# datagram loss would otherwise re-spray the whole chunk set per ping.
STREAM_STATE_CHUNKS = 8
_STREAM_TIMEOUT_S = 10.0
# UDP transfer attempts (REQs sent / assemblies expired) per digest
# before the stream fallback takes over.
_UDP_STATE_MAX_ATTEMPTS = 3
# Failed HTTP streams per digest before falling back to UDP chunking
# even for large blobs (a peer reachable over UDP but not HTTP must
# still converge).  When BOTH paths exhaust a round, the counters reset
# and the alternation starts over.
_STREAM_MAX_FAILURES = 2


def gossip_port_for(host: str, offset: int = 1000) -> int:
    """Default gossip port: HTTP port + offset."""
    _, _, port = host.partition(":")
    return int(port or 10101) + offset


class GossipNodeSet:
    """NodeSet + Broadcaster + BroadcastReceiver in one object, like the
    reference's GossipNodeSet (reference: gossip/gossip.go:31-45)."""

    def __init__(
        self,
        host: str,
        bind: str = "",
        seed: str = "",
        gossip_interval: float = 1.0,
        suspect_after: float = 5.0,
        gossip_fanout: int = 3,
        state_provider=None,
        state_merger=None,
        state_fetcher=None,
        hot_provider=None,
        health_provider=None,
        logger=None,
        stats=None,
        ack_timeout: float = 0.25,
        stream_timeout: float = _STREAM_TIMEOUT_S,
    ):
        self.host = host  # the node's HTTP host:port (cluster identity)
        if bind:
            addr, _, port = bind.partition(":")
            self.bind = (addr or "0.0.0.0", int(port))
        else:
            # Listen on all interfaces; peers must be able to reach us
            # cross-machine.
            self.bind = ("0.0.0.0", gossip_port_for(host))
        # Address advertised in join/ping envelopes: the node's public
        # hostname (from its HTTP identity) + the gossip port — never
        # the wildcard/loopback bind address.
        adv_host = host.partition(":")[0] or "127.0.0.1"
        self.advertise = (adv_host, self.bind[1])
        self.seed = seed  # seed gossip addr "a.b.c.d:port"
        self.gossip_interval = gossip_interval
        self.suspect_after = suspect_after
        self.gossip_fanout = gossip_fanout
        self.state_provider = state_provider
        self.state_merger = state_merger
        # Hot-slice piggyback: ``hot_provider() -> {index: [slice,...]}``
        # rides every PING/ACK (capped, see HOT_SLICES_MAX), announcing
        # which slices this node is actually serving queries over right
        # now.  Receivers keep the per-peer sets; a restarting node
        # reads the union (``remote_hot_slices``) to stage its hottest
        # fragments FIRST (core/holder.stage_device_mirrors).
        self.hot_provider = hot_provider
        self._hot_remote: dict[str, tuple[float, dict]] = {}
        # Device-health piggyback: ``health_provider() -> bool``
        # (degraded = accelerator quarantined, node serving from host
        # planes) rides every PING/ACK; receivers keep the per-peer
        # flag and invoke ``on_peer_health(host, degraded)`` so the
        # server can deprioritize degraded replicas in routing
        # (Cluster.note_degraded).
        self.health_provider = health_provider
        self.on_peer_health = None
        self._health_remote: dict[str, bool] = {}
        # Stream fallback: fetch a peer's whole state blob over its
        # HTTP listener (GET /state) when UDP chunking is the wrong
        # tool — injectable for tests.
        self.state_fetcher = state_fetcher or self._http_state_fetch
        self.logger = logger or (lambda m: None)
        # Datagram traffic counters (gossip.sent/recv + bytes); Nop
        # unless the server wires a real stats client.
        from pilosa_tpu_torch.obs.stats import NopStatsClient

        self.stats = stats or NopStatsClient()

        self._handler = None  # BroadcastHandler (the server)
        self._sock: socket.socket | None = None
        self._closing = threading.Event()
        self._threads: list[threading.Thread] = []
        self._mu = threading.Lock()
        # member -> {addr: (ip, port), last_seen: float,
        #            state: UP|SUSPECT|DOWN}.  SUSPECT is SWIM's middle
        # state: direct pings went unanswered, indirect probes through
        # third parties are in flight, and the member still counts as
        # live until they too fail (memberlist semantics behind
        # reference: gossip/gossip.go:31-45).
        self._members: dict[str, dict] = {}
        # SWIM ping-req relay bookkeeping: suspect host -> {requester
        # gossip addr: deadline} to answer with ind-ack when the suspect
        # acks one of OUR pings.  Keyed by requester so repeated
        # ping-reqs from the same suspecting node refresh one entry
        # instead of accumulating an ind-ack burst.
        self._relay_pending: dict[str, dict[tuple, float]] = {}
        # Indirect probes to issue per suspect per tick.
        self.indirect_probes = 2
        self.on_membership_change = None  # callback(list[(host, state)])
        # Reliable send_sync machinery: per-message ack events on the
        # sender, an id-dedup LRU on the receiver (retries stay
        # exactly-once).  Ids carry a per-process random prefix so a
        # restarted node's fresh counter can never collide with ids a
        # peer remembers from the previous incarnation.
        self._msg_ids = itertools.count()
        self._msg_prefix = uuid.uuid4().hex[:12]
        self._ack_events: dict[str, threading.Event] = {}
        self._seen_user: OrderedDict[str, float] = OrderedDict()
        self.sync_retries = 5
        # First ACK wait (doubles per retry) and the HTTP state-stream
        # fallback timeout (the JAX package's [gossip] ack-timeout-ms /
        # stream-timeout-ms keys; the server's gossip_*_timeout_ms).
        self.ack_timeout = ack_timeout
        self.stream_timeout = stream_timeout
        # Chunked state transfer: digests already merged (content-keyed
        # LRU — a digest seen from any peer needs no re-fetch) and
        # in-progress chunk assemblies keyed by (sender, digest).
        self._merged_digests: OrderedDict[str, float] = OrderedDict()
        self._assemblies: dict[tuple[str, str], dict] = {}
        # digest -> UDP transfer attempts (STATE-REQs sent + timed-out
        # assemblies); past _UDP_STATE_MAX_ATTEMPTS the digest flips to
        # the HTTP stream fallback.  Counting REQs (not just expired
        # assemblies) catches TOTAL chunk loss, where no assembly ever
        # forms.  When a digest exhausts BOTH paths' budgets, the offer
        # handler resets both counters and the alternation starts over
        # — neither path can permanently wedge the other.
        self._udp_state_attempts: OrderedDict[str, int] = OrderedDict()
        self._stream_failures: OrderedDict[str, int] = OrderedDict()
        self._streams_in_flight: set[str] = set()

    # ------------------------------------------------------------------
    # NodeSet
    # ------------------------------------------------------------------

    def nodes(self) -> list[str]:
        """Live members only — presence here means UP (the
        broadcast.NodeSet contract consumed by Cluster.node_states).
        SUSPECT members are still live: SWIM keeps a member until
        indirect probes through third parties also fail."""
        with self._mu:
            return sorted(
                h for h, m in self._members.items() if m["state"] != "DOWN"
            )

    def member_states(self) -> dict[str, str]:
        with self._mu:
            return {h: m["state"] for h, m in self._members.items()}

    def open(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # Chunked state transfers burst several ~44 KB datagrams; the
        # default rcvbuf (~208 KB on Linux) would shed most of a large
        # blob.  Best-effort — the kernel clamps to net.core.rmem_max.
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        except OSError:
            pass
        self._sock.bind(self.bind)
        # A bind to port 0 takes an ephemeral port: advertise that one.
        self.bind = (self.bind[0], self._sock.getsockname()[1])
        self._sock.settimeout(0.2)
        self.advertise = (self.advertise[0], self.bind[1])
        self._register(self.host, self.advertise)
        for name, fn in (("gossip-rx", self._rx_loop), ("gossip-tick", self._tick_loop)):
            t = threading.Thread(target=fn, daemon=True, name=f"{name}:{self.host}")
            t.start()
            self._threads.append(t)
        if self.seed:
            # Best-effort: a join datagram lost to the network is
            # re-sent by the tick loop for as long as this node knows
            # only itself (memberlist likewise retries joins).
            self._send_logged(
                _parse_addr(self.seed),
                {"t": "join", "from": self.host, "gaddr": _fmt_addr(self.advertise)},
            )

    def close(self) -> None:
        self._closing.set()
        if self._sock is not None:
            self._sock.close()

    # ------------------------------------------------------------------
    # Broadcaster
    # ------------------------------------------------------------------

    def send_sync(self, msg) -> None:
        """Deliver ``msg`` to every live member, blocking until each one
        ACKs (retry with backoff); raises listing the peers that never
        confirmed — reliable like the reference's TCP SendSync
        (reference: gossip.go:124-149)."""
        from pilosa_tpu_torch.cluster.broadcast import marshal_message

        payload = base64.b64encode(marshal_message(msg)).decode()
        errors: list[str] = []
        errors_mu = threading.Lock()

        def deliver(host: str, member: dict) -> None:
            mid = f"{self._msg_prefix}/{next(self._msg_ids)}"
            ev = threading.Event()
            with self._mu:
                self._ack_events[mid] = ev
            try:
                timeout = self.ack_timeout
                for _ in range(self.sync_retries):
                    try:
                        self._send(
                            member["addr"],
                            {
                                "t": "user",
                                "from": self.host,
                                "p": payload,
                                "id": mid,
                            },
                        )
                    except OSError as e:
                        with errors_mu:
                            errors.append(f"{host}: {e}")
                        return
                    if ev.wait(timeout):
                        return
                    timeout *= 2
                with errors_mu:
                    errors.append(f"{host}: no ack after {self.sync_retries} tries")
            finally:
                with self._mu:
                    self._ack_events.pop(mid, None)

        # Concurrent fan-out, like the reference's errgroup SendSync
        # (reference: gossip.go:124-149) — total wall time is one peer's
        # retry budget, not the sum over unresponsive peers.
        threads = []
        for host, member in self._snapshot().items():
            if host == self.host or member["state"] == "DOWN":
                continue
            t = threading.Thread(target=deliver, args=(host, member), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError("; ".join(sorted(errors)))

    def send_async(self, msg) -> None:
        from pilosa_tpu_torch.cluster.broadcast import marshal_message

        payload = base64.b64encode(marshal_message(msg)).decode()
        peers = [
            m
            for h, m in self._snapshot().items()
            if h != self.host and m["state"] != "DOWN"
        ]
        random.shuffle(peers)
        for member in peers[: self.gossip_fanout]:
            try:
                self._send(
                    member["addr"], {"t": "user", "from": self.host, "p": payload}
                )
            except OSError:
                pass

    # ------------------------------------------------------------------
    # BroadcastReceiver
    # ------------------------------------------------------------------

    def start(self, handler) -> None:
        self._handler = handler

    # ------------------------------------------------------------------
    # protocol internals
    # ------------------------------------------------------------------

    def _snapshot(self) -> dict[str, dict]:
        with self._mu:
            return {h: dict(m) for h, m in self._members.items()}

    def _register(self, host: str, addr, age_s: float = 0.0) -> None:
        """Record a liveness report for ``host``.  ``age_s`` is how old
        the report is: 0 for direct contact (a datagram from the member
        itself), the reporter's time-since-last-heard for third-party
        vouches (_merge_members).  last_seen only moves FORWARD to
        ``now - age_s`` — a stale vouch can never refresh a member past
        fresher local evidence, so a dead member's silence accumulates
        cluster-wide instead of peers mutually resurrecting it with
        stale 'UP' reports forever (the false-ALIVE dual of a
        false-DOWN storm)."""
        now = time.monotonic()
        seen = now - max(age_s, 0.0)
        changed = False
        with self._mu:
            m = self._members.get(host)
            if m is None:
                fresh = age_s <= self.suspect_after
                self._members[host] = {
                    "addr": tuple(addr),
                    "last_seen": seen,
                    # A member discovered through an already-stale vouch
                    # starts SUSPECT: it must prove liveness within a
                    # probe window rather than being presumed UP.
                    "state": "UP" if fresh else "SUSPECT",
                }
                changed = fresh
            else:
                m["addr"] = tuple(addr)
                if seen > m["last_seen"]:
                    m["last_seen"] = seen
                    if (
                        m["state"] != "UP"
                        and now - m["last_seen"] <= self.suspect_after
                    ):
                        # Only DOWN->UP is externally visible: SUSPECT
                        # collapses to UP at the _notify boundary, so a
                        # SUSPECT->UP refresh must not fire a spurious
                        # membership callback every probe cycle.
                        changed = m["state"] == "DOWN"
                        m["state"] = "UP"
                        m.pop("suspect_since", None)
        if changed:
            self._notify()

    def _notify(self) -> None:
        if self.on_membership_change is not None:
            # SUSPECT is internal to the SWIM protocol; the NodeSet
            # contract (and the reference's status surface) knows only
            # UP/DOWN, and a suspected member is still UP.
            states = {
                h: ("UP" if s != "DOWN" else "DOWN")
                for h, s in self.member_states().items()
            }
            try:
                self.on_membership_change(sorted(states.items()))
            except Exception as e:  # noqa: BLE001
                self.logger(f"membership callback error: {e}")

    def _send(self, addr, obj: dict) -> None:
        if self._sock is not None:
            # Chaos hook (testing/faults.py): the datagram-send
            # boundary.  ``mode=drop``/``error`` with seeded ``prob``
            # injects deterministic datagram loss per SENDER (host =
            # this node's identity, path = the message type) — the
            # lossy network of the churn tests.
            faults.check("gossip.send", host=self.host, path=obj.get("t"))
            data = json.dumps(obj).encode()
            self._sock.sendto(data, tuple(addr))
            self.stats.count("gossip.sent")
            self.stats.count("gossip.sentBytes", len(data))

    def _send_logged(self, addr, obj: dict) -> None:
        """Best-effort send: failures are LOGGED, never silently dropped
        — a send that starts failing (oversized datagram, unreachable
        peer) must leave a trace: a swallowed EMSGSIZE would stop schema
        sync with no log."""
        try:
            self._send(addr, obj)
        except OSError as e:
            self.logger(
                f"gossip send {obj.get('t')} to {_fmt_addr(addr)} failed: {e}"
            )

    def _member_list(self) -> list[dict]:
        now = time.monotonic()
        return [
            {
                "host": h,
                "gaddr": _fmt_addr(m["addr"]),
                "state": m["state"],
                # Age of this liveness report: receivers refresh
                # last_seen to (their now - age), never backwards.
                "age": round(now - m["last_seen"], 3),
            }
            for h, m in self._snapshot().items()
        ]

    def _merge_members(self, members: list[dict]) -> None:
        """Adopt third-party liveness reports: a peer vouching UP for a
        member refreshes its last_seen BY THE REPORT'S AGE, so liveness
        scales with cluster size (memberlist-style indirect
        confirmation) while a dead member's growing silence still
        accumulates everywhere — stale vouches cannot keep a corpse
        alive."""
        for m in members:
            if m.get("state") == "UP" and m["host"] != self.host:
                try:
                    age = max(float(m.get("age", 0.0)), 0.0)
                except (TypeError, ValueError):
                    age = 0.0
                self._register(m["host"], _parse_addr(m["gaddr"]), age_s=age)

    def _rx_loop(self) -> None:
        while not self._closing.is_set():
            try:
                data, addr = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            self.stats.count("gossip.recv")
            self.stats.count("gossip.recvBytes", len(data))
            try:
                obj = json.loads(data)
            except json.JSONDecodeError:
                continue
            try:
                self._handle(obj, addr)
            except Exception as e:  # noqa: BLE001 — peer boundary
                self.logger(f"gossip rx error: {e}")

    def _handle(self, obj: dict, addr) -> None:
        typ = obj.get("t")
        sender = obj.get("from", "")
        if typ == "join":
            self._register(sender, _parse_addr(obj["gaddr"]))
            self._send_logged(
                _parse_addr(obj["gaddr"]),
                {
                    "t": "join-ack",
                    "from": self.host,
                    "members": self._member_list(),
                },
            )
        elif typ == "join-ack":
            self._merge_members(obj.get("members", []))
        elif typ == "ping":
            self._register(sender, _parse_addr(obj["gaddr"]))
            self._merge_members(obj.get("members", []))
            self._merge_state(obj)
            self._merge_hot(sender, obj)
            self._merge_health(sender, obj)
            self._send_logged(
                _parse_addr(obj["gaddr"]),
                {
                    "t": "ack",
                    "from": self.host,
                    "gaddr": _fmt_addr(self.advertise),
                    "members": self._member_list(),
                    **self._state_field(),
                    **self._hot_field(),
                    **self._health_field(),
                },
            )
        elif typ == "ack":
            self._register(sender, _parse_addr(obj["gaddr"]))
            self._merge_members(obj.get("members", []))
            self._merge_state(obj)
            self._merge_hot(sender, obj)
            self._merge_health(sender, obj)
            # SWIM relay leg 3: if someone asked us to probe this
            # sender, tell them it answered.
            with self._mu:
                waiters = list(self._relay_pending.pop(sender, {}).items())
            now = time.monotonic()
            for req_addr, deadline in waiters:
                if now <= deadline:
                    self._send_logged(
                        req_addr,
                        {
                            "t": "ind-ack",
                            "from": self.host,
                            "target": sender,
                            "taddr": obj["gaddr"],
                        },
                    )
        elif typ == "ping-req":
            # SWIM relay leg 2: probe the target on the requester's
            # behalf; our eventual ack from the target triggers ind-ack.
            self._register(sender, _parse_addr(obj["gaddr"]))
            target = obj.get("target", "")
            if not target:
                return
            taddr = _parse_addr(obj["taddr"])
            with self._mu:
                self._relay_pending.setdefault(target, {})[
                    _parse_addr(obj["gaddr"])
                ] = time.monotonic() + 4 * self.suspect_after
            self._send_logged(
                taddr,
                {
                    "t": "ping",
                    "from": self.host,
                    "gaddr": _fmt_addr(self.advertise),
                    "members": self._member_list(),
                    **self._state_field(),
                    **self._hot_field(),
                    **self._health_field(),
                },
            )
        elif typ == "ind-ack":
            # SWIM relay leg 4: a third party reached the suspect —
            # refresh it without direct contact.
            target = obj.get("target", "")
            if target:
                self._register(target, _parse_addr(obj["taddr"]))
        elif typ == "user":
            mid = obj.get("id")
            if self._handler is None:
                # No handler wired yet — don't ack, so the sender keeps
                # retrying until this node can actually apply messages.
                return
            if mid is None or not self._is_seen(mid):
                from pilosa_tpu_torch.cluster.broadcast import unmarshal_message

                msg = unmarshal_message(base64.b64decode(obj["p"]))
                # A handler exception propagates before the id is marked
                # seen or acked — the sender's retry re-applies instead
                # of being deduped into a silent drop.
                self._handler.receive_message(msg)
                if mid is not None:
                    self._mark_seen(mid)
            # Ack AFTER processing so a send_sync return means the
            # message was handled, not merely received.
            if mid is not None:
                self._send(addr, {"t": "user-ack", "from": self.host, "id": mid})
        elif typ == "user-ack":
            with self._mu:
                ev = self._ack_events.get(obj.get("id"))
            if ev is not None:
                ev.set()
        elif typ == "state-req":
            self._serve_state_req(addr)
        elif typ == "state-chunk":
            self._handle_state_chunk(obj)

    def _is_seen(self, mid: str) -> bool:
        """True when a user message id was already fully processed —
        retries of it are acked but not re-applied."""
        with self._mu:
            if mid in self._seen_user:
                self._seen_user.move_to_end(mid)
                return True
            return False

    def _mark_seen(self, mid: str) -> None:
        """Record a processed id (bounded LRU); called only after the
        handler applied the message successfully."""
        with self._mu:
            self._seen_user[mid] = time.monotonic()
            while len(self._seen_user) > 4096:
                self._seen_user.popitem(last=False)

    def _hot_field(self) -> dict:
        if self.hot_provider is None:
            return {}
        try:
            hot = self.hot_provider()
        except Exception as e:  # noqa: BLE001
            self.logger(f"hot provider error: {e}")
            return {}
        if not hot:
            return {}
        return {
            "hot": {
                str(idx): [int(s) for s in slices[:HOT_SLICES_MAX]]
                for idx, slices in hot.items()
                if slices
            }
        }

    def _health_field(self) -> dict:
        if self.health_provider is None:
            return {}
        try:
            degraded = bool(self.health_provider())
        except Exception as e:  # noqa: BLE001
            self.logger(f"health provider error: {e}")
            return {}
        # Only announce a non-default state (one key per datagram is
        # cheap, but an always-healthy fleet should pay nothing).
        return {"dvh": True} if degraded else {"dvh": False}

    def _merge_health(self, sender: str, obj: dict) -> None:
        flag = obj.get("dvh")
        if not sender or not isinstance(flag, bool):
            return
        with self._mu:
            prev = self._health_remote.get(sender)
            self._health_remote[sender] = flag
        if prev != flag and self.on_peer_health is not None:
            try:
                self.on_peer_health(sender, flag)
            except Exception as e:  # noqa: BLE001 — advisory hook
                self.logger(f"peer health callback error: {e}")

    def remote_device_health(self) -> dict[str, bool]:
        """{peer host: degraded} as last announced."""
        with self._mu:
            return dict(self._health_remote)

    def _merge_hot(self, sender: str, obj: dict) -> None:
        hot = obj.get("hot")
        if not sender or not isinstance(hot, dict):
            return
        clean: dict[str, list[int]] = {}
        for idx, slices in hot.items():
            if isinstance(slices, list):
                clean[str(idx)] = [
                    int(s) for s in slices[:HOT_SLICES_MAX]
                    if isinstance(s, int)
                ]
        with self._mu:
            self._hot_remote[sender] = (time.monotonic(), clean)

    def remote_hot_slices(self) -> dict[str, list[int]]:
        """Union of peers' fresh hot-slice announcements:
        ``{index: [slice,...]}`` — the gossip-informed head of the
        cold-staging priority queue."""
        now = time.monotonic()
        out: dict[str, dict[int, None]] = {}
        with self._mu:
            for _host, (t, hot) in self._hot_remote.items():
                if now - t > HOT_TTL_S:
                    continue
                for idx, slices in hot.items():
                    d = out.setdefault(idx, {})
                    for s in slices:
                        d.setdefault(s, None)
        return {idx: list(d) for idx, d in out.items()}

    def _state_field(self) -> dict:
        if self.state_provider is None:
            return {}
        try:
            blob = self.state_provider()
        except Exception as e:  # noqa: BLE001
            self.logger(f"state provider error: {e}")
            return {}
        if not blob:
            return {}
        if len(blob) <= INLINE_STATE_MAX:
            return {"state_blob": base64.b64encode(blob).decode()}
        # Too big for a datagram: advertise the digest (and size — the
        # receiver picks UDP chunks vs the HTTP stream from it);
        # interested peers pull the blob.
        return {
            "state_digest": hashlib.sha1(blob).hexdigest(),
            "state_size": len(blob),
        }

    def _merge_state(self, obj: dict) -> None:
        blob = obj.get("state_blob")
        if blob and self.state_merger is not None:
            try:
                self.state_merger(base64.b64decode(blob))
            except Exception as e:  # noqa: BLE001
                self.logger(f"state merge error: {e}")
            return
        digest = obj.get("state_digest")
        if not digest or self.state_merger is None:
            return
        now = time.monotonic()
        with self._mu:
            if digest in self._merged_digests:
                self._merged_digests.move_to_end(digest)
                return
            # A fresh in-flight assembly for this digest suppresses
            # duplicate STATE-REQs — every ping/ack carrying the digest
            # would otherwise trigger a full-blob retransmission.
            for (_, d), asm in self._assemblies.items():
                if d == digest and now - asm["t0"] <= _ASSEMBLY_TTL:
                    return
        # Stream fallback: a blob bigger than STREAM_STATE_CHUNKS
        # datagrams, or one whose UDP transfer already stalled once,
        # fetches over the peer's HTTP listener in one request instead
        # of re-spraying the chunk set (memberlist's TCP push/pull
        # analog, reference: gossip/gossip.go:191-222).
        size = obj.get("state_size")
        big = (
            isinstance(size, int)
            and size > STREAM_STATE_CHUNKS * STATE_CHUNK_SIZE
        )
        with self._mu:
            attempts = self._udp_state_attempts.get(digest, 0)
            sfails = self._stream_failures.get(digest, 0)
            stalled = attempts >= _UDP_STATE_MAX_ATTEMPTS
            if stalled and sfails >= _STREAM_MAX_FAILURES:
                # Both paths exhausted a round — reset and alternate
                # again rather than wedging on either.
                self._udp_state_attempts.pop(digest, None)
                self._stream_failures.pop(digest, None)
                attempts = sfails = 0
                stalled = False
        if (big or stalled) and sfails < _STREAM_MAX_FAILURES:
            # Dial only hosts the membership snapshot already knows: the
            # UDP "from" field is unauthenticated, and following it
            # blindly would let one spoofed datagram point the fetch at
            # an arbitrary host.
            claimed = obj.get("from", "")
            if claimed in self._snapshot():
                self._start_stream(claimed, digest)
                return
            self.logger(
                f"state stream: ignoring offer from unknown member {claimed!r}"
            )
            return
        sender = self._snapshot().get(obj.get("from", ""))
        if sender is not None:
            with self._mu:
                self._bump_state_attempts_locked(digest)
            self._send_logged(
                sender["addr"],
                {"t": "state-req", "from": self.host, "digest": digest},
            )

    @staticmethod
    def _bump_locked(counter: OrderedDict, key: str) -> None:
        """Increment a bounded per-digest counter (caller holds _mu)."""
        counter[key] = counter.get(key, 0) + 1
        while len(counter) > 64:
            counter.popitem(last=False)

    def _bump_state_attempts_locked(self, digest: str) -> None:
        self._bump_locked(self._udp_state_attempts, digest)

    def _start_stream(self, peer_host: str, digest: str) -> None:
        """Fetch a peer's state blob over HTTP on a worker thread (the
        receive loop must never block on a network round trip); one
        in-flight stream per digest."""
        if not peer_host or self.state_merger is None:
            return
        with self._mu:
            if digest in self._streams_in_flight:
                return
            self._streams_in_flight.add(digest)
        threading.Thread(
            target=self._stream_state,
            args=(peer_host, digest),
            daemon=True,
            name=f"state-stream:{peer_host}",
        ).start()

    def _stream_state(self, peer_host: str, digest: str) -> None:
        ok = False
        try:
            blob = self.state_fetcher(peer_host)
            if blob:
                # What arrives is recorded under its OWN digest; the
                # ADVERTISED digest is only marked merged when the
                # blob's sha1 actually matches it — a peer whose state
                # moved past the offer (or a tampered body) must not
                # retire a digest this node never merged.  state_merger
                # parses the blob and raises on garbage, which counts
                # as a stream failure below.
                got = hashlib.sha1(blob).hexdigest()
                self.state_merger(blob)
                ok = True
                now = time.monotonic()
                with self._mu:
                    self._merged_digests[got] = now
                    self._udp_state_attempts.pop(got, None)
                    self._stream_failures.pop(got, None)
                    while len(self._merged_digests) > 64:
                        self._merged_digests.popitem(last=False)
        except Exception as e:  # noqa: BLE001
            self.logger(f"state stream from {peer_host} failed: {e}")
        finally:
            if not ok:
                # EVERY unsuccessful stream (fetch error, empty body,
                # unparseable blob) counts toward the fallback budget:
                # past _STREAM_MAX_FAILURES the offer handler retries
                # UDP chunking even for large blobs, so a broken HTTP
                # path never pins the digest to doomed re-downloads.
                with self._mu:
                    self._bump_locked(self._stream_failures, digest)
            with self._mu:
                self._streams_in_flight.discard(digest)

    def _http_state_fetch(self, peer_host: str) -> bytes:
        """GET the peer's full state blob from its HTTP listener
        (net/handler.py serves /state from the same provider that
        feeds gossip)."""
        import urllib.request

        with urllib.request.urlopen(
            f"http://{peer_host}/state", timeout=self.stream_timeout
        ) as resp:
            return resp.read()

    def _serve_state_req(self, addr) -> None:
        """Stream the CURRENT state blob in numbered chunks.  The blob's
        own digest rides along (it may have moved past the requested
        one — the receiver validates against what actually arrives)."""
        if self.state_provider is None:
            return
        try:
            blob = self.state_provider()
        except Exception as e:  # noqa: BLE001
            self.logger(f"state provider error: {e}")
            return
        if not blob:
            return
        digest = hashlib.sha1(blob).hexdigest()
        chunks = [
            blob[i : i + STATE_CHUNK_SIZE]
            for i in range(0, len(blob), STATE_CHUNK_SIZE)
        ]
        for seq, chunk in enumerate(chunks):
            self._send_logged(
                addr,
                {
                    "t": "state-chunk",
                    "from": self.host,
                    "digest": digest,
                    "seq": seq,
                    "n": len(chunks),
                    "p": base64.b64encode(chunk).decode(),
                },
            )

    def _handle_state_chunk(self, obj: dict) -> None:
        sender = obj.get("from", "")
        digest = obj.get("digest", "")
        seq, n = obj.get("seq"), obj.get("n")
        if not digest or not isinstance(seq, int) or not isinstance(n, int):
            return
        if not (0 <= seq < n):
            return
        key = (sender, digest)
        now = time.monotonic()
        with self._mu:
            if digest in self._merged_digests:
                return
            # GC stale partial assemblies; each timed-out transfer
            # counts toward the stream-fallback threshold.
            for k in [
                k
                for k, a in self._assemblies.items()
                if now - a["t0"] > _ASSEMBLY_TTL
            ]:
                self._bump_state_attempts_locked(k[1])
                del self._assemblies[k]
            asm = self._assemblies.setdefault(key, {"t0": now, "n": n, "parts": {}})
            if asm["n"] != n:
                # Sender restarted the transfer with a different chunk
                # count; start over.
                asm = self._assemblies[key] = {"t0": now, "n": n, "parts": {}}
            asm["parts"][seq] = base64.b64decode(obj.get("p", ""))
            # Progress refreshes the TTL: a slow lossy transfer keeps its
            # partial assembly as long as chunks keep arriving.
            asm["t0"] = now
            if len(asm["parts"]) < n:
                return
            blob = b"".join(asm["parts"][i] for i in range(n))
            del self._assemblies[key]
        if hashlib.sha1(blob).hexdigest() != digest:
            self.logger(
                f"state transfer from {sender} failed digest check; dropped"
            )
            return
        if self.state_merger is not None:
            try:
                self.state_merger(blob)
            except Exception as e:  # noqa: BLE001
                # NOT recorded as merged: the next ping retries the
                # transfer instead of skipping this state forever.
                self.logger(f"state merge error: {e}")
                return
        with self._mu:
            self._merged_digests[digest] = now
            self._udp_state_attempts.pop(digest, None)
            self._stream_failures.pop(digest, None)
            while len(self._merged_digests) > 64:
                self._merged_digests.popitem(last=False)

    def _tick_loop(self) -> None:
        while not self._closing.wait(self.gossip_interval):
            # A node that still knows only itself re-sends its join —
            # the original datagram may have been lost (memberlist
            # retries joins the same way).
            peers = [
                (h, m)
                for h, m in self._snapshot().items()
                if h != self.host
            ]
            if not peers and self.seed:
                self._send_logged(
                    _parse_addr(self.seed),
                    {
                        "t": "join",
                        "from": self.host,
                        "gaddr": _fmt_addr(self.advertise),
                    },
                )
            # probe a random live peer
            if peers:
                host, member = random.choice(peers)
                self._send_logged(
                    member["addr"],
                    {
                        "t": "ping",
                        "from": self.host,
                        "gaddr": _fmt_addr(self.advertise),
                        "members": self._member_list(),
                        **self._state_field(),
                        **self._hot_field(),
                    **self._health_field(),
                    },
                )
            # SWIM suspect machinery: silence past suspect_after marks a
            # member SUSPECT and fans indirect probes through third
            # parties; only continued silence — direct AND indirect —
            # past another suspect_after confirms DOWN.  An asymmetric
            # partition (we can't reach B, C can) therefore never flaps
            # B to DOWN: C's ind-ack refreshes it.
            now = time.monotonic()
            changed = False
            suspects: list[tuple[str, dict]] = []
            with self._mu:
                for h, m in self._members.items():
                    if h == self.host:
                        m["last_seen"] = now
                        continue
                    silent = now - m["last_seen"]
                    if m["state"] == "UP" and silent > self.suspect_after:
                        m["state"] = "SUSPECT"
                        # DOWN is anchored to SUSPECT entry, not to
                        # last_seen: even after a tick-loop stall the
                        # member gets one full probed window before it
                        # can be confirmed DOWN.
                        m["suspect_since"] = now
                    if (
                        m["state"] == "SUSPECT"
                        and now - m.get("suspect_since", now)
                        > self.suspect_after
                    ):
                        m["state"] = "DOWN"
                        changed = True
                    elif m["state"] == "SUSPECT":
                        # Probed EVERY tick while suspect (not only on
                        # the transition): a lost probe round must not
                        # be able to confirm a reachable member DOWN.
                        suspects.append((h, dict(m)))
                relays = [
                    (h, m["addr"])
                    for h, m in self._members.items()
                    if h != self.host and m["state"] == "UP"
                ]
                # Expire stale relay bookkeeping.
                for tgt in list(self._relay_pending):
                    self._relay_pending[tgt] = {
                        a: d for a, d in self._relay_pending[tgt].items() if d >= now
                    }
                    if not self._relay_pending[tgt]:
                        del self._relay_pending[tgt]
            for h, m in suspects:
                # One more direct attempt plus k indirect probes.
                self._send_logged(
                    m["addr"],
                    {
                        "t": "ping",
                        "from": self.host,
                        "gaddr": _fmt_addr(self.advertise),
                        "members": self._member_list(),
                        **self._state_field(),
                        **self._hot_field(),
                    **self._health_field(),
                    },
                )
                pool = [r for r in relays if r[0] != h]
                random.shuffle(pool)
                for _, relay_addr in pool[: self.indirect_probes]:
                    self._send_logged(
                        relay_addr,
                        {
                            "t": "ping-req",
                            "from": self.host,
                            "gaddr": _fmt_addr(self.advertise),
                            "target": h,
                            "taddr": _fmt_addr(m["addr"]),
                        },
                    )
            if changed:
                self._notify()


def _parse_addr(s: str) -> tuple[str, int]:
    addr, _, port = s.partition(":")
    return (addr or "127.0.0.1", int(port))


def _fmt_addr(addr) -> str:
    return f"{addr[0]}:{addr[1]}"
