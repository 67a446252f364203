"""The replicated service catalog — the port of
``sidecar_tpu/catalog/state.py`` (the reference's
catalog/services_state.go): ``servers[hostname] → services[id] →
Service`` with latest-timestamp-wins merge, change events fanned out to
listeners and the query hub, the broadcast, tombstone and tracking
loops, the Merkle digest ladder the writer keeps, and the Go wire form.

The writer path is :meth:`ServicesState.add_service_entry`: latest stamp
wins, DRAINING stays sticky, stale records are dropped, a record stamped
beyond ``future_fudge_s`` is rejected, and with an origin gate
(``ops/suspicion.QuarantineScorer``) attached, records pushed by a
quarantined origin are rejected.  :meth:`ServicesState.merge` takes a
peer's whole body.  Every mutation subtracts a record's old digest key
before it changes the record and adds the new one after
(capture-before-mutate), then publishes an immutable snapshot that
readers take without the lock.

Concurrency: one re-entrant lock around the state, one writer thread
draining ``service_msgs``, bounded listener queues with non-blocking
delivery.  Every background loop takes a ``Looper`` (``runtime/``), so
tests drive it with ``FreeLooper``.  Where the reference reads
``SIDECAR_TPU_DIGEST_BUCKETS`` and ``SIDECAR_TPU_ANTIENTROPY_DEPTH``,
the port takes ``ServicesState(..., digest_buckets=64,
ladder_depth=5)``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import socket
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch import service as svc_mod
from sidecar_tpu_torch.ops import digest as digest_ops
from sidecar_tpu_torch.output import time_ago
from sidecar_tpu_torch.telemetry.span import span as _span
from sidecar_tpu_torch.telemetry import coherence as _coherence
from sidecar_tpu_torch.telemetry import propagation as _propagation
from sidecar_tpu_torch.runtime.looper import Looper, TimedLooper
from sidecar_tpu_torch.service import (
    ALIVE_LIFESPAN,
    DRAINING_LIFESPAN,
    NS_PER_SECOND,
    Service,
    TOMBSTONE,
    TOMBSTONE_LIFESPAN,
    UNKNOWN,
    _as_int,
    _as_str,
    _parse_ts,
    ns_to_rfc3339,
)

log = logging.getLogger(__name__)

# Lifecycle constants (catalog/services_state.go:26-37).
TOMBSTONE_COUNT = 10           # tombstone announce repetitions @ 1 Hz
ALIVE_COUNT = 5                # new-service announce repetitions @ 1 Hz
TOMBSTONE_SLEEP_INTERVAL = 2.0
TOMBSTONE_RETRANSMIT = 1.0
ALIVE_SLEEP_INTERVAL = 1.0
ALIVE_BROADCAST_INTERVAL = 60.0
LISTENER_EVENT_BUFFER_SIZE = 20
SERVICE_MSGS_BUFFER = 25       # NewServicesState (services_state.go:95)


@dataclasses.dataclass
class ChangeEvent:
    """A major state transition (catalog/services_state.go:42-46)."""

    service: Service
    previous_status: int
    time: int  # ns since epoch

    def to_json(self) -> dict:
        return {"Service": self.service.to_json(),
                "PreviousStatus": self.previous_status,
                "Time": ns_to_rfc3339(self.time)}

    @classmethod
    def from_json(cls, d: dict) -> "ChangeEvent":
        return cls(service=Service.from_json(d.get("Service") or {}),
                   previous_status=_as_int(d.get("PreviousStatus"),
                                           UNKNOWN),
                   time=_ts(d.get("Time")))


# One wire-timestamp rule for both decoders (service.py owns it).
_ts = _parse_ts


class Listener:
    """Receives ChangeEvents on a bounded queue
    (catalog.Listener interface, services_state.go:83-87)."""

    def chan(self) -> "queue.Queue[ChangeEvent]":
        raise NotImplementedError

    def name(self) -> str:
        raise NotImplementedError

    def managed(self) -> bool:
        """Auto-added/removed by discovery (SidecarListener labels)?"""
        return False


class QueueListener(Listener):
    """Trivial listener backed by a queue — test and building-block use."""

    def __init__(self, name: str,
                 buffer: int = LISTENER_EVENT_BUFFER_SIZE,
                 managed: bool = False) -> None:
        self._name = name
        self._chan: "queue.Queue[ChangeEvent]" = queue.Queue(maxsize=buffer)
        self._managed = managed

    def chan(self) -> "queue.Queue[ChangeEvent]":
        return self._chan

    def name(self) -> str:
        return self._name

    def managed(self) -> bool:
        return self._managed


class Server:
    """State about one host in the cluster (services_state.go:50-56)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.services: dict[str, Service] = {}
        self.last_updated: int = 0
        self.last_changed: int = 0

    def has_service(self, service_id: str) -> bool:
        return service_id in self.services

    def to_json(self) -> dict:
        return {
            "Name": self.name,
            "Services": {sid: s.to_json() for sid, s in self.services.items()},
            "LastUpdated": ns_to_rfc3339(self.last_updated),
            "LastChanged": ns_to_rfc3339(self.last_changed),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Server":
        server = cls(_as_str(d.get("Name", ""), ""))
        for sid, sd in (d.get("Services") or {}).items():
            server.services[sid] = Service.from_json(sd)
        server.last_updated = _ts(d.get("LastUpdated"))
        server.last_changed = _ts(d.get("LastChanged"))
        return server


class ServicesState:
    """The cluster-wide replicated catalog (services_state.go:70-110)."""

    def __init__(self, hostname: Optional[str] = None,
                 cluster_name: str = "", *,
                 digest_buckets: int = digest_ops.DEFAULT_BUCKETS,
                 ladder_depth: int = digest_ops.DEFAULT_LADDER_DEPTH
                 ) -> None:
        """``digest_buckets`` (a power of two) and ``ladder_depth``
        (at least 1) fix the digest's geometry; a bad value raises
        ``ValueError``."""
        self.servers: dict[str, Server] = {}
        self.last_changed: int = 0
        self.cluster_name = cluster_name
        self.hostname = hostname if hostname is not None else socket.gethostname()
        # Encoded outbound gossip payloads (lists of encoded records);
        # the transport drains this (services_state.go:75 Broadcasts chan).
        self.broadcasts: "queue.Queue[Optional[list[bytes]]]" = queue.Queue()
        # Single-writer mutation queue (services_state.go:127-140).
        self.service_msgs: "queue.Queue[Service]" = queue.Queue(
            maxsize=SERVICE_MSGS_BUFFER)
        self._listeners: dict[str, Listener] = {}
        self.tombstone_retransmit = TOMBSTONE_RETRANSMIT
        self._lock = threading.RLock()
        self._now: Callable[[], int] = svc_mod.now_ns
        # The query plane (query/), attached on first use; once
        # attached, every change event also publishes a snapshot and a
        # delta through it.
        self._query_hub = None
        # The flap damper (catalog/damping.py): when attached, every
        # status transition through service_changed feeds it.
        self.flap_damper = None
        # The future bound: a record stamped beyond now + this many
        # seconds is rejected at the writer (the live twin of
        # ops/merge.future_mask).  Negative: off.
        self.future_fudge_s: float = -1.0
        # The origin gate (ops/suspicion.QuarantineScorer): when
        # attached, merge() scores each push-pull body against its
        # sender and the writer rejects a quarantined origin's records.
        self.origin_gate = None
        # The digest ladder (ops/digest.LadderDigest), kept by the
        # writer under the lock, and its level 0 published as an
        # immutable (count, value) pair that readers take without it.
        self._digest = digest_ops.LadderDigest(digest_buckets,
                                               ladder_depth)
        self.digest_snapshot: tuple = (0, self._digest.value())
        # A peer's digest annotation, kept by decode() from a push-pull
        # body's "Digest" key; None on a state built here.
        self.wire_digest: Optional[dict] = None
        # The last autopilot report the bridge published (None before).
        self.autopilot_report: Optional[dict] = None

    # -- time injection (tests) -------------------------------------------

    def set_clock(self, now_fn: Callable[[], int]) -> None:
        self._now = now_fn

    # -- the query plane ---------------------------------------------------

    def query_hub(self):
        """The attached :class:`sidecar_tpu_torch.query.QueryHub`, created on
        first use — the read-path consumers' single entry point (web
        /watch, UrlListener, ADS)."""
        with self._lock:
            if self._query_hub is None:
                from sidecar_tpu_torch.query import QueryHub

                hub = QueryHub(self)
                hub.attach()
                self._query_hub = hub
            return self._query_hub

    # -- basic accessors ---------------------------------------------------

    def has_server(self, hostname: str) -> bool:
        return hostname in self.servers

    def get_local_service_by_id(self, service_id: str) -> Service:
        """services_state.go:349-363; raises KeyError when absent."""
        with self._lock:
            server = self.servers.get(self.hostname)
            if server and service_id in server.services:
                return server.services[service_id].copy()
        raise KeyError(
            f"service with ID {service_id!r} not found on host "
            f"{self.hostname!r}")

    # -- encode / decode ---------------------------------------------------

    def to_json(self) -> dict:
        return {
            "Servers": {h: s.to_json() for h, s in self.servers.items()},
            "LastChanged": ns_to_rfc3339(self.last_changed),
            "ClusterName": self.cluster_name,
            "Hostname": self.hostname,
        }

    def encode(self) -> bytes:
        with self._lock:
            return json.dumps(self.to_json(), separators=(",", ":")).encode()

    def encode_annotated(self) -> bytes:
        """The push-pull body: :meth:`encode`'s Go-wire document plus
        the coherence-digest annotation under a ``"Digest"`` key.  Kept
        OFF :meth:`encode` so decode→encode stays byte-identical to the
        Go fixtures (tests/test_go_wire.py); Go peers ignore the extra
        key (encoding/json skips unknown fields), sidecar-tpu peers
        harvest it in :meth:`merge` via :func:`decode`."""
        with self._lock:
            doc = self.to_json()
            doc["Digest"] = self.digest_doc()
            return json.dumps(doc, separators=(",", ":")).encode()

    # -- the coherence digest (ops/digest.py live twin) --------------------

    def digest_doc(self) -> dict:
        """Wire/JSON view of the published digest snapshot — read
        WITHOUT the state lock (one immutable-tuple reference read;
        ``buckets`` is fixed at construction).  This is the coherence
        plane's read-path contract: /api/digest.json and the push-pull
        annotation never contend with the writer."""
        count, value = self.digest_snapshot
        return {"Buckets": self._digest.buckets, "Records": count,
                "Hex": digest_ops.digest_to_hex(value),
                # The anti-entropy version gate: advertising a ladder
                # geometry declares this peer speaks digest-directed
                # reconciliation (transport/antientropy.py).  Plain-wire
                # peers (and Go's encoding/json) ignore the extra key;
                # absence of it routes a session straight to the
                # full-body fallback.
                "Ladder": {"Depth": self._digest.depth,
                           "Leaf": self._digest.leaf_buckets}}

    def digest_level(self, level: int) -> tuple:
        """One ladder level's canonical digest, read under the state
        lock (levels deeper than the published snapshot are maintained
        by the writer but not snapshotted — reconciliation sessions are
        rare next to mutations, so they pay the lock, not the writer)."""
        with self._lock:
            return self._digest.level(level)

    def ladder_geometry(self) -> tuple:
        """(base buckets, depth) — fixed at construction."""
        return self._digest.base, self._digest.depth

    def services_in_buckets(self, buckets, leaf_buckets: int) -> list:
        """Copies of every record whose identity hashes into one of
        ``buckets`` at the ``leaf_buckets`` ladder level — the
        digest-directed session body (ships divergence, not catalogs).
        Tombstones are records too: a reconciling peer must learn of
        deaths it missed."""
        want = set(buckets)
        out = []
        with self._lock:
            for _, _, svc in self.each_service_sorted():
                ident = digest_ops.ident_of(svc.hostname, svc.id)
                if digest_ops.bucket_of(ident, leaf_buckets) in want:
                    out.append(svc.copy())
        return out

    def _digest_remove(self, svc: Service) -> None:
        """Writer-side capture: MUST run BEFORE a record is replaced,
        deleted, or mutated in place — the digest key includes
        ``(updated, status)``, so the old pair has to be subtracted
        while it is still observable."""
        self._digest.remove(digest_ops.ident_of(svc.hostname, svc.id),
                            digest_ops.live_key(svc.updated, svc.status))

    def _digest_add(self, svc: Service) -> None:
        self._digest.add(digest_ops.ident_of(svc.hostname, svc.id),
                         digest_ops.live_key(svc.updated, svc.status))

    def _digest_publish(self) -> None:
        """Swap in a fresh immutable snapshot (atomic reference
        assignment — the lock-free read path) and feed the local view
        of the coherence monitor, anchored to the query-plane version
        so time-to-coherence is attributable to a specific publish."""
        snap = (self._digest.count, self._digest.value())
        self.digest_snapshot = snap
        hub = self._query_hub
        cur = getattr(hub, "_current", None) if hub is not None else None
        _coherence.observe(self.hostname, snap[1],
                           buckets=self._digest.buckets,
                           records=snap[0], local=True,
                           version=cur.version if cur is not None else 0,
                           now_ns=self._now())

    # -- mutation: the merge kernel ---------------------------------------

    def update_service(self, svc: Service) -> None:
        """Enqueue a state update (services_state.go:137-140).  Blocks if
        the single-writer queue is full, like an unbuffered-over-capacity
        Go channel send."""
        self.service_msgs.put(svc)

    def offer_service(self, svc: Service, timeout: float = 0.0) -> bool:
        """Non-wedging variant of :meth:`update_service`: returns False
        instead of blocking past ``timeout`` when the single-writer
        queue is full.  The transport bridge loop uses this so a stalled
        writer cannot wedge the shared outbound/inbound thread — shed
        records are re-delivered by anti-entropy."""
        try:
            if timeout > 0.0:
                self.service_msgs.put(svc, timeout=timeout)
            else:
                self.service_msgs.put_nowait(svc)
            return True
        except queue.Full:
            return False

    def process_service_msgs(self, looper: Looper) -> None:
        """Single-writer loop draining ``service_msgs``
        (services_state.go:129-135)."""
        def one() -> None:
            svc = self.service_msgs.get()
            if svc is None:  # shutdown sentinel
                raise StopIteration
            self.add_service_entry(svc)

        try:
            looper.loop(one)
        except StopIteration:
            pass

    def stop_processing(self) -> None:
        self.service_msgs.put(None)  # type: ignore[arg-type]

    def add_service_entry(self, new_svc: Service) -> None:
        """THE merge kernel — latest-timestamp-wins with DRAINING
        stickiness and staleness rejection (services_state.go:293-347).
        This is the host-side scalar twin of ops/merge.py's vectorized
        kernel.  Timed like the reference (services_state.go:294)."""
        t0 = time.perf_counter()
        # Span: the merge hop of the live propagation path — the root
        # of the writer-thread chain (snapshot publish nests under it;
        # gossip.receive traces separately across the inbound queue —
        # docs/telemetry.md).
        with _span("catalog.merge"):
            try:
                self._add_service_entry(new_svc)
            finally:
                metrics.measure_since("addServiceEntry", t0)

    def _add_service_entry(self, new_svc: Service) -> None:
        with self._lock:
            now = self._now()
            gate = self.origin_gate
            if gate is not None:
                # Transport-origin annotation, NOT the record's hostname
                # — a forger writes any hostname it likes, the transport
                # knows who actually pushed.  Un-annotated records (the
                # per-record UDP path carries no sender) pass: the gate
                # covers the push-pull plane, exactly where a flood can
                # carry a whole board in one body.
                origin = getattr(new_svc, "gossip_origin", None)
                if origin is not None and gate.is_quarantined(origin):
                    metrics.incr("defense.live.rejectedQuarantine")
                    log.warning(
                        "Dropping record %s:%s (%s) from quarantined "
                        "origin %s", new_svc.hostname, new_svc.name,
                        new_svc.id, origin)
                    return
            if new_svc.is_stale(TOMBSTONE_LIFESPAN, now=now):
                log.warning("Dropping stale service received on gossip: "
                            "%s:%s (%s)", new_svc.hostname, new_svc.name,
                            new_svc.id)
                return
            if self.future_fudge_s >= 0 and new_svc.updated > \
                    now + int(self.future_fudge_s * svc_mod.NS_PER_SECOND):
                # Reject — never clamp: a clamped stamp would still win
                # LWW against honest peers and freeze the record.
                log.warning(
                    "Dropping future-stamped service received on "
                    "gossip: %s:%s (%s) is %.3fs ahead",
                    new_svc.hostname, new_svc.name, new_svc.id,
                    (new_svc.updated - now) / svc_mod.NS_PER_SECOND)
                metrics.incr("clock.live.rejectedFuture")
                return

            if not self.has_server(new_svc.hostname):
                self.servers[new_svc.hostname] = Server(new_svc.hostname)
            server = self.servers[new_svc.hostname]

            if not server.has_service(new_svc.id):
                server.services[new_svc.id] = new_svc
                self._digest_add(new_svc)
                self._digest_publish()
                self.service_changed(new_svc, UNKNOWN, new_svc.updated)
                self.retransmit(new_svc)
                self._observe_propagation(new_svc, now)
            elif new_svc.invalidates(server.services[new_svc.id]):
                server.last_updated = new_svc.updated
                old = server.services[new_svc.id]
                # DRAINING stickiness (services_state.go:329-331).
                if old.status == svc_mod.DRAINING and \
                        new_svc.status == svc_mod.ALIVE:
                    new_svc.status = old.status
                self._digest_remove(old)
                server.services[new_svc.id] = new_svc
                self._digest_add(new_svc)
                self._digest_publish()
                if old.status != new_svc.status:
                    self.service_changed(new_svc, old.status, new_svc.updated)
                self.retransmit(new_svc)
                self._observe_propagation(new_svc, now)

    def _observe_propagation(self, svc: Service, now: int) -> None:
        """Admission-time propagation lag — the live twin of the sim's
        record-level provenance plane (telemetry/propagation.py,
        docs/telemetry.md): merge time minus the record's origin stamp,
        accounted per origin host.  Own records show ~0 lag (they are
        stamped on this node's clock moments before the writer drains
        them), which keeps the per-origin table an honest baseline."""
        _propagation.observe("catalog", svc.hostname,
                             (now - svc.updated) / 1e6)

    def merge(self, other: "ServicesState") -> None:
        """Full-state anti-entropy merge (services_state.go:367-373).

        When the origin gate is attached, one push-pull body is "one
        packet" in the defense ladder's sense: the whole body is scored
        against the sender (``other.hostname`` — the transport origin
        the peer authenticated as, not any record's claimed hostname)
        before a single record is enqueued, and every record is
        annotated with that origin so the writer can reject the push
        once the origin crosses the quarantine threshold."""
        origin = other.hostname
        # Coherence harvest: one push-pull body carries the peer's
        # catalog digest ("Digest" annotation captured by decode(), or
        # the live snapshot when merging an in-process state) — the
        # monitor learns how far the peer's view diverges from ours
        # before a single record lands (telemetry/coherence.py).
        if origin and origin != self.hostname:
            peer_doc = getattr(other, "wire_digest", None)
            if peer_doc is None and \
                    getattr(other, "digest_snapshot", (0,))[0]:
                peer_doc = other.digest_doc()
            if peer_doc is not None:
                _coherence.observe_doc(origin, peer_doc,
                                       now_ns=self._now())
        gate = self.origin_gate
        if gate is not None and origin:
            over = gate.observe(
                origin,
                [(svc.hostname == origin, svc.updated)
                 for server in other.servers.values()
                 for svc in server.services.values()],
                self._now())
            if over:
                metrics.incr("defense.live.originViolations", over)
        for server in other.servers.values():
            for svc in server.services.values():
                c = svc.copy()
                if gate is not None and origin:
                    c.gossip_origin = origin
                self.update_service(c)

    def retransmit(self, svc: Service) -> None:
        """Epidemic relay of non-local changes (services_state.go:377-392);
        bounded by the invalidates() check in add_service_entry."""
        if svc.hostname == self.hostname:
            return
        try:
            self.broadcasts.put_nowait([svc.encode()])
        except queue.Full:  # pragma: no cover — unbounded by default
            log.warning("Broadcast queue full; dropping retransmit")

    # -- change accounting + listener fan-out ------------------------------

    def attach_damper(self, damper) -> None:
        """Attach a :class:`~sidecar_tpu_torch.catalog.damping.FlapDamper`:
        from here on every status transition is observed, and the proxy
        resource generators (which read it through :meth:`query_hub` or
        directly) gate admission on it."""
        with self._lock:
            self.flap_damper = damper

    def attach_origin_gate(self, scorer) -> None:
        """Attach an :class:`~sidecar_tpu_torch.ops.suspicion.QuarantineScorer`
        (same attach pattern as :meth:`attach_damper`): push-pull bodies
        are scored in :meth:`merge` and quarantined origins' records
        rejected in the writer."""
        with self._lock:
            self.origin_gate = scorer

    def service_changed(self, svc: Service, previous_status: int,
                        updated: int) -> None:
        """services_state.go:195-201."""
        self._server_changed(svc.hostname, updated)
        # Flap observation sits on the writer funnel — EVERY status
        # transition passes through here, so the damper sees the full
        # flap history regardless of which consumers are subscribed.
        damper = self.flap_damper
        if damper is not None:
            damper.observe(svc, previous_status)
        self.notify_listeners(svc, previous_status, self.last_changed)

    def _server_changed(self, hostname: str, updated: int) -> None:
        if not self.has_server(hostname):
            log.error("Attempt to change a server we don't have! (%s)",
                      hostname)
            return
        self.servers[hostname].last_updated = updated
        self.servers[hostname].last_changed = updated
        self.last_changed = updated

    def notify_listeners(self, svc: Service, previous_status: int,
                         changed_time: int) -> None:
        """Non-blocking fan-out (services_state.go:217-240)."""
        event = ChangeEvent(service=svc.copy(),
                            previous_status=previous_status,
                            time=changed_time)
        # Query-plane publish rides the same writer path: versions are
        # totally ordered because every change funnels through here
        # (under the state lock), and publish itself never blocks —
        # slow subscribers coalesce on their own bounded queues.
        hub = self._query_hub
        if hub is not None:
            hub.publish(event)
        for listener in list(self._listeners.values()):
            ch = listener.chan()
            if ch is None:
                continue  # hub-driven: fed by the query plane above
            try:
                ch.put_nowait(event)
            except queue.Full:
                log.warning("Can't notify listener (%s). May not be ready "
                            "yet.", listener.name())

    def add_listener(self, listener: Listener) -> None:
        """services_state.go:245-261 — queues must be bounded (≥1).

        Hub-driven listeners (``hub_driven = True``, e.g. UrlListener)
        carry no queue: they register here only for the managed-listener
        lifecycle (track_local_listeners) and receive their events
        through a query-hub subscription instead."""
        ch = listener.chan()
        if ch is None:
            if getattr(listener, "hub_driven", False):
                with self._lock:
                    self._listeners[listener.name()] = listener
                return
            log.error("Refusing to add listener %s with nil channel!",
                      listener.name())
            return
        if ch.maxsize < 1:
            log.error("Refusing to add blocking channel as listener: %s",
                      listener.name())
            return
        with self._lock:
            self._listeners[listener.name()] = listener

    def remove_listener(self, name: str) -> None:
        with self._lock:
            if name not in self._listeners:
                raise KeyError(f"no listener found with the name {name!r}")
            del self._listeners[name]

    def get_listeners(self) -> list[Listener]:
        with self._lock:
            return list(self._listeners.values())

    # -- server expiry (SWIM NotifyLeave path) -----------------------------

    def expire_server(self, hostname: str) -> None:
        """Tombstone all of a dead node's records and announce them
        TOMBSTONE_COUNT× (services_state.go:150-192)."""
        with self._lock:
            server = self.servers.get(hostname)
            if not server or not server.services:
                log.info("No records to expire for %s", hostname)
                return
            if all(svc.is_tombstone() for svc in server.services.values()):
                log.info("No records to expire for %s (no live services)",
                         hostname)
                return
            log.info("Expiring %s", hostname)
            tombstones = []
            now = self._now()
            for svc in server.services.values():
                previous = svc.status
                # tombstone() mutates (status, updated) IN PLACE — the
                # digest key covers both, so subtract the old pair
                # first (capture-before-mutate).
                self._digest_remove(svc)
                svc.tombstone(now=now)
                self._digest_add(svc)
                self.service_changed(svc, previous, svc.updated)
                tombstones.append(svc.copy())
            self._digest_publish()
        self.send_services(
            tombstones,
            TimedLooper(self.tombstone_retransmit, TOMBSTONE_COUNT))

    # -- broadcast lifecycle loops -----------------------------------------

    def is_new_service(self, svc: Service) -> bool:
        """services_state.go:505-517."""
        found = None
        if self.has_server(svc.hostname):
            found = self.servers[svc.hostname].services.get(svc.id)
        return found is None or (not svc.is_tombstone()
                                 and svc.status != found.status)

    def broadcast_services_step(
            self, fn: Callable[[], list[Service]]) -> Callable[[], None]:
        """One tick of :meth:`broadcast_services` — exposed so the node
        scheduler can drive it without a dedicated thread."""
        last_time = 0

        def one() -> None:
            nonlocal last_time
            services = []
            have_new = False
            service_list = fn()
            with self._lock:
                now = self._now()
                for svc in service_list:
                    if self.is_new_service(svc):
                        have_new = True
                        services.append(svc)
                    elif now - int(ALIVE_BROADCAST_INTERVAL *
                                   NS_PER_SECOND) > last_time:
                        services.append(svc)
            if services:
                run_count = ALIVE_COUNT if have_new else 1
                last_time = self._now()
                self.send_services(
                    services,
                    TimedLooper(self.tombstone_retransmit, run_count))
            else:
                self.broadcasts.put(None)

        return one

    def broadcast_services(self, fn: Callable[[], list[Service]],
                           looper: Looper) -> None:
        """Announce local services: new ⇒ ALIVE_COUNT× @ 1 Hz, else
        re-announce on the 1-minute refresh window
        (services_state.go:525-574)."""
        looper.loop(self.broadcast_services_step(fn))

    def send_services(self, services: list[Service], looper: Looper,
                      background: bool = True) -> Optional[threading.Thread]:
        """Re-enqueue each record every second, bumping Updated +50 ns per
        round so peers retransmit (services_state.go:579-604)."""
        services = [svc.copy() for svc in services]
        base_updated = [svc.updated for svc in services]

        def run() -> None:
            additional = 0

            def one() -> None:
                nonlocal additional
                prepared = []
                for svc, base in zip(services, base_updated):
                    # Linear +50 ns per round from the ORIGINAL stamp so
                    # peers see each round as strictly newer
                    # (services_state.go:585-599 copies the struct per
                    # iteration; re-adding to the mutated copy would
                    # compound the skew).
                    svc.updated = base + additional
                    prepared.append(svc.encode())
                additional += 50
                self.broadcasts.put(prepared)

            looper.loop(one)

        if background:
            t = threading.Thread(target=run, name="send-services", daemon=True)
            t.start()
            return t
        run()
        return None

    def broadcast_tombstones(self, fn: Callable[[], list[Service]],
                             looper: Looper) -> None:
        """Tombstone vanished local services + expire remote state
        (services_state.go:606-633)."""
        looper.loop(self.broadcast_tombstones_step(fn))

    def broadcast_tombstones_step(
            self, fn: Callable[[], list[Service]]) -> Callable[[], None]:
        """One tick of :meth:`broadcast_tombstones` (scheduler form)."""
        def one() -> None:
            with self._lock:
                container_list = fn()
                other = self.tombstone_others_services()
                mine = self.tombstone_services(self.hostname, container_list)
                tombstones = mine + other
            if tombstones:
                self.send_services(
                    tombstones,
                    TimedLooper(self.tombstone_retransmit, TOMBSTONE_COUNT))
            else:
                self.broadcasts.put(None)

        return one

    def tombstone_others_services(self) -> list[Service]:
        """Lifespan sweep over the whole view: GC 3h-old tombstones, and
        tombstone expired records at original-timestamp+1s so unseen newer
        records still win (services_state.go:635-683)."""
        result = []
        now = self._now()
        with self._lock:
            changed = False
            for hostname in list(self.servers):
                server = self.servers[hostname]
                for sid in list(server.services):
                    svc = server.services[sid]
                    if svc.is_tombstone() and svc.updated < now - int(
                            TOMBSTONE_LIFESPAN * NS_PER_SECOND):
                        self._digest_remove(svc)
                        changed = True
                        del server.services[sid]
                        if not server.services:
                            del self.servers[hostname]
                        continue
                    lifespan = (DRAINING_LIFESPAN if svc.is_draining()
                                else ALIVE_LIFESPAN)
                    if not svc.is_tombstone() and svc.updated < now - int(
                            lifespan * NS_PER_SECOND):
                        log.warning(
                            "Found expired service %s ID %s from %s, "
                            "tombstoning", svc.name, svc.id, svc.hostname)
                        previous = svc.status
                        # Original timestamp + 1 s, NOT now — the "+1 s
                        # rule" (services_state.go:667-675).  In-place
                        # restamp: subtract the old digest key first.
                        self._digest_remove(svc)
                        svc.status = TOMBSTONE
                        svc.updated = svc.updated + NS_PER_SECOND
                        self._digest_add(svc)
                        changed = True
                        self.service_changed(svc, previous, svc.updated)
                        result.append(svc.copy())
            if changed:
                self._digest_publish()
        return result

    def tombstone_services(self, hostname: str,
                           container_list: list[Service]) -> list[Service]:
        """Tombstone local services that vanished from discovery; each
        record twice for receipt (services_state.go:685-715)."""
        if not self.has_server(hostname):
            return []
        mapping = {svc.id for svc in container_list}
        result = []
        now = self._now()
        with self._lock:
            for svc in self.servers[hostname].services.values():
                if svc.id not in mapping and not svc.is_tombstone():
                    log.warning("Tombstoning %s", svc.id)
                    previous = svc.status
                    self._digest_remove(svc)
                    svc.tombstone(now=now)
                    self._digest_add(svc)
                    self.service_changed(svc, previous, svc.updated)
                    result.extend([svc.copy(), svc.copy()])
            if result:
                self._digest_publish()
        return result

    # -- tracking loops ----------------------------------------------------

    def track_new_services(self, fn: Callable[[], list[Service]],
                           looper: Looper) -> None:
        """services_state.go:444-452."""
        looper.loop(self.track_new_services_step(fn))

    def track_new_services_step(
            self, fn: Callable[[], list[Service]]) -> Callable[[], None]:
        """One tick of :meth:`track_new_services` (scheduler form)."""
        def one() -> None:
            for svc in fn():
                self.update_service(svc)
        return one

    def track_local_listeners(self, fn: Callable[[], list[Listener]],
                              looper: Looper) -> None:
        """Sync managed listeners with discovery
        (services_state.go:454-497)."""
        looper.loop(self.track_local_listeners_step(fn))

    def track_local_listeners_step(
            self, fn: Callable[[], list[Listener]]) -> Callable[[], None]:
        """One tick of :meth:`track_local_listeners` (scheduler form)."""
        def one() -> None:
            discovered = fn()
            names = {listener.name() for listener in discovered}
            for listener in discovered:
                with self._lock:
                    have = listener.name() in self._listeners
                if not have:
                    log.info("Adding listener %s because it was just "
                             "discovered", listener.name())
                    watch = getattr(listener, "watch", None)
                    if callable(watch):
                        watch(self)
                    else:
                        self.add_listener(listener)
            for listener in self.get_listeners():
                if listener.managed() and listener.name() not in names:
                    log.info("Removing listener %s because the service "
                             "appears to be gone", listener.name())
                    stop = getattr(listener, "stop", None)
                    if callable(stop):
                        stop()
                    try:
                        self.remove_listener(listener.name())
                    except KeyError as exc:
                        log.warning("Failed to remove listener: %s", exc)
        return one

    # -- iteration / views -------------------------------------------------

    def each_server(self) -> Iterator[tuple[str, Server]]:
        yield from list(self.servers.items())

    def each_service(self) -> Iterator[tuple[str, str, Service]]:
        for hostname, server in self.each_server():
            for sid, svc in list(server.services.items()):
                yield hostname, sid, svc

    def each_service_sorted(self) -> Iterator[tuple[str, str, Service]]:
        """Deterministic order — hostname then service ID (view.go:14-33);
        the Envoy adapter's oldest-wins collision guard relies on it."""
        for hostname in sorted(self.servers):
            server = self.servers[hostname]
            for sid in sorted(server.services):
                yield hostname, sid, server.services[sid]

    def by_service(self) -> dict[str, list[Service]]:
        """Group instances by service name (services_state.go:752-764)."""
        out: dict[str, list[Service]] = {}
        with self._lock:
            for _, _, svc in self.each_service_sorted():
                out.setdefault(svc.name, []).append(svc.copy())
        return out

    # -- display -----------------------------------------------------------

    def format(self, members: Optional[Iterable[str]] = None) -> str:
        """Human-readable dump (services_state.go:396-436)."""
        now = self._now()
        out = "Services ------------------------------\n"
        with self._lock:
            for name in sorted(self.servers):
                server = self.servers[name]
                out += f"  {name}: ({time_ago(server.last_updated, now)})\n"
                for svc in sorted(server.services.values(),
                                  key=lambda s: s.name):
                    out += svc_mod.format_service(svc, now)
                out += "\n"
        if members is None:
            return out
        out += "\nCluster Hosts -------------------------\n"
        for host in members:
            out += f"    {host}\n"
        out += "---------------------------------------"
        return out


def decode(data: bytes | str) -> ServicesState:
    """Rebuild a state from its JSON wire form (services_state.go:774-782).

    Raises ValueError on ANY malformed payload — push-pull bodies come
    from (same-cluster but untrusted) peers, and a TypeError or
    AttributeError leaking from a shape surprise would kill the caller's
    merge loop, silently ending anti-entropy."""
    try:
        d = json.loads(data)
        if not isinstance(d, dict):
            raise ValueError("state JSON: not an object")
        state = ServicesState(
            hostname=_as_str(d.get("Hostname"), "") or "")
        state.cluster_name = _as_str(d.get("ClusterName"), "") or ""
        state.last_changed = _ts(d.get("LastChanged"))
        for hostname, sd in (d.get("Servers") or {}).items():
            state.servers[hostname] = Server.from_json(sd)
        # Coherence annotation (encode_annotated): captured verbatim for
        # merge() to harvest — never merged into the decoded state's own
        # (empty) incremental digest, which only the writer maintains.
        dig = d.get("Digest")
        if isinstance(dig, dict):
            state.wire_digest = dig
        return state
    except (json.JSONDecodeError, UnicodeDecodeError, TypeError,
            AttributeError, KeyError, OverflowError) as exc:
        raise ValueError(
            f"failed to decode state JSON: {exc}") from exc


def decode_stream(stream, callback) -> None:
    """Newline-delimited JSON of by-service maps
    (services_state.go:766-772): calls ``callback(mapping, error)`` per
    document.

    Stop-on-first-error is DELIBERATE reference parity: the Go
    DecodeStream returns on its first Decode error
    (services_state.go:766-772), ending the stream.  The alternative
    (skip the bad document and continue) would hide a desynced or
    corrupted stream from a long-lived consumer; matching the
    reference, the callback sees the error once and the reader stops —
    reconnecting is the consumer's decision (the receiver library's
    retry loop does exactly that)."""
    for line in stream:
        if not line.strip():
            continue
        try:
            doc = json.loads(line)
            mapping = {name: [Service.from_json(s) for s in svcs]
                       for name, svcs in doc.items()}
        except (json.JSONDecodeError, AttributeError, TypeError,
                ValueError, KeyError, OverflowError) as exc:
            # Same wire-boundary rule as decode(): any malformed document
            # becomes the callback's error, never an exception that
            # kills the reader of a long-lived /watch stream.  Only the
            # parse sits inside the try — a consumer callback's own
            # exceptions must propagate, not masquerade as wire errors.
            callback(None, exc)
            return
        callback(mapping, None)
