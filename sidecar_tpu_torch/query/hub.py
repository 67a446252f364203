"""The subscription hub — the port of ``sidecar_tpu/query/hub.py``:
versioned snapshot publication and delta fan-out.

``ServicesState`` calls :meth:`QueryHub.publish` for every change event
from inside ``notify_listeners``, under the writer's lock, so versions
are totally ordered.  Each publish builds the successor
:class:`~sidecar_tpu_torch.query.snapshot.CatalogSnapshot` copy-on-write
and offers every subscriber a delta event on a bounded queue.

Backpressure (``docs/query.md``): a subscriber whose queue is full has
its queued deltas replaced by one snapshot-at-latest-version marker;
its next read is a ``snapshot`` event at the current version, after
which deltas resume without a gap.  ``query.hub.dropped`` counts the
deltas discarded and ``query.hub.coalesced`` the collapses.  Publish
never blocks the writer and serializes nothing.  Publish and delivery
stamp ``published_ns`` and the lag histograms with the wall clock.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import threading
import time
from typing import Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.telemetry.span import span as _span
from sidecar_tpu_torch.telemetry import propagation as _propagation
from sidecar_tpu_torch.query.snapshot import (
    CatalogSnapshot,
    ServerView,
    record_encode,
    snapshot_from_state,
)

log = logging.getLogger(__name__)

# Default per-subscriber queue bound.  Small enough that a stuck
# consumer collapses to a snapshot quickly instead of holding hundreds
# of delta events alive; large enough to ride normal bursts.
DEFAULT_SUBSCRIBER_BUFFER = 64

# Relay hubs ride a deeper queue than leaf subscribers: a relay that
# coalesces forces a resync on EVERY subscriber downstream of it, so
# the tier trades a little memory for far fewer collapses.
DEFAULT_RELAY_BUFFER = 256

# Fill lock for the per-event wire-encoding caches.  One lock for all
# events is fine: it is only ever taken by the FIRST consumer of each
# buffer (once per published version), never on the shared-buffer hot
# path.  Re-entrant: delta_doc_bytes fills change_frag under it.
_event_fill = threading.RLock()


class QueryEvent:
    """One item on a subscription queue.

    ``kind`` is ``"delta"`` (one catalog change; ``change`` holds the
    :class:`~sidecar_tpu_torch.catalog.state.ChangeEvent`) or ``"snapshot"``
    (resync-at-latest: the subscriber fell behind, or this is the
    priming event of a fresh subscription).  ``version`` is the hub
    version AFTER applying the event; ``snapshot`` is the catalog at
    exactly that version.  ``published_ns`` stamps delta events at
    fan-out time so delivery can account publish-to-deliver lag
    (``query.hub.lag``); resync markers are built at delivery and
    carry 0.
    """

    __slots__ = ("kind", "version", "snapshot", "change", "published_ns",
                 "_frag", "_delta_doc")

    def __init__(self, kind: str, version: int,
                 snapshot: CatalogSnapshot, change=None,
                 published_ns: int = 0) -> None:
        self.kind = kind
        self.version = version
        self.snapshot = snapshot
        self.change = change
        self.published_ns = published_ns
        self._frag: Optional[bytes] = None
        self._delta_doc: Optional[bytes] = None

    # -- shared wire encodings (zero-copy fan-out, docs/query.md) ----------

    def change_frag(self) -> bytes:
        """Compact encoding of this delta's ChangeEvent — filled once
        per published version under the fill lock, then handed to every
        consumer as the same object: the /watch ``Deltas`` array and the
        UrlListener POST body are composed from this buffer instead of
        re-running ``json.dumps`` per subscriber."""
        frag = self._frag
        if frag is None:
            with _event_fill:
                if self._frag is None:
                    buf = json.dumps(self.change.to_json(),
                                     separators=(",", ":")).encode()
                    record_encode(len(buf))
                    self._frag = buf
                frag = self._frag
        return frag

    def delta_doc_bytes(self) -> bytes:
        """The UrlListener delta POST body
        (``{"Version": V, "ChangeEvent": {...}}``, byte-identical to
        ``delta_event_json``) as one cached buffer shared by every
        listener delivering this version."""
        doc = self._delta_doc
        if doc is None:
            with _event_fill:
                if self._delta_doc is None:
                    self._delta_doc = (b'{"Version":%d,"ChangeEvent":%s}'
                                       % (self.version, self.change_frag()))
                doc = self._delta_doc
        return doc

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"QueryEvent({self.kind}, v{self.version})"


class Subscription:
    """A bounded, coalescing delta queue for one consumer."""

    def __init__(self, hub: "QueryHub", name: str, buffer: int) -> None:
        if buffer < 1:
            raise ValueError("subscription buffer must be >= 1")
        self.name = name
        self._hub = hub
        self._buffer = buffer
        self._cond = threading.Condition()
        self._deque: "collections.deque[QueryEvent]" = collections.deque()
        self._pending_snapshot: Optional[CatalogSnapshot] = None
        self._closed = False
        # Per-subscriber delivery-lag instrumentation (docs/query.md):
        # how far behind the hub head this consumer's reads run, in
        # versions and in wall ms — updated at every delta delivery.
        self.delivered = 0
        self.last_lag_versions = 0
        self.last_lag_ms = 0.0

    # -- producer side (hub, under the writer path) ------------------------

    def _offer(self, event: QueryEvent) -> None:
        with self._cond:
            if self._closed:
                return
            if self._pending_snapshot is not None:
                # Already collapsed: the marker subsumes every delta up
                # to latest, just slide it forward.
                self._pending_snapshot = event.snapshot
                metrics.incr("query.hub.dropped")
            elif len(self._deque) >= self._buffer:
                dropped = len(self._deque)
                self._deque.clear()
                self._pending_snapshot = event.snapshot
                metrics.incr("query.hub.dropped", dropped + 1)
                metrics.incr("query.hub.coalesced")
                log.warning("query: subscriber %s fell behind; coalesced "
                            "%d deltas to snapshot v%d", self.name,
                            dropped + 1, event.version)
            else:
                self._deque.append(event)
            self._cond.notify_all()

    # -- consumer side -----------------------------------------------------

    def get(self, timeout: Optional[float] = None) -> Optional[QueryEvent]:
        """Next event, or None on timeout / after :meth:`close`.  A
        pending resync marker is delivered before any newer deltas (it
        is always the oldest information the subscriber is missing)."""
        event = None
        with self._cond:
            if not self._deque and self._pending_snapshot is None \
                    and not self._closed:
                self._cond.wait(timeout=timeout)
            if self._pending_snapshot is not None:
                snap = self._pending_snapshot
                self._pending_snapshot = None
                event = QueryEvent("snapshot", snap.version, snap)
            elif self._deque:
                event = self._deque.popleft()
        if event is not None:
            self._observe_delivery(event)
        return event

    def drain(self) -> list[QueryEvent]:
        """Every immediately-available event (burst coalescing for
        consumers that batch, e.g. the /watch chunk writer)."""
        out = []
        with self._cond:
            if self._pending_snapshot is not None:
                snap = self._pending_snapshot
                self._pending_snapshot = None
                out.append(QueryEvent("snapshot", snap.version, snap))
            while self._deque:
                out.append(self._deque.popleft())
        for event in out:
            self._observe_delivery(event)
        return out

    def _observe_delivery(self, event: QueryEvent) -> None:
        """Publish-to-deliver lag accounting, OUTSIDE the queue lock
        (metrics registry has its own).  Version gap = how far the hub
        head has moved past the event being handed over right now —
        the subscriber's staleness in catalog versions; ms = wall time
        the event sat queued.  Only delta events carry a publish stamp
        (resync markers are built at delivery — their lag is exactly
        the coalescing they represent, already counted in
        ``query.hub.dropped``)."""
        if not event.published_ns:
            return
        cur = self._hub._current
        gap = max(0, (cur.version if cur is not None
                      else event.version) - event.version)
        ms = max(0.0, (time.time_ns() - event.published_ns) / 1e6)
        self.delivered += 1
        self.last_lag_versions = gap
        self.last_lag_ms = ms
        metrics.histogram("query.hub.lag", ms)
        metrics.histogram("query.hub.lag.versions", gap)
        self._hub._observe_lag(gap)

    def pending(self) -> int:
        with self._cond:
            return len(self._deque) + (
                1 if self._pending_snapshot is not None else 0)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Detach from the hub; wakes any blocked :meth:`get`."""
        with self._cond:
            self._closed = True
            self._deque.clear()
            self._pending_snapshot = None
            self._cond.notify_all()
        self._hub._remove(self)


class QueryHub:
    """Snapshot publisher + subscriber registry for one catalog."""

    def __init__(self, state,
                 default_buffer: int = DEFAULT_SUBSCRIBER_BUFFER) -> None:
        self.state = state
        self.default_buffer = default_buffer
        self._lock = threading.Lock()      # subscriber set + version
        # Keyed by id(sub): O(1) unsubscribe at 100k-subscriber churn
        # (the old list scan made churn quadratic) while dict insertion
        # order keeps publish-order iteration stable.
        self._subs: dict[int, Subscription] = {}
        self._current: Optional[CatalogSnapshot] = None
        # High-water mark of the delivery version gap across ALL
        # subscribers — the query.hub.lag.max gauge (reset with the
        # metrics registry in tests).  Guarded by its own lock, NOT the
        # registry lock: every delivery calls _observe_lag, and an
        # unlocked read-modify-write here let concurrent deliveries
        # regress the high-water mark.
        self._max_lag_versions = 0
        self._lag_lock = threading.Lock()

    def _observe_lag(self, gap: int) -> None:
        with self._lag_lock:
            if gap > self._max_lag_versions:
                self._max_lag_versions = gap
            # Gauge write inside the lock so a stale value can never
            # overwrite a newer maximum.
            metrics.set_gauge("query.hub.lag.max", self._max_lag_versions)

    # -- lifecycle ---------------------------------------------------------

    def attach(self) -> CatalogSnapshot:
        """Build the version-1 snapshot from the live state.  Takes the
        state lock itself (re-entrant from ``ServicesState.query_hub``);
        lock order is always state → hub."""
        with self.state._lock:
            with self._lock:
                if self._current is None:
                    self._current = snapshot_from_state(self.state, 1)
                    metrics.set_gauge("query.snapshot.version", 1)
                return self._current

    def current(self) -> CatalogSnapshot:
        """The latest snapshot — one reference read, never a lock on
        the catalog."""
        snap = self._current
        if snap is None:
            return self.attach()
        return snap

    @property
    def damper(self):
        """The catalog's flap damper (catalog/damping.py), or None —
        snapshot-path consumers (the ADS server, HAProxy writer) gate
        proxy admission on it so a flapping service is withheld from
        routing without being dropped from the snapshots themselves
        (the catalog views stay complete; damping is a routing
        decision)."""
        return getattr(self.state, "flap_damper", None)

    # -- the writer-path publish -------------------------------------------

    def publish(self, event) -> CatalogSnapshot:
        """Build + publish the successor snapshot for one ChangeEvent.

        Runs on the catalog writer path, under ``state._lock`` (the
        re-entrant lock makes the state reads here free).  Copy-on-write
        scope: only the changed host's ``ServerView`` is rebuilt — from
        the previous snapshot's frozen services when the host's service
        set is unchanged (O(1) upsert of the event's own frozen copy),
        from the live state when services appeared/vanished (catches
        tombstone GC deletions, which emit no events)."""
        host = event.service.hostname
        with self._lock:
            prev = self._current
            if prev is None:
                # Publish before attach: the implicit v1 snapshot is
                # built from the (already mutated) state, so the v2
                # successor below is content-identical — harmless.
                prev = snapshot_from_state(self.state, 1)
            servers = dict(prev.servers)
            live = self.state.servers.get(host)
            if live is None:
                servers.pop(host, None)
            else:
                prev_view = prev.servers.get(host)
                if prev_view is not None and \
                        prev_view.services.keys() == live.services.keys() \
                        and event.service.id in live.services:
                    services = dict(prev_view.services)
                    services[event.service.id] = event.service
                else:
                    services = {sid: svc.copy()
                                for sid, svc in live.services.items()}
                servers[host] = ServerView(
                    name=live.name, services=services,
                    last_updated=live.last_updated,
                    last_changed=live.last_changed)
            snap = CatalogSnapshot(
                version=prev.version + 1,
                changed_ns=self.state.last_changed,
                cluster_name=self.state.cluster_name,
                hostname=self.state.hostname,
                servers=servers)
            self._current = snap
            subs = list(self._subs.values())
        metrics.incr("query.hub.published")
        metrics.set_gauge("query.snapshot.version", snap.version)
        qevent = QueryEvent("delta", snap.version, snap, change=event,
                            published_ns=time.time_ns())
        # The publish hop of the live propagation path: span for the
        # /api/trace causal chain, fan-out latency (all subscriber
        # offers for one version) into the query.hub.fanout histogram —
        # the p50/p95/p99 the 100k-watcher climb is measured by
        # (docs/telemetry.md, docs/metrics.md).
        with _span("query.publish"):
            t0 = time.perf_counter()
            for sub in subs:
                sub._offer(qevent)
            metrics.histogram_since("query.hub.fanout", t0)
        # End-to-end propagation lag at the query plane — the second
        # site of the live provenance twin (telemetry/propagation.py):
        # how far behind the origin's stamp this record was when it
        # became visible to /watch consumers.
        _propagation.observe("query", event.service.hostname,
                             (time.time_ns() - event.service.updated)
                             / 1e6)
        return snap

    # -- subscriptions -----------------------------------------------------

    def subscribe(self, name: str, buffer: Optional[int] = None,
                  prime: bool = True) -> Subscription:
        """Register a consumer.  With ``prime`` the first read returns a
        snapshot event at the current version, so every subscriber
        starts from a known version cursor."""
        sub = Subscription(self, name,
                           buffer if buffer is not None
                           else self.default_buffer)
        self.current()  # ensure attached (state→hub lock order)
        # Snapshot read + registration are ONE critical section: a
        # publish interleaved between them would be missed by both the
        # prime snapshot and the fan-out (it copies _subs before the
        # append) — the subscriber would hold a stale cursor with no
        # delta coming.
        with self._lock:
            self._subs[id(sub)] = sub
            if prime:
                # Inside the registration critical section: a publish
                # interleaved after registration could collapse the
                # queue to a NEWER pending snapshot, and an unlocked
                # prime assignment would overwrite it with the older
                # one (hub→sub lock order matches publish's fan-out;
                # close() releases the cond before taking the hub
                # lock, so no inversion).
                with sub._cond:
                    sub._pending_snapshot = self._current
                    sub._cond.notify_all()
            n_subs = len(self._subs)
        metrics.set_gauge("query.hub.subscribers", n_subs)
        return sub

    def _remove(self, sub: Subscription) -> None:
        with self._lock:
            if self._subs.pop(id(sub), None) is None:
                return
            metrics.set_gauge("query.hub.subscribers", len(self._subs))

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)


# -- tiered relay fan-out ---------------------------------------------------

_relay_count = 0
_relay_count_lock = threading.Lock()


def _relay_count_delta(d: int) -> None:
    global _relay_count
    with _relay_count_lock:
        _relay_count += d
        metrics.set_gauge("query.hub.tier.relays", _relay_count)


class RelayHub:
    """A coalescing fan-out tier between the root :class:`QueryHub` and
    its subscribers (docs/query.md).

    The relay holds ONE bounded subscription on its parent (the root
    hub or another relay) and re-fans every event to its own
    subscriptions from a dedicated delivery thread.  With W relays over
    N subscribers the writer-path publish touches W queues instead of
    N — O(relays) on the catalog writer — and the O(N) offer work
    happens on relay threads, off the writer.  Composing relays builds
    a tree (:func:`relay_tree`) whose per-hub fan-out stays bounded.

    Semantics are preserved end-to-end:

    * Events are re-fanned by reference — same ``QueryEvent``, same
      shared wire buffers, original ``published_ns`` — so a leaf
      subscriber's ``query.hub.lag`` measures true publish-to-deliver
      latency across every tier, and its version-gap is computed
      against the ROOT head.
    * A relay that falls behind collapses its parent queue to a
      snapshot marker exactly like any subscriber; re-fanning that
      marker resyncs everyone downstream (gap-free by construction).
    * Subscribing primes from the relay's *delivered horizon* (the last
      event it re-fanned), not the root head: the relay-local stream
      stays contiguous — prime at vK, next delta vK+1.
    """

    def __init__(self, parent, name: str = "relay",
                 buffer: int = DEFAULT_RELAY_BUFFER,
                 poll: float = 0.5) -> None:
        self.name = name
        self._parent = parent
        self._root = getattr(parent, "_root", parent)
        self._lock = threading.Lock()      # horizon + subscriber set
        self._subs: dict[int, Subscription] = {}
        self._closed = False
        self._poll = poll
        self.relayed = 0
        self._psub = parent.subscribe(f"relay:{name}", buffer=buffer,
                                      prime=False)
        # Horizon AFTER subscribing: events already queued are ≤ this
        # version and get skipped as catch-up duplicates; everything
        # newer flows through, so the horizon is never ahead of a
        # missed event.
        self._last: CatalogSnapshot = parent.current()
        _relay_count_delta(+1)
        self._thread = threading.Thread(
            target=self._pump, name=f"relay-{name}", daemon=True)
        self._thread.start()

    # -- QueryHub surface consumed by Subscription -------------------------

    @property
    def _current(self) -> Optional[CatalogSnapshot]:
        # Lag accounting measures staleness against the ROOT head.
        return self._root._current

    @property
    def default_buffer(self) -> int:
        return self._root.default_buffer

    @property
    def damper(self):
        return self._root.damper

    def current(self) -> CatalogSnapshot:
        return self._root.current()

    def _observe_lag(self, gap: int) -> None:
        self._root._observe_lag(gap)

    # -- delivery ----------------------------------------------------------

    def _pump(self) -> None:
        while True:
            ev = self._psub.get(timeout=self._poll)
            if self._closed or self._psub.closed:
                return
            if ev is None:
                continue
            with self._lock:
                # Horizon advance + fan-out list are ONE critical
                # section with subscribe()'s prime (the same discipline
                # as QueryHub.publish): a subscriber primed at _last
                # can never miss a later event.
                if ev.version <= self._last.version:
                    continue  # pre-subscription catch-up duplicate
                self._last = ev.snapshot
                subs = list(self._subs.values())
            t0 = time.perf_counter()
            for sub in subs:
                sub._offer(ev)
            self.relayed += 1
            metrics.incr("query.hub.tier.relayed")
            metrics.histogram_since("query.hub.tier.fanout", t0)

    # -- subscriptions (QueryHub parity) -----------------------------------

    def subscribe(self, name: str, buffer: Optional[int] = None,
                  prime: bool = True) -> Subscription:
        sub = Subscription(self, name,
                           buffer if buffer is not None
                           else self.default_buffer)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"relay {self.name} is closed")
            self._subs[id(sub)] = sub
            if prime:
                with sub._cond:
                    sub._pending_snapshot = self._last
                    sub._cond.notify_all()
        return sub

    def _remove(self, sub: Subscription) -> None:
        with self._lock:
            self._subs.pop(id(sub), None)

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def close(self) -> None:
        """Detach from the parent and close every downstream
        subscription (their blocked gets wake with None)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            subs = list(self._subs.values())
            self._subs.clear()
        self._psub.close()
        for sub in subs:
            sub.close()
        _relay_count_delta(-1)


def relay_tree(root: QueryHub, leaves: int, max_fanout: int = 16,
               buffer: int = DEFAULT_RELAY_BUFFER,
               name: str = "tier") -> tuple[list, list]:
    """Build a balanced relay tree under ``root`` with ``leaves`` leaf
    relays and at most ``max_fanout`` children per hub; returns
    ``(leaf_relays, all_relays)``.  Spread subscribers across the leaf
    relays: one root publish then costs ≤ ``max_fanout`` offers and
    every delivery thread re-fans a bounded set (100k subscribers at
    2048/leaf → 49 leaves, 4 mid relays, 2 tiers)."""
    if leaves < 1:
        raise ValueError("relay tree needs at least one leaf")
    sizes = [leaves]
    while sizes[0] > max_fanout:
        sizes.insert(0, math.ceil(sizes[0] / max_fanout))
    parents: list = [root]
    relays: list = []
    for tier, size in enumerate(sizes):
        level = [RelayHub(parents[i * len(parents) // size],
                          name=f"{name}{tier}.{i}", buffer=buffer)
                 for i in range(size)]
        relays.extend(level)
        parents = level
    return parents, relays
