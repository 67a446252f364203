"""Immutable versioned catalog snapshots — the port of
``sidecar_tpu/query/snapshot.py``, the copy-on-write read view.

A :class:`CatalogSnapshot` is a frozen view of the catalog at one hub
version: readers hold a reference and walk it without a lock, since a
published snapshot never changes.  The publisher
(:class:`sidecar_tpu_torch.query.hub.QueryHub`) builds each successor by
structural sharing — only the host a change touched gets a fresh
service map — so a publish costs O(services on that host), and each
serialization (``to_json``, ``encode``, ``by_service``) is computed at
most once a version and shared by every consumer.

Versions count up from 1 (the attach snapshot).  ``changed_ns`` is the
catalog's ``LastChanged`` at publish time, so the wire keeps the RFC 3339
``LastChanged`` field beside the version cursor.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Iterator, Mapping, Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.service import Service, ns_to_rfc3339

_SEP = (",", ":")


def record_encode(nbytes: int) -> None:
    """Account one wire-encoding cache fill (``query.encode.*``).

    Counted ONLY on fills — never on cache hits — so the counters read
    as "serialization work actually performed": at N subscribers the
    zero-copy read path holds ``query.encode.bytes`` at O(1) per
    published version while the old path would have been O(N).  The
    bench's ``query_scale`` block derives its baseline-vs-zero-copy
    ratio from exactly these counters."""
    metrics.incr("query.encode.count")
    metrics.incr("query.encode.bytes", nbytes)


@dataclasses.dataclass(frozen=True)
class ServerView:
    """Frozen per-host slice of a snapshot (the ``Server`` analog)."""

    name: str
    services: Mapping[str, Service]   # sid → frozen Service copy
    last_updated: int
    last_changed: int

    def to_json(self) -> dict:
        return {
            "Name": self.name,
            "Services": {sid: s.to_json()
                         for sid, s in self.services.items()},
            "LastUpdated": ns_to_rfc3339(self.last_updated),
            "LastChanged": ns_to_rfc3339(self.last_changed),
        }


class CatalogSnapshot:
    """One immutable, versioned view of the catalog.

    Every serialization is computed at most once per version, under the
    snapshot's fill lock, and the SAME buffer object is handed to every
    consumer — the /watch chunk writer, UrlListener POST bodies, and the
    state-dump endpoints all share it (zero-copy fan-out: per version
    the cost is one ``json.dumps`` plus O(subscribers) pointer
    hand-offs).  The fast path is lock-free: a filled cache slot is read
    without taking the lock (attribute assignment is atomic), only the
    first reader of each form pays for the fill.
    """

    __slots__ = ("version", "changed_ns", "cluster_name", "hostname",
                 "servers", "_fill", "_json", "_encoded", "_by_service",
                 "_by_service_encoded", "_watch_raw", "_watch_by_service",
                 "_resync_doc")

    def __init__(self, version: int, changed_ns: int, cluster_name: str,
                 hostname: str,
                 servers: Mapping[str, ServerView]) -> None:
        self.version = version
        self.changed_ns = changed_ns
        self.cluster_name = cluster_name
        self.hostname = hostname
        self.servers = servers
        self._fill = threading.RLock()
        self._json: Optional[dict] = None
        self._encoded: Optional[bytes] = None
        self._by_service: Optional[dict] = None
        self._by_service_encoded: Optional[bytes] = None
        self._watch_raw: Optional[bytes] = None
        self._watch_by_service: Optional[bytes] = None
        self._resync_doc: Optional[bytes] = None

    # -- iteration (mirrors ServicesState's view methods) ------------------

    def each_service_sorted(self) -> Iterator[tuple[str, str, Service]]:
        """Deterministic (hostname, sid, service) walk — the same
        contract as ``ServicesState.each_service_sorted`` so consumers
        like the Envoy resource generator duck-type over either."""
        for hostname in sorted(self.servers):
            server = self.servers[hostname]
            for sid in sorted(server.services):
                yield hostname, sid, server.services[sid]

    def service_count(self) -> int:
        return sum(len(s.services) for s in self.servers.values())

    # -- cached serializations ---------------------------------------------

    def to_json(self) -> dict:
        """State-dump wire shape (``ServicesState.to_json`` parity) plus
        the version cursor."""
        doc = self._json
        if doc is None:
            with self._fill:
                if self._json is None:
                    self._json = {
                        "Servers": {h: s.to_json()
                                    for h, s in self.servers.items()},
                        "LastChanged": ns_to_rfc3339(self.changed_ns),
                        "ClusterName": self.cluster_name,
                        "Hostname": self.hostname,
                        "Version": self.version,
                    }
                doc = self._json
        return doc

    def encode(self) -> bytes:
        enc = self._encoded
        if enc is None:
            with self._fill:
                if self._encoded is None:
                    buf = json.dumps(self.to_json(),
                                     separators=_SEP).encode()
                    record_encode(len(buf))
                    self._encoded = buf
                enc = self._encoded
        return enc

    def by_service(self) -> dict[str, list[Service]]:
        """Instances grouped by service name (``ServicesState.by_service``
        parity, same deterministic order) — computed once per version."""
        grouped = self._by_service
        if grouped is None:
            with self._fill:
                if self._by_service is None:
                    out: dict[str, list[Service]] = {}
                    for _, _, svc in self.each_service_sorted():
                        out.setdefault(svc.name, []).append(svc)
                    self._by_service = out
                grouped = self._by_service
        return grouped

    def by_service_json(self) -> dict:
        return {name: [svc.to_json() for svc in instances]
                for name, instances in self.by_service().items()}

    def by_service_encoded(self) -> bytes:
        """Compact encoding of :meth:`by_service_json` — one fill per
        version, shared by every by-service /watch subscriber."""
        enc = self._by_service_encoded
        if enc is None:
            with self._fill:
                if self._by_service_encoded is None:
                    buf = json.dumps(self.by_service_json(),
                                     separators=_SEP).encode()
                    record_encode(len(buf))
                    self._by_service_encoded = buf
                enc = self._by_service_encoded
        return enc

    # -- shared wire documents (zero-copy fan-out) -------------------------

    def watch_doc_bytes(self, by_service: bool) -> bytes:
        """The full /watch snapshot document
        (``{"Version": V, "Snapshot": ...}``) as ONE cached buffer —
        every /watch subscriber of a version writes this same object to
        its socket (wrap in ``memoryview`` for partial writes)."""
        if by_service:
            doc = self._watch_by_service
        else:
            doc = self._watch_raw
        if doc is None:
            with self._fill:
                body = (self.by_service_encoded() if by_service
                        else self.encode())
                if by_service:
                    if self._watch_by_service is None:
                        self._watch_by_service = (
                            b'{"Version":%d,"Snapshot":%s}'
                            % (self.version, body))
                    doc = self._watch_by_service
                else:
                    if self._watch_raw is None:
                        self._watch_raw = (
                            b'{"Version":%d,"Snapshot":%s}'
                            % (self.version, body))
                    doc = self._watch_raw
        return doc

    def resync_doc_bytes(self) -> bytes:
        """The UrlListener resync POST body
        (``{"Version": V, "State": ...}``, docs/query.md) as one cached
        buffer shared by every listener that fell behind at this
        version."""
        doc = self._resync_doc
        if doc is None:
            with self._fill:
                if self._resync_doc is None:
                    self._resync_doc = (b'{"Version":%d,"State":%s}'
                                        % (self.version, self.encode()))
                doc = self._resync_doc
        return doc


def snapshot_from_state(state, version: int) -> CatalogSnapshot:
    """Full snapshot of a live ``ServicesState`` — the attach/resync
    path.  Caller must hold (or be on the thread that holds)
    ``state._lock``; the hub's attach path does."""
    servers = {
        h: ServerView(
            name=server.name,
            services={sid: svc.copy()
                      for sid, svc in server.services.items()},
            last_updated=server.last_updated,
            last_changed=server.last_changed,
        )
        for h, server in state.servers.items()
    }
    return CatalogSnapshot(
        version=version, changed_ns=state.last_changed,
        cluster_name=state.cluster_name, hostname=state.hostname,
        servers=servers)
