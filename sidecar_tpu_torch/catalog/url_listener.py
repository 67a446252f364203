"""UrlListener — the port of ``sidecar_tpu/catalog/url_listener.py``:
pushes catalog change events to a subscriber URL over HTTP POST
(the reference's catalog/url_listener.go:22-161).

It consumes the query hub: its drain thread reads versioned events
from a :class:`sidecar_tpu_torch.query.hub.Subscription` and POSTs the
delta shape (``docs/query.md``) — ``{"Version": V, "ChangeEvent":
{...}}`` a change, or ``{"Version": V, "State": {...}}`` when the hub
coalesced a backlog (the full state is the resync).  The older shape,
the whole catalog with each event, survives as
:func:`state_changed_event_json`.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from sidecar_tpu_torch.catalog.state import (
    ChangeEvent,
    LISTENER_EVENT_BUFFER_SIZE,
    Listener,
    ServicesState,
)

log = logging.getLogger(__name__)

CLIENT_TIMEOUT = 3.0   # url_listener.go:18
DEFAULT_RETRIES = 5    # url_listener.go:19
RETRY_INTERVAL = 0.1   # linear backoff unit (url_listener.go:88)


def with_retries(count: int, fn,
                 sleep: Callable[[float], None] = time.sleep
                 ) -> Optional[Exception]:
    """url_listener.go:81-94 — first try immediate, then ``count``
    retries with linear backoff: 1×, 2×, … ``RETRY_INTERVAL`` BEFORE
    each retry (the old schedule slept ``0.1 * 0 = 0`` before the first
    retry, so the documented backoff never backed off where it matters
    most — the immediate-retry hammer).  ``sleep`` is injectable so
    tests assert the schedule against a fake clock."""
    last: Optional[Exception] = None
    for attempt in range(count + 1):
        try:
            fn()
            return None
        except Exception as exc:  # noqa: BLE001 — retry any failure
            last = exc
            if attempt < count:
                sleep(RETRY_INTERVAL * (attempt + 1))
    log.warning("Failed after %d retries", count)
    return last


def state_changed_event_json(state: ServicesState,
                             event: ChangeEvent) -> bytes:
    """LEGACY wire shape of StateChangedEvent (url_listener.go:36-39):
    the full catalog plus the event.  With a query hub attached the
    state document comes from the immutable current snapshot — no
    ``state._lock``, serialization cached per version; the lock path
    survives only for bare states."""
    hub = getattr(state, "_query_hub", None)
    if hub is not None:
        state_doc = hub.current().to_json()
    else:
        with state._lock:
            state_doc = state.to_json()
    doc = {"State": state_doc, "ChangeEvent": event.to_json()}
    return json.dumps(doc, separators=(",", ":")).encode()


def delta_event_json(version: int, event: ChangeEvent) -> bytes:
    """Delta wire shape (docs/query.md): one versioned change.  The
    drain loop serves this same document from the QueryEvent's cached
    buffer (``QueryEvent.delta_doc_bytes`` — byte-identical); this
    function survives for consumers holding a bare ChangeEvent."""
    return json.dumps({"Version": version,
                       "ChangeEvent": event.to_json()},
                      separators=(",", ":")).encode()


def resync_event_json(snapshot) -> bytes:
    """Resync wire shape (docs/query.md): the subscriber fell behind and
    the hub collapsed its backlog — the full state at the latest
    version replaces every missed delta.  Served from the snapshot's
    shared per-version buffer when it carries one (every listener
    resyncing at a version POSTs the same object)."""
    cached = getattr(snapshot, "resync_doc_bytes", None)
    if cached is not None:
        return cached()
    return json.dumps({"Version": snapshot.version,
                       "State": snapshot.to_json()},
                      separators=(",", ":")).encode()


class UrlListener(Listener):
    # Registered in the state's listener registry for the managed-
    # listener lifecycle, but fed through a hub subscription — see
    # ServicesState.add_listener.
    hub_driven = True

    def __init__(self, url: str, managed: bool = False,
                 retries: int = DEFAULT_RETRIES,
                 timeout: float = CLIENT_TIMEOUT) -> None:
        self.url = url
        self.retries = retries
        self.timeout = timeout
        self._managed = managed
        self._name = f"UrlListener({url})"
        self._sub = None
        self._quit = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Session-affinity cookie for LB stickiness
        # (url_listener.go:40-60).
        self._cookie = ("sidecar-session-host="
                        f"{socket.gethostname()}-{time.time()}")

    # -- Listener ----------------------------------------------------------

    def chan(self):
        # Hub-driven: no listener queue.  Kept returning None so the
        # old add_listener path refuses it loudly rather than silently
        # double-subscribing (watch() is the only supported entry).
        return None

    def name(self) -> str:
        return self._name

    def set_name(self, name: str) -> None:
        self._name = name

    def managed(self) -> bool:
        return self._managed

    def stop(self) -> None:
        self._quit.set()
        if self._sub is not None:
            self._sub.close()  # wakes the drain thread's blocking get

    # -- the POST loop -----------------------------------------------------

    def _post(self, data: bytes) -> None:
        req = urllib.request.Request(
            self.url, data=data,
            headers={"Content-Type": "application/json",
                     "Cookie": self._cookie},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            if not (200 <= resp.status < 300):
                raise OSError(f"Bad status code returned ({resp.status})")

    def watch(self, state: ServicesState) -> None:
        """Subscribe to the state's query hub and start posting delta
        events in a background thread (url_listener.go:116-161 recast
        onto the hub)."""
        self._sub = state.query_hub().subscribe(
            self._name, buffer=LISTENER_EVENT_BUFFER_SIZE, prime=False)
        state.add_listener(self)  # lifecycle registry only (no queue)

        def drain() -> None:
            while not self._quit.is_set():
                ev = self._sub.get(timeout=1.0)
                if self._quit.is_set() or self._sub.closed:
                    return
                if ev is None:
                    continue
                # Shared per-version wire buffers (zero-copy fan-out):
                # every listener POSTing this version sends the SAME
                # bytes object; serialization happened at most once,
                # whoever got there first.
                if ev.kind == "snapshot":
                    data = ev.snapshot.resync_doc_bytes()
                else:
                    data = ev.delta_doc_bytes()
                err = with_retries(self.retries,
                                   lambda: self._post(data))
                if err is not None:
                    log.warning("Failed posting state to '%s' %s: %s",
                                self.url, self.name(), err)

        self._thread = threading.Thread(target=drain, name=self._name,
                                        daemon=True)
        self._thread.start()
