"""The replicated service catalog, read side — the port of what the
simulator bridge and the autopilot read of
``sidecar_tpu/catalog/state.py``: :class:`Server`, a
:class:`ServicesState` holding ``servers[hostname] → services[id] →
Service`` with its lock, and the Go wire form (:meth:`ServicesState.
to_json`, :meth:`ServicesState.encode` and :func:`decode`).

This is how a user of the port gets a catalog: :func:`decode` of the
document ``ServicesState.encode()`` writes and ``GET /api/state.json``
serves, handed to ``bridge.SimBridge``.  The writer path of the
reference — ``add_service_entry``, ``merge``, the listeners, the
incremental digest, the origin gate — belongs to the live node's host
planes and is not ported here.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Optional

from sidecar_tpu_torch.service import (
    Service,
    _as_str,
    _parse_ts,
    ns_to_rfc3339,
)


class Server:
    """State about one host in the cluster (services_state.go:50-56)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.services: dict[str, Service] = {}
        self.last_updated: int = 0
        self.last_changed: int = 0

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
        server.last_updated = _parse_ts(d.get("LastUpdated"))
        server.last_changed = _parse_ts(d.get("LastChanged"))
        return server


class ServicesState:
    """The cluster's catalog as the bridge reads it: ``servers``,
    ``hostname`` (this node), ``cluster_name``, ``last_changed``, the
    re-entrant ``_lock`` every reader takes, and the last autopilot
    report (``autopilot_report``, None before any)."""

    def __init__(self, hostname: Optional[str] = None,
                 cluster_name: str = "") -> None:
        self.servers: dict[str, Server] = {}
        self.last_changed: int = 0
        self.cluster_name = cluster_name
        self.hostname = hostname if hostname is not None \
            else socket.gethostname()
        self._lock = threading.RLock()
        self.autopilot_report: Optional[dict] = None

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


def decode(data: bytes | str) -> ServicesState:
    """A state from its JSON wire form (services_state.go:774-782); any
    malformed payload raises ``ValueError``."""
    try:
        d = json.loads(data)
        if not isinstance(d, dict):
            raise ValueError("state JSON: not an object")
        state = ServicesState(
            hostname=_as_str(d.get("Hostname"), "") or "")
        state.cluster_name = _as_str(d.get("ClusterName"), "") or ""
        state.last_changed = _parse_ts(d.get("LastChanged"))
        for hostname, sd in (d.get("Servers") or {}).items():
            state.servers[hostname] = Server.from_json(sd)
        return state
    except (json.JSONDecodeError, UnicodeDecodeError, TypeError,
            AttributeError, KeyError, OverflowError) as exc:
        raise ValueError(
            f"failed to decode state JSON: {exc}") from exc
