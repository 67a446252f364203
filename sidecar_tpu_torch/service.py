"""The service record and its wire form — the port of
``sidecar_tpu/service.py``: the status codes and their names
(:func:`status_string`), the lifespans, the RFC 3339 nanosecond
timestamps of the Go wire format, :class:`Port` and :class:`Service`
with their JSON forms and lifecycle predicates, :func:`decode` and
:func:`format_service`.

Timestamps are integer nanoseconds since the Unix epoch: the protocol
relies on nanosecond resolution (the +50 ns broadcast skew), which
``datetime`` would lose.  The reference's ``to_service``, which turns a
Docker container into a record, belongs to discovery and is not here.
"""

from __future__ import annotations

import calendar
import dataclasses
import json
import time as _time
from typing import Any, Optional

# Status codes (service/service.go:17-23); SUSPECT is the simulator's
# quarantine-before-tombstone code, which the live catalog never makes.
ALIVE = 0
TOMBSTONE = 1
UNHEALTHY = 2
UNKNOWN = 3
DRAINING = 4
SUSPECT = 5

NS_PER_SECOND = 1_000_000_000

# Lifespans (catalog/services_state.go:26-37), in seconds.
TOMBSTONE_LIFESPAN = 3 * 3600.0
ALIVE_LIFESPAN = 80.0
DRAINING_LIFESPAN = 600.0
STALENESS_FUDGE = 60.0


def now_ns() -> int:
    return _time.time_ns()


def status_string(status: int) -> str:
    """The status's name; an unknown code reads as Tombstone."""
    return {
        ALIVE: "Alive",
        UNHEALTHY: "Unhealthy",
        UNKNOWN: "Unknown",
        DRAINING: "Draining",
        SUSPECT: "Suspect",
    }.get(status, "Tombstone")


# -- RFC 3339 nanosecond timestamps (Go's time.Time JSON form) ---------------

def ns_to_rfc3339(ns: int) -> str:
    """As Go's ``time.Time.MarshalJSON``: RFC 3339 in UTC, nanoseconds
    with trailing zeros trimmed."""
    secs, nanos = divmod(ns, NS_PER_SECOND)
    base = _time.strftime("%Y-%m-%dT%H:%M:%S", _time.gmtime(secs))
    if nanos:
        frac = f"{nanos:09d}".rstrip("0")
        return f"{base}.{frac}Z"
    return base + "Z"


def rfc3339_to_ns(text: str) -> int:
    """Parse RFC 3339, with optional fractional seconds and a numeric
    zone."""
    t = text.strip()
    offset = 0
    if t.endswith(("Z", "z")):
        body = t[:-1]
    else:
        body = t
        for i in range(len(t) - 1, 10, -1):
            if t[i] in "+-":
                body = t[:i]
                sign = -1 if t[i] == "-" else 1
                hh, mm = t[i + 1:].split(":")
                offset = sign * (int(hh) * 3600 + int(mm) * 60)
                break
    if "." in body:
        main, frac = body.split(".", 1)
        nanos = int((frac + "000000000")[:9])
    else:
        main, nanos = body, 0
    st = _time.strptime(main, "%Y-%m-%dT%H:%M:%S")
    return (calendar.timegm(st) - offset) * NS_PER_SECOND + nanos


# -- typed field readers (a wrong type is a decode error) --------------------

def _as_int(v: Any, default: int = 0) -> int:
    if v is None:
        return default
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise TypeError(f"expected number, got {type(v).__name__}")
    return int(v)


def _as_str(v: Any, default: str) -> str:
    if v is None:
        return default
    if not isinstance(v, str):
        raise TypeError(f"expected string, got {type(v).__name__}")
    return v


def _parse_ts(v: Any) -> int:
    if v is None:
        return 0
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    if isinstance(v, str):
        return rfc3339_to_ns(v)
    raise TypeError(f"timestamp: expected int or RFC3339 string, "
                    f"got {type(v).__name__}")


@dataclasses.dataclass
class Port:
    """One published port (service/service.go:25-30)."""

    type: str = "tcp"
    port: int = 0
    service_port: int = 0
    ip: str = ""

    def to_json(self) -> dict:
        return {"Type": self.type, "Port": self.port,
                "ServicePort": self.service_port, "IP": self.ip}

    @classmethod
    def from_json(cls, d: dict) -> "Port":
        return cls(type=_as_str(d.get("Type", "tcp"), "tcp"),
                   port=_as_int(d.get("Port")),
                   service_port=_as_int(d.get("ServicePort")),
                   ip=_as_str(d.get("IP", ""), ""))


@dataclasses.dataclass
class Service:
    """One service instance record (service/service.go:32-42)."""

    id: str = ""
    name: str = ""
    image: str = ""
    created: int = 0           # ns since epoch
    hostname: str = ""
    ports: list[Port] = dataclasses.field(default_factory=list)
    updated: int = 0           # ns since epoch — the LWW merge key
    proxy_mode: str = "http"
    status: int = UNKNOWN

    # -- predicates (service/service.go:50-72) -------------------------------

    def is_alive(self) -> bool:
        return self.status == ALIVE

    def is_tombstone(self) -> bool:
        return self.status == TOMBSTONE

    def is_draining(self) -> bool:
        return self.status == DRAINING

    def invalidates(self, other: Optional["Service"]) -> bool:
        """True when this record is strictly newer than ``other``."""
        return other is not None and self.updated > other.updated

    def is_stale(self, lifespan_s: float = TOMBSTONE_LIFESPAN,
                 now: Optional[int] = None) -> bool:
        """Older than ``lifespan_s`` plus the one-minute drift fudge."""
        now = now_ns() if now is None else now
        oldest = now - int((lifespan_s + STALENESS_FUDGE) * NS_PER_SECOND)
        return self.updated < oldest

    def tombstone(self, now: Optional[int] = None) -> None:
        self.status = TOMBSTONE
        self.updated = now_ns() if now is None else now

    # -- accessors -----------------------------------------------------------

    def status_string(self) -> str:
        return status_string(self.status)

    def version(self) -> str:
        """The image's tag, or the whole image when it has none."""
        parts = self.image.split(":")
        return parts[1] if len(parts) > 1 else parts[0]

    def port_for_service_port(self, find_port: int,
                              ptype: str = "tcp") -> int:
        """The published port mapped to ``find_port``; -1 when none."""
        for p in self.ports:
            if p.service_port == find_port and p.type == ptype:
                return p.port
        return -1

    def listener_name(self) -> str:
        return f"Service({self.name}-{self.id})"

    # -- wire form -----------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "ID": self.id,
            "Name": self.name,
            "Image": self.image,
            "Created": ns_to_rfc3339(self.created),
            "Hostname": self.hostname,
            "Ports": [p.to_json() for p in self.ports] or None,
            "Updated": ns_to_rfc3339(self.updated),
            "ProxyMode": self.proxy_mode,
            "Status": self.status,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Service":
        ports = d.get("Ports") or []
        if not isinstance(ports, list):
            raise TypeError("Ports: not a list")
        return cls(
            id=_as_str(d.get("ID", ""), ""),
            name=_as_str(d.get("Name", ""), ""),
            image=_as_str(d.get("Image", ""), ""),
            created=_parse_ts(d.get("Created")),
            hostname=_as_str(d.get("Hostname", ""), ""),
            ports=[Port.from_json(p) for p in ports],
            updated=_parse_ts(d.get("Updated")),
            proxy_mode=_as_str(d.get("ProxyMode", "http"), "http")
            or "http",
            status=_as_int(d.get("Status"), UNKNOWN),
        )

    def encode(self) -> bytes:
        return json.dumps(self.to_json(), separators=(",", ":")).encode()

    def copy(self) -> "Service":
        return dataclasses.replace(self, ports=[dataclasses.replace(p)
                                                for p in self.ports])


def decode(data: bytes | str) -> Service:
    """A record from its JSON wire form; any malformed payload raises
    ``ValueError`` (a wire boundary fed by untrusted peers: a leaked
    ``TypeError`` would end the caller's receive loop)."""
    try:
        d = json.loads(data)
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise ValueError(f"failed to decode service JSON: {exc}") from exc
    if not isinstance(d, dict):
        raise ValueError("failed to decode service JSON: not an object")
    try:
        return Service.from_json(d)
    except (TypeError, AttributeError, KeyError, OverflowError) as exc:
        raise ValueError(
            f"failed to decode service JSON: malformed shape ({exc})"
        ) from exc


def format_service(svc: Service, now: Optional[int] = None) -> str:
    """The record as one human-readable line (service/service.go:74-89)."""
    from sidecar_tpu_torch.output import time_ago

    now = now_ns() if now is None else now
    ports = ",".join(f"{p.service_port}->{p.port}" for p in svc.ports)
    return (f"      {svc.id} {svc.name:<30} {ports:<15} {svc.image:<45}  "
            f"{time_ago(svc.updated, now):<15} {svc.status_string():<9}\n")
