"""The service record and its wire form — the port's own copy of what
the simulator bridge reads from ``sidecar_tpu/service.py``: the status
codes and their names (:func:`status_string`), the RFC 3339 nanosecond
timestamps of the Go wire format, and :class:`Port` and
:class:`Service` with their JSON forms.

Timestamps are integer nanoseconds since the Unix epoch: the protocol
relies on nanosecond resolution, which ``datetime`` would lose.  The
record's lifecycle predicates, its own ``decode`` and the Docker and
formatting helpers of the reference belong to the live node's writer
and discovery planes and are not here.
"""

from __future__ import annotations

import calendar
import dataclasses
import time as _time
from typing import Any

# Status codes (service/service.go:17-23); SUSPECT is the simulator's
# quarantine-before-tombstone code, which the live catalog never makes.
ALIVE = 0
TOMBSTONE = 1
UNHEALTHY = 2
UNKNOWN = 3
DRAINING = 4
SUSPECT = 5

NS_PER_SECOND = 1_000_000_000


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
