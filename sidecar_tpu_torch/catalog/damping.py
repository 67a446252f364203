"""Flap damping — the port of ``sidecar_tpu/catalog/damping.py``: a
per-service-instance penalty with exponential decay that gates proxy
admission for services that keep flapping (the BGP route-flap-damping
shape, RFC 2439 recast).

* every observed liveness flap (ALIVE ↔ not-ALIVE) adds
  ``flap_penalty`` to the instance's penalty;
* the penalty decays continuously with half-life ``half_life_s``;
* an instance whose penalty reaches ``threshold`` is suppressed, and
  reinstated once it decays below ``reuse_threshold`` (by default half
  the threshold: the hysteresis band).

``threshold == 0`` suppresses nothing (flaps are still counted).  The
bridge's damping prediction (``SimBridge._predict_damping``) replays a
simulated change stream through :class:`TransitionReplay` into a
:class:`FlapDamper` on a logical clock.  The arithmetic is Python
floats in the reference's order, so one stream gives the same decisions
in both packages.

Metrics (the port's registry): ``damping.flaps``, ``damping.suppressed``
and ``damping.reinstated`` counters, the ``damping.damped_services``
gauge.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.service import ALIVE, SUSPECT, UNKNOWN

# Entries whose penalty decayed below this are dropped at the next
# observation: the table holds the flapping population, not the catalog.
_GC_FLOOR = 0.01

NS_PER_SECOND = 1_000_000_000


class _SimRecord:
    """The record a simulated transition stands for (no live
    ``Service`` behind it)."""

    __slots__ = ("hostname", "id", "status")

    def __init__(self, hostname: str, sid: str, status: int) -> None:
        self.hostname = hostname
        self.id = sid
        self.status = status


class TransitionReplay:
    """Simulated status observations replayed through a damper under the
    live writer path's rules:

    * SUSPECT is quarantine, not routing-visible liveness: it neither
      flaps nor updates the tracked status;
    * the first sight of a record is discovery, not a flap;
    * only liveness changes (ALIVE ↔ not-ALIVE) flap, as
      :meth:`FlapDamper.observe` counts them."""

    def __init__(self, damper: "FlapDamper") -> None:
        self.damper = damper
        self._last: dict[str, int] = {}
        self.flaps: dict[str, int] = {}

    def prime(self, sid: str, status: int) -> None:
        """Seed the tracked status from the initial catalog view."""
        self._last[sid] = status

    def see(self, hostname: str, sid: str, status: int,
            now_ns: int) -> None:
        """One observed (service, status) sample of the stream."""
        if status == SUSPECT or status < 0:
            return
        prev = self._last.get(sid)
        self._last[sid] = status
        if prev is None or prev == status:
            return
        if (prev == ALIVE) != (status == ALIVE):
            self.flaps[sid] = self.flaps.get(sid, 0) + 1
        self.damper.observe(_SimRecord(hostname, sid, status), prev,
                            now_ns=now_ns)


class FlapDamper:
    """Per-instance flap penalty with exponential decay and
    suppress/reuse hysteresis; thread-safe."""

    def __init__(self, half_life_s: float = 60.0,
                 threshold: float = 0.0,
                 reuse_threshold: float = 0.0,
                 flap_penalty: float = 1.0,
                 now_fn: Optional[Callable[[], int]] = None) -> None:
        if half_life_s <= 0:
            raise ValueError("half_life_s must be > 0")
        if reuse_threshold > threshold:
            raise ValueError("reuse_threshold cannot exceed threshold")
        self.half_life_s = half_life_s
        self.threshold = threshold
        self.reuse_threshold = reuse_threshold if reuse_threshold > 0 \
            else threshold / 2.0
        self.flap_penalty = flap_penalty
        # The clock (ns): wall time unless the caller drives a logical one.
        self._now = now_fn if now_fn is not None else time.time_ns
        self._lock = threading.Lock()
        # key → [penalty, last_ns, suppressed]
        self._entries: dict[tuple[str, str], list] = {}

    @classmethod
    def from_protocol(cls, params,
                      now_fn: Optional[Callable[[], int]] = None
                      ) -> "FlapDamper":
        """From an ``ops.suspicion.ProtocolParams`` bundle."""
        return cls(half_life_s=params.damping_half_life_s,
                   threshold=params.damping_threshold,
                   reuse_threshold=params.resolved_reuse_threshold
                   if params.damping_threshold > 0 else 0.0,
                   flap_penalty=params.damping_flap_penalty,
                   now_fn=now_fn)

    @staticmethod
    def key_of(svc) -> tuple[str, str]:
        return (svc.hostname, svc.id)

    def _decayed(self, entry: list, now_ns: int) -> float:
        penalty, last_ns, _ = entry
        dt_s = max(0, now_ns - last_ns) / NS_PER_SECOND
        return penalty * math.exp(-math.log(2.0) * dt_s / self.half_life_s)

    def _update_suppression(self, entry: list, penalty: float) -> None:
        suppressed = entry[2]
        if not suppressed and self.threshold > 0 \
                and penalty >= self.threshold:
            entry[2] = True
            metrics.incr("damping.suppressed")
        elif suppressed and penalty < self.reuse_threshold:
            entry[2] = False
            metrics.incr("damping.reinstated")

    def _gauge(self) -> None:
        metrics.set_gauge("damping.damped_services",
                          sum(1 for e in self._entries.values() if e[2]))

    def observe(self, svc, previous_status: int,
                now_ns: Optional[int] = None) -> None:
        """Record one status transition.  A flap is a liveness change on
        a record seen before (previous UNKNOWN is discovery)."""
        if previous_status == UNKNOWN:
            return
        if (previous_status == ALIVE) == (svc.status == ALIVE):
            return
        now = now_ns if now_ns is not None else self._now()
        key = self.key_of(svc)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = [0.0, now, False]
                self._entries[key] = entry
            penalty = self._decayed(entry, now) + self.flap_penalty
            entry[0], entry[1] = penalty, now
            metrics.incr("damping.flaps")
            self._update_suppression(entry, penalty)
            self._gc(now)
            self._gauge()

    def _gc(self, now_ns: int) -> None:
        dead = [k for k, e in self._entries.items()
                if not e[2] and self._decayed(e, now_ns) < _GC_FLOOR]
        for k in dead:
            del self._entries[k]

    def suppressed(self, key: tuple[str, str],
                   now_ns: Optional[int] = None) -> bool:
        """Whether the instance is damped now; the decayed penalty is
        re-checked, so a quiet service readmits by time alone."""
        if self.threshold <= 0:
            return False
        now = now_ns if now_ns is not None else self._now()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            self._update_suppression(entry, self._decayed(entry, now))
            result = entry[2]
            self._gauge()
            return result

    def admitted(self, svc, now_ns: Optional[int] = None) -> bool:
        """The proxy-admission gate: False while the instance is
        damped."""
        return not self.suppressed(self.key_of(svc), now_ns)

    def penalty(self, key: tuple[str, str],
                now_ns: Optional[int] = None) -> float:
        now = now_ns if now_ns is not None else self._now()
        with self._lock:
            entry = self._entries.get(key)
            return 0.0 if entry is None else self._decayed(entry, now)

    def damped(self, now_ns: Optional[int] = None) -> set[tuple[str, str]]:
        """The suppressed instances, hysteresis applied at read time."""
        if self.threshold <= 0:
            return set()
        now = now_ns if now_ns is not None else self._now()
        with self._lock:
            for entry in self._entries.values():
                self._update_suppression(entry, self._decayed(entry, now))
            self._gauge()
            return {k for k, e in self._entries.items() if e[2]}

    def snapshot(self, now_ns: Optional[int] = None) -> dict:
        """The JSON view: knobs and each entry's penalty and state."""
        now = now_ns if now_ns is not None else self._now()
        with self._lock:
            return {
                "half_life_s": self.half_life_s,
                "threshold": self.threshold,
                "reuse_threshold": self.reuse_threshold,
                "entries": {
                    f"{host}/{sid}": {
                        "penalty": round(self._decayed(e, now), 4),
                        "suppressed": bool(e[2]),
                    }
                    for (host, sid), e in sorted(self._entries.items())
                },
            }
