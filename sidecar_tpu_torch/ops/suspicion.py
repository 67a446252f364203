"""The suspicion and flap-damping subprotocol's shared pieces — the port
of ``sidecar_tpu/ops/suspicion.py``: the Lifeguard self-refutation at an
announce site (:func:`announce_refute`), the knob bundle the simulator
and the live catalog both read (:class:`ProtocolParams`), and the
host-side per-origin misbehaviour score (:class:`QuarantineScorer`).

The device half of suspicion is the TTL sweep's SUSPECT re-pack
(``ops/ttl.py``) and the refutation below; the host half is the flap
damper (``catalog/damping.py``).  ``SimBridge.simulate`` takes a
:class:`ProtocolParams` (or its dict form, the ``POST /simulate``
surface) per request."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sidecar_tpu_torch.ops.status import ALIVE, SUSPECT


def announce_refute(due, st, present, suspicion):
    """Fold the self-refutation into an announce: with ``suspicion``
    (a Python bool, or the fleet's per-row bool tensor), an owner whose
    own record is SUSPECT announces immediately, as ALIVE.  Returns
    ``(due, st)``."""
    if not isinstance(suspicion, torch.Tensor) and not suspicion:
        return due, st
    refute = present & (st == SUSPECT)
    if isinstance(suspicion, torch.Tensor):
        refute = refute & suspicion
    return due | refute, torch.where(refute, ALIVE, st)


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    """The suspicion/damping knob bundle shared by sim and live.

    The defaults are the disabled subprotocol: ``suspicion_window_s ==
    0`` keeps every simulated round equal to the pre-suspicion one, and
    ``damping_threshold == 0`` never suppresses a service.  Negative
    ``future_fudge_s``, ``origin_budget`` and ``origin_quarantine`` turn
    those defences off."""

    suspicion_window_s: float = 0.0   # SWIM quarantine window (0 = off)
    damping_half_life_s: float = 60.0  # penalty exponential-decay half-life
    damping_threshold: float = 0.0    # suppress at penalty ≥ this (0 = off)
    damping_reuse_threshold: float = 0.0  # readmit below this
                                      # (0 = auto: threshold / 2)
    damping_flap_penalty: float = 1.0  # penalty added per observed flap
    future_fudge_s: float = -1.0      # future-admission bound
                                      # (negative = off; ops/merge)
    origin_budget: int = -1           # suspicious records a packet may
                                      # carry (negative = off)
    origin_quarantine: int = -1       # violations that quarantine an
                                      # origin (negative = off)

    def __post_init__(self):
        if self.suspicion_window_s < 0:
            raise ValueError("suspicion_window_s must be >= 0")
        if self.damping_half_life_s <= 0:
            raise ValueError("damping_half_life_s must be > 0")
        if self.damping_threshold < 0:
            raise ValueError("damping_threshold must be >= 0")
        if self.damping_reuse_threshold > self.damping_threshold:
            raise ValueError(
                "damping_reuse_threshold cannot exceed damping_threshold")

    @property
    def resolved_reuse_threshold(self) -> float:
        """The readmission floor: the explicit one, else half the
        suppress threshold (the hysteresis band)."""
        if self.damping_reuse_threshold > 0:
            return self.damping_reuse_threshold
        return self.damping_threshold / 2.0

    def timecfg(self, base):
        """``base`` (a ``TimeConfig``) with this bundle's suspicion
        window, future bound and origin defences applied."""
        return dataclasses.replace(
            base, suspicion_window_s=self.suspicion_window_s,
            future_fudge_s=self.future_fudge_s,
            origin_budget=self.origin_budget,
            origin_quarantine=self.origin_quarantine)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Optional[dict]) -> "ProtocolParams":
        """From a request dict; unknown keys raise (a typoed knob must
        not silently run the defaults).  Integer fields are read as
        ints, the rest as floats."""
        if not d:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(
                f"unknown protocol param(s): {sorted(bad)} "
                f"(expected a subset of {sorted(known)})")
        ints = {f.name for f in dataclasses.fields(cls) if f.type == "int"}
        return cls(**{k: (int(v) if k in ints else float(v))
                      for k, v in d.items()})

    @classmethod
    def from_config(cls, sidecar_cfg) -> "ProtocolParams":
        """From any object with the live node's configuration names:
        ``suspicion_window``, ``damping_half_life``,
        ``damping_threshold``, ``future_fudge``, ``origin_budget`` and
        ``origin_quarantine``."""
        return cls(
            suspicion_window_s=sidecar_cfg.suspicion_window,
            damping_half_life_s=sidecar_cfg.damping_half_life,
            damping_threshold=sidecar_cfg.damping_threshold,
            future_fudge_s=sidecar_cfg.future_fudge,
            origin_budget=sidecar_cfg.origin_budget,
            origin_quarantine=sidecar_cfg.origin_quarantine,
        )


class QuarantineScorer:
    """Host-side misbehaviour score, the live twin of the simulator's
    per-origin violation counter.

    One push from one origin is one packet: the scorer counts its fresh
    third-party claims — records the sender does not own stamped at or
    beyond the receiver's clock — and charges one violation per claim
    beyond ``origin_budget``.  An origin whose count reaches
    ``origin_quarantine`` is quarantined.  With either knob negative
    the scorer scores nothing and quarantines no one."""

    def __init__(self, params: ProtocolParams):
        self.budget = int(params.origin_budget)
        self.threshold = int(params.origin_quarantine)
        self.violations: dict = {}

    @property
    def enabled(self) -> bool:
        return self.budget >= 0 and self.threshold >= 0

    def observe(self, origin: str, claims, now) -> int:
        """Score one push.  ``claims`` holds one ``(owned, timestamp)``
        pair a record, ``owned`` True when the origin (the transport
        sender) owns it; timestamps share ``now``'s units.  Returns the
        violations charged to ``origin``."""
        if not self.enabled:
            return 0
        suspicious = sum(1 for owned, ts in claims
                         if (not owned) and ts >= now)
        over = max(0, suspicious - self.budget)
        if over:
            self.violations[origin] = self.violations.get(origin, 0) + over
        return over

    def is_quarantined(self, origin: str) -> bool:
        return (self.enabled and
                self.violations.get(origin, 0) >= self.threshold)

    def quarantined(self) -> set:
        """The quarantined origins."""
        if not self.enabled:
            return set()
        return {o for o, v in self.violations.items()
                if v >= self.threshold}
