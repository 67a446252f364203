"""The AdversaryPlan — the port's copy of
``sidecar_tpu/chaos/adversary.py``: declarative Byzantine-peer attack
programs beside :mod:`sidecar_tpu_torch.chaos.plan`'s honest-fault
FaultPlan, and their compiled form, :class:`CompiledAdversaryPlan`.

A FaultPlan breaks the transport; an AdversaryPlan breaks the content:
selected nodes LIE in the records they gossip.  Each :class:`Attack`
names who lies (``nodes``), about whom (``victims``), when (a half-open
``[start_round, end_round)`` window), how much of each packet
(``rate`` of the message budget) and how (``kind``):

* ``tombstone_bomb`` — forged TOMBSTONE records for the victims' slots
  at the attacker's current tick;
* ``future_flood`` — forged ALIVE records ``magnitude_ticks`` in the
  future (beyond any admission fudge);
* ``sybil_flood`` — the same flood within a small magnitude, caught
  only by the per-origin budget;
* ``past_flood`` / ``replay`` — old-stamped ALIVE floods;
* ``flap`` — the attacker oscillates its OWN records ALIVE/DRAINING
  with fresh stamps every round.

Every kind is PRNG-free: an attack corrupts the first ``floor(rate ·
budget)`` columns (at least one) of an attacker's packet and picks
victim slots by rotation (``(round · ncorrupt + col) % V``), so the
tensor form (:meth:`CompiledAdversaryPlan.corrupt`) and the NumPy form
(:meth:`CompiledAdversaryPlan.host_overrides`) agree exactly, with each
other and with the reference.  Overlapping windows of the same kind on
the same attacker are a validation error.  Future-stamped forgeries
count toward the packed-key horizon guard (``max_future_ticks``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from sidecar_tpu_torch.chaos.plan import (
    FOREVER,
    NodeSel,
    _as_sel,
    resolve_nodes,
)
from sidecar_tpu_torch.models.common import resolve_device
from sidecar_tpu_torch.ops import status as svc_status

ATTACK_KINDS = ("tombstone_bomb", "future_flood", "sybil_flood",
                "past_flood", "replay", "flap")

# Kinds whose forged timestamps sit magnitude_ticks in the future and
# therefore contribute to the packed-key horizon guard.
_FUTURE_KINDS = ("future_flood", "sybil_flood")
# Kinds that need a nonzero timestamp displacement to mean anything.
_NEEDS_MAGNITUDE = ("future_flood", "sybil_flood", "past_flood", "replay")


@dataclasses.dataclass(frozen=True)
class Attack:
    """One attack program: WHO lies about WHOM, WHEN, HOW, and HOW MUCH.

    ``rate`` is the corrupted fraction of the per-packet message budget
    — ``floor(rate * budget)`` columns of every packet the attacker
    sends inside the window carry forged records instead of (or on top
    of) its honest payload.  ``magnitude_ticks`` is the forged-stamp
    displacement for the flood kinds (future for ``future_flood`` /
    ``sybil_flood``, past for ``past_flood`` / ``replay``); it is
    ignored by ``tombstone_bomb`` and ``flap``, which stamp at the
    attacker's current tick.
    """

    kind: str
    nodes: NodeSel
    victims: NodeSel = "all"
    start_round: int = 0
    end_round: int = FOREVER
    rate: float = 1.0
    magnitude_ticks: int = 0

    def __post_init__(self):
        if self.kind not in ATTACK_KINDS:
            raise ValueError(
                f"unknown attack kind {self.kind!r} (expected one of "
                f"{', '.join(ATTACK_KINDS)})")
        object.__setattr__(self, "nodes", _as_sel(self.nodes))
        object.__setattr__(self, "victims", _as_sel(self.victims))
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"rate={self.rate} not in (0, 1]")
        if self.start_round < 0:
            raise ValueError(f"negative window start {self.start_round}")
        if self.start_round >= self.end_round:
            raise ValueError(
                f"empty window [{self.start_round}, {self.end_round})")
        if self.magnitude_ticks < 0:
            raise ValueError(
                f"magnitude_ticks must be >= 0, got {self.magnitude_ticks}")
        if self.kind in _NEEDS_MAGNITUDE and self.magnitude_ticks == 0:
            raise ValueError(
                f"{self.kind} requires magnitude_ticks >= 1")

    @property
    def max_future_ticks(self) -> int:
        """Largest future displacement this entry can stamp — the
        horizon-guard contribution
        (``models/timecfg.TimeConfig.validate_horizon``)."""
        return self.magnitude_ticks if self.kind in _FUTURE_KINDS else 0

    def active_at(self, round_idx: int) -> bool:
        return self.start_round <= round_idx < self.end_round


def _overlap(a: Attack, b: Attack) -> bool:
    if a.kind != b.kind:
        return False
    if a.start_round >= b.end_round or b.start_round >= a.end_round:
        return False
    sa = "all" if a.nodes == "all" else set(a.nodes)
    sb = "all" if b.nodes == "all" else set(b.nodes)
    if sa == "all" or sb == "all":
        return True
    return bool(sa & sb)


@dataclasses.dataclass(frozen=True)
class AdversaryPlan:
    """The whole Byzantine schedule, rooted at one seed.

    The seed exists for schema parity with FaultPlan (one reproduction
    recipe names both plans) and for future randomized attack kinds;
    every current kind is deliberately PRNG-free (module docstring).
    """

    seed: int
    attacks: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "attacks", tuple(self.attacks))
        for a in self.attacks:
            if not isinstance(a, Attack):
                raise TypeError(f"attacks entries must be Attack, "
                                f"got {type(a).__name__}")
        for i, a in enumerate(self.attacks):
            for b in self.attacks[i + 1:]:
                if _overlap(a, b):
                    raise ValueError(
                        f"overlapping {a.kind} windows "
                        f"[{a.start_round}, {a.end_round}) and "
                        f"[{b.start_round}, {b.end_round}) on shared "
                        f"attacker(s)")

    @property
    def max_future_ticks(self) -> int:
        """Largest future stamp any attacker can mint — folded into the
        packed-key overflow guard beside the plan's clock skew."""
        return max((a.max_future_ticks for a in self.attacks), default=0)

    def attackers(self, n: int) -> tuple:
        """Sorted union of every entry's attacker set for an ``n``-node
        cluster (the live injector's roster and the quarantine tests'
        expected origin set)."""
        out: set = set()
        for a in self.attacks:
            out.update(resolve_nodes(a.nodes, n))
        return tuple(sorted(out))

    def active_attackers(self, n: int, round_idx: int) -> tuple:
        out: set = set()
        for a in self.attacks:
            if a.active_at(round_idx):
                out.update(resolve_nodes(a.nodes, n))
        return tuple(sorted(out))

    # -- serialization (reproduction recipes) -------------------------------

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "attacks": [dataclasses.asdict(a) for a in self.attacks]}

    @classmethod
    def from_json(cls, d: dict) -> "AdversaryPlan":
        return cls(seed=int(d["seed"]),
                   attacks=tuple(Attack(**a) for a in d.get("attacks", [])))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "AdversaryPlan":
        return cls.from_json(json.loads(s))


@dataclasses.dataclass(frozen=True)
class _CompiledAttack:
    """One attack resolved against a concrete cluster: its window, its
    corrupted width, and the attacker mask and slot table as numpy
    arrays (the host form) and device tensors (the tensor form)."""

    kind: str
    start_round: int
    end_round: int
    ncorrupt: int             # corrupted columns per packet
    magnitude_ticks: int
    attacker_mask: np.ndarray  # bool [n]
    slots: np.ndarray          # int64 [V] victim slots, or [n, S] own
                               # slots (flap)
    attacker_mask_t: torch.Tensor  # the same, on the sim's device
    slots_t: torch.Tensor          # int64

    def active_at(self, round_idx: int) -> bool:
        return self.start_round <= round_idx < self.end_round


class CompiledAdversaryPlan:
    """An AdversaryPlan resolved against one cluster shape.

    :meth:`corrupt` is the tensor path (called between
    ``select_messages`` and ``record_transmissions`` in the chaos
    round); :meth:`host_overrides` is the NumPy form of the SAME
    formulas.  Both are pure functions of (round, per-node now).  The
    attacker masks and slot tables are built once, on ``device`` (the
    card unless the caller asks for the CPU), after the plan has been
    checked against the cluster."""

    def __init__(self, plan: AdversaryPlan, *, n: int, owner,
                 budget: int, device="cuda"):
        self.plan = plan
        self.n = int(n)
        self.budget = int(budget)
        if isinstance(owner, torch.Tensor):
            owner = owner.cpu().numpy()
        owner = np.asarray(owner, np.int64)
        tables = []
        for a in plan.attacks:
            attackers = resolve_nodes(a.nodes, n)
            amask = np.zeros(n, bool)
            amask[list(attackers)] = True
            ncorrupt = int(np.floor(a.rate * budget))
            if ncorrupt == 0:
                ncorrupt = 1  # rate > 0 always corrupts at least a column
            if a.kind == "flap":
                widths = np.bincount(owner, minlength=n)[:n]
                if len(set(widths.tolist())) != 1:
                    raise ValueError(
                        "flap attack requires a uniform services-per-node "
                        f"layout, got widths {sorted(set(widths.tolist()))}")
                slots = np.argsort(owner, kind="stable").reshape(n, -1)
            else:
                victims = resolve_nodes(a.victims, n)
                vmask = np.isin(owner, np.asarray(victims, np.int64))
                slots = np.where(vmask)[0]
                if not slots.size:
                    raise ValueError(
                        f"{a.kind} attack has no victim-owned slots "
                        f"(victims={a.victims!r})")
            tables.append((a, ncorrupt, amask, slots.astype(np.int64)))
        dev = self.device = resolve_device(device, "CompiledAdversaryPlan")
        self._entries = tuple(
            _CompiledAttack(
                kind=a.kind, start_round=a.start_round,
                end_round=a.end_round, ncorrupt=ncorrupt,
                magnitude_ticks=a.magnitude_ticks, attacker_mask=amask,
                slots=slots, attacker_mask_t=torch.as_tensor(amask,
                                                             device=dev),
                slots_t=torch.as_tensor(slots, device=dev))
            for a, ncorrupt, amask, slots in tables)

    def active_at(self, round_idx: int) -> bool:
        """Whether any attack forges in round ``round_idx`` (a host
        int)."""
        return any(e.active_at(round_idx) for e in self._entries)

    # -- tensor path --------------------------------------------------------

    def corrupt(self, round_idx: int, now_n, svc_idx, msg):
        """Overwrite the leading ``ncorrupt`` columns of every active
        attacker's packet with forged records.

        ``round_idx`` is the round (a host int), ``now_n`` the int32
        ``[n]`` per-node stamping clock (ClockFault offsets applied —
        liars lie relative to their OWN clocks), ``svc_idx``/``msg``
        the int32 ``[n, budget]`` packet from ``select_messages``.
        Returns ``(svc_idx, msg, nforged)``, ``nforged`` the int32
        device scalar count of forged columns this round (the
        ``adversary.sim.forgedRecords`` accounting).  Forged columns
        replace honest payload AND padding.  No host read."""
        dev = msg.device
        nforged = torch.zeros((), dtype=torch.int32, device=dev)
        active = [e for e in self._entries if e.active_at(round_idx)]
        if not active:
            return svc_idx, msg, nforged
        i32 = torch.int32
        now_col = now_n.to(i32)[:, None]
        col = torch.arange(self.budget, dtype=torch.int64, device=dev)
        any_mask = torch.zeros((self.n, self.budget), dtype=torch.bool,
                               device=dev)
        for e in active:
            amask = e.attacker_mask_t[:, None] & (col < e.ncorrupt)[None, :]
            if e.kind == "flap":
                own = e.slots_t
                slots = own[:, (round_idx + col) % own.shape[1]]
                stat = (svc_status.ALIVE if round_idx % 2 == 0
                        else svc_status.DRAINING)
                val = svc_status.pack(torch.clamp(now_col, min=1), stat)
            else:
                vslots = e.slots_t
                idx = (round_idx * e.ncorrupt + col) % vslots.shape[0]
                slots = vslots[idx][None, :].expand(self.n, self.budget)
                if e.kind == "tombstone_bomb":
                    ts = torch.clamp(now_col, min=1)
                    stat = svc_status.TOMBSTONE
                elif e.kind in _FUTURE_KINDS:
                    ts = now_col + e.magnitude_ticks
                    stat = svc_status.ALIVE
                else:  # past_flood / replay
                    ts = torch.clamp(now_col - e.magnitude_ticks, min=1)
                    stat = svc_status.ALIVE
                val = svc_status.pack(ts, stat)
            svc_idx = torch.where(amask, slots.to(i32), svc_idx)
            msg = torch.where(amask, val, msg)
            any_mask |= amask
        return svc_idx, msg, any_mask.sum(dtype=i32)

    # -- host mirror (NumPy) ------------------------------------------------

    def host_overrides(self, round_idx: int, now_n):
        """The NumPy form of :meth:`corrupt`'s formulas: returns
        ``(mask, slots, vals)``, each ``[n, budget]``, where ``mask``
        is True on forged columns."""
        mask = np.zeros((self.n, self.budget), bool)
        slots = np.zeros((self.n, self.budget), np.int64)
        vals = np.zeros((self.n, self.budget), np.int64)
        if not self._entries:
            return mask, slots, vals
        now_n = np.asarray(now_n, np.int64)
        col = np.arange(self.budget)
        bits = svc_status.STATUS_BITS
        for e in self._entries:
            if not e.active_at(round_idx):
                continue
            amask = e.attacker_mask[:, None] & (col < e.ncorrupt)[None, :]
            if e.kind == "flap":
                own = e.slots
                s = own.shape[1]
                eslots = own[:, (round_idx + col) % s]
                stat = (svc_status.ALIVE if round_idx % 2 == 0
                        else svc_status.DRAINING)
                ets = np.maximum(now_n, 1)[:, None]
                ets = np.broadcast_to(ets, (self.n, self.budget))
            else:
                vslots = e.slots
                idx = (round_idx * e.ncorrupt + col) % vslots.shape[0]
                eslots = np.broadcast_to(vslots[idx][None, :],
                                         (self.n, self.budget))
                if e.kind == "tombstone_bomb":
                    ets = np.maximum(now_n, 1)[:, None]
                    stat = svc_status.TOMBSTONE
                elif e.kind in _FUTURE_KINDS:
                    ets = now_n[:, None] + e.magnitude_ticks
                    stat = svc_status.ALIVE
                else:
                    ets = np.maximum(now_n[:, None] - e.magnitude_ticks, 1)
                    stat = svc_status.ALIVE
                ets = np.broadcast_to(ets, (self.n, self.budget))
            evals = (ets.astype(np.int64) << bits) | stat
            mask = np.where(amask, True, mask)
            slots = np.where(amask, eslots, slots)
            vals = np.where(amask, evals, vals)
        return mask, slots, vals
