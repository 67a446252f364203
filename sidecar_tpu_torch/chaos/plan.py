"""The FaultPlan — the port's copy of ``sidecar_tpu/chaos/plan.py``:
one seeded, declarative description of every fault a chaos run injects
(``EdgeFault``, ``NodeFault``, ``HealthFault``, ``ClockFault``), with
its validation errors, its JSON form and the live path's :func:`coin`.

The port keeps its own copy so that it imports nothing of the JAX
package.  The classes, their checks and their serialisation are the
reference's, so a plan written by either package (``dumps``) loads in
the other (``loads``) and gives the same string back.

* **Deterministic.**  Every probabilistic decision derives from
  ``plan.seed`` plus stable coordinates (round index, edge, entry
  index).  The simulator (``chaos/sim_inject.py``) draws its fault
  masks from a ``torch.Generator`` seeded from ``(seed, round)``
  alone; the live path draws through :func:`coin`, a counter-based
  blake2b hash of the same seed.
* **Structured, not i.i.d.**  Per-EDGE schedules (source set ×
  destination set × round window), asymmetric partitions and
  correlated node windows.
* **Round-indexed.**  Windows are half-open ``[start_round,
  end_round)`` in gossip rounds.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import json
from typing import Iterable, Union

# "all" or an explicit tuple of node indices.  Tuples (not lists) so
# plans stay hashable.
NodeSel = Union[str, tuple]

FOREVER = 1 << 30


def _as_sel(nodes) -> NodeSel:
    if isinstance(nodes, str):
        if nodes != "all":
            raise ValueError(f"node selector string must be 'all', got "
                             f"{nodes!r}")
        return nodes
    return tuple(int(i) for i in nodes)


def resolve_nodes(sel: NodeSel, n: int) -> tuple:
    """Selector → concrete node-index tuple for an ``n``-node cluster."""
    if sel == "all":
        return tuple(range(n))
    bad = [i for i in sel if not 0 <= i < n]
    if bad:
        raise ValueError(f"node selector {bad} out of range for n={n}")
    return tuple(sel)


@dataclasses.dataclass(frozen=True)
class EdgeFault:
    """Per-edge message faults on the (src → dst) direction.

    ``drop_prob`` loses the packet entirely; ``delay_prob`` diverts it
    to arrive ``delay_rounds`` later; ``duplicate_prob`` delivers it now
    AND again after ``max(delay_rounds, 1)`` rounds.  A full partition
    in one direction is ``drop_prob=1.0``; an asymmetric 20% loss is
    ``drop_prob=0.2`` with src/dst covering one direction only.
    """

    src: NodeSel = "all"
    dst: NodeSel = "all"
    start_round: int = 0
    end_round: int = FOREVER
    drop_prob: float = 0.0
    delay_rounds: int = 0
    delay_prob: float = 0.0
    duplicate_prob: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "src", _as_sel(self.src))
        object.__setattr__(self, "dst", _as_sel(self.dst))
        for name in ("drop_prob", "delay_prob", "duplicate_prob"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} not in [0, 1]")
        if self.delay_rounds < 0:
            raise ValueError("delay_rounds must be >= 0")
        if self.delay_prob > 0.0 and self.delay_rounds == 0:
            raise ValueError("delay_prob > 0 requires delay_rounds >= 1")
        if self.start_round >= self.end_round:
            raise ValueError(
                f"empty window [{self.start_round}, {self.end_round})")

    @property
    def needs_ring(self) -> bool:
        """True when the sim must carry a delay ring for this entry."""
        return self.delay_prob > 0.0 or self.duplicate_prob > 0.0

    @property
    def ring_rounds(self) -> int:
        """Depth of the delay ring (duplicates without an explicit delay
        re-arrive the next round)."""
        return max(self.delay_rounds, 1)

    @property
    def full_cut(self) -> bool:
        """A deterministic total cut — severs TCP push-pull too (UDP
        loss below 1.0 does not: TCP rides retransmission)."""
        return self.drop_prob >= 1.0


@dataclasses.dataclass(frozen=True)
class NodeFault:
    """A correlated node window: ``pause`` (the process stalls — sends
    and accepts nothing, state retained) or ``crash`` (same, but at
    ``end_round`` the node restarts COLD: its belief row is wiped to a
    fresh re-announce of its own records — the rejoin workload)."""

    nodes: NodeSel
    start_round: int
    end_round: int
    kind: str = "pause"

    def __post_init__(self):
        object.__setattr__(self, "nodes", _as_sel(self.nodes))
        if self.kind not in ("pause", "crash"):
            raise ValueError(f"kind must be pause|crash, got {self.kind!r}")
        if self.start_round >= self.end_round:
            raise ValueError(
                f"empty window [{self.start_round}, {self.end_round})")


@dataclasses.dataclass(frozen=True)
class HealthFault:
    """Slow/failing health-check injection: checks whose id matches
    ``id_pattern`` (fnmatch) gain ``extra_latency_s`` of synthetic IO
    time inside the window; ``fail`` additionally makes them report
    UNKNOWN.  This is the workload that exposes check-pool starvation
    (the live health monitor's pool)."""

    id_pattern: str = "*"
    start_round: int = 0
    end_round: int = FOREVER
    extra_latency_s: float = 0.0
    fail: bool = False

    def matches(self, check_id: str) -> bool:
        return fnmatch.fnmatch(check_id, self.id_pattern)


@dataclasses.dataclass(frozen=True)
class ClockFault:
    """Per-node clock skew: inside ``[start_round, end_round)`` the
    selected nodes STAMP records with their own skewed clock — a static
    ``offset_ticks``, plus ``drift_ticks_per_round`` accumulating from
    the window start, plus an optional one-shot ``step_ticks`` jump
    from ``step_round`` on (an operator fat-fingering ``date``, a leap
    smear gone wrong).  Receivers keep judging admission and TTL expiry
    by their OWN clocks, so a rushing node (+offset) mints records the
    rest of the cluster sees as from the future — LWW poison the
    future-admission bound (ops/merge.future_mask) exists to reject —
    and a slow node (−offset) looks stale early, the false-positive
    tombstone workload.  Offsets of overlapping entries add.

    Drift is computed as ``floor(float32(drift) * float32(r - start))``
    — float32 multiply then floor — identically here, in the compiled
    plan's tensor form and in the reference, so they agree tick for
    tick.
    """

    nodes: NodeSel = "all"
    start_round: int = 0
    end_round: int = FOREVER
    offset_ticks: int = 0
    drift_ticks_per_round: float = 0.0
    step_ticks: int = 0
    step_round: int = 0

    def __post_init__(self):
        object.__setattr__(self, "nodes", _as_sel(self.nodes))
        if self.start_round < 0:
            raise ValueError(
                f"negative window start {self.start_round}")
        if self.start_round >= self.end_round:
            raise ValueError(
                f"empty window [{self.start_round}, {self.end_round})")
        if self.drift_ticks_per_round != 0.0 and \
                self.end_round >= FOREVER:
            raise ValueError(
                "drift requires a bounded window (end_round < FOREVER): "
                "unbounded drift overflows the int32 tick clock")

    def offset_at(self, round_idx: int) -> int:
        """This entry's skew (ticks) at a round — 0 outside the window.
        The NumPy form of the compiled offset math (float32
        multiply + floor, see class docstring)."""
        if not self.start_round <= round_idx < self.end_round:
            return 0
        import numpy as np
        off = self.offset_ticks
        if self.drift_ticks_per_round != 0.0:
            off += int(np.floor(
                np.float32(self.drift_ticks_per_round)
                * np.float32(round_idx - self.start_round)))
        if self.step_ticks and round_idx >= self.step_round:
            off += self.step_ticks
        return off

    @property
    def max_offset(self) -> int:
        """Largest positive skew this entry can inject over its window
        — the horizon-guard contribution
        (``models/timecfg.TimeConfig.validate_horizon``).
        The offset is monotone in |drift|, so the max over the window is
        attained at one of the candidate rounds checked here."""
        cands = [self.start_round, min(self.end_round, FOREVER) - 1]
        if self.step_ticks:
            # Each monotone piece of the offset attains its max at a
            # piece endpoint: the step boundary adds two candidates.
            cands += [max(self.step_round, self.start_round),
                      max(self.step_round - 1, self.start_round)]
        return max(0, max(self.offset_at(r) for r in cands
                          if r >= self.start_round))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The whole chaos schedule, rooted at one seed."""

    seed: int
    edges: tuple = ()
    nodes: tuple = ()
    health: tuple = ()
    clocks: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "edges", tuple(self.edges))
        object.__setattr__(self, "nodes", tuple(self.nodes))
        object.__setattr__(self, "health", tuple(self.health))
        object.__setattr__(self, "clocks", tuple(self.clocks))
        for e in self.edges:
            if not isinstance(e, EdgeFault):
                raise TypeError(f"edges entries must be EdgeFault, "
                                f"got {type(e).__name__}")
        for e in self.nodes:
            if not isinstance(e, NodeFault):
                raise TypeError(f"nodes entries must be NodeFault, "
                                f"got {type(e).__name__}")
        for e in self.health:
            if not isinstance(e, HealthFault):
                raise TypeError(f"health entries must be HealthFault, "
                                f"got {type(e).__name__}")
        for e in self.clocks:
            if not isinstance(e, ClockFault):
                raise TypeError(f"clocks entries must be ClockFault, "
                                f"got {type(e).__name__}")

    # -- builders ----------------------------------------------------------

    @staticmethod
    def partition(side_a: Iterable[int], side_b: Iterable[int],
                  start_round: int, end_round: int,
                  direction: str = "both",
                  loss_prob: float = 1.0) -> tuple:
        """Edge entries for a (possibly asymmetric, possibly lossy
        rather than total) partition between two node sets.

        ``direction``: ``both`` | ``a_to_b`` | ``b_to_a`` — which
        traffic direction is affected.  ``loss_prob < 1.0`` models a
        degraded link instead of a clean split.
        """
        a, b = tuple(side_a), tuple(side_b)
        if set(a) & set(b):
            raise ValueError("partition sides overlap")
        out = []
        if direction in ("both", "a_to_b"):
            out.append(EdgeFault(src=a, dst=b, start_round=start_round,
                                 end_round=end_round, drop_prob=loss_prob))
        if direction in ("both", "b_to_a"):
            out.append(EdgeFault(src=b, dst=a, start_round=start_round,
                                 end_round=end_round, drop_prob=loss_prob))
        if not out:
            raise ValueError(
                f"direction must be both|a_to_b|b_to_a, got {direction!r}")
        return tuple(out)

    def with_edges(self, *entries: EdgeFault) -> "FaultPlan":
        flat: list = []
        for e in entries:
            flat.extend(e) if isinstance(e, tuple) else flat.append(e)
        return dataclasses.replace(self, edges=self.edges + tuple(flat))

    # -- live-path helpers -------------------------------------------------

    def health_fault_at(self, check_id: str,
                        round_idx: int) -> tuple[float, bool]:
        """(extra latency seconds, fail?) for a check at a round —
        latencies of overlapping entries add, fail ORs."""
        delay, fail = 0.0, False
        for h in self.health:
            if h.start_round <= round_idx < h.end_round and \
                    h.matches(check_id):
                delay += h.extra_latency_s
                fail = fail or h.fail
        return delay, fail

    def node_down(self, node: int, round_idx: int) -> bool:
        for f in self.nodes:
            if f.start_round <= round_idx < f.end_round and \
                    (f.nodes == "all" or node in f.nodes):
                return True
        return False

    def clock_offset(self, node: int, round_idx: int) -> int:
        """Net clock skew (ticks) node ``node`` stamps with at a round
        — overlapping entries add (the live injector's shim and the
        NumPy oracle both read this)."""
        off = 0
        for f in self.clocks:
            if f.nodes == "all" or node in f.nodes:
                off += f.offset_at(round_idx)
        return off

    @property
    def max_clock_offset(self) -> int:
        """Largest positive skew any node can stamp with under this
        plan — folded into the packed-key overflow guard
        (models/timecfg.validate_horizon)."""
        return sum(f.max_offset for f in self.clocks)

    # -- serialization (reproduction recipes) -------------------------------

    def to_json(self) -> dict:
        def enc(entry):
            return dataclasses.asdict(entry)
        return {"seed": self.seed,
                "edges": [enc(e) for e in self.edges],
                "nodes": [enc(e) for e in self.nodes],
                "health": [enc(e) for e in self.health],
                "clocks": [enc(e) for e in self.clocks]}

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        return cls(seed=int(d["seed"]),
                   edges=tuple(EdgeFault(**e) for e in d.get("edges", [])),
                   nodes=tuple(NodeFault(**e) for e in d.get("nodes", [])),
                   health=tuple(HealthFault(**e)
                                for e in d.get("health", [])),
                   clocks=tuple(ClockFault(**e)
                                for e in d.get("clocks", [])))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "FaultPlan":
        return cls.from_json(json.loads(s))


def coin(seed: int, *coords) -> float:
    """The live path's deterministic uniform draw in [0, 1): a blake2b
    hash of (seed, coords).  Stable across processes and platforms, so
    a live chaos run's fault schedule is a pure function of the plan
    seed and the decision coordinates (edge, per-edge counter)."""
    payload = repr((int(seed),) + tuple(coords)).encode()
    h = hashlib.blake2b(payload, digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)
