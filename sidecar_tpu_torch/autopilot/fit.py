"""Condition fitting: telemetry → a simulable estimate — the port of
``sidecar_tpu/autopilot/fit.py``, over the port's flight-recorder rows
(``ops/trace.trace_to_dicts``), ``ChaosExactSim.injection_counts`` and
metrics registry.

The autopilot's first move is to answer "what is the cluster living
through RIGHT NOW?" in the simulator's vocabulary — a
:class:`ConditionEstimate` whose pieces map exactly onto the fleet
plane's inputs:

* ``loss_rate`` / ``churn_rate`` land on DATA axes
  (``ScenarioSpec.drop_prob`` / ``churn_prob`` — they vmap freely, so
  every search candidate carries the fitted environment at zero extra
  compile cost);
* ``paused_frac`` is STRUCTURE — it becomes a ``FaultPlan`` pause
  window (:meth:`ConditionEstimate.fault_plan`), shared by the whole
  batch the way the fleet shares compile keys.

Two adapters produce an estimate:

* :func:`fit_from_trace` — the rigorous path: flight-recorder round
  records (ops/trace.py, the same stream ``POST /simulate`` returns
  and tests replay through ``ChaosExactSim.run_with_trace``) plus the
  chaos injection counters.  The estimators invert the trace model:

  - **loss**: the chaos plane drops non-empty packets; the frontier
    census says how many non-empty packets were offered
    (``frontier × fanout`` per round), so
    ``loss = dropped / Σ frontier·fanout``.
  - **churn**: each ALIVE→TOMBSTONE restart of a live-owned slot
    spreads ≈ one false-positive tombstone ENTRY per cluster node
    (ops/trace.fp_tombstone_entries counts the transition at every
    believer), and restart churn tombstones half its flips, so
    ``churn ≈ 2 · fp_tombstones_total / (n · m · rounds)``.
  - **pause**: a node paused from the start of the horizon never
    learns the other ``m − spn`` slots and never teaches its own
    ``spn``, so once the up-cluster settles the behind census floor is
    ``spn · p · (2n − 1 − p)`` for ``p`` paused nodes — invert the
    quadratic on the min of the last few recorded rounds.  (A pause
    that starts AFTER convergence leaves no backlog floor and fits as
    ≈ 0 — the estimate reads standing degradation, not history.)

* :func:`fit_live` — the best-effort live path: the process metrics
  registry (engine UDP relay gauges, ``damping.flaps``,
  ``coherence.agreement``).  Live signals lack a round base, so churn
  needs an explicit observation ``window_rounds``; anything the
  registry can't support stays 0 and the raw inputs are preserved in
  ``signals`` — an unfittable parameter never silently pretends to be
  a fitted one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Behind-census tail window: the pause estimator reads the MIN over the
# last few recorded rounds so a transient backlog (churn in flight, a
# late frontier) doesn't read as standing paused-node degradation.
TAIL_ROUNDS = 5


@dataclasses.dataclass(frozen=True)
class ConditionEstimate:
    """Current cluster conditions, in the simulator's vocabulary."""

    n: int                       # cluster size the estimate describes
    services_per_node: int
    loss_rate: float = 0.0       # fraction of non-empty packets lost
    churn_rate: float = 0.0      # per-round per-slot restart probability
    paused_frac: float = 0.0     # fraction of nodes stalled (state kept)
    seconds_per_round: Optional[float] = None   # the protocol clock
    source: str = "trace"        # "trace" | "live"
    signals: dict = dataclasses.field(default_factory=dict)

    @property
    def m(self) -> int:
        return self.n * self.services_per_node

    def base_fields(self) -> dict:
        """The estimate's DATA-axis half: ``ScenarioSpec`` base fields
        every search candidate inherits (negligible rates are omitted —
        a 1e-7 drop_prob would only perturb the PRNG stream)."""
        out: dict = {}
        if self.loss_rate > 1e-4:
            out["drop_prob"] = round(min(self.loss_rate, 0.9), 4)
        if self.churn_rate > 1e-6:
            out["churn_prob"] = round(min(self.churn_rate, 1.0), 6)
        return out

    def fault_plan(self, seed: int = 0, start_round: int = 1,
                   end_round: Optional[int] = None):
        """The estimate's STRUCTURAL half: a ``FaultPlan`` pausing
        ``round(paused_frac · n)`` nodes over the window, or None when
        no nodes appear stalled (an empty plan would still force the
        chaos scan path onto every candidate).  Which specific nodes
        stall is unobservable from pooled telemetry; the trailing run
        of node ids is chosen — symmetric under the complete overlay,
        deterministic for the fitted-then-swept contract."""
        count = int(round(self.paused_frac * self.n))
        if count < 1:
            return None
        from sidecar_tpu_torch.chaos import FOREVER, FaultPlan, NodeFault
        nodes = tuple(range(self.n - count, self.n))
        return FaultPlan(seed=seed, nodes=(NodeFault(
            nodes=nodes, start_round=start_round,
            end_round=FOREVER if end_round is None else end_round,
            kind="pause"),))

    def to_json(self) -> dict:
        return {
            "n": self.n,
            "services_per_node": self.services_per_node,
            "loss_rate": round(self.loss_rate, 6),
            "churn_rate": round(self.churn_rate, 8),
            "paused_frac": round(self.paused_frac, 6),
            "seconds_per_round": self.seconds_per_round,
            "source": self.source,
            "signals": dict(self.signals),
        }


def _pause_from_behind(behind_tail: int, n: int, spn: int) -> float:
    """Invert the standing-backlog model ``behind = spn·p·(2n−1−p)``
    (p paused nodes: each is behind on ``m − spn`` cells and keeps the
    ``n − p`` up nodes behind on its own ``spn``) for the paused-node
    fraction."""
    if behind_tail <= 0 or n < 1 or spn < 1:
        return 0.0
    b = behind_tail / spn
    disc = (2 * n - 1) ** 2 - 4 * b
    p = (2 * n - 1 - math.sqrt(disc)) / 2 if disc >= 0 else n / 2
    return min(max(p / n, 0.0), 1.0)


def fit_from_trace(trace_rows, *, params, injections: Optional[dict] = None,
                   timecfg=None, source: str = "trace") -> ConditionEstimate:
    """Fit a :class:`ConditionEstimate` from flight-recorder rounds.

    ``trace_rows`` is the ``ops/trace.trace_to_dicts`` form (one dict
    per recorded round); ``injections`` the chaos counters
    (``ChaosExactSim.injection_counts``) when the trace came from the
    chaos family; ``params`` the SimParams of the traced run (the
    estimators need n/spn/fanout to invert the censuses); ``timecfg``
    supplies the protocol clock for ``seconds_per_round``."""
    rows = list(trace_rows)
    n, spn = int(params.n), int(params.services_per_node)
    m, fanout = n * spn, int(params.fanout)
    rounds = len(rows)

    offered = sum(int(r.get("frontier", 0)) for r in rows) * fanout
    dropped = int((injections or {}).get("dropped", 0))
    loss = dropped / offered if offered else 0.0

    fp_total = sum(int(r.get("fp_tombstones", 0)) for r in rows)
    churn = 2.0 * fp_total / (n * m * rounds) if rounds else 0.0

    tail = [int(r.get("behind", 0)) for r in rows[-TAIL_ROUNDS:]]
    behind_tail = min(tail) if tail else 0
    paused = _pause_from_behind(behind_tail, n, spn)

    spr = None
    if timecfg is not None:
        spr = timecfg.round_ticks / timecfg.ticks_per_second
    return ConditionEstimate(
        n=n, services_per_node=spn,
        loss_rate=min(max(loss, 0.0), 1.0),
        churn_rate=min(max(churn, 0.0), 1.0),
        paused_frac=paused, seconds_per_round=spr, source=source,
        signals={"rounds": rounds, "offered_packets": offered,
                 "dropped_packets": dropped, "fp_tombstones": fp_total,
                 "behind_tail": behind_tail})


def fit_live(snapshot: Optional[dict] = None, *, n: int,
             services_per_node: int,
             seconds_per_round: Optional[float] = None,
             window_rounds: Optional[int] = None) -> ConditionEstimate:
    """Best-effort estimate from the process metrics registry.

    * loss — the native transport relay's EAGAIN-dropped sends over
      packets out (``engine.udpSendDrops`` / ``engine.udpOut``);
    * churn — ``damping.flaps`` needs a round base: with
      ``window_rounds`` the flap count converts to a per-round
      per-slot rate, without one it stays 0 (reported raw in
      ``signals`` — never silently invented);
    * pause proxy — ``1 − coherence.agreement``: hosts off the quorum
      digest are standing divergence, the live shadow of a stalled
      node's backlog.
    """
    if snapshot is None:
        from sidecar_tpu_torch import metrics
        snapshot = metrics.snapshot()
    gauges = snapshot.get("gauges", {})
    counters = snapshot.get("counters", {})
    m = n * services_per_node

    def signal(name):
        v = gauges.get(name)
        return v if v is not None else counters.get(name)

    out_pk = float(signal("engine.udpOut") or 0.0)
    drops = float(signal("engine.udpSendDrops") or 0.0)
    loss = drops / out_pk if out_pk > 0 else 0.0

    flaps = float(counters.get("damping.flaps") or 0.0)
    churn = flaps / (m * window_rounds) \
        if window_rounds and m else 0.0

    agreement = gauges.get("coherence.agreement")
    paused = max(0.0, 1.0 - float(agreement)) \
        if agreement is not None else 0.0

    return ConditionEstimate(
        n=n, services_per_node=services_per_node,
        loss_rate=min(max(loss, 0.0), 1.0),
        churn_rate=min(max(churn, 0.0), 1.0),
        paused_frac=min(paused, 1.0),
        seconds_per_round=seconds_per_round, source="live",
        signals={"udp_out": out_pk, "udp_send_drops": drops,
                 "flaps": flaps, "agreement": agreement,
                 "window_rounds": window_rounds})
