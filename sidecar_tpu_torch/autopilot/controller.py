"""The autopilot control loop — the port of
``sidecar_tpu/autopilot/controller.py``.

``AutopilotController.recommend`` closes the live↔sim loop in four
moves, each owned by a sibling module:

1. **fit** (``autopilot/fit.py``) — the cluster's conditions as a
   :class:`ConditionEstimate` (loss and churn as data-axis base fields,
   pauses as a shared ``FaultPlan``);
2. **objective** (``autopilot/objective.py``) — the operator's
   ``telemetry/slo.py`` rules become the scalar the search minimises;
3. **search** (``autopilot/search.py``) — grid seeding plus elite-jitter
   ES over the knob space, one ``FleetSim`` dispatch a generation on the
   card, every scenario counted;
4. **verify + gate** — the winner is replayed UNBATCHED through
   ``ExactSim`` / ``ChaosExactSim`` from the generators the fleet used
   and must equal its fleet row (:func:`replay_check`) before it is
   applied.

The reference reads its apply gate, default rules and search budget
from environment variables; the port reads none.  They are explicit
here: the apply gate is the constructor's ``apply_armed`` (only whoever
builds the controller — the operator's side — can arm it; a request's
``apply=True`` alone never can, and a blocked apply is counted as
``autopilot.apply_blocked``), the default rules are
:data:`DEFAULT_AUTOPILOT_RULES`, and the rounds, generations and
population default to 120, 2 and 6.

Every recommendation records the ``autopilot.*`` metrics in the port's
registry and stores its report on a catalog-like ``state``
(``state.autopilot_report``; duck-typed: ``_lock`` and ``servers``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.autopilot.fit import ConditionEstimate, fit_live
from sidecar_tpu_torch.autopilot.objective import Objective
from sidecar_tpu_torch.autopilot.search import (
    AxisSpec,
    EvalResult,
    FleetEvaluator,
    es_search,
)
from sidecar_tpu_torch.fleet import churn_seed, restart_churn_perturb
from sidecar_tpu_torch.fleet.batch import _TIMECFG_FIELDS
from sidecar_tpu_torch.fleet.grid import DEFAULT_MAX_BATCH
from sidecar_tpu_torch.models.exact import ExactSim, SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import topology as topo_mod

DEFAULT_AUTOPILOT_RULES = ("converge <= 30 rounds", "agreement >= 0.99")

# The fleet-row ↔ unbatched-run comparison surface.
REPLAY_FIELDS = ("known", "sent", "node_alive", "round_idx")


def default_axes(timecfg: TimeConfig,
                 params: Optional[SimParams] = None) -> tuple:
    """The stock searchable knobs, anchored at the status-quo config:
    gossip cadence (log scale — it spans orders of magnitude),
    transmit limit, and the suspicion window."""
    limit = params.resolved_retransmit_limit() if params is not None \
        else 6
    return (
        AxisSpec("push_pull_interval_s", 0.5, 30.0, log=True,
                 base=timecfg.push_pull_interval_s),
        AxisSpec("retransmit_limit", 2, 12, base=limit),
        AxisSpec("suspicion_window_s", 0.0, 8.0,
                 base=timecfg.suspicion_window_s),
    )


def axis_from_wire(doc: dict) -> AxisSpec:
    """An ``AxisSpec`` from its wire form (unknown keys rejected loudly —
    a typoed bound silently defaulting would search the wrong space)."""
    if not isinstance(doc, dict):
        raise ValueError(f"axis entries must be objects, got {doc!r}")
    allowed = {"name", "lo", "hi", "integer", "log", "base"}
    bad = set(doc) - allowed
    if bad:
        raise ValueError(
            f"unknown axis field(s) {sorted(bad)}; expected a subset "
            f"of {sorted(allowed)}")
    for req in ("name", "lo", "hi"):
        if req not in doc:
            raise ValueError(f"axis entry missing {req!r}: {doc!r}")
    return AxisSpec(name=str(doc["name"]), lo=float(doc["lo"]),
                    hi=float(doc["hi"]),
                    integer=bool(doc.get("integer", False)),
                    log=bool(doc.get("log", False)),
                    base=None if doc.get("base") is None
                    else float(doc["base"]))


def estimate_from_wire(doc: dict, *, n: int,
                       services_per_node: int) -> ConditionEstimate:
    """A ``ConditionEstimate`` stated directly by the caller instead of
    fitted."""
    if not isinstance(doc, dict):
        raise ValueError(
            f"'estimate' must be an object, got {doc!r}")
    allowed = {"loss_rate", "churn_rate", "paused_frac",
               "seconds_per_round"}
    bad = set(doc) - allowed
    if bad:
        raise ValueError(
            f"unknown estimate field(s) {sorted(bad)}; expected a "
            f"subset of {sorted(allowed)}")
    for k in ("loss_rate", "churn_rate", "paused_frac"):
        v = doc.get(k, 0.0)
        if not 0.0 <= float(v) <= 1.0:
            raise ValueError(f"estimate.{k}={v} not in [0, 1]")
    return ConditionEstimate(
        n=n, services_per_node=services_per_node,
        loss_rate=float(doc.get("loss_rate", 0.0)),
        churn_rate=float(doc.get("churn_rate", 0.0)),
        paused_frac=float(doc.get("paused_frac", 0.0)),
        seconds_per_round=doc.get("seconds_per_round"),
        source="request")


def replay_check(result: EvalResult) -> dict:
    """Verify the winner OUTSIDE the batch: rebuild scenario ``lane``'s
    unbatched sim from what the fleet used — ``scenario_params``,
    ``scenario_timecfg``, ``scenario_cadence``, ``scenario_plan`` (its
    fault seed), the static-probability churn twin on the generator
    seeded with ``churn_seed(spec.seed)``, and the round draws of
    ``batch.generators()[lane]`` — and require its final state to equal
    the fleet row on every :data:`REPLAY_FIELDS` field.  The chaos
    round samples with no cadence gate, in the fleet's batch as in
    ``ChaosExactSim``, so a chaos lane's replay takes no cadence.  A
    diverging replay is reported as ``identical: false``, never
    raised."""
    batch, run, lane = result.batch, result.run, result.lane
    spec = batch.specs[lane]
    params_i = batch.scenario_params(lane)
    perturb = (restart_churn_perturb(params_i, prob=spec.churn_prob,
                                     seed=churn_seed(spec.seed))
               if spec.churn_prob > 0 else None)
    topo = (topo_mod.from_name(batch.topology, params_i.n)
            if batch.topology else topo_mod.complete(params_i.n))
    plan_i = batch.scenario_plan(lane)
    dev = batch.device
    if plan_i is not None:
        from sidecar_tpu_torch.chaos import ChaosExactSim
        sim = ChaosExactSim(params_i, topo, batch.scenario_timecfg(lane),
                            plan_i, device=dev, perturb=perturb)
    else:
        period, phase = batch.scenario_cadence(lane)
        sim = ExactSim(params_i, topo, batch.scenario_timecfg(lane),
                       device=dev, perturb=perturb, tick_period=period,
                       tick_phase=phase)
    rounds = int(run.rounds[lane])       # stop=False: the full horizon
    final, _conv = sim.run(sim.init_state(), rounds,
                           generator=batch.generators()[lane])
    fleet_st = run.final_states
    a_src = fleet_st.sim if hasattr(fleet_st, "sim") else fleet_st
    b_src = final.sim if hasattr(final, "sim") else final
    fields = {}
    for name in REPLAY_FIELDS:
        a, b = getattr(a_src, name)[lane], getattr(b_src, name)
        fields[name] = bool(torch.equal(a, b)) \
            if isinstance(a, torch.Tensor) else int(a) == int(b)
    return {"checked": True, "rounds": rounds,
            "identical": all(fields.values()), "fields": fields}


class AutopilotController:
    """One recommendation pass over the knob space.

    ``bridge`` supplies the live catalog shape, the protocol clock and
    the apply target; either may be omitted for library use (then ``n``
    or an ``estimate`` must be given).  ``apply_armed`` is the apply
    gate: off unless the constructor arms it."""

    def __init__(self, bridge=None, state=None,
                 timecfg: Optional[TimeConfig] = None, *,
                 apply_armed: bool = False) -> None:
        self.bridge = bridge
        self.state = state if state is not None \
            else getattr(bridge, "state", None)
        self.timecfg = timecfg if timecfg is not None \
            else getattr(bridge, "t", None) or TimeConfig()
        self.apply_armed = bool(apply_armed)

    # -- the loop ----------------------------------------------------------

    def recommend(self, *, rules=None, axes=None, estimate=None,
                  rounds: int = 120, eps: float = 0.01,
                  n: Optional[int] = None, services_per_node: int = 4,
                  fanout: int = 3, budget: int = 15, seed: int = 0,
                  seed_grid: int = 2, generations: int = 2,
                  population: int = 6, elites: int = 2,
                  apply: bool = False, provenance: int = 0,
                  max_batch: int = DEFAULT_MAX_BATCH,
                  device="cuda") -> dict:
        """Run fit → objective → search → verify → gate on ``device``
        (the card unless the caller asks for the CPU) and return the
        report (also stored as ``state.autopilot_report``).  Raises
        ``ValueError`` on malformed rules, axes or estimate."""
        t0 = time.perf_counter()
        if rules is None:
            rules = list(DEFAULT_AUTOPILOT_RULES)
        if not isinstance(rules, (list, tuple)) or not rules:
            raise ValueError(
                "'rules' must be a non-empty list of SLO rule strings")
        rounds = int(rounds)
        if rounds < 1:
            raise ValueError(f"rounds={rounds} must be >= 1")
        generations, population = int(generations), int(population)
        if n is None:
            if self.state is not None:
                with self.state._lock:
                    n = len(self.state.servers)
                n = max(int(n), 8)
            elif estimate is not None and hasattr(estimate, "n"):
                n = int(estimate.n)
            else:
                raise ValueError(
                    "'n' is required without a live catalog to size "
                    "the twin from")
        n, spn = int(n), int(services_per_node)

        if estimate is None:
            estimate = fit_live(n=n, services_per_node=spn)
        elif isinstance(estimate, dict):
            estimate = estimate_from_wire(estimate, n=n,
                                          services_per_node=spn)

        # Cold-start study clock (the sweep convention): refresh pinned
        # out so rounds-to-ε measures pure epidemic spread.
        cfg = dataclasses.replace(self.timecfg,
                                  refresh_interval_s=10_000.0)
        params = SimParams(n=n, services_per_node=spn,
                           fanout=int(fanout), budget=int(budget))
        if axes is None:
            axes = default_axes(cfg, params)
        else:
            axes = tuple(ax if isinstance(ax, AxisSpec)
                         else axis_from_wire(ax) for ax in axes)

        spr = cfg.round_ticks / cfg.ticks_per_second
        objective = Objective(rules, seconds_per_round=spr)
        base = dict(estimate.base_fields())
        base["seed"] = int(seed)
        plan = estimate.fault_plan(seed=int(seed))
        tracked = ()
        if provenance:
            from sidecar_tpu_torch.ops import provenance as prov_ops
            tracked = prov_ops.default_tracked(params.m, int(provenance))
        evaluator = FleetEvaluator(
            params, cfg, objective, plan=plan, rounds=rounds,
            eps=float(eps), base=base, tracked=tracked,
            max_batch=max_batch, device=device)
        result = es_search(evaluator, axes, seed_grid=int(seed_grid),
                           generations=generations,
                           population=population, elites=int(elites),
                           seed=int(seed))
        replay = replay_check(result.best)

        # -- the apply gate ------------------------------------------------
        armed = self.apply_armed
        applied_fields: dict = {}
        applied = False
        if apply and armed and replay["identical"]:
            applied_fields = {k: v for k, v
                              in result.best.candidate.items()
                              if k in _TIMECFG_FIELDS}
            if self.bridge is not None and applied_fields:
                self.bridge.t = dataclasses.replace(self.bridge.t,
                                                    **applied_fields)
            applied = bool(applied_fields)
            metrics.incr("autopilot.applied")
        elif apply:
            metrics.incr("autopilot.apply_blocked")

        wall = time.perf_counter() - t0
        metrics.incr("autopilot.recommendations")
        metrics.incr("autopilot.evaluations", result.evaluations)
        metrics.set_gauge("autopilot.best_score", result.best.score)
        if result.baseline is not None:
            metrics.set_gauge("autopilot.baseline_score",
                              result.baseline.score)
        best_pass = result.best.slo.get("pass")
        metrics.set_gauge("autopilot.slo_pass",
                          1.0 if best_pass else 0.0)
        metrics.set_gauge("autopilot.replay_identical",
                          1.0 if replay["identical"] else 0.0)
        metrics.histogram_since("autopilot.recommend", t0)

        report = {
            "rules": objective.rules_text,
            "estimate": estimate.to_json(),
            "axes": [dataclasses.asdict(ax) for ax in axes],
            "n": n, "services_per_node": spn,
            "fanout": int(fanout), "budget": int(budget),
            "rounds": rounds, "eps": float(eps), "seed": int(seed),
            "fault_plan": (None if plan is None else
                           {"nodes_paused": sum(
                               len(nf.nodes) for nf in plan.nodes),
                            "seed": plan.seed}),
            "baseline": (None if result.baseline is None
                         else result.baseline.to_json()),
            "recommended": result.best.to_json(),
            "evaluations": result.evaluations,
            "dispatches": result.dispatches,
            "generations_run": result.generations_run,
            "grid_points": result.grid_points,
            "candidates": len(result.history),
            "replay": replay,
            "apply": {"requested": bool(apply), "armed": armed,
                      "applied": applied, "fields": applied_fields},
            "wall_seconds": round(wall, 3),
        }
        if self.state is not None:
            self.state.autopilot_report = report
        return report
