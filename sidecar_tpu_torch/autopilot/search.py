"""Knob-space search batched through the fleet — the port of
``sidecar_tpu/autopilot/search.py``: grid seeding plus elite-jitter
evolution (a (μ+λ)-ES), each generation's candidates scored in fleet
dispatches (one ``FleetSim`` batch per group of the axes that shape the
program).

* **seed generation** — a coarse grid over the axes, plus the
  status-quo baseline as candidate 0;
* **evolve generations** — each jitters the elites (log space for
  scale-like knobs, rounded for integer knobs, clipped to the axis
  range), drops what was already evaluated, and scores the rest.

Candidates come from ``np.random.default_rng(seed)`` alone, as in the
reference, so the same scores give the same history; a batch runs with
``stop=False``, so the winner's row can be replayed through the
unbatched sim (``controller.replay_check``); ties break on (score,
name).  The evaluator counts every scenario it scores
(``evaluations``) and every batch it runs (``dispatches``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np

from sidecar_tpu_torch.fleet import FleetSim
from sidecar_tpu_torch.fleet.batch import ScenarioSpec
from sidecar_tpu_torch.fleet.grid import (
    _DATA_AXES,
    DEFAULT_MAX_BATCH,
    KNOWN_AXES,
    build_batches,
)
from sidecar_tpu_torch.models import common

# Integer-valued knobs (rounded after jitter/clipping).
_INT_AXES = ("seed", "retransmit_limit", "fault_seed", "origin_budget",
             "origin_quarantine", "fanout", "budget")


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One searchable knob: its range, scale, and status-quo value.

    ``log=True`` marks scale-like knobs (intervals, half-lives) whose
    jitter should be multiplicative.  ``base`` is the value the
    baseline/status-quo config holds — used when a jitter parent never
    set the axis (the baseline candidate is ``{}``)."""

    name: str
    lo: float
    hi: float
    integer: bool = False
    log: bool = False
    base: Optional[float] = None

    def __post_init__(self):
        if self.name not in KNOWN_AXES:
            raise ValueError(
                f"unknown search axis {self.name!r}; expected one of "
                f"{sorted(KNOWN_AXES)}")
        if not self.lo < self.hi:
            raise ValueError(
                f"axis {self.name}: empty range [{self.lo}, {self.hi}]")
        if self.log and self.lo <= 0:
            raise ValueError(
                f"axis {self.name}: log scale needs lo > 0, "
                f"got {self.lo}")
        if self.name in _INT_AXES and not self.integer:
            object.__setattr__(self, "integer", True)

    @property
    def data_axis(self) -> bool:
        return self.name in _DATA_AXES

    def clip(self, v: float):
        v = min(max(float(v), self.lo), self.hi)
        return int(round(v)) if self.integer else round(v, 6)

    def grid(self, k: int) -> list:
        """k values spanning the range (log- or linearly spaced),
        deduplicated after integer rounding."""
        k = max(int(k), 1)
        if k == 1:
            pts = [(self.lo + self.hi) / 2]
        elif self.log:
            la, lb = math.log(self.lo), math.log(self.hi)
            pts = [math.exp(la + (lb - la) * i / (k - 1))
                   for i in range(k)]
        else:
            pts = [self.lo + (self.hi - self.lo) * i / (k - 1)
                   for i in range(k)]
        out, seen = [], set()
        for p in pts:
            v = self.clip(p)
            if v not in seen:
                seen.add(v)
                out.append(v)
        return out

    def effective(self, candidate: dict):
        """The value ``candidate`` holds on this axis (falling back to
        the status-quo ``base``, then the range midpoint)."""
        if self.name in candidate:
            return candidate[self.name]
        if self.base is not None:
            return self.clip(self.base)
        return self.clip((self.lo + self.hi) / 2)

    def jitter(self, v: float, rng, sigma: float):
        """One mutation: multiplicative in log space for scale knobs,
        additive as a fraction of the range otherwise."""
        if self.log:
            return self.clip(float(v) * math.exp(
                rng.normal() * sigma * math.log(self.hi / self.lo)))
        return self.clip(float(v) + rng.normal() * sigma
                         * (self.hi - self.lo))


def _key(candidate: dict) -> tuple:
    return tuple(sorted(candidate.items()))


@dataclasses.dataclass
class EvalResult:
    """One scored candidate, with the run refs the replay check needs."""

    candidate: dict
    name: str
    score: float
    slo: dict              # the evaluate_row verdict block
    row: dict              # the FleetRun.table row
    batch: object          # the ScenarioBatch the candidate ran in
    run: object            # the FleetRun
    lane: int              # the candidate's scenario index in the batch

    def to_json(self) -> dict:
        return {"candidate": dict(self.candidate), "name": self.name,
                "score": round(self.score, 6), "slo": self.slo,
                "row": self.row}


class FleetEvaluator:
    """Score candidate knob bundles in fleet dispatches on ``device``
    (the card unless the caller asks for the CPU).

    Every candidate becomes a ``ScenarioSpec`` layered over the fitted
    ``base`` fields (the environment the fit produced rides every
    scenario), grouped and chunked by ``build_batches`` at ``max_batch``
    (the reference's environment default, ``DEFAULT_MAX_BATCH``), and
    run with ``stop=False`` so each row equals its unbatched run."""

    def __init__(self, params, timecfg, objective, *, plan=None,
                 rounds: int = 120, eps: float = 0.01,
                 conv_every: int = 1, base: Optional[dict] = None,
                 tracked=(), max_batch: int = DEFAULT_MAX_BATCH,
                 device="cuda") -> None:
        self.params = params
        self.timecfg = timecfg
        self.objective = objective
        self.plan = plan
        self.rounds = int(rounds)
        self.eps = float(eps)
        self.conv_every = int(conv_every)
        self.base = dict(base or {})
        self.tracked = tuple(tracked)
        self.max_batch = int(max_batch)
        self.device = common.resolve_device(device, "FleetEvaluator")
        self.evaluations = 0     # scenarios actually simulated
        self.dispatches = 0      # fleet batches run

    def _run_batch(self, batch, inputs=None):
        """One fleet dispatch of ``batch``: ``(FleetSim, FleetRun)``.
        ``inputs`` — ``(draws, fault_draws, perturb)``, as
        ``fleet.cpu_inputs`` gives them — replaces the batch's own draws
        and churn hook."""
        draws, faults, perturb = inputs or (None, None, None)
        fleet = FleetSim(batch, perturb=perturb)
        run = fleet.run(fleet.init_states(), self.rounds,
                        conv_every=self.conv_every, eps=self.eps,
                        stop=False, tracked=self.tracked, draws=draws,
                        fault_draws=faults)
        return fleet, run

    def evaluate(self, candidates: list, tag: str) -> list:
        """Score ``candidates`` (dicts of axis overrides) and return
        aligned :class:`EvalResult`s."""
        specs = []
        for i, cand in enumerate(candidates):
            kw = dict(self.base)
            kw.update(cand)
            specs.append(ScenarioSpec(name=f"{tag}-c{i:02d}", **kw))
        results: list = [None] * len(specs)
        for batch, idxs in build_batches(
                specs, self.params, self.timecfg, family="exact",
                plan=self.plan, max_batch=self.max_batch,
                device=self.device):
            _fleet, run = self._run_batch(batch)
            rows = run.table(self.timecfg.round_ticks,
                             self.timecfg.ticks_per_second)
            for j, src in enumerate(idxs):
                score, block = self.objective.score_row(
                    rows[j], run.lag_summary(j), horizon=self.rounds)
                results[src] = EvalResult(
                    candidate=dict(candidates[src]),
                    name=specs[src].name, score=score, slo=block,
                    row=rows[j], batch=batch, run=run, lane=j)
            self.dispatches += 1
        self.evaluations += len(specs)
        return results


@dataclasses.dataclass
class SearchResult:
    best: EvalResult
    baseline: Optional[EvalResult]
    history: list            # every EvalResult, evaluation order
    evaluations: int
    dispatches: int
    generations_run: int
    grid_points: int         # exhaustive-grid size over the same axes

    def to_json(self) -> dict:
        return {"best": self.best.to_json(),
                "baseline": self.baseline.to_json()
                if self.baseline else None,
                "evaluations": self.evaluations,
                "dispatches": self.dispatches,
                "generations_run": self.generations_run,
                "grid_points": self.grid_points,
                "candidates": [r.to_json() for r in self.history]}


def exhaustive_grid_size(axes, per_axis: int = 4) -> int:
    """What an exhaustive grid over the same axes would cost, at
    ``per_axis`` values per axis — the measured comparison point for
    the bench's fewer-evaluations claim (counted, never run)."""
    size = 1
    for ax in axes:
        size *= max(len(ax.grid(per_axis)), 1)
    return size


def es_search(evaluator: FleetEvaluator, axes, *, seed_grid: int = 2,
              generations: int = 2, population: int = 8,
              elites: int = 2, seed: int = 0,
              include_baseline: bool = True,
              sigma: float = 0.25, sigma_decay: float = 0.6,
              grid_per_axis: int = 4) -> SearchResult:
    """Grid-seed + elite-jitter search over ``axes``.

    ``seed_grid`` values per axis seed the landscape (Cartesian over
    the axes — keep it coarse; the ES does the refining); each of
    ``generations`` then scores ``population`` jittered children of
    the current ``elites`` in one fleet dispatch.  Deterministic under
    ``seed``."""
    axes = tuple(axes)
    if not axes:
        raise ValueError("es_search needs at least one AxisSpec")
    names = [ax.name for ax in axes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate search axes in {names}")
    rng = np.random.default_rng(seed)

    seeds: list = [{}] if include_baseline else []
    for combo in itertools.product(*(ax.grid(seed_grid) for ax in axes)):
        seeds.append(dict(zip(names, combo)))
    seen = {_key(c) for c in seeds}

    history = list(evaluator.evaluate(seeds, "seed"))
    baseline = history[0] if include_baseline else None
    data_axes = [ax for ax in axes if ax.data_axis]

    gens_run = 0
    for g in range(int(generations)):
        ranked = sorted(history, key=lambda r: (r.score, r.name))
        parents = ranked[:max(int(elites), 1)]
        sg = sigma * (sigma_decay ** g)
        cands, attempts = [], 0
        while len(cands) < int(population) and attempts < population * 20:
            attempts += 1
            parent = parents[attempts % len(parents)]
            cand = dict(parent.candidate)
            # Mutate a random non-empty subset of the data axes;
            # the program-shaping axes stay inherited (one batch a
            # generation).
            if not data_axes:
                break
            k = int(rng.integers(1, len(data_axes) + 1))
            picked = rng.choice(len(data_axes), size=k, replace=False)
            for ai in sorted(int(x) for x in picked):
                ax = data_axes[ai]
                cand[ax.name] = ax.jitter(ax.effective(cand), rng, sg)
            key = _key(cand)
            if key not in seen:
                seen.add(key)
                cands.append(cand)
        if not cands:
            break
        history.extend(evaluator.evaluate(cands, f"g{g:02d}"))
        gens_run += 1

    best = min(history, key=lambda r: (r.score, r.name))
    return SearchResult(
        best=best, baseline=baseline, history=history,
        evaluations=evaluator.evaluations,
        dispatches=evaluator.dispatches, generations_run=gens_run,
        grid_points=exhaustive_grid_size(axes, grid_per_axis))
