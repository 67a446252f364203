"""Grid expansion into ScenarioBatches, and the Pareto-front helper — the
port of ``sidecar_tpu/fleet/grid.py``.

A grid spec is a dict of axis name → list of values.  Axes split as
``ops/knobs.py`` splits the parameter space:

* **data axes** (vary within a batch): ``seed``, ``retransmit_limit``,
  ``drop_prob``, ``churn_prob``, ``mint_frac``, ``fault_seed``,
  ``tick_period``/``tick_phase`` and the per-scenario TimeConfig
  overrides (``push_pull_interval_s``, ``sweep_interval_s``,
  ``refresh_interval_s``, ``suspicion_window_s``, ``alive_lifespan_s``,
  ``draining_lifespan_s``, ``tombstone_lifespan_s``,
  ``future_fudge_s``, ``origin_budget``, ``origin_quarantine``);
* **axes that shape the program** (group into separate batches):
  ``fanout``, ``budget``, ``topology``.

Grids larger than one batch are chunked at ``max_batch`` scenarios
(default 64): the boundary is invisible to the results (scenarios are
independent) and bounds one batch's memory.  The reference also reads
the cap from an environment variable; the port reads none.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from sidecar_tpu_torch.fleet.batch import ScenarioBatch, ScenarioSpec
from sidecar_tpu_torch.models.timecfg import TimeConfig

_DATA_AXES = (
    "seed", "retransmit_limit", "drop_prob", "churn_prob", "mint_frac",
    "fault_seed", "push_pull_interval_s", "sweep_interval_s",
    "refresh_interval_s", "suspicion_window_s", "alive_lifespan_s",
    "draining_lifespan_s", "tombstone_lifespan_s", "future_fudge_s",
    "origin_budget", "origin_quarantine", "tick_period", "tick_phase",
)
_STATIC_AXES = ("fanout", "budget", "topology")
KNOWN_AXES = _DATA_AXES + _STATIC_AXES

DEFAULT_MAX_BATCH = 64


def expand_grid(axes: dict, base: Optional[dict] = None) -> list:
    """Cartesian-expand a grid spec into ``ScenarioSpec``s.

    ``axes`` maps axis names (:data:`KNOWN_AXES`) to value lists;
    ``base`` supplies fixed spec fields every point shares.  Unknown
    axis names are rejected (a typoed knob silently sweeping nothing
    would report the base config for every point)."""
    base = dict(base or {})
    bad = [k for k in axes if k not in KNOWN_AXES]
    if bad:
        raise ValueError(
            f"unknown grid axis(es) {sorted(bad)}; expected a subset of "
            f"{sorted(KNOWN_AXES)}")
    bad = [k for k in base if k not in KNOWN_AXES]
    if bad:
        raise ValueError(
            f"unknown base field(s) {sorted(bad)}; expected a subset of "
            f"{sorted(KNOWN_AXES)}")
    for k, vs in axes.items():
        if not isinstance(vs, (list, tuple)) or not vs:
            raise ValueError(
                f"grid axis {k!r} must be a non-empty list of values, "
                f"got {vs!r}")
    names = sorted(axes)
    specs = []
    for i, combo in enumerate(itertools.product(
            *(axes[k] for k in names))):
        kw = dict(base)
        kw.update(dict(zip(names, combo)))
        tag = "-".join(f"{k}={v}" for k, v in zip(names, combo))
        specs.append(ScenarioSpec(name=f"pt{i:03d}" + (f"-{tag}"
                                                       if tag else ""),
                                  **kw))
    return specs


def build_batches(specs, params, timecfg: TimeConfig = TimeConfig(),
                  *, family: str = "exact", plan=None,
                  max_batch: int = DEFAULT_MAX_BATCH,
                  device="cuda") -> list:
    """Group specs by the axes that shape the program, chunk each group
    at ``max_batch``, and build validated ``ScenarioBatch``es on
    ``device``.

    Returns ``[(batch, indices)]``, ``indices`` mapping each batch
    scenario back to its position in ``specs``."""
    specs = list(specs)
    cap = max(1, int(max_batch))
    groups: dict = {}
    for idx, s in enumerate(specs):
        key = (s.fanout if s.fanout is not None else params.fanout,
               s.budget if s.budget is not None else params.budget,
               s.topology if s.topology is not None else "")
        groups.setdefault(key, []).append(idx)
    out = []
    for (fanout, budget, _topology), idxs in sorted(groups.items()):
        p = dataclasses.replace(params, fanout=fanout, budget=budget)
        for lo in range(0, len(idxs), cap):
            chunk = idxs[lo:lo + cap]
            batch = ScenarioBatch.build(
                [specs[i] for i in chunk], p, timecfg, family=family,
                plan=plan, device=device)
            out.append((batch, chunk))
    return out


class ParetoFront(list):
    """The front's indices, plus the rows it refused to consider.

    A plain ``list`` of the non-dominated indices, with ``excluded``:
    the indices of rows dropped before the domination test because a key
    was ``None`` (never converged within the horizon)."""

    def __init__(self, front=(), excluded=()):
        super().__init__(front)
        self.excluded = tuple(excluded)


def pareto_front(rows: list, *, keys=("rounds_to_eps",
                                      "exchange_bytes")) -> ParetoFront:
    """Indices of the non-dominated rows, minimising every key.  Rows
    with a ``None`` key are excluded from the front and counted in the
    result's ``excluded``."""
    def val(row, k):
        v = row.get(k)
        return float("inf") if v is None else float(v)

    front, excluded = [], []
    for i, a in enumerate(rows):
        av = [val(a, k) for k in keys]
        if any(v == float("inf") for v in av):
            excluded.append(i)
            continue
        dominated = False
        for j, b in enumerate(rows):
            if i == j:
                continue
            bv = [val(b, k) for k in keys]
            if all(x <= y for x, y in zip(bv, av)) and \
                    any(x < y for x, y in zip(bv, av)):
                dominated = True
                break
        if not dominated:
            front.append(i)
    return ParetoFront(front, excluded)
