"""The scenario fleet — the port of ``sidecar_tpu/fleet/``: S
independent scenarios advanced together a round at a time.

* :mod:`batch`  — ``ScenarioSpec`` / ``ScenarioBatch``: per-scenario
  protocol knobs validated and stacked on the device
  (``ops/knobs.BatchedKnobs``), and the knob-driven churn hook;
* :mod:`rounds` — the batched exact and chaos rounds, the compressed
  round a scenario at a time, and the batched census and convergence;
* :mod:`engine` — ``FleetSim``: the driver, with the converged-mask
  early exit, per-scenario convergence curves and the folded census;
* :mod:`grid`   — grid expansion into ``ScenarioBatch``es (grids larger
  than one batch are chunked; the axes that shape the program group)
  and the Pareto front.
"""

from sidecar_tpu_torch.fleet.batch import (  # noqa: F401
    ScenarioBatch,
    ScenarioSpec,
    churn_seed,
    restart_churn_perturb,
)
from sidecar_tpu_torch.fleet.engine import (  # noqa: F401
    FleetRun,
    FleetSim,
    cpu_inputs,
)
from sidecar_tpu_torch.fleet.grid import (  # noqa: F401
    ParetoFront,
    build_batches,
    expand_grid,
    pareto_front,
)
