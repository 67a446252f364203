"""The autopilot — the port of ``sidecar_tpu/autopilot/``: the live↔sim
control loop over the scenario fleet.

* :mod:`fit`        — telemetry → a :class:`ConditionEstimate` (loss and
  churn as data axes, pauses as a ``FaultPlan``);
* :mod:`objective`  — ``telemetry/slo.py`` rules → the scalar the search
  minimises;
* :mod:`search`     — grid seeding + elite-jitter ES, one ``FleetSim``
  dispatch a generation, every evaluation counted;
* :mod:`controller` — recommend, replay-verify and the apply gate, and
  the ``autopilot.*`` metrics.
"""

from sidecar_tpu_torch.autopilot.controller import (  # noqa: F401
    DEFAULT_AUTOPILOT_RULES,
    REPLAY_FIELDS,
    AutopilotController,
    axis_from_wire,
    default_axes,
    estimate_from_wire,
    replay_check,
)
from sidecar_tpu_torch.autopilot.fit import (  # noqa: F401
    ConditionEstimate,
    fit_from_trace,
    fit_live,
)
from sidecar_tpu_torch.autopilot.objective import Objective  # noqa: F401
from sidecar_tpu_torch.autopilot.search import (  # noqa: F401
    AxisSpec,
    FleetEvaluator,
    SearchResult,
    es_search,
)
