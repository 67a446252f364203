"""Chaos and adversary — the port of ``sidecar_tpu/chaos/``'s simulator
half: one seeded :class:`FaultPlan` (``chaos/plan.py``) and an optional
:class:`AdversaryPlan` (``chaos/adversary.py``) drive
:class:`ChaosExactSim` (``chaos/sim_inject.py``), the exact model's
round with per-edge drop, delay and duplicate schedules, asymmetric
partitions, node pause and crash windows, clock skew, forged records
and the per-origin defences.  The live transport injector of the
reference (``live_inject.py``) holds no device code and is not ported.
"""

from sidecar_tpu_torch.chaos.adversary import (
    ATTACK_KINDS,
    AdversaryPlan,
    Attack,
    CompiledAdversaryPlan,
)
from sidecar_tpu_torch.chaos.plan import (
    FOREVER,
    ClockFault,
    EdgeFault,
    FaultPlan,
    HealthFault,
    NodeFault,
    coin,
    resolve_nodes,
)
from sidecar_tpu_torch.chaos.sim_inject import (
    ChaosExactSim,
    ChaosSimState,
    CompiledFaultPlan,
    FaultDraws,
)

__all__ = [
    "ATTACK_KINDS",
    "AdversaryPlan",
    "Attack",
    "ChaosExactSim",
    "ChaosSimState",
    "ClockFault",
    "CompiledAdversaryPlan",
    "CompiledFaultPlan",
    "EdgeFault",
    "FOREVER",
    "FaultDraws",
    "FaultPlan",
    "HealthFault",
    "NodeFault",
    "coin",
    "resolve_nodes",
]
