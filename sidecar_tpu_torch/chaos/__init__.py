"""Chaos and adversary — the port of ``sidecar_tpu/chaos/``: one seeded
:class:`FaultPlan` (``chaos/plan.py``) and an optional
:class:`AdversaryPlan` (``chaos/adversary.py``) drive
:class:`ChaosExactSim` (``chaos/sim_inject.py``), the exact model's
round with per-edge drop, delay and duplicate schedules, asymmetric
partitions, node pause and crash windows, clock skew, forged records
and the per-origin defences; and the same plans on the live cluster
(``chaos/live_inject.py``): :class:`LiveInjector` at a node's transport
boundary, :class:`AdversaryInjector` forging catalog pushes, and
:class:`LiveChaosController` cutting partitions in the gossip engines.
"""

from sidecar_tpu_torch.chaos.adversary import (
    ATTACK_KINDS,
    AdversaryPlan,
    Attack,
    CompiledAdversaryPlan,
)
from sidecar_tpu_torch.chaos.live_inject import (
    AdversaryInjector,
    LiveChaosController,
    LiveInjector,
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
    "AdversaryInjector",
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
    "LiveChaosController",
    "LiveInjector",
    "NodeFault",
    "coin",
    "resolve_nodes",
]
