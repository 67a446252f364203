"""The live-catalog ⇄ simulator bridge (``sim_bridge.py``):
``SimBridge`` and its HTTP server ``serve_bridge``."""

from sidecar_tpu_torch.bridge.sim_bridge import (  # noqa: F401
    BridgeMapping,
    SimBridge,
    SimulationReport,
    serve_bridge,
)
