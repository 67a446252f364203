"""The live node's transport plane: the native gossip engine and the
delegate that bridges it to the catalog (``gossip.py``), and
digest-directed anti-entropy sessions between two catalogs
(``antientropy.py``)."""

from sidecar_tpu_torch.transport.antientropy import (
    AntiEntropyResponder,
    LoopbackChannel,
    ReconcileSession,
    SessionConfig,
    SessionReport,
    reconcile,
)
from sidecar_tpu_torch.transport.gossip import GossipTransport, load_native

__all__ = ["GossipTransport", "load_native", "AntiEntropyResponder",
           "LoopbackChannel", "ReconcileSession", "SessionConfig",
           "SessionReport", "reconcile"]
