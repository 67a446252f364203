"""The live node's transport plane: digest-directed anti-entropy
sessions between two catalogs (``antientropy.py``).  The gossip
transport, which loads the native engine, is not ported yet."""

from sidecar_tpu_torch.transport.antientropy import (
    AntiEntropyResponder,
    LoopbackChannel,
    ReconcileSession,
    SessionConfig,
    SessionReport,
    reconcile,
)

__all__ = ["AntiEntropyResponder", "LoopbackChannel", "ReconcileSession",
           "SessionConfig", "SessionReport", "reconcile"]
