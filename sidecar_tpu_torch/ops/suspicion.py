"""The Lifeguard self-refutation at an announce site — the port of
``sidecar_tpu/ops/suspicion.py`` ``announce_refute``.  (The host-side
flap damping and the ``ProtocolParams`` bundle are not ported.)"""

from __future__ import annotations

import torch

from sidecar_tpu_torch.ops.status import ALIVE, SUSPECT


def announce_refute(due, st, present, suspicion):
    """Fold the self-refutation into an announce: with ``suspicion``
    (a Python bool, or the fleet's per-row bool tensor), an owner whose
    own record is SUSPECT announces immediately, as ALIVE.  Returns
    ``(due, st)``."""
    if not isinstance(suspicion, torch.Tensor) and not suspicion:
        return due, st
    refute = present & (st == SUSPECT)
    if isinstance(suspicion, torch.Tensor):
        refute = refute & suspicion
    return due | refute, torch.where(refute, ALIVE, st)
