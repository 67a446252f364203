"""Phase scopes of the round — the port of the first half of
``sidecar_tpu/telemetry/cost.py``.

:func:`phase` wraps a phase of the round (``publish``, ``gather``,
``fold``, ``exchange``, ``ttl_sweep``, ``announce``, ``apply_scatter``)
in a ``torch.profiler.record_function("sidecar.phase.<name>")``, so a
``torch.profiler`` trace groups the host ranges — and the device
kernels launched inside them — by protocol phase.  :func:`phased` is
the decorator form; its ``tag`` nests a second range inside the phase
(the compressed push-pull is phase ``exchange``, tag ``push_pull``,
which keeps it apart from the sharded twin's board exchange).

Off by default, and then every scope is a ``nullcontext`` and the round
runs exactly as without it.  ``SIDECAR_TPU_COST_PHASES=1`` turns the
scopes on (``0`` or empty off); unset, a configured profile directory
(``SIDECAR_TPU_PROFILE_DIR``) turns them on, as in the reference.
:func:`forced_phases` pins the switch for a block.  The check runs per
call, so a switch takes effect at the next round.

The reference's other half — compiled-HLO cost reports, collective
byte parsing and profile-trace reduction — reads XLA's programs and is
not ported.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Optional

import torch

PHASE_ENV = "SIDECAR_TPU_COST_PHASES"
PROFILE_ENV = "SIDECAR_TPU_PROFILE_DIR"
PHASE_PREFIX = "sidecar.phase."

# The phase taxonomy of the reference.
PHASES = ("publish", "gather", "fold", "exchange", "ttl_sweep",
          "announce", "apply_scatter")


def phases_enabled() -> bool:
    """``SIDECAR_TPU_COST_PHASES`` when set (anything but ``""`` and
    ``"0"`` is on), else whether a profile directory is configured."""
    raw = os.environ.get(PHASE_ENV)
    if raw is not None:
        return raw.strip() not in ("", "0")
    return bool(os.environ.get(PROFILE_ENV))


def phase(name: str):
    """The ``sidecar.phase.<name>`` range when phases are on, a
    ``nullcontext`` otherwise."""
    if not phases_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(PHASE_PREFIX + name)


def phased(name: str, tag: Optional[str] = None):
    """Decorator form of :func:`phase`; ``tag`` nests a range of that
    name inside the phase's."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not phases_enabled():
                return fn(*args, **kwargs)
            with phase(name):
                if tag is None:
                    return fn(*args, **kwargs)
                with torch.profiler.record_function(tag):
                    return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def forced_phases(enabled: bool = True):
    """Pin ``SIDECAR_TPU_COST_PHASES`` for the block, then restore it."""
    old = os.environ.get(PHASE_ENV)
    os.environ[PHASE_ENV] = "1" if enabled else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(PHASE_ENV, None)
        else:
            os.environ[PHASE_ENV] = old
