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
runs exactly as without it.  The reference reads its switch from the
``SIDECAR_TPU_COST_PHASES`` and ``SIDECAR_TPU_PROFILE_DIR`` environment
variables; the port reads none: :func:`set_phases` turns the scopes on
or off, and :func:`forced_phases` pins the switch for a block.  The
check runs per call, so a switch takes effect at the next round.

:func:`snapshot` is the document of ``GET /api/cost.json``.  The
reference's compiled-HLO cost reports, collective byte parsing and
profile-trace reduction read XLA's programs and are not ported, so its
``programs`` block is empty.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

from sidecar_tpu_torch import metrics

PHASE_PREFIX = "sidecar.phase."

# The phase taxonomy of the reference.
PHASES = ("publish", "gather", "fold", "exchange", "ttl_sweep",
          "announce", "apply_scatter")


_enabled = False


def phases_enabled() -> bool:
    """Whether the phase scopes are on (off until :func:`set_phases`)."""
    return _enabled


def set_phases(enabled: bool) -> None:
    """Turn the phase scopes on or off."""
    global _enabled
    _enabled = bool(enabled)


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
    """Pin the switch for the block, then restore it."""
    old = _enabled
    set_phases(enabled)
    try:
        yield
    finally:
        set_phases(old)


def snapshot() -> dict:
    """The view behind ``GET /api/cost.json``: the phase-scope state,
    the phase taxonomy, the ``compile.*`` counters and the compiled
    programs' reports — none in the port, which compiles no XLA
    program."""
    return {
        "phases_enabled": phases_enabled(),
        "phase_taxonomy": list(PHASES),
        "programs": {},
        "compile": {
            "count": metrics.counter("compile.count"),
            "cache_hits": metrics.counter("compile.cache_hit"),
        },
    }
