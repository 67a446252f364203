"""Scenario registration and protocol-config validation — the port of
``sidecar_tpu/sim/scenarios.py``'s ``register_scenario``,
``validate_protocol_config`` and ``ALL_SCENARIOS`` registry, with the
reference's error messages word for word.

A scenario config is validated at registration time: a bad fanout or
transmit limit fails here with a named error, not many rounds into a
run as a shape or int8 failure.  The fleet (``fleet/batch.py``) routes
every grid point through :func:`validate_protocol_config` for the same
reason.

The reference's configs 1–6 and ``run_all`` are not ported yet, so the
registry starts empty; a caller registers its own scenarios.
"""

from __future__ import annotations

import math
from typing import Callable

ALL_SCENARIOS: dict[str, Callable] = {}


def register_scenario(name: str, fn: Callable, *,
                      replace: bool = False) -> None:
    """Register a runnable scenario under ``name``.

    Duplicate names are rejected (two scenarios silently shadowing each
    other is how a sweep reports the wrong config's numbers); pass
    ``replace=True`` to overwrite deliberately."""
    if not callable(fn):
        raise TypeError(f"scenario {name!r}: fn must be callable, got "
                        f"{type(fn).__name__}")
    if not replace and name in ALL_SCENARIOS:
        raise ValueError(
            f"scenario {name!r} is already registered "
            f"(to {ALL_SCENARIOS[name].__name__}); pick a distinct name "
            "or pass replace=True")
    ALL_SCENARIOS[name] = fn


def validate_protocol_config(n: int, *, fanout: int, budget: int,
                             retransmit_limit: int = 0,
                             services_per_node: int = 1,
                             name: str = "scenario") -> None:
    """Range-check the protocol knobs a scenario or grid point declares.

    Raises ``ValueError`` naming the offending knob and its bound: the
    fanout shapes the sampled-peer tensor, and the transmit limit must
    keep the int8 ``sent`` counters representable
    (``ops/gossip.record_transmissions``)."""
    label = f"{name}: " if name else ""
    if n < 1:
        raise ValueError(f"{label}n={n} must be >= 1")
    if services_per_node < 1:
        raise ValueError(
            f"{label}services_per_node={services_per_node} must be >= 1")
    if not 1 <= fanout:
        raise ValueError(f"{label}fanout={fanout} must be >= 1")
    if n > 1 and fanout >= n:
        raise ValueError(
            f"{label}fanout={fanout} must be < n={n} (a node cannot "
            "gossip to more distinct peers than exist)")
    if budget < 1:
        raise ValueError(f"{label}budget={budget} must be >= 1")
    if retransmit_limit < 0:
        raise ValueError(
            f"{label}retransmit_limit={retransmit_limit} must be >= 0 "
            "(0 = auto: RetransmitMult x ceil(log10(n+1)))")
    resolved = retransmit_limit if retransmit_limit > 0 else \
        4 * math.ceil(math.log10(n + 1))
    if resolved + fanout - 1 > 127:
        raise ValueError(
            f"{label}retransmit_limit={resolved} + fanout={fanout} - 1 "
            "exceeds the int8 transmit counter range (127)")
