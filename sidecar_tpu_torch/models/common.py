"""What the port's models share: the checks at construction — the
device (the card unless the caller asks for the CPU), the tick cadence
(:func:`resolve_cadence`) and the options not ported yet, each of which
raises naming its ROADMAP item — and the draw schedule of the
``run*`` methods (:func:`round_draws`)."""

from __future__ import annotations

import numpy as np
import torch

# Where each deferred option is queued (ROADMAP.md, Queue 1).
DEFERRED = {
    "perturb": "Queue 1 item 8 (chaos and adversary)",
    "cut_mask": "Queue 1 item 8 (chaos and adversary)",
    "node_side": "Queue 1 item 8 (chaos and adversary)",
}


def deferred(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet: ROADMAP.md {DEFERRED[option]}")


def reject_deferred(**options) -> None:
    """Raise :func:`deferred` for the first of ``options`` (``perturb``,
    ``cut_mask``, ``node_side``) that is not None."""
    for name, value in options.items():
        if name not in DEFERRED:
            raise TypeError(f"unknown option {name!r}")
        if value is not None:
            raise deferred(name)


def resolve_device(device, model: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{model} runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev


def resolve_cadence(tick_period, tick_phase, n: int, device):
    """The constructors' tick cadence (the reference's
    ``models/exact.py`` ``_resolve_cadence``): None or a static 1 is the
    int pair ``(1, 0)`` — no gate; any other int period stays an int
    pair; a sequence or array, scalar or per-node ``[N]``, becomes a
    pair of int32 tensors on ``device``.  Periods must be at least 1."""
    if tick_period is None:
        tick_period = 1
    if tick_phase is None:
        tick_phase = 0
    if isinstance(tick_period, int) and isinstance(tick_phase, int):
        if tick_period < 1:
            raise ValueError(
                f"tick_period must be an int ≥ 1, got {tick_period!r}")
        if tick_period == 1:
            return 1, 0
        return tick_period, tick_phase
    period = np.asarray(tick_period, dtype=np.int64).reshape(-1)
    phase = np.asarray(tick_phase, dtype=np.int64).reshape(-1)
    if (period < 1).any():
        raise ValueError(
            f"tick_period entries must be ≥ 1, got min {period.min()}")
    for name, v in (("tick_period", period), ("tick_phase", phase)):
        if v.shape[0] not in (1, n):
            raise ValueError(
                f"{name} must be a scalar or a length-{n} per-node "
                f"vector, got shape {v.shape}")
    return (torch.as_tensor(period.astype(np.int32), device=device),
            torch.as_tensor(phase.astype(np.int32), device=device))


def gate_kwargs(sim, round_idx: int) -> dict:
    """``sample_peers``'s gating keywords for ``round_idx``: the
    topology's stagger (``sim._stagger``, ``sim._stagger_period``) and
    the knobs' tick cadence; ``{}`` when neither is on."""
    kw = {}
    if sim._stagger is not None:
        kw.update(stagger=sim._stagger,
                  stagger_period=sim._stagger_period, round_idx=round_idx)
    kn = sim._knobs
    if kn.cadence_enabled:
        kw.update(tick_period=kn.tick_period, tick_phase=kn.tick_phase,
                  round_idx=round_idx)
    return kw


def stagger_tensor(topo, device):
    """The topology's stagger offsets as an int32 tensor, or None where
    it staggers nothing (no offsets, or a period of at most 1)."""
    if topo.stagger is None or topo.stagger_period <= 1:
        return None
    return torch.as_tensor(np.asarray(topo.stagger, dtype=np.int32),
                           device=device)


def one_draw(draws):
    """A single round's ``draws`` as :func:`round_draws` takes them."""
    return None if draws is None else [draws]


def round_draws(sim, first_round: int, num_rounds: int, generator, draws):
    """Yield the draws of rounds ``first_round`` … ``first_round +
    num_rounds - 1``: from ``draws`` when given (one per round), else
    from ``generator`` through ``sim.draw``."""
    if draws is not None:
        draws = list(draws)
        if len(draws) < num_rounds:
            raise ValueError(f"{len(draws)} draws for {num_rounds} rounds")
    elif generator is None:
        raise ValueError("pass generator= (a torch.Generator) or draws=")
    for i in range(num_rounds):
        if draws is not None:
            yield draws[i]
        else:
            yield sim.draw(generator, first_round + i)
