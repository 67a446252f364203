"""What the port's models share: the checks at construction — the
device (the card unless the caller asks for the CPU) and the options not
ported yet, each of which raises naming its ROADMAP item — and the
drivers' draw schedule (:func:`round_draws`)."""

from __future__ import annotations

import torch

# Where each deferred constructor option is queued (ROADMAP.md, Queue 1).
DEFERRED = {
    "perturb": "Queue 1 item 8 (chaos and adversary)",
    "cut_mask": "Queue 1 item 8 (chaos and adversary)",
    "node_side": "Queue 1 item 8 (chaos and adversary)",
    "sparse": "Queue 1 item 6 (execution modes: sparse-frontier round)",
    "pipeline": "Queue 1 item 6 (execution modes: pipelined round)",
    "tick_period": "Queue 1 item 6 (execution modes: per-node tick cadence)",
    "stagger": "Queue 1 item 6 (execution modes: staggered rounds)",
}


def deferred(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet: ROADMAP.md {DEFERRED[option]}")


def reject_deferred(topo, *, tick_period=None, tick_phase=None,
                    **options) -> None:
    """Raise :func:`deferred` for the first option given that the port
    does not run yet: any of ``options`` (``perturb``, ``cut_mask``,
    ``node_side``, ``sparse``, ``pipeline``) not None, a tick cadence
    other than every round, or a staggered topology."""
    for name, value in options.items():
        if name not in DEFERRED:
            raise TypeError(f"unknown option {name!r}")
        if value is not None:
            raise deferred(name)
    if tick_period not in (None, 1) or tick_phase not in (None, 0):
        raise deferred("tick_period")
    if topo.stagger is not None and topo.stagger_period > 1:
        raise deferred("stagger")


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


def round_draws(sim, state, num_rounds: int, generator, draws):
    """Yield the draws of the next ``num_rounds`` rounds from ``state``:
    from ``draws`` when given (one per round), else from ``generator``
    through ``sim.draw``."""
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
            yield sim.draw(generator, state.round_idx + 1 + i)
