"""What the port's models share: the checks at construction — the
device (the card unless the caller asks for the CPU), the tick cadence
(:func:`resolve_cadence`) and the partition cut (:func:`cut_tensor`) —
the scenario hook's call (:func:`apply_perturb`), the draw schedule
of the ``run*`` methods (:func:`round_draws`) and the convergence
metric's float32 sum (:func:`alive_mean`)."""

from __future__ import annotations

import numpy as np
import torch


def apply_perturb(perturb, state, now: int, kn, rows=None):
    """Run the scenario hook ``perturb`` on ``state`` before the round's
    sample, as the reference does: ``perturb(state, now)``, or
    ``perturb(state, now, kn)`` when the hook sets ``wants_knobs``.

    The hook contract of the port: the reference hands its hook the
    round's ``k_perturb`` key, and the port draws no threefry, so a
    port hook takes its randomness from a generator of its own (or from
    masks it was given).  It returns the state; on the exact model it
    may write ``known`` and ``sent`` in place.  None returns ``state``
    untouched.

    A hook that sets ``row_local`` may run on a rank's rows of a
    sharded state: it is called with ``rows=``, the global node rows
    the node-major leaves of ``state`` hold (a ``slice``; None where
    the caller names no range: every node), and touches only those
    rows."""
    if perturb is None:
        return state
    kw = {"rows": rows} if getattr(perturb, "row_local", False) else {}
    if getattr(perturb, "wants_knobs", False):
        return perturb(state, now, kn, **kw)
    return perturb(state, now, **kw)


def cut_tensor(cut_mask, topo, device):
    """``cut_mask`` (bool ``[N, D]``, the partitioned edges of ``topo``'s
    neighbour list) as a bool tensor on ``device``; None stays None.  A
    complete graph has no edges to cut and raises."""
    if cut_mask is None:
        return None
    if topo.nbrs is None:
        raise ValueError(
            "cut_mask requires a neighbor-list topology (mesh/ring/ER/BA);"
            " a complete graph has no edge structure to cut")
    cut = torch.as_tensor(np.asarray(cut_mask, dtype=bool), device=device)
    if tuple(cut.shape) != tuple(np.shape(topo.nbrs)):
        raise ValueError(f"cut_mask must be shaped like the neighbour list "
                         f"{tuple(np.shape(topo.nbrs))}, got "
                         f"{tuple(cut.shape)}")
    return cut


def side_tensor(node_side, n: int, device):
    """``node_side`` (int ``[N]``, each node's side of a partition) as an
    int32 tensor on ``device``; None stays None."""
    if node_side is None:
        return None
    side = torch.as_tensor(np.asarray(node_side, dtype=np.int32),
                           device=device)
    if tuple(side.shape) != (n,):
        raise ValueError(f"node_side must be [{n}], got {tuple(side.shape)}")
    return side


def exchange_ok(alive, side, roll_amt: int):
    """The stride push-pull's pairing gate: node i and the node
    ``roll_amt`` rolls onto it exchange where both are alive and, with
    partition sides ``side`` (None: no sides), on one side."""
    ok = alive & torch.roll(alive, roll_amt, 0)
    if side is not None:
        ok = ok & (side == torch.roll(side, roll_amt, 0))
    return ok


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


# The reference's CPU backend sums a float32 row of up to this many
# values one after another, in index order.
SEQUENTIAL_SUM_MAX = 32


def alive_mean(agree, m: int, alive):
    """The convergence metric from each node's count of agreeing cells
    (int ``[..., N]`` of ``m`` cells) and its liveness: the mean agreement
    of the alive nodes, float32, computed as the reference's compiled
    program computes it — each node's mean as ``count · fl32(1/m)``,
    their alive-weighted sum over the last axis, over the alive count.
    The sum's order is the same on every device: in index order for at
    most :data:`SEQUENTIAL_SUM_MAX` nodes (the reference's CPU order, so
    the value is its bit for bit), else in float64 — exact for these
    values at the sizes run — rounded to float32 once.  (``torch.sum``
    orders a float32 sum differently on the CPU and on the card.)"""
    alive_f = alive.to(torch.float32)
    x = agree.to(torch.float32) * float(np.float32(1.0 / m)) * alive_f
    n = x.shape[-1]
    if n <= SEQUENTIAL_SUM_MAX:
        total = x[..., 0]
        for i in range(1, n):
            total = total + x[..., i]
    else:
        total = x.to(torch.float64).sum(dim=-1).to(torch.float32)
    return total / torch.clamp(alive_f.sum(dim=-1), min=1.0)
