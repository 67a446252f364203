"""Peer sampling, the refresh stagger, and the round's random draws —
the port of ``PHASE_MULT``, ``refresh_phase``, ``refresh_due`` and
``sample_peers`` from ``sidecar_tpu/ops/gossip.py``, plus the one seam
all randomness of a round passes through (:class:`RoundDraws`).

The reference draws from ``jax.random`` keys inside the round.  The
port draws from an explicit ``torch.Generator`` through
:func:`draw_round` instead; the two streams differ, so a caller that
needs the reference's exact trajectory hands the round its draws
directly (the drivers' ``draws=`` argument) — that is how the lockstep
tests feed in the JAX draws.

uint32 arithmetic: torch has no full uint32 multiply, so products are
taken in int64 and masked to their low 32 bits (exact: the low 32 bits
of a wrapped product do not depend on the high ones).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sidecar_tpu_torch.ops.status import unpack_ts

# Knuth's multiplicative constant — the slot-phase spreader for the
# refresh stagger and the publish tie rotation.
PHASE_MULT = 2654435761
MASK32 = 0xFFFFFFFF


def refresh_phase(slots, refresh_rounds: int):
    """Deterministic per-slot refresh phase in ``[0, refresh_rounds)``:
    ``(uint32(slot) · PHASE_MULT mod 2³²) mod refresh_rounds``."""
    u = (slots.to(torch.int64) * PHASE_MULT) & MASK32
    return (u % refresh_rounds).to(torch.int32)


def refresh_due(own, slots, round_idx: int, *, refresh_rounds: int,
                round_ticks: int, now: int):
    """True where an owner's record hits its periodic re-announce this
    round: on its hash-spread phase round, and only once ``now - ts``
    clears a quarter of the interval.  Callers AND the result with their
    own present/non-tombstone masks."""
    at_phase = (round_idx % refresh_rounds) == refresh_phase(
        slots, refresh_rounds)
    guard = (refresh_rounds * round_ticks) // 4
    elapsed = now - unpack_ts(own)
    return at_phase & (elapsed >= guard)


@dataclasses.dataclass(frozen=True)
class RoundDraws:
    """Every random draw one round consumes.

    ``peer_slot`` is the sampled neighbour-list column per (node, fanout
    leg) — or, on a complete graph, the draw in ``[0, N-1)`` that the
    self-exclusion shift turns into a peer id; ``stride`` the push-pull
    partner offset in ``[1, N)`` (0 on rounds without push-pull);
    ``keep`` the packet-loss keep mask (None when ``drop_prob == 0``)."""

    peer_slot: torch.Tensor                 # int32 [N, F]
    stride: int
    keep: Optional[torch.Tensor] = None     # bool [N, F, K]


def draw_round(generator: torch.Generator, n: int, fanout: int, *,
               deg=None, push_pull: bool = True, keep_prob: float = 1.0,
               cache_lines: int = 0) -> RoundDraws:
    """Draw one round from ``generator`` on the generator's device.

    ``deg`` (int [N]) selects neighbour-list sampling, uniform over
    ``[0, max(deg, 1))`` per node; None is the complete graph.  The
    stride is drawn only when ``push_pull`` (it is a host int, so a CUDA
    generator synchronises for it); the keep mask only when
    ``keep_prob < 1``."""
    dev = generator.device
    if deg is None:
        slot = torch.randint(0, n - 1, (n, fanout), generator=generator,
                             device=dev, dtype=torch.int32)
    else:
        hi = torch.clamp(deg.to(dev, torch.int64), min=1)[:, None]
        u = torch.rand((n, fanout), generator=generator, device=dev,
                       dtype=torch.float64)
        slot = torch.minimum((u * hi).to(torch.int64), hi - 1)
        slot = slot.to(torch.int32)
    stride = 0
    if push_pull:
        stride = int(torch.randint(1, n, (1,), generator=generator,
                                   device=dev))
    keep = None
    if keep_prob < 1.0:
        keep = torch.rand((n, fanout, cache_lines), generator=generator,
                          device=dev) < keep_prob
    return RoundDraws(peer_slot=slot, stride=stride, keep=keep)


def sample_peers(peer_slot, n: int, *, nbrs=None, node_alive=None):
    """Resolve a round's ``peer_slot`` draws to gossip targets
    ``dst[int32 N, F]``.  Dead senders resolve to their own index (a
    self-send is a merge no-op).

    ``nbrs`` (int32 [N, D]) is the padded neighbour list; None is the
    complete graph, where the draw ``r`` in ``[0, N-1)`` becomes
    ``r + (r >= self)``."""
    self_idx = torch.arange(n, dtype=torch.int32,
                            device=peer_slot.device)[:, None]
    if nbrs is None:
        dst = peer_slot + (peer_slot >= self_idx).to(torch.int32)
    else:
        dst = torch.gather(nbrs, 1, peer_slot.to(torch.int64))
    if node_alive is not None:
        dst = torch.where(node_alive[:, None], dst, self_idx)
    return dst
