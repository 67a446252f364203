"""Shard groups and the board-exchange modes of the node-sharded round —
the port of ``sidecar_tpu/parallel/mesh.py``.

The reference splits the node axis over a device mesh and runs one
round body per device under ``shard_map``, with XLA collectives between
the phases.  The port runs the same body as phases over a loop of
shards; a *shard group* supplies the collectives between the phases.
Every collective takes one tensor per shard (a list of ``d``) and
returns one tensor per shard.

:class:`LocalShardGroup` holds all ``d`` shards on one device, so a
collective is a tensor operation on that device.  A group over several
cards (``torch.distributed`` with NCCL, each rank holding one shard and
exchanging through the same method names) is where a multi-card run
plugs in later.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sidecar_tpu_torch import metrics

# The cross-shard board exchange of the sharded round (the reference's
# docs/sharding.md): the whole board to every shard, the sampled rows
# only, a ring of block hops, or the overlay's statically reachable
# blocks only.
BOARD_EXCHANGES = ("all_gather", "all_to_all", "ring", "zoned")


def resolve_board_exchange(explicit: Optional[str] = None, *,
                           supported: Sequence[str] = BOARD_EXCHANGES
                           ) -> str:
    """The board-exchange mode: the explicit argument, ``all_gather``
    when it is None, counted as ``parallel.exchange.mode.<mode>``.  A
    mode the twin does not support raises.  (The reference also reads
    an environment variable, and counts its fallback; the port reads
    none.)"""
    mode = "all_gather" if explicit is None else explicit
    if mode not in supported:
        raise ValueError(f"board_exchange must be one of {tuple(supported)}, "
                         f"got {mode!r}")
    metrics.incr(f"parallel.exchange.mode.{mode}")
    return mode


class LocalShardGroup:
    """``d`` shards on one device, with the collectives of the sharded
    round.  A collective whose result every shard receives alike returns
    the same tensor object ``d`` times (no shard writes to it)."""

    def __init__(self, d: int):
        if d < 1:
            raise ValueError(f"a shard group needs d >= 1, got {d}")
        self.d = d

    def _check(self, xs):
        if len(xs) != self.d:
            raise ValueError(f"expected one tensor per shard ({self.d}), "
                             f"got {len(xs)}")

    def all_gather(self, xs):
        """Every shard's block, concatenated along dim 0 (tiled)."""
        self._check(xs)
        full = xs[0] if self.d == 1 else torch.cat(xs)
        return [full] * self.d

    def all_to_all(self, xs):
        """Each ``xs[j]`` is ``[d, ...]``: ``out[s][j] = xs[j][s]``."""
        self._check(xs)
        return [torch.stack([x[s] for x in xs]) for s in range(self.d)]

    def ppermute(self, xs, perm):
        """``perm`` holds ``(source, destination)`` shard pairs; a shard
        that no pair names as destination receives zeros."""
        self._check(xs)
        out = [None] * self.d
        for src, dst in perm:
            out[dst] = xs[src]
        return [torch.zeros_like(xs[s]) if o is None else o
                for s, o in enumerate(out)]

    def pmax(self, xs):
        """Elementwise max over the ``d`` replicas (stacked)."""
        self._check(xs)
        m = torch.stack(xs).amax(dim=0)
        return [m] * self.d

    def psum(self, xs):
        """Elementwise sum over the ``d`` shards (stacked)."""
        self._check(xs)
        total = torch.stack(xs).sum(dim=0)
        return [total] * self.d
