"""Shard groups and the board-exchange modes of the node-sharded round —
the port of ``sidecar_tpu/parallel/mesh.py``.

The reference splits the node axis over a device mesh and runs one
round body per device under ``shard_map``, with XLA collectives between
the phases.  The port runs the same body as phases over a loop of the
shards a process holds; a *shard group* supplies the collectives between
the phases.  Every group has one contract:

* ``d`` — the global shard count;
* ``rank`` and ``world`` — this process's place among the processes of
  the group, and ``local`` — the shard indices it holds, the contiguous
  range ``[rank·dl, (rank+1)·dl)`` with ``dl = d / world``;
* the shard collectives (``all_gather``, ``all_to_all``, ``ppermute``,
  ``pmax``, ``psum``) take one tensor per LOCAL shard and return one
  tensor per local shard;
* the row collectives of the global phases, on a rank's node rows
  (``gather_rows``, ``shift_rows``; ``fetch_rows`` and
  ``scatter_max_rows``, which read or max-fold rows named by global id,
  whatever rank holds them) or on a tensor every rank holds whole
  (``all_reduce_max``, ``all_reduce_sum``).

:class:`LocalShardGroup` is the one-rank case: all ``d`` shards on one
device, every collective a tensor operation on that device and every row
collective the identity (``shift_rows`` a ``torch.roll``).
:class:`~sidecar_tpu_torch.parallel.dist.DistShardGroup` is the group
over ``torch.distributed`` ranks (``parallel/dist.py``), each rank
holding only its shards' rows.
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


def local_rows(group, n: int) -> slice:
    """The global node rows ``group``'s rank holds, of ``n``: its shards'
    contiguous rows."""
    per = n // group.world
    return slice(group.rank * per, (group.rank + 1) * per)


class LocalShardGroup:
    """``d`` shards on one device, with the collectives of the sharded
    round: the group of one rank.  A collective whose result every shard
    receives alike returns the same tensor object ``d`` times (no shard
    writes to it)."""

    rank = 0
    world = 1

    def __init__(self, d: int):
        if d < 1:
            raise ValueError(f"a shard group needs d >= 1, got {d}")
        self.d = d
        self.dl = d
        self.local = tuple(range(d))

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

    # -- the row collectives of the global phases ---------------------------

    @staticmethod
    def gather_rows(x):
        """Every rank's node rows, in rank order: here ``x`` itself."""
        return x

    @staticmethod
    def shift_rows(x, k: int):
        """Row ``i`` of the result is global row ``(i + k) mod N``."""
        return torch.roll(x, -k, 0)

    @staticmethod
    def fetch_rows(x, idx):
        """Rows ``idx`` (int64 global row ids) of the global tensor:
        ``x[idx]``."""
        return x[idx]

    @staticmethod
    def scatter_max_rows(x, idx, vals):
        """Fold row ``vals[i]`` into row ``idx[i]`` of ``x`` by an
        elementwise max, in place; returns ``x``."""
        return x.scatter_reduce_(0, idx[:, None].expand_as(vals), vals,
                                 "amax")

    @staticmethod
    def all_reduce_max(x):
        """The elementwise max of ``x`` over the ranks: ``x``."""
        return x

    @staticmethod
    def all_reduce_sum(x):
        """The elementwise sum of ``x`` over the ranks: ``x``."""
        return x


def resolve_group(group, d: int):
    """``group``, checked to hold ``d`` shards; None is the one-process
    :class:`LocalShardGroup`."""
    if group is None:
        return LocalShardGroup(d)
    if group.d != d:
        raise ValueError(f"the shard group holds d={group.d} shards, the "
                         f"sim was given d={d}")
    return group

