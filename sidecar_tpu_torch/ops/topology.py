"""Cluster topologies — the numpy builders of
``sidecar_tpu/ops/topology.py`` (``Topology``, ``complete``, ``ring``,
``erdos_renyi``), copied so both packages build bit-identical graphs
from the same seed.

A :class:`Topology` is a padded neighbour list ``nbrs[N, D]`` (int32,
padded with the node's own index) plus a degree vector ``deg[N]``;
``nbrs is None`` is the complete graph, sampled with a self-exclusion
shift so no O(N²) structure exists.  Builders run on the host in numpy
(one-time set-up, not the hot path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Peer adjacency for N nodes (``nbrs`` None = complete graph).

    ``stagger``/``stagger_period`` carry per-node round-phase offsets
    in the reference; the port does not run staggered rounds yet and
    its model raises on a topology that sets them."""

    n: int
    nbrs: Optional[np.ndarray] = None  # int32 [N, D], padded with self-index
    deg: Optional[np.ndarray] = None   # int32 [N]
    name: str = "complete"
    stagger: Optional[np.ndarray] = None  # int32 [N] phase offsets
    stagger_period: int = 1

    @property
    def max_degree(self) -> int:
        return 0 if self.nbrs is None else int(self.nbrs.shape[1])


def complete(n: int) -> Topology:
    """Fully-connected cluster — memberlist's random-member gossip."""
    return Topology(n=n, name="complete")


def ring(n: int, hops: int = 1) -> Topology:
    """Ring lattice: each node linked to ``hops`` neighbours per side."""
    offsets = [d for h in range(1, hops + 1) for d in (h, -h)]
    nbrs = np.stack(
        [(np.arange(n) + d) % n for d in offsets], axis=1
    ).astype(np.int32)
    deg = np.full(n, len(offsets), dtype=np.int32)
    return Topology(n=n, nbrs=nbrs, deg=deg, name=f"ring{hops}")


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> Topology:
    """Erdős–Rényi G(n, p) with p = avg_degree/(n-1).

    The same block-of-rows ``random((rows, n))`` draws as the reference
    builder, so the graph is bit-identical for the same seed: edges are
    sampled on the upper triangle, both directions kept, and a lexsort
    leaves every adjacency row ascending.  O(n²) random draws on the
    host — the cost of bit-identity (about two minutes at 100k nodes).
    Isolated nodes keep degree 0 and a self-padded row; samplers clamp
    the degree to 1, so such a node gossips with itself (a no-op).
    """
    rng = np.random.default_rng(seed)
    p = min(1.0, avg_degree / max(1, n - 1))
    srcs, dsts = [], []
    # Sample undirected edges in blocks of rows to bound memory.
    block = max(1, min(n, 4_000_000 // max(n, 1) + 1))
    for start in range(0, n, block):
        stop = min(n, start + block)
        rows = np.arange(start, stop)
        mask = rng.random((stop - start, n)) < p
        # Keep the upper triangle only (i < j) to avoid double-sampling.
        mask &= np.arange(n)[None, :] > rows[:, None]
        r, c = np.nonzero(mask)
        srcs.append(rows[r])
        dsts.append(c)
    i = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    j = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    # Both directions of every undirected edge, ascending per node.
    src = np.concatenate([i, j])
    dst = np.concatenate([j, i])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n).astype(np.int32)
    k = max(1, int(deg.max())) if n else 1
    nbrs = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    starts = np.cumsum(deg, dtype=np.int64) - deg
    col = np.arange(src.shape[0], dtype=np.int64) - starts[src]
    nbrs[src, col] = dst.astype(np.int32)
    return Topology(n=n, nbrs=nbrs, deg=deg, name=f"er{avg_degree:g}")
