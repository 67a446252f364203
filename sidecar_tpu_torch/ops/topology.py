"""Cluster topologies — the numpy builders of
``sidecar_tpu/ops/topology.py`` (``Topology``, ``complete``, ``ring``,
``erdos_renyi``, ``mesh2d``, ``with_stagger``, ``partition_mask``),
copied so both packages build
bit-identical graphs from the same seed, the overlay-name resolver
(``from_name``, over the families the port has), and the static plan of
the sharded round's zoned board exchange (``zoned_exchange_plan``).

A :class:`Topology` is a padded neighbour list ``nbrs[N, D]`` (int32,
padded with the node's own index) plus a degree vector ``deg[N]``;
``nbrs is None`` is the complete graph, sampled with a self-exclusion
shift so no O(N²) structure exists.  Builders run on the host in numpy
(one-time set-up, not the hot path).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from sidecar_tpu_torch import metrics


@dataclasses.dataclass(frozen=True)
class Topology:
    """Peer adjacency for N nodes (``nbrs`` None = complete graph).

    ``stagger``/``stagger_period`` are per-node round-phase offsets
    (:func:`with_stagger`): node i gossips only on rounds where
    ``(round + stagger[i]) % stagger_period == 0``."""

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


def mesh2d(rows: int, cols: int) -> Topology:
    """2-D grid mesh with 4-neighbour connectivity (config 5's 1M-node
    partitioned mesh is a split mesh2d), built vectorised: the
    candidate neighbours in the four directions, those off the grid
    padded with self, the valid ones moved to the front of each row in
    the order up, down, left, right."""
    n = rows * cols
    idx = np.arange(n, dtype=np.int32).reshape(rows, cols)
    self_col = idx.reshape(n)
    cand = np.tile(self_col[:, None], (1, 4))
    valid = np.zeros((n, 4), dtype=bool)
    up = np.roll(idx, 1, axis=0).reshape(n)
    down = np.roll(idx, -1, axis=0).reshape(n)
    left = np.roll(idx, 1, axis=1).reshape(n)
    right = np.roll(idx, -1, axis=1).reshape(n)
    rr = np.repeat(np.arange(rows), cols)
    cc = np.tile(np.arange(cols), rows)
    for k, (nbr, ok) in enumerate((
            (up, rr > 0), (down, rr < rows - 1),
            (left, cc > 0), (right, cc < cols - 1))):
        cand[:, k] = np.where(ok, nbr, self_col)
        valid[:, k] = ok
    order = np.argsort(~valid, axis=1, kind="stable")
    nbrs = np.take_along_axis(cand, order, axis=1)
    deg = valid.sum(axis=1).astype(np.int32)
    pad = np.arange(4)[None, :] >= deg[:, None]
    nbrs = np.where(pad, self_col[:, None], nbrs).astype(np.int32)
    return Topology(n=n, nbrs=nbrs, deg=deg, name=f"mesh{rows}x{cols}")


def partition_mask(topo: Topology, side_of: np.ndarray) -> np.ndarray:
    """Bool ``[N, D]`` mask of the edges crossing a partition: ``side_of
    [n]`` assigns each node a side, and an edge is cut where its ends
    differ.  A model takes it as ``cut_mask`` while the split holds."""
    if topo.nbrs is None:
        raise ValueError("partition_mask requires an explicit neighbor list")
    side_of = np.asarray(side_of)
    return side_of[topo.nbrs] != side_of[:, None]


def with_stagger(topo: Topology, period: int,
                 offsets: Optional[np.ndarray] = None,
                 seed: int = 0) -> Topology:
    """Attach per-node round-stagger offsets: node i gossips only when
    ``(round + offsets[i]) % period == 0``.  ``offsets`` defaults to the
    reference's seeded uniform draw over ``[0, period)``; a period of at
    most 1 strips any stagger."""
    if period <= 1:
        return dataclasses.replace(topo, stagger=None, stagger_period=1)
    if offsets is None:
        offsets = np.random.default_rng(seed).integers(
            0, period, size=topo.n)
    offsets = np.asarray(offsets, dtype=np.int32)
    if offsets.shape != (topo.n,):
        raise ValueError(
            f"stagger offsets must be shape ({topo.n},), got {offsets.shape}")
    return dataclasses.replace(topo, stagger=offsets,
                               stagger_period=int(period))


# The reference's overlay families; the port builds complete, ring, er
# and mesh.
_NAME_RE = re.compile(
    r"(complete|chord)"
    r"|ring(\d+)|expander(\d+)|er(\d+(?:\.\d+)?)|ba(\d+)"
    r"|zoned(\d+)|mesh(\d+)x(\d+)")


def from_name(name: str, n: int, seed: int = 0) -> Topology:
    """An overlay by NAME, as the reference's ``from_name`` resolves it:
    ``complete``, ``ring<hops>``, ``er<avg degree>`` (seeded) and
    ``mesh<rows>x<cols>``, and the resolution counted as
    ``topology.from_name.<family>``.  The reference's other families
    (``chord``, ``expander<k>``, ``ba<m>``, ``zoned<z>``) are not in the
    port and raise, as does an unknown name."""
    s = str(name).strip().lower()
    m = _NAME_RE.fullmatch(s)
    if m is None:
        raise ValueError(f"unknown topology {name!r}: the port builds "
                         "complete, ring<hops>, er<avg degree> and "
                         "mesh<rows>x<cols>")
    if m.group(1) == "complete":
        family, topo = "complete", complete(n)
    elif m.group(2):
        family, topo = "ring", ring(n, hops=int(m.group(2)))
    elif m.group(4):
        family, topo = "er", erdos_renyi(n, avg_degree=float(m.group(4)),
                                         seed=seed)
    elif m.group(7):
        r, c = int(m.group(7)), int(m.group(8))
        if r * c != n:
            raise ValueError(
                f"topology {name!r} invalid for n={n}: mesh{r}x{c} has "
                f"{r * c} nodes, cluster has {n}")
        family, topo = "mesh", mesh2d(r, c)
    else:
        raise ValueError(f"topology {name!r} is not in the port: it builds "
                         "complete, ring<hops>, er<avg degree> and "
                         "mesh<rows>x<cols>")
    metrics.incr(f"topology.from_name.{family}")
    return topo


# -- the zoned board-exchange plan --------------------------------------------


@dataclasses.dataclass(frozen=True)
class ZonedHop:
    """One hop of the zoned exchange: the static per-sender-shard row
    blocks shipped at ring offset h (shard s → shard (s-h) mod d).

    ``rows[d, R]`` are each sender shard's local row ids (0-padded past
    ``valid``); ``pos[d, nl]`` inverts them (local row → block position,
    R for absent rows — the receiver's lookup in the pull fold)."""

    rows: np.ndarray   # int32 [d, R]
    valid: np.ndarray  # bool  [d, R]
    pos: np.ndarray    # int32 [d, nl]

    @property
    def width(self) -> int:
        return int(self.rows.shape[1])


@dataclasses.dataclass(frozen=True)
class ZonedExchangePlan:
    """Static reachability tables for ``board_exchange="zoned"``: which
    of each shard's rows the overlay can make another shard sample.
    ``hops[h-1]`` is the block plan for ring offset h (None when no
    ordered pair needs that offset and the hop is skipped).

    ``direction="push"`` marks row r of shard s reachable into shard t
    when some neighbour of r lives on t; ``"pull"`` (the compressed
    twin: boards are pulled by samplers) when some node of t has r in
    its neighbour table.  Either way the set is a static superset of
    every cross-shard (sender, receiver) pair a round can sample, which
    is what makes the mode give ``all_gather``'s result."""

    d: int
    nl: int
    direction: str
    hops: tuple  # tuple[Optional[ZonedHop]], length d-1

    @property
    def total_rows(self) -> int:
        """Σ hop widths — the rows a shard receives each round."""
        return sum(h.width for h in self.hops if h is not None)


def zoned_exchange_plan(topo: Topology, d: int,
                        direction: str = "push") -> ZonedExchangePlan:
    """Build the static per-(sender shard, ring offset) row-block tables
    of the zoned board exchange (see :class:`ZonedExchangePlan`).
    Requires a neighbour-list topology: the complete graph reaches every
    shard, which is the ``all_gather`` this mode exists to shrink."""
    if topo.nbrs is None:
        raise ValueError(
            "zoned exchange requires a neighbor-list topology: the "
            "complete graph reaches every shard (use all_gather there)")
    if direction not in ("push", "pull"):
        raise ValueError(f"direction must be push|pull, got {direction!r}")
    n = topo.n
    if n % d:
        raise ValueError(f"n={n} must divide into {d} shards")
    nl = n // d
    width = topo.nbrs.shape[1]
    edge_ok = np.arange(width)[None, :] < topo.deg[:, None]
    src = np.repeat(np.arange(n, dtype=np.int64), width)[edge_ok.ravel()]
    tgt = topo.nbrs.ravel().astype(np.int64)[edge_ok.ravel()]
    if direction == "push":
        rows_of, needed_by = src, tgt // nl
    else:
        rows_of, needed_by = tgt, src // nl
    reach = np.zeros((n, d), dtype=bool)
    reach[rows_of, needed_by] = True
    reach[np.arange(n), np.arange(n) // nl] = False  # own shard is local
    hops = []
    for h in range(1, d):
        blocks = [np.nonzero(reach[s * nl:(s + 1) * nl, (s - h) % d])[0]
                  for s in range(d)]
        r = max((len(b) for b in blocks), default=0)
        if r == 0:
            hops.append(None)
            continue
        rows = np.zeros((d, r), dtype=np.int32)
        valid = np.zeros((d, r), dtype=bool)
        pos = np.full((d, nl), r, dtype=np.int32)
        for s, b in enumerate(blocks):
            rows[s, :len(b)] = b
            valid[s, :len(b)] = True
            pos[s, b] = np.arange(len(b), dtype=np.int32)
        hops.append(ZonedHop(rows=rows, valid=valid, pos=pos))
    return ZonedExchangePlan(d=d, nl=nl, direction=direction,
                             hops=tuple(hops))
