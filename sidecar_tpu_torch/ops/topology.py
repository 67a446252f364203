"""Cluster topologies — the numpy builders of
``sidecar_tpu/ops/topology.py`` (``Topology``, ``complete``, ``ring``,
``erdos_renyi``, ``barabasi_albert``, ``mesh2d``, ``ring_chord``,
``expander``, ``zoned``, ``with_stagger``, ``partition_mask``), copied so
both packages build bit-identical graphs from the same seed; the
connectivity repair (``components``, ``repair``); the overlay-name
resolver (``from_name``, every family of ``topology_names``); and the
static plan of the sharded round's zoned board exchange
(``zoned_exchange_plan``).

A :class:`Topology` is a padded neighbour list ``nbrs[N, D]`` (int32,
padded with the node's own index) plus a degree vector ``deg[N]``;
``nbrs is None`` is the complete graph, sampled with a self-exclusion
shift so no O(N²) structure exists.  Builders run on the host in numpy
(one-time set-up, not the hot path).
"""

from __future__ import annotations

import dataclasses
import os
import re
from concurrent.futures import ThreadPoolExecutor
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
    host — the cost of bit-identity.  The blocks are drawn on a pool of
    threads, each from the seed's PCG64 stream advanced to its block's
    first draw (one draw a double), so the draws are the reference's
    single stream, cut into pieces.  Isolated nodes keep degree 0 and a
    self-padded row; samplers clamp the degree to 1, so such a node
    gossips with itself (a no-op).
    """
    p = min(1.0, avg_degree / max(1, n - 1))
    # Sample undirected edges in blocks of rows to bound memory.
    block = max(1, min(n, 4_000_000 // max(n, 1) + 1))

    def block_edges(start):
        stop = min(n, start + block)
        bits = np.random.PCG64(seed)      # default_rng(seed)'s stream
        bits.advance(start * n)
        rows = np.arange(start, stop)
        mask = np.random.Generator(bits).random((stop - start, n)) < p
        # Keep the upper triangle only (i < j) to avoid double-sampling.
        mask &= np.arange(n)[None, :] > rows[:, None]
        r, c = np.nonzero(mask)
        return rows[r], c

    starts = range(0, n, block)
    workers = max(1, min(8, len(starts), os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(block_edges, starts))
    i = np.concatenate([r for r, _ in parts]) if parts \
        else np.zeros(0, np.int64)
    j = np.concatenate([c for _, c in parts]) if parts \
        else np.zeros(0, np.int64)
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


def _pad_neighbor_list(n: int, adj: list, name: str) -> Topology:
    """A :class:`Topology` from adjacency lists, each row padded with the
    node's own index."""
    deg = np.array([len(a) for a in adj], dtype=np.int32)
    k = max(1, int(deg.max()))
    nbrs = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    for i, a in enumerate(adj):
        if a:
            nbrs[i, : len(a)] = np.asarray(a, dtype=np.int32)
    return Topology(n=n, nbrs=nbrs, deg=deg, name=name)


def barabasi_albert(n: int, m: int, seed: int = 0) -> Topology:
    """Barabási–Albert scale-free graph, ``m`` edges per new node
    (config 4): degree-proportional attachment through the
    repeated-endpoint list, the reference's draws in its order."""
    rng = np.random.default_rng(seed)
    adj: list = [[] for _ in range(n)]
    repeated: list = []
    for v in range(m, n):
        chosen = set()
        while len(chosen) < min(m, v):
            if repeated and rng.random() < 0.9:
                cand = repeated[rng.integers(len(repeated))]
            else:
                cand = int(rng.integers(v))
            chosen.add(cand)
        for t in chosen:
            adj[v].append(t)
            adj[t].append(v)
            repeated.extend((v, t))
    return _pad_neighbor_list(n, adj, f"ba{m}")


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


def ring_chord(n: int) -> Topology:
    """Ring ±1 plus symmetric power-of-two chord fingers (±2, ±4, …):
    the O(log n)-diameter structured overlay, every finger both ways."""
    offsets = [1, -1]
    f = 2
    while f <= (n - 1) // 2:
        offsets.extend((f, -f))
        f *= 2
    idx = np.arange(n, dtype=np.int32)
    cols, seen = [], set()
    for d in offsets:
        d_mod = d % n
        if d_mod == 0 or d_mod in seen:
            continue
        seen.add(d_mod)
        cols.append((idx + d) % n)
    nbrs = np.stack(cols, axis=1).astype(np.int32)
    deg = np.full(n, nbrs.shape[1], dtype=np.int32)
    return Topology(n=n, nbrs=nbrs, deg=deg, name="chord")


def expander(n: int, k: int = 4, seed: int = 0) -> Topology:
    """Random k-regular-ish expander: the union of ``k // 2`` seeded
    Hamiltonian cycles, coincident edges deduplicated per node (so
    ``deg`` may dip below k on small n)."""
    if k < 2 or k % 2:
        raise ValueError(f"expander degree k must be even and >= 2, got {k}")
    rng = np.random.default_rng(seed)
    adj: list = [[] for _ in range(n)]
    for _ in range(k // 2):
        perm = rng.permutation(n)
        nxt = np.roll(perm, -1)
        for a, b in zip(perm, nxt):
            a, b = int(a), int(b)
            if b not in adj[a]:
                adj[a].append(b)
            if a not in adj[b]:
                adj[b].append(a)
    return _pad_neighbor_list(n, adj, f"expander{k}")


def zoned(n: int, zones: int, *, local_hops: int = 2, remote_deg: int = 2,
          local_bias: float = 0.5, gateways: int = 2,
          seed: int = 0) -> Topology:
    """Zone-aware two-tier sampling table: ``zones`` contiguous blocks,
    a within-zone ring lattice (``local_hops`` each side, replicated so
    the local share of a row approximates ``local_bias``), ``remote_deg``
    seeded links a node into ONE other zone, and ``gateways`` nodes of
    each zone linked both ways to their twins in the neighbouring
    zones, so the overlay is connected by construction."""
    if n % zones:
        raise ValueError(f"zones={zones} must divide n={n}")
    zl = n // zones
    if zl < 2:
        raise ValueError(f"zoned needs >= 2 nodes per zone, got {zl}")
    if not 0.0 < local_bias < 1.0:
        raise ValueError(f"local_bias must be in (0, 1), got {local_bias}")
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int32)
    zone_of = idx // zl
    z0 = zone_of * zl
    pos = idx - z0

    hops = [h for step in range(1, local_hops + 1) for h in (step, -step)]
    local_cols = []
    seen_off = set()
    for h in hops:
        if h % zl == 0 or (h % zl) in seen_off:
            continue
        seen_off.add(h % zl)
        local_cols.append(z0 + (pos + h) % zl)
    local = np.stack(local_cols, axis=1).astype(np.int32)

    if zones < 2:
        raise ValueError("zoned needs >= 2 zones for the remote tier")
    tz = rng.integers(0, zones - 1, size=n)
    tz = tz + (tz >= zone_of)
    rr = rng.integers(0, zl, size=(n, remote_deg))
    remote = (tz[:, None] * zl + rr).astype(np.int32)

    gw = min(gateways, zl)
    gcols = np.full((n, 2), -1, dtype=np.int32)
    is_gw = pos < gw
    gcols[is_gw, 0] = (idx[is_gw] + zl) % n
    gcols[is_gw, 1] = (idx[is_gw] - zl) % n

    width_l, width_r = local.shape[1], remote.shape[1]
    best_r, best_err = 1, float("inf")
    for r in range(1, 9):
        err = abs(r * width_l / (r * width_l + width_r) - local_bias)
        if err < best_err - 1e-12:
            best_r, best_err = r, err
    row_parts = np.concatenate([local] * best_r + [remote], axis=1)
    width = row_parts.shape[1] + 2
    nbrs = np.tile(idx[:, None], (1, width))
    nbrs[:, :row_parts.shape[1]] = row_parts
    deg = np.full(n, row_parts.shape[1], dtype=np.int32)
    has_g = gcols >= 0
    for g in range(2):
        sel = has_g[:, g]
        nbrs[sel, deg[sel]] = gcols[sel, g]
        deg[sel] += 1
    pad = np.arange(width)[None, :] >= deg[:, None]
    nbrs = np.where(pad, idx[:, None], nbrs).astype(np.int32)
    return Topology(n=n, nbrs=nbrs, deg=deg, name=f"zoned{zones}")


def components(topo: Topology) -> np.ndarray:
    """Connected-component label per node (int32 ``[N]``, each label the
    minimum member id), by min-label propagation with pointer jumping."""
    if topo.nbrs is None:
        return np.zeros(topo.n, dtype=np.int32)
    n = topo.n
    width = topo.nbrs.shape[1]
    edge_ok = np.arange(width)[None, :] < topo.deg[:, None]
    src = np.repeat(np.arange(n, dtype=np.int64), width)[edge_ok.ravel()]
    dst = topo.nbrs.ravel().astype(np.int64)[edge_ok.ravel()]
    label = np.arange(n, dtype=np.int64)
    while True:
        new = label.copy()
        if src.size:
            np.minimum.at(new, src, label[dst])
            np.minimum.at(new, dst, label[src])
        while True:
            hop = new[new]
            if np.array_equal(hop, new):
                break
            new = hop
        if np.array_equal(new, label):
            return label.astype(np.int32)
        label = new


def repair(topo: Topology) -> Topology:
    """Chain a fragmented overlay's connected components into one: the
    components in order of their minimum member id, each link joining
    the two components' minimum-degree nodes (ties to the lowest id).
    Adds exactly ``components - 1`` undirected edges and renames the
    overlay ``{name}+r``; a connected topology comes back unchanged."""
    if topo.nbrs is None:
        return topo
    label = components(topo)
    reps_of = {}
    for comp in np.unique(label):
        members = np.nonzero(label == comp)[0]
        d = topo.deg[members]
        reps_of[int(comp)] = int(members[int(np.argmin(d))])
    if len(reps_of) <= 1:
        return topo
    reps = [reps_of[c] for c in sorted(reps_of)]
    n = topo.n
    deg = topo.deg.astype(np.int32).copy()
    extra = np.zeros(n, dtype=np.int32)
    for a, b in zip(reps, reps[1:]):
        extra[a] += 1
        extra[b] += 1
    width = max(topo.nbrs.shape[1], int((deg + extra).max()))
    nbrs = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width))
    nbrs[:, : topo.nbrs.shape[1]] = topo.nbrs
    for a, b in zip(reps, reps[1:]):
        nbrs[a, deg[a]] = b
        deg[a] += 1
        nbrs[b, deg[b]] = a
        deg[b] += 1
    pad = np.arange(width)[None, :] >= deg[:, None]
    nbrs = np.where(pad, np.arange(n, dtype=np.int32)[:, None], nbrs)
    return dataclasses.replace(topo, nbrs=nbrs.astype(np.int32), deg=deg,
                               name=f"{topo.name}+r")


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


def topology_names() -> tuple:
    """The name families :func:`from_name` resolves — ``{x}`` marks an
    integer parameter baked into the name (``ring2``, ``zoned64``, …)."""
    return ("complete", "ring{h}", "chord", "expander{k}", "er{deg}",
            "ba{m}", "zoned{z}", "mesh{r}x{c}")


_NAME_RE = re.compile(
    r"(complete|chord)"
    r"|ring(\d+)|expander(\d+)|er(\d+(?:\.\d+)?)|ba(\d+)"
    r"|zoned(\d+)|mesh(\d+)x(\d+)")


def from_name(name: str, n: int, seed: int = 0) -> Topology:
    """Resolve an overlay NAME into a built :class:`Topology`, as the
    reference's ``from_name`` does — deterministic for a (name, n, seed)
    triple, so a grid point and its unbatched rerun build the same
    overlay — and count the resolution as
    ``topology.from_name.<family>``.  Raises the reference's named
    ``ValueError`` for an unknown name or one invalid for ``n``."""
    s = str(name).strip().lower()
    m = _NAME_RE.fullmatch(s)
    if m is None:
        raise ValueError(
            f"unknown topology {name!r}: known families are "
            f"{', '.join(topology_names())}")
    try:
        if m.group(1) == "complete":
            family, topo = "complete", complete(n)
        elif m.group(1) == "chord":
            family, topo = "chord", ring_chord(n)
        elif m.group(2):
            family, topo = "ring", ring(n, hops=int(m.group(2)))
        elif m.group(3):
            family, topo = "expander", expander(n, k=int(m.group(3)),
                                                seed=seed)
        elif m.group(4):
            family, topo = "er", erdos_renyi(
                n, avg_degree=float(m.group(4)), seed=seed)
        elif m.group(5):
            family, topo = "ba", barabasi_albert(n, m=int(m.group(5)),
                                                 seed=seed)
        elif m.group(6):
            family, topo = "zoned", zoned(n, zones=int(m.group(6)),
                                          seed=seed)
        else:
            r, c = int(m.group(7)), int(m.group(8))
            if r * c != n:
                raise ValueError(
                    f"mesh{r}x{c} has {r * c} nodes, cluster has {n}")
            family, topo = "mesh", mesh2d(r, c)
    except ValueError as exc:
        raise ValueError(f"topology {name!r} invalid for n={n}: {exc}") \
            from exc
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
