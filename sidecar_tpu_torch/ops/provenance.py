"""Record-level propagation provenance — the port of
``sidecar_tpu/ops/provenance.py``.

A run picks at most T tracer slots and a :class:`ProvTrace` follows
them: per (record, node) the round the node first held the record
(``first_seen``, -1 never), its infection parent (``PARENT_ORIGIN`` for
seeded copies, ``PARENT_UNATTRIBUTED`` when no sampled channel from a
prior holder reached the node that round) and its tree depth
(``hops``), plus each observed round's holder count (``coverage``, a
``cap``-row window with the :class:`~sidecar_tpu_torch.ops.trace.
RoundTrace` contract: host ``count`` and ``overflow``).

Attribution (the reference's rule): a node newly holding a record is
charged to the candidate with the least ``(hops, node id)`` among the
peer channels sampled that round whose sender already held it.  The
channels come from the round's own draws, re-resolved as the step
resolves them, so observing never touches the round's tensors.

The update is O(T·N·F) elementwise work and one scatter-min
(``scatter_reduce_(…, "amin")`` into a ``[T, N + 1]`` buffer).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

I32, I64 = torch.int32, torch.int64

PARENT_ORIGIN = -1
PARENT_UNATTRIBUTED = -2

_INF = 2**31 - 1

# The smallest packed key with a real tick, pack(1, 0): a ``ref`` below
# it (an empty slot at seed time) makes the holder test plain is_known.
_MIN_KNOWN = 8


@dataclasses.dataclass
class ProvTrace:
    """The carried provenance stream; ``ref`` pins the traced version
    (the freshest packed key of each tracer when observation began)."""

    ref: torch.Tensor         # int32 [T]
    first_seen: torch.Tensor  # int32 [T, N] absolute round; -1 unreached
    parent: torch.Tensor      # int32 [T, N] infector node id / sentinel
    hops: torch.Tensor        # int32 [T, N] tree depth; -1 unreached
    coverage: torch.Tensor    # int32 [cap, T] holder count per round
    count: int                # rounds observed
    overflow: bool            # count > cap


def zero_prov(tracked: int, n: int, cap: int, device="cpu") -> ProvTrace:
    """An empty trace for ``tracked`` records over ``n`` nodes with a
    ``cap``-round coverage window."""
    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=device)

    return ProvTrace(ref=full((tracked,), 0),
                     first_seen=full((tracked, n), -1),
                     parent=full((tracked, n), PARENT_ORIGIN),
                     hops=full((tracked, n), -1),
                     coverage=full((cap, tracked), 0),
                     count=0, overflow=False)


def holders(prov: ProvTrace, belief):
    """Bool ``[N, T]``: which beliefs (packed ``[N, T]``) have reached
    the traced version."""
    return belief >= torch.clamp(prov.ref, min=_MIN_KNOWN)[None, :]


def holders_batch(ref, belief):
    """:func:`holders` against explicit refs: ``belief`` ``[..., N, T]``
    vs ``ref`` ``[..., T]``."""
    return belief >= torch.clamp(ref, min=_MIN_KNOWN)[..., None, :]


def seed(prov: ProvTrace, belief, round_idx: int) -> ProvTrace:
    """Pin ``ref`` to each tracer's freshest key in ``belief`` (the
    starting state's packed ``[N, T]``) and mark the nodes holding it
    as origin copies at ``round_idx``."""
    prov = dataclasses.replace(prov, ref=belief.amax(dim=0).to(I32))
    hit = holders(prov, belief).T & (prov.first_seen < 0)
    return dataclasses.replace(
        prov,
        first_seen=torch.where(hit, int(round_idx), prov.first_seen),
        parent=torch.where(hit, PARENT_ORIGIN, prov.parent),
        hops=torch.where(hit, 0, prov.hops))


def observe(prov: ProvTrace, prev_cols, nxt_cols, round_idx: int,
            pushes=(), pulls=()) -> ProvTrace:
    """Fold one round into the trace.

    ``prev_cols``/``nxt_cols``: bool ``[N, T]`` holders before and after
    the round.  ``pushes``: ``(dst, mask)`` pairs — sender ``s`` offered
    to ``dst[s, k]`` where ``mask`` (broadcastable to ``dst``, or None)
    holds; ``pulls``: ``(src, mask)`` — receiver ``i`` read from
    ``src[i, k]``.  Channel ids lie in ``[0, N)``."""
    t_n, n = prov.first_seen.shape
    dev = prov.first_seen.device
    ids = torch.arange(n, dtype=I32, device=dev)
    # Lexicographic (hops, id) as one int32, as the reference packs it.
    score = torch.where(prev_cols.T,
                        torch.clamp(prov.hops, min=0) * n + ids[None, :],
                        _INF)

    best = torch.full((t_n, n + 1), _INF, dtype=I32, device=dev)
    for idx, mask in pushes:
        contrib = score[:, :, None].expand((t_n,) + tuple(idx.shape))
        if mask is not None:
            m = torch.broadcast_to(mask, idx.shape)
            contrib = torch.where(m[None], contrib, _INF)
        flat = idx.reshape(1, -1).to(I64).expand(t_n, -1)
        best.scatter_reduce_(1, flat, contrib.reshape(t_n, -1), "amin",
                             include_self=True)
    for idx, mask in pulls:
        cand = score[:, idx.to(I64)]                      # [T, N, K]
        if mask is not None:
            m = torch.broadcast_to(mask, idx.shape)
            cand = torch.where(m[None], cand, _INF)
        best[:, :n] = torch.minimum(best[:, :n], cand.amin(dim=2))

    bn = best[:, :n]
    attributed = bn != _INF
    parent_new = torch.where(attributed, bn % n, PARENT_UNATTRIBUTED)
    hops_new = torch.where(attributed, torch.div(bn, n,
                                                 rounding_mode="floor") + 1,
                           0)
    newly = nxt_cols.T & (prov.first_seen < 0)
    cap = prov.coverage.shape[0]
    coverage = prov.coverage
    if prov.count < cap:
        coverage[prov.count] = nxt_cols.sum(dim=0, dtype=I64).to(I32)
    count = prov.count + 1
    return ProvTrace(
        ref=prov.ref,
        first_seen=torch.where(newly, int(round_idx), prov.first_seen),
        parent=torch.where(newly, parent_new.to(I32), prov.parent),
        hops=torch.where(newly, hops_new.to(I32), prov.hops),
        coverage=coverage, count=count,
        overflow=prov.overflow or count > cap)


# -- tracer selection -----------------------------------------------------------

def default_tracked(m: int, count: int) -> tuple:
    """``count`` tracer slots spread evenly over ``[0, m)``."""
    if m < 1 or count < 1:
        return ()
    count = min(count, m)
    return tuple(sorted({int(round(i * (m - 1) / max(count - 1, 1)))
                         for i in range(count)}))


# -- host-side reductions --------------------------------------------------------

def _pctl(vals, q: float):
    """Nearest-rank percentile (the reference's)."""
    if len(vals) == 0:
        return None
    vals = sorted(vals)
    k = max(0, min(len(vals) - 1,
                   int(round(q / 100.0 * len(vals) + 0.5)) - 1))
    return vals[k]


def lag_values(first_seen_row) -> list:
    """Rounds from one record's origin (its least ``first_seen``) to
    each node that holds it."""
    fs = np.asarray(first_seen_row)
    seen = fs >= 0
    if not seen.any():
        return []
    origin = int(fs[seen].min())
    return [int(v) - origin for v in fs[seen]]


def pooled_lag(first_seen) -> dict:
    """The lag distribution over every (record, reached node)."""
    lags: list = []
    for row in np.asarray(first_seen):
        lags.extend(lag_values(row))
    return {"samples": len(lags), "p50": _pctl(lags, 50.0),
            "p95": _pctl(lags, 95.0), "p99": _pctl(lags, 99.0),
            "max": max(lags) if lags else None}


def p99_lag_rounds(first_seen):
    """The pooled p99 lag, or None without samples."""
    return pooled_lag(first_seen)["p99"]


def _host(prov: ProvTrace):
    return (prov.first_seen.cpu().numpy(), prov.hops.cpu().numpy(),
            prov.parent.cpu().numpy())


def summarize(prov: ProvTrace, tracked, services_per_node: int) -> dict:
    """Per-record lag percentiles, hop histograms and reach, and the
    pooled lag summary."""
    fs, hops, parent = _host(prov)
    count = int(prov.count)
    cap = prov.coverage.shape[0]
    records = []
    for ti, slot in enumerate(tracked):
        seen = fs[ti] >= 0
        lags = lag_values(fs[ti])
        hop_vals = hops[ti][seen & (hops[ti] >= 0)]
        records.append({
            "slot": int(slot),
            "origin_node": int(slot) // services_per_node,
            "origin_round": int(fs[ti][seen].min()) if seen.any()
            else None,
            "reached": int(seen.sum()),
            "rounds_to_reach_all": (max(lags) if seen.all() else None),
            "unattributed": int(np.sum(
                seen & (parent[ti] == PARENT_UNATTRIBUTED))),
            "lag": {"p50": _pctl(lags, 50.0), "p95": _pctl(lags, 95.0),
                    "p99": _pctl(lags, 99.0)},
            "hop_histogram": (np.bincount(hop_vals).tolist()
                              if hop_vals.size else []),
        })
    return {
        "tracked": [int(s) for s in tracked],
        "records": records,
        "lag": pooled_lag(fs),
        "rounds_observed": count,
        "overflow": bool(prov.overflow),
        "coverage": prov.coverage.cpu().numpy()[:min(count, cap)].T.tolist(),
        "nodes": fs.shape[1],
    }


def tree_to_dict(prov: ProvTrace, tracked) -> list:
    """Per record, the per-node parent, hop and first-seen lists."""
    fs, hops, parent = _host(prov)
    return [{"slot": int(slot), "first_seen": fs[ti].tolist(),
             "parent": parent[ti].tolist(), "hops": hops[ti].tolist()}
            for ti, slot in enumerate(tracked)]


def blast_radius(prov: ProvTrace, tracked, services_per_node: int,
                 origin_nodes) -> dict:
    """For the tracked records owned by ``origin_nodes``: reach, reach
    fraction, deepest hop and unattributed arrivals."""
    origin_nodes = set(int(x) for x in origin_nodes)
    fs, hops, parent = _host(prov)
    n = fs.shape[1]
    out = []
    for ti, slot in enumerate(tracked):
        owner = int(slot) // services_per_node
        if owner not in origin_nodes:
            continue
        seen = fs[ti] >= 0
        hop_vals = hops[ti][seen & (hops[ti] >= 0)]
        out.append({
            "slot": int(slot),
            "origin_node": owner,
            "reached": int(seen.sum()),
            "reach_fraction": float(seen.sum()) / n,
            "max_hops": int(hop_vals.max()) if hop_vals.size else 0,
            "unattributed_paths": int(np.sum(
                seen & (parent[ti] == PARENT_UNATTRIBUTED))),
        })
    return {"origins": sorted(origin_nodes), "records": out}
