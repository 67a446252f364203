"""Per-round changed-cell sets — the port of ``sidecar_tpu/ops/delta.py``.

Consecutive belief tensors are diffed on the device and only the changed
``(node, slot)`` index sets leave it, in a :class:`DeltaBatch` of fixed
capacity ``cap``.  A round that changes more than ``cap`` cells sets
``overflow``, the consumer's cue to resync from a snapshot; ``count``
stays exact.

The exact model diffs ``known[N, M]`` directly.  The compressed model
diffs its belief view ``belief(i, m) = max(floor[m], cache hit, own if
i owns m)`` (:func:`compressed_belief`): an ``[N, M]`` tensor, the
bridge and test regime's tool (at the north star it would be 10¹¹
cells).

The reference compacts with a static-size ``nonzero``; ``torch.nonzero``
reads its size on the host, so :func:`extract_delta` compacts as
``ops/sparse.compact_rows`` does: each changed cell's place is its
running count, and a ``[cap + 1]`` buffer's last entry takes every cell
past the capacity.  No host read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

I32, I64 = torch.int32, torch.int64


@dataclasses.dataclass
class DeltaBatch:
    """One round's changed cells, padded to ``cap``: entries past
    ``min(count, cap)`` have ``node == slot == -1`` and ``val == 0``."""

    count: torch.Tensor     # int32 0-d — changed cells (exact)
    node: torch.Tensor      # int32 [cap] — row (-1 padding)
    slot: torch.Tensor      # int32 [cap] — column (-1 padding)
    val: torch.Tensor       # int32 [cap] — the NEW packed key
    overflow: torch.Tensor  # bool 0-d — count > cap


def extract_delta(prev, nxt, cap: int) -> DeltaBatch:
    """Changed cells between two aligned packed tensors, reported as
    ``(row, col)`` of their 2-D ``[shape[0], -1]`` view, in row-major
    order."""
    prev2 = prev.reshape(prev.shape[0], -1)
    nxt2 = nxt.reshape(nxt.shape[0], -1)
    m = nxt2.shape[1]
    flat = nxt2.reshape(-1)
    total = flat.numel()
    dev = flat.device
    changed = (prev2 != nxt2).reshape(-1)
    place = torch.cumsum(changed, 0, dtype=I64)
    count = place[-1] if total else torch.zeros((), dtype=I64, device=dev)
    at = torch.where(changed & (place <= cap), place - 1, cap)
    buf = torch.full((cap + 1,), total, dtype=I64, device=dev)
    buf.scatter_(0, at, torch.arange(total, dtype=I64, device=dev))
    idx = buf[:cap]
    valid = idx < total
    safe = torch.clamp(idx, max=max(total - 1, 0))
    node = torch.where(valid, torch.div(safe, m, rounding_mode="floor"), -1)
    slot = torch.where(valid, safe % m, -1)
    val = torch.where(valid, flat[safe], 0)
    return DeltaBatch(count=count.to(I32), node=node.to(I32),
                      slot=slot.to(I32), val=val.to(I32),
                      overflow=count > cap)


def compressed_belief(own, cache_slot, cache_val, floor,
                      services_per_node: int, row_offset: int = 0):
    """The compressed model's per-node belief view ``[N, M]``:
    ``max(floor[m], cache line hit, own[i] where i owns m)`` — a slot
    can sit only at line ``hash_line(m)`` on every node, so the cache
    part is one column gather; liveness is not applied.  The rows may be
    a rank's: row 0 is then global node ``row_offset``."""
    # Imported here: the compressed model imports this module.
    from sidecar_tpu_torch.models.compressed import hash_line

    n, s = own.shape
    m = floor.shape[0]
    dev = own.device
    slots = torch.arange(m, dtype=I32, device=dev)
    lines = hash_line(slots, cache_slot.shape[1], services_per_node).to(I64)
    hit = cache_slot[:, lines] == slots[None, :]
    cached = torch.where(hit, cache_val[:, lines], 0)
    owner = torch.div(slots, s, rounding_mode="floor")
    own_row = torch.zeros(m, dtype=own.dtype, device=dev)
    own_row[row_offset * s:(row_offset + n) * s] = own.reshape(-1)
    node = row_offset + torch.arange(n, dtype=I32, device=dev)
    own_b = torch.where(owner[None, :] == node[:, None], own_row[None, :], 0)
    return torch.maximum(torch.maximum(floor[None, :], cached), own_b)


def merge_deltas(count, node, slot, val, cap: int) -> DeltaBatch:
    """One batch from the ranks' batches of a shard group, gathered
    (``count`` ``[W]``; ``node`` — global rows —, ``slot`` and ``val``
    ``[W, cap]``, rank order): the ranks' changed cells in that order,
    which is the one-process row-major order, the first ``cap`` kept,
    ``count`` their total.  No host read."""
    w = count.shape[0]
    dev = count.device
    held = torch.arange(cap, device=dev)[None, :] < \
        torch.clamp(count.to(I64), max=cap)[:, None]
    flat = held.reshape(-1)
    place = torch.cumsum(flat, 0, dtype=I64)
    at = torch.where(flat & (place <= cap), place - 1, cap)
    buf = torch.full((cap + 1,), w * cap, dtype=I64, device=dev)
    buf.scatter_(0, at, torch.arange(w * cap, dtype=I64, device=dev))
    idx = buf[:cap]
    valid = idx < w * cap
    safe = torch.clamp(idx, max=w * cap - 1)
    total = count.to(I64).sum()

    def pick(x, pad):
        return torch.where(valid, x.reshape(-1)[safe], pad).to(I32)

    return DeltaBatch(count=total.to(I32), node=pick(node, -1),
                      slot=pick(slot, -1), val=pick(val, 0),
                      overflow=total > cap)


def oracle_diff(prev, nxt) -> dict:
    """``{(node, slot): new_packed}`` over two 2-D host arrays — the
    plain diff the device op is held against."""
    prev = np.asarray(prev)
    nxt = np.asarray(nxt)
    rows, cols = np.nonzero(prev != nxt)
    return {(r, c): int(nxt[r, c])
            for r, c in zip(rows.tolist(), cols.tolist())}


def batch_to_dict(batch: DeltaBatch) -> dict:
    """``{(node, slot): val}`` of one batch, padding dropped; an
    overflowed batch raises (the caller resyncs from a snapshot)."""
    if bool(batch.overflow):
        raise OverflowError(
            f"delta batch overflowed: {int(batch.count)} changes > "
            f"capacity {batch.node.shape[0]}")
    node = batch.node.cpu().numpy()
    slot = batch.slot.cpu().numpy()
    val = batch.val.cpu().numpy()
    keep = node >= 0
    return {(int(r), int(c)): int(v)
            for r, c, v in zip(node[keep], slot[keep], val[keep])}
