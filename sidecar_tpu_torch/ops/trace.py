"""The flight recorder — the port of ``sidecar_tpu/ops/trace.py``: one
int32 record of ``TRACE_WIDTH`` columns a round, built on the device
from consecutive states, and a bounded buffer of them
(:class:`RoundTrace`).

Columns (the reference's, same order): ``round``; ``frontier`` — rows
with an eligible record or line BEFORE the round (the sparse path's
sender predicate); ``behind`` — the (alive node, slot) beliefs short of
the freshest version AFTER it; ``admitted`` — state cells the round
changed; ``exchange_bytes`` — ``Σ min(budget, eligible) · fanout ·
RECORD_WIRE_BYTES``; ``sparse`` and ``overflow`` — the sparse step's
stats; ``tombstones``, ``suspects`` — post-round census;
``fp_tombstones`` — cells that entered TOMBSTONE while the owner is
alive; ``rejected_future`` — record copies the receivers' future bound
rejected (the chaos round's count, ``ChaosExactSim._trace_record``; 0
elsewhere); ``ticked_nodes`` — alive nodes whose cadence gate fires.

Buffer contract: ``count`` is the exact number of rounds recorded,
rows past ``min(count, cap)`` stay zero, and ``overflow`` says
``count > cap`` — rounds past the capacity are dropped, never silently.
The round counter is a host int in the port, so ``count`` and
``overflow`` are host values and appending writes one row of ``rec``
in place: no host read.

Every reduction is computed in int64 and narrowed to int32 at the end,
which wraps as the reference's int32 sums do.

On a rank of a shard group (``group=``, ``parallel/mesh.py``) the
states hold the rank's node rows: each count over rows is the rank's
share, the shares are summed over the ranks (narrowing to int32 is a
ring map, so the sum of the wrapped shares is the wrapped total), the
freshest belief is max-reduced and the liveness gathered first — every
rank returns the one-process record.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sidecar_tpu_torch.ops import gossip as gossip_ops
from sidecar_tpu_torch.ops.kernels.publish_gather import eligible_lines
from sidecar_tpu_torch.ops.status import (
    SUSPECT,
    TOMBSTONE,
    is_known,
    unpack_status,
)

I32, I64 = torch.int32, torch.int64

# Analytic wire cost of one gossiped record (the reference's ~1398 B UDP
# packet carries the 15-record budget).
RECORD_WIRE_BYTES = 93

TRACE_ROUND = 0
TRACE_FRONTIER = 1
TRACE_BEHIND = 2
TRACE_ADMITTED = 3
TRACE_EXCHANGE_BYTES = 4
TRACE_SPARSE = 5
TRACE_OVERFLOW = 6
TRACE_TOMBSTONES = 7
TRACE_SUSPECTS = 8
TRACE_FP_TOMBSTONES = 9
TRACE_REJECTED_FUTURE = 10
TRACE_TICKED_NODES = 11
TRACE_WIDTH = 12
TRACE_FIELDS = ("round", "frontier", "behind", "admitted",
                "exchange_bytes", "sparse", "overflow", "tombstones",
                "suspects", "fp_tombstones", "rejected_future",
                "ticked_nodes")

_I32_MAX = 2**31 - 1


@dataclasses.dataclass
class RoundTrace:
    """A bounded stream of per-round records."""

    count: int           # rounds recorded (exact)
    rec: torch.Tensor    # int32 [cap, TRACE_WIDTH]
    overflow: bool       # count > cap


def zero_trace(cap: int, device="cpu") -> RoundTrace:
    return RoundTrace(count=0, rec=torch.zeros((cap, TRACE_WIDTH),
                                               dtype=I32, device=device),
                      overflow=False)


def append_record(buf, rec):
    """Append one record (a RoundTrace's or any buffer of the same
    three fields): row ``count`` of ``rec`` is written in place while
    it is inside the capacity; ``count`` stays exact."""
    cap = buf.rec.shape[0]
    if buf.count < cap:
        buf.rec[buf.count] = rec
    count = buf.count + 1
    return dataclasses.replace(buf, count=count, overflow=count > cap)


def _sum(mask) -> torch.Tensor:
    """An int32 0-d count of a bool tensor (int64 sum, wrapped)."""
    return mask.sum(dtype=I64).to(I32)


def offer_census(elig, budget: int, fanout: int):
    """``(frontier, exchange_bytes)`` from a pre-round eligibility mask
    ``elig`` (bool ``[N, X]``), as int32 0-d tensors."""
    per_row = elig.sum(dim=1, dtype=I64).to(I32)
    frontier = _sum(per_row > 0)
    recs = torch.clamp(per_row, max=budget).sum(dtype=I64).to(I32)
    return frontier, recs * (fanout * RECORD_WIRE_BYTES)


def _status_count(status: int, packed) -> torch.Tensor:
    total = torch.zeros((), dtype=I32, device=packed[0].device)
    for arr in packed:
        total = total + _sum(is_known(arr) & (unpack_status(arr) == status))
    return total


def count_tombstones(*packed) -> torch.Tensor:
    """TOMBSTONE cells across packed-key tensors (unknown cells never
    count)."""
    return _status_count(TOMBSTONE, packed)


def count_suspects(*packed) -> torch.Tensor:
    """SUSPECT cells across packed-key tensors."""
    return _status_count(SUSPECT, packed)


def fp_tombstone_entries(prev, nxt, owner_alive) -> torch.Tensor:
    """Cells that ENTERED tombstone status between two aligned packed
    tensors while the slot's owner is alive (``owner_alive`` broadcasts
    against them)."""
    entered = is_known(nxt) & (unpack_status(nxt) == TOMBSTONE) & \
        ~(is_known(prev) & (unpack_status(prev) == TOMBSTONE))
    return _sum(entered & owner_alive)


def ticked_census(round_idx: int, node_alive, tick_period=None,
                  tick_phase=None) -> torch.Tensor:
    """Alive nodes whose cadence gate fires at ``round_idx``; a period
    of None or an int ≤ 1 is the uniform cadence (every alive node)."""
    if tick_period is None or (isinstance(tick_period, int)
                               and tick_period <= 1):
        return _sum(node_alive)
    n = node_alive.shape[0]
    dev = node_alive.device
    per = torch.as_tensor(tick_period, dtype=I32,
                          device=dev).reshape(-1).expand(n)
    pha = torch.as_tensor(0 if tick_phase is None else tick_phase,
                          dtype=I32, device=dev).reshape(-1).expand(n)
    ticked = ((round_idx + pha) % torch.clamp(per, min=1)) == 0
    return _sum(ticked & node_alive)


def _i32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device, I32).reshape(())
    return torch.full((), int(v), dtype=I32, device=device)


def build_record(round_idx, frontier, behind, admitted, exchange_bytes,
                 tombstones, suspects, fp_tombstones, stats=None,
                 rejected_future=0, ticked_nodes=0) -> torch.Tensor:
    """The int32 ``[TRACE_WIDTH]`` record, on the device of
    ``frontier``; ``stats`` is the sparse step's ``[3]`` (sparse taken,
    overflowed, frontier) or None on a dense round."""
    sparse, overflow = (0, 0) if stats is None else (stats[0], stats[1])
    dev = frontier.device
    return torch.stack([_i32(v, dev) for v in (
        round_idx, frontier, behind, admitted, exchange_bytes, sparse,
        overflow, tombstones, suspects, fp_tombstones, rejected_future,
        ticked_nodes)])


def _group_sum(group, counts):
    """The int32 counts summed over ``group``'s ranks (None: this
    process holds every row), in int64 and narrowed once."""
    if group is None:
        return counts
    total = group.all_reduce_sum(torch.stack(counts).to(I64)).to(I32)
    return list(total.unbind())


def exact_record(prev, nxt, *, budget: int, fanout: int, limit: int,
                 stats=None, rejected_future=0, tick_period=None,
                 tick_phase=None, census=None, group=None) -> torch.Tensor:
    """One round's record for the exact model.  ``census``, when given,
    is :func:`offer_census` of the pre-round state, computed before the
    round rewrote it in place; then ``prev`` needs only ``known`` (a
    copy of the pre-round one).  ``group``: see the module note."""
    if census is None:
        census = offer_census(
            gossip_ops.eligible_records(prev.known, prev.sent, limit),
            budget, fanout)
    frontier, xbytes = census
    alive = nxt.node_alive
    known = nxt.known
    alive_all = alive if group is None else group.gather_rows(alive)
    truth = torch.where(alive[:, None], known, 0).amax(dim=0)
    if group is not None:
        truth = group.all_reduce_max(truth)
    behind = _sum(alive[:, None] & (known < truth[None, :]))
    admitted = _sum(known != prev.known)
    n, m = alive_all.shape[0], known.shape[1]
    owner = torch.div(torch.arange(m, dtype=I64, device=known.device),
                      m // n, rounding_mode="floor")
    fp = fp_tombstone_entries(prev.known, known, alive_all[owner][None, :])
    frontier, behind, admitted, xbytes, tombs, suspects, fp = _group_sum(
        group, [frontier, behind, admitted, xbytes, count_tombstones(known),
                count_suspects(known), fp])
    return build_record(nxt.round_idx, frontier, behind, admitted, xbytes,
                        tombs, suspects, fp, stats,
                        rejected_future=rejected_future,
                        ticked_nodes=ticked_census(nxt.round_idx, alive_all,
                                                   tick_period, tick_phase))


def _behind_i32(behind) -> torch.Tensor:
    """The float census as the reference narrows it: ``min(float32(b),
    float32(2³¹ − 1))`` converted to int32, saturating (float32 rounds
    the bound up to 2³¹, which XLA's conversion clamps)."""
    b = torch.clamp(torch.as_tensor(behind, dtype=torch.float32),
                    max=float(_I32_MAX)).to(torch.float64)
    return torch.clamp(b, max=_I32_MAX).to(I64).to(I32)


def compressed_record(prev, nxt, behind, *, budget: int, fanout: int,
                      limit: int, stats=None, tick_period=None,
                      tick_phase=None, group=None) -> torch.Tensor:
    """One round's record for the compressed model; ``behind`` is the
    model's own census (``CompressedSim.behind(nxt)``, over every
    rank).  ``group``: see the module note; the shared ``floor``, whole
    on every rank, is counted once, after the sum."""
    elig = eligible_lines(prev.cache_slot, prev.cache_sent, limit)
    frontier, xbytes = offer_census(elig, budget, fanout)
    alive = nxt.node_alive
    alive_all = alive if group is None else group.gather_rows(alive)
    frontier, xbytes, admitted, tombs, suspects, fp = _group_sum(group, [
        frontier, xbytes,
        (_sum(nxt.own != prev.own) + _sum(nxt.cache_val != prev.cache_val)
         + _sum(nxt.cache_slot != prev.cache_slot)),
        count_tombstones(nxt.own, nxt.cache_val),
        count_suspects(nxt.own, nxt.cache_val),
        fp_tombstone_entries(prev.own, nxt.own, alive[:, None])])
    n, s = alive_all.shape[0], nxt.own.shape[1]
    floor_owner = torch.div(torch.arange(n * s, dtype=I64,
                                         device=alive.device),
                            s, rounding_mode="floor")
    admitted = admitted + _sum(nxt.floor != prev.floor)
    tombs = tombs + count_tombstones(nxt.floor)
    suspects = suspects + count_suspects(nxt.floor)
    fp = fp + fp_tombstone_entries(prev.floor, nxt.floor,
                                   alive_all[floor_owner])
    return build_record(nxt.round_idx, frontier, _behind_i32(behind),
                        admitted, xbytes, tombs, suspects, fp, stats,
                        ticked_nodes=ticked_census(nxt.round_idx, alive_all,
                                                   tick_period, tick_phase))


# -- host-side views ----------------------------------------------------------

def _recorded(trace) -> np.ndarray:
    rec = trace.rec.cpu().numpy()
    return rec[:min(int(trace.count), rec.shape[0])]


def trace_to_dicts(trace: RoundTrace) -> list:
    """One dict per recorded round (padding dropped)."""
    return [{name: int(row[i]) for i, name in enumerate(TRACE_FIELDS)}
            for row in _recorded(trace)]


def summarize(trace: RoundTrace) -> dict:
    """The reference's tail summary: last-record census and per-round
    exchange-byte statistics over the recorded rounds."""
    count = int(trace.count)
    recorded = _recorded(trace)
    if recorded.shape[0] == 0:
        return {"rounds": 0, "truncated": bool(trace.overflow)}
    xb = recorded[:, TRACE_EXCHANGE_BYTES].astype(np.int64)
    return {
        "rounds": count,
        "truncated": bool(trace.overflow),
        "frontier_last": int(recorded[-1, TRACE_FRONTIER]),
        "frontier_max": int(recorded[:, TRACE_FRONTIER].max()),
        "behind_last": int(recorded[-1, TRACE_BEHIND]),
        "admitted_total": int(
            recorded[:, TRACE_ADMITTED].astype(np.int64).sum()),
        "exchange_bytes_per_round_mean": int(xb.mean()),
        "exchange_bytes_per_round_max": int(xb.max()),
        "exchange_bytes_total": int(xb.sum()),
        "sparse_rounds": int(recorded[:, TRACE_SPARSE].sum()),
        "overflow_rounds": int(recorded[:, TRACE_OVERFLOW].sum()),
        "tombstones_last": int(recorded[-1, TRACE_TOMBSTONES]),
        "suspects_last": int(recorded[-1, TRACE_SUSPECTS]),
        "suspects_max": int(recorded[:, TRACE_SUSPECTS].max()),
        "fp_tombstones_total": int(
            recorded[:, TRACE_FP_TOMBSTONES].astype(np.int64).sum()),
        "rejected_future_total": int(
            recorded[:, TRACE_REJECTED_FUTURE].astype(np.int64).sum()),
        "ticked_nodes_last": int(recorded[-1, TRACE_TICKED_NODES]),
        "ticked_nodes_min": int(recorded[:, TRACE_TICKED_NODES].min()),
    }
