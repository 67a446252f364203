"""The gossip-round ops — the port of ``sidecar_tpu/ops/gossip.py``:
the refresh stagger (``refresh_phase``, ``refresh_due``), peer sampling
(``sample_peers``) with its delivery gates (``cadence_gate``,
``stagger_gate``), and the exact model's round (``eligible_mask``,
``eligible_records``, ``select_messages``, ``expand_deliveries``,
``finalize_deliveries``, ``prepare_deliveries``, ``apply_updates``,
``record_transmissions``, ``push_pull``), plus the one seam all
randomness of a round passes through (:class:`RoundDraws`).

The reference draws from ``jax.random`` keys inside the round.  The
port draws from an explicit ``torch.Generator`` through
:func:`draw_round` instead; the two streams differ, so a caller that
needs the reference's exact trajectory hands the round its draws
directly (the drivers' ``draws=`` argument) — that is how the lockstep
tests feed in the JAX draws.

uint32 arithmetic: torch has no full uint32 multiply, so products are
taken in int64 and masked to their low 32 bits (exact: the low 32 bits
of a wrapped product do not depend on the high ones).

Out-of-range indices: JAX clamps a gather's index and drops a scatter's
out-of-range entry, each axis on its own; the exact round relies on both
(row ``N`` pads the announce, column ``M`` pads unfilled message slots).
Here a gather clamps each index explicitly, and every scatter checks
each axis before it forms a flat index, so ``(r, M)`` never aliases
``(r + 1, 0)``.

In place: ``record_transmissions`` and ``apply_updates`` update ``sent``
and ``known`` in place (the reference's drivers donate these buffers;
at the bench shape ``known`` is 671 MB).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from sidecar_tpu_torch.ops import kernels as kernel_ops
from sidecar_tpu_torch.ops.merge import (
    admit_gate,
    merge_packed,
    sticky_adjust,
)
from sidecar_tpu_torch.ops.status import MASK32, PHASE_MULT, unpack_ts

I32, I64 = torch.int32, torch.int64


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
    self-exclusion shift turns into a peer id; ``stride`` the compressed
    model's push-pull partner offset in ``[1, N)`` (0 on rounds without
    push-pull); ``keep`` the packet-loss keep mask (None when
    ``drop_prob == 0``), K cache lines wide on the compressed model and
    ``B = min(budget, M)`` records on the exact one; ``pp_slot`` the
    exact model's push-pull partner, a peer-slot draw of one leg that
    :func:`sample_peers` resolves (None on rounds without push-pull)."""

    peer_slot: torch.Tensor                 # int32 [N, F]
    stride: int
    keep: Optional[torch.Tensor] = None     # bool [N, F, K or B]
    pp_slot: Optional[torch.Tensor] = None  # int32 [N, 1]


def _peer_slots(generator, n: int, legs: int, deg, dev):
    """``legs`` peer-slot draws per node: uniform over ``[0, N-1)`` on a
    complete graph (0 for a single node, as the reference's empty
    ``randint`` range gives), over ``[0, max(deg, 1))`` on a neighbour
    list."""
    if deg is None:
        return torch.randint(0, max(n - 1, 1), (n, legs),
                             generator=generator, device=dev,
                             dtype=torch.int32)
    hi = torch.clamp(deg.to(dev, torch.int64), min=1)[:, None]
    u = torch.rand((n, legs), generator=generator, device=dev,
                   dtype=torch.float64)
    return torch.minimum((u * hi).to(torch.int64), hi - 1).to(torch.int32)


def draw_round(generator: torch.Generator, n: int, fanout: int, *,
               deg=None, push_pull: bool = True, keep_prob: float = 1.0,
               keep_width: int = 0, partner: bool = False) -> RoundDraws:
    """Draw one round from ``generator`` on the generator's device.

    ``deg`` (int [N]) selects neighbour-list sampling, uniform over
    ``[0, max(deg, 1))`` per node; None is the complete graph.  The
    push-pull partner is drawn only when ``push_pull``: as a peer slot
    ``pp_slot`` with ``partner`` (the exact model), else as the stride
    (a host int, so a CUDA generator synchronises for it).  The
    ``[N, F, keep_width]`` keep mask is drawn only when
    ``keep_prob < 1``."""
    dev = generator.device
    slot = _peer_slots(generator, n, fanout, deg, dev)
    stride, pp_slot = 0, None
    if push_pull and partner:
        pp_slot = _peer_slots(generator, n, 1, deg, dev)
    elif push_pull:
        stride = int(torch.randint(1, n, (1,), generator=generator,
                                   device=dev))
    keep = None
    if keep_prob < 1.0:
        keep = torch.rand((n, fanout, keep_width), generator=generator,
                          device=dev) < keep_prob
    return RoundDraws(peer_slot=slot, stride=stride, keep=keep,
                      pp_slot=pp_slot)


def cadence_gate(dst, round_idx: int, tick_period, tick_phase,
                 self_idx=None):
    """Per-node tick cadence: node i ticks iff ``(round_idx + phase[i])
    % period[i] == 0``; off this round, every sampled target resolves to
    itself (the merge no-op self-send, like a dead sender).
    ``tick_period``/``tick_phase`` are ints or int32 tensors, scalar or
    per-node ``[N]``; periods are clamped to at least 1.  Gossip fan-out
    only: push-pull is never gated, and the draws happen either way."""
    n = dst.shape[0]
    dev = dst.device
    if self_idx is None:
        self_idx = torch.arange(n, dtype=torch.int32, device=dev)
    period = torch.as_tensor(tick_period, dtype=torch.int32,
                             device=dev).reshape(-1).expand(n)
    phase = torch.as_tensor(tick_phase, dtype=torch.int32,
                            device=dev).reshape(-1).expand(n)
    off = ((round_idx + phase) % torch.clamp(period, min=1)) != 0
    return torch.where(off[:, None], self_idx.reshape(-1, 1), dst)


def stagger_gate(dst, round_idx: int, stagger, stagger_period: int,
                 self_idx=None):
    """Round stagger: node i gossips only when ``(round_idx +
    stagger[i]) % stagger_period == 0`` — :func:`cadence_gate` with one
    period for every node.  ``stagger`` None or a period of at most 1
    returns ``dst`` untouched."""
    if stagger is None or stagger_period <= 1:
        return dst
    return cadence_gate(dst, round_idx, stagger_period, stagger,
                        self_idx=self_idx)


def sample_peers(peer_slot, n: int, *, nbrs=None, node_alive=None,
                 cut_mask=None, stagger=None, stagger_period: int = 1,
                 round_idx=None, tick_period=None, tick_phase=None):
    """Resolve a round's ``peer_slot`` draws to gossip targets
    ``dst[int32 N, F]``.  Dead senders and cut edges resolve to the
    sender's own index (a self-send is a merge no-op).

    ``nbrs`` (int32 [N, D]) is the padded neighbour list; None is the
    complete graph, where the draw ``r`` in ``[0, N-1)`` becomes
    ``r + (r >= self)``.  ``cut_mask`` (bool [N, D]) marks partitioned
    edges, read at the drawn slot; a complete graph has no edges to cut
    and raises.  After the draw, the stagger gate (:func:`stagger_gate`)
    and then the cadence gate (:func:`cadence_gate`, when
    ``tick_period`` is given) apply at ``round_idx``; a node sends only
    when both are on."""
    self_idx = torch.arange(n, dtype=torch.int32,
                            device=peer_slot.device)[:, None]
    if nbrs is None:
        if cut_mask is not None:
            raise ValueError(
                "cut_mask requires an explicit neighbor-list topology; a "
                "complete graph has no edge structure to cut — build the "
                "cluster on a mesh/ring/ER/BA topology to model partitions"
            )
        dst = peer_slot + (peer_slot >= self_idx).to(torch.int32)
        if n == 1:
            # The shift names node 1, which does not exist: the
            # reference's scatter drops those deliveries, and a
            # self-send (a merge no-op) gives the same state.
            dst = torch.zeros_like(dst)
    else:
        slot = peer_slot.to(torch.int64)
        dst = torch.gather(nbrs, 1, slot)
        if cut_mask is not None:
            dst = torch.where(torch.gather(cut_mask, 1, slot), self_idx,
                              dst)
    if node_alive is not None:
        dst = torch.where(node_alive[:, None], dst, self_idx)
    if stagger is not None and stagger_period > 1:
        if round_idx is None:
            raise ValueError("stagger gating needs the current round_idx")
        dst = stagger_gate(dst, round_idx, stagger, stagger_period,
                           self_idx=self_idx[:, 0])
    if tick_period is not None:
        if round_idx is None:
            raise ValueError("cadence gating needs the current round_idx")
        dst = cadence_gate(dst, round_idx, tick_period,
                           0 if tick_phase is None else tick_phase,
                           self_idx=self_idx[:, 0])
    return dst


# -- the exact model's round --------------------------------------------------

def eligible_mask(sent, limit):
    """True where a record still has transmissions left
    (TransmitLimited).  ``limit`` is an int, or the fleet's per-row int32
    tensor, which the comparison promotes to without an int32 copy of
    ``sent``."""
    if isinstance(limit, torch.Tensor):
        return sent < limit
    return sent.to(I32) < limit


def eligible_records(known, sent, limit: int):
    """A record the dense select could publish: known (packed key > 0)
    AND transmissions left — exactly the cells :func:`select_messages`
    ranks above zero."""
    return eligible_mask(sent, limit) & (known > 0)


def top_k(x, k: int):
    """``lax.top_k`` over the last axis of an int32 tensor: the ``k``
    largest values in descending order, ties broken to the LOWER index
    (``torch.topk`` promises no order among ties).  Each value becomes a
    unique int64 key ``(value << 32) | (2³² − 1 − index)``, so one
    ``topk`` on the keys gives both orders.  Returns ``(values int32,
    indices int64)``."""
    idx = torch.arange(x.shape[-1], dtype=I64, device=x.device)
    key = (x.to(I64) << 32) | (MASK32 - idx)
    top = torch.topk(key, k, dim=-1).values
    return (top >> 32).to(I32), MASK32 - (top & MASK32)


def _row_rotation(n: int, device, row_offset: int = 0, row_ids=None):
    """``uint32(row id) · PHASE_MULT mod 2³²`` per row, as int64; the
    row ids are ``row_offset + i``, or ``row_ids`` when given."""
    if row_ids is not None:
        rows = row_ids.to(device, I64) & MASK32
    else:
        rows = torch.arange(n, dtype=I64, device=device) + row_offset
    return (rows * PHASE_MULT) & MASK32


def select_messages(known, sent, budget: int, limit: int,
                    row_offset: int = 0, row_ids=None):
    """Top-``budget`` freshest eligible records per node, with the
    reference's per-row rotation of the tie order (row ``i`` scans from a
    hashed offset; ``row_offset`` is the global id of row 0, and
    ``row_ids`` int32 ``[N]``, when given, the global id of each row — the
    sparse round selects on a compacted, non-contiguous row set).

    Rows of at most 4,096 columns take one ``top_k`` over the rotated
    row.  Wider rows take the reference's two stages as written: groups
    of ``sub`` columns (a divisor of M near √(M/B), padded otherwise),
    ranked by their max in a per-row rotated order over the group count
    padded to a power of two; then one ``top_k`` over the top ``B``
    groups' records.  Ties resolve by group rank, then offset — not as
    a flat ``top_k`` would.

    Returns ``(svc_idx, msg)``, int32 ``[N, B]`` with ``B = min(budget,
    M)``: ``msg`` is 0 (a merge no-op) where a node has fewer than B
    eligible records, and ``svc_idx`` is ``M`` there."""
    priority = torch.where(eligible_mask(sent, limit), known, 0)
    n, m = priority.shape
    dev = priority.device
    budget = min(budget, m)
    rot = _row_rotation(n, dev, row_offset, row_ids)

    if m <= 4 * 1024:
        r = (rot % m)[:, None]
        idx = (torch.arange(m, dtype=I64, device=dev)[None, :] + r) % m
        msg, pos = top_k(torch.gather(priority, 1, idx), budget)
        svc_idx = (pos + r) % m
        return torch.where(msg > 0, svc_idx, m).to(I32), msg

    ideal = max(8, math.isqrt(m // budget) + 1)
    sub = next((d for d in range(ideal, min(4 * ideal, m) + 1)
                if m % d == 0), ideal)
    g = -(-m // sub)
    pad = g * sub - m
    if pad:
        priority = torch.nn.functional.pad(priority, (0, pad))
    pr = priority.reshape(n, g, sub)
    gmax = pr.amax(dim=2)

    gp = 1 << (g - 1).bit_length()
    gmax_p = torch.nn.functional.pad(gmax, (0, gp - g))
    r = (rot & (gp - 1))[:, None]
    # rot_view[i, j] = gmax_p[i, (j + r_i) mod gp]: the reference's
    # binary rolls as one gather.
    idx = (torch.arange(gp, dtype=I64, device=dev)[None, :] + r) % gp
    gval, top_g_rot = top_k(torch.gather(gmax_p, 1, idx), budget)
    top_g = (top_g_rot + r) % gp
    keep = gval > 0
    top_g = torch.where(keep, top_g, 0)
    cand = torch.gather(pr, 1, top_g[:, :, None].expand(n, budget, sub))
    cand = torch.where(keep[:, :, None], cand, 0)
    msg, pos = top_k(cand.reshape(n, budget * sub), budget)
    svc_idx = torch.gather(top_g, 1, pos // sub) * sub + pos % sub
    return torch.where(msg > 0, svc_idx, m).to(I32), msg


def expand_deliveries(dst, svc_idx, msg, *, now_tick, stale_ticks: int,
                      node_alive=None, sender_alive=None, record_keep=None,
                      edge_keep=None, future_ticks=None, tomb_budget=None,
                      sender_own=None):
    """Expand each sender's ``B`` selected records to each of its ``F``
    targets as flat ``(row, col, val)`` triples, every gate applied but
    the pre-round stickiness (:func:`finalize_deliveries`): admission
    (staleness; the future bound and the per-origin budget when not
    None — ``sender_own`` [N, B] exempts the sender's own slots), dead
    sender or receiver, the pre-drawn loss mask ``record_keep``
    ``[N, F, B]``, and last the packet mask ``edge_keep`` ``[N, F]`` of
    the fault layer (a dropped packet loses all ``B`` records).
    ``sender_alive`` replaces the sender-liveness gate for a compacted
    batch whose rows are not node ids (the sparse round); ``node_alive``
    still gates the receivers.  ``now_tick`` is an int or a per-receiver
    tensor broadcastable to ``[N, F, B]`` (the chaos round's clocks,
    ``[N, F, 1]``)."""
    n, fanout = dst.shape
    budget = svc_idx.shape[1]
    shape = (n, fanout, budget)
    val = msg[:, None, :].expand(shape)
    tgt = dst[:, :, None].expand(shape)
    own = sender_own[:, None, :] if sender_own is not None else None
    val = admit_gate(val, now_tick, stale_ticks, future_ticks, tomb_budget,
                     own)
    if node_alive is not None:
        snd = sender_alive if sender_alive is not None else node_alive
        val = torch.where(snd[:, None, None], val, 0)
        val = torch.where(node_alive[tgt.to(I64)], val, 0)
    if record_keep is not None:
        val = torch.where(record_keep, val, 0)
    if edge_keep is not None:
        val = torch.where(edge_keep[:, :, None], val, 0)
    return (tgt.reshape(-1), svc_idx[:, None, :].expand(shape).reshape(-1),
            val.reshape(-1))


def finalize_deliveries(known, rows, cols, vals):
    """Resolve raw deliveries against the pre-round ``known``: the
    strict-advance mask and DRAINING stickiness.  The pre-round value is
    read at the CLAMPED index (padding column ``M`` reads column
    ``M − 1``; its value 0 never advances).  Returns ``(vals,
    advanced)``."""
    n, m = known.shape
    flat = rows.to(I64).clamp(0, n - 1) * m + cols.to(I64).clamp(0, m - 1)
    pre_vals = known.view(-1)[flat]
    advanced = vals > pre_vals
    return sticky_adjust(vals, pre_vals, advanced), advanced


def prepare_deliveries(known, dst, svc_idx, msg, **gates):
    """:func:`expand_deliveries` then :func:`finalize_deliveries`:
    returns ``(rows, cols, vals, advanced)``, int32 ``[N·F·B]`` triples
    and the bool mask of entries that strictly advance their cell."""
    rows, cols, vals = expand_deliveries(dst, svc_idx, msg, **gates)
    vals, advanced = finalize_deliveries(known, rows, cols, vals)
    return rows, cols, vals, advanced


def apply_updates(known, sent, rows, cols, vals, advanced):
    """The round's two scatters, in place: merge ``vals`` into ``known``
    (scatter-max) and zero ``sent`` where ``advanced``, dropping entries
    out of range on either axis — the hand-written CUDA kernel
    ``scatter_max_apply_kernel`` on the card, its plain version on the
    CPU.  Returns ``(known, sent)``."""
    return kernel_ops.scatter_max_apply(known, rows, cols, vals, sent,
                                        advanced)


def record_transmissions(sent, svc_idx, msg, fanout: int, row_ids=None,
                         repeats: bool = False):
    """Charge ``fanout`` transmissions to every record offered this round,
    in place — the reference's unclamped int8 scatter-add (counts stay
    under ``limit + fanout − 1``).

    The padding (``msg == 0``, column ``M``) adds nothing.  A row's
    selected columns are distinct unless ``repeats`` is set (the chaos
    round's forged columns may repeat a slot): then a column offered
    ``c`` times in one row is charged ``c · fanout``, as the reference's
    scatter-add charges it.  Either way a gather, an add and a scatter
    are exact without atomics: every writer of a cell stores the same
    number.  A padding entry is pointed at the row's first selection
    with that selection's value, or at column 0 unchanged when the row
    selected nothing (the first column is offered whenever any is).

    ``row_ids`` (int32 ``[C]``, distinct) maps a compacted selection
    batch to its rows of ``sent``; ids out of ``[0, N)`` — the pad id
    ``N`` — drop.  A dropped row charges nothing: it is pointed at a row
    outside the batch (one exists wherever a batch has a pad) and writes
    that row's counts back unchanged, so no two writers of a cell store
    different numbers.  Returns ``sent``."""
    offered = msg > 0
    first = offered[:, :1]
    col0 = torch.where(first, svc_idx[:, :1].to(I64), 0)
    cols = torch.where(offered, svc_idx.to(I64), col0)
    if repeats:
        charge = ((svc_idx[:, :, None] == svc_idx[:, None, :])
                  & offered[:, None, :]).sum(dim=-1, dtype=I32) * fanout
        bump = torch.where(offered, charge,
                           torch.where(first, charge[:, :1], 0))
    else:
        bump = torch.where(offered | first, fanout, 0)
    bump = bump.to(sent.dtype)
    if row_ids is None:
        return sent.scatter_(1, cols, torch.gather(sent, 1, cols) + bump)
    n = sent.shape[0]
    ids = row_ids.to(I64)
    real = (ids >= 0) & (ids < n)
    member = torch.zeros(n + 1, dtype=torch.bool, device=sent.device)
    member[torch.where(real, ids, n)] = True
    spare = torch.argmin(member[:n].to(torch.int8))
    rows = torch.where(real, ids, spare)[:, None].expand_as(cols)
    bump = torch.where(real[:, None], bump, 0).to(sent.dtype)
    return sent.index_put_((rows, cols), sent[rows, cols] + bump)


def push_pull(known, partner, *, now_tick, stale_ticks: int,
              node_alive=None, future_ticks=None, now_push=None,
              tomb_budget=None, owner=None, row_ids=None):
    """Anti-entropy: node ``i`` exchanges full rows with ``partner[i]``
    (``partner[i] == i`` is no exchange; a dead end on either side
    becomes one).  Pull: merge the partner's row into ours
    (:func:`merge_packed`).  Push: our admitted row, sticky-adjusted
    against the partner's pre-exchange row, max-scattered onto the
    partner's row — partners repeat, so it is a row scatter-max
    (``scatter_reduce_`` with ``amax``).  ``tomb_budget`` with ``owner``
    (int32 [M] slot → owner) exempts the sending side's own slots on
    each leg.  ``now_push`` is the push leg's receiver clock (the chaos
    round's per-node clocks: the pull leg admits at the initiator's
    ``now_tick``, the push leg at the partner's; each an int or an
    ``[N, 1]`` tensor); None is ``now_tick``.  ``row_ids`` (int32
    ``[N]``) is each row's node id for the owner masks where rows are
    not node ids (the fleet's flattened ``[S·N]`` batch, partners within
    each scenario's block); None is the row index.  Returns the merged
    tensor (a new one)."""
    n = known.shape[0]
    self_idx = torch.arange(n, dtype=I32, device=known.device)
    if node_alive is not None:
        partner = torch.where(node_alive & node_alive[partner.to(I64)],
                              partner, self_idx)
    own_pull = own_push = None
    if tomb_budget is not None and owner is not None:
        ids, p_ids = self_idx, partner
        if row_ids is not None:
            ids, p_ids = row_ids, row_ids[partner.to(I64)]
        own_pull = owner[None, :] == p_ids[:, None]
        own_push = owner[None, :] == ids[:, None]
    pidx = partner.to(I64)
    pre_tgt = known[pidx]
    pulled = merge_packed(known, pre_tgt, now_tick, stale_ticks,
                          future_ticks, tomb_budget, own_pull)
    offered = admit_gate(known, now_tick if now_push is None else now_push,
                         stale_ticks, future_ticks, tomb_budget, own_push)
    offered = sticky_adjust(offered, pre_tgt, offered > pre_tgt)
    return pulled.scatter_reduce_(0, pidx[:, None].expand_as(offered),
                                  offered, "amax")
