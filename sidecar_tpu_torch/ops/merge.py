"""The LWW merge gates and the aligned merge — the port of
``sidecar_tpu/ops/merge.py`` (``staleness_mask``, ``future_mask``,
``budget_mask``, ``admit_gate``, ``sticky_adjust``, ``apply_stickiness``,
``merge_packed``, ``merge_records``).

Rule 2 of ``AddServiceEntry`` (strictly newer wins) is integer ``max``
on packed keys; the staleness and future bounds, the per-origin budget
and DRAINING stickiness are masks.  All arithmetic stays int32, with
``now``/``stale_ticks``/… as Python ints (they never promote an int32
tensor).
"""

from __future__ import annotations

import torch

from sidecar_tpu_torch.ops.status import (
    ALIVE,
    DRAINING,
    TOMBSTONE,
    is_known,
    pack,
    unpack_status,
    unpack_ts,
)

# The off value of a per-row budget or quarantine threshold (the fleet's
# batched knobs, ``ops/knobs.BatchedKnobs``): per-packet suspicious ranks
# are bounded by the message budget, so ``rank > BUDGET_OFF`` never holds.
BUDGET_OFF = 1 << 28


def staleness_mask(packed, now_tick: int, stale_ticks: int):
    """True where a packed record is too old to merge (``stale_ticks``
    already includes the reference's 1-minute fudge)."""
    ts = unpack_ts(packed)
    return (ts > 0) & (ts < now_tick - stale_ticks)


def future_mask(packed, now_tick: int, future_ticks: int):
    """True where a packed record is stamped beyond ``now +
    future_ticks`` at the receiver (rejected, never clamped)."""
    return unpack_ts(packed) > now_tick + future_ticks


def budget_mask(vals, now_tick: int, tomb_budget: int, own=None):
    """True where a record exceeds its sender's per-packet budget of
    SUSPICIOUS records (third-party tombstones or stamps ahead of the
    receiver's clock), counted cumulatively along the last axis.
    ``own`` marks the sender's first-party records, which never count."""
    ts = unpack_ts(vals)
    suspicious = (ts > 0) & (
        (unpack_status(vals) == TOMBSTONE) | (ts > now_tick))
    if own is not None:
        suspicious = suspicious & ~own
    rank = torch.cumsum(suspicious.to(torch.int32), dim=-1,
                        dtype=torch.int32)
    return suspicious & (rank > tomb_budget)


def admit_gate(vals, now_tick: int, stale_ticks: int, future_ticks=None,
               tomb_budget=None, own=None):
    """Zero packed values outside the admission window: stale, or —
    when enabled (not None) — beyond the future bound or over the
    per-origin budget.  With both defences None this is the bare
    staleness gate."""
    vals = torch.where(staleness_mask(vals, now_tick, stale_ticks), 0, vals)
    if future_ticks is not None:
        vals = torch.where(future_mask(vals, now_tick, future_ticks), 0,
                           vals)
    if tomb_budget is not None:
        vals = torch.where(budget_mask(vals, now_tick, tomb_budget, own),
                           0, vals)
    return vals


def sticky_adjust(vals, pre_vals, advanced):
    """DRAINING stickiness on incoming values against the receiver's
    pre-batch state: where an advancing value would flip a known
    DRAINING cell to ALIVE, rewrite it to DRAINING at the new
    timestamp.  ``advanced`` is the caller's ``vals > pre_vals`` mask."""
    sticky = (
        advanced
        & is_known(pre_vals)
        & (unpack_status(pre_vals) == DRAINING)
        & (unpack_status(vals) == ALIVE)
    )
    return torch.where(sticky, pack(unpack_ts(vals), DRAINING), vals)


def apply_stickiness(pre, post):
    """Re-apply DRAINING stickiness after a max-merge: where ``post``
    advanced a DRAINING ``pre`` cell to ALIVE, keep the new timestamp
    and restore DRAINING."""
    return sticky_adjust(post, pre, post > pre)


def merge_packed(known, incoming, now_tick: int, stale_ticks: int,
                 future_ticks=None, tomb_budget=None, own=None):
    """Merge an aligned tensor of incoming packed records into ``known``
    — the full-state anti-entropy merge: canonicalise (a ts == 0 key is
    the unknown sentinel whatever its status bits), gate admission
    (:func:`admit_gate`; ``own`` marks the sending origin's own cells),
    take the max, and re-apply DRAINING stickiness against ``known``."""
    incoming = torch.where(is_known(incoming), incoming, 0)
    incoming = admit_gate(incoming, now_tick, stale_ticks, future_ticks,
                          tomb_budget, own)
    return apply_stickiness(known, torch.maximum(known, incoming))


def merge_records(known_ts, known_status, inc_ts, inc_status, now_tick: int,
                  stale_ticks: int, future_ticks=None):
    """:func:`merge_packed` for callers that keep separate timestamp and
    status tensors: pack both sides, merge, and return ``(ts, status,
    accepted)``, ``accepted`` True where the cell changed."""
    known = pack(known_ts, known_status)
    merged = merge_packed(known, pack(inc_ts, inc_status), now_tick,
                          stale_ticks, future_ticks)
    return unpack_ts(merged), unpack_status(merged), merged != known
