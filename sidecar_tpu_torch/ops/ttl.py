"""Record-lifespan sweep — the port of ``sidecar_tpu/ops/ttl.py``
``ttl_sweep`` in its two static-window forms.

Tombstones older than the tombstone lifespan are garbage-collected; any
other record not refreshed within its lifespan (alive, or draining) is
tombstoned at its ORIGINAL timestamp + 1 s (the "+1 s rule").  With a
suspicion window > 0, expired non-DRAINING records first sit SUSPECT
at their original timestamp for the window.

The knobs are Python ints (an unbatched round), or per-row tensors that
broadcast against ``known`` (the scenario fleet's batched knobs,
``ops/knobs.BatchedKnobs.rows``).  A tensor window is the fleet's
per-scenario window: both forms are computed and selected elementwise on
``window > 0`` — not the quarantine math evaluated at window 0, because
the two differ there: the quarantine form parks a fresh expiry in
SUSPECT for one sweep even with a zero window, where the window-0 sweep
tombstones it at once.
"""

from __future__ import annotations

import torch

from sidecar_tpu_torch.ops.status import (
    DRAINING,
    SUSPECT,
    TOMBSTONE,
    is_known,
    pack,
    unpack_status,
    unpack_ts,
)


def ttl_sweep(known, now_tick: int, *, alive_lifespan: int,
              draining_lifespan: int, tombstone_lifespan: int,
              one_second: int, suspicion_window: int = 0):
    """Apply the lifespan sweep to an int32 packed tensor of any shape;
    the lifespans and the window are ints or tensors that broadcast
    against it.

    Returns ``(swept, expired)``: the updated tensor and a bool mask of
    the cells this sweep tombstoned (cells entering SUSPECT are not in
    it)."""
    ts = unpack_ts(known)
    st = unpack_status(known)
    present = is_known(known)

    is_tomb = present & (st == TOMBSTONE)
    gc = is_tomb & (ts < now_tick - tombstone_lifespan)

    def plain():
        lifespan = torch.where(st == DRAINING, draining_lifespan,
                               alive_lifespan)
        expired = present & ~is_tomb & (ts < now_tick - lifespan)
        swept = torch.where(expired, pack(ts + one_second, TOMBSTONE),
                            known)
        return swept, expired

    def quarantine():
        # Quarantine before tombstone: fresh expiries of suspectable
        # records become SUSPECT at the original ts; a SUSPECT record
        # tombstones only once the grace window has also lapsed.
        is_suspect = present & (st == SUSPECT)
        is_drain = present & (st == DRAINING)
        suspectable = present & ~is_tomb & ~is_suspect & ~is_drain
        to_suspect = suspectable & (ts < now_tick - alive_lifespan)
        expired = (is_drain & (ts < now_tick - draining_lifespan)) | \
            (is_suspect & (ts < now_tick - alive_lifespan
                           - suspicion_window))
        swept = torch.where(to_suspect, pack(ts, SUSPECT), known)
        swept = torch.where(expired, pack(ts + one_second, TOMBSTONE),
                            swept)
        return swept, expired

    if isinstance(suspicion_window, torch.Tensor):
        on = suspicion_window > 0
        swept_q, expired_q = quarantine()
        swept_p, expired_p = plain()
        swept = torch.where(on, swept_q, swept_p)
        expired = torch.where(on, expired_q, expired_p)
    elif suspicion_window <= 0:
        swept, expired = plain()
    else:
        swept, expired = quarantine()

    swept = torch.where(gc, 0, swept)
    return swept, expired
