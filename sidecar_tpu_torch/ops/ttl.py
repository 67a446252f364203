"""Record-lifespan sweep — the port of ``sidecar_tpu/ops/ttl.py``
``ttl_sweep`` in its two static-window forms.

Tombstones older than the tombstone lifespan are garbage-collected; any
other record not refreshed within its lifespan (alive, or draining) is
tombstoned at its ORIGINAL timestamp + 1 s (the "+1 s rule").  With a
suspicion window > 0, expired non-DRAINING records first sit SUSPECT
at their original timestamp for the window.  The window is a Python
int here: the reference's traced-window select belongs to the fleet
engine, which the port does not run yet.
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
    """Apply the lifespan sweep to an int32 packed tensor of any shape.

    Returns ``(swept, expired)``: the updated tensor and a bool mask of
    the cells this sweep tombstoned (cells entering SUSPECT are not in
    it)."""
    ts = unpack_ts(known)
    st = unpack_status(known)
    present = is_known(known)

    is_tomb = present & (st == TOMBSTONE)
    gc = is_tomb & (ts < now_tick - tombstone_lifespan)

    if suspicion_window <= 0:
        lifespan = torch.where(st == DRAINING, draining_lifespan,
                               alive_lifespan)
        expired = present & ~is_tomb & (ts < now_tick - lifespan)
        swept = torch.where(expired, pack(ts + one_second, TOMBSTONE),
                            known)
    else:
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

    swept = torch.where(gc, 0, swept)
    return swept, expired
