"""Service status codes and the packed ``(tick << 3) | status`` int32
key — the port of ``sidecar_tpu/ops/status.py``.

The merge rule "strictly newer timestamp wins" is integer ``max`` on
packed keys; ``ts == 0`` is the unknown sentinel.  Every function takes
an int32 tensor (or a Python int) and keeps int32: ``>>`` on a signed
torch tensor is an arithmetic shift, as ``jnp``'s is.
"""

from __future__ import annotations

import torch

# Mirror of service/service.go:17-23.
ALIVE = 0
TOMBSTONE = 1
UNHEALTHY = 2
UNKNOWN = 3
DRAINING = 4
# Simulator-side suspicion code (above every reference status, so a
# suspicion re-packed at the original timestamp wins same-version ties).
SUSPECT = 5

STATUS_BITS = 3
STATUS_MASK = (1 << STATUS_BITS) - 1

# Highest representable tick in a non-negative int32 packed key.
MAX_TICK = (1 << (31 - STATUS_BITS)) - 1  # 268_435_455

# Knuth's multiplicative constant — the slot-phase spreader for the
# refresh stagger and the publish tie rotation — and the mask that keeps
# a product's low 32 bits (uint32 arithmetic done in int64).
PHASE_MULT = 2654435761
MASK32 = 0xFFFFFFFF


def _i32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.as_tensor(x, dtype=torch.int32)


def pack(ts, status):
    """Pack (logical tick, status) into an int32 key.  Two Python ints
    give a Python int; otherwise an int32 tensor."""
    if isinstance(ts, int) and isinstance(status, int):
        return (ts << STATUS_BITS) | status
    if isinstance(ts, torch.Tensor):
        return (_i32(ts) << STATUS_BITS) | status
    return (ts << STATUS_BITS) | _i32(status)


def unpack_ts(packed):
    """Logical tick of a packed key (0 = unknown sentinel)."""
    return _i32(packed) >> STATUS_BITS


def unpack_status(packed):
    """Status code of a packed key (meaningless when ts == 0)."""
    return _i32(packed) & STATUS_MASK


def is_known(packed):
    """True where the cell holds a real record (ts > 0)."""
    return unpack_ts(packed) > 0
