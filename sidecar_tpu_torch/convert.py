"""Carry state, params, time configs and graphs across from the JAX
reference's numpy form (and back), field for field.

The reference's ``CompressedState`` is a dataclass of arrays; its numpy
form is ``{field: np.asarray(value)}``.  Params and time configs travel
as ``dataclasses.asdict`` of the reference dataclasses.  Nothing here
imports the reference: a caller that has both sides converts through
numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sidecar_tpu_torch.models.compressed import (
    CompressedParams,
    CompressedState,
)
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops.topology import Topology

# Field → dtype of the tensor fields of CompressedState.
STATE_DTYPES = {
    "own": torch.int32,
    "cache_slot": torch.int32,
    "cache_val": torch.int32,
    "cache_sent": torch.int8,
    "floor": torch.int32,
    "node_alive": torch.bool,
    "evictions": torch.int32,
    "dropped": torch.int32,
}
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(CompressedState))


def state_from_numpy(arrays: dict, device="cuda") -> CompressedState:
    """A port state from ``{field: np.ndarray}`` (every field of the
    reference's ``CompressedState``); ``round_idx`` becomes a host int."""
    missing = set(STATE_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    kw = {name: torch.as_tensor(np.ascontiguousarray(arrays[name]),
                                dtype=dtype, device=device).contiguous()
          for name, dtype in STATE_DTYPES.items()}
    return CompressedState(round_idx=int(np.asarray(arrays["round_idx"])),
                           **kw)


def state_to_numpy(state: CompressedState) -> dict:
    """``{field: np.ndarray}`` with the reference's dtypes (``round_idx``
    as an int32 scalar array)."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in STATE_DTYPES}
    out["round_idx"] = np.asarray(state.round_idx, dtype=np.int32)
    return out


def params_from_jax_fields(fields: dict) -> CompressedParams:
    """Port params from ``dataclasses.asdict`` of the reference's
    ``CompressedParams``.  ``sparse_cap`` belongs to the sparse-frontier
    round, which the port does not run yet: only its default (0) is
    accepted."""
    fields = dict(fields)
    sparse_cap = fields.pop("sparse_cap", 0)
    if sparse_cap:
        raise NotImplementedError(
            "sparse_cap is not ported yet: ROADMAP.md Queue 1 item 6 "
            "(execution modes: sparse-frontier round)")
    return CompressedParams(**fields)


def timecfg_from_fields(fields: dict) -> TimeConfig:
    """Port time config from ``dataclasses.asdict`` of the reference's
    ``TimeConfig``."""
    return TimeConfig(**fields)


def topology_from_numpy(n: int, nbrs=None, deg=None,
                        name: str = "complete") -> Topology:
    """A port topology from the reference's ``(n, nbrs, deg)``; ``nbrs``
    None is the complete graph."""
    if nbrs is None:
        return Topology(n=n, name=name)
    return Topology(n=n, nbrs=np.asarray(nbrs, dtype=np.int32),
                    deg=np.asarray(deg, dtype=np.int32), name=name)
