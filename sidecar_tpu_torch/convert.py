"""Carry state, params, time configs and graphs across from the JAX
reference's numpy form (and back), field for field, for both models.

The reference's states (``CompressedState``, the exact model's
``SimState``) are dataclasses of arrays; their numpy form is ``{field:
np.asarray(value)}``.  Params and time configs travel as
``dataclasses.asdict`` of the reference dataclasses.  Nothing here
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
from sidecar_tpu_torch.models.exact import SimParams, SimState
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
# Field → dtype of the tensor fields of the exact model's SimState.
EXACT_STATE_DTYPES = {
    "known": torch.int32,
    "sent": torch.int8,
    "node_alive": torch.bool,
}
EXACT_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


def _state_from_numpy(cls, dtypes, arrays: dict, device):
    fields = tuple(f.name for f in dataclasses.fields(cls))
    missing = set(fields) - set(arrays)
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    kw = {name: torch.as_tensor(np.ascontiguousarray(arrays[name]),
                                dtype=dtype, device=device).contiguous()
          for name, dtype in dtypes.items()}
    return cls(round_idx=int(np.asarray(arrays["round_idx"])), **kw)


def state_from_numpy(arrays: dict, device="cuda") -> CompressedState:
    """A compressed-model state from ``{field: np.ndarray}`` (every
    field of the reference's ``CompressedState``); ``round_idx`` becomes
    a host int."""
    return _state_from_numpy(CompressedState, STATE_DTYPES, arrays, device)


def exact_state_from_numpy(arrays: dict, device="cuda") -> SimState:
    """An exact-model state from ``{field: np.ndarray}`` (every field of
    the reference's exact ``SimState``); ``round_idx`` becomes a host
    int."""
    return _state_from_numpy(SimState, EXACT_STATE_DTYPES, arrays, device)


def state_to_numpy(state) -> dict:
    """``{field: np.ndarray}`` of either model's state, with the
    reference's dtypes (``round_idx`` as an int32 scalar array)."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        out[f.name] = (np.asarray(value, dtype=np.int32)
                       if f.name == "round_idx"
                       else value.detach().cpu().numpy())
    return out


def params_from_jax_fields(fields: dict) -> CompressedParams:
    """Compressed-model params from ``dataclasses.asdict`` of the
    reference's ``CompressedParams``."""
    return CompressedParams(**fields)


def exact_params_from_jax_fields(fields: dict) -> SimParams:
    """Exact-model params from ``dataclasses.asdict`` of the reference's
    exact ``SimParams``."""
    return SimParams(**fields)


def timecfg_from_fields(fields: dict) -> TimeConfig:
    """Port time config from ``dataclasses.asdict`` of the reference's
    ``TimeConfig``."""
    return TimeConfig(**fields)


def topology_from_numpy(n: int, nbrs=None, deg=None,
                        name: str = "complete", *, stagger=None,
                        stagger_period: int = 1) -> Topology:
    """A port topology from the reference's ``(n, nbrs, deg)`` and, where
    it staggers rounds, its ``stagger``/``stagger_period``; ``nbrs``
    None is the complete graph."""
    stagger = None if stagger is None else np.asarray(stagger,
                                                      dtype=np.int32)
    if nbrs is None:
        return Topology(n=n, name=name, stagger=stagger,
                        stagger_period=int(stagger_period))
    return Topology(n=n, nbrs=np.asarray(nbrs, dtype=np.int32),
                    deg=np.asarray(deg, dtype=np.int32), name=name,
                    stagger=stagger, stagger_period=int(stagger_period))
