"""Checkpoint and resume of a simulated cluster's state — the port of
``sidecar_tpu/sim/checkpoint.py``, for both models (and their sharded
twins, whose state is the single-device one).

The file is the reference's ``.npz`` layout (``FORMAT_VERSION`` 2, the
version-1 exact files too), so a reference file loads into the port and
a port file loads into the reference.  The reference rebuilds its
randomness from the key and ``round_idx``; the port's draws come from a
generator stream (``models/common.round_draws``), so
:func:`save_state` also stores ``generator.get_state()`` under
:data:`GENERATOR_KEY` when a generator is given, and :func:`load_state`
restores it into the generator it is given — a resumed run then equals a
straight one.  The reference's loader reads only the state's fields and
ignores that key.  A generator's state restores only into a generator
of the same device type.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.models.compressed import (
    CompressedParams,
    CompressedState,
    hash_line,
)
from sidecar_tpu_torch.models.exact import SimParams, SimState

FORMAT_VERSION = 2
GENERATOR_KEY = "generator_state"

_KINDS = {
    "exact": (SimState, SimParams, convert.EXACT_STATE_DTYPES),
    "compressed": (CompressedState, CompressedParams, convert.STATE_DTYPES),
}


def _kind_of(state) -> str:
    for kind, (state_cls, _, _) in _KINDS.items():
        if isinstance(state, state_cls):
            return kind
    raise TypeError(f"unsupported state type {type(state).__name__}")


def save_state(path, state, params, generator=None) -> None:
    """Write state + params (and ``generator``'s state, when given) to a
    compressed npz."""
    kind = _kind_of(state)
    _, params_cls, _ = _KINDS[kind]
    if not isinstance(params, params_cls):
        raise TypeError(
            f"{type(state).__name__} must be saved with "
            f"{params_cls.__name__}, got {type(params).__name__}")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = convert.state_to_numpy(state)
    if generator is not None:
        arrays[GENERATOR_KEY] = generator.get_state().numpy()
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        kind=kind,
        params=json.dumps(dataclasses.asdict(params)),
        **arrays,
    )


def load_state(path, device="cuda", generator=None):
    """Load a checkpoint onto ``device`` → (state, params); raises
    ValueError on version or shape mismatch.  Version-1 files (exact
    model only, no ``kind`` field) load too.  With ``generator``, the
    stored generator state (where the file has one) is restored into
    it."""
    dev = common.resolve_device(device, "load_state")
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        version = int(data["version"])
        if version == 1:
            kind = "exact"
        elif version == FORMAT_VERSION:
            kind = str(data["kind"])
        else:
            raise ValueError(
                f"checkpoint version {version} unsupported "
                f"(expected <= {FORMAT_VERSION})")
        if kind not in _KINDS:
            raise ValueError(f"unknown checkpoint kind {kind!r}")
        state_cls, params_cls, dtypes = _KINDS[kind]
        params = params_cls(**json.loads(str(data["params"])))
        # Fields ADDED after a format was frozen default to zero scalars
        # so older files stay loadable — but only those exact fields: a
        # file missing anything else (e.g. a truncated npz without
        # round_idx) must still fail loudly, not resume at tick 0.
        added_fields = {"dropped"}
        missing = {f.name for f in dataclasses.fields(state_cls)
                   if f.name not in data} - added_fields
        if missing:
            raise ValueError(
                f"checkpoint is missing state field(s) {sorted(missing)}")
        kw = {}
        for f in dataclasses.fields(state_cls):
            if f.name == "round_idx":
                kw[f.name] = int(data[f.name])
            elif f.name in data:
                kw[f.name] = torch.as_tensor(
                    np.ascontiguousarray(data[f.name]),
                    dtype=dtypes[f.name], device=dev).contiguous()
            else:
                kw[f.name] = torch.zeros((), dtype=torch.int32, device=dev)
        state = state_cls(**kw)
        if generator is not None and GENERATOR_KEY in data:
            generator.set_state(torch.as_tensor(data[GENERATOR_KEY]))

    if kind == "exact":
        expect = {"known": (params.n, params.m),
                  "sent": (params.n, params.m),
                  "node_alive": (params.n,)}
    else:
        expect = {
            "own": (params.n, params.services_per_node),
            "cache_slot": (params.n, params.cache_lines),
            "cache_val": (params.n, params.cache_lines),
            "cache_sent": (params.n, params.cache_lines),
            "floor": (params.m,),
            "node_alive": (params.n,),
        }
    for name, shape in expect.items():
        got = tuple(getattr(state, name).shape)
        if got != shape:
            raise ValueError(
                f"checkpoint shape {name}={got} does not match params "
                f"{shape}")
    if kind == "compressed":
        _validate_cache_placement(state, params)
    return state, params


def _validate_cache_placement(state, params) -> None:
    """Fail loudly on checkpoints whose cache entries sit on lines the
    CURRENT hash no longer assigns them: every occupied line must equal
    ``hash_line(slot)``, or the census and the own-offer insert (no
    collision handling) break after a resume."""
    cache_slot = state.cache_slot
    occupied = cache_slot >= 0
    if not bool(occupied.any()):
        return
    lines = torch.arange(cache_slot.shape[1], dtype=torch.int64,
                         device=cache_slot.device)[None, :].expand(
        cache_slot.shape)
    expected = hash_line(torch.where(occupied, cache_slot, 0),
                         params.cache_lines, params.services_per_node)
    bad = occupied & (lines != expected.to(torch.int64))
    if bool(bad.any()):
        n_bad = int(bad.sum())
        node, line = (int(v) for v in torch.nonzero(bad)[0])
        raise ValueError(
            f"checkpoint cache layout mismatch: {n_bad} cache entr"
            f"{'y' if n_bad == 1 else 'ies'} sit on lines the current "
            f"hash_line does not assign them (first: node {node}, line "
            f"{line}, slot {int(cache_slot[node, line])}).  This "
            "checkpoint predates the owner-run cache layout; resuming it "
            "would corrupt the census — re-run the scenario or migrate "
            "the checkpoint")
