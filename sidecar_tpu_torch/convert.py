"""Carry state, params, time configs and graphs across from the JAX
reference's numpy form (and back), field for field, for both models.

The reference's states (``CompressedState``, the exact model's
``SimState``) are dataclasses of arrays; their numpy form is ``{field:
np.asarray(value)}``.  Params and time configs travel as
``dataclasses.asdict`` of the reference dataclasses.  Nothing here
imports the reference: a caller that has both sides converts through
numpy.

A reference fleet's stacked states (``FleetRun.final_states``: ``[S]``
on every leaf) become the port's batched states
(:func:`fleet_state_from_numpy`: ``[S]`` tensors, the round indices a
tuple of host ints), the chaos state's rings and counters included; a
reference ``ScenarioBatch``'s stacked knobs become the port's
:class:`~sidecar_tpu_torch.ops.knobs.BatchedKnobs`
(:func:`batched_knobs_from_numpy`).
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
from sidecar_tpu_torch.ops import knobs as knob_ops
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


# The chaos state's counters (origin_violations is [N] a scenario).
CHAOS_COUNTERS = ("injected_drops", "injected_delays", "injected_dups",
                  "rejected_future", "forged_records", "rejected_budget",
                  "origin_violations")


def _batched(cls, dtypes, arrays: dict, device):
    fields = tuple(f.name for f in dataclasses.fields(cls))
    missing = set(fields) - set(arrays)
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    kw = {name: torch.as_tensor(np.ascontiguousarray(arrays[name]),
                                dtype=dtype, device=device).contiguous()
          for name, dtype in dtypes.items()}
    rounds = tuple(int(r) for r in np.asarray(arrays["round_idx"]).reshape(-1))
    return cls(round_idx=rounds, **kw)


def fleet_state_from_numpy(arrays: dict, family: str, device="cuda"):
    """A batched fleet state from the reference fleet's stacked numpy
    form: ``family`` ``"exact"`` (``{field: [S, …]}`` of ``SimState``),
    ``"compressed"`` (of ``CompressedState``) or ``"chaos"`` (``{"sim":
    the exact fields, "rings": [(rows, cols, vals) [S, d, L]], counter:
    [S] or [S, N]}``)."""
    if family == "exact":
        return _batched(SimState, EXACT_STATE_DTYPES, arrays, device)
    if family == "compressed":
        return _batched(CompressedState, STATE_DTYPES, arrays, device)
    if family != "chaos":
        raise ValueError(f"unknown fleet family {family!r}")
    from sidecar_tpu_torch.chaos.sim_inject import ChaosSimState

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=device).contiguous()

    return ChaosSimState(
        sim=_batched(SimState, EXACT_STATE_DTYPES, arrays["sim"], device),
        rings=tuple(tuple(i32(t) for t in ring) for ring in arrays["rings"]),
        **{f: i32(arrays[f]) for f in CHAOS_COUNTERS})


def fleet_state_to_numpy(state) -> dict:
    """The inverse of :func:`fleet_state_from_numpy`: ``round_idx`` an
    int32 ``[S]`` array."""
    if hasattr(state, "rings"):
        out = {"sim": fleet_state_to_numpy(state.sim),
               "rings": [tuple(t.cpu().numpy() for t in ring)
                         for ring in state.rings]}
        out.update({f: getattr(state, f).cpu().numpy()
                    for f in CHAOS_COUNTERS})
        return out
    return {f.name: (np.asarray(getattr(state, f.name), dtype=np.int32)
                     if f.name == "round_idx"
                     else getattr(state, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(state)}


def fleet_leaves(arrays: dict) -> dict:
    """A fleet state's numpy form (:func:`fleet_state_to_numpy`) as
    ``{name: array}``: the exact fields (``sim.``-prefixed in a chaos
    state), each ring's ``ring<i>.rows``, ``.cols`` and ``.vals``, and
    the counters."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(x) for kk, x in v.items()})
        elif isinstance(v, (list, tuple)):
            for i, ring in enumerate(v):
                for name, t in zip(("rows", "cols", "vals"), ring):
                    out[f"ring{i}.{name}"] = np.asarray(t)
        else:
            out[k] = np.asarray(v)
    return out


def batched_knobs_from_numpy(fields: dict, device="cuda"):
    """The port's :class:`BatchedKnobs` from a reference ``ScenarioBatch``'s
    stacked knobs, ``{field: [S] array}`` of its ``RoundKnobs``.  The
    float knobs arrive as the reference stacks them, float32."""
    s = len(np.asarray(fields["limit"]).reshape(-1))
    host = []
    for i in range(s):
        kw = {}
        for name in knob_ops.KNOB_FIELDS:
            v = np.asarray(fields[name]).reshape(-1)[i]
            kw[name] = float(v) if name in ("keep_prob", "churn_prob") \
                else int(v)
        host.append(knob_ops.RoundKnobs(**kw))
    return knob_ops.BatchedKnobs.stack(host, device)


# -- rank-local states --------------------------------------------------------

# The node-major fields of either model's state: row i is node i's.  The
# other fields (the compressed model's floor, the counters, round_idx)
# are whole on every rank.
NODE_FIELDS = ("known", "sent", "own", "cache_slot", "cache_val",
               "cache_sent", "node_alive")


def _is_fleet(arrays: dict) -> bool:
    """A fleet state: ``round_idx`` is ``[S]`` and every leaf leads with
    the scenario axis (a chaos state's ``round_idx`` is in ``sim``)."""
    return np.ndim(arrays.get("sim", arrays)["round_idx"]) == 1


def _split(a, rank: int, world: int):
    a = np.asarray(a)
    if a.shape[0] % world:
        raise ValueError(f"an axis of {a.shape[0]} does not divide over "
                         f"{world} ranks")
    per = a.shape[0] // world
    return a[rank * per:(rank + 1) * per]


# A fleet state's node-major leaves (second axis N) and per-scenario
# counters (a node block holds its senders' counts).
FLEET_NODE_FIELDS = ("known", "sent", "node_alive", "origin_violations")
FLEET_COUNTERS = tuple(f for f in CHAOS_COUNTERS
                       if f not in FLEET_NODE_FIELDS)


def _fleet_part(arrays: dict, rank: int, world: int, nd: int) -> dict:
    """Rank ``rank``'s scenario block (``rank // nd`` of ``world / nd``)
    and node block (``rank % nd``) of a fleet state."""
    sd, blk, nb = world // nd, rank // nd, rank % nd

    def node(a, axis):
        a = np.asarray(a)
        if a.shape[axis] % nd:
            raise ValueError(f"an axis of {a.shape[axis]} does not divide "
                             f"over {nd} node blocks")
        per = a.shape[axis] // nd
        return np.take(a, range(nb * per, (nb + 1) * per), axis=axis)

    def part(k, v):
        if isinstance(v, dict):
            return {kk: part(kk, x) for kk, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [tuple(node(_split(t, blk, sd), 2) for t in ring)
                    for ring in v]
        v = _split(v, blk, sd)
        if nd == 1:
            return v
        if k in FLEET_NODE_FIELDS:
            return node(v, 1)
        if k in FLEET_COUNTERS and nb:
            return np.zeros_like(v)
        return v

    return {k: part(k, v) for k, v in arrays.items()}


def _fleet_join(parts: list, nd: int) -> dict:
    """The inverse of :func:`_fleet_part` over every rank's part."""
    def join_nodes(k, vs):
        if isinstance(vs[0], dict):
            return {kk: join_nodes(kk, [v[kk] for v in vs]) for kk in vs[0]}
        if isinstance(vs[0], (list, tuple)):
            return [tuple(np.concatenate([v[i][j] for v in vs], axis=2)
                          for j in range(len(vs[0][i])))
                    for i in range(len(vs[0]))]
        vs = [np.asarray(v) for v in vs]
        if k in FLEET_NODE_FIELDS:
            return np.concatenate(vs, axis=1)
        if k in FLEET_COUNTERS:
            return np.sum(vs, axis=0, dtype=vs[0].dtype)
        for r, v in enumerate(vs[1:], 1):
            if not np.array_equal(v, vs[0]):
                raise ValueError(f"field {k!r} is held whole but node "
                                 f"block {r}'s differs from block 0's")
        return vs[0]

    def join_scen(vs):
        if isinstance(vs[0], dict):
            return {k: join_scen([v[k] for v in vs]) for k in vs[0]}
        if isinstance(vs[0], (list, tuple)):
            return [tuple(np.concatenate([v[i][j] for v in vs])
                          for j in range(len(vs[0][i])))
                    for i in range(len(vs[0]))]
        return np.concatenate([np.asarray(v) for v in vs])

    blocks = [parts[b:b + nd] for b in range(0, len(parts), nd)]
    joined = [{k: join_nodes(k, [p[k] for p in blk]) for k in blk[0]}
              for blk in blocks]
    return {k: join_scen([b[k] for b in joined]) for k in joined[0]}


def shard_state(arrays: dict, rank: int, world: int, d: int = 0,
                node_devices: int = 1) -> dict:
    """Rank ``rank``'s part of a global state in numpy form (``{field:
    np.ndarray}`` of either model, a reference's or the port's): the
    rows of its ``d / world`` shards on the node-major fields, the rest
    whole.  A fleet state (``round_idx`` ``[S]``, the chaos rings and
    counters included) splits its scenario axis instead, over ``world /
    node_devices`` scenario blocks (``d`` is not used): rank ``rank``
    holds scenario block ``rank // node_devices`` of every leaf, and
    with ``node_devices > 1`` node block ``rank % node_devices`` of it —
    the rows of the node-major leaves (``known``, ``sent``,
    ``node_alive``, ``origin_violations``), the senders' lanes of each
    ring, and the counters on node block 0 (zeros on the others: a
    block holds its senders' counts)."""
    if _is_fleet(arrays):
        if node_devices < 1 or world % node_devices:
            raise ValueError(f"node_devices={node_devices} must divide "
                             f"{world} ranks")
        return _fleet_part(arrays, rank, world, node_devices)
    if d < 1 or d % world:
        raise ValueError(f"d={d} shards must divide over {world} ranks")
    return {k: _split(v, rank, world) if k in NODE_FIELDS else np.asarray(v)
            for k, v in arrays.items()}


def join_state(parts: list, node_devices: int = 1) -> dict:
    """The inverse of :func:`shard_state`: the ranks' parts, in rank
    order, as the global numpy state.  A field held whole must be equal
    on every rank (of a node group, for a fleet state), or this raises;
    a fleet's counters are summed over each node group."""
    first = parts[0]
    if _is_fleet(first):
        return _fleet_join(parts, node_devices)
    out = {}
    for k in first:
        vs = [np.asarray(p[k]) for p in parts]
        if k in NODE_FIELDS:
            out[k] = np.concatenate(vs)
            continue
        for r, v in enumerate(vs[1:], 1):
            if not np.array_equal(v, vs[0]):
                raise ValueError(f"field {k!r} is held whole but rank {r}'s "
                                 "differs from rank 0's")
        out[k] = vs[0]
    return out


def shard_inflight(publish, rank: int, world: int) -> tuple:
    """Rank ``rank``'s part of a pipelined carry's publish (an
    :class:`~sidecar_tpu_torch.ops.pipeline.Inflight`'s ``publish``:
    node-major ``[N, ...]`` arrays) over ``world`` ranks: its rows."""
    return tuple(_split(a, rank, world) for a in publish)


def join_inflight(parts: list) -> tuple:
    """The inverse of :func:`shard_inflight`: the ranks' publishes, in
    rank order, as the global one."""
    return tuple(np.concatenate([np.asarray(p[i]) for p in parts])
                 for i in range(len(parts[0])))


def join_stream(parts: list) -> dict:
    """A telemetry plane's result as the ranks of a shard group return
    it (``{field: array or host value}``, every rank the whole stream):
    rank 0's, after checking that every rank's is equal."""
    first = parts[0]
    for r, part in enumerate(parts[1:], 1):
        for k in first:
            if not np.array_equal(np.asarray(part[k]),
                                  np.asarray(first[k])):
                raise ValueError(f"stream field {k!r} of rank {r} differs "
                                 "from rank 0's")
    return first
