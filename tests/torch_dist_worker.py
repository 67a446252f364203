"""The rank bodies of ``tests/test_torch_dist.py`` and
``tests/test_torch_dist_paths.py``: each rank of a gloo group runs every
case in turn and returns its rank-local results.

This module imports only torch, numpy and the port, so a spawned rank
never imports JAX; the cases arrive as plain data (numpy arrays, dicts
and tuples) that the test built from the reference's draws.  The same
bodies run in the test process with :class:`LocalContext`, whose groups
are the one-process :class:`LocalShardGroup`: that is the one-process
run each case is held against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sidecar_tpu_torch import convert
from sidecar_tpu_torch.chaos import FaultPlan
from sidecar_tpu_torch.chaos.sim_inject import FaultDraws
from sidecar_tpu_torch.fleet import (
    FleetSim,
    ScenarioBatch,
    ScenarioSpec,
    restart_churn_perturb,
)
from sidecar_tpu_torch.models.compressed import CompressedParams
from sidecar_tpu_torch.models.exact import SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    TOMBSTONE,
    pack,
    unpack_status,
    unpack_ts,
)
from sidecar_tpu_torch.parallel import (
    LocalShardGroup,
    ShardedCompressedSim,
    ShardedSim,
)
from sidecar_tpu_torch.sim import scenarios

# The dtypes the collective cases exchange.
COLLECTIVE_DTYPES = {"int32": torch.int32, "int8": torch.int8}


def draws_to_data(draws) -> list:
    """:class:`RoundDraws` as picklable tuples of numpy arrays."""
    def arr(t):
        return None if t is None else t.numpy()

    return [(d.peer_slot.numpy(), int(d.stride), arr(d.keep),
             arr(d.pp_slot)) for d in draws]


def draws_from_data(data) -> list:
    def tensor(a):
        return None if a is None else torch.as_tensor(a)

    return [RoundDraws(peer_slot=torch.as_tensor(slot), stride=stride,
                       keep=tensor(keep), pp_slot=tensor(pp))
            for slot, stride, keep, pp in data]


def faults_to_data(faults) -> list:
    """:class:`FaultDraws` as picklable tuples of numpy arrays."""
    def arr(t):
        return None if t is None else t.numpy()

    return [(arr(f.drop_u), [arr(t) for t in f.delay_u],
             [arr(t) for t in f.dup_u]) for f in faults]


def faults_from_data(data) -> list:
    def tensor(a):
        return None if a is None else torch.as_tensor(a)

    return [FaultDraws(tensor(drop), tuple(map(tensor, delay)),
                       tuple(map(tensor, dup))) for drop, delay, dup in data]


def topology(data):
    return convert.topology_from_numpy(*data[:4], stagger=data[4],
                                       stagger_period=data[5])


def collective_inputs(d: int, dtype: str, seed: int = 0):
    """Every shard's inputs of the collective case: a ``[3, 5]`` block,
    a ``[d, 2, 3]`` all-to-all buffer, a replica and a ``[2d, 4]`` row
    tensor (two rows a shard)."""
    rng = np.random.default_rng(seed + d)
    t = COLLECTIVE_DTYPES[dtype]

    def draw(*shape):
        return torch.as_tensor(rng.integers(-100, 100, shape), dtype=t)

    return ([draw(3, 5) for _ in range(d)], [draw(d, 2, 3) for _ in range(d)],
            [draw(4, 3) for _ in range(d)], draw(2 * d, 4))


# Two permutations: the ring, and one that names no pair for shard 0.
def perms(d: int):
    return {"ring": [(i, (i - 1) % d) for i in range(d)],
            "partial": [(i, (i + 1) % d) for i in range(d - 1)]}


def group_outputs(g, d: int, dtype: str, rows_held=None) -> dict:
    """Every collective of ``g`` on the collective case's inputs, as
    numpy arrays: per local shard for the shard collectives, the rank's
    rows for the row collectives."""
    blocks, buffers, replicas, rows = collective_inputs(d, dtype)
    loc = list(g.local)
    held = rows if rows_held is None else rows[rows_held]
    out = {"all_gather": g.all_gather([blocks[s] for s in loc]),
           "all_to_all": g.all_to_all([buffers[s] for s in loc]),
           "pmax": g.pmax([replicas[s] for s in loc]),
           "psum": g.psum([replicas[s] for s in loc]),
           "gather_rows": [g.gather_rows(held)],
           "shift_rows": [g.shift_rows(held, k) for k in (0, 1, 3, -5)],
           "all_reduce_max": [g.all_reduce_max(replicas[loc[0]])],
           "all_reduce_sum": [g.all_reduce_sum(replicas[loc[0]])]}
    for name, perm in perms(d).items():
        out[f"ppermute_{name}"] = g.ppermute([blocks[s] for s in loc], perm)
    return {k: [t.numpy() for t in v] for k, v in out.items()}


def run_collectives(ctx, d: int, dtype: str) -> dict:
    g = ctx.group(d)
    per = 2 * d // g.world
    return group_outputs(g, d, dtype,
                         slice(g.rank * per, (g.rank + 1) * per))


def run_subgroup_collectives(ctx, size: int, dtype: str) -> dict:
    """The collective case on this rank's block of ``size`` consecutive
    ranks (``DistShardGroup.split``): ``size`` shards, one a rank."""
    g = ctx.fleet_groups(size)[1]
    out = group_outputs(g, size, dtype, slice(2 * g.rank, 2 * g.rank + 2))
    out["ranks"] = [np.asarray(g.ranks)]
    return out


def run_exact(ctx, *, d, params, topo, time, draws, state, sim_kw) -> dict:
    g = ctx.group(d)
    sim = ShardedSim(SimParams(**params), topology(topo), TimeConfig(**time),
                     d=d, device=ctx.device, group=g, **sim_kw)
    st = convert.exact_state_from_numpy(
        convert.shard_state(state, g.rank, g.world, d), ctx.device)
    final, conv = sim.run(st, len(draws), draws=draws_from_data(draws))
    out = {"state": convert.state_to_numpy(final), "conv": conv,
           "exchange": dict(g.stats)}
    if sim.last_sparse_stats is not None:
        out["sparse_stats"] = sim.last_sparse_stats
    return out


def run_compressed(ctx, *, d, params, topo, time, chunks, dead,
                   sim_kw) -> dict:
    """The rank-local boot state (``dead`` nodes down), then per chunk a
    rank-local ``mint`` and ``run_behind``."""
    g = ctx.group(d)
    sim = ShardedCompressedSim(CompressedParams(**params), topology(topo),
                               TimeConfig(**time), d=d, device=ctx.device,
                               group=g, **sim_kw)
    st = sim.init_state()
    if dead:
        rows = sim._rows()
        for node in dead:
            if rows.start <= node < rows.stop:
                st.node_alive[node - rows.start] = False
    curves = []
    for slots, tick, status, draws in chunks:
        st = sim.mint(st, slots, tick, status)
        st, behind = sim.run_behind(st, len(draws), 1,
                                    draws=draws_from_data(draws))
        curves.append(behind)
    return {"state": convert.state_to_numpy(st),
            "behind": torch.cat(curves), "convergence": sim.convergence(st),
            "dropped": sim.sync_exchange_metrics(st),
            "exchange": dict(g.stats)}


def run_fleet(ctx, *, specs, params, time, rounds, draws, stop,
              eps) -> dict:
    batch = ScenarioBatch.build([ScenarioSpec(**s) for s in specs],
                                SimParams(**params), TimeConfig(**time),
                                device=ctx.device)
    fleet = FleetSim(batch, group=ctx.group(ctx.world))
    run = fleet.run(fleet.init_states(), rounds, draws=[
        draws_from_data(dr) for dr in draws], stop=stop, eps=eps)
    t = batch.timecfg
    return {"table": run.table(t.round_ticks, t.ticks_per_second),
            "convergence": run.convergence, "rounds": run.rounds,
            "host_reads": run.host_reads}


def run_fleet_nodes(ctx, *, nd, specs, params, time, plan, rounds, draws,
                    faults, masks, stop, eps, tracked) -> dict:
    """A fleet over ``ctx``'s ranks laid as ``(world / nd, nd)``
    scenario and node blocks (``nd = 1``: the scenario axis, or one
    process), fed the given draws, fault draws and churn masks (per
    scenario ``{round: bool [M]}`` or None): every table row, the
    gathered curve and ``first_seen``, the rank's final state and its
    K4a launches (none on the CPU)."""
    from sidecar_tpu_torch.ops.kernels import scatter_max

    batch = ScenarioBatch.build(
        [ScenarioSpec(**sp) for sp in specs], SimParams(**params),
        TimeConfig(**time), plan=None if plan is None else
        FaultPlan.loads(plan), device=ctx.device)
    perturb = None
    if any(m is not None for m in masks):
        perturb = restart_churn_perturb(batch.params, masks=[
            None if m is None else {r: torch.as_tensor(v)
                                    for r, v in m.items()} for m in masks])
    g = ctx.fleet_groups(nd)[0] if nd > 1 else ctx.group(ctx.world)
    fleet = FleetSim(batch, perturb=perturb, group=g, node_devices=nd)
    before = scatter_max.scatter_max_apply_cuda.launches
    run = fleet.run(fleet.init_states(), rounds, eps=eps, stop=stop,
                    tracked=tracked,
                    draws=[draws_from_data(d) for d in draws],
                    fault_draws=None if faults is None else
                    [faults_from_data(f) for f in faults])
    t = batch.timecfg
    return {"table": run.table(t.round_ticks, t.ticks_per_second),
            "convergence": run.convergence, "rounds": run.rounds,
            "eps_round": run.eps_round, "first_seen": run.first_seen,
            "exchange_bytes": run.exchange_bytes,
            "frontier_max": run.frontier_max, "host_reads": run.host_reads,
            "state": convert.fleet_state_to_numpy(run.final_states),
            "exchange": stats_of(g),
            "node_exchange": stats_of(fleet.nodes.group),
            "k4a": scatter_max.scatter_max_apply_cuda.launches - before}


# -- the paths of tests/test_torch_dist_paths.py ------------------------------


class LocalContext:
    """A rank context of one process: its groups are
    :class:`LocalShardGroup`, every shard here."""

    rank, world = 0, 1
    device = torch.device("cpu")

    @staticmethod
    def group(d: int):
        return LocalShardGroup(d)


def stats_of(g) -> dict:
    """A group's exchange accounting (none for the one-process group)."""
    return dict(getattr(g, "stats", {}))


def stream_data(stream) -> dict:
    """A telemetry stream's fields (a dataclass of tensors and host
    values) as a dict."""
    return {f.name: getattr(stream, f.name)
            for f in dataclasses.fields(stream)}


def run_plane(sim, state, plane, draws, tracked=(), delta_cap=0):
    """``sim.run_with_<plane>`` from ``state`` on ``draws``: ``(final,
    stream dict, curve or None)``."""
    if plane == "provenance":
        out = sim.run_with_provenance(state, len(draws), tracked,
                                      draws=draws)
    elif plane == "deltas":
        out = sim.run_with_deltas(state, len(draws), delta_cap, draws=draws)
    else:
        out = getattr(sim, f"run_with_{plane}")(state, len(draws),
                                                draws=draws)
    return out[0], stream_data(out[1]), out[2] if len(out) > 2 else None


def exact_twin(ctx, d, params, topo, time, sim_kw):
    g = ctx.group(d)
    return g, ShardedSim(SimParams(**params), topology(topo),
                         TimeConfig(**time), d=d, device=ctx.device,
                         group=g, **sim_kw)


def compressed_twin(ctx, d, params, topo, time, sim_kw, hook=None):
    g = ctx.group(d)
    return g, ShardedCompressedSim(CompressedParams(**params), topology(topo),
                                   TimeConfig(**time), d=d,
                                   device=ctx.device, group=g, perturb=hook,
                                   **sim_kw)


def rank_state(g, d, state, device):
    """The rank's part of a global exact state in numpy form, on fresh
    buffers (the exact model's runs write their state in place)."""
    part = convert.shard_state(state, g.rank, g.world, d)
    return convert.exact_state_from_numpy(
        {k: np.array(v) for k, v in part.items()}, device)


def run_exact_planes(ctx, *, d, params, topo, time, draws, state, sim_kw,
                     planes, tracked) -> dict:
    """Each plane of the exact twin from the global start ``state``."""
    g, sim = exact_twin(ctx, d, params, topo, time, sim_kw)
    out = {}
    for plane in planes:
        start = rank_state(g, d, state, ctx.device)
        final, stream, conv = run_plane(sim, start, plane,
                                        draws_from_data(draws), tracked)
        out[plane] = {"state": convert.state_to_numpy(final),
                      "stream": stream, "conv": conv}
    out["exchange"] = stats_of(g)
    return out


def run_compressed_planes(ctx, *, d, params, topo, time, draws, sim_kw,
                          planes, tracked, mint, delta_cap) -> dict:
    """Each plane of the compressed twin from the boot state and a
    rank-local ``mint``."""
    g, sim = compressed_twin(ctx, d, params, topo, time, sim_kw)
    out = {}
    for plane in planes:
        st = sim.mint(sim.init_state(), *mint)
        final, stream, _ = run_plane(sim, st, plane, draws_from_data(draws),
                                     tracked, delta_cap)
        out[plane] = {"state": convert.state_to_numpy(final),
                      "stream": stream}
    out["dropped"] = sim.sync_exchange_metrics(final)
    out["exchange"] = stats_of(g)
    return out


def pipelined_chunks(sim, st, draws, conv, *, split):
    """Prime, then ``run_pipelined`` for ``split`` ticks, two
    ``step_pipelined`` ticks and ``run_pipelined`` for the rest; the
    curve of every tick.  Then ``run_fast_pipelined`` from a second
    prime over every tick.  Returns ``(final, curve, publish,
    fast final)``."""
    st0 = st
    st, inf = sim.prime_pipeline(st, draws=draws[0])
    st, c1, inf = sim.run_pipelined(st, split, inflight=inf,
                                    draws=draws[1:split + 1])
    curve = [c1]
    for i in (split + 1, split + 2):
        st, inf = sim.step_pipelined(st, inf, draws=draws[i])
        curve.append(conv(st).reshape(1))
    rest = len(draws) - split - 3
    st, c2, inf = sim.run_pipelined(st, rest, inflight=inf,
                                    draws=draws[split + 3:])
    curve.append(c2)
    fast, _ = sim.run_fast_pipelined(st0, len(draws) - 1, draws=draws)
    return st, torch.cat(curve), inf.publish, fast


def run_exact_pipelined(ctx, *, d, params, topo, time, draws, state, sim_kw,
                        split) -> dict:
    """The exact twin's pipelined round from the global ``state``."""
    g, sim = exact_twin(ctx, d, params, topo, time, sim_kw)
    final, curve, publish, fast = pipelined_chunks(
        sim, rank_state(g, d, state, ctx.device), draws_from_data(draws),
        sim.convergence, split=split)
    return {"state": convert.state_to_numpy(final), "conv": curve,
            "publish": publish, "fast": convert.state_to_numpy(fast),
            "exchange": stats_of(g)}


def run_compressed_pipelined(ctx, *, d, params, topo, time, draws, sim_kw,
                             mint, split) -> dict:
    """The compressed twin's pipelined round from the boot state and a
    rank-local ``mint``."""
    g, sim = compressed_twin(ctx, d, params, topo, time, sim_kw)
    st = sim.mint(sim.init_state(), *mint)
    final, curve, publish, fast = pipelined_chunks(
        sim, st, draws_from_data(draws), sim.convergence, split=split)
    return {"state": convert.state_to_numpy(final), "conv": curve,
            "publish": publish, "fast": convert.state_to_numpy(fast),
            "dropped": sim.sync_exchange_metrics(final),
            "exchange": stats_of(g)}


def own_churn_hook(churn, flip_alive, services_per_node, round_ticks):
    """A compressed-state scenario hook: each round the slots of
    ``churn[r]`` (bool ``[M]``) restart — an owner's ALIVE record is
    tombstoned at ``now``, any other re-announced ALIVE — and the nodes
    of ``flip_alive[r]`` (bool ``[N]``) toggle their liveness; ``r`` is
    the round the hook runs before.  Row-local: on a rank it touches
    only its ``rows``."""
    def hook(state, now, rows=None):
        r = now // round_ticks
        if r not in churn:
            return state
        rows = slice(None) if rows is None else rows
        own = state.own
        pick = torch.as_tensor(churn[r], device=own.device).reshape(
            -1, services_per_node)[rows]
        flip = pick & (unpack_ts(own) > 0) & state.node_alive[:, None]
        new_status = torch.where(unpack_status(own) == ALIVE, TOMBSTONE,
                                 ALIVE)
        own = torch.where(flip, pack(now, new_status), own)
        alive = state.node_alive ^ torch.as_tensor(
            flip_alive[r], device=own.device)[rows]
        return dataclasses.replace(state, own=own, node_alive=alive)

    hook.row_local = True
    return hook


def run_compressed_perturb(ctx, *, d, params, topo, time, draws, sim_kw,
                           mint, churn, flip_alive) -> dict:
    """The compressed twin with :func:`own_churn_hook`: its behind curve
    and final state."""
    p = CompressedParams(**params)
    hook = own_churn_hook(churn, flip_alive, p.services_per_node,
                          TimeConfig(**time).round_ticks)
    g, sim = compressed_twin(ctx, d, params, topo, time, sim_kw, hook)
    st = sim.mint(sim.init_state(), *mint)
    final, behind = sim.run_behind(st, len(draws), 1,
                                   draws=draws_from_data(draws))
    return {"state": convert.state_to_numpy(final), "behind": behind,
            "convergence": sim.convergence(final),
            "exchange": stats_of(g)}


def run_gate(ctx, *, d, params, topo, time, states) -> dict:
    """``gate_predicates`` of the digest-gated zoned twin on each global
    ``known`` of ``states``."""
    g, sim = exact_twin(ctx, d, params, topo, time,
                        dict(board_exchange="zoned", digest_gate=True))
    out = []
    for known in states:
        n = known.shape[0]
        st = rank_state(g, d, {"known": known,
                               "sent": np.zeros(known.shape, np.int8),
                               "node_alive": np.ones(n, bool),
                               "round_idx": np.int32(0)}, ctx.device)
        out.append(sim.gate_predicates(st))
    return {"predicates": out, "exchange": stats_of(g)}


def run_scenario(ctx, *, name, d, kwargs) -> dict:
    """Config 4 or 5 over a group of ``d`` shards: the result's curve
    and ε round."""
    fn = {"config4": scenarios.config4_ba_antientropy,
          "config5": scenarios.config5_split_heal}[name]
    g = ctx.group(d)
    res = fn(device=ctx.device, group=g, **kwargs)
    return {"n": res.n, "convergence": res.convergence,
            "eps_round": res.eps_round, "rounds_run": res.rounds_run,
            "exchange": stats_of(g)}


def routed_inputs(world: int, rows: int = 8, seed: int = 2):
    """The routed row collectives' case: a global ``[world·rows, 3]``
    int32 tensor, and per rank the global ids it names (any rank's rows,
    repeats included; rank 0 names none of rank 1's rows) and the rows it
    folds onto them."""
    rng = np.random.default_rng(seed)
    n = world * rows
    x = torch.as_tensor(rng.integers(-50, 50, (n, 3)), dtype=torch.int32)
    idx, vals = [], []
    for r in range(world):
        k = 5 + 3 * r
        ids = rng.integers(0, rows if r == 0 else n, k)
        idx.append(torch.as_tensor(ids, dtype=torch.int64))
        vals.append(torch.as_tensor(rng.integers(-50, 100, (k, 3)),
                                    dtype=torch.int32))
    return x, idx, vals


def run_routed(ctx, *, world) -> dict:
    """``fetch_rows`` and ``scatter_max_rows`` of the group on this
    rank's rows of :func:`routed_inputs`."""
    g = ctx.group(ctx.world)
    x, idx, vals = routed_inputs(world)
    rows = slice(g.rank * x.shape[0] // g.world,
                 (g.rank + 1) * x.shape[0] // g.world)
    held = x[rows].clone()
    return {"fetched": g.fetch_rows(held, idx[g.rank]),
            "folded": g.scatter_max_rows(held, idx[g.rank], vals[g.rank]),
            "exchange": stats_of(g)}


CASES = {"collectives": run_collectives,
         "subgroup_collectives": run_subgroup_collectives,
         "fleet_nodes": run_fleet_nodes,
         "exact": run_exact, "compressed": run_compressed, "fleet": run_fleet,
         "exact_planes": run_exact_planes,
         "compressed_planes": run_compressed_planes,
         "exact_pipelined": run_exact_pipelined,
         "compressed_pipelined": run_compressed_pipelined,
         "compressed_perturb": run_compressed_perturb,
         "gate": run_gate, "scenario": run_scenario, "routed": run_routed}


def run_cases(ctx, cases) -> dict:
    """Run ``cases`` (``[(id, kind, kwargs)]``) in turn on this rank."""
    return {cid: CASES[kind](ctx, **kw) for cid, kind, kw in cases}


def fail_on_rank_one(ctx):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    g = ctx.group(ctx.world)
    if ctx.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return g.gather_rows(torch.zeros(1, dtype=torch.int32))


def group_against_local(ctx, d: int = 4, rounds: int = 12) -> dict:
    """On this rank's device: the exact and compressed twins through a
    group of ``d`` shards over the ranks (world 1: every shard here) and
    through ``LocalShardGroup``, from one set of CPU draws; whether each
    pair's final state and curve differ."""
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    out = {}
    topo = erdos_renyi(64, avg_degree=6.0, seed=3)
    time = TimeConfig(refresh_interval_s=2.0, push_pull_interval_s=1.0,
                      sweep_interval_s=0.4)
    for label, make, params in (
            ("exact", ShardedSim, SimParams(n=64, services_per_node=4,
                                            fanout=3, budget=6,
                                            drop_prob=0.1)),
            ("compressed", ShardedCompressedSim,
             CompressedParams(n=64, services_per_node=4, cache_lines=16,
                              drop_prob=0.1))):
        for mode in ("all_gather", "ring"):
            sims = [make(params, topo, time, d=d, board_exchange=mode,
                         device=ctx.device, group=g)
                    for g in (ctx.group(d), None)]
            gen = torch.Generator().manual_seed(5)
            draws = [sims[0].draw(gen, r) for r in range(1, rounds + 1)]
            runs = [sim.run(sim.init_state(), rounds, draws=draws)
                    for sim in sims]
            (a, ca), (b, cb) = runs
            x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
            out[f"{label}-{mode}"] = {
                "fields_differ": [f for f in x
                                  if not np.array_equal(x[f], y[f])],
                "curve_equal": bool(torch.equal(ca, cb))}
    return out


def paths_against_local(ctx, d: int = 4, rounds: int = 12) -> dict:
    """On this rank's device, in a group of one rank (its state is
    whole): the exact twin's trace and the compressed twin's pipelined
    ticks (prime, then one ``step_pipelined`` a round) through a group
    of ``d`` shards and through ``LocalShardGroup``, from one set of CPU
    draws; which fields differ and whether the streams, curves and
    carries are equal."""
    from sidecar_tpu_torch.ops.topology import erdos_renyi

    topo = erdos_renyi(64, avg_degree=6.0, seed=3)
    time = TimeConfig(refresh_interval_s=2.0, push_pull_interval_s=1.0,
                      sweep_interval_s=0.4)
    out = {}
    sims = [ShardedSim(SimParams(n=64, services_per_node=4, fanout=3,
                                 budget=6, drop_prob=0.1), topo, time, d=d,
                       board_exchange="ring", device=ctx.device, group=g)
            for g in (ctx.group(d), None)]
    gen = torch.Generator().manual_seed(5)
    draws = [sims[0].draw(gen, r) for r in range(1, rounds + 1)]
    (a, ta, ca), (b, tb, cb) = [sim.run_with_trace(sim.init_state(), rounds,
                                                   draws=draws)
                                for sim in sims]
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    out["exact-trace"] = {
        "fields_differ": [f for f in x if not np.array_equal(x[f], y[f])],
        "equal": (bool(torch.equal(ta.rec, tb.rec)) and ta.count == tb.count
                  and bool(torch.equal(ca, cb)))}
    sims = [ShardedCompressedSim(
        CompressedParams(n=64, services_per_node=4, cache_lines=16,
                         drop_prob=0.1), topo, time, d=d,
        board_exchange="ring", device=ctx.device, group=g)
        for g in (ctx.group(d), None)]
    gen = torch.Generator().manual_seed(6)
    draws = [sims[0].draw(gen, r) for r in range(1, rounds + 2)]
    ends = []
    for sim in sims:
        st = sim.mint(sim.init_state(), np.arange(0, 256, 9), 7)
        st, inf = sim.prime_pipeline(st, draws=draws[0])
        curve = []
        for i in range(1, rounds + 1):
            st, inf = sim.step_pipelined(st, inf, draws=draws[i])
            curve.append(sim.convergence(st))
        ends.append((convert.state_to_numpy(st), torch.stack(curve),
                     inf.publish))
    (x, cx, px), (y, cy, py) = ends
    out["compressed-pipelined"] = {
        "fields_differ": [f for f in x if not np.array_equal(x[f], y[f])],
        "equal": (bool(torch.equal(cx, cy))
                  and all(torch.equal(u, v) for u, v in zip(px, py)))}
    return out
