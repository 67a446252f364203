"""The rank bodies of ``tests/test_torch_dist.py``: each rank of a gloo
group runs every case in turn and returns its rank-local results.

This module imports only torch, numpy and the port, so a spawned rank
never imports JAX; the cases arrive as plain data (numpy arrays, dicts
and tuples) that the test built from the reference's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from sidecar_tpu_torch import convert
from sidecar_tpu_torch.fleet import FleetSim, ScenarioBatch, ScenarioSpec
from sidecar_tpu_torch.models.compressed import CompressedParams
from sidecar_tpu_torch.models.exact import SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.parallel import ShardedCompressedSim, ShardedSim

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


CASES = {"collectives": run_collectives, "exact": run_exact,
         "compressed": run_compressed, "fleet": run_fleet}


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
