"""The BASELINE validation scenarios, runnable end to end — the port of
``sidecar_tpu/sim/scenarios.py``: configs 1–6, ``run_all``, the
``python -m sidecar_tpu_torch.sim.scenarios --scale --only --device``
entry point, and the registry and protocol-config validation, with the
reference's error messages word for word.

  1. static single node, 3 services — the merge sanity config
  2. 32-node ring, fanout 3, 10 services/node
  3. 4,096-node Erdős–Rényi with 5 % service churn and tombstones
  4. 65,536-node Barabási–Albert with periodic anti-entropy (compressed)
  5. 1M-node partitioned mesh, 2-way split + heal (compressed)
  6. partition → churn → heal under 20 % asymmetric loss (chaos)

Each config takes ``device`` (the card unless the caller asks for the
CPU) and returns a :class:`ScenarioResult`.  ``scale`` shrinks the large
configs for quick runs.  ``_run`` seeds ``sim.default_generator(seed)``
with the reference's seed and passes ONE generator through every chunk,
so a chunked run equals a straight one (the reference folds the round
index into its key for the same contract; the port's draws are a
generator stream).  The churn hooks take their randomness from masks
drawn up front from a CPU generator of their own (:func:`churn_masks`),
so a resumed run (``sim/checkpoint.py``) and a card run see the same
churn as a straight CPU run.

A scenario config is validated at registration time: a bad fanout or
transmit limit fails with a named error, not many rounds into a run as a
shape or int8 failure.  The fleet (``fleet/batch.py``) routes every grid
point through :func:`validate_protocol_config` for the same reason.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import topology as topo_mod


@dataclasses.dataclass
class ScenarioResult:
    name: str
    n: int
    services_per_node: int
    rounds_run: int
    convergence: np.ndarray          # sampled convergence curve
    eps_round: Optional[int]         # first round with conv >= 1 - eps
    eps_seconds_simulated: Optional[float]
    wall_seconds: float
    rounds_per_sec: float
    scaled_from: Optional[int] = None  # declared full-scale N, if reduced
    conv_every: int = 1              # rounds between convergence samples
    notes: str = ""

    def summary(self) -> dict:
        return {
            "scenario": self.name,
            "n": self.n,
            "rounds": self.rounds_run,
            "final_convergence": float(self.convergence[-1])
            if len(self.convergence) else None,
            "eps_round": self.eps_round,
            "eps_seconds_simulated": self.eps_seconds_simulated,
            "wall_seconds": round(self.wall_seconds, 3),
            "rounds_per_sec": round(self.rounds_per_sec, 2),
            "scaled_from": self.scaled_from,
            "conv_every": self.conv_every,
            "notes": self.notes,
        }


def _eps_round(conv: np.ndarray, eps: float,
               conv_every: int = 1) -> Optional[int]:
    hits = np.nonzero(conv >= 1.0 - eps)[0]
    return (int(hits[0]) + 1) * conv_every if hits.size else None


# The reference's longest single device program, in node-rounds (it
# chunks to stay under a TPU watchdog).  The port keeps the chunk
# arithmetic so the curves' sampling lines up; the generator carries
# across chunks, so chunking changes nothing else.
MAX_CHUNK_NODE_ROUNDS = 50_000_000
MAX_CHUNK_ROUNDS = 400


def _chunk_rounds(n: int, conv_every: int) -> int:
    chunk = min(MAX_CHUNK_ROUNDS, max(1, MAX_CHUNK_NODE_ROUNDS // n))
    chunk = max(conv_every, chunk - chunk % conv_every)
    return chunk


def _run_chunked(sim, state, generator, rounds: int, conv_every: int):
    """``sim.run`` in chunks, one ``generator`` through all of them;
    returns (state, conv array)."""
    if rounds <= 0:
        return state, np.zeros((0,), np.float32)
    chunk = _chunk_rounds(sim.p.n, conv_every)
    parts = []
    done = 0
    while done < rounds:
        step = min(chunk, rounds - done)
        if conv_every > 1:
            state, conv = sim.run(state, step, conv_every,
                                  generator=generator)
        else:
            state, conv = sim.run(state, step, generator=generator)
        parts.append(conv.cpu().numpy())
        done += step
    return state, np.concatenate(parts)


def _run(sim, state, rounds: int, seed: int,
         name: str, eps: float, scaled_from: Optional[int] = None,
         conv_every: int = 1, notes: str = "") -> ScenarioResult:
    """Drive any sim exposing ``run`` (the exact, chaos and compressed
    models share the ``run`` contract) from ``default_generator(seed)``.
    ``conv_every`` samples the metric on a cadence (compressed sims
    only)."""
    generator = sim.default_generator(seed)
    t0 = time.perf_counter()
    state, conv = _run_chunked(sim, state, generator, rounds, conv_every)
    wall = time.perf_counter() - t0
    er = _eps_round(conv, eps, conv_every)
    return ScenarioResult(
        name=name, n=sim.p.n, services_per_node=sim.p.services_per_node,
        rounds_run=rounds, convergence=conv, eps_round=er,
        eps_seconds_simulated=(er * sim.t.round_ticks /
                               sim.t.ticks_per_second
                               if er is not None else None),
        wall_seconds=wall, rounds_per_sec=rounds / wall,
        scaled_from=scaled_from, conv_every=conv_every, notes=notes)


# Cold-start studies pin the refresh far out so convergence measures pure
# epidemic spread, not the refresh chase.
_STUDY_CFG = TimeConfig(refresh_interval_s=10_000.0)


def churn_masks(m: int, prob: float, rounds, seed: int, device=None) -> dict:
    """``{round: bool [m]}`` for ``rounds = (first, end)``, each slot
    picked with ``prob``, drawn in round order from a CPU generator
    seeded with ``seed`` (the same masks on any device), then moved to
    ``device`` when given."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for r in range(rounds[0], rounds[1]):
        mask = torch.rand(m, generator=gen) < prob
        out[r] = mask if device is None else mask.to(device)
    return out


def config1_static_merge(eps: float = 0.0,
                         device="cuda") -> ScenarioResult:
    """Single node, 3 services: the merge sanity config."""
    from sidecar_tpu_torch.models.exact import ExactSim, SimParams

    sim = ExactSim(SimParams(n=1, services_per_node=3, fanout=1, budget=3),
                   topo_mod.complete(1), _STUDY_CFG, device=device)
    return _run(sim, sim.init_state(), rounds=10, seed=1,
                name="config1-static", eps=eps,
                notes="single node: converged by construction")


def config2_ring(eps: float = 0.0, rounds: int = 120,
                 device="cuda") -> ScenarioResult:
    """32-node ring, fanout 3, 10 services/node."""
    from sidecar_tpu_torch.models.exact import ExactSim, SimParams

    sim = ExactSim(SimParams(n=32, services_per_node=10, fanout=3,
                             budget=15),
                   topo_mod.ring(32), _STUDY_CFG, device=device)
    return _run(sim, sim.init_state(), rounds=rounds, seed=2,
                name="config2-ring32", eps=eps)


def _churn_perturb(params, churn_prob_per_round: float, rounds: int,
                   seed: int, device=None):
    """Service churn: each round a Bernoulli subset of slots restarts —
    the old instance tombstoned by its owner, a successor announced at
    ``now``: the fleet's ``restart_churn_perturb`` at a static
    probability, its masks for rounds 1 … ``rounds`` from
    :func:`churn_masks` seeded with ``churn_seed(seed)``."""
    from sidecar_tpu_torch.fleet.batch import (
        churn_seed,
        restart_churn_perturb,
    )

    masks = churn_masks(params.m, churn_prob_per_round, (1, rounds + 1),
                        churn_seed(seed), device)
    return restart_churn_perturb(params, prob=churn_prob_per_round,
                                 masks=masks)


def config3_sim(rounds: int = 1200, scale: float = 1.0, device="cuda"):
    """config3's sim: ER(8, seed 3) at ``max(64, 4,096·scale)`` nodes ×
    10 services, 5 % of the services churning across ``rounds``."""
    from sidecar_tpu_torch.models.exact import ExactSim, SimParams

    dev = common.resolve_device(device, "config3")
    n = max(64, int(4096 * scale))
    params = SimParams(n=n, services_per_node=10, fanout=3, budget=15)
    churn_per_round = 0.05 / rounds
    return ExactSim(params, topo_mod.erdos_renyi(n, avg_degree=8, seed=3),
                    _STUDY_CFG, device=dev,
                    perturb=_churn_perturb(params, churn_per_round,
                                           rounds, 3, dev))


def config3_er_churn(eps: float = 0.01, rounds: int = 1200,
                     scale: float = 1.0, device="cuda") -> ScenarioResult:
    """4,096-node Erdős–Rényi, 5 % churn over the run, tombstones
    propagating.  1,200 rounds: the full-scale cold start is
    push-pull-bound (the 20 s anti-entropy, every 100 rounds, does the
    bulk syncing)."""
    sim = config3_sim(rounds, scale, device)
    n = sim.p.n
    return _run(sim, sim.init_state(), rounds=rounds, seed=3,
                name="config3-er4096-churn", eps=eps,
                scaled_from=4096 if n != 4096 else None,
                notes="5% service churn across the run; convergence "
                      "chases a moving target")


def churn_slots(params, frac: float, seed: int,
                owner_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """The slots of a churn burst: a random ``frac`` of all service
    slots (of the nodes ``owner_mask`` marks, when given), sorted, from
    ``default_rng(seed)`` as the reference draws them."""
    rng = np.random.default_rng(seed)
    count = max(1, int(params.m * frac))
    if owner_mask is None:
        slots = rng.choice(params.m, size=count, replace=False)
    else:
        pool = np.nonzero(np.repeat(owner_mask,
                                    params.services_per_node))[0]
        slots = rng.choice(pool, size=min(count, pool.size), replace=False)
    return np.sort(slots).astype(np.int32)


def _mint_churn(sim, state, frac: float, tick: int, seed: int,
                owner_mask: Optional[np.ndarray] = None):
    """Mint the churn burst of :func:`churn_slots` at ``tick``."""
    return sim.mint(state, churn_slots(sim.p, frac, seed, owner_mask),
                    tick)


def _device_count(device) -> int:
    """The reference's ``jax.device_count()`` rule: the CUDA devices on
    the card, one on the CPU."""
    dev = torch.device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _shard_count(sharded: bool, group, device) -> int:
    """The node shards of a config: the group's ``d`` when a shard group
    is given, one a device when ``sharded``, else 1."""
    if group is not None:
        return group.d
    return _device_count(device) if sharded else 1


def _compressed_sim(params, topo, cfg, sharded: bool, device, group=None,
                    **kw):
    """CompressedSim, or its node-sharded twin when ``sharded`` or given a
    shard ``group`` (over the devices, or the group's ``d`` shards on
    its ranks)."""
    if sharded or group is not None:
        from sidecar_tpu_torch.parallel import ShardedCompressedSim
        return ShardedCompressedSim(
            params, topo, cfg, d=_shard_count(sharded, group, device),
            device=device, group=group, **kw)
    from sidecar_tpu_torch.models.compressed import CompressedSim
    return CompressedSim(params, topo, cfg, device=device, **kw)


def config4_sim(scale: float = 1.0, sharded: bool = False, device="cuda",
                group=None):
    """config4's sim: BA(3, seed 4) at ``max(128, 65,536·scale)`` nodes
    (rounded up to a multiple of the shards when sharded) × 10 services,
    K = 256 lines, anti-entropy every 4 s."""
    from sidecar_tpu_torch.models.compressed import CompressedParams

    n = max(128, int(65_536 * scale))
    if sharded or group is not None:  # the node axis must divide the shards
        d = _shard_count(sharded, group, device)
        n = -(-n // d) * d
    cfg = dataclasses.replace(_STUDY_CFG, push_pull_interval_s=4.0)
    params = CompressedParams(n=n, services_per_node=10, fanout=3,
                              budget=15, cache_lines=256,
                              deep_sweep_every=5)
    return _compressed_sim(params, topo_mod.barabasi_albert(n, m=3, seed=4),
                           cfg, sharded, device, group)


def config4_ba_antientropy(eps: float = 2e-4, rounds: int = 400,
                           scale: float = 1.0,
                           churn_frac: float = 0.002,
                           sharded: bool = False,
                           device="cuda", group=None) -> ScenarioResult:
    """65,536-node Barabási–Albert with periodic anti-entropy, at the
    declared scale on the compressed model: the cluster boots converged,
    ``churn_frac`` of all services churn at once (0.2 %, about 1,310
    records), and the scenario measures the drain back to ε through
    gossip and the 4 s anti-entropy cadence.  ``group`` (a shard group,
    ``parallel/``) runs the node-sharded twin over its ranks, as
    ``sharded`` runs it over the devices: the same curve and ε round on
    every rank."""
    sim = config4_sim(scale, sharded, device, group)
    n = sim.p.n
    conv_every = 5 if n >= 16_384 else 1
    rounds = -(-rounds // conv_every) * conv_every
    state = _mint_churn(sim, sim.init_state(), churn_frac, tick=10, seed=4)
    return _run(sim, state, rounds=rounds, seed=4,
                name="config4-ba-antientropy", eps=eps,
                conv_every=conv_every,
                scaled_from=65_536 if n != 65_536 else None,
                notes=f"compressed model; {churn_frac:.2%} service churn "
                      "burst; anti-entropy every 4 s simulated"
                      + ("; node-axis sharded"
                         if sharded or group is not None else ""))


# config5's protocol: frequent anti-entropy (healing a partition is seeded
# by push-pull at the boundary, then drained by gossip relay).
CONFIG5_TIME = dataclasses.replace(_STUDY_CFG, push_pull_interval_s=2.0)


def config5_params(n: int):
    """config5's compressed params: 4 services a node, K = 64 lines."""
    from sidecar_tpu_torch.models.compressed import CompressedParams

    return CompressedParams(n=n, services_per_node=4, fanout=3, budget=15,
                            cache_lines=64, deep_sweep_every=5)


def split_mesh(side: int):
    """config5's split mesh: ``mesh2d(side, side)``, each node's side
    (its column in the right half) and the cut of the edges between
    them.  Returns ``(topo, halves, cut)``."""
    topo = topo_mod.mesh2d(side, side)
    halves = (np.arange(topo.n) % side >= side // 2).astype(np.int32)
    return topo, halves, topo_mod.partition_mask(topo, halves)


def config5_split_heal(eps: float = 1e-5, split_rounds: int = 150,
                       heal_rounds: int = 450,
                       scale: float = 1.0,
                       churn_frac: float = 1e-4,
                       sharded: bool = False,
                       device="cuda", group=None) -> ScenarioResult:
    """Partitioned 2-D mesh at the declared 1M nodes (compressed model):
    churn is injected on ONE side of the split, convergence stalls while
    the partition holds (cross-side gossip and stride anti-entropy are
    severed), then the cut is removed and the backlog drains to ε.  The
    default 0.01 % burst (about 400 records) is what a 450-round heal
    completes at K = 64 lines a node.  ``group``: as in
    :func:`config4_ba_antientropy`."""
    side = max(8, int(1000 * math.sqrt(scale)))
    if sharded or group is not None:  # the node axis must divide the shards
        d = _shard_count(sharded, group, device)
        while (side * side) % d:
            side += 1
    topo, halves, cut = split_mesh(side)
    n = topo.n
    params = config5_params(n)
    cfg = CONFIG5_TIME

    conv_every = 5 if n >= 16_384 else 1
    split_rounds = -(-split_rounds // conv_every) * conv_every
    heal_rounds = -(-heal_rounds // conv_every) * conv_every
    split_sim = _compressed_sim(params, topo, cfg, sharded, device, group,
                                cut_mask=cut, node_side=halves)
    generator = split_sim.default_generator(5)
    t0 = time.perf_counter()
    state = _mint_churn(split_sim, split_sim.init_state(), churn_frac,
                        tick=10, seed=5, owner_mask=halves == 0)
    state, conv_split = _run_chunked(split_sim, state, generator,
                                     split_rounds, conv_every)

    heal_sim = _compressed_sim(params, topo, cfg, sharded, device,
                               group)  # cut removed
    state, conv_heal = _run_chunked(heal_sim, state, generator,
                                    heal_rounds, conv_every)
    wall = time.perf_counter() - t0

    conv = np.concatenate([conv_split, conv_heal])
    rounds = split_rounds + heal_rounds
    er = _eps_round(conv, eps, conv_every)
    split_peak = float(conv_split.max()) if conv_split.size else \
        float("nan")
    return ScenarioResult(
        name="config5-split-heal", n=n,
        services_per_node=params.services_per_node, rounds_run=rounds,
        convergence=conv, eps_round=er,
        eps_seconds_simulated=(er * cfg.round_ticks / cfg.ticks_per_second
                               if er is not None else None),
        wall_seconds=wall, rounds_per_sec=rounds / wall,
        scaled_from=1_000_000 if n != 1_000_000 else None,
        conv_every=conv_every,
        notes=f"compressed model; churn on one side of the split; "
              f"convergence while split peaked at {split_peak:.4f} "
              "(must stay < 1); heal completes it")


def side_churn(params, prob: float, *, start: int = 30, end: int = 60,
               seed: int = 0, masks=None, device=None):
    """config6's side-A churn: the fleet's ``restart_churn_perturb`` at
    ``prob`` whose masks pick, from round ``start`` to ``end``, only
    slots of side A (owners below ``n / 2``), and nothing in the other
    rounds.  The masks are ``masks`` (``{round: bool [M]}``, as the
    reference hook draws ``bernoulli(k_perturb, prob, [M])`` each round)
    when given, else :func:`churn_masks` drawn up front from a generator
    seeded with ``seed`` onto ``device``, so the round reads no host
    value and every run from the same seed sees the same churn."""
    from sidecar_tpu_torch.fleet.batch import restart_churn_perturb

    if masks is None:
        masks = churn_masks(params.m, prob, (start, end), seed, device)
    side_a = torch.arange(params.m) // params.services_per_node \
        < params.n // 2
    picked = {r: masks[r] & side_a.to(masks[r].device)
              for r in range(start, end) if r in masks}
    return restart_churn_perturb(params, prob=prob, masks=picked)


def config6_plan(n: int, seed: int = 6):
    """config6's FaultPlan: sides A (the lower half) and B, 20 % A→B loss
    all run, a full split over rounds 20–80."""
    from sidecar_tpu_torch.chaos import EdgeFault, FaultPlan

    side_a = tuple(range(n // 2))
    side_b = tuple(range(n // 2, n))
    return FaultPlan(
        seed=seed,
        edges=(EdgeFault(src=side_a, dst=side_b, drop_prob=0.2),),
    ).with_edges(*FaultPlan.partition(side_a, side_b, 20, 80))


def config6_sim(n: int = 256, seed: int = 6,
                timecfg: Optional[TimeConfig] = None, device="cuda"):
    """config6's ``ChaosExactSim``: n × 4 services on the complete graph
    under :func:`config6_plan`, with the side-A churn of
    :func:`side_churn` (each side-A slot with probability 0.02/4 a round
    over rounds 30–60).  ``timecfg`` defaults to config6's clock
    (push-pull every 2 s, refresh pinned out)."""
    from sidecar_tpu_torch.chaos import ChaosExactSim
    from sidecar_tpu_torch.models.exact import SimParams

    dev = common.resolve_device(device, "config6")
    spn = 4
    cfg = timecfg if timecfg is not None else dataclasses.replace(
        _STUDY_CFG, push_pull_interval_s=2.0)
    params = SimParams(n=n, services_per_node=spn, fanout=3, budget=15)
    hook = side_churn(params, 0.02 / spn, seed=seed, device=dev)
    return ChaosExactSim(params, topo_mod.complete(n), cfg,
                         config6_plan(n, seed), device=dev, perturb=hook)


def config6_chaos(eps: float = 1e-3, scale: float = 1.0,
                  seed: int = 6, device="cuda") -> ScenarioResult:
    """Partition → churn → heal under 20 % asymmetric loss, exact model:
    rounds [20, 80) split the cluster in half while A→B also loses 20 %
    of its packets all run; churn lands on side A only during the
    partition, so side B converges on the backlog only through the
    heal."""
    n = max(32, int(256 * scale))
    n -= n % 2
    sim = config6_sim(n, seed, device=device)
    return _run(sim, sim.init_state(), rounds=200, seed=seed,
                name="config6-chaos-partition", eps=eps,
                scaled_from=256 if n != 256 else None,
                notes="FaultPlan-driven: 2-way split rounds 20-80, "
                      "one-sided churn rounds 30-60, 20% A->B loss "
                      "throughout; heal drains the backlog")


# -- registration + validation ----------------------------------------------

ALL_SCENARIOS: dict[str, Callable] = {}


def register_scenario(name: str, fn: Callable, *,
                      replace: bool = False) -> None:
    """Register a runnable scenario under ``name``.

    Duplicate names are rejected (two scenarios silently shadowing each
    other is how a sweep reports the wrong config's numbers); pass
    ``replace=True`` to overwrite deliberately."""
    if not callable(fn):
        raise TypeError(f"scenario {name!r}: fn must be callable, got "
                        f"{type(fn).__name__}")
    if not replace and name in ALL_SCENARIOS:
        raise ValueError(
            f"scenario {name!r} is already registered "
            f"(to {ALL_SCENARIOS[name].__name__}); pick a distinct name "
            "or pass replace=True")
    ALL_SCENARIOS[name] = fn


def validate_protocol_config(n: int, *, fanout: int, budget: int,
                             retransmit_limit: int = 0,
                             services_per_node: int = 1,
                             name: str = "scenario") -> None:
    """Range-check the protocol knobs a scenario or grid point declares.

    Raises ``ValueError`` naming the offending knob and its bound: the
    fanout shapes the sampled-peer tensor, and the transmit limit must
    keep the int8 ``sent`` counters representable
    (``ops/gossip.record_transmissions``)."""
    label = f"{name}: " if name else ""
    if n < 1:
        raise ValueError(f"{label}n={n} must be >= 1")
    if services_per_node < 1:
        raise ValueError(
            f"{label}services_per_node={services_per_node} must be >= 1")
    if not 1 <= fanout:
        raise ValueError(f"{label}fanout={fanout} must be >= 1")
    if n > 1 and fanout >= n:
        raise ValueError(
            f"{label}fanout={fanout} must be < n={n} (a node cannot "
            "gossip to more distinct peers than exist)")
    if budget < 1:
        raise ValueError(f"{label}budget={budget} must be >= 1")
    if retransmit_limit < 0:
        raise ValueError(
            f"{label}retransmit_limit={retransmit_limit} must be >= 0 "
            "(0 = auto: RetransmitMult x ceil(log10(n+1)))")
    resolved = retransmit_limit if retransmit_limit > 0 else \
        4 * math.ceil(math.log10(n + 1))
    if resolved + fanout - 1 > 127:
        raise ValueError(
            f"{label}retransmit_limit={resolved} + fanout={fanout} - 1 "
            "exceeds the int8 transmit counter range (127)")


for _name, _fn in (
        ("config1", config1_static_merge),
        ("config2", config2_ring),
        ("config3", config3_er_churn),
        ("config4", config4_ba_antientropy),
        ("config5", config5_split_heal),
        ("config6", config6_chaos)):
    register_scenario(_name, _fn)

_SCALED = ("config3", "config4", "config5", "config6")


def run_one(name: str, scale: float = 1.0,
            device="cuda") -> ScenarioResult:
    """The registered scenario ``name`` at ``scale`` (the configs that
    scale) on ``device``."""
    fn = ALL_SCENARIOS[name]
    if name in _SCALED:
        return fn(scale=scale, device=device)
    return fn(device=device)


def run_all(scale: float = 1.0, device="cuda") -> list:
    return [run_one(name, scale, device) for name in ALL_SCENARIOS]


if __name__ == "__main__":
    import argparse
    import json

    parser = argparse.ArgumentParser("scenarios")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="scale factor for the large configs "
                             "(1.0 = the declared BASELINE sizes: "
                             "config3 4,096 dense / config4 65,536 "
                             "compressed / config5 1M compressed)")
    parser.add_argument("--only", default=None,
                        help="run a single config (config1..config6)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card)")
    args = parser.parse_args()
    if args.only:
        results = [run_one(args.only, args.scale, args.device)]
    else:
        results = run_all(scale=args.scale, device=args.device)
    for result in results:
        print(json.dumps(result.summary()))
