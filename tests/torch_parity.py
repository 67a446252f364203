"""Shared helpers of the ``test_torch_*`` suites: build the JAX
reference and the PyTorch port from the same inputs, replay the
reference's key schedule as the port's :class:`RoundDraws`, and compare
states field for field — for the compressed model and (below) the exact
one.

The reference draws inside its round: the round key is
``fold_in(key, round_idx_before_step)`` and ``split(k, 4)`` gives
``(k_perturb, k_peers, k_drop, k_pp)`` (``models/compressed.py``
``_step``/``_run_*_jit``).  :func:`jax_draws` reproduces those draws
with ``jax.random`` and hands them to the port, whose drivers take them
through ``draws=``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sidecar_tpu.models import compressed as jax_compressed
from sidecar_tpu.models import exact as jax_exact
from sidecar_tpu.models.timecfg import TimeConfig as JaxTimeConfig
from sidecar_tpu.ops import status as jax_status
from sidecar_tpu.ops import topology as jax_topology
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models.compressed import CompressedSim
from sidecar_tpu_torch.models.exact import ExactSim
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.status import ALIVE, TOMBSTONE

STATE_FIELDS = ("own", "cache_slot", "cache_val", "cache_sent", "floor",
                "node_alive", "round_idx", "evictions", "dropped")

# The bench's north-star protocol constants (bench.py _bench_north_star).
BENCH_TIME = dict(refresh_interval_s=10_000.0, push_pull_interval_s=4.0)


def jax_draws(key, round_idx: int, *, n: int, fanout: int, deg=None,
              cache_lines: int = 0, keep_prob: float = 1.0) -> RoundDraws:
    """The reference's draws for the round taken from ``round_idx``."""
    k = jax.random.fold_in(key, round_idx)
    _k_perturb, k_peers, k_drop, k_pp = jax.random.split(k, 4)
    if deg is None:
        slot = jax.random.randint(k_peers, (n, fanout), 0, n - 1,
                                  dtype=jnp.int32)
    else:
        slot = jax.random.randint(
            k_peers, (n, fanout), 0,
            jnp.maximum(jnp.asarray(deg), 1)[:, None], dtype=jnp.int32)
    stride = int(jax.random.randint(k_pp, (), 1, n, dtype=jnp.int32))
    keep = None
    if keep_prob < 1.0:
        keep = torch.tensor(np.asarray(jax.random.bernoulli(
            k_drop, keep_prob, (n, fanout, cache_lines))))
    return RoundDraws(peer_slot=torch.tensor(np.asarray(slot)),
                      stride=stride, keep=keep)


def jax_draw_seq(jsim, key, start_round: int, num_rounds: int):
    """The reference's draws for ``num_rounds`` rounds from
    ``start_round`` of the JAX sim ``jsim``."""
    p = jsim.p
    deg = None if jsim.topo.deg is None else jsim.topo.deg
    return [jax_draws(key, start_round + i, n=p.n, fanout=p.fanout,
                      deg=deg, cache_lines=p.cache_lines,
                      keep_prob=1.0 - p.drop_prob)
            for i in range(num_rounds)]


def jax_sharded_draws(jsim, key, start_round: int, num_rounds: int):
    """The draws of the reference's ``ShardedCompressedSim`` ``jsim`` for
    ``num_rounds`` rounds from ``start_round``, as the port's
    single-stream :class:`RoundDraws`.  The reference draws per shard:
    shard s splits ``fold_in(k_peers, s)`` into its peer and loss keys
    and draws its ``[nl, F]`` peers and ``[nl, F, K]`` keep mask from
    them (``parallel/sharded_compressed.py`` ``_gossip_shard``,
    ``_sample_dst_jit``); the stride comes from ``k_pp`` as on one
    device.  Concatenated over shards, these are the port's draws."""
    p, d = jsim.p, jsim.d
    nl = p.n // d
    deg = None if jsim.topo.deg is None else np.asarray(jsim.topo.deg)
    out = []
    for i in range(num_rounds):
        k = jax.random.fold_in(key, start_round + i)
        _k_perturb, k_peers, _k_drop, k_pp = jax.random.split(k, 4)
        slots, keeps = [], []
        for s in range(d):
            kp, kd = jax.random.split(jax.random.fold_in(k_peers, s))
            if deg is None:
                hi = p.n - 1
            else:
                hi = jnp.maximum(jnp.asarray(deg[s * nl:(s + 1) * nl]),
                                 1)[:, None]
            slots.append(np.asarray(jax.random.randint(
                kp, (nl, p.fanout), 0, hi, dtype=jnp.int32)))
            if p.drop_prob > 0.0:
                keeps.append(np.asarray(jax.random.bernoulli(
                    kd, 1.0 - p.drop_prob, (nl, p.fanout, p.cache_lines))))
        stride = int(jax.random.randint(k_pp, (), 1, p.n, dtype=jnp.int32))
        out.append(RoundDraws(
            peer_slot=torch.tensor(np.concatenate(slots)), stride=stride,
            keep=torch.tensor(np.concatenate(keeps)) if keeps else None))
    return out


def to_numpy_state(state) -> dict:
    """``{field: np.ndarray}`` of a JAX state."""
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


def port_topology(topo):
    """The port's copy of a reference graph, stagger included."""
    return convert.topology_from_numpy(
        topo.n, topo.nbrs, topo.deg, topo.name, stagger=topo.stagger,
        stagger_period=topo.stagger_period)


def port_pair(params_kw: dict, topo, time_kw: dict, *,
              fused_gather: bool = True, **sim_kw):
    """The reference sim and the port sim (on the CPU) built from the
    same params, time config and graph; ``sim_kw`` (the tick cadence)
    goes to both constructors."""
    jp = jax_compressed.CompressedParams(**params_kw)
    jt = JaxTimeConfig(**time_kw)
    jsim = jax_compressed.CompressedSim(jp, topo, jt, **sim_kw)
    tsim = CompressedSim(
        convert.params_from_jax_fields(dataclasses.asdict(jp)),
        port_topology(topo),
        convert.timecfg_from_fields(dataclasses.asdict(jt)),
        device="cpu", fused_gather=fused_gather, **sim_kw)
    return jsim, tsim


def port_state(jax_state):
    """The port's copy of a JAX state, on the CPU."""
    return convert.state_from_numpy(to_numpy_state(jax_state), "cpu")


def assert_states_equal(jax_state, port_state, ctx: str = ""):
    got = convert.state_to_numpy(port_state)
    want = to_numpy_state(jax_state)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{ctx} field {f}")
        assert got[f].dtype == want[f].dtype, (ctx, f, got[f].dtype,
                                               want[f].dtype)


def bench_burst(m: int, frac: float, seed: int = 7) -> np.ndarray:
    """The bench's churn burst: ``frac`` of the slots, sorted."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(m, size=max(1, int(m * frac)),
                              replace=False)).astype(np.int32)


def er(n: int):
    """The bench's graph, ER(avg degree 8, seed 3)."""
    return jax_topology.erdos_renyi(n, avg_degree=8.0, seed=3)


# -- the exact model ----------------------------------------------------------

EXACT_STATE_FIELDS = ("known", "sent", "node_alive", "round_idx")


def jax_exact_draws(key, round_idx: int, *, n: int, fanout: int, budget: int,
                    deg=None, keep_prob: float = 1.0) -> RoundDraws:
    """The reference exact model's draws for the round taken from
    ``round_idx`` (``models/exact.py`` ``_step``): ``split(fold_in(key,
    r), 4)`` gives ``(k_perturb, k_peers, k_drop, k_pp)``; the peers are
    ``randint`` ``[N, F]`` from ``k_peers``, the loss ``bernoulli``
    ``[N, F, B]`` from ``k_drop`` and the push-pull partner ``randint``
    ``[N, 1]`` from ``k_pp`` (drawn every round; the port reads it on
    push-pull rounds)."""
    k = jax.random.fold_in(key, round_idx)
    _k_perturb, k_peers, k_drop, k_pp = jax.random.split(k, 4)
    if deg is None:
        hi = n - 1
    else:
        hi = jnp.maximum(jnp.asarray(deg), 1)[:, None]
    slot = jax.random.randint(k_peers, (n, fanout), 0, hi, dtype=jnp.int32)
    pp = jax.random.randint(k_pp, (n, 1), 0, hi, dtype=jnp.int32)
    keep = None
    if keep_prob < 1.0:
        keep = torch.tensor(np.asarray(jax.random.bernoulli(
            k_drop, keep_prob, (n, fanout, budget))))
    return RoundDraws(peer_slot=torch.tensor(np.asarray(slot)), stride=0,
                      keep=keep, pp_slot=torch.tensor(np.asarray(pp)))


def jax_exact_draw_seq(jsim, key, start_round: int, num_rounds: int):
    """The reference exact sim ``jsim``'s draws for ``num_rounds`` rounds
    from ``start_round``."""
    p = jsim.p
    return [jax_exact_draws(key, start_round + i, n=p.n, fanout=p.fanout,
                            budget=min(p.budget, p.m), deg=jsim.topo.deg,
                            keep_prob=1.0 - p.drop_prob)
            for i in range(num_rounds)]


def exact_port_pair(params_kw: dict, topo, time_kw: dict, **sim_kw):
    """The reference ``ExactSim`` and the port's (on the CPU) built from
    the same params, time config and graph; ``sim_kw`` goes to both
    constructors."""
    jp = jax_exact.SimParams(**params_kw)
    jt = JaxTimeConfig(**time_kw)
    jsim = jax_exact.ExactSim(jp, topo, jt, **sim_kw)
    tsim = ExactSim(
        convert.exact_params_from_jax_fields(dataclasses.asdict(jp)),
        port_topology(topo),
        convert.timecfg_from_fields(dataclasses.asdict(jt)), device="cpu",
        **sim_kw)
    return jsim, tsim


def exact_to_numpy(state) -> dict:
    """``{field: np.ndarray}`` of a JAX exact-model state."""
    return {f: np.asarray(getattr(state, f)) for f in EXACT_STATE_FIELDS}


def exact_port_state(jax_state):
    """The port's copy of a JAX exact-model state, on the CPU, on fresh
    writable buffers (the exact drivers update their state in place, and
    a CPU tensor made from a JAX array's numpy view would share it)."""
    return convert.exact_state_from_numpy(
        {f: np.array(v) for f, v in exact_to_numpy(jax_state).items()},
        "cpu")


def assert_exact_states_equal(jax_state, port_state, ctx: str = ""):
    got = convert.state_to_numpy(port_state)
    want = exact_to_numpy(jax_state)
    for f in EXACT_STATE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{ctx} field {f}")
        assert got[f].dtype == want[f].dtype, (ctx, f, got[f].dtype,
                                               want[f].dtype)


# -- the telemetry planes -----------------------------------------------------

PLANES = ("trace", "digest", "deltas", "provenance")
PLANE_FIELDS = {"trace": ("count", "rec", "overflow"),
                "digest": ("count", "rec", "overflow"),
                "deltas": ("count", "node", "slot", "val", "overflow"),
                "provenance": ("ref", "first_seen", "parent", "hops",
                               "coverage", "count", "overflow")}


def np_of(x):
    """A tensor, a JAX array or a host scalar as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_stream_equal(jax_stream, port_stream, plane, ctx=""):
    """Every field of a telemetry stream; the port's host
    ``count``/``overflow`` against the JAX scalars."""
    for f in PLANE_FIELDS[plane]:
        np.testing.assert_array_equal(
            np_of(getattr(port_stream, f)), np_of(getattr(jax_stream, f)),
            err_msg=f"{ctx} {plane}.{f}")


def assert_port_states_equal(a, b, ctx=""):
    """Two port states, field for field."""
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for f in x:
        np.testing.assert_array_equal(x[f], y[f], err_msg=f"{ctx} {f}")


def jax_sharded_exact_draws(jsim, key, start_round: int, num_rounds: int):
    """The draws of the reference's exact ``ShardedSim`` ``jsim`` for
    ``num_rounds`` rounds from ``start_round``, as the port's
    single-stream :class:`RoundDraws`.

    The reference (``parallel/sharded.py`` ``_step_impl``,
    ``_gossip_shard``) splits ``fold_in(key, r)`` into ``(k_round,
    k_pp)``; shard s splits ``fold_in(k_round, s)`` into its peer and
    loss keys, draws its ``[nl, F]`` peer slots and a FULL ``[N, F, B]``
    keep mask, and applies that mask to the messages that target its
    rows.  So the loss of message ``(s, f, b)`` is the mask of the shard
    that owns ``dst[s, f]``: the folded ``[N, F, B]`` mask takes row
    ``(s, f)`` from that shard's mask (the sender's own where a cut edge,
    the round's stagger or its cadence turns the send to itself).
    Liveness needs no fold: a dead sender's or receiver's messages are
    zeroed whatever the mask.  The stride comes from ``k_pp``."""
    p, d = jsim.p, jsim.d
    n, f, nl = p.n, p.fanout, p.n // jsim.d
    b = min(p.budget, p.m)
    nbrs = None if jsim.topo.nbrs is None else np.asarray(jsim.topo.nbrs)
    deg = None if jsim.topo.deg is None else np.asarray(jsim.topo.deg)
    ids = np.arange(n, dtype=np.int32)
    out = []
    for i in range(num_rounds):
        r = start_round + i
        k_round, k_pp = jax.random.split(jax.random.fold_in(key, r))
        slots, keeps = [], []
        for s in range(d):
            k_peers, k_drop = jax.random.split(jax.random.fold_in(k_round, s))
            hi = n - 1 if deg is None else jnp.maximum(
                jnp.asarray(deg[s * nl:(s + 1) * nl]), 1)[:, None]
            slots.append(np.asarray(jax.random.randint(
                k_peers, (nl, f), 0, hi, dtype=jnp.int32)))
            if p.drop_prob > 0.0:
                keeps.append(np.asarray(jax.random.bernoulli(
                    k_drop, 1.0 - p.drop_prob, (n, f, b))))
        slot = np.concatenate(slots)
        if nbrs is None:
            dst = slot + (slot >= ids[:, None])
        else:
            dst = np.take_along_axis(nbrs, slot, axis=1)
            if jsim._cut is not None:
                cut = np.take_along_axis(np.asarray(jsim._cut), slot, axis=1)
                dst = np.where(cut, ids[:, None], dst)
        dst = np.asarray(jsim._stagger_gate(jnp.asarray(dst, jnp.int32),
                                            jnp.asarray(ids), r + 1))
        keep = None
        if keeps:
            keep = torch.tensor(np.stack(keeps)[
                dst // nl, ids[:, None], np.arange(f)[None, :]])
        stride = int(jax.random.randint(k_pp, (), 1, n, dtype=jnp.int32))
        out.append(RoundDraws(peer_slot=torch.tensor(slot), stride=stride,
                              keep=keep))
    return out


def sharded_exact_port(jsim, **kw):
    """The port's ``ShardedSim`` built from a reference exact sim's
    params, graph and time config, on the CPU; ``kw`` goes to its
    constructor."""
    from sidecar_tpu_torch.parallel import ShardedSim

    return ShardedSim(
        convert.exact_params_from_jax_fields(dataclasses.asdict(jsim.p)),
        port_topology(jsim.topo),
        convert.timecfg_from_fields(dataclasses.asdict(jsim.t)),
        device="cpu", **kw)


# -- chaos and adversary ------------------------------------------------------


def jax_fault_draws(jsim, round_idx: int):
    """The uniforms behind the reference ``ChaosExactSim``'s fault masks
    for the round that advances the state to ``round_idx``
    (``chaos/sim_inject.py`` ``CompiledFaultPlan.edge_masks``): every
    draw roots at ``kbase = fold_in(PRNGKey(fault seed), round_idx)``;
    the drop mask is ``uniform(fold_in(kbase, 0), (N, F)) < p`` and edge
    entry i's delay and duplicate masks fold in ``100 + i`` and
    ``200 + i``.  Returned as the port's ``FaultDraws``."""
    from sidecar_tpu_torch.chaos.sim_inject import FaultDraws

    p, prog = jsim.p, jsim._prog
    shape = (p.n, p.fanout)
    kbase = jax.random.fold_in(jax.random.PRNGKey(jsim._knobs.fault_seed),
                               round_idx)

    def u(tag):
        return torch.tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(kbase, tag), shape, jnp.float32)))

    drop_u = u(0) if any(e.drop_prob > 0 for e in jsim.plan.edges) \
        else None
    delay_u, dup_u = [], []
    for i, (_, _, e, ring_idx) in enumerate(prog.edge_entries):
        if ring_idx is None:
            continue
        delay_u.append(u(100 + i) if e.delay_prob > 0.0 else None)
        dup_u.append(u(200 + i) if e.duplicate_prob > 0.0 else None)
    return FaultDraws(drop_u, tuple(delay_u), tuple(dup_u))


def jax_fault_draw_seq(jsim, start_round: int, num_rounds: int):
    """The reference chaos sim's fault uniforms for ``num_rounds`` rounds
    from a state at round ``start_round``."""
    return [jax_fault_draws(jsim, start_round + i + 1)
            for i in range(num_rounds)]


def jax_perturb_masks(key, start_round: int, num_rounds: int, shape,
                      prob: float):
    """The ``bernoulli(k_perturb, prob, shape)`` mask a reference
    scenario hook draws each round, ``k_perturb`` the first of
    ``split(fold_in(key, r), 4)``: ``{round index after the step:
    bool tensor}``."""
    out = {}
    for i in range(num_rounds):
        r = start_round + i
        k_perturb = jax.random.split(jax.random.fold_in(key, r), 4)[0]
        out[r + 1] = torch.tensor(np.asarray(
            jax.random.bernoulli(k_perturb, prob, shape)))
    return out


def chaos_state_to_numpy(cst) -> dict:
    """Every field of a chaos state, the reference's or the port's, as
    numpy: the exact fields, the rings and the counters."""
    if isinstance(cst.sim.known, torch.Tensor):
        out = dict(convert.state_to_numpy(cst.sim))
    else:
        out = exact_to_numpy(cst.sim)
    for i, ring in enumerate(cst.rings):
        for name, t in zip(("rows", "cols", "vals"), ring):
            out[f"ring{i}.{name}"] = np_of(t)
    for f in ("injected_drops", "injected_delays", "injected_dups",
              "rejected_future", "forged_records", "rejected_budget",
              "origin_violations"):
        out[f] = np_of(getattr(cst, f))
    return out


def assert_chaos_states_equal(jax_cst, port_cst, ctx: str = ""):
    """Field for field, rings and counters included, dtypes too."""
    want, got = chaos_state_to_numpy(jax_cst), chaos_state_to_numpy(port_cst)
    assert want.keys() == got.keys(), (ctx, want.keys(), got.keys())
    for f in want:
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{ctx} field {f}")
        assert got[f].dtype == want[f].dtype, (ctx, f, got[f].dtype,
                                               want[f].dtype)


def churn_hooks(params, round_ticks, masks, start, end, prob=0.05):
    """config6's side-A churn (``sim/scenarios.py`` ``config6_chaos``)
    in both packages: from round ``start`` to ``end`` the chosen side-A
    slots restart, ALIVE ↔ TOMBSTONE at ``now``.  The reference hook
    draws ``bernoulli(k_perturb, prob, [M])``; the port's is the port's
    ``sim/scenarios.side_churn`` replaying those masks (``masks``, by
    round, from :func:`jax_perturb_masks`).  Returns ``(jax hook, port
    hook)``."""
    from sidecar_tpu_torch.models.exact import SimParams
    from sidecar_tpu_torch.sim.scenarios import side_churn

    m, spn, n = params["n"] * params["services_per_node"], \
        params["services_per_node"], params["n"]

    def jax_hook(state, key, now):
        round_idx = now // round_ticks
        active = (round_idx >= start) & (round_idx < end)
        owner = jnp.arange(m, dtype=jnp.int32) // spn
        cols = jnp.arange(m, dtype=jnp.int32)
        churn = jax.random.bernoulli(key, prob, (m,))
        own = state.known[owner, cols]
        flip = churn & active & (owner < n // 2) & \
            (jax_status.unpack_ts(own) > 0) & state.node_alive[owner]
        new_val = jnp.where(flip, jax_status.pack(now, jnp.where(
            jax_status.unpack_status(own) == ALIVE, TOMBSTONE, ALIVE)), own)
        known = state.known.at[owner, cols].set(new_val)
        sent = state.sent.at[jnp.where(flip, owner, n), cols].set(
            jnp.int8(0), mode="drop")
        return dataclasses.replace(state, known=known, sent=sent)

    port_hook = side_churn(SimParams(**params), prob, start=start, end=end,
                           masks=masks)
    return jax_hook, port_hook


def reference_inputs(jb, rounds):
    """Per scenario of the reference fleet batch ``jb``: the reference's
    draws, its churn hook's masks and (under a plan) its fault draws."""
    from sidecar_tpu.chaos.sim_inject import ChaosExactSim as JChaosExactSim

    p = jb.params
    draws, masks, faults = [], [], []
    for i, spec in enumerate(jb.specs):
        key = jax.random.PRNGKey(spec.seed)
        keep = 1.0 - jb.scenario_params(i).drop_prob
        if jb.family == "compressed":
            draws.append([jax_draws(key, r, n=p.n, fanout=p.fanout,
                                    cache_lines=p.cache_lines,
                                    keep_prob=keep)
                          for r in range(rounds)])
        else:
            draws.append([jax_exact_draws(key, r, n=p.n, fanout=p.fanout,
                                          budget=min(p.budget, p.m),
                                          keep_prob=keep)
                          for r in range(rounds)])
        masks.append(jax_perturb_masks(key, 0, rounds, (p.m,),
                                       spec.churn_prob)
                     if spec.churn_prob > 0 else None)
        if jb.plan is not None:
            jsim = JChaosExactSim(jb.scenario_params(i),
                                  jax_topology.complete(p.n),
                                  jb.scenario_timecfg(i),
                                  plan=jb.scenario_plan(i))
            faults.append(jax_fault_draw_seq(jsim, 0, rounds))
    return draws, masks, (faults or None)


def chaos_option_kwargs(option, topo, round_ticks, key, n):
    """``(reference kwargs, port kwargs)`` that switch ``option`` on: a
    hook toggling the liveness of the nodes a reference draw picks (the
    port's replays the masks), a cut of the ring into halves, or the
    halves as sides."""
    side = (np.arange(n) >= n // 2).astype(np.int32)
    if option == "node_side":
        return dict(node_side=side), dict(node_side=side)
    if option == "cut_mask":
        cut = jax_topology.partition_mask(topo, side)
        return dict(cut_mask=cut), dict(cut_mask=cut)
    masks = jax_perturb_masks(key, 0, 2, (n,), 0.25)

    def jax_hook(state, k, now):
        flip = jax.random.bernoulli(k, 0.25, (n,))
        return dataclasses.replace(state, node_alive=state.node_alive ^ flip)

    def port_hook(state, now):
        return dataclasses.replace(
            state, node_alive=state.node_alive ^ masks[now // round_ticks])

    return dict(perturb=jax_hook), dict(perturb=port_hook)


def reference_batch(batch):
    """The reference ``ScenarioBatch`` of a port batch: the same specs,
    params, clock and plan."""
    from sidecar_tpu import fleet as jfleet
    from sidecar_tpu.chaos import FaultPlan as JFaultPlan

    plan = None if batch.plan is None else JFaultPlan.loads(
        batch.plan.dumps())
    return jfleet.ScenarioBatch.build(
        [jfleet.ScenarioSpec(**dataclasses.asdict(s)) for s in batch.specs],
        jax_exact.SimParams(**dataclasses.asdict(batch.params)),
        JaxTimeConfig(**dataclasses.asdict(batch.timecfg)),
        family=batch.family, plan=plan)
