"""The port's chaos and adversary layer (``sidecar_tpu_torch/chaos/``)
against the JAX reference, exactly.

* (i) The plan and adversary copies: ``dumps`` byte-equal to the
  reference's and loadable by it, ``resolve_nodes``, ``coin`` and
  ``ClockFault.offset_at`` over a grid, the same validation errors,
  and ``host_overrides`` and ``corrupt`` of every attack kind equal to
  the reference's.
* (ii) ``ChaosExactSim`` against the reference's, one case per fault
  family, each attack kind with the budget and quarantine on, and a
  config6-style plan with its side-A churn hook: ``known``, ``sent``,
  the rings and every counter after each round.  The reference's
  draws come in through ``draws=`` and ``fault_draws=``
  (``torch_parity.jax_exact_draw_seq``, ``jax_fault_draw_seq``), the
  hook's masks through ``jax_perturb_masks``.
* (iii) Chunked equals straight, rings and counters included; the
  fault draws depend on the plan's seed and the round alone.
* (iv) The trace and provenance streams and the metrics deltas equal
  the reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu import metrics as jmetrics
from sidecar_tpu.chaos import adversary as jadv
from sidecar_tpu.chaos import plan as jplan
from sidecar_tpu.chaos.sim_inject import ChaosExactSim as JChaosExactSim
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu_torch import convert
from sidecar_tpu_torch import metrics as tmetrics
from sidecar_tpu_torch.chaos import adversary as tadv
from sidecar_tpu_torch.chaos import plan as tplan
from sidecar_tpu_torch.chaos import (
    AdversaryPlan,
    ChaosExactSim,
    CompiledFaultPlan,
    FaultPlan,
)
from sidecar_tpu_torch.models.exact import ExactSim
from sidecar_tpu_torch.ops.status import TOMBSTONE, unpack_status
from tests.torch_parity import (
    assert_chaos_states_equal,
    assert_exact_states_equal,
    assert_port_states_equal,
    assert_stream_equal,
    churn_hooks,
    jax_exact_draw_seq,
    jax_fault_draw_seq,
    jax_perturb_masks,
    port_topology,
)

N, SPN = 32, 4
PARAMS = dict(n=N, services_per_node=SPN, fanout=2, budget=6,
              drop_prob=0.1)
# Refreshes every 10 rounds, push-pull every 5, the sweep every 2.
TIME = dict(refresh_interval_s=2.0, push_pull_interval_s=1.0,
            sweep_interval_s=0.4)
ROUNDS = 24
KEY = jax.random.PRNGKey(11)
A = tuple(range(N // 2))
B = tuple(range(N // 2, N))


# -- (i) the plan and adversary copies ----------------------------------------


def plans(mod):
    """The same plans built by either package's module."""
    return [
        mod.FaultPlan(seed=0),
        mod.FaultPlan(
            seed=7,
            edges=(mod.EdgeFault(src=A, dst="all", drop_prob=0.2),
                   mod.EdgeFault(src=B, dst=A, start_round=3, end_round=9,
                                 delay_rounds=2, delay_prob=0.5,
                                 duplicate_prob=0.25)),
            nodes=(mod.NodeFault(nodes=(1, 2), start_round=4,
                                 end_round=8, kind="crash"),),
            health=(mod.HealthFault(id_pattern="web-*", extra_latency_s=1.5,
                                    fail=True),),
            clocks=(mod.ClockFault(nodes="all", start_round=2,
                                   end_round=40, offset_ticks=-30,
                                   drift_ticks_per_round=0.7,
                                   step_ticks=11, step_round=9),),
        ).with_edges(*mod.FaultPlan.partition(A, B, 5, 15, "a_to_b", 0.5)),
    ]


def test_plan_dumps_byte_equal_and_loads_across():
    for jp, tp in zip(plans(jplan), plans(tplan)):
        assert tp.dumps() == jp.dumps()
        assert tplan.FaultPlan.loads(jp.dumps()) == tp
        assert jplan.FaultPlan.loads(tp.dumps()) == jp
        assert tp.max_clock_offset == jp.max_clock_offset
        assert tp.to_json() == jp.to_json()


def test_resolve_coin_offset_grid():
    for sel in ("all", (0, 5, 31), ()):
        assert tplan.resolve_nodes(sel, N) == jplan.resolve_nodes(sel, N)
    for coords in [(0,), (3, "a->b", 17), (99, 1.5)]:
        assert tplan.coin(5, *coords) == jplan.coin(5, *coords)
    kw = [dict(offset_ticks=40, drift_ticks_per_round=1.7, step_ticks=25,
               step_round=7, end_round=30),
          dict(start_round=3, end_round=50, drift_ticks_per_round=-2.3),
          dict(offset_ticks=-500, step_ticks=-90, step_round=4)]
    for k in kw:
        t, j = tplan.ClockFault(**k), jplan.ClockFault(**k)
        assert [t.offset_at(r) for r in range(60)] == \
            [j.offset_at(r) for r in range(60)]
        assert t.max_offset == j.max_offset
    tp, jp = plans(tplan)[1], plans(jplan)[1]
    for node in (0, 1, 20):
        for r in range(0, 20, 3):
            assert tp.clock_offset(node, r) == jp.clock_offset(node, r)
            assert tp.node_down(node, r) == jp.node_down(node, r)
            assert tp.health_fault_at("web-1", r) == \
                jp.health_fault_at("web-1", r)


INVALID = [
    lambda m: m.EdgeFault(drop_prob=1.5),
    lambda m: m.EdgeFault(delay_rounds=-1),
    lambda m: m.EdgeFault(delay_prob=0.5),
    lambda m: m.EdgeFault(start_round=5, end_round=5),
    lambda m: m.EdgeFault(src="some"),
    lambda m: m.NodeFault(nodes=(1,), start_round=0, end_round=3,
                          kind="explode"),
    lambda m: m.NodeFault(nodes=(1,), start_round=3, end_round=3),
    lambda m: m.ClockFault(start_round=-1),
    lambda m: m.ClockFault(drift_ticks_per_round=1.0),
    lambda m: m.FaultPlan(seed=0, edges=(m.NodeFault((1,), 0, 2),)),
    lambda m: m.FaultPlan(seed=0, clocks=(m.EdgeFault(),)),
    lambda m: m.FaultPlan.partition((1, 2), (2, 3), 0, 5),
    lambda m: m.FaultPlan.partition((1,), (2,), 0, 5, direction="up"),
    lambda m: m.resolve_nodes((0, 99), 10),
]

INVALID_ATTACKS = [
    lambda m: m.Attack(kind="nuke", nodes=(1,)),
    lambda m: m.Attack(kind="tombstone_bomb", nodes=(1,), rate=0.0),
    lambda m: m.Attack(kind="future_flood", nodes=(1,)),
    lambda m: m.Attack(kind="replay", nodes=(1,), magnitude_ticks=-1),
    lambda m: m.Attack(kind="flap", nodes=(1,), start_round=-2),
    lambda m: m.Attack(kind="flap", nodes=(1,), start_round=4, end_round=4),
    lambda m: m.AdversaryPlan(seed=0, attacks=(
        m.Attack(kind="flap", nodes=(1, 2), end_round=10),
        m.Attack(kind="flap", nodes=(2,), start_round=5, end_round=20))),
    lambda m: m.AdversaryPlan(seed=0, attacks=("flap",)),
    lambda m: m.CompiledAdversaryPlan(
        m.AdversaryPlan(seed=0, attacks=(m.Attack("flap", (1,)),)),
        n=4, owner=np.array([0, 0, 1, 2, 3]), budget=4),
    lambda m: m.CompiledAdversaryPlan(
        m.AdversaryPlan(seed=0, attacks=(
            m.Attack("tombstone_bomb", (1,), victims=(3,)),)),
        n=4, owner=np.array([0, 0, 1, 1]), budget=4),
]


@pytest.mark.parametrize("make", INVALID + INVALID_ATTACKS,
                         ids=[f"plan{i}" for i in range(len(INVALID))]
                         + [f"attack{i}" for i in range(len(INVALID_ATTACKS))])
def test_same_validation_errors(make):
    mods = ((jplan, tplan) if make in INVALID else (jadv, tadv))
    raised = []
    for mod in mods:
        with pytest.raises((ValueError, TypeError)) as exc:
            make(mod)
        raised.append((type(exc.value), str(exc.value)))
    assert raised[0] == raised[1]


def attack(mod, kind):
    mag = {"future_flood": 5000, "sybil_flood": 300, "past_flood": 4000,
           "replay": 900}.get(kind, 0)
    return mod.Attack(kind=kind, nodes=(3, 9, 17), victims=B,
                      start_round=4, end_round=18, rate=0.5,
                      magnitude_ticks=mag)


@pytest.mark.parametrize("kind", jadv.ATTACK_KINDS)
def test_adversary_overrides_and_corrupt_equal_reference(kind):
    assert tadv.ATTACK_KINDS == jadv.ATTACK_KINDS
    budget = 6
    owner = np.arange(N * SPN) // SPN
    jp = jadv.AdversaryPlan(seed=2, attacks=(attack(jadv, kind),))
    tp = AdversaryPlan.loads(jp.dumps())
    assert tp.dumps() == jp.dumps()
    assert tp.max_future_ticks == jp.max_future_ticks
    assert tp.attackers(N) == jp.attackers(N)
    assert tp.active_attackers(N, 5) == jp.active_attackers(N, 5)
    jc = jadv.CompiledAdversaryPlan(jp, n=N, owner=owner, budget=budget)
    tc = tadv.CompiledAdversaryPlan(tp, n=N, owner=torch.as_tensor(owner),
                                    budget=budget, device="cpu")
    rng = np.random.default_rng(3)
    for r in (0, 4, 5, 11, 17, 18):
        now_n = rng.integers(0, 4000, N).astype(np.int32)
        for a, b in zip(tc.host_overrides(r, now_n),
                        jc.host_overrides(r, now_n)):
            np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
        svc = rng.integers(0, N * SPN + 1, (N, budget)).astype(np.int32)
        msg = rng.integers(0, 1 << 20, (N, budget)).astype(np.int32)
        want = jc.corrupt(r, jnp.asarray(now_n), jnp.asarray(svc),
                          jnp.asarray(msg))
        got = tc.corrupt(r, torch.as_tensor(now_n), torch.as_tensor(svc),
                         torch.as_tensor(msg))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"round {r}")
        assert got[2].dtype == torch.int32 and got[2].dim() == 0


@pytest.mark.parametrize("kind", jadv.ATTACK_KINDS)
def test_transmit_charge_equals_reference_on_forged_packets(kind):
    """``record_transmissions`` on an honest packet (distinct columns,
    with and without the repeat count) and on the packet ``corrupt``
    forges from it (``repeats=True``: a forged column may repeat a slot
    of the row) equals the reference's scatter-add."""
    from sidecar_tpu.ops import gossip as jg
    from sidecar_tpu_torch.ops import gossip as tg

    budget, m = 6, N * SPN
    rng = np.random.default_rng(4)
    k = rng.integers(0, budget + 1, N)
    offered = np.arange(budget)[None, :] < k[:, None]
    svc = np.stack([rng.permutation(m)[:budget] for _ in range(N)])
    svc = np.where(offered, svc, m).astype(np.int32)
    msg = np.where(offered, rng.integers(1, 1 << 20, (N, budget)),
                   0).astype(np.int32)
    sent = rng.integers(0, 5, (N, m)).astype(np.int8)
    jp = jadv.AdversaryPlan(seed=2, attacks=(attack(jadv, kind),))
    jc = jadv.CompiledAdversaryPlan(jp, n=N, owner=np.arange(m) // SPN,
                                    budget=budget)
    now_n = rng.integers(0, 4000, N).astype(np.int32)

    def forge(pv, pm):
        return [np.asarray(x) for x in jc.corrupt(
            5, jnp.asarray(now_n), jnp.asarray(pv), jnp.asarray(pm))[:2]]

    # Each attacker's honest tail holds the slots it is about to forge.
    fsvc, _ = forge(svc, msg)
    for r in (3, 9, 17):
        tail = fsvc[r, :3]
        head = rng.permutation(np.setdiff1d(np.arange(m), tail))[:3]
        svc[r] = np.concatenate([head, tail])
        msg[r] = rng.integers(1, 1 << 20, budget)
    fsvc, fmsg = forge(svc, msg)
    repeat = ((fsvc[:, :, None] == fsvc[:, None, :])
              & (fmsg[:, None, :] > 0) & ~np.eye(budget, dtype=bool))
    assert repeat.any()
    for label, pv, pm, repeats in (("honest", svc, msg, False),
                                   ("honest", svc, msg, True),
                                   ("forged", fsvc, fmsg, True)):
        want = jg.record_transmissions(jnp.asarray(sent), jnp.asarray(pv),
                                       jnp.asarray(pm), 3, 12)
        got = tg.record_transmissions(
            torch.as_tensor(sent), torch.as_tensor(np.array(pv)),
            torch.as_tensor(np.array(pm)), 3, repeats=repeats)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{label} {repeats}")


# -- (ii) ChaosExactSim against the reference ------------------------------


def clock_plan(mod):
    return mod.FaultPlan(seed=4, clocks=(
        mod.ClockFault(nodes=(2, 3), end_round=40, offset_ticks=1500,
                       drift_ticks_per_round=37.5, step_ticks=900,
                       step_round=9),
        mod.ClockFault(nodes=(20,), offset_ticks=-700)),
        edges=(mod.EdgeFault(src=(2, 3, 20), dst="all", delay_rounds=2,
                             delay_prob=0.4),))


FAMILIES = {
    "empty": (lambda m: m.FaultPlan(seed=0), {}, None),
    "drop_subset": (lambda m: m.FaultPlan(seed=1, edges=(
        m.EdgeFault(src=tuple(range(10)), dst="all", drop_prob=0.3),)),
        {}, None),
    "overlapping_drops": (lambda m: m.FaultPlan(seed=2, edges=(
        m.EdgeFault(src=A, dst="all", drop_prob=0.3),
        m.EdgeFault(src="all", dst=B, drop_prob=0.45, start_round=3,
                    end_round=20),
        m.EdgeFault(src=tuple(range(8, 24)), dst=A, drop_prob=0.15))),
        {}, None),
    "partition_push_pull": (lambda m: m.FaultPlan(seed=3).with_edges(
        *m.FaultPlan.partition(A, B, 3, 18)), {}, None),
    "delay_ring": (lambda m: m.FaultPlan(seed=5, edges=(
        m.EdgeFault(src=B, dst=A, delay_rounds=3, delay_prob=0.3,
                    duplicate_prob=0.2),
        m.EdgeFault(src=A, dst=B, duplicate_prob=0.25),
        m.EdgeFault(src="all", dst="all", drop_prob=0.1))), {}, None),
    "pause": (lambda m: m.FaultPlan(seed=6, nodes=(
        m.NodeFault(nodes=(1, 2, 3, 4, 5), start_round=4, end_round=12),)),
        {}, None),
    "crash_restart": (lambda m: m.FaultPlan(seed=7, nodes=(
        m.NodeFault(nodes=(6, 7, 8), start_round=3, end_round=10,
                    kind="crash"),
        m.NodeFault(nodes=(30,), start_round=12, end_round=15,
                    kind="crash"))), {}, None),
    "clock_skew": (clock_plan, dict(future_fudge_s=0.5), None),
}
DEFENCES = dict(future_fudge_s=0.5, origin_budget=2, origin_quarantine=3)
FAMILIES.update({
    f"attack_{kind}": (lambda m: m.FaultPlan(seed=8), DEFENCES, kind)
    for kind in jadv.ATTACK_KINDS})


def chaos_pair(plan_of, time_kw=None, adversary=None, topo=None,
               params=PARAMS, perturb=(None, None), **kw):
    """The reference ``ChaosExactSim`` and the port's, on the CPU, from
    the same params, graph, time config and plan (the port's plan loaded
    from the reference's JSON)."""
    topo = jtopo.erdos_renyi(N, 4.0, seed=1) if topo is None else topo
    jp, jt = jexact.SimParams(**params), JTimeConfig(**dict(TIME,
                                                           **(time_kw or {})))
    jpl = plan_of(jplan)
    jad = None if adversary is None else jadv.AdversaryPlan(
        seed=1, attacks=(attack(jadv, adversary),))
    jsim = JChaosExactSim(jp, topo, jt, plan=jpl, adversary=jad,
                          perturb=perturb[0], **kw)
    tsim = ChaosExactSim(
        convert.exact_params_from_jax_fields(dataclasses.asdict(jp)),
        port_topology(topo),
        convert.timecfg_from_fields(dataclasses.asdict(jt)),
        FaultPlan.loads(jpl.dumps()), device="cpu", perturb=perturb[1],
        adversary=None if jad is None else AdversaryPlan.loads(jad.dumps()),
        **kw)
    return jsim, tsim


@functools.lru_cache(maxsize=None)
def reference_steps(family):
    """The reference's state after each of ROUNDS rounds, its draws and
    its fault draws."""
    plan_of, time_kw, adversary = FAMILIES[family]
    jsim, _ = chaos_pair(plan_of, time_kw, adversary)
    js, states = jsim.init_state(0.9, seed=2), []
    for r in range(ROUNDS):
        js = jsim.step(js, jax.random.fold_in(KEY, r))
        states.append(js)
    return jsim, states, jax_exact_draw_seq(jsim, KEY, 0, ROUNDS), \
        jax_fault_draw_seq(jsim, 0, ROUNDS)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chaos_round_equals_reference(family):
    plan_of, time_kw, adversary = FAMILIES[family]
    jsim, want, draws, fdraws = reference_steps(family)
    _, tsim = chaos_pair(plan_of, time_kw, adversary)
    ts = tsim.init_state(0.9, seed=2)
    for r in range(ROUNDS):
        ts = tsim.step(ts, draws=draws[r], fault_draws=fdraws[r])
        assert_chaos_states_equal(want[r], ts, f"{family} round {r + 1}")
    assert tsim.injection_counts(ts) == jsim.injection_counts(want[-1])
    assert tsim.quarantined_origins(ts) == \
        jsim.quarantined_origins(want[-1])
    counts = tsim.injection_counts(ts)
    # Premise: each family injects what it is about.
    premise = {"drop_subset": "dropped", "overlapping_drops": "dropped",
               "partition_push_pull": "dropped", "delay_ring": "delayed",
               "clock_skew": "rejected_future"}
    if family in premise:
        assert counts[premise[family]] > 0, counts
    if family == "delay_ring":
        assert counts["duplicated"] > 0, counts
    if adversary is not None:
        assert counts["forged"] > 0, counts
    if adversary in ("tombstone_bomb", "future_flood", "sybil_flood"):
        assert counts["quarantined"] > 0, counts
    if family == "empty":
        plain = ExactSim(tsim.p, tsim.topo, tsim.t, device="cpu")
        got = plain.run_fast(plain.init_state(0.9, seed=2), ROUNDS,
                             draws=draws)
        assert_exact_states_equal(want[-1].sim, got, "ExactSim")


@functools.lru_cache(maxsize=None)
def config6_reference():
    """config6's shape at n = 32 on the complete graph: A→B loss 0.2
    all run, a full split over rounds 5–15 (push-pull every 5 rounds
    inside it), side-A churn over rounds 6–12 as the hook."""
    params = dict(PARAMS, drop_prob=0.0)
    time_kw = {}
    round_ticks = JTimeConfig().round_ticks
    masks = jax_perturb_masks(KEY, 0, ROUNDS, (N * SPN,), 0.05)
    hooks = churn_hooks(params, round_ticks, masks, 6, 12)

    def plan_of(m):
        return m.FaultPlan(seed=6, edges=(
            m.EdgeFault(src=A, dst=B, drop_prob=0.2),)).with_edges(
            *m.FaultPlan.partition(A, B, 5, 15))

    pair = chaos_pair(plan_of, time_kw, topo=jtopo.complete(N),
                      params=params, perturb=hooks[:2])
    jsim = pair[0]
    js, states = jsim.init_state(), []
    for r in range(ROUNDS):
        js = jsim.step(js, jax.random.fold_in(KEY, r))
        states.append(js)
    return pair, states, jax_exact_draw_seq(jsim, KEY, 0, ROUNDS), \
        jax_fault_draw_seq(jsim, 0, ROUNDS)


def test_config6_style_plan_with_churn_hook():
    (jsim, tsim), want, draws, fdraws = config6_reference()
    ts = tsim.init_state()
    for r in range(ROUNDS):
        ts = tsim.step(ts, draws=draws[r], fault_draws=fdraws[r])
        assert_chaos_states_equal(want[r], ts, f"config6 round {r + 1}")
    assert float(tsim.convergence(ts)) == float(jsim.convergence(want[-1]))
    # Premise: the hook flipped records (tombstones exist on side A).
    assert (unpack_status(ts.known) == TOMBSTONE).any()


def test_chaos_options_refused_like_reference():
    _, tsim = chaos_pair(FAMILIES["drop_subset"][0])
    st = tsim.init_state()
    with pytest.raises(ValueError, match="sparse"):
        tsim.run(st, 1, generator=torch.Generator().manual_seed(0),
                 sparse=True)
    with pytest.raises(ValueError, match="pipelined"):
        tsim.run(st, 1, generator=torch.Generator().manual_seed(0),
                 pipeline=True)
    with pytest.raises(ValueError, match="neighbor-list"):
        ChaosExactSim(tsim.p, port_topology(jtopo.complete(N)), tsim.t,
                      device="cpu", cut_mask=np.zeros((N, 2), bool))
    # The horizon guard counts the plan's skew and the forged stamps.
    _, skewed = chaos_pair(clock_plan, adversary="future_flood")
    assert skewed._skew_ticks == clock_plan(tplan).max_clock_offset + 5000
    max_tick = (1 << 28) - 1
    far = tplan.FaultPlan(seed=0, clocks=(tplan.ClockFault(
        nodes=(1,), offset_ticks=max_tick - 1000),))
    jsim, tsim = chaos_pair(lambda m: m.FaultPlan.loads(far.dumps()))
    for sim in (jsim, tsim):
        with pytest.raises(ValueError, match="skew ticks"):
            sim._check_horizon(sim.init_state(), 10)


# -- (iii) chunked equals straight; the fault draws' root --------------------


def test_chunked_equals_straight_and_fault_draws_ignore_driver_seed():
    family = "delay_ring"
    plan_of, time_kw, _ = FAMILIES[family]
    _, tsim = chaos_pair(plan_of, time_kw)
    gen = torch.Generator().manual_seed(5)
    draws = [tsim.draw(gen, r) for r in range(1, 31)]
    straight = tsim.run_fast(tsim.init_state(), 30, draws=draws)
    half = tsim.run_fast(tsim.init_state(), 15, draws=draws[:15])
    chunked = tsim.run_fast(half, 15, draws=draws[15:], start_round=15)
    assert_chaos_states_equal(straight, chunked, "chunked")
    assert int(straight.injected_delays) > 0
    # The plan's draws are a function of (seed, round) alone ...
    a, b = tsim.fault_draw(7), tsim.fault_draw(7)
    assert torch.equal(a.drop_u, b.drop_u)
    assert torch.equal(a.delay_u[0], b.delay_u[0])
    other = CompiledFaultPlan(tsim.plan, N, device="cpu").draw(
        7, tsim.plan.seed + 1, fanout=2)
    assert not torch.equal(a.drop_u, other.drop_u)
    # ... so two driver seeds consume the same fault draws.
    seen = []
    step = tsim._step

    def spy(cst, d, fd=None):
        seen.append(fd)
        return step(cst, d, fd)

    tsim._step = spy
    for seed in (1, 2):
        tsim.run_fast(tsim.init_state(), 5,
                      generator=torch.Generator().manual_seed(seed))
    for x, y in zip(seen[:5], seen[5:]):
        assert torch.equal(x.drop_u, y.drop_u)
        for u, v in zip(x.delay_u + x.dup_u, y.delay_u + y.dup_u):
            assert (u is None and v is None) or torch.equal(u, v)


# -- (iv) the streams and the metrics -----------------------------------------


@pytest.fixture
def registries():
    tmetrics.reset()
    jmetrics.registry._counters.clear()
    jmetrics.registry._gauges.clear()
    yield
    tmetrics.reset()


PREFIXES = ("chaos.sim.", "clock.sim.", "adversary.sim.", "defense.sim.")


def chaos_counters(snap):
    return {k: v for k, v in snap["counters"].items()
            if k.startswith(PREFIXES)}


@pytest.mark.parametrize("family", ["clock_skew", "attack_tombstone_bomb"])
def test_trace_provenance_and_metrics_equal_reference(registries, family):
    plan_of, time_kw, adversary = FAMILIES[family]
    jsim, tsim = chaos_pair(plan_of, time_kw, adversary)
    rounds, tracked = 20, (5, 66, 100)
    draws = jax_exact_draw_seq(jsim, KEY, 0, rounds)
    fdraws = jax_fault_draw_seq(jsim, 0, rounds)
    js, tr, jconv = jsim.run_with_trace(jsim.init_state(), KEY, rounds)
    ts, ttr, tconv = tsim.run_with_trace(tsim.init_state(), rounds,
                                         draws=draws, fault_draws=fdraws)
    assert_chaos_states_equal(js, ts, "trace run")
    assert_stream_equal(tr, ttr, "trace", family)
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    assert chaos_counters(tmetrics.snapshot()) == \
        chaos_counters(jmetrics.snapshot())
    assert chaos_counters(tmetrics.snapshot())
    js, pv, _ = jsim.run_with_provenance(jsim.init_state(), KEY, rounds,
                                         tracked)
    ts, tpv, _ = tsim.run_with_provenance(tsim.init_state(), rounds,
                                          tracked, draws=draws,
                                          fault_draws=fdraws)
    assert_chaos_states_equal(js, ts, "provenance run")
    assert_stream_equal(pv, tpv, "provenance", family)
    js = jsim.run_fast(jsim.init_state(), KEY, rounds)
    ts = tsim.run_fast(tsim.init_state(), rounds, draws=draws,
                       fault_draws=fdraws)
    assert_chaos_states_equal(js, ts, "run_fast")
    js, jd, _ = jsim.run_with_digest(jsim.init_state(), KEY, rounds)
    ts, td, _ = tsim.run_with_digest(tsim.init_state(), rounds,
                                     draws=draws, fault_draws=fdraws)
    assert_stream_equal(jd, td, "digest", family)
    assert chaos_counters(tmetrics.snapshot()) == \
        chaos_counters(jmetrics.snapshot())
    # A traced run ends where an untraced one does.
    plain = tsim.run_fast(tsim.init_state(), rounds, draws=draws,
                          fault_draws=fdraws)
    assert_port_states_equal(plain.sim, ts.sim, "digest against plain")


# -- the ops' per-node clocks, packet masks and cuts --------------------------


def test_ops_take_per_node_clocks_masks_and_cuts():
    """``admit_gate``, ``budget_mask`` and ``ttl_sweep`` with ``[N, 1]``
    and ``[N, F, 1]`` clocks, ``expand_deliveries`` with ``edge_keep``
    and receiver clocks, ``push_pull`` with ``now_push`` and
    ``sample_peers`` with a cut, each equal to the reference's."""
    from sidecar_tpu.ops import gossip as jg
    from sidecar_tpu.ops import merge as jm
    from sidecar_tpu.ops import ttl as jttl
    from sidecar_tpu_torch.ops import gossip as tg
    from sidecar_tpu_torch.ops import merge as tm
    from sidecar_tpu_torch.ops import ttl as tttl

    rng = np.random.default_rng(9)
    n, f, b, m = 16, 3, 5, 48
    ts = rng.integers(0, 4000, (n, f, b))
    vals = ((ts << 3) | rng.integers(0, 6, (n, f, b))).astype(np.int32)
    now3 = rng.integers(1000, 3000, (n, f, 1)).astype(np.int32)
    now2 = rng.integers(1000, 3000, (n, 1)).astype(np.int32)
    own = rng.random((n, f, b)) < 0.3

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    for now in (now3, now3[:, :1, :]):
        same(tm.admit_gate(torch.as_tensor(vals), torch.as_tensor(now), 900,
                           400, 1, torch.as_tensor(own)),
             jm.admit_gate(jnp.asarray(vals), jnp.asarray(now), 900, 400, 1,
                           jnp.asarray(own)))
        same(tm.budget_mask(torch.as_tensor(vals), torch.as_tensor(now), 1,
                            torch.as_tensor(own)),
             jm.budget_mask(jnp.asarray(vals), jnp.asarray(now), 1,
                            jnp.asarray(own)))
    known = vals.reshape(n, f * b)
    kw = dict(alive_lifespan=800, draining_lifespan=1500,
              tombstone_lifespan=2500, one_second=1000)
    for window in (0, 300):
        got = tttl.ttl_sweep(torch.as_tensor(known), torch.as_tensor(now2),
                             suspicion_window=window, **kw)
        want = jttl.ttl_sweep(jnp.asarray(known), jnp.asarray(now2),
                              suspicion_window=window, **kw)
        for a, c in zip(got, want):
            same(a, c)

    dst = rng.integers(0, n, (n, f)).astype(np.int32)
    svc = rng.integers(0, m + 1, (n, b)).astype(np.int32)
    msg = np.where(svc < m, vals[:, 0, :], 0).astype(np.int32)
    alive = rng.random(n) < 0.9
    ekeep = rng.random((n, f)) < 0.7
    got = tg.expand_deliveries(
        torch.as_tensor(dst), torch.as_tensor(svc), torch.as_tensor(msg),
        now_tick=torch.as_tensor(now3), stale_ticks=900,
        node_alive=torch.as_tensor(alive), edge_keep=torch.as_tensor(ekeep),
        future_ticks=400)
    want = jg.expand_deliveries(
        jnp.asarray(dst), jnp.asarray(svc), jnp.asarray(msg),
        now_tick=jnp.asarray(now3), stale_ticks=900,
        node_alive=jnp.asarray(alive), edge_keep=jnp.asarray(ekeep),
        future_ticks=400)
    for a, c in zip(got, want):
        same(a, c)

    kn = rng.integers(0, 4000, (n, m)).astype(np.int32) << 3
    partner = rng.integers(0, n, n).astype(np.int32)
    push = rng.integers(1000, 3000, (n, 1)).astype(np.int32)
    same(tg.push_pull(torch.as_tensor(kn), torch.as_tensor(partner),
                      now_tick=torch.as_tensor(now2), stale_ticks=900,
                      node_alive=torch.as_tensor(alive), future_ticks=400,
                      now_push=torch.as_tensor(push)),
         jg.push_pull(jnp.asarray(kn), jnp.asarray(partner),
                      now_tick=jnp.asarray(now2), stale_ticks=900,
                      node_alive=jnp.asarray(alive), future_ticks=400,
                      now_push=jnp.asarray(push)))

    topo = jtopo.mesh2d(4, 4)
    side = (np.arange(16) % 4 >= 2).astype(np.int32)
    cut = jtopo.partition_mask(topo, side)
    key = jax.random.PRNGKey(2)
    want = jg.sample_peers(key, 16, 3, nbrs=jnp.asarray(topo.nbrs),
                           deg=jnp.asarray(topo.deg),
                           node_alive=jnp.asarray(alive),
                           cut_mask=jnp.asarray(cut))
    slot = jax.random.randint(key, (16, 3), 0,
                              jnp.maximum(jnp.asarray(topo.deg), 1)[:, None],
                              dtype=jnp.int32)
    got = tg.sample_peers(torch.tensor(np.asarray(slot)), 16,
                          nbrs=torch.as_tensor(topo.nbrs),
                          node_alive=torch.as_tensor(alive),
                          cut_mask=torch.as_tensor(cut))
    same(got, want)
    assert (np.asarray(want) == np.arange(16)[:, None]).any()
    with pytest.raises(ValueError, match="explicit neighbor-list"):
        tg.sample_peers(torch.zeros((16, 3), dtype=torch.int32), 16,
                        cut_mask=torch.as_tensor(cut))
