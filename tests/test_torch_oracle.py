"""The port's sequential NumPy oracle (``sidecar_tpu_torch/sim/
oracle.py``) against the JAX reference's oracle and against the port's
models, round by round.

Each case steps four things from one key schedule: the reference's
``OracleSim`` (its round keys ``fold_in(key, r)``), the port's
``OracleSim`` and the port's model fed the same rounds as draws
(``torch_parity.jax_exact_draws``), and the reference model.  ``known``
and ``sent`` must be equal in all four after every round: the plain
round on a complete graph and on ER, a suspicion window with the future
bound and the origin budget, a per-node cadence gate, a clock-only
``ChaosExactSim`` and one under an adversary with the defences on (its
quarantine engaging).  The pipelined oracle holds against
``step_pipelined``, and the provenance oracle against
``run_with_provenance``'s trace.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sidecar_tpu.chaos import adversary as jadv
from sidecar_tpu.chaos import plan as jplan
from sidecar_tpu.chaos.sim_inject import ChaosExactSim as JChaosExactSim
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.sim import oracle as joracle
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.chaos import AdversaryPlan, ChaosExactSim, FaultPlan
from sidecar_tpu_torch.ops import provenance as prov_ops
from sidecar_tpu_torch.sim import oracle as toracle
from tests.torch_parity import (
    exact_port_pair,
    exact_port_state,
    jax_exact_draws,
    port_topology,
)

# Push-pull every 10 rounds, the sweep every 5, refresh every 15.
FAST = dict(refresh_interval_s=3.0, push_pull_interval_s=2.0,
            sweep_interval_s=1.0)


def draws_of(jsim, key, r):
    p = jsim.p
    return jax_exact_draws(key, r, n=p.n, fanout=p.fanout,
                           budget=min(p.budget, p.m), deg=jsim.topo.deg,
                           keep_prob=1.0 - p.drop_prob)


def assert_four_equal(jst, tst, jorc, torc, ctx):
    """``known`` equal in all four; ``sent`` equal in the models' int8
    (the oracles count in int32, and their selection reads the int8
    cast, so an attacker's count past 127 wraps alike), and the two
    oracles' int32 counts equal."""
    want_k = np.asarray(jst.known)
    want_s = np.asarray(jst.sent)
    for name, k, s in (("reference oracle", jorc.known,
                        jorc.sent.astype(np.int8)),
                       ("port oracle", torc.known, torc.sent.astype(np.int8)),
                       ("port model", tst.known.numpy(), tst.sent.numpy())):
        np.testing.assert_array_equal(k, want_k,
                                      err_msg=f"{ctx} {name} known")
        np.testing.assert_array_equal(s, want_s,
                                      err_msg=f"{ctx} {name} sent")
    np.testing.assert_array_equal(torc.sent, jorc.sent,
                                  err_msg=f"{ctx} oracles' int32 sent")


def lockstep(jsim, tsim, rounds, seed, *, chaos=False):
    """Step the four from one key; returns the port oracle and the
    status codes its state held over the run."""
    key = jax.random.PRNGKey(seed)
    jst = jsim.init_state()
    if chaos:
        tst = tsim.init_state()
        j_inner, t_of = jst.sim, (lambda s: s.sim)
    else:
        tst = exact_port_state(jst)
        j_inner, t_of = jst, (lambda s: s)
    jorc = joracle.OracleSim(jsim, j_inner)
    torc = toracle.OracleSim(tsim, t_of(tst))
    seen = set()
    for r in range(rounds):
        d = draws_of(jsim, key, r)
        k = jax.random.fold_in(key, r)
        jst = jsim.step(jst, k)
        tst = tsim.step(tst, draws=d)
        jorc.step(k)
        torc.step(d)
        inner = jst.sim if chaos else jst
        assert_four_equal(inner, t_of(tst), jorc, torc, f"round {r + 1}")
        seen |= set(np.unique(torc.known[torc.known > 0] & 7).tolist())
    assert torc.origin_violations.tolist() == \
        jorc.origin_violations.tolist()
    assert torc.quarantined_origins() == jorc.quarantined_origins()
    assert torc.convergence() == jorc.convergence()
    return torc, seen


@pytest.mark.parametrize("case", ["complete", "er", "loss"])
def test_plain_round_equals_reference_oracle(case):
    n = 16
    topo = jtopo.erdos_renyi(n, avg_degree=4, seed=1) if case == "er" \
        else jtopo.complete(n)
    params = dict(n=n, services_per_node=3, fanout=2, budget=6,
                  drop_prob=0.3 if case == "loss" else 0.0)
    jsim, tsim = exact_port_pair(params, topo, FAST)
    lockstep(jsim, tsim, rounds=30, seed=42)


def test_suspicion_future_bound_and_budget():
    """A short alive lifespan with the suspicion window, the future
    bound and the origin budget: records expire to SUSPECT, refute and
    tombstone, and the gates run on every packet."""
    time_kw = dict(FAST, alive_lifespan_s=2.0, suspicion_window_s=1.0,
                   refresh_interval_s=600.0, future_fudge_s=0.5,
                   origin_budget=1)
    params = dict(n=8, services_per_node=2, fanout=2, budget=6)
    jsim, tsim = exact_port_pair(params, jtopo.complete(8), time_kw)
    _, seen = lockstep(jsim, tsim, rounds=40, seed=3)
    assert 5 in seen       # SUSPECT


def test_cadence_gate():
    """Per-node tick periods and phases on ER: off nodes send to
    themselves and still select and charge."""
    n = 16
    period = [1, 2, 3, 4] * 4
    phase = list(range(n))
    params = dict(n=n, services_per_node=2, fanout=2, budget=5)
    jsim, tsim = exact_port_pair(params, jtopo.erdos_renyi(n, 4, seed=2),
                                 FAST, tick_period=period,
                                 tick_phase=phase)
    assert tsim._knobs.cadence_enabled
    lockstep(jsim, tsim, rounds=30, seed=5)


def chaos_pair(params, time_kw, plan_of, adversary_of=None):
    jp = jexact.SimParams(**params)
    jt = JTimeConfig(**time_kw)
    jpl = plan_of(jplan)
    jad = None if adversary_of is None else adversary_of(jadv)
    jsim = JChaosExactSim(jp, jtopo.complete(params["n"]), jt, plan=jpl,
                          adversary=jad)
    tsim = ChaosExactSim(
        convert.exact_params_from_jax_fields(dataclasses.asdict(jp)),
        port_topology(jtopo.complete(params["n"])),
        convert.timecfg_from_fields(dataclasses.asdict(jt)),
        FaultPlan.loads(jpl.dumps()), device="cpu",
        adversary=None if jad is None else AdversaryPlan.loads(jad.dumps()))
    return jsim, tsim


def clock_plan(mod):
    return mod.FaultPlan(seed=11, clocks=(
        mod.ClockFault(nodes=(0,), start_round=3, end_round=18,
                       offset_ticks=30_000, drift_ticks_per_round=7.5),
        mod.ClockFault(nodes=(1,), start_round=5, end_round=25,
                       offset_ticks=-9_000, step_ticks=2_000,
                       step_round=12)))


def attack_plan(mod):
    return mod.AdversaryPlan(seed=7, attacks=(
        mod.Attack(kind="tombstone_bomb", nodes=(0,), victims=(3, 4),
                   rate=0.8, start_round=2, end_round=40),
        mod.Attack(kind="sybil_flood", nodes=(2,), victims=(5,), rate=0.6,
                   magnitude_ticks=300, start_round=3, end_round=40)))


def test_clock_only_chaos_with_future_bound():
    params = dict(n=8, services_per_node=2, fanout=2, budget=5)
    time_kw = dict(FAST, future_fudge_s=0.5)
    jsim, tsim = chaos_pair(params, time_kw, clock_plan)
    lockstep(jsim, tsim, rounds=25, seed=2, chaos=True)


def test_adversary_with_budget_and_quarantine():
    params = dict(n=8, services_per_node=2, fanout=3, budget=4)
    time_kw = dict(refresh_interval_s=4.0, alive_lifespan_s=6.0,
                   sweep_interval_s=0.4, push_pull_interval_s=1.0,
                   future_fudge_s=0.5, origin_budget=1, origin_quarantine=6)
    jsim, tsim = chaos_pair(params, time_kw,
                            lambda mod: mod.FaultPlan(seed=1), attack_plan)
    torc, seen = lockstep(jsim, tsim, rounds=40, seed=2, chaos=True)
    assert torc.quarantined_origins() == (0, 2)
    assert 1 in seen       # the bomb's tombstones


def test_adversary_transmit_counts_wrap_alike():
    """Forged sends charge the attacker's counts past 127: the models'
    int8 ``sent`` wraps, the oracles' int32 does not, and the oracles
    select on its int8 cast, so all four stay equal every round."""
    params = dict(n=16, services_per_node=2, fanout=3, budget=15,
                  drop_prob=0.1)
    time_kw = dict(FAST, future_fudge_s=0.5, origin_budget=1,
                   origin_quarantine=6)
    jsim, tsim = chaos_pair(params, time_kw,
                            lambda mod: mod.FaultPlan(seed=1), attack_plan)
    torc, _ = lockstep(jsim, tsim, rounds=40, seed=2, chaos=True)
    assert torc.sent.max() > 127


def test_pipelined_oracle_equals_step_pipelined():
    params = dict(n=12, services_per_node=2, fanout=2, budget=5,
                  drop_prob=0.3)
    jsim, tsim = exact_port_pair(params, jtopo.complete(12), FAST,
                                 pipeline="1")
    key = jax.random.PRNGKey(7)
    jst = jsim.init_state()
    tst = exact_port_state(jst)
    jorc = joracle.PipelinedOracleSim(jsim, jst)
    torc = toracle.PipelinedOracleSim(tsim, tst)
    jorc.prime(key)
    torc.prime(draws_of(jsim, key, 0))
    jst, jinf = jsim.prime_pipeline(jst, key)
    tst, tinf = tsim.prime_pipeline(tst, draws=draws_of(jsim, key, 0))
    for r in range(25):
        nxt = draws_of(jsim, key, r + 1)
        jst, jinf = jsim.step_pipelined(jst, jinf, key)
        tst, tinf = tsim.step_pipelined(tst, tinf, draws=nxt)
        jorc.step(key)
        torc.step(nxt)
        assert_four_equal(jst, tst, jorc, torc, f"tick {r + 1}")
    with pytest.raises(ValueError, match="lockstep-only"):
        _, csim = chaos_pair(dict(n=8, services_per_node=2), FAST,
                             clock_plan)
        toracle.PipelinedOracleSim(csim, csim.init_state().sim)


@pytest.mark.parametrize("topo_name", ["complete", "er"])
def test_provenance_oracle_equals_run_with_provenance(topo_name):
    n = 12
    topo = jtopo.complete(n) if topo_name == "complete" \
        else jtopo.erdos_renyi(n, 4, seed=1)
    params = dict(n=n, services_per_node=2, fanout=2, budget=4)
    time_kw = dict(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    jsim, tsim = exact_port_pair(params, topo, time_kw)
    tracked = prov_ops.default_tracked(n * 2, 4)
    tr = torch.tensor(tracked, dtype=torch.int32)
    key = jax.random.PRNGKey(4)
    rounds = 24
    draws = [draws_of(jsim, key, r) for r in range(rounds)]
    start = tsim.init_state()
    _, pv, _ = tsim.run_with_provenance(start, rounds, tracked,
                                        draws=draws, donate=False)
    orc = toracle.ProvenanceOracle(tsim._prov_belief(start, tr), 0)
    st = start
    for d in draws:
        nxt = tsim.step(st, draws=d)
        orc.observe(orc.holders(tsim._prov_belief(st, tr)),
                    orc.holders(tsim._prov_belief(nxt, tr)),
                    nxt.round_idx, *tsim._prov_channels(nxt, d))
        st = nxt
    np.testing.assert_array_equal(pv.first_seen.numpy(), orc.first_seen)
    np.testing.assert_array_equal(pv.parent.numpy(), orc.parent)
    np.testing.assert_array_equal(pv.hops.numpy(), orc.hops)
    np.testing.assert_array_equal(
        pv.coverage.numpy()[:len(orc.coverage)], np.asarray(orc.coverage))
    assert (orc.first_seen >= 0).any() and (orc.parent >= 0).any()
    # The reference's oracle on the same holders and channels agrees.
    jorc = joracle.ProvenanceOracle(tsim._prov_belief(start, tr).numpy(), 0)
    st = start
    for d in draws:
        nxt = tsim.step(st, draws=d)
        pushes, pulls = tsim._prov_channels(nxt, d)
        jorc.observe(jorc.holders(tsim._prov_belief(st, tr).numpy()),
                     jorc.holders(tsim._prov_belief(nxt, tr).numpy()),
                     nxt.round_idx,
                     [(i.numpy(), None if m is None else m.numpy())
                      for i, m in pushes],
                     [(i.numpy(), None if m is None else m.numpy())
                      for i, m in pulls])
        st = nxt
    np.testing.assert_array_equal(jorc.first_seen, orc.first_seen)
    np.testing.assert_array_equal(jorc.parent, orc.parent)
    assert jorc.coverage == orc.coverage
