"""The port's scenario fleet (``sidecar_tpu_torch/fleet/``) against the
JAX reference's ``FleetSim``, exactly.

* (i) Each family — exact (with a churn scenario and a mixed suspicion
  window), chaos (a shared FaultPlan, per-scenario fault seeds, a lossy
  and a churny scenario) and compressed (per-scenario mint and limit) —
  runs as a batch from the reference's draws: every row's integer state,
  the folded ``FleetStats`` and the provenance ``first_seen`` equal the
  reference fleet's, the convergence curves within ``CONV_TOL``, with
  ``stop=False`` and ``stop=True``.  The draws come per scenario from
  ``torch_parity`` (``jax_exact_draws``, ``jax_draws``,
  ``jax_fault_draw_seq``) and the churn hook's masks from
  ``jax_perturb_masks``.
* (ii) Every row equals the port's own unbatched run of that scenario,
  from the batch's generators.
* (iii) The batched sweep window equals the reference's traced window.
* (iv) Validation, the grid, the Pareto front, the scenario registry and
  the conversion of a reference fleet's states and knobs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu import fleet as jfleet
from sidecar_tpu import metrics as jmetrics
from sidecar_tpu.chaos import EdgeFault as JEdgeFault
from sidecar_tpu.chaos import FaultPlan as JFaultPlan
from sidecar_tpu.chaos import NodeFault as JNodeFault
from sidecar_tpu.models import compressed as jcompressed
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import ttl as jttl
from sidecar_tpu.sim import scenarios as jscenarios
from sidecar_tpu_torch import convert
from sidecar_tpu_torch import fleet as tfleet
from sidecar_tpu_torch import metrics as tmetrics
from sidecar_tpu_torch.chaos import ChaosExactSim, FaultPlan
from sidecar_tpu_torch.fleet.engine import scenario_state
from sidecar_tpu_torch.models.compressed import (
    CompressedParams,
    CompressedSim,
)
from sidecar_tpu_torch.models.exact import ExactSim, SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import knobs as knob_ops
from sidecar_tpu_torch.ops import ttl as tttl
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    DRAINING,
    SUSPECT,
    TOMBSTONE,
)
from sidecar_tpu_torch.sim import scenarios as tscenarios
from tests.test_torch_exact import CONV_TOL
from tests.torch_parity import reference_inputs

BASE = dict(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
EXACT_PARAMS = dict(n=16, services_per_node=2, fanout=3, budget=5)
COMPRESSED_PARAMS = dict(n=32, services_per_node=4, cache_lines=16)
TRACKED = (0, 5, 17)
FLEET_COUNTERS = ("fleet.batches", "fleet.scenarios", "fleet.rounds",
                  "fleet.rounds_saved", "chaos.sim.droppedPackets",
                  "chaos.sim.delayedPackets", "chaos.sim.duplicatedPackets")

# The exact matrix: limit 0/8, loss 0/0.1, push-pull 1/2 s, suspicion
# 0/2 s (tight lifespans, so expiry, quarantine and refutation happen in
# the horizon, beside a window-0 twin), a churn scenario, the future
# bound, the per-origin budget with a tick cadence.
EXACT_SPECS = (
    dict(name="plain", seed=1),
    dict(name="lossy", seed=2, drop_prob=0.1),
    dict(name="limit8", seed=3, retransmit_limit=8),
    dict(name="pp1", seed=4, push_pull_interval_s=1.0),
    dict(name="suspicion", seed=5, suspicion_window_s=2.0,
         alive_lifespan_s=2.0, sweep_interval_s=0.4,
         refresh_interval_s=4.0),
    dict(name="no-window", seed=5, alive_lifespan_s=2.0,
         sweep_interval_s=0.4, refresh_interval_s=4.0),
    dict(name="churny", seed=6, churn_prob=0.02, drop_prob=0.1,
         retransmit_limit=8),
    dict(name="gated", seed=7, future_fudge_s=0.5, origin_budget=1,
         tick_period=2, tick_phase=1),
)
CHAOS_SPECS = (
    dict(name="fs7", seed=1, fault_seed=7),
    dict(name="fs8", seed=1, fault_seed=8),
    dict(name="fs9-lossy", seed=2, fault_seed=9, drop_prob=0.05),
    dict(name="fs10-churny", seed=3, fault_seed=10, churn_prob=0.02),
)
COMPRESSED_SPECS = (
    dict(name="a", seed=1, mint_frac=0.05),
    dict(name="b", seed=2, mint_frac=0.05, drop_prob=0.1),
    dict(name="c", seed=3, mint_frac=0.08, retransmit_limit=8),
    dict(name="d", seed=4, mint_frac=0.05, push_pull_interval_s=1.0,
         suspicion_window_s=1.0, alive_lifespan_s=3.0,
         sweep_interval_s=0.4, refresh_interval_s=4.0),
)


def chaos_plan_json(n):
    """The shared plan structure: one-way loss, a delay ring with
    duplicates the other way, a pause window."""
    a, b = tuple(range(n // 2)), tuple(range(n // 2, n))
    return JFaultPlan(
        seed=7,
        edges=(JEdgeFault(src=a, dst=b, drop_prob=0.2),
               JEdgeFault(src=b, dst=a, delay_rounds=2, delay_prob=0.2,
                          duplicate_prob=0.1)),
        nodes=(JNodeFault(nodes=(1, 2), start_round=5, end_round=15,
                          kind="pause"),)).dumps()


def batches(family, specs, plan_json=None):
    """The reference batch and the port's (on the CPU), same specs."""
    if family == "compressed":
        jp = jcompressed.CompressedParams(**COMPRESSED_PARAMS)
        tp = CompressedParams(**COMPRESSED_PARAMS)
    else:
        jp = jexact.SimParams(**EXACT_PARAMS)
        tp = SimParams(**EXACT_PARAMS)
    jplan = None if plan_json is None else JFaultPlan.loads(plan_json)
    tplan = None if plan_json is None else FaultPlan.loads(plan_json)
    jb = jfleet.ScenarioBatch.build(
        [jfleet.ScenarioSpec(**s) for s in specs], jp, JTimeConfig(**BASE),
        family=family, plan=jplan)
    tb = tfleet.ScenarioBatch.build(
        [tfleet.ScenarioSpec(**s) for s in specs], tp, TimeConfig(**BASE),
        family=family, plan=tplan, device="cpu")
    return jb, tb


def both_runs(family, specs, rounds, *, stop, plan_json=None, eps=0.01,
              tracked=TRACKED):
    """The reference fleet run and the port's from its draws; the fleet
    counters each registry gained."""
    jb, tb = batches(family, specs, plan_json)
    jmetrics.registry._counters.clear()
    tmetrics.reset()
    jf = jfleet.FleetSim(jb)
    jrun = jf.run(jf.init_states(), rounds, eps=eps, stop=stop,
                  tracked=tracked)
    draws, masks, faults = reference_inputs(jb, rounds)
    perturb = None
    if tb.has_churn:
        perturb = tfleet.restart_churn_perturb(tb.params, masks=masks)
    tf = tfleet.FleetSim(tb, perturb=perturb)
    trun = tf.run(tf.init_states(), rounds, eps=eps, stop=stop,
                  tracked=tracked, draws=draws, fault_draws=faults)
    counters = [{k: v for k, v in snap["counters"].items()
                 if k in FLEET_COUNTERS}
                for snap in (jmetrics.snapshot(), tmetrics.snapshot())]
    return jrun, trun, counters


def leaves(state):
    """``{name: np.ndarray [S, …]}`` of a batched state, either side's."""
    out = {}

    def put(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "sim":
                put("sim.", v)
            elif f.name == "rings":
                for i, ring in enumerate(v):
                    for name, t in zip(("rows", "cols", "vals"), ring):
                        out[f"ring{i}.{name}"] = np.asarray(
                            t.cpu() if isinstance(t, torch.Tensor) else t)
            else:
                out[prefix + f.name] = np.asarray(
                    v.cpu() if isinstance(v, torch.Tensor) else v)

    put("", state)
    return out


def assert_runs_equal(jrun, trun, ctx):
    want, got = leaves(jrun.final_states), leaves(trun.final_states)
    assert want.keys() == got.keys(), ctx
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{ctx} {name}")
    np.testing.assert_array_equal(trun.rounds, jrun.rounds, err_msg=ctx)
    assert trun.eps_round == jrun.eps_round, ctx
    np.testing.assert_array_equal(trun.exchange_bytes, jrun.exchange_bytes,
                                  err_msg=ctx)
    np.testing.assert_array_equal(trun.frontier_max, jrun.frontier_max,
                                  err_msg=ctx)
    np.testing.assert_array_equal(trun.first_seen, jrun.first_seen,
                                  err_msg=ctx)
    assert trun.convergence.shape == jrun.convergence.shape, ctx
    np.testing.assert_allclose(trun.convergence, jrun.convergence,
                               atol=CONV_TOL, err_msg=ctx)


# -- (i) against the reference -------------------------------------------------

class TestExactFleet:
    R = 30

    @pytest.fixture(scope="class", params=[False, True],
                    ids=["full", "stop"])
    def runs(self, request):
        return both_runs("exact", EXACT_SPECS, self.R, stop=request.param)

    def test_rows_equal_reference(self, runs):
        jrun, trun, _ = runs
        assert_runs_equal(jrun, trun, "exact")

    def test_fleet_counters_equal_reference(self, runs):
        _, _, (want, got) = runs
        assert got == want and got["fleet.batches"] == 1

    def test_run_exercises_the_matrix(self, runs):
        """The suspicion lane quarantined (it differs from its window-0
        twin), the churn lane churned, and early exit froze someone."""
        jrun, trun, _ = runs
        names = trun.names
        known = trun.final_states.known
        sus, plain = names.index("suspicion"), names.index("no-window")
        assert not torch.equal(known[sus], known[plain])
        assert trun.host_reads["live"] in (0, self.R)
        if trun.host_reads["live"]:
            assert (trun.rounds < self.R).any()

    def test_table_and_digests(self, runs):
        jrun, trun, _ = runs
        want = jrun.table(200, 1000)
        got = trun.table(200, 1000)
        assert got == want


class TestChaosFleet:
    R = 25

    @pytest.fixture(scope="class")
    def runs(self):
        return both_runs("exact", CHAOS_SPECS, self.R, stop=False,
                         plan_json=chaos_plan_json(16))

    def test_rows_equal_reference(self, runs):
        jrun, trun, _ = runs
        assert_runs_equal(jrun, trun, "chaos")
        drops = trun.final_states.injected_drops
        assert drops[0] != drops[1]
        assert int(trun.final_states.injected_delays.min()) > 0

    def test_fleet_counters_equal_reference(self, runs):
        _, _, (want, got) = runs
        assert got == want and got["chaos.sim.droppedPackets"] > 0


class TestCompressedFleet:
    R = 30

    @pytest.mark.parametrize("stop", [False, True], ids=["full", "stop"])
    def test_rows_equal_reference(self, stop):
        jrun, trun, (want, got) = both_runs(
            "compressed", COMPRESSED_SPECS, self.R, stop=stop, eps=1e-3,
            tracked=(1, 7, 40))
        assert_runs_equal(jrun, trun, f"compressed stop={stop}")
        assert got == want
        # The reference's digest column reads ``known``, which a
        # compressed state lacks; the port's reads the belief view.
        jrun.digest_agreement = lambda i: None
        table = trun.table(200, 1000)
        assert [dict(r, digest_agreement=None) for r in table] == \
            jrun.table(200, 1000)
        assert all(0.0 < r["digest_agreement"] <= 1.0 for r in table)


# -- (ii) against the port's own unbatched runs --------------------------------

def unbatched_twin(fleet, batch, i):
    """Scenario ``i``'s unbatched port sim and its initial state."""
    spec = batch.specs[i]
    p = batch.scenario_params(i)
    hook = None
    if spec.churn_prob > 0:
        hook = tfleet.restart_churn_perturb(
            p, prob=spec.churn_prob, seed=tfleet.churn_seed(spec.seed))
    t = batch.scenario_timecfg(i)
    if batch.family == "compressed":
        sim = CompressedSim(p, fleet.topo, t, device="cpu")
        st = sim.init_state()
        return sim, sim.mint(st, batch.mint_slots(i), spec.mint_tick)
    if batch.plan is not None:
        sim = ChaosExactSim(p, fleet.topo, t, batch.scenario_plan(i),
                            device="cpu", perturb=hook)
    else:
        period, phase = batch.scenario_cadence(i)
        sim = ExactSim(p, fleet.topo, t, device="cpu", perturb=hook,
                       tick_period=period, tick_phase=phase)
    return sim, sim.init_state()


@pytest.mark.parametrize("family,specs,plan", [
    ("exact", EXACT_SPECS, False), ("chaos", CHAOS_SPECS, True),
    ("compressed", COMPRESSED_SPECS, False)])
def test_rows_equal_unbatched_port_runs(family, specs, plan):
    """Each row of a generator-driven fleet run equals the port's
    unbatched run of that scenario from the same generator, every field
    (rings and counters included) and the curve."""
    rounds = 20
    specs = [dict(s, topology="ring1") for s in specs]
    tb = batches("compressed" if family == "compressed" else "exact", specs,
                 chaos_plan_json(16) if plan else None)[1]
    fleet = tfleet.FleetSim(tb)
    run = fleet.run(fleet.init_states(), rounds)
    gens = tb.generators()
    for i, spec in enumerate(tb.specs):
        sim, st = unbatched_twin(fleet, tb, i)
        final, conv = sim.run(st, rounds, generator=gens[i])
        want = leaves(final)
        got = leaves(scenario_state(run.final_states, i))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{spec.name} {name}")
        np.testing.assert_allclose(run.convergence[:, i], conv.numpy(),
                                   atol=CONV_TOL)


@pytest.mark.parametrize("plan", [False, True], ids=["exact", "chaos"])
def test_cpu_inputs_replay_the_batch_own_run(plan):
    """``fleet.cpu_inputs`` holds what a batch's own run on the CPU
    draws (round draws, fault draws, churn masks): a run fed them ends
    in the same states and curves."""
    rounds = 20
    specs = CHAOS_SPECS if plan else EXACT_SPECS
    tb = batches("exact", specs, chaos_plan_json(16) if plan else None)[1]
    assert tb.has_churn
    own = tfleet.FleetSim(tb)
    a = own.run(own.init_states(), rounds)
    draws, faults, perturb = tfleet.cpu_inputs(tb, rounds)
    assert (faults is None) == (not plan)
    fed = tfleet.FleetSim(tb, perturb=perturb)
    b = fed.run(fed.init_states(), rounds, draws=draws, fault_draws=faults)
    want, got = leaves(a.final_states), leaves(b.final_states)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(b.convergence, a.convergence)


# -- (iii) the batched sweep window --------------------------------------------

def test_sweep_windows_equal_reference():
    """A per-scenario window (0 beside > 0, and per-scenario lifespans)
    on a state holding ALIVE, DRAINING, SUSPECT and TOMBSTONE cells
    equals the reference's traced-window sweep, vmapped."""
    rng = np.random.default_rng(3)
    s, n, m = 4, 8, 24
    now = 20_000
    status = rng.choice([ALIVE, DRAINING, SUSPECT, TOMBSTONE], (s, n, m))
    ts = rng.integers(0, now, (s, n, m))
    known = np.where(rng.random((s, n, m)) < 0.9,
                     (ts << 3) | status, 0).astype(np.int32)
    assert {ALIVE, DRAINING, SUSPECT, TOMBSTONE} <= set(
        (known[known > 0] & 7).tolist())
    windows = np.array([0, 2000, 0, 5000], np.int32)
    alive_l = np.array([8000, 4000, 12000, 6000], np.int32)
    drain_l = np.array([9000, 9000, 3000, 9000], np.int32)
    tomb_l = np.array([15000, 10000, 15000, 12000], np.int32)

    def ref(k, w, al, dl, tl):
        return jttl.ttl_sweep(k, now, alive_lifespan=al,
                              draining_lifespan=dl, tombstone_lifespan=tl,
                              one_second=1000, suspicion_window=w)

    want_swept, want_exp = jax.vmap(ref)(
        jnp.asarray(known), jnp.asarray(windows), jnp.asarray(alive_l),
        jnp.asarray(drain_l), jnp.asarray(tomb_l))
    host = [dataclasses.replace(
        knob_ops.RoundKnobs(limit=1, keep_prob=1.0, push_pull_rounds=1,
                            sweep_rounds=1, refresh_rounds=1,
                            recover_rounds=1, suspicion_window=int(w),
                            alive_lifespan=int(a), draining_lifespan=int(d),
                            tombstone_lifespan=int(t), stale_ticks=1))
        for w, a, d, t in zip(windows, alive_l, drain_l, tomb_l)]
    kn = knob_ops.BatchedKnobs.stack(host, "cpu")
    swept, expired = tttl.ttl_sweep(
        torch.tensor(known).reshape(s * n, m), now,
        alive_lifespan=kn.rows("alive_lifespan", n),
        draining_lifespan=kn.rows("draining_lifespan", n),
        tombstone_lifespan=kn.rows("tombstone_lifespan", n),
        one_second=1000, suspicion_window=kn.rows("suspicion_window", n))
    np.testing.assert_array_equal(swept.reshape(s, n, m).numpy(),
                                  np.asarray(want_swept))
    np.testing.assert_array_equal(expired.reshape(s, n, m).numpy(),
                                  np.asarray(want_exp))
    # The window-0 rows take the plain sweep, not the quarantine math.
    plain, _ = tttl.ttl_sweep(torch.tensor(known[0]), now,
                              alive_lifespan=int(alive_l[0]),
                              draining_lifespan=int(drain_l[0]),
                              tombstone_lifespan=int(tomb_l[0]),
                              one_second=1000)
    assert torch.equal(swept[:n], plain)


# -- (iv) validation, the grid, the registry, conversion ------------------------

BAD_SPECS = [
    ("duplicate", [dict(name="x"), dict(name="x")], {}),
    ("fanout", [dict(name="x", fanout=5)], {}),
    ("budget", [dict(name="x", budget=7)], {}),
    ("topology", [dict(name="x"), dict(name="y", topology="ring1")], {}),
    ("limit", [dict(name="x", retransmit_limit=126)], {}),
    ("drop", [dict(name="x", drop_prob=1.5)], {}),
    ("negative", [dict(name="x", sweep_interval_s=-1.0)], {}),
    ("tick_period", [dict(name="x", tick_period=0)], {}),
    ("tick_phase", [dict(name="x", tick_phase=-1)], {}),
    ("fault_seed", [dict(name="x", fault_seed=3)], {}),
    ("mint", [dict(name="x", mint_frac=0.1)], {}),
    ("churn", [dict(name="x", churn_prob=0.1)],
     dict(family="compressed")),
    ("family", [dict(name="x")], dict(family="nope")),
    ("plan_family", [dict(name="x")], dict(family="compressed",
                                           plan=True)),
    ("empty", [], {}),
]


@pytest.mark.parametrize("case,specs,kw", BAD_SPECS,
                         ids=[c[0] for c in BAD_SPECS])
def test_build_raises_the_reference_errors(case, specs, kw):
    """``ScenarioBatch.build`` refuses what the reference refuses, with
    the same message."""
    family = kw.get("family", "exact")
    plan = kw.get("plan")
    if family == "compressed":
        jp = jcompressed.CompressedParams(n=16, services_per_node=2,
                                          cache_lines=16, budget=5)
        tp = CompressedParams(n=16, services_per_node=2, cache_lines=16,
                              budget=5)
    else:
        jp, tp = jexact.SimParams(**EXACT_PARAMS), SimParams(**EXACT_PARAMS)
    jplan = JFaultPlan(seed=1) if plan else None
    tplan = FaultPlan(seed=1) if plan else None
    with pytest.raises(ValueError) as want:
        jfleet.ScenarioBatch.build(
            [jfleet.ScenarioSpec(**s) for s in specs], jp,
            JTimeConfig(**BASE), family=family, plan=jplan)
    with pytest.raises(ValueError) as got:
        tfleet.ScenarioBatch.build(
            [tfleet.ScenarioSpec(**s) for s in specs], tp,
            TimeConfig(**BASE), family=family, plan=tplan, device="cpu")
    assert str(got.value) == str(want.value)


PROTOCOL_CASES = [
    dict(n=0, fanout=1, budget=1),
    dict(n=4, fanout=1, budget=1, services_per_node=0),
    dict(n=4, fanout=0, budget=1),
    dict(n=4, fanout=4, budget=1),
    dict(n=4, fanout=2, budget=0),
    dict(n=4, fanout=2, budget=3, retransmit_limit=-1),
    dict(n=4, fanout=2, budget=3, retransmit_limit=127),
    dict(n=4, fanout=2, budget=3, retransmit_limit=9, name=""),
    dict(n=10**6, fanout=100, budget=3),
]


@pytest.mark.parametrize("kw", PROTOCOL_CASES)
def test_validate_protocol_config(kw):
    kw = dict(kw)
    n = kw.pop("n")
    try:
        jscenarios.validate_protocol_config(n, **kw)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        tscenarios.validate_protocol_config(n, **kw)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want


def test_register_scenario():
    def fn():
        return None

    name = "test-torch-fleet-scenario"
    tscenarios.ALL_SCENARIOS.pop(name, None)
    tscenarios.register_scenario(name, fn)
    with pytest.raises(ValueError) as got:
        tscenarios.register_scenario(name, fn)
    jscenarios.ALL_SCENARIOS.pop(name, None)
    jscenarios.register_scenario(name, fn)
    with pytest.raises(ValueError) as want:
        jscenarios.register_scenario(name, fn)
    assert str(got.value) == str(want.value)
    tscenarios.register_scenario(name, print, replace=True)
    assert tscenarios.ALL_SCENARIOS[name] is print
    with pytest.raises(TypeError) as got:
        tscenarios.register_scenario("x", 3)
    with pytest.raises(TypeError) as want:
        jscenarios.register_scenario("x", 3)
    assert str(got.value) == str(want.value)
    for reg in (tscenarios.ALL_SCENARIOS, jscenarios.ALL_SCENARIOS):
        reg.pop(name)


GRIDS = [
    (dict(drop_prob=[0.0, 0.1], push_pull_interval_s=[1.0, 2.0]), None, 3),
    (dict(fanout=[2, 3], drop_prob=[0.0, 0.1]), None, 64),
    (dict(retransmit_limit=[0, 8], suspicion_window_s=[0.0, 2.0],
          seed=[1, 2, 3]), dict(drop_prob=0.05), 5),
    (dict(future_fudge_s=[-1.0, 0.5], tick_period=[1, 2]), None, 64),
]


@pytest.mark.parametrize("axes,base,cap", GRIDS)
def test_grid_equals_reference(axes, base, cap):
    """``expand_grid`` and ``build_batches`` give the reference's specs,
    groups, chunks and knobs."""
    jspecs = jfleet.expand_grid(axes, base)
    tspecs = tfleet.expand_grid(axes, base)
    assert [dataclasses.asdict(s) for s in tspecs] == \
        [dataclasses.asdict(s) for s in jspecs]
    jb = jfleet.build_batches(jspecs, jexact.SimParams(**EXACT_PARAMS),
                              JTimeConfig(**BASE), max_batch=cap)
    tb = tfleet.build_batches(tspecs, SimParams(**EXACT_PARAMS),
                              TimeConfig(**BASE), max_batch=cap,
                              device="cpu")
    assert [idx for _, idx in tb] == [idx for _, idx in jb]
    for (j, _), (t, _) in zip(jb, tb):
        assert dataclasses.asdict(t.params) == dataclasses.asdict(j.params)
        got = convert.batched_knobs_from_numpy(
            {f: np.asarray(getattr(j.knobs, f))
             for f in knob_ops.KNOB_FIELDS}, "cpu")
        for f in knob_ops.KNOB_FIELDS:
            assert torch.equal(t.knobs.tensors[f], got.tensors[f]), f


def test_grid_rejections():
    for bad in (dict(fanuot=[2]), dict(seed=[]), dict(seed=3)):
        with pytest.raises(ValueError) as want:
            jfleet.expand_grid(bad)
        with pytest.raises(ValueError) as got:
            tfleet.expand_grid(bad)
        assert str(got.value) == str(want.value)


def test_pareto_front_equals_reference():
    rng = np.random.default_rng(5)
    rows = [{"rounds_to_eps": (None if rng.random() < 0.2
                               else int(rng.integers(1, 20))),
             "exchange_bytes": int(rng.integers(1, 50))}
            for _ in range(40)]
    want, got = jfleet.pareto_front(rows), tfleet.pareto_front(rows)
    assert list(got) == list(want)
    assert got.excluded == want.excluded and got.excluded


def test_convert_carries_a_chaos_fleet_across():
    """A reference chaos fleet's stacked state after 10 rounds, carried
    across, runs 10 more rounds in the port to the reference's 20-round
    state — rings and counters included; the batch's knobs come across
    equal to the port's."""
    plan_json = chaos_plan_json(16)
    jb, tb = batches("exact", CHAOS_SPECS[:3], plan_json)
    jf = jfleet.FleetSim(jb)
    half = jf.run(jf.init_states(), 10, stop=False).final_states
    full = jf.run(jf.init_states(), 20, stop=False).final_states
    arrays = {"sim": {f: np.array(getattr(half.sim, f))
                      for f in ("known", "sent", "node_alive", "round_idx")},
              "rings": [tuple(np.array(t) for t in r) for r in half.rings]}
    arrays.update({f: np.array(getattr(half, f))
                   for f in convert.CHAOS_COUNTERS})
    state = convert.fleet_state_from_numpy(arrays, "chaos", "cpu")
    draws, _, faults = reference_inputs(jb, 20)
    tf = tfleet.FleetSim(tb)
    run = tf.run(state, 10, draws=[d[10:] for d in draws],
                 fault_draws=[f[10:] for f in faults])
    want = leaves(full)
    got = leaves(run.final_states)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    back = convert.fleet_state_to_numpy(run.final_states)
    np.testing.assert_array_equal(back["sim"]["round_idx"], [20] * 3)
    knobs = convert.batched_knobs_from_numpy(
        {f: np.asarray(getattr(jb.knobs, f)) for f in knob_ops.KNOB_FIELDS},
        "cpu")
    for f in knob_ops.KNOB_FIELDS:
        assert torch.equal(knobs.tensors[f], tb.knobs.tensors[f]), f
