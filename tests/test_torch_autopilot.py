"""The port's autopilot (``sidecar_tpu_torch/autopilot/``), its SLO
evaluator (``telemetry/slo.py``) and the metrics histograms, against the
JAX reference, exactly.

* The pure host pieces — ``SloRule``/``SloEvaluator``, ``Objective``,
  ``AxisSpec``, ``es_search`` over a stub evaluator, ``fit_live`` and the
  registry's histograms — give the reference's results on the same
  inputs.
* ``fit_from_trace`` gives the reference's estimate on the reference's
  trace rows, and on the port's own ``ChaosExactSim.run_with_trace`` fed
  the reference's draws and fault draws (a loss plan and a pause plan).
* One ``recommend`` pass in lockstep: the port's fleet dispatches
  (``FleetEvaluator._run_batch``) take the reference's per-scenario
  draws (``torch_parity.reference_inputs``); the report equals the
  reference controller's in every field but ``replay`` (the port replays
  from its own generators) and ``wall_seconds``.
* Port only: with the port's own generators the replay is identical on
  the exact and the chaos family; the apply gate; the reference's
  ``ValueError`` texts.
"""

import dataclasses

import jax
import numpy as np
import pytest

from sidecar_tpu import autopilot as japilot
from sidecar_tpu import metrics as jmetrics
from sidecar_tpu.autopilot import search as jsearch
from sidecar_tpu.chaos import FaultPlan as JFaultPlan
from sidecar_tpu.models.exact import SimParams as JSimParams
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.ops.trace import trace_to_dicts as jtrace_to_dicts
from sidecar_tpu.telemetry import slo as jslo
from sidecar_tpu_torch import autopilot as tapilot
from sidecar_tpu_torch import fleet as tfleet
from sidecar_tpu_torch import metrics as tmetrics
from sidecar_tpu_torch.autopilot import search as tsearch
from sidecar_tpu_torch.chaos import ChaosExactSim, FaultPlan
from sidecar_tpu_torch.models.exact import SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import topology as ttopo
from sidecar_tpu_torch.ops.trace import trace_to_dicts
from sidecar_tpu_torch.telemetry import slo as tslo
from tests.torch_parity import (
    jax_exact_draw_seq,
    jax_fault_draw_seq,
    reference_batch,
    reference_inputs,
)

N, SPN, ROUNDS = 16, 4, 60
PARAMS = dict(n=N, services_per_node=SPN, fanout=3, budget=15)
CFG = dict(refresh_interval_s=10_000.0)
AXES = [{"name": "push_pull_interval_s", "lo": 0.5, "hi": 30.0,
         "log": True, "base": 20.0}]
RULES = ["converge <= 10 rounds"]


def raised(fn, *args, **kw):
    """``(exception type, text)`` of what ``fn`` raises, else None."""
    try:
        fn(*args, **kw)
    except (ValueError, TypeError) as exc:
        return type(exc), str(exc)
    return None


# -- the SLO evaluator -----------------------------------------------------------

RULE_TEXTS = ["p99 <= 12 rounds", "p95<=1.5s", "MAX <= 300 ms",
              "converge <= 20 rounds", "converge <= 5 seconds",
              "agreement >= 0.99", "p50 <= 2 round",
              "p99 <= banana", "p42 <= 3 rounds", "agreement <= 0.5",
              "converge >= 3 rounds", ""]
ROWS = [
    {"rounds_to_eps": 6, "seconds_to_eps": 1.2, "rounds_run": 40,
     "exchange_bytes": 1_000_000, "digest_agreement": 1.0},
    {"rounds_to_eps": None, "seconds_to_eps": None, "rounds_run": 40,
     "exchange_bytes": 5_000_000, "digest_agreement": 0.5},
    {"rounds_to_eps": 25, "seconds_to_eps": 5.0, "rounds_run": 40,
     "exchange_bytes": 0, "digest_agreement": None},
    {"rounds_to_eps": None, "seconds_to_eps": None, "rounds_run": 0,
     "exchange_bytes": None, "digest_agreement": 0.995},
]
LAGS = [None, {"samples": 0}, {"samples": 12, "p50": 3, "p95": 7,
                               "p99": 9, "max": 14},
        {"samples": 4, "p50": 30, "p95": 40, "p99": 41, "max": 41}]
GOOD_RULES = [r for r in RULE_TEXTS if raised(jslo.SloRule.parse, r)
              is None]


def test_slo_rules_parse_and_reject_as_reference():
    assert len(GOOD_RULES) == 7
    for text in RULE_TEXTS:
        assert raised(tslo.SloRule.parse, text) == \
            raised(jslo.SloRule.parse, text), text
        if text in GOOD_RULES:
            t, j = tslo.SloRule.parse(text), jslo.SloRule.parse(text)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert (t.key, t.text(), t.check(1.0)) == \
                (j.key, j.text(), j.check(1.0))
    assert tslo.DEFAULT_RULES == jslo.DEFAULT_RULES
    assert tslo.DEFAULT_COHERENCE_RULES == jslo.DEFAULT_COHERENCE_RULES


def test_slo_blocks_equal_reference():
    tev, jev = tslo.SloEvaluator(GOOD_RULES), jslo.SloEvaluator(GOOD_RULES)
    for row in ROWS:
        for lag in LAGS:
            for spr in (None, 0.2):
                assert tev.evaluate_row(row, lag=lag,
                                        seconds_per_round=spr) == \
                    jev.evaluate_row(row, lag=lag, seconds_per_round=spr)
    for lag in LAGS:
        for spr in (None, 0.2):
            assert tev.evaluate_lag(lag, spr, publish=False) == \
                jev.evaluate_lag(lag, spr, publish=False)


def test_slo_live_and_coherence_read_the_registry(monkeypatch):
    """``evaluate_live`` and ``evaluate_coherence`` over the same
    registry contents give the reference's blocks, and a published
    verdict sets the same ``slo.*`` gauges."""
    snap = {"counters": {}, "timers": {},
            "gauges": {"coherence.agreement": 0.995},
            "histograms": {
                "propagation.query.lag": {"count": 3, "p50_ms": 120.0,
                                          "p95_ms": 900.0,
                                          "p99_ms": 1500.0,
                                          "max_ms": 2500.0},
                "coherence.ttc": {"count": 2, "p50_ms": 800.0,
                                  "p95_ms": 1900.0, "p99_ms": 2100.0,
                                  "max_ms": 2100.0}}}
    monkeypatch.setattr(jmetrics, "snapshot", lambda: snap)
    monkeypatch.setattr(tmetrics, "snapshot", lambda: snap)
    tev, jev = tslo.SloEvaluator(GOOD_RULES), jslo.SloEvaluator(GOOD_RULES)
    assert tev.evaluate_live(publish=False) == \
        jev.evaluate_live(publish=False)
    assert tev.evaluate_coherence(publish=False) == \
        jev.evaluate_coherence(publish=False)
    monkeypatch.undo()
    tmetrics.reset()
    block = tslo.SloEvaluator(["p99 <= 12 rounds"]).evaluate_lag(LAGS[2])
    assert block["pass"] is True
    assert tmetrics.snapshot()["gauges"] == {
        "slo.p99_12rounds.observed": 9.0, "slo.p99_12rounds.ok": 1.0}


# -- the objective ---------------------------------------------------------------

def test_objective_scores_equal_reference():
    for rules in (GOOD_RULES, ["converge <= 10 rounds", "agreement >= 0.99"],
                  ["converge <= 300 ms"]):
        for spr in (None, 0.2):
            tobj = tapilot.Objective(rules, seconds_per_round=spr)
            jobj = japilot.Objective(rules, seconds_per_round=spr)
            assert tobj.rules_text == jobj.rules_text
            for row in ROWS:
                for lag in LAGS:
                    for horizon in (None, 40):
                        assert tobj.score_row(row, lag, horizon) == \
                            jobj.score_row(row, lag, horizon)
    from sidecar_tpu.autopilot import objective as jobjective
    from sidecar_tpu_torch.autopilot import objective as tobjective
    assert (tobjective.PENALTY, tobjective.VIOLATION_CAP) == \
        (jobjective.PENALTY, jobjective.VIOLATION_CAP)


# -- the search ------------------------------------------------------------------

AXIS_CASES = [("push_pull_interval_s", 0.5, 30.0, dict(log=True, base=20.0)),
              ("retransmit_limit", 2, 12, {}),
              ("suspicion_window_s", 0.0, 8.0, dict(base=2.0)),
              ("drop_prob", 0.0, 0.4, {})]


def test_axis_spec_equals_reference():
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    for name, lo, hi, kw in AXIS_CASES:
        t, j = tsearch.AxisSpec(name, lo, hi, **kw), \
            jsearch.AxisSpec(name, lo, hi, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.data_axis == j.data_axis
        for k in (1, 2, 3, 4, 7):
            assert t.grid(k) == j.grid(k)
        for v in (-1.0, lo, 0.37 * hi, 3.7, hi * 2):
            assert t.clip(v) == j.clip(v)
        for cand in ({}, {name: t.clip(0.5 * (lo + hi))}):
            assert t.effective(cand) == j.effective(cand)
            for sigma in (0.25, 0.1):
                assert t.jitter(t.effective(cand), rng_t, sigma) == \
                    j.jitter(j.effective(cand), rng_j, sigma)
    for args in (("not_a_knob", 0.0, 1.0), ("drop_prob", 0.5, 0.5),
                 ("push_pull_interval_s", 0.0, 10.0, False, True)):
        got = raised(tsearch.AxisSpec, *args)
        assert got is not None and got == raised(jsearch.AxisSpec, *args)
    axes_t = [tsearch.AxisSpec(n, lo, hi, **kw)
              for n, lo, hi, kw in AXIS_CASES]
    axes_j = [jsearch.AxisSpec(n, lo, hi, **kw)
              for n, lo, hi, kw in AXIS_CASES]
    assert tsearch.exhaustive_grid_size(axes_t) == \
        jsearch.exhaustive_grid_size(axes_j)


class StubEvaluator:
    """Scores a candidate by a fixed function of it, as the fleet would,
    and counts what it scored."""

    def __init__(self, pkg):
        self.pkg, self.evaluations, self.dispatches = pkg, 0, 0

    def evaluate(self, candidates, tag):
        out = []
        for i, cand in enumerate(candidates):
            pp = cand.get("push_pull_interval_s", 20.0)
            lim = cand.get("retransmit_limit", 8)
            score = abs(np.log(pp / 2.0)) + 0.1 * abs(lim - 5) + \
                cand.get("drop_prob", 0.0)
            out.append(self.pkg.EvalResult(
                candidate=dict(cand), name=f"{tag}-c{i:02d}",
                score=float(score), slo={}, row={}, batch=None, run=None,
                lane=i))
        self.evaluations += len(candidates)
        self.dispatches += 1
        return out


@pytest.mark.parametrize("kw", [
    dict(seed_grid=2, generations=2, population=5, seed=9),
    dict(seed_grid=3, generations=3, population=4, elites=3, seed=1,
         include_baseline=False),
    dict(seed_grid=1, generations=0, seed=2)])
def test_es_search_equals_reference(kw):
    def search(pkg):
        axes = [pkg.AxisSpec(n, lo, hi, **akw)
                for n, lo, hi, akw in AXIS_CASES]
        return pkg.es_search(StubEvaluator(pkg), axes, **kw)

    t, j = search(tsearch), search(jsearch)
    assert [(r.candidate, r.name, r.score) for r in t.history] == \
        [(r.candidate, r.name, r.score) for r in j.history]
    assert (t.best.name, t.evaluations, t.dispatches, t.generations_run,
            t.grid_points) == (j.best.name, j.evaluations, j.dispatches,
                               j.generations_run, j.grid_points)
    assert (t.baseline is None) == (j.baseline is None)
    assert t.to_json() == j.to_json()


# -- the fit ---------------------------------------------------------------------

def fit_plans():
    """The reference tests' plans: 20 % loss on every edge, and the last
    4 nodes paused from round 1 on."""
    from sidecar_tpu.chaos import EdgeFault, NodeFault
    from sidecar_tpu.chaos.plan import FOREVER

    everyone = tuple(range(N))
    return {
        "loss": JFaultPlan(seed=2, edges=(EdgeFault(
            src=everyone, dst=everyone, drop_prob=0.2),)),
        "pause": JFaultPlan(seed=1, nodes=(NodeFault(
            nodes=tuple(range(N - 4, N)), start_round=1, end_round=FOREVER,
            kind="pause"),))}


@pytest.fixture(scope="module")
def traces():
    """Per plan: the reference's trace rows and injections, and the
    port's from the same draws and fault draws."""
    from sidecar_tpu.chaos import ChaosExactSim as JChaosExactSim

    out = {}
    jp, jt = JSimParams(**PARAMS), JTimeConfig(**CFG)
    for label, plan in fit_plans().items():
        jsim = JChaosExactSim(jp, jtopo.complete(N), jt, plan=plan)
        key = jax.random.PRNGKey(0)
        jfinal, jtr, _ = jsim.run_with_trace(jsim.init_state(), key,
                                             ROUNDS, cap=ROUNDS)
        tsim = ChaosExactSim(SimParams(**PARAMS), ttopo.complete(N),
                             TimeConfig(**CFG),
                             FaultPlan.loads(plan.dumps()), device="cpu")
        tfinal, ttr, _ = tsim.run_with_trace(
            tsim.init_state(), ROUNDS, cap=ROUNDS,
            draws=jax_exact_draw_seq(jsim, key, 0, ROUNDS),
            fault_draws=jax_fault_draw_seq(jsim, 0, ROUNDS))
        out[label] = (jtrace_to_dicts(jtr), jsim.injection_counts(jfinal),
                      trace_to_dicts(ttr), tsim.injection_counts(tfinal))
    return out


@pytest.mark.parametrize("label", ["loss", "pause"])
def test_fit_from_trace_equals_reference(traces, label):
    jrows, jinj, trows, tinj = traces[label]
    assert trows == jrows and tinj == jinj
    want = japilot.fit_from_trace(jrows, params=JSimParams(**PARAMS),
                                  injections=jinj,
                                  timecfg=JTimeConfig(**CFG))
    for rows, inj in ((jrows, jinj), (trows, tinj)):
        got = tapilot.fit_from_trace(rows, params=SimParams(**PARAMS),
                                     injections=inj,
                                     timecfg=TimeConfig(**CFG))
        assert got.to_json() == want.to_json()
        assert got.base_fields() == want.base_fields()
    if label == "loss":
        assert 0.1 <= got.loss_rate <= 0.3
    else:
        assert got.paused_frac == pytest.approx(0.25, abs=0.1)
        tplan, jplan = got.fault_plan(seed=7), want.fault_plan(seed=7)
        assert tplan.dumps() == jplan.dumps()


def test_fit_live_equals_reference():
    snap = {"gauges": {"engine.udpOut": 1000.0, "engine.udpSendDrops": 50.0,
                       "coherence.agreement": 0.9},
            "counters": {"damping.flaps": 64.0}}
    for window in (None, 100):
        got = tapilot.fit_live(snap, n=16, services_per_node=4,
                               window_rounds=window)
        want = japilot.fit_live(snap, n=16, services_per_node=4,
                                window_rounds=window)
        assert got.to_json() == want.to_json()
    tmetrics.reset()
    tmetrics.set_gauge("engine.udpOut", 10.0)
    tmetrics.incr("engine.udpSendDrops", 2)
    assert tapilot.fit_live(n=4, services_per_node=1).loss_rate == 0.2
    tmetrics.reset()


# -- the closed loop, in lockstep ------------------------------------------------

RUN_BATCH = tsearch.FleetEvaluator._run_batch


def lockstep_run_batch(self, batch):
    """``FleetEvaluator._run_batch`` fed the reference's per-scenario
    draws, churn masks and fault draws."""
    draws, masks, faults = reference_inputs(reference_batch(batch),
                                            self.rounds)
    perturb = None
    if batch.has_churn:
        perturb = tfleet.restart_churn_perturb(batch.params, masks=masks)
    return RUN_BATCH(self, batch, (draws, faults, perturb))


RECOMMEND = dict(rules=RULES, estimate={"loss_rate": 0.45}, n=16,
                 rounds=40, seed=3, seed_grid=2, generations=1,
                 population=3, axes=AXES)


def test_recommend_lockstep_equals_reference(monkeypatch):
    want = japilot.AutopilotController(
        timecfg=JTimeConfig()).recommend(**RECOMMEND)
    monkeypatch.setattr(tsearch.FleetEvaluator, "_run_batch",
                        lockstep_run_batch)
    tmetrics.reset()
    got = tapilot.AutopilotController(timecfg=TimeConfig()).recommend(
        device="cpu", **RECOMMEND)
    assert set(got) == set(want)
    for key in want:
        if key not in ("replay", "wall_seconds"):
            assert got[key] == want[key], key
    assert want["baseline"]["slo"]["pass"] is False
    assert got["recommended"]["slo"]["pass"] is True
    assert got["evaluations"] == got["candidates"] == 6
    snap = tmetrics.snapshot()
    assert snap["counters"]["autopilot.recommendations"] == 1
    assert snap["counters"]["autopilot.evaluations"] == 6
    assert snap["histograms"]["autopilot.recommend"]["count"] == 1
    assert round(snap["gauges"]["autopilot.best_score"], 6) == \
        got["recommended"]["score"]


# -- port only: the replay, the gate, the errors ---------------------------------

# Every candidate but the baseline gossips every second or third round:
# the exact replay takes the lane's cadence, and the chaos round takes
# none, in the fleet's batch as in ``ChaosExactSim``.
TICK_AXES = [{"name": "tick_period", "lo": 2, "hi": 3, "integer": True}]
LOSS_CHURN = {"loss_rate": 0.2, "churn_rate": 0.01}


@pytest.mark.parametrize("estimate,axes", [
    (LOSS_CHURN, AXES),
    (dict(LOSS_CHURN, paused_frac=0.25), AXES),
    (LOSS_CHURN, TICK_AXES),
    (dict(LOSS_CHURN, paused_frac=0.25), TICK_AXES)],
    ids=["exact", "chaos", "exact_tick_period", "chaos_tick_period"])
def test_replay_identical_with_port_generators(estimate, axes,
                                               monkeypatch):
    """The winner's replay, and every other candidate's, is identical
    to its fleet row."""
    seen = []
    evaluate = tsearch.FleetEvaluator.evaluate

    def kept(self, candidates, tag):
        out = evaluate(self, candidates, tag)
        seen.extend(out)
        return out

    monkeypatch.setattr(tsearch.FleetEvaluator, "evaluate", kept)
    rep = tapilot.AutopilotController(timecfg=TimeConfig()).recommend(
        rules=RULES, estimate=estimate, n=16, rounds=30, seed=3,
        seed_grid=2, generations=1, population=2, axes=axes,
        device="cpu")
    assert (rep["fault_plan"] is None) == ("paused_frac" not in estimate)
    assert rep["replay"] == {"checked": True, "rounds": 30,
                             "identical": True,
                             "fields": dict.fromkeys(tapilot.REPLAY_FIELDS,
                                                     True)}
    if axes is TICK_AXES:
        assert {r.candidate.get("tick_period") for r in seen} >= {2, 3}
    for result in seen:
        assert tapilot.replay_check(result)["identical"], result.candidate


class _Bridge:
    def __init__(self):
        self.state = None
        self.t = TimeConfig()


@pytest.mark.parametrize("armed,apply", [(False, True), (True, True),
                                         (True, False)])
def test_apply_gate(armed, apply):
    tmetrics.reset()
    bridge = _Bridge()
    before = dataclasses.replace(bridge.t)
    rep = tapilot.AutopilotController(bridge=bridge,
                                      apply_armed=armed).recommend(
        apply=apply, device="cpu", **RECOMMEND)
    counters = tmetrics.snapshot()["counters"]
    if armed and apply:
        assert rep["apply"]["applied"] is True
        knob = rep["apply"]["fields"]["push_pull_interval_s"]
        assert bridge.t.push_pull_interval_s == knob != 20.0
        assert counters["autopilot.applied"] == 1
    else:
        assert rep["apply"] == {"requested": apply, "armed": armed,
                                "applied": False, "fields": {}}
        assert bridge.t == before
        assert counters.get("autopilot.apply_blocked", 0) == int(apply)


def test_state_receives_the_report_and_sizes_the_twin():
    import threading

    class Catalog:
        _lock = threading.Lock()
        servers = {f"host{i}": None for i in range(5)}

    state = Catalog()
    rep = tapilot.AutopilotController(state=state).recommend(
        rules=RULES, estimate={"loss_rate": 0.1}, rounds=5, seed_grid=1,
        generations=0, axes=AXES, device="cpu")
    assert rep["n"] == 8 and state.autopilot_report is rep


MALFORMED = [
    dict(rules=[], estimate={}, n=16),
    dict(rules=RULES, estimate={"loss_rate": 1.5}, n=16),
    dict(rules=RULES, estimate={"typo_rate": 0.1}, n=16),
    dict(rules=RULES, estimate={}, n=16,
         axes=[{"name": "push_pull_interval_s", "lo": 1, "hi": 2,
                "bogus": 3}]),
    dict(rules=RULES, estimate={}, n=16, axes=[{"name": "drop_prob"}]),
    dict(rules=RULES, estimate={}, n=16, axes=["drop_prob"]),
    dict(rules=["converge <= banana"], estimate={}, n=16),
    dict(rules=RULES, estimate={}, n=16, rounds=0),
    dict(rules=RULES, estimate={}),
]


@pytest.mark.parametrize("kw", MALFORMED)
def test_malformed_inputs_raise_reference_text(kw):
    got = raised(tapilot.AutopilotController(timecfg=TimeConfig()).recommend,
                 device="cpu", **kw)
    want = raised(japilot.AutopilotController(
        timecfg=JTimeConfig()).recommend, **kw)
    assert got is not None and got == want


def test_defaults_are_the_reference_env_defaults():
    from sidecar_tpu.autopilot import controller as jcontroller
    from sidecar_tpu_torch.autopilot import controller as tcontroller
    assert tcontroller.DEFAULT_AUTOPILOT_RULES == \
        jcontroller.DEFAULT_AUTOPILOT_RULES
    assert tcontroller.REPLAY_FIELDS == jcontroller.REPLAY_FIELDS
    t = tapilot.default_axes(TimeConfig(), SimParams(n=64))
    j = japilot.default_axes(JTimeConfig(), JSimParams(n=64))
    assert [dataclasses.asdict(a) for a in t] == \
        [dataclasses.asdict(a) for a in j]


# -- the metrics histograms ------------------------------------------------------

def test_histogram_snapshot_equals_reference():
    """The same samples (past the 512-sample reservoir, so Algorithm R's
    draws count) give the reference registry's snapshot; ``reset``
    clears every block."""
    treg, jreg = tmetrics.Metrics(), jmetrics.Metrics()
    rng = np.random.default_rng(5)
    for reg in (treg, jreg):
        reg.incr("a.count", 3)
        reg.set_gauge("a.gauge", 0.5)
    for ms in rng.exponential(20.0, 700):
        treg.histogram("lat", ms)
        jreg.histogram("lat", ms)
    for ms in (1.0, 2.5):
        treg.histogram("short", ms)
        jreg.histogram("short", ms)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.counter("a.count") == jreg.counter("a.count") == 3
    assert treg.counter("nothing") == 0
    treg.measure_since("timer", 0.0)
    assert treg.snapshot()["timers"]["timer"]["count"] == 1
    treg.reset()
    assert treg.snapshot() == {"counters": {}, "gauges": {}, "timers": {},
                               "histograms": {}}
