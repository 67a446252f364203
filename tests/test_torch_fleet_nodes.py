"""The fleet's node axis: ``FleetSim(batch, group=, node_devices=nd)``
over real gloo groups of CPU processes (``parallel/launch.spawn_group``)
laid as the reference's ``fleet_mesh(sd, nd)``, against the one-process
port fleet and the JAX reference's ``FleetSim`` on that mesh.

One group is spawned for each layout ``(sd, nd)`` — ``(1, 2)`` on two
ranks and ``(2, 2)`` on four — and runs every case in turn
(``tests/torch_dist_worker.py``, which imports no JAX); meanwhile this
process runs the reference fleet on the ``("scenario", "node")`` mesh
and the port's one-process fleet from the same draws, fault draws and
churn masks (``torch_parity.reference_inputs``).  The cases:

* exact — the reference's exact matrix (``tests/test_fleet.py``: loss,
  limit 8, push-pull every second, the suspicion window, churn, the
  future bound) and one scenario with the per-origin budget on a tick
  cadence, 8 scenarios of 16 nodes, 30 rounds;
* chaos — the reference's 4-scenario chaos batch (fault seeds 7, 8, 9,
  a lossy and a churny scenario) under its one-way loss and pause, with
  a delay ring carrying duplicates the other way, a crash window on the
  second node block, rushing clocks, a full split of the sides and the
  defences (future bound, budget, quarantine) on one scenario, 25
  rounds;

each with ``stop=False`` (the provenance plane's ``first_seen`` on) and
``stop=True``.  Every rank's ``table(...)``, curve, ``first_seen`` and
the joined final state (``convert.join_state``: rows, ring lanes and
summed counters) equal the one-process fleet's bit for bit; the
integers equal the reference's, its curves within the ``atol=1e-6`` its
own mesh test allows.  Then the validation errors, in the reference's
words.
"""

import threading
import types

import jax
import numpy as np
import pytest

from sidecar_tpu import fleet as jfleet
from sidecar_tpu.chaos import ClockFault as JClockFault
from sidecar_tpu.chaos import EdgeFault as JEdgeFault
from sidecar_tpu.chaos import FaultPlan as JFaultPlan
from sidecar_tpu.chaos import NodeFault as JNodeFault
from sidecar_tpu.fleet.engine import fleet_mesh
from sidecar_tpu.models import compressed as jcompressed
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu_torch import convert
from sidecar_tpu_torch import fleet as tfleet
from sidecar_tpu_torch.models.compressed import CompressedParams
from sidecar_tpu_torch.models.exact import SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.parallel import spawn_group
from tests import torch_dist_worker as worker
from tests.torch_parity import reference_inputs

N = 16
PARAMS = dict(n=N, services_per_node=2, fanout=3, budget=5)
TIME = dict(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
EPS = 0.05
EXACT_SPECS = (
    dict(name="plain", seed=1),
    dict(name="lossy", seed=2, drop_prob=0.15),
    dict(name="limit8", seed=3, retransmit_limit=8),
    dict(name="pp1", seed=4, push_pull_interval_s=1.0),
    dict(name="suspicion", seed=5, suspicion_window_s=1.0,
         alive_lifespan_s=2.0, sweep_interval_s=0.4,
         refresh_interval_s=4.0),
    dict(name="churny", seed=6, churn_prob=0.01),
    dict(name="fudged", seed=7, future_fudge_s=0.5),
    dict(name="budgeted", seed=8, origin_budget=1, drop_prob=0.1,
         tick_period=2, tick_phase=1),
)
CHAOS_SPECS = (
    dict(name="fs7", seed=1, fault_seed=7),
    dict(name="fs8", seed=1, fault_seed=8),
    dict(name="fs9-lossy", seed=2, fault_seed=9, drop_prob=0.05,
         future_fudge_s=0.5, origin_budget=1, origin_quarantine=2,
         refresh_interval_s=1.0),
    dict(name="fs7-churny", seed=3, fault_seed=7, churn_prob=0.01),
)
CASES = {
    "exact-full": dict(specs=EXACT_SPECS, chaos=False, rounds=30,
                       stop=False, tracked=(0, 5, 17)),
    "exact-stop": dict(specs=EXACT_SPECS, chaos=False, rounds=30,
                       stop=True, tracked=()),
    "chaos-full": dict(specs=CHAOS_SPECS, chaos=True, rounds=25,
                       stop=False, tracked=(1, 9)),
    "chaos-stop": dict(specs=CHAOS_SPECS, chaos=True, rounds=25,
                       stop=True, tracked=()),
}
LAYOUTS = [(1, 2), (2, 2)]


def plan_json():
    """The reference chaos batch's plan (one-way loss A → B, a pause of
    nodes 1 and 2 over rounds 5–15), with a delay ring and duplicates
    B → A, a crash of node 11 over rounds 3–12, rushing clocks (side B
    inside the future bound, node 3 beyond it) and a full split of the
    sides over rounds 16–22 (push-pull severed)."""
    a, b = tuple(range(N // 2)), tuple(range(N // 2, N))
    return JFaultPlan(
        seed=7,
        edges=(JEdgeFault(src=a, dst=b, drop_prob=0.2),
               JEdgeFault(src=b, dst=a, delay_rounds=2, delay_prob=0.2,
                          duplicate_prob=0.1)),
        nodes=(JNodeFault(nodes=(1, 2), start_round=5, end_round=15,
                          kind="pause"),
               JNodeFault(nodes=(11,), start_round=3, end_round=12,
                          kind="crash")),
        clocks=(JClockFault(nodes=b, start_round=2, offset_ticks=300),
                JClockFault(nodes=(3,), start_round=2,
                            offset_ticks=1500)),
    ).with_edges(*JFaultPlan.partition(a, b, 16, 22)).dumps()


def reference_batch(case):
    return jfleet.ScenarioBatch.build(
        [jfleet.ScenarioSpec(**s) for s in case["specs"]],
        jexact.SimParams(**PARAMS), JTimeConfig(**TIME), family="exact",
        plan=JFaultPlan.loads(plan_json()) if case["chaos"] else None)


def worker_case(case, inputs):
    """The case as the worker takes it: plain data only."""
    draws, masks, faults = inputs
    return dict(specs=list(case["specs"]), params=PARAMS, time=TIME,
                plan=plan_json() if case["chaos"] else None,
                rounds=case["rounds"],
                draws=[worker.draws_to_data(d) for d in draws],
                faults=None if faults is None else
                [worker.faults_to_data(f) for f in faults],
                masks=[None if m is None else
                       {r: v.numpy() for r, v in m.items()} for m in masks],
                stop=case["stop"], eps=EPS, tracked=case["tracked"])


def reference_leaves(final) -> dict:
    """The reference fleet's final state as ``convert.fleet_leaves``
    names a port fleet's."""
    if hasattr(final, "rings"):
        state = {"sim": {f: np.asarray(getattr(final.sim, f)) for f in
                         ("known", "sent", "node_alive", "round_idx")},
                 "rings": [tuple(np.asarray(t) for t in ring)
                           for ring in final.rings]}
        state.update({f: np.asarray(getattr(final, f))
                      for f in convert.CHAOS_COUNTERS})
    else:
        state = {f: np.asarray(getattr(final, f)) for f in
                 ("known", "sent", "node_alive", "round_idx")}
    return convert.fleet_leaves(state)


# -- the one-process runs, shared by both layouts ------------------------------

@pytest.fixture(scope="module")
def inputs():
    """Per case: the reference batch's draws, churn masks and fault
    draws, and the port's one-process run from them."""
    out = {}
    for cid, case in CASES.items():
        data = worker_case(case, reference_inputs(reference_batch(case),
                                                  case["rounds"]))
        out[cid] = (data, worker.run_fleet_nodes(worker.LocalContext, nd=1,
                                                 **data))
    return out


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=[f"{sd}x{nd}" for sd, nd in LAYOUTS])
def layout(request, inputs):
    """Spawn the layout's group on every case and run the reference's
    fleets on its mesh meanwhile: ``(sd, nd, {case id: (rank results,
    one-process run, reference run)})``."""
    sd, nd = request.param
    got, failure = {}, []
    cases = [(cid, "fleet_nodes", dict(data, nd=nd))
             for cid, (data, _) in inputs.items()]

    def spawn():
        try:
            got["ranks"] = spawn_group(worker.run_cases, sd * nd, "gloo",
                                       (cases,), device="cpu",
                                       timeout_s=240.0)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            failure.append(exc)

    thread = threading.Thread(target=spawn)
    thread.start()
    refs = {}
    try:
        for cid, case in CASES.items():
            jf = jfleet.FleetSim(reference_batch(case),
                                 mesh=fleet_mesh(sd, nd))
            refs[cid] = jf.run(jf.init_states(), case["rounds"], eps=EPS,
                               stop=case["stop"], tracked=case["tracked"])
    finally:
        thread.join(300.0)
    assert not thread.is_alive()
    if failure:
        raise failure[0]
    return sd, nd, {cid: ([r[cid] for r in got["ranks"]], inputs[cid][1],
                          refs[cid]) for cid in CASES}


# -- against the one-process fleet ---------------------------------------------

@pytest.mark.parametrize("cid", sorted(CASES))
def test_ranks_equal_one_process_fleet(layout, cid):
    """Every rank's table, curve, rounds, crossings, bytes, frontiers and
    ``first_seen``, and the joined final state, equal the one-process
    fleet's bit for bit."""
    sd, nd, results = layout
    parts, local, _ = results[cid]
    for p in parts:
        assert p["table"] == local["table"], cid
        assert p["eps_round"] == local["eps_round"], cid
        assert p["host_reads"] == local["host_reads"], cid
        for k in ("convergence", "rounds", "first_seen", "exchange_bytes",
                  "frontier_max"):
            np.testing.assert_array_equal(p[k], local[k],
                                          err_msg=f"{cid} {k}")
        assert p["convergence"].dtype == np.float32
    want = convert.fleet_leaves(local["state"])
    got = convert.fleet_leaves(convert.join_state([p["state"] for p in parts], nd))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{cid} {name}")
    # Each rank holds its node block's rows of its scenario block.
    s = len(CASES[cid]["specs"]) // sd
    assert parts[0]["state"].get("sim", parts[0]["state"])[
        "known"].shape[:2] == (s, N // nd)
    # Premise: the rows crossed the node group, and gloo staged nothing.
    for p in parts:
        assert p["node_exchange"]["bytes_sent"] > 0
        assert p["node_exchange"]["staging_bytes"] == 0


# -- against the reference on its mesh -----------------------------------------

@pytest.mark.parametrize("cid", sorted(CASES))
def test_ranks_equal_reference_mesh(layout, cid):
    """The integers equal the reference ``FleetSim`` on ``fleet_mesh(sd,
    nd)`` bit for bit; its curves within ``atol=1e-6``."""
    sd, nd, results = layout
    parts, _, jrun = results[cid]
    want = reference_leaves(jrun.final_states)
    got = convert.fleet_leaves(convert.join_state([p["state"] for p in parts], nd))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{cid} {name}")
    jtable = jrun.table(200, 1000)
    for p in parts:
        np.testing.assert_array_equal(p["rounds"], jrun.rounds)
        assert p["eps_round"] == jrun.eps_round
        np.testing.assert_array_equal(p["exchange_bytes"],
                                      jrun.exchange_bytes)
        np.testing.assert_array_equal(p["frontier_max"], jrun.frontier_max)
        np.testing.assert_array_equal(p["first_seen"], jrun.first_seen)
        np.testing.assert_allclose(p["convergence"], jrun.convergence,
                                   atol=1e-6)
        for row, jrow in zip(p["table"], jtable):
            row, jrow = dict(row), dict(jrow)
            assert abs(row.pop("final_convergence")
                       - jrow.pop("final_convergence")) <= 1e-6
            assert row == jrow, cid


def test_cases_exercise_the_layout(layout):
    """The premises: early exit froze scenarios at different rounds, the
    chaos batch delayed, duplicated, crashed and quarantined, the churn
    scenario churned, and the tracked slots reached some nodes late."""
    sd, nd, results = layout
    for cid in ("exact-stop", "chaos-stop"):
        rounds = results[cid][1]["rounds"]
        assert (rounds < CASES[cid]["rounds"]).any() and \
            len(set(rounds)) > 1, (cid, rounds)
    chaos = results["chaos-full"][1]["state"]
    assert (chaos["injected_delays"] > 0).all()
    assert (chaos["injected_dups"] > 0).any()
    assert chaos["origin_violations"].max() >= 2   # a quarantine
    assert (chaos["rejected_future"] > 0).any()
    first = results["exact-full"][1]["first_seen"]
    assert (first > first.min()).any()


# -- validation, in the reference's words --------------------------------------

def _ranks(world):
    """A stand-in group of ``world`` ranks: validation reads its size
    only."""
    return types.SimpleNamespace(world=world, rank=0)


@pytest.mark.parametrize("what,world,nd,scenarios,n,match", [
    ("compressed", 2, 2, 2, 32, "composes on the exact family only"),
    ("scenario axis", 4, 2, 3, 16, "divide the scenario"),
    ("node axis", 3, 3, 3, 16, "must divide the node mesh axis"),
])
def test_validation_raises_the_reference_errors(what, world, nd, scenarios,
                                                n, match):
    specs = [dict(name=f"s{i}", seed=i) for i in range(scenarios)]
    if what == "compressed":
        jp = jcompressed.CompressedParams(n=n, services_per_node=4,
                                          cache_lines=16)
        tp = CompressedParams(n=n, services_per_node=4, cache_lines=16)
        family = "compressed"
    else:
        jp, tp = jexact.SimParams(**dict(PARAMS, n=n)), \
            SimParams(**dict(PARAMS, n=n))
        family = "exact"
    jb = jfleet.ScenarioBatch.build(
        [jfleet.ScenarioSpec(**s) for s in specs], jp, JTimeConfig(**TIME),
        family=family)
    with pytest.raises(ValueError, match=match):
        jfleet.FleetSim(jb, mesh=fleet_mesh(world // nd, nd))
    tb = tfleet.ScenarioBatch.build(
        [tfleet.ScenarioSpec(**s) for s in specs], tp, TimeConfig(**TIME),
        family=family, device="cpu")
    with pytest.raises(ValueError, match=match):
        tfleet.FleetSim(tb, group=_ranks(world), node_devices=nd)


def test_node_devices_must_divide_the_world():
    tb = tfleet.ScenarioBatch.build(
        [tfleet.ScenarioSpec(name="a", seed=1)], SimParams(**PARAMS),
        TimeConfig(**TIME), device="cpu")
    with pytest.raises(ValueError, match="must divide the group's"):
        tfleet.FleetSim(tb, group=_ranks(2), node_devices=4)
    with pytest.raises(ValueError, match="must divide the group's"):
        tfleet.FleetSim(tb, node_devices=2)
