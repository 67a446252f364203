"""Ground rules of the PyTorch port: it imports neither ``jax`` nor
anything of ``sidecar_tpu`` (nor does ``chip_smoke.py``), its entry
points (both models, the fleet and the bridge) refuse to fall back to
the CPU when no GPU is present, the options once deferred run a round (the execution modes',
and the chaos options ``perturb``, ``cut_mask`` and ``node_side``, each
equal to the JAX reference's round), no module names a deferred
ROADMAP item any more, and state, params, time configs and graphs
survive the trip through ``convert``.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models.compressed import (
    CompressedParams,
    CompressedSim,
)
from sidecar_tpu_torch.models.exact import ExactSim, SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import topology
from tests.torch_parity import (
    chaos_option_kwargs,
    assert_exact_states_equal,
    assert_states_equal,
    exact_port_pair,
    exact_port_state,
    jax_draw_seq,
    jax_exact_draw_seq,
    port_pair,
    port_state,
)

CHAOS_OPTIONS = ("perturb", "cut_mask", "node_side")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "sidecar_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "sidecar_tpu"), (path, mod)


def test_every_port_module_is_checked():
    names = {p.name for p in PORT_FILES}
    for expected in ("status.py", "merge.py", "ttl.py", "suspicion.py",
                     "gossip.py", "knobs.py", "topology.py",
                     "publish_gather.py", "build.py", "compressed.py",
                     "timecfg.py", "convert.py", "mesh.py",
                     "sharded_compressed.py", "sharded.py", "chip_smoke.py",
                     "exact.py",
                     "scatter_max.py", "common.py", "sparse.py",
                     "pipeline.py", "metrics.py", "trace.py", "digest.py",
                     "delta.py", "provenance.py", "planes.py", "cost.py",
                     "plan.py", "adversary.py", "sim_inject.py",
                     "batch.py", "engine.py", "grid.py", "rounds.py",
                     "scenarios.py", "fit.py", "objective.py", "search.py",
                     "controller.py", "slo.py", "checkpoint.py",
                     "sim_bridge.py", "oracle.py", "service.py",
                     "damping.py", "state.py", "span.py", "looper.py",
                     "output.py", "propagation.py", "coherence.py",
                     "snapshot.py", "hub.py", "url_listener.py",
                     "antientropy.py", "scheduler.py", "live_inject.py",
                     "prometheus.py", "api.py", "server.py"):
        assert expected in names, expected
    for package in ("chaos", "fleet", "sim", "autopilot", "telemetry",
                    "bridge", "catalog", "runtime", "query", "transport",
                    "web"):
        assert any(p.parent.name == package for p in PORT_FILES), package


def environment_reads(path):
    """``os.environ``/``os.getenv`` (and ``environ``/``getenv`` imported
    from ``os``) read in ``path``'s code."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in (
                "environ", "getenv", "environb", "getenvb") and \
                isinstance(node.value, ast.Name) and node.value.id == "os":
            yield node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module == "os" and \
                any(a.name in ("environ", "getenv") for a in node.names):
            yield node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_environment_variable(path):
    """Where the reference reads an environment variable, the port takes
    an explicit argument with the reference's default."""
    assert list(environment_reads(path)) == [], path


def test_no_module_names_a_deferred_item():
    """Queue 1 item 8 is ported: no module raises naming it."""
    for path in PORT_FILES:
        text = path.read_text()
        assert "NotImplementedError" not in text or \
            "item 8" not in text, path


def compressed_option_round(option):
    """One round of the compressed model with a chaos option on, port
    against reference, from the reference's draws."""
    import jax
    from sidecar_tpu.ops import topology as jtopo

    key = jax.random.PRNGKey(4)
    topo = jtopo.ring(16)
    jkw, tkw = chaos_option_kwargs(option, topo, 200, key, 16)
    params = dict(n=16, services_per_node=2, cache_lines=8, budget=4)
    time = dict(push_pull_interval_s=0.2)
    jsim, _ = port_pair(params, topo, time, **jkw)
    _, tsim = port_pair(params, topo, time, **tkw)
    js = jsim.mint(jsim.init_state(), np.array([3, 17], np.int32), 10)
    jf, jb = jsim.run_behind(js, key, 1, every=1, donate=False)
    tf, tb = tsim.run_behind(port_state(js), 1, 1,
                             draws=jax_draw_seq(jsim, key, 0, 1))
    assert_states_equal(jf, tf, option)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    return tsim, tf


def small_sim(**kw):
    p = CompressedParams(n=16, services_per_node=2, cache_lines=8,
                         budget=4)
    return CompressedSim(p, topology.complete(16), TimeConfig(), **kw)


def small_exact(**kw):
    p = SimParams(n=16, services_per_node=2, budget=4)
    return ExactSim(p, topology.ring(16), TimeConfig(), **kw)


def small_chaos(**kw):
    from sidecar_tpu_torch.chaos import ChaosExactSim, EdgeFault, FaultPlan

    p = SimParams(n=16, services_per_node=2, budget=4)
    plan = FaultPlan(seed=1, edges=(EdgeFault(drop_prob=0.5),))
    return ChaosExactSim(p, topology.ring(16), TimeConfig(), plan, **kw)


def small_fleet(**kw):
    from sidecar_tpu_torch.fleet import FleetSim, ScenarioBatch, ScenarioSpec

    p = SimParams(n=16, services_per_node=2, budget=4)
    batch = ScenarioBatch.build(
        [ScenarioSpec(name="a", seed=1), ScenarioSpec(name="b", seed=2)],
        p, TimeConfig(), **kw)
    return FleetSim(batch)


def small_evaluator(**kw):
    from sidecar_tpu_torch.autopilot import FleetEvaluator, Objective

    p = SimParams(n=16, services_per_node=2, budget=4)
    return FleetEvaluator(p, TimeConfig(), Objective(["converge <= 10 "
                                                      "rounds"]), **kw)


def small_scenario(**kw):
    from sidecar_tpu_torch.sim import scenarios

    return scenarios.config6_sim(n=32, **kw)


def small_bridge(**kw):
    from sidecar_tpu_torch.bridge import SimBridge
    from sidecar_tpu_torch.catalog import ServicesState

    return SimBridge(ServicesState(hostname="h0"), TimeConfig(), **kw)


def small_fault_plan(**kw):
    from sidecar_tpu_torch.chaos import CompiledFaultPlan, EdgeFault, FaultPlan

    plan = FaultPlan(seed=1, edges=(EdgeFault(drop_prob=0.5),))
    return CompiledFaultPlan(plan, 16, **kw)


def small_adversary(**kw):
    from sidecar_tpu_torch.chaos import (
        AdversaryPlan,
        Attack,
        CompiledAdversaryPlan,
    )

    plan = AdversaryPlan(seed=1, attacks=(
        Attack(kind="tombstone_bomb", nodes=(1,), victims=(3,)),))
    return CompiledAdversaryPlan(plan, n=16, owner=np.arange(32) // 2,
                                 budget=4, **kw)


@pytest.mark.parametrize(
    "make",
    [small_sim, small_exact, small_chaos, small_fault_plan, small_adversary,
     small_fleet, small_evaluator, small_scenario, small_bridge],
    ids=["compressed", "exact", "chaos", "fault_plan", "adversary",
         "fleet", "evaluator", "scenario", "bridge"])
def test_default_device_needs_a_gpu(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device.type == "cpu"


def one_round(sim, state, **kw):
    """One round on the CPU through ``run_fast``; returns the state."""
    st = sim.run_fast(state, 1, generator=torch.Generator().manual_seed(0),
                      **kw)
    assert st.round_idx == 1
    return st


def run_mode_option(sim, option, state):
    """The item-6 options run a round: ``sparse`` a sparse dispatch
    (stats for one round), ``pipeline="1"`` a pipelined one by default,
    the cadence a gated lockstep round."""
    if option == "sparse":
        one_round(sim, state, sparse=True)
        assert int(sim.last_sparse_stats[:2].sum()) == 1
    else:
        one_round(sim, state)
        assert sim.last_sparse_stats is None
    if option == "pipeline":
        assert sim._pipeline_mode == "1"
    if option.startswith("tick_"):
        assert sim._knobs.cadence_enabled


@pytest.mark.parametrize("option,value", [
    ("perturb", None),
    ("cut_mask", None),
    ("node_side", None),
    ("sparse", "auto"),
    ("pipeline", "1"),
    ("tick_period", 2),
])
def test_deferred_options_raise(option, value):
    """Every option once deferred runs a round: the chaos options
    (Queue 1 item 8) one equal to the reference's, the execution modes'
    (item 6) as :func:`run_mode_option` checks."""
    if option in CHAOS_OPTIONS:
        sim, _ = compressed_option_round(option)
        assert getattr(sim, {"perturb": "perturb", "cut_mask": "_cut",
                             "node_side": "_side"}[option]) is not None
        return
    sim = small_sim(device="cpu", **{option: value})
    run_mode_option(sim, option, sim.mint(sim.init_state(), [3, 17], 10))


@pytest.mark.parametrize("option,value,item", [
    ("perturb", None, "item 8"),
    ("cut_mask", None, "item 8"),
    ("sparse", "auto", "item 6"),
    ("pipeline", "1", "item 6"),
    ("tick_period", 2, "item 6"),
    ("tick_phase", 1, "item 6"),
])
def test_exact_deferred_options_raise(option, value, item):
    """As :func:`test_deferred_options_raise`, on the exact model: the
    chaos options run a round equal to the reference's; a phase alone
    (period 1) is accepted and gates nothing."""
    if item == "item 8":
        import jax
        from sidecar_tpu.ops import topology as jtopo

        key = jax.random.PRNGKey(4)
        topo = jtopo.ring(16)
        jkw, tkw = chaos_option_kwargs(option, topo, 200, key, 16)
        params = dict(n=16, services_per_node=2, budget=4)
        time = dict(push_pull_interval_s=0.2)
        jsim, _ = exact_port_pair(params, topo, time, **jkw)
        _, tsim = exact_port_pair(params, topo, time, **tkw)
        js = jsim.init_state(0.8, seed=1)
        jf, jc = jsim.run(js, key, 1, donate=False)
        tf, tc = tsim.run(exact_port_state(js), 1,
                          draws=jax_exact_draw_seq(jsim, key, 0, 1))
        assert_exact_states_equal(jf, tf, option)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        return
    sim = small_exact(device="cpu", **{option: value})
    if option == "tick_phase":
        assert not sim._knobs.cadence_enabled
        one_round(sim, sim.init_state())
        return
    run_mode_option(sim, option, sim.init_state())


def staggered_ring():
    """A ring whose every node is off on odd rounds (period 2, phase
    0): round 1 gossips nothing."""
    return dataclasses.replace(topology.ring(16),
                               stagger=np.zeros(16, np.int32),
                               stagger_period=2)


def test_exact_staggered_topology_raises():
    """A staggered topology, deferred until item 6, now runs: round 1
    is off for every node, so only the owners know their records."""
    p = SimParams(n=16, services_per_node=2)
    sim = ExactSim(p, staggered_ring(), TimeConfig(), device="cpu")
    st = one_round(sim, sim.init_state())
    assert torch.equal(st.known, sim.init_state().known)
    plain = ExactSim(p, topology.ring(16), TimeConfig(), device="cpu")
    assert not torch.equal(one_round(plain, plain.init_state()).known,
                           st.known)


def test_staggered_topology_raises():
    """As :func:`test_exact_staggered_topology_raises`, on the
    compressed model: no pull lands in round 1."""
    p = CompressedParams(n=16, services_per_node=2, cache_lines=8,
                         budget=4)
    sim = CompressedSim(p, staggered_ring(), TimeConfig(), device="cpu")
    minted = sim.mint(sim.init_state(), [3, 17, 30], 10)
    st = one_round(sim, minted)
    held = (st.cache_slot >= 0).sum()
    plain = CompressedSim(p, topology.ring(16), TimeConfig(), device="cpu")
    assert (one_round(plain, minted).cache_slot >= 0).sum() > held


def test_convert_round_trip():
    sim = small_sim(device="cpu")
    st = sim.mint(sim.init_state(), [3, 17, 30], 10)
    st = sim.run_fast(st, 3, generator=torch.Generator().manual_seed(0))
    arrays = convert.state_to_numpy(st)
    assert arrays["cache_sent"].dtype == np.int8
    assert arrays["round_idx"].dtype == np.int32
    back = convert.state_from_numpy(arrays, "cpu")
    for name, value in convert.state_to_numpy(back).items():
        np.testing.assert_array_equal(value, arrays[name], err_msg=name)
    with pytest.raises(ValueError, match="missing"):
        convert.state_from_numpy({"own": arrays["own"]}, "cpu")


def test_convert_round_trip_exact():
    sim = small_exact(device="cpu")
    st = sim.run_fast(sim.init_state(0.8, seed=3), 4,
                      generator=torch.Generator().manual_seed(0))
    arrays = convert.state_to_numpy(st)
    assert arrays["sent"].dtype == np.int8
    assert arrays["round_idx"].dtype == np.int32
    back = convert.exact_state_from_numpy(arrays, "cpu")
    assert back.round_idx == 4
    for name, value in convert.state_to_numpy(back).items():
        np.testing.assert_array_equal(value, arrays[name], err_msg=name)
    with pytest.raises(ValueError, match="missing"):
        convert.exact_state_from_numpy({"known": arrays["known"]}, "cpu")
    p = SimParams(n=40, drop_prob=0.25, retransmit_limit=9)
    assert convert.exact_params_from_jax_fields(
        dict(dataclasses.asdict(p), sparse_cap=0)) == p
    # sparse_cap converts through and caps the sparse round's frontier.
    q = convert.exact_params_from_jax_fields(
        dict(dataclasses.asdict(p), sparse_cap=8))
    assert q.sparse_cap == 8
    sim = ExactSim(q, topology.ring(40), TimeConfig(), device="cpu")
    assert sim._sparse_cap == 8
    one_round(sim, sim.init_state(), sparse=True)
    assert int(sim.last_sparse_stats[1]) == 1     # 40 senders overflow


def test_convert_params_timecfg_topology():
    p = CompressedParams(n=40, drop_prob=0.25, fold_quorum=1.0)
    assert convert.params_from_jax_fields(
        dict(dataclasses.asdict(p), sparse_cap=0)) == p
    q = convert.params_from_jax_fields(
        dict(dataclasses.asdict(p), sparse_cap=8))
    assert q.sparse_cap == 8
    sim = CompressedSim(q, topology.ring(40), TimeConfig(), device="cpu")
    assert sim._sparse_caps == (8, 24, 8)
    one_round(sim, sim.mint(sim.init_state(), [5, 77], 10), sparse=True)
    assert int(sim.last_sparse_stats[:2].sum()) == 1
    t = TimeConfig(push_pull_interval_s=4.0, origin_budget=3)
    assert convert.timecfg_from_fields(dataclasses.asdict(t)) == t
    er = topology.erdos_renyi(40, 4.0, seed=1)
    again = convert.topology_from_numpy(40, er.nbrs, er.deg, er.name)
    np.testing.assert_array_equal(again.nbrs, er.nbrs)
    assert convert.topology_from_numpy(40).nbrs is None
