"""The port's scenario configs (``sidecar_tpu_torch/sim/scenarios.py``),
checkpoints (``sim/checkpoint.py``) and topology families against the
JAX reference.

* Every overlay family builds the reference's graph through
  ``from_name``, and ``components``/``repair`` agree.
* Configs 1–6 at small scale build the reference's params, graph,
  clock, plan, cut, sides and burst (both packages' ``_run`` and
  ``_run_chunked`` are intercepted before a round runs).
* config6 (n = 32, 40 rounds), config4 (128 nodes, 20 rounds) and
  config1 (one node, 10 rounds) run in lockstep with the reference's
  runs from its draws, churn masks and fault draws: the same curve and
  final state.
* A chunked run equals a straight one; ``run_all`` returns the six
  summaries with the reference's keys.
* Checkpoints: the round trip on both models, a reference file into the
  port and a port file into the reference, a resume with the generator
  equal to a straight run, and the reference's refusals.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.models import compressed as jcompressed
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.sim import checkpoint as jckpt
from sidecar_tpu.sim import scenarios as jscenarios
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models.compressed import (
    CompressedParams,
    CompressedSim,
    hash_line,
)
from sidecar_tpu_torch.models.exact import ExactSim, SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import topology as ttopo
from sidecar_tpu_torch.sim import checkpoint as tckpt
from sidecar_tpu_torch.sim import scenarios as tscenarios
from tests.test_torch_exact import CONV_TOL
from tests.torch_parity import (
    assert_chaos_states_equal,
    assert_exact_states_equal,
    assert_port_states_equal,
    assert_states_equal,
    jax_draw_seq,
    jax_exact_draw_seq,
    jax_fault_draw_seq,
    jax_perturb_masks,
)

FAST = dict(refresh_interval_s=1000.0, push_pull_interval_s=2.0)


# -- the topology families -------------------------------------------------------

FAMILIES = ["complete", "chord", "ring1", "ring3", "expander4", "expander6",
            "er2", "er3.5", "ba1", "ba3", "zoned4", "zoned8", "mesh6x8"]


@pytest.mark.parametrize("name", FAMILIES)
def test_from_name_builds_reference_graph(name):
    for seed in (0, 5):
        t, j = ttopo.from_name(name, 48, seed=seed), \
            jtopo.from_name(name, 48, seed=seed)
        assert (t.n, t.name, t.nbrs is None) == (j.n, j.name, j.nbrs is None)
        if j.nbrs is not None:
            np.testing.assert_array_equal(t.nbrs, j.nbrs)
            np.testing.assert_array_equal(t.deg, j.deg)
            assert (t.nbrs.dtype, t.deg.dtype) == (j.nbrs.dtype, j.deg.dtype)
        np.testing.assert_array_equal(ttopo.components(t),
                                      jtopo.components(j))


@pytest.mark.parametrize("build", [
    lambda m: m.erdos_renyi(60, 1.0, seed=2),
    lambda m: m.erdos_renyi(40, 0.5, seed=7),
    lambda m: m.ring(12),
    lambda m: m.complete(5)])
def test_components_and_repair_equal_reference(build):
    t, j = build(ttopo), build(jtopo)
    np.testing.assert_array_equal(ttopo.components(t), jtopo.components(j))
    rt, rj = ttopo.repair(t), jtopo.repair(j)
    assert rt.name == rj.name
    if rj.nbrs is not None:
        np.testing.assert_array_equal(rt.nbrs, rj.nbrs)
        np.testing.assert_array_equal(rt.deg, rj.deg)
        assert len(set(ttopo.components(rt).tolist())) == 1


def test_from_name_errors_and_names_equal_reference():
    assert ttopo.topology_names() == jtopo.topology_names()
    for name, n in (("torus", 16), ("zoned5", 32), ("expander3", 32),
                    ("mesh5x8", 41), ("zoned16", 16)):
        with pytest.raises(ValueError) as got:
            ttopo.from_name(name, n)
        with pytest.raises(ValueError) as want:
            jtopo.from_name(name, n)
        assert str(got.value) == str(want.value)


# -- the configs build what the reference builds -----------------------------------

class Captured(Exception):
    """Raised by the intercepted ``_run`` once the scenario is built."""


def capture(module, monkeypatch, name, **kw):
    """Build scenario ``name`` of ``module`` and return what reached its
    ``_run``/``_run_chunked``: ``[(sim, state), ...]`` (config5: the
    split and the heal sims)."""
    seen = []

    def fake_run(sim, state, *a, **k):
        seen.append((sim, state))
        raise Captured

    def fake_chunked(sim, state, *a, **k):
        seen.append((sim, state))
        return state, np.zeros((0,), np.float32)

    monkeypatch.setattr(module, "_run", fake_run)
    monkeypatch.setattr(module, "_run_chunked", fake_chunked)
    try:
        module.ALL_SCENARIOS[name](**kw)
    except Captured:
        pass
    monkeypatch.undo()
    return seen


def graph_of(sim):
    return sim.topo.n, sim.topo.nbrs, sim.topo.deg


def assert_sim_built_as_reference(tsim, jsim):
    assert dataclasses.asdict(tsim.p) == dataclasses.asdict(jsim.p)
    assert dataclasses.asdict(tsim.t) == dataclasses.asdict(jsim.t)
    tn, tnb, tdeg = graph_of(tsim)
    jn, jnb, jdeg = graph_of(jsim)
    assert tn == jn and (tnb is None) == (jnb is None)
    if jnb is not None:
        np.testing.assert_array_equal(tnb, np.asarray(jnb))
        np.testing.assert_array_equal(tdeg, np.asarray(jdeg))
    for port_attr, ref_attr in (("_cut", "_cut"), ("_side", "_side")):
        want = getattr(jsim, ref_attr, None)
        got = getattr(tsim, port_attr, None)
        assert (got is None) == (want is None), port_attr
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if hasattr(jsim, "plan"):
        assert tsim.plan.dumps() == jsim.plan.dumps()


SMALL = {"config1": {}, "config2": {}, "config3": dict(scale=0.02),
         "config4": dict(scale=0.002), "config5": dict(scale=0.0001),
         "config6": dict(scale=0.125)}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_config_builds_reference_scenario(name, monkeypatch):
    t = capture(tscenarios, monkeypatch, name, device="cpu", **SMALL[name])
    j = capture(jscenarios, monkeypatch, name, **SMALL[name])
    assert len(t) == len(j) >= 1
    for (tsim, tst), (jsim, jst) in zip(t, j):
        assert_sim_built_as_reference(tsim, jsim)
        if isinstance(tsim, CompressedSim):
            # The minted burst: the same slots at the same tick.
            assert_states_equal(jst, tst, name)
        else:
            st = tst.sim if hasattr(tst, "sim") else tst
            js = jst.sim if hasattr(jst, "sim") else jst
            assert_exact_states_equal(js, st, name)


def test_config_sizes_and_results_match_reference():
    """``run_all`` on the CPU returns the six results, their summaries
    with the reference's keys; the scaled sizes round as the
    reference's do."""
    results = tscenarios.run_all(scale=0.0001, device="cpu")
    names = [r.name for r in results]
    assert names == ["config1-static", "config2-ring32",
                     "config3-er4096-churn", "config4-ba-antientropy",
                     "config5-split-heal", "config6-chaos-partition"]
    want_keys = jscenarios.ScenarioResult(
        name="x", n=1, services_per_node=1, rounds_run=1,
        convergence=np.ones(1), eps_round=1, eps_seconds_simulated=0.2,
        wall_seconds=1.0, rounds_per_sec=1.0).summary().keys()
    for r in results:
        assert r.summary().keys() == want_keys
        assert 0.0 <= r.summary()["final_convergence"] <= 1.0
    by = {r.name: r for r in results}
    assert by["config1-static"].convergence[-1] == 1.0
    assert by["config1-static"].eps_round == 1
    assert by["config2-ring32"].convergence[-1] == 1.0
    assert (by["config3-er4096-churn"].n, by["config4-ba-antientropy"].n,
            by["config5-split-heal"].n, by["config6-chaos-partition"].n) \
        == (64, 128, 100, 32)
    c5 = by["config5-split-heal"]
    assert c5.convergence[:150].max() < 1.0 and c5.eps_round > 150
    assert tscenarios._chunk_rounds(4096, 1) == \
        jscenarios._chunk_rounds(4096, 1) == 400
    assert tscenarios._chunk_rounds(1_000_000, 5) == \
        jscenarios._chunk_rounds(1_000_000, 5) == 50
    conv = np.array([0.5, 0.99, 0.995, 1.0], np.float32)
    for eps, every in ((0.01, 1), (0.0, 5), (0.001, 1)):
        assert tscenarios._eps_round(conv, eps, every) == \
            jscenarios._eps_round(conv, eps, every)


# -- lockstep with the reference's runs ------------------------------------------

def test_config6_lockstep_with_reference(monkeypatch):
    """config6 at n = 32, 40 rounds: the port's sim from the module, fed
    the reference's draws, churn masks and fault draws, ends in the
    reference's state with its curve."""
    rounds, seed = 40, 6
    ((tsim, tst),) = capture(tscenarios, monkeypatch, "config6",
                             scale=0.125, device="cpu")
    ((jsim, jst),) = capture(jscenarios, monkeypatch, "config6",
                             scale=0.125)
    key = jax.random.PRNGKey(seed)
    p = tsim.p
    masks = jax_perturb_masks(key, 0, rounds, (p.m,), 0.02 / 4)
    tsim.perturb = tscenarios.side_churn(p, 0.02 / 4, masks=masks)
    jfinal, jconv = jsim.run(jst, key, rounds)
    tfinal, tconv = tsim.run(
        tst, rounds, draws=jax_exact_draw_seq(jsim, key, 0, rounds),
        fault_draws=jax_fault_draw_seq(jsim, 0, rounds))
    assert_chaos_states_equal(jfinal, tfinal, "config6")
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv),
                               atol=CONV_TOL)
    assert int(tfinal.injected_drops) > 0
    churned = [r for r in range(31, 41) if masks[r].any()]
    assert churned


def test_config4_lockstep_with_reference(monkeypatch):
    """config4 at 128 nodes (BA(3), K = 256, the 0.2 % burst), 20
    rounds from the reference's draws: the same state and curve."""
    rounds = 20
    scale = 128 / 65_536
    ((tsim, tst),) = capture(tscenarios, monkeypatch, "config4",
                             scale=scale, device="cpu")
    ((jsim, jst),) = capture(jscenarios, monkeypatch, "config4",
                             scale=scale)
    key = jax.random.PRNGKey(4)
    jfinal, jconv = jsim.run(jst, key, rounds)
    tfinal, tconv = tsim.run(tst, rounds,
                             draws=jax_draw_seq(jsim, key, 0, rounds))
    assert_states_equal(jfinal, tfinal, "config4")
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv),
                               atol=CONV_TOL)
    assert float(tconv[0]) < 1.0


def test_config1_lockstep_with_reference(monkeypatch):
    """config1's single node, 10 rounds from the reference's draws: the
    port's self-send (its one peer slot names itself) ends where the
    reference's dropped deliveries (its shift names node 1) end — the
    same ``known``, ``sent`` and liveness, and the same curve."""
    rounds = 10
    ((tsim, tst),) = capture(tscenarios, monkeypatch, "config1",
                             device="cpu")
    ((jsim, jst),) = capture(jscenarios, monkeypatch, "config1")
    key = jax.random.PRNGKey(1)
    jfinal, jconv = jsim.run(jst, key, rounds)
    tfinal, tconv = tsim.run(
        tst, rounds, draws=jax_exact_draw_seq(jsim, key, 0, rounds))
    assert_exact_states_equal(jfinal, tfinal, "config1")
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv),
                               atol=CONV_TOL)
    assert int(tfinal.sent.sum()) > 0      # the node did send


@pytest.mark.parametrize("name,kw", [("config3", dict(scale=0.02)),
                                     ("config4", dict(scale=0.002)),
                                     ("config6", dict(scale=0.125))])
def test_chunked_run_equals_straight(name, kw, monkeypatch):
    """One generator through several chunks gives the straight run's
    state and curve (the churn masks are keyed by round)."""
    rounds, every = 24, 1
    runs = []
    for chunk in (rounds, 5):
        ((sim, st),) = capture(tscenarios, monkeypatch, name, device="cpu",
                               **kw)
        monkeypatch.setattr(tscenarios, "MAX_CHUNK_ROUNDS", chunk)
        assert tscenarios._chunk_rounds(sim.p.n, every) == chunk
        gen = sim.default_generator(3)
        runs.append(tscenarios._run_chunked(sim, st, gen, rounds, every))
        monkeypatch.undo()
    (a, ca), (b, cb) = runs
    np.testing.assert_array_equal(ca, cb)
    assert_port_states_equal(a.sim if hasattr(a, "sim") else a,
                             b.sim if hasattr(b, "sim") else b, name)


# -- checkpoints -----------------------------------------------------------------

def exact_sim(device="cpu"):
    return ExactSim(SimParams(n=8, services_per_node=3, fanout=2, budget=6),
                    ttopo.ring(8), TimeConfig(**FAST), device=device)


def compressed_sim(n=32, k=64):
    return CompressedSim(CompressedParams(n=n, services_per_node=4,
                                          cache_lines=k),
                         ttopo.complete(n), TimeConfig(**FAST), device="cpu")


def compressed_start(sim):
    return sim.mint(sim.init_state(), torch.arange(8) * 3, 10)


@pytest.mark.parametrize("model", ["exact", "compressed"])
def test_round_trip_and_resume_with_generator(model, tmp_path):
    """Save at round 10 with the generator, load, 10 more rounds: the
    straight 20-round run, every field."""
    sim = exact_sim() if model == "exact" else compressed_sim()

    def start():
        return sim.init_state() if model == "exact" else \
            compressed_start(sim)

    straight = sim.run_fast(start(), 20,
                            generator=sim.default_generator(7))
    gen = sim.default_generator(7)
    half = sim.run_fast(start(), 10, generator=gen)
    tckpt.save_state(tmp_path / "mid.npz", half, sim.p, generator=gen)
    gen2 = torch.Generator()
    loaded, params = tckpt.load_state(tmp_path / "mid.npz", device="cpu",
                                      generator=gen2)
    assert params == sim.p and loaded.round_idx == 10
    assert_port_states_equal(loaded, half, model)
    # The generator comes back at round 10's position of the stream.
    assert torch.equal(gen2.get_state(), gen.get_state())
    resumed = sim.run_fast(loaded, 10, generator=gen2)
    assert_port_states_equal(resumed, straight, model)
    # A file saved without a generator leaves a given one alone.
    tckpt.save_state(tmp_path / "bare.npz", half, sim.p)
    fresh = torch.Generator().manual_seed(3)
    before = fresh.get_state()
    tckpt.load_state(tmp_path / "bare.npz", device="cpu", generator=fresh)
    assert torch.equal(fresh.get_state(), before)


@pytest.mark.parametrize("model", ["exact", "compressed"])
def test_files_cross_between_packages(model, tmp_path):
    """A reference file loads into the port and a port file loads into
    the reference, with equal states and params."""
    if model == "exact":
        sim = exact_sim()
        state = sim.run_fast(sim.init_state(), 6,
                             generator=sim.default_generator(2))
        jparams = jexact.SimParams(**dataclasses.asdict(sim.p))
        jstate = jexact.SimState(**{
            k: jnp.asarray(v) for k, v in
            convert.state_to_numpy(state).items()})
    else:
        sim = compressed_sim()
        state = sim.run_fast(compressed_start(sim), 6,
                             generator=sim.default_generator(2))
        jparams = jcompressed.CompressedParams(**dataclasses.asdict(sim.p))
        jstate = jcompressed.CompressedState(**{
            k: jnp.asarray(v) for k, v in
            convert.state_to_numpy(state).items()})
    jckpt.save_state(tmp_path / "ref.npz", jstate, jparams)
    got, params = tckpt.load_state(tmp_path / "ref.npz", device="cpu")
    assert params == sim.p
    assert_port_states_equal(got, state, "reference file")
    tckpt.save_state(tmp_path / "port.npz", state, sim.p,
                     generator=sim.default_generator(1))
    back, jp = jckpt.load_state(tmp_path / "port.npz")
    assert dataclasses.asdict(jp) == dataclasses.asdict(sim.p)
    for f, v in convert.state_to_numpy(state).items():
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), v,
                                      err_msg=f)


def refusal(loader, path):
    with pytest.raises(ValueError) as exc:
        loader(path)
    return str(exc.value)


def test_refusals_equal_reference(tmp_path):
    """Shape mismatch, the version-1 file, a future version, a missing
    field, the params class and a stale cache layout: the reference's
    outcome and text."""
    sim = exact_sim()
    state = sim.run_fast(sim.init_state(), 4,
                         generator=sim.default_generator(2))
    bad = dataclasses.replace(state, known=state.known[:, :4].contiguous(),
                              sent=state.sent[:, :4].contiguous())
    tckpt.save_state(tmp_path / "bad.npz", bad, sim.p)
    msg = refusal(lambda p: tckpt.load_state(p, device="cpu"),
                  tmp_path / "bad.npz")
    assert "shape" in msg and msg == refusal(jckpt.load_state,
                                             tmp_path / "bad.npz")

    arrays = convert.state_to_numpy(state)
    np.savez_compressed(tmp_path / "v1.npz", version=1,
                        params=json.dumps(dataclasses.asdict(sim.p)),
                        **arrays)
    loaded, params = tckpt.load_state(tmp_path / "v1.npz", device="cpu")
    assert params == sim.p and loaded.round_idx == 4
    assert_port_states_equal(loaded, state, "v1")
    for name, extra in (("v3.npz", dict(version=3, kind="exact")),
                        ("kind.npz", dict(version=2, kind="dense"))):
        np.savez_compressed(tmp_path / name, params=json.dumps(
            dataclasses.asdict(sim.p)), **extra, **arrays)
        assert refusal(lambda p: tckpt.load_state(p, device="cpu"),
                       tmp_path / name) == \
            refusal(jckpt.load_state, tmp_path / name)
    partial = {k: v for k, v in arrays.items() if k != "round_idx"}
    np.savez_compressed(tmp_path / "partial.npz", version=2, kind="exact",
                        params=json.dumps(dataclasses.asdict(sim.p)),
                        **partial)
    assert refusal(lambda p: tckpt.load_state(p, device="cpu"),
                   tmp_path / "partial.npz") == \
        refusal(jckpt.load_state, tmp_path / "partial.npz")

    with pytest.raises(TypeError, match="must be saved with"):
        tckpt.save_state(tmp_path / "x.npz", sim.init_state(),
                         CompressedParams(n=8))

    csim = compressed_sim(16, 64)
    st = csim.run_fast(csim.mint(csim.init_state(), torch.arange(4) * 5, 10),
                       4, generator=csim.default_generator(3))
    occupied = torch.nonzero(st.cache_slot >= 0)
    assert len(occupied), "workload produced no cache entries"
    node, line = (int(v) for v in occupied[0])
    slot = int(st.cache_slot[node, line])
    wrong = (int(hash_line(torch.tensor(slot), 64, 4)) + 1) % 64
    cs, cv = st.cache_slot.clone(), st.cache_val.clone()
    cs[node, wrong], cv[node, wrong] = slot, cv[node, line]
    cs[node, line], cv[node, line] = -1, 0
    stale = dataclasses.replace(st, cache_slot=cs, cache_val=cv)
    tckpt.save_state(tmp_path / "stale.npz", stale, csim.p)
    msg = refusal(lambda p: tckpt.load_state(p, device="cpu"),
                  tmp_path / "stale.npz")
    assert "cache layout mismatch" in msg
    assert msg == refusal(jckpt.load_state, tmp_path / "stale.npz")
    assert tckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION
