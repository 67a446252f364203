"""The port's node-sharded exact twin (``ShardedSim``) against the JAX
reference, exactly.

* Every ``board_exchange`` mode at d ∈ {2, 4, 8} against the
  reference's ``ShardedSim`` on the 8-device CPU mesh of
  ``tests/conftest.py``: random peers, packet loss, the stride push-pull
  every 5 rounds and the sweep every 2.  The reference draws per shard;
  ``torch_parity.jax_sharded_exact_draws`` rebuilds those streams into
  the port's single ``RoundDraws``.
* Every mode at d ∈ {1, 2, 4, 8} against the reference's single-device
  ``ExactSim`` with push-pull past the horizon (the two differ only in
  the anti-entropy pairing), fed ``jax_exact_draw_seq``'s draws.
* The sparse round with a cap that one shard overflows and the other
  does not, the pipelined round by delegation, the trace, digest and
  provenance streams, the digest-gated zoned exchange, the exchange
  byte gauges and the constructor's refusals.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu import metrics as jmetrics
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.parallel.mesh import make_mesh
from sidecar_tpu.parallel.sharded import ShardedSim as JShardedSim
from sidecar_tpu_torch import metrics as tmetrics
from sidecar_tpu_torch.models.exact import SimParams
from sidecar_tpu_torch.ops import topology as ttopo
from sidecar_tpu_torch.ops.gossip import eligible_records
from sidecar_tpu_torch.parallel import ShardedSim
from tests.torch_parity import (
    chaos_option_kwargs,
    assert_exact_states_equal,
    assert_port_states_equal,
    assert_stream_equal,
    exact_port_state,
    exact_to_numpy,
    jax_exact_draw_seq,
    jax_sharded_exact_draws,
    sharded_exact_port,
)

# Refreshes every 10 rounds, the stride push-pull every 5, the sweep
# every 2.
TIME = dict(refresh_interval_s=2.0, push_pull_interval_s=1.0,
            sweep_interval_s=0.4)
# Push-pull past the horizon: the sharded twin then equals ExactSim.
NO_PP = dict(TIME, push_pull_interval_s=1e6)
PARAMS = dict(n=32, services_per_node=4, fanout=2, budget=6, drop_prob=0.1)
ROUNDS = 20
KEY = jax.random.PRNGKey(3)
MODES = ("all_gather", "ring", "zoned")


def graph(mode, n=32):
    """The complete graph, or for ``zoned`` its acceptance overlay
    (local lattice, remote links and a gateway ring)."""
    if mode == "zoned":
        return jtopo.zoned(n, 4, local_hops=1, remote_deg=2, gateways=1)
    return jtopo.complete(n)


def jax_sharded(d, mode, params=PARAMS, time=TIME, topo=None, **kw):
    return JShardedSim(jexact.SimParams(**params),
                       graph(mode, params["n"]) if topo is None else topo,
                       JTimeConfig(**time), mesh=make_mesh(jax.devices()[:d]),
                       board_exchange=mode, **kw)


def port_from(jsim, d, mode, **kw):
    return sharded_exact_port(jsim, d=d, board_exchange=mode, **kw)


# -- (i) against the reference's sharded twin ---------------------------------


@functools.lru_cache(maxsize=None)
def reference_sharded_run(mode, d):
    jsim = jax_sharded(d, mode)
    final, conv = jsim.run(jsim.init_state(), KEY, ROUNDS)
    return jsim, final, np.asarray(conv), \
        jax_sharded_exact_draws(jsim, KEY, 0, ROUNDS)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_equals_reference_sharded_twin(mode, d):
    jsim, want, conv, draws = reference_sharded_run(mode, d)
    tsim = port_from(jsim, d, mode)
    got, got_conv = tsim.run(tsim.init_state(), ROUNDS, draws=draws)
    assert_exact_states_equal(want, got, f"{mode}/d={d}")
    np.testing.assert_array_equal(got_conv.numpy(), conv)
    # Premise: loss fired, push-pull ran, the run had not converged.
    assert any((~dr.keep).any() for dr in draws)
    assert ROUNDS // tsim._knobs.push_pull_rounds >= 2
    assert 0.0 < conv[-1] < 1.0


def test_exchange_stub_is_wrong_the_reference_way():
    """``exchange_stub`` (measurement only: own-shard offers alone) ends
    where the reference's does, and not where the full round does."""
    jsim = jax_sharded(2, "all_gather", exchange_stub=True)
    want, conv = jsim.run(jsim.init_state(), KEY, ROUNDS)
    draws = jax_sharded_exact_draws(jsim, KEY, 0, ROUNDS)
    tsim = port_from(jsim, 2, "all_gather", exchange_stub=True)
    got, got_conv = tsim.run(tsim.init_state(), ROUNDS, draws=draws)
    assert_exact_states_equal(want, got, "stub")
    np.testing.assert_array_equal(got_conv.numpy(), np.asarray(conv))
    full, _ = reference_sharded_run("all_gather", 2)[1:3]
    assert not np.array_equal(exact_to_numpy(full)["known"],
                              exact_to_numpy(want)["known"])


# -- (ii) against the single-device ExactSim, push-pull past the horizon -----


@functools.lru_cache(maxsize=None)
def reference_exact_run(mode):
    jsim = jexact.ExactSim(jexact.SimParams(**PARAMS), graph(mode),
                           JTimeConfig(**NO_PP))
    final, conv = jsim.run(jsim.init_state(), KEY, ROUNDS)
    return jsim, final, np.asarray(conv), \
        jax_exact_draw_seq(jsim, KEY, 0, ROUNDS)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_equals_single_device_exact(mode, d):
    jsim, want, conv, draws = reference_exact_run(mode)
    tsim = port_from(jsim, d, mode)
    got, got_conv = tsim.run(tsim.init_state(), ROUNDS, draws=draws)
    assert_exact_states_equal(want, got, f"{mode}/d={d}")
    np.testing.assert_array_equal(got_conv.numpy(), conv)


# -- (iii) the sparse round --------------------------------------------------

# One transmission a record and no refresh: the frontier drains between
# push-pulls, which reset the transmit counts of the rows they move.
SPARSE_PARAMS = dict(n=64, services_per_node=2, fanout=2, budget=4,
                     drop_prob=0.1, sparse_cap=16, retransmit_limit=2)
SPARSE_TIME = dict(TIME, refresh_interval_s=1000.0)


def half_down(jsim):
    """The reference's cold start with the second shard's nodes down and
    empty: shard 0 starts with 32 senders (over its cap of 16), shard 1
    has none."""
    st = jsim.init_state()
    known = np.asarray(st.known).copy()
    known[32:] = 0
    alive = np.arange(64) < 32
    return dataclasses.replace(st, known=jnp.asarray(known),
                               node_alive=jnp.asarray(alive))


@functools.lru_cache(maxsize=None)
def reference_sparse_run():
    jsim = jax_sharded(2, "ring", SPARSE_PARAMS, SPARSE_TIME, sparse="1")
    st = half_down(jsim)
    final, conv = jsim.run(st, KEY, ROUNDS, donate=False)
    return (jsim, st, final, np.asarray(conv),
            np.asarray(jsim.last_sparse_stats),
            jax_sharded_exact_draws(jsim, KEY, 0, ROUNDS))


def test_sparse_round_equals_reference():
    jsim, start, want, conv, stats, draws = reference_sparse_run()
    tsim = port_from(jsim, 2, "ring", sparse="1")
    assert tsim._sparse_cap_shard == 16
    got, got_conv = tsim.run(exact_port_state(start), ROUNDS, draws=draws)
    assert_exact_states_equal(want, got, "sparse")
    np.testing.assert_array_equal(got_conv.numpy(), conv)
    np.testing.assert_array_equal(tsim.last_sparse_stats.numpy(), stats)
    # Premise: rounds where one shard overflowed and the other ran
    # compacted, and rounds with no overflow at all.
    st, mixed = exact_port_state(start), 0
    for dr in draws:
        sizes = [int(eligible_records(st.known[rows], st.sent[rows],
                                      tsim._knobs.limit).any(1).sum())
                 for rows in (slice(0, 32), slice(32, 64))]
        mixed += (max(sizes) > 16) and (min(sizes) <= 16)
        st, _ = tsim.step_sparse(st, draws=dr)
    assert mixed > 0 and 0 < stats[0] < ROUNDS, (mixed, stats)
    # The dense run from the same draws ends in the same state.
    dense, dense_conv = tsim.run(exact_port_state(start), ROUNDS,
                                 draws=draws, sparse=False)
    assert_port_states_equal(dense, got, "sparse vs dense")
    assert torch.equal(dense_conv, got_conv)


# -- (iv) the pipelined round, by delegation --------------------------------


def test_pipelined_delegation_equals_reference():
    jsim = jax_sharded(4, "ring")
    jf, jc, jinf = jsim.run_pipelined(jsim.init_state(), KEY, ROUNDS,
                                      donate=False)
    # The delegated program draws the single-device model's draws.
    single = jexact.ExactSim(jsim.p, jsim.topo, jsim.t)
    draws = jax_exact_draw_seq(single, KEY, 0, ROUNDS + 1)
    tsim = port_from(jsim, 4, "ring")
    tf, tc, tinf = tsim.run_pipelined(tsim.init_state(), ROUNDS,
                                      draws=draws)
    assert_exact_states_equal(jf, tf, "pipelined")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for got, want in zip(tinf.publish, jinf):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pf, pc = tsim.run(tsim.init_state(), ROUNDS, draws=draws, pipeline=True)
    assert_port_states_equal(pf, tf, "run(pipeline=True)")
    assert torch.equal(pc, tc)
    with pytest.raises(ValueError, match="the carried publish is dense"):
        tsim.run(tsim.init_state(), ROUNDS, draws=draws, pipeline=True,
                 sparse=True)


# -- (v) the telemetry streams ------------------------------------------------

TRACKED = (0, 37, 90, 127)


@pytest.mark.parametrize("plane", ["trace", "digest", "provenance"])
def test_streams_equal_reference(plane):
    jsim = jax_sharded(4, "ring")
    draws = reference_sharded_run("ring", 4)[3]
    tsim = port_from(jsim, 4, "ring")
    if plane == "provenance":
        jf, js, jc = jsim.run_with_provenance(jsim.init_state(), KEY,
                                              ROUNDS, TRACKED)
        tf, ts, tc = tsim.run_with_provenance(tsim.init_state(), ROUNDS,
                                              TRACKED, draws=draws)
    else:
        run = f"run_with_{plane}"
        jf, js, jc = getattr(jsim, run)(jsim.init_state(), KEY, ROUNDS)
        tf, ts, tc = getattr(tsim, run)(tsim.init_state(), ROUNDS,
                                        draws=draws)
    assert_exact_states_equal(jf, tf, plane)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_stream_equal(js, ts, plane, "sharded d=4")
    with pytest.raises(NotImplementedError, match="no run_with_deltas"):
        tsim.run_with_deltas(tsim.init_state(), ROUNDS, 8, draws=draws)


def test_sparse_trace_equals_reference():
    jsim, start, *_ = reference_sparse_run()
    draws = reference_sparse_run()[5]
    jf, js, jc = jsim.run_with_trace(start, KEY, ROUNDS, donate=False)
    tsim = port_from(jsim, 2, "ring", sparse="1")
    tf, ts, tc = tsim.run_with_trace(exact_port_state(start), ROUNDS,
                                     draws=draws)
    assert_exact_states_equal(jf, tf, "sparse trace")
    assert_stream_equal(js, ts, "trace", "sparse trace")
    np.testing.assert_array_equal(tsim.last_sparse_stats.numpy(),
                                  np.asarray(jsim.last_sparse_stats))


# -- (vi) the digest-gated zoned exchange ------------------------------------

GATE_PARAMS = dict(n=16, services_per_node=2, fanout=4, budget=8)
GATE_TIME = dict(refresh_interval_s=1000.0, push_pull_interval_s=1e6,
                 sweep_interval_s=1.0)
GATE_ROUNDS = 14


def gate_graph():
    return jtopo.zoned(16, 4, local_hops=2, remote_deg=4, gateways=2)


@pytest.mark.parametrize("d", [2, 4])
def test_digest_gate_equals_reference_and_engages(d):
    jsim = jax_sharded(d, "zoned", GATE_PARAMS, GATE_TIME, gate_graph(),
                       digest_gate=True)
    jf, jc = jsim.run(jsim.init_state(), KEY, GATE_ROUNDS)
    draws = jax_sharded_exact_draws(jsim, KEY, 0, GATE_ROUNDS)
    gated = port_from(jsim, d, "zoned", digest_gate=True)
    plain = port_from(jsim, d, "zoned")
    start = gated.init_state()
    assert not gated.gate_predicates(start).any()
    skips = []
    gate_skips = gated._gate_skips
    gated._gate_skips = lambda *a: skips.append(gate_skips(*a)) or skips[-1]
    st_g, st_p = start, plain.init_state()
    for dr in draws:
        st_g, st_p = gated.step(st_g, draws=dr), plain.step(st_p, draws=dr)
        assert_port_states_equal(st_g, st_p, "gated vs ungated")
    assert_exact_states_equal(jf, st_g, f"gated d={d}")
    known = exact_to_numpy(jf)["known"]
    assert (known == known[:1]).all(), "converged"
    want = jsim.gate_predicates(jf)
    np.testing.assert_array_equal(gated.gate_predicates(st_g), want)
    assert want.all()
    # The device-side gate agrees with the host replica: it skipped no
    # hop at the start and every hop once the state had converged.
    assert not skips[0]
    gated.step(st_g, draws=draws[-1])
    assert skips[-1] == set(range(1, d))


# -- (vii) gauges and refusals ----------------------------------------------


@pytest.fixture
def registries():
    tmetrics.reset()
    jmetrics.registry._counters.clear()
    jmetrics.registry._gauges.clear()
    yield
    tmetrics.reset()


GAUGES = ("parallel.exchange.bytes", "parallel.exchange.zoned_rows")


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_exchange_bytes_and_gauges_match_reference(registries, mode, d):
    topo = graph("zoned")
    jsim = jax_sharded(d, mode, topo=topo)
    tsim = port_from(jsim, d, mode)
    assert tsim.exchange_bytes_per_round == jsim.exchange_bytes_per_round
    assert tsim._sparse_cap_shard == jsim._sparse_cap_shard
    jg, tg = (reg.snapshot()["gauges"] for reg in (jmetrics, tmetrics))
    assert {k: tg.get(k) for k in GAUGES} == {k: jg.get(k) for k in GAUGES}
    assert tg["parallel.exchange.bytes"] > 0


def small(**kw):
    p = SimParams(n=16, services_per_node=2, fanout=2, budget=4)
    topo = kw.pop("topo", ttopo.complete(16))
    return ShardedSim(p, topo, device=kw.pop("device", "cpu"), **kw)


@pytest.mark.parametrize("option,value", [
    ("cut_mask", None),
    ("node_side", None),
])
def test_chaos_options_raise(option, value):
    """The chaos options (Queue 1 item 8, ported) run a round equal to
    the reference twin's at d = 2, push-pull firing every round."""
    key = jax.random.PRNGKey(4)
    topo = jtopo.ring(16)
    jkw, tkw = chaos_option_kwargs(option, topo, 200, key, 16)
    params = dict(n=16, services_per_node=2, fanout=2, budget=4)
    jsim = JShardedSim(jexact.SimParams(**params), topo,
                       JTimeConfig(push_pull_interval_s=0.2),
                       mesh=make_mesh(jax.devices()[:2]),
                       board_exchange="ring", **jkw)
    want, conv = jsim.run(jsim.init_state(), key, 1)
    tsim = port_from(jsim, 2, "ring", **tkw)
    got, got_conv = tsim.run(tsim.init_state(), 1,
                             draws=jax_sharded_exact_draws(jsim, key, 0, 1))
    assert_exact_states_equal(want, got, option)
    np.testing.assert_array_equal(got_conv.numpy(), np.asarray(conv))


@pytest.mark.parametrize("kw,match", [
    (dict(board_exchange="zoned"), "neighbor-list"),
    (dict(board_exchange="all_to_all"), "board_exchange"),
    (dict(digest_gate=True), "digest_gate"),
    (dict(d=3), "divide"),
    (dict(d=4, board_exchange="zoned", topo=ttopo.ring(16),
          gate_buckets=6, digest_gate=True), "power of two"),
])
def test_bad_configurations_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        small(**kw)


def test_reads_no_environment_and_needs_a_gpu(monkeypatch):
    monkeypatch.setenv("SIDECAR_TPU_ANTIENTROPY_GATE", "1")
    sim = small(d=4, board_exchange="zoned", topo=ttopo.ring(16))
    assert not sim.digest_gate
    with pytest.raises(ValueError, match="requires digest_gate"):
        sim.gate_predicates(sim.init_state())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small(device="cuda")
    assert sim.device.type == "cpu"
