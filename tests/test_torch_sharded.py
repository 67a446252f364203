"""The port's node-sharded compressed twin against the JAX reference,
exactly.

* Every ``board_exchange`` mode at every shard count d ∈ {1, 2, 4, 8}
  equals the reference's single-device ``CompressedSim`` in every state
  field and every behind sample, fed the reference's single-device
  draws (the reference's own sharded suites pin its twin to the
  single-device model the same way).  One reference run per graph:
  the complete graph with packet loss, the zoned overlay with the
  admission defences on.
* The port against the reference's ``ShardedCompressedSim`` itself, on
  the 8-device CPU mesh of ``tests/conftest.py``, with random peers and
  packet loss: the reference draws per shard, and
  ``torch_parity.jax_sharded_draws`` rebuilds those streams.  One
  ``all_to_all`` case runs at ``a2a_slack=1``, where pulls overflow
  their buckets, and the drop counts must agree.
* The ``row_offset`` forms of the publish and the announce, the
  exchange byte counts, the zoned plan, the shard group's collectives,
  and the constructor's refusals.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.models import compressed as jc
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.parallel.mesh import make_mesh
from sidecar_tpu.parallel.sharded_compressed import (
    ShardedCompressedSim as JShardedCompressedSim,
)
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models.compressed import (
    CompressedParams,
    CompressedSim,
)
from sidecar_tpu_torch.ops import topology as ttopo
from sidecar_tpu_torch.ops.status import ALIVE, TOMBSTONE
from sidecar_tpu_torch.parallel import (
    LocalShardGroup,
    ShardedCompressedSim,
    resolve_board_exchange,
)
from tests.torch_parity import (
    chaos_option_kwargs,
    assert_port_states_equal,
    assert_states_equal,
    jax_draw_seq,
    jax_sharded_draws,
    port_pair,
    port_state,
)

# Refreshes every 10 rounds (so refresh folds write the floor slices),
# push-pull every 5, the sweep every 2.
TIME = dict(refresh_interval_s=2.0, push_pull_interval_s=1.0,
            sweep_interval_s=0.4)
PARAMS = dict(n=16, services_per_node=2, fanout=2, budget=4,
              cache_lines=32)
CHUNK = 10
MODES = ("all_gather", "all_to_all", "ring", "zoned")
DS = (1, 2, 4, 8)


def zoned_graph(n=16, zones=4):
    """The zoned exchange's acceptance overlay
    (tests/test_sharded_exchange.py): local lattice, remote links and a
    gateway ring all active."""
    return jtopo.zoned(n, zones, local_hops=1, remote_deg=2, gateways=1)


def port_sharded(jsim, **kw):
    """The port's sharded twin built from a reference sim's params,
    graph and time config, on the CPU."""
    topo = jsim.topo
    return ShardedCompressedSim(
        convert.params_from_jax_fields(dataclasses.asdict(jsim.p)),
        convert.topology_from_numpy(topo.n, topo.nbrs, topo.deg, topo.name),
        convert.timecfg_from_fields(dataclasses.asdict(jsim.t)),
        device="cpu", **kw)


def mints(m, chunks):
    rng = np.random.default_rng(5)
    return [np.sort(rng.choice(m, size=6, replace=False)).astype(np.int32)
            for _ in range(chunks)]


def run_jax(jsim, key, draws_of, statuses=(ALIVE, ALIVE)):
    """One run of CHUNK rounds per entry of ``statuses``, a burst of
    that status minted before each; returns the states after each, the
    behind curve and the draws."""
    states, curves, draws = [], [], []
    js = jsim.init_state()
    for c, slots in enumerate(mints(jsim.p.m, len(statuses))):
        js = jsim.mint(js, jnp.asarray(slots), c * CHUNK * 200 + 7,
                       statuses[c])
        draws += draws_of(jsim, key, c * CHUNK, CHUNK)
        js, jb = jsim.run_behind(js, key, CHUNK, every=1, donate=False)
        states.append(js)
        curves.append(np.asarray(jb))
    return states, np.concatenate(curves), draws


def run_port(tsim, draws, statuses=(ALIVE, ALIVE)):
    states, curves = [], []
    ts = tsim.init_state()
    for c, slots in enumerate(mints(tsim.p.m, len(statuses))):
        ts = tsim.mint(ts, slots, c * CHUNK * 200 + 7, statuses[c])
        ts, tb = tsim.run_behind(ts, CHUNK, 1,
                                 draws=draws[c * CHUNK:(c + 1) * CHUNK])
        states.append(ts)
        curves.append(tb.numpy())
    return states, np.concatenate(curves)


# The two single-device reference runs: the complete graph with packet
# loss; the zoned overlay with the admission defences on (the per-origin
# budget, the future bound) and a tombstone burst that relays make
# suspicious.
GRAPHS = {
    "complete": (lambda: jtopo.complete(PARAMS["n"]), dict(drop_prob=0.1),
                 {}, (ALIVE, ALIVE)),
    "zoned": (zoned_graph, {}, dict(origin_budget=1, future_fudge_s=0.5),
              (ALIVE, TOMBSTONE)),
}


@functools.lru_cache(maxsize=None)
def single_device_reference(graph: str):
    make_topo, params, time_kw, statuses = GRAPHS[graph]
    jsim, _ = port_pair(dict(PARAMS, **params), make_topo(),
                        dict(TIME, **time_kw))
    states, curve, draws = run_jax(jsim, jax.random.PRNGKey(4),
                                   jax_draw_seq, statuses)
    return jsim, states, curve, draws


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("mode", MODES)
def test_every_mode_and_d_equals_single_device_reference(mode, d):
    graph = "zoned" if mode == "zoned" else "complete"
    jsim, want, curve, draws = single_device_reference(graph)
    tsim = port_sharded(jsim, d=d, board_exchange=mode)
    got, got_curve = run_port(tsim, draws, GRAPHS[graph][3])
    for c, (a, b) in enumerate(zip(want, got)):
        assert_states_equal(a, b, f"{mode}/d={d} chunk {c}")
    np.testing.assert_array_equal(got_curve, curve)
    # Premise: a burst was in flight, and no pull was dropped.
    assert curve.max() > 0
    assert tsim.sync_exchange_metrics(got[-1]) == 0


@pytest.mark.parametrize("mode,d,slack,stub", [
    ("ring", 4, 2, False),
    ("all_to_all", 2, 1, False),
    ("all_gather", 2, 2, True),
])
def test_equals_reference_sharded_twin(mode, d, slack, stub):
    """Random per-shard peers and 20 % loss through the reference's own
    sharded twin, for one chunk (each new input layout recompiles the
    reference's sharded program).  At ``a2a_slack=1`` (n=64, F=3: a
    bucket holds 48 requests, the mean load) pulls overflow and are
    dropped; the port must drop the same ones.  ``exchange_stub`` (the
    measurement-only round that folds own-shard rows alone) must be
    wrong the reference's way."""
    n = 64 if mode == "all_to_all" else 32
    params = dict(PARAMS, n=n, drop_prob=0.2,
                  fanout=3 if mode == "all_to_all" else 2)
    kw = dict(board_exchange=mode, a2a_slack=slack, exchange_stub=stub)
    jsim = JShardedCompressedSim(
        jc.CompressedParams(**params), jtopo.complete(n),
        JTimeConfig(**TIME), mesh=make_mesh(jax.devices()[:d]), **kw)
    want, curve, draws = run_jax(jsim, jax.random.PRNGKey(9),
                                 jax_sharded_draws, statuses=(ALIVE,))
    tsim = port_sharded(jsim, d=d, **kw)
    got, got_curve = run_port(tsim, draws, statuses=(ALIVE,))
    for c, (a, b) in enumerate(zip(want, got)):
        assert_states_equal(a, b, f"{mode}/d={d} chunk {c}")
    np.testing.assert_array_equal(got_curve, curve)
    dropped = tsim.sync_exchange_metrics(got[-1])
    assert dropped == int(want[-1].dropped)
    assert (dropped > 0) == (slack == 1), dropped


# -- the sparse and pipelined rounds against the reference's twin ---------

SPARSE_TIME = dict(TIME, sweep_interval_s=1.0)


def sparse_twin_pair(mode, d, slack=2, **kw):
    """The reference's twin and the port's at n = 64 with a sparse cap
    of 4 (per-shard caps of 16 rows: at d = 2 the frontiers overflow
    in the burst's busy rounds, at d = 4 a shard has 16 rows)."""
    n = 64
    params = dict(PARAMS, n=n, drop_prob=0.1, sparse_cap=4,
                  fanout=3 if mode == "all_to_all" else 2)
    topo = zoned_graph(n, 4) if mode == "zoned" else jtopo.complete(n)
    kw = dict(kw, board_exchange=mode, a2a_slack=slack)
    jsim = JShardedCompressedSim(
        jc.CompressedParams(**params), topo, JTimeConfig(**SPARSE_TIME),
        mesh=make_mesh(jax.devices()[:d]), **kw)
    return jsim, port_sharded(jsim, d=d, **kw)


SPARSE_ROUNDS = 16


@pytest.mark.parametrize("mode,d,slack", [
    (mode, d, 2) for mode in MODES for d in (2, 4)] + [
    ("all_to_all", 2, 1)])
def test_sparse_round_equals_reference_twin(mode, d, slack):
    """``sparse="1"`` through the reference's own twin from a burst: the
    same states, behind curve, sparse stats and dropped pulls."""
    jsim, tsim = sparse_twin_pair(mode, d, slack, sparse="1")
    slots = mints(jsim.p.m, 1)[0]
    key = jax.random.PRNGKey(7)
    js = jsim.mint(jsim.init_state(), jnp.asarray(slots), 7)
    jf, jb = jsim.run_behind(js, key, SPARSE_ROUNDS, every=1, donate=False,
                             sparse=True)
    draws = jax_sharded_draws(jsim, key, 0, SPARSE_ROUNDS)
    ts = tsim.mint(tsim.init_state(), slots, 7)
    tf, tb = tsim.run_behind(ts, SPARSE_ROUNDS, 1, draws=draws,
                             sparse=True)
    assert_states_equal(jf, tf, f"sparse {mode}/d={d}")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    stats = tsim.last_sparse_stats.numpy()
    np.testing.assert_array_equal(stats, np.asarray(jsim.last_sparse_stats))
    dropped = tsim.sync_exchange_metrics(tf)
    assert dropped == int(jf.dropped)
    assert (dropped > 0) == (slack == 1), dropped
    # Premise: compacted rounds ran, and at d = 2 some overflowed.
    assert stats[0] > 0 and (stats[1] > 0) == (d == 2), stats


def test_pipelined_twin_equals_reference_twin():
    """The pipelined round through the reference's twin: the inherited
    single-device program on the global state, drawing the
    single-device stream."""
    jsim, tsim = sparse_twin_pair("ring", 4)
    slots = mints(jsim.p.m, 1)[0]
    key = jax.random.PRNGKey(8)
    js = jsim.mint(jsim.init_state(), jnp.asarray(slots), 7)
    jf, jc_, jinf = jsim.run_pipelined(js, key, SPARSE_ROUNDS, 1,
                                       donate=False)
    draws = jax_draw_seq(jsim, key, 0, SPARSE_ROUNDS + 1)
    ts = tsim.mint(tsim.init_state(), slots, 7)
    tf, tc, tinf = tsim.run_pipelined(ts, SPARSE_ROUNDS, 1, draws=draws)
    assert_states_equal(jf, tf, "pipelined twin")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc_))
    for got, want in zip(tinf.publish, jinf):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- row_offset: the shard's view of the single-device phases -------------


@functools.lru_cache(maxsize=None)
def mid_flight_pair(n=48, rounds=6):
    """A reference sim and a port sim, and a port state a few rounds
    after a burst (refreshes due, lines in flight)."""
    params = dict(n=n, services_per_node=4, fanout=3, budget=6,
                  cache_lines=32)
    jsim, tsim = port_pair(params, jtopo.erdos_renyi(n, 6.0, seed=3), TIME)
    rng = np.random.default_rng(1)
    st = tsim.mint(tsim.init_state(),
                   np.sort(rng.choice(tsim.p.m, 40, replace=False)), 10)
    st = tsim.run_fast(st, rounds,
                       generator=torch.Generator().manual_seed(2))
    return jsim, tsim, st


@pytest.mark.parametrize("r0,nl", [(0, 48), (16, 16), (36, 12)])
def test_publish_row_offset_matches_reference(r0, nl):
    jsim, tsim, st = mid_flight_pair()
    rows = slice(r0, r0 + nl)
    block = dataclasses.replace(st, cache_val=st.cache_val[rows],
                                cache_slot=st.cache_slot[rows],
                                cache_sent=st.cache_sent[rows])
    jblock = jc.CompressedState(**{
        k: jnp.asarray(v) for k, v in convert.state_to_numpy(block).items()})
    limit = tsim._knobs.limit
    got = tsim._publish(block, limit, row_offset=r0)
    want = jax.jit(functools.partial(jsim._publish, limit=limit,
                                     row_offset=r0))(jblock)
    for name, g, w in zip(("bval", "bslot", "sent"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("r0,nl", [(0, 48), (16, 16), (36, 12)])
def test_announce_offers_row_offset_matches_reference(r0, nl):
    jsim, tsim, st = mid_flight_pair()
    rows = slice(r0, r0 + nl)
    alive = st.node_alive.clone()
    alive[r0 + 1] = False
    ref = jax.jit(functools.partial(jsim._announce_offers, row_offset=r0))
    for round_idx in range(st.round_idx + 1, st.round_idx + 11):
        now = round_idx * tsim.t.round_ticks
        got = tsim._announce_offers(st.own[rows], st.floor, alive[rows],
                                    round_idx, now, row_offset=r0)
        want = ref(jnp.asarray(st.own[rows].numpy()),
                   jnp.asarray(st.floor.numpy()),
                   jnp.asarray(alive[rows].numpy()), round_idx, now)
        for name, g, w in zip(("own", "floor", "offer_val", "base_slot"),
                              got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} r{round_idx}")
    # Premise: refreshes folded into the floor slice over these rounds.
    assert not torch.equal(got[1], st.floor)


# -- the exchange's byte counts and the zoned plan --------------------------


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_exchange_bytes_match_reference(mode, d):
    params = dict(PARAMS, n=32, fanout=3)
    topo = zoned_graph(32, 4)
    jsim = JShardedCompressedSim(
        jc.CompressedParams(**params), topo, JTimeConfig(**TIME),
        mesh=make_mesh(jax.devices()[:d]), board_exchange=mode)
    tsim = port_sharded(jsim, d=d, board_exchange=mode)
    assert tsim.exchange_bytes_per_round == jsim.exchange_bytes_per_round
    assert tsim._a2a_cap == jsim._a2a_cap


@pytest.mark.parametrize("direction", ["pull", "push"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_zoned_plan_matches_reference(d, direction):
    topo = zoned_graph(32, 4)
    want = jtopo.zoned_exchange_plan(topo, d, direction=direction)
    got = ttopo.zoned_exchange_plan(
        convert.topology_from_numpy(32, topo.nbrs, topo.deg), d,
        direction=direction)
    assert got.total_rows == want.total_rows
    for g, w in zip(got.hops, want.hops):
        assert (g is None) == (w is None)
        if g is not None:
            for f in ("rows", "valid", "pos"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


# -- the shard group ------------------------------------------------------


def test_shard_group_collectives():
    g = LocalShardGroup(3)
    xs = [torch.arange(6, dtype=torch.int32).reshape(3, 2) + 10 * s
          for s in range(3)]
    full = g.all_gather(xs)
    assert all(torch.equal(f, torch.cat(xs)) for f in full)
    out = g.all_to_all(xs)
    for s in range(3):
        for j in range(3):
            assert torch.equal(out[s][j], xs[j][s])
    moved = g.ppermute(xs, [(0, 2), (2, 1)])
    assert torch.equal(moved[2], xs[0]) and torch.equal(moved[1], xs[2])
    assert not moved[0].any()
    # pmax merges replicas whose slices overlap in value.
    reps = [torch.tensor([5, 1, 7]), torch.tensor([2, 9, 7]),
            torch.tensor([5, 1, 3])]
    assert all(torch.equal(m, torch.tensor([5, 9, 7])) for m in g.pmax(reps))
    assert all(int(v) == 6 for v in g.psum([torch.tensor(v)
                                            for v in (1, 2, 3)]))
    with pytest.raises(ValueError, match="one tensor per shard"):
        g.pmax(reps[:2])


def test_board_exchange_resolution():
    assert resolve_board_exchange() == "all_gather"
    assert resolve_board_exchange("ring") == "ring"
    with pytest.raises(ValueError, match="board_exchange"):
        resolve_board_exchange("broadcast")
    with pytest.raises(ValueError, match="board_exchange"):
        resolve_board_exchange("zoned", supported=("all_gather",))


# -- constructor refusals -------------------------------------------------


def small(**kw):
    p = CompressedParams(n=16, services_per_node=2, cache_lines=8, budget=4)
    topo = kw.pop("topo", ttopo.complete(16))
    return ShardedCompressedSim(p, topo, device=kw.pop("device", "cpu"),
                                **kw)


@pytest.mark.parametrize("option,value", [
    ("perturb", None),
    ("cut_mask", None),
    ("node_side", None),
    ("sparse", "auto"),
    ("pipeline", "1"),
    ("tick_period", 2),
])
def test_deferred_sharded_options_raise(option, value):
    """Every option once deferred runs a round.  The chaos options
    (item 8): the twin at d = 2 with the option equals the reference's
    single-device model with it.  The twin's sparse and pipelined rounds
    (item 10) and the tick cadence: the sparse round equals the twin's
    dense one, the pipelined round the single-device model's pipelined
    one."""
    if option in ("perturb", "cut_mask", "node_side"):
        key = jax.random.PRNGKey(4)
        topo = jtopo.ring(16)
        jkw, tkw = chaos_option_kwargs(option, topo, 200, key, 16)
        params = dict(n=16, services_per_node=2, cache_lines=8, budget=4)
        time = dict(push_pull_interval_s=0.2)
        jsim, _ = port_pair(params, topo, time, **jkw)
        js = jsim.mint(jsim.init_state(), np.array([3, 17], np.int32), 10)
        jf, jb = jsim.run_behind(js, key, 1, every=1, donate=False)
        twin = port_sharded(jsim, d=2, board_exchange="ring", **tkw)
        tf, tb = twin.run_behind(port_state(js), 1, 1,
                                 draws=jax_draw_seq(jsim, key, 0, 1))
        assert_states_equal(jf, tf, option)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        return
    sim = small(d=2, **{option: value})
    st = sim.mint(sim.init_state(), [3, 17], 10)

    def one_round(s, **kw):
        out = s.run_fast(st, 1, generator=torch.Generator().manual_seed(0),
                         **kw)
        assert out.round_idx == 1
        return out

    if option == "tick_period":
        one_round(sim)
        assert sim._knobs.cadence_enabled
    elif option == "sparse":
        got = one_round(sim, sparse=True)
        assert int(sim.last_sparse_stats[:2].sum()) == 1
        assert_port_states_equal(got, one_round(sim, sparse=False))
    else:
        single = CompressedSim(sim.p, sim.topo, sim.t, device="cpu",
                               fused_gather=False, pipeline="1")
        assert_port_states_equal(one_round(sim), one_round(single))


@pytest.mark.parametrize("kw,match", [
    (dict(board_exchange="zoned"), "neighbor-list"),
    (dict(board_exchange="broadcast"), "board_exchange"),
    (dict(a2a_slack=0), "a2a_slack"),
    (dict(d=3), "divide"),
])
def test_bad_configurations_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        small(**kw)


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small(device="cuda")
    assert small(d=4).device.type == "cpu"
