"""The partition hooks on the port's models — ``cut_mask``,
``node_side`` and the scenario hook ``perturb`` — against the JAX
reference, exactly.

* ``mesh2d``, ``partition_mask`` and ``from_name("mesh…")`` build the
  reference's arrays.
* ``ExactSim`` with a cut and a churn hook (the reference hook's masks
  replayed, ``torch_parity.jax_perturb_masks``), lockstep, sparse and
  pipelined, and its provenance stream.
* ``CompressedSim`` with a cut, sides and a liveness hook: fused,
  unfused, forced sparse, pipelined, and with ``fold_quorum < 1`` (the
  quorum fold is off while a cut is modelled), and its provenance
  stream.
* ``ShardedSim`` with the cut and sides at d ∈ {2, 4} in each exchange
  mode against the reference's ``ShardedSim``; its pipelined round
  refuses the sides and takes the cut; ``ShardedCompressedSim`` with
  the cut and sides at d ∈ {2, 4} in each mode against the reference's
  single-device model.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.parallel.mesh import make_mesh
from sidecar_tpu.parallel.sharded import ShardedSim as JShardedSim
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models.compressed import CompressedSim
from sidecar_tpu_torch.ops import topology as ttopo
from sidecar_tpu_torch.ops.status import TOMBSTONE, unpack_status
from sidecar_tpu_torch.parallel import ShardedCompressedSim
from tests.torch_parity import (
    assert_exact_states_equal,
    assert_port_states_equal,
    assert_states_equal,
    assert_stream_equal,
    bench_burst,
    churn_hooks,
    exact_port_pair,
    exact_port_state,
    jax_draw_seq,
    jax_exact_draw_seq,
    jax_perturb_masks,
    jax_sharded_exact_draws,
    port_pair,
    port_state,
    sharded_exact_port,
)

KEY = jax.random.PRNGKey(21)
ROWS, COLS = 4, 8
N = ROWS * COLS
# Sides by column half, as config5 splits its mesh.
SIDE = (np.arange(N) % COLS >= COLS // 2).astype(np.int32)
TIME = dict(refresh_interval_s=2.0, push_pull_interval_s=1.0,
            sweep_interval_s=0.4)
ROUNDS = 24


def mesh():
    return jtopo.mesh2d(ROWS, COLS)


def cut():
    return jtopo.partition_mask(mesh(), SIDE)


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 5), (3, 1), (4, 8),
                                       (7, 5)])
def test_mesh2d_and_partition_mask_equal_reference(rows, cols):
    j, t = jtopo.mesh2d(rows, cols), ttopo.mesh2d(rows, cols)
    np.testing.assert_array_equal(t.nbrs, j.nbrs)
    np.testing.assert_array_equal(t.deg, j.deg)
    assert t.nbrs.dtype == j.nbrs.dtype and t.deg.dtype == j.deg.dtype
    assert (t.n, t.name) == (j.n, j.name)
    side = (np.arange(rows * cols) % max(cols, 1) >= cols // 2).astype(
        np.int32)
    np.testing.assert_array_equal(ttopo.partition_mask(t, side),
                                  jtopo.partition_mask(j, side))
    got = ttopo.from_name(f"mesh{rows}x{cols}", rows * cols)
    np.testing.assert_array_equal(got.nbrs, j.nbrs)
    with pytest.raises(ValueError, match="explicit neighbor list"):
        ttopo.partition_mask(ttopo.complete(4), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="has 40 nodes"):
        ttopo.from_name("mesh5x8", 41)


# -- the exact model ----------------------------------------------------------


def exact_pair(**kw):
    params = dict(n=N, services_per_node=4, fanout=2, budget=6,
                  drop_prob=0.1)
    round_ticks = JTimeConfig().round_ticks
    masks = jax_perturb_masks(KEY, 0, ROUNDS + 1, (N * 4,), 0.05)
    jhook, thook = churn_hooks(params, round_ticks, masks, 3, 15)
    jsim, tsim = exact_port_pair(params, mesh(), TIME, cut_mask=cut(), **kw)
    jsim.perturb, tsim.perturb = jhook, thook
    return jsim, tsim


@pytest.mark.parametrize("mode", ["lockstep", "sparse", "pipelined"])
def test_exact_cut_and_perturb_equal_reference(mode):
    jsim, tsim = exact_pair(sparse="1" if mode == "sparse" else None,
                            pipeline="1" if mode == "pipelined" else None)
    js = jsim.init_state(0.8, seed=4)
    ts = exact_port_state(js)
    draws = jax_exact_draw_seq(jsim, KEY, 0, ROUNDS + 1)
    if mode == "pipelined":
        jf, jconv, _ = jsim.run_pipelined(js, KEY, ROUNDS, donate=False)
        tf, tconv, _ = tsim.run_pipelined(ts, ROUNDS, draws=draws)
    else:
        jf, jconv = jsim.run(js, KEY, ROUNDS, donate=False)
        tf, tconv = tsim.run(ts, ROUNDS, draws=draws[:ROUNDS])
    assert_exact_states_equal(jf, tf, mode)
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    if mode == "sparse":
        np.testing.assert_array_equal(tsim.last_sparse_stats.numpy(),
                                      np.asarray(jsim.last_sparse_stats))
    # Premise: the hook flipped records (tombstones at the owners).
    assert (unpack_status(tf.known) == TOMBSTONE).any()
    if mode == "lockstep":
        # The cut matters: without it the same run differs.
        _, free = exact_port_pair(dict(tsim.p.__dict__), mesh(), TIME)
        free.perturb = tsim.perturb
        other, _ = free.run(exact_port_state(js), ROUNDS,
                            draws=draws[:ROUNDS])
        assert not torch.equal(other.known, tf.known)


def test_exact_provenance_with_cut_and_perturb_equals_reference():
    jsim, tsim = exact_pair()
    js = jsim.init_state(0.8, seed=4)
    ts = exact_port_state(js)
    tracked = (0, 17, 100)
    draws = jax_exact_draw_seq(jsim, KEY, 0, ROUNDS)
    jf, jp, _ = jsim.run_with_provenance(js, KEY, ROUNDS, tracked,
                                         donate=False)
    tf, tp, _ = tsim.run_with_provenance(ts, ROUNDS, tracked, draws=draws)
    assert_exact_states_equal(jf, tf, "provenance")
    assert_stream_equal(jp, tp, "provenance")


def test_cut_on_a_complete_graph_raises():
    for make in (lambda: exact_port_pair(dict(n=8), jtopo.complete(8), {},
                                         cut_mask=np.zeros((8, 2), bool)),
                 lambda: port_pair(dict(n=8, cache_lines=16),
                                   jtopo.complete(8), {},
                                   cut_mask=np.zeros((8, 2), bool))):
        with pytest.raises(ValueError, match="neighbor-list topology"):
            make()


# -- the compressed model -----------------------------------------------------


CPARAMS = dict(n=N, services_per_node=4, cache_lines=16, fanout=2,
               budget=6, fold_quorum=1.0, deep_sweep_every=0)


def liveness_hooks(masks, round_ticks):
    """A hook that toggles the liveness of the chosen nodes each round,
    in both packages: the reference draws ``bernoulli(k_perturb, 0.08,
    [N])``, the port's replays those masks."""
    def jax_hook(state, key, now):
        flip = jax.random.bernoulli(key, 0.08, (N,))
        return dataclasses.replace(state,
                                   node_alive=state.node_alive ^ flip)

    def port_hook(state, now):
        return dataclasses.replace(
            state, node_alive=state.node_alive ^ masks[now // round_ticks])

    return jax_hook, port_hook


def compressed_pair(fused=True, **kw):
    params = dict(CPARAMS, **kw.pop("params", {}))
    jsim, tsim = port_pair(params, mesh(), TIME, fused_gather=fused,
                           cut_mask=cut(), node_side=SIDE, **kw)
    masks = jax_perturb_masks(KEY, 0, ROUNDS + 1, (N,), 0.08)
    jsim.perturb, tsim.perturb = liveness_hooks(
        masks, JTimeConfig().round_ticks)
    return jsim, tsim


def minted(jsim, tsim):
    slots = bench_burst(jsim.p.m, 0.15)
    js = jsim.mint(jsim.init_state(), slots, 10)
    return js, tsim.mint(tsim.init_state(), slots, 10)


@pytest.mark.parametrize("case", ["fused", "unfused", "sparse", "pipelined",
                                  "quorum"])
def test_compressed_cut_sides_perturb_equal_reference(case):
    kw = {}
    if case == "sparse":
        kw = dict(sparse="1", params=dict(sparse_cap=12))
    elif case == "pipelined":
        kw = dict(pipeline="1")
    elif case == "quorum":
        kw = dict(params=dict(fold_quorum=0.5))
    jsim, tsim = compressed_pair(fused=case != "unfused", **kw)
    js, ts = minted(jsim, tsim)
    draws = jax_draw_seq(jsim, KEY, 0, ROUNDS + 1)
    if case == "pipelined":
        jf, jb, _ = jsim.run_pipelined(js, KEY, ROUNDS, 1, donate=False)
        tf, tb, _ = tsim.run_pipelined(ts, ROUNDS, 1, draws=draws)
    else:
        jf, jb = jsim.run_behind(js, KEY, ROUNDS, every=1, donate=False)
        tf, tb = tsim.run_behind(ts, ROUNDS, 1, draws=draws[:ROUNDS])
    assert_states_equal(jf, tf, case)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if case == "sparse":
        stats = tsim.last_sparse_stats.numpy()
        np.testing.assert_array_equal(stats,
                                      np.asarray(jsim.last_sparse_stats))
        assert stats[0] > 0
    # Premise: nodes went down and a burst was in flight.
    assert not bool(tf.node_alive.all())
    assert float(tb.max()) > 0


def test_quorum_fold_is_off_under_a_cut():
    """With the cut, ``fold_quorum < 1`` folds only on a full census;
    without it the same run folds by quorum, and differs."""
    jsim, tsim = compressed_pair(params=dict(fold_quorum=0.5))
    plain = CompressedSim(tsim.p, tsim.topo, tsim.t, device="cpu")
    js, ts = minted(jsim, tsim)
    draws = jax_draw_seq(jsim, KEY, 0, ROUNDS)
    cut_run = tsim.run_fast(ts, ROUNDS, draws=draws)
    free_run = plain.run_fast(ts, ROUNDS, draws=draws)
    assert not torch.equal(cut_run.floor, free_run.floor)


def test_compressed_provenance_with_hooks_equals_reference():
    jsim, tsim = compressed_pair()
    js, ts = minted(jsim, tsim)
    tracked = tuple(int(s) for s in bench_burst(jsim.p.m, 0.15)[:4])
    draws = jax_draw_seq(jsim, KEY, 0, ROUNDS)
    jf, jp = jsim.run_with_provenance(js, KEY, ROUNDS, tracked,
                                      donate=False)
    tf, tp = tsim.run_with_provenance(ts, ROUNDS, tracked, draws=draws)
    assert_states_equal(jf, tf, "provenance")
    assert_stream_equal(jp, tp, "provenance")


# -- the sharded twins --------------------------------------------------------


SPARAMS = dict(n=N, services_per_node=4, fanout=2, budget=6, drop_prob=0.1)


@functools.lru_cache(maxsize=None)
def reference_sharded_exact(mode, d):
    jsim = JShardedSim(jexact.SimParams(**SPARAMS), mesh(),
                       JTimeConfig(**TIME), mesh=make_mesh(jax.devices()[:d]),
                       board_exchange=mode, cut_mask=cut(), node_side=SIDE)
    final, conv = jsim.run(jsim.init_state(), KEY, ROUNDS)
    return jsim, final, np.asarray(conv), \
        jax_sharded_exact_draws(jsim, KEY, 0, ROUNDS)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", ["all_gather", "ring", "zoned"])
def test_sharded_exact_cut_and_sides_equal_reference(mode, d):
    jsim, want, conv, draws = reference_sharded_exact(mode, d)
    tsim = sharded_exact_port(jsim, d=d, board_exchange=mode,
                              cut_mask=cut(), node_side=SIDE)
    init = exact_port_state(jsim.init_state())
    got, got_conv = tsim.run(init, ROUNDS, draws=draws)
    assert_exact_states_equal(want, got, f"{mode}/d={d}")
    np.testing.assert_array_equal(got_conv.numpy(), conv)
    # Premise: the sides matter — without them the run differs.
    free = sharded_exact_port(jsim, d=d, board_exchange=mode,
                              cut_mask=cut())
    other, _ = free.run(exact_port_state(jsim.init_state()),
                        ROUNDS, draws=draws)
    assert not torch.equal(other.known, got.known)


def test_sharded_exact_pipelined_refuses_sides_and_takes_the_cut():
    jsim = reference_sharded_exact("ring", 2)[0]
    sided = sharded_exact_port(jsim, d=2, board_exchange="ring",
                               cut_mask=cut(), node_side=SIDE)
    with pytest.raises(ValueError, match="does not support node_side"):
        sided.run_pipelined(sided.init_state(), 2,
                            generator=torch.Generator().manual_seed(0))
    twin = sharded_exact_port(jsim, d=2, board_exchange="ring",
                              cut_mask=cut())
    jx, tx = exact_port_pair(SPARAMS, mesh(), TIME, cut_mask=cut(),
                             pipeline="1")
    js = jx.init_state(0.8, seed=4)
    draws = jax_exact_draw_seq(jx, KEY, 0, ROUNDS + 1)
    jf, jconv, _ = jx.run_pipelined(js, KEY, ROUNDS, donate=False)
    tf, tconv, _ = twin.run_pipelined(exact_port_state(js), ROUNDS,
                                      draws=draws)
    assert_exact_states_equal(jf, tf, "pipelined twin")
    assert twin._pipeline_twin()._cut is not None


@functools.lru_cache(maxsize=None)
def reference_compressed_cut():
    """The reference's single-device compressed model with the cut and
    the sides (unfused), over one burst."""
    jsim, _ = port_pair(dict(CPARAMS, drop_prob=0.1), mesh(), TIME,
                        fused_gather=False, cut_mask=cut(), node_side=SIDE)
    js = jsim.mint(jsim.init_state(), bench_burst(jsim.p.m, 0.15), 10)
    jf, jb = jsim.run_behind(js, KEY, ROUNDS, every=1, donate=False)
    return jsim, js, jf, np.asarray(jb), jax_draw_seq(jsim, KEY, 0, ROUNDS)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", ["all_gather", "all_to_all", "ring",
                                  "zoned"])
def test_sharded_compressed_cut_and_sides_equal_reference(mode, d):
    jsim, js, want, behind, draws = reference_compressed_cut()
    topo = jsim.topo
    tsim = ShardedCompressedSim(
        convert.params_from_jax_fields(dataclasses.asdict(jsim.p)),
        convert.topology_from_numpy(topo.n, topo.nbrs, topo.deg, topo.name),
        convert.timecfg_from_fields(dataclasses.asdict(jsim.t)),
        device="cpu", d=d, board_exchange=mode, cut_mask=cut(),
        node_side=SIDE)
    assert tsim._cut is not None and tsim._side is not None
    got, got_b = tsim.run_behind(port_state(js), ROUNDS, 1, draws=draws)
    assert_states_equal(want, got, f"{mode}/d={d}")
    np.testing.assert_array_equal(got_b.numpy(), behind)
    assert tsim.sync_exchange_metrics(got) == 0
    assert behind.max() > 0


def test_sharded_compressed_sparse_with_cut_equals_dense():
    jsim, js, want, behind, draws = reference_compressed_cut()
    p = convert.params_from_jax_fields(dict(dataclasses.asdict(jsim.p),
                                            sparse_cap=4))
    topo = jsim.topo
    tsim = ShardedCompressedSim(
        p, convert.topology_from_numpy(topo.n, topo.nbrs, topo.deg,
                                       topo.name),
        convert.timecfg_from_fields(dataclasses.asdict(jsim.t)),
        device="cpu", d=2, board_exchange="ring", cut_mask=cut(),
        node_side=SIDE)
    got, got_b = tsim.run_behind(port_state(js), ROUNDS, 1, draws=draws,
                                 sparse=True)
    assert_states_equal(want, got, "sparse d=2")
    np.testing.assert_array_equal(got_b.numpy(), behind)
    dense, _ = tsim.run_behind(port_state(js), ROUNDS, 1, draws=draws)
    assert_port_states_equal(dense, got, "dense vs sparse")
