"""The compressed model's telemetry runs against the JAX reference's,
exactly, and its node-sharded twin's against the single-device port:
``run_with_trace``, ``run_with_digest``, ``run_with_deltas`` and
``run_with_provenance``, dense and ``sparse="1"``, from a burst on the
bench's protocol at n = 32, fed the reference's draws
(``torch_parity``).  Every field of every stream and of the final state
must be equal.  As in ``tests/test_torch_telemetry_models.py`` (the
exact model), the port's sparse digest, delta and provenance streams are
held against the reference's dense ones (its sparse round equals its
dense round), the sparse trace against its sparse trace.

The port against itself: a traced run consumes its generator as an
untraced one does and ends in the same state; two provenance chunks
chained by ``prov=`` equal one run; the twin at d = 2, in three
exchange modes, streams what the single-device model streams.
"""

import jax
import numpy as np
import pytest
import torch

from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu_torch.ops.trace import TRACE_FIELDS
from sidecar_tpu_torch.parallel import ShardedCompressedSim
from tests.torch_parity import (
    BENCH_TIME,
    PLANES,
    assert_port_states_equal,
    assert_states_equal,
    assert_stream_equal,
    bench_burst,
    jax_draw_seq,
    np_of,
    port_pair,
)

KEY = jax.random.PRNGKey(4)
ROUNDS = 12
TRACE_CAP = 9            # the dense trace truncates its last rounds
DELTA_CAP = 24           # busy rounds overflow, quiet ones do not
BUCKETS = 16
# The bench's protocol at n = 32 after a 10 % burst, 10 % loss,
# push-pull every 5 rounds and the sweep every 10.
PARAMS = dict(n=32, services_per_node=4, cache_lines=16, fanout=3,
              budget=4, drop_prob=0.1, sparse_cap=4, fold_quorum=0.995,
              deep_sweep_every=0)
TIME = dict(BENCH_TIME, push_pull_interval_s=1.0, sweep_interval_s=2.0)


@pytest.fixture(scope="module")
def case():
    """The reference's streams (dense, and the sparse trace), and the
    port sim, burst and draws they came from."""
    jsim, tsim = port_pair(PARAMS, jtopo.erdos_renyi(PARAMS["n"], 6.0,
                                                     seed=3), TIME)
    slots = bench_burst(jsim.p.m, 0.1)
    js = jsim.mint(jsim.init_state(), slots, 10)
    tracked = tuple(int(s) for s in slots[:4])
    kw = dict(donate=False)
    want = {
        "trace": jsim.run_with_trace(js, KEY, ROUNDS, cap=TRACE_CAP, **kw),
        "trace_sparse": jsim.run_with_trace(js, KEY, ROUNDS, sparse=True,
                                            **kw),
        "digest": jsim.run_with_digest(js, KEY, ROUNDS, buckets=BUCKETS,
                                       **kw),
        "deltas": jsim.run_with_deltas(js, KEY, ROUNDS, DELTA_CAP, **kw),
        "provenance": jsim.run_with_provenance(js, KEY, ROUNDS, tracked,
                                               **kw),
    }
    return tsim, slots, jax_draw_seq(jsim, KEY, 0, ROUNDS), tracked, want


def plane_run(sim, slots, plane, tracked, rounds=ROUNDS, st=None, **kw):
    """One plane's run method from the burst (or ``st``); returns
    ``(final, stream)``."""
    if st is None:
        st = sim.mint(sim.init_state(), slots, 10)
    if plane == "trace":
        return sim.run_with_trace(st, rounds, **kw)
    if plane == "digest":
        return sim.run_with_digest(st, rounds, buckets=BUCKETS, **kw)
    if plane == "deltas":
        return sim.run_with_deltas(st, rounds, DELTA_CAP, **kw)
    return sim.run_with_provenance(st, rounds, tracked, **kw)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("plane", PLANES)
def test_compressed_plane_matches_jax(case, plane, mode):
    tsim, slots, draws, tracked, want = case
    sparse = mode == "sparse"
    kw = {"cap": TRACE_CAP} if plane == "trace" and not sparse else {}
    final, stream = plane_run(tsim, slots, plane, tracked, draws=draws,
                              sparse=sparse, **kw)
    jfinal, jstream = want["trace_sparse" if sparse and plane == "trace"
                           else plane]
    assert_states_equal(jfinal, final, f"{plane}/{mode}")
    assert_stream_equal(jstream, stream, plane, mode)
    if sparse:
        stats = np_of(tsim.last_sparse_stats)
        assert stats[0] > 0 and stats[1] > 0     # both branches ran
    if plane == "deltas":
        over = np_of(stream.overflow)
        assert over.any() and not over.all()
    if plane == "provenance":
        assert (stream.first_seen.numpy() > 0).any()


@pytest.mark.parametrize("plane", PLANES)
def test_traced_run_equals_untraced(case, plane):
    """From one generator seed, in both orders: the traced run ends in
    the untraced run's state and leaves its generator where the
    untraced run leaves it."""
    tsim, slots, _, tracked, _ = case

    def traced(g):
        return plane_run(tsim, slots, plane, tracked, generator=g)[0]

    def plain(g):
        return tsim.run_fast(tsim.mint(tsim.init_state(), slots, 10),
                             ROUNDS, generator=g)

    for runs in ((traced, plain), (plain, traced)):
        gens = [torch.Generator().manual_seed(11) for _ in runs]
        a, b = (run(g) for run, g in zip(runs, gens))
        assert_port_states_equal(a, b, plane)
        assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_provenance_chunks_chain(case):
    """Two chunks chained by ``prov=`` equal one run, and the JAX
    reference's run."""
    tsim, slots, draws, tracked, want = case
    half = ROUNDS // 2
    st, prov = plane_run(tsim, slots, "provenance", tracked, half,
                         cap=ROUNDS, draws=draws[:half])
    _, prov = plane_run(tsim, slots, "provenance", tracked, ROUNDS - half,
                        st=st, prov=prov, draws=draws[half:])
    assert prov.count == ROUNDS
    assert_stream_equal(want["provenance"][1], prov, "provenance",
                        "chained")


@pytest.mark.parametrize("mode", ["all_gather", "ring", "all_to_all"])
@pytest.mark.parametrize("plane", PLANES)
def test_sharded_twin_streams_equal_single_device(case, plane, mode):
    """The node-sharded twin at d = 2 (no pull dropped) streams what the
    single-device port streams from the same draws, dense and on its
    sparse round: equal in every field, but for the trace's record of
    which rounds ran compacted (the twin's per-shard caps are not the
    single device's)."""
    tsim, slots, draws, tracked, _ = case
    twin = ShardedCompressedSim(tsim.p, tsim.topo, tsim.t, d=2,
                                board_exchange=mode, device="cpu")
    a = plane_run(tsim, slots, plane, tracked, draws=draws)
    b = plane_run(twin, slots, plane, tracked, draws=draws)
    assert int(b[0].dropped) == 0
    assert_port_states_equal(a[0], b[0], f"sharded {mode}")
    assert_stream_equal(a[1], b[1], plane, f"sharded {mode}")
    c = plane_run(twin, slots, plane, tracked, draws=draws, sparse=True)
    assert_port_states_equal(a[0], c[0], f"sharded sparse {mode}")
    stats = np_of(twin.last_sparse_stats)
    assert stats[0] > 0 and stats[0] + stats[1] == ROUNDS
    if plane == "trace":
        keep = [i for i, f in enumerate(TRACE_FIELDS)
                if f not in ("sparse", "overflow")]
        np.testing.assert_array_equal(np_of(c[1].rec)[:, keep],
                                      np_of(a[1].rec)[:, keep])
        assert np_of(c[1].rec)[:, TRACE_FIELDS.index("sparse")].sum() \
            == stats[0]
    else:
        assert_stream_equal(a[1], c[1], plane, f"sharded sparse {mode}")
