"""The exact model's telemetry runs against the JAX reference's,
exactly: ``run_with_trace``, ``run_with_digest``, ``run_with_deltas``
and ``run_with_provenance``, dense and ``sparse="1"``, fed the
reference's draws (``torch_parity``).  Every field of every stream —
trace records (a buffer that truncates), digest records, delta batches
(busy rounds overflow, quiet ones do not), ``ProvTrace`` fields — and
the final state must be equal; the float32 convergence curve is held
within 1e-6 of the reference's, as in ``tests/test_torch_exact.py``,
and equal to the port's untraced curve.  (The compressed model and its
sharded twin: ``tests/test_torch_telemetry_compressed.py``.)

The reference's sparse round equals its dense round bit for bit, so a
sparse digest, delta or provenance stream of the port is held against
the reference's dense stream; the trace differs in its ``sparse`` and
``overflow`` columns and is held against the reference's sparse trace.
Each reference run happens once, in a module-scoped fixture.

The port against itself: a traced run consumes its generator as an
untraced one does and ends in the same state and curve; two provenance
chunks chained by ``prov=`` equal one run.
"""

import jax
import numpy as np
import pytest
import torch

from sidecar_tpu.ops import provenance as jprov
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu_torch.ops import provenance as tprov
from tests.torch_parity import (
    PLANES,
    assert_exact_states_equal,
    assert_port_states_equal,
    assert_stream_equal,
    exact_port_pair,
    jax_exact_draw_seq,
    np_of,
)

KEY = jax.random.PRNGKey(4)
ROUNDS = 12
TRACE_CAP = 9            # the dense trace truncates its last rounds
DELTA_CAP = 24           # busy rounds overflow, quiet ones do not
BUCKETS = 16
# A cold start with a tenth of the slots live (so the sparse round's
# sender frontier fits its cap on some rounds), 10 % loss, push-pull
# every 10 rounds.
PARAMS = dict(n=24, services_per_node=4, fanout=3, budget=6,
              drop_prob=0.1, sparse_cap=6)
TIME = dict(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)


def start(tsim):
    return tsim.init_state(0.1, seed=1)


@pytest.fixture(scope="module")
def case():
    """The reference's streams (dense, and the sparse trace) and the
    port sim and draws they came from."""
    jsim, tsim = exact_port_pair(PARAMS, jtopo.erdos_renyi(PARAMS["n"], 6.0,
                                                           seed=3), TIME)
    js = jsim.init_state(0.1, seed=1)
    tracked = jprov.default_tracked(jsim.p.m, 4)
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
    return tsim, jax_exact_draw_seq(jsim, KEY, 0, ROUNDS), tracked, want


def plane_run(tsim, plane, st, rounds, tracked, **kw):
    """One plane's run method; returns ``(final, stream, conv)``."""
    if plane == "trace":
        return tsim.run_with_trace(st, rounds, **kw)
    if plane == "digest":
        return tsim.run_with_digest(st, rounds, buckets=BUCKETS, **kw)
    if plane == "deltas":
        return tsim.run_with_deltas(st, rounds, DELTA_CAP, **kw)
    return tsim.run_with_provenance(st, rounds, tracked, **kw)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("plane", PLANES)
def test_exact_plane_matches_jax(case, plane, mode):
    tsim, draws, tracked, want = case
    sparse = mode == "sparse"
    kw = {"cap": TRACE_CAP} if plane == "trace" and not sparse else {}
    final, stream, conv = plane_run(tsim, plane, start(tsim), ROUNDS,
                                    tracked, draws=draws, sparse=sparse,
                                    **kw)
    jfinal, jstream, jconv = want["trace_sparse" if sparse and
                                  plane == "trace" else plane]
    assert_exact_states_equal(jfinal, final, f"{plane}/{mode}")
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), rtol=0,
                               atol=1e-6)
    assert_stream_equal(jstream, stream, plane, mode)
    if sparse:
        stats = np_of(tsim.last_sparse_stats)
        assert stats[0] > 0 and stats[1] > 0     # both branches ran
    if plane == "trace":
        assert stream.count == ROUNDS and stream.overflow == (not sparse)
    if plane == "deltas":
        over = np_of(stream.overflow)
        assert over.any() and not over.all()


@pytest.mark.parametrize("plane", PLANES)
def test_traced_run_equals_untraced(case, plane):
    """From one generator seed, in both orders: the traced run ends in
    the untraced run's state and curve and leaves its generator where
    the untraced run leaves it."""
    tsim, _, tracked, _ = case

    def traced(g):
        final, _, conv = plane_run(tsim, plane, start(tsim), ROUNDS,
                                   tracked, generator=g)
        return final, conv

    def plain(g):
        return tsim.run(start(tsim), ROUNDS, generator=g)

    for runs in ((traced, plain), (plain, traced)):
        gens = [torch.Generator().manual_seed(11) for _ in runs]
        (a, conv_a), (b, conv_b) = (run(g) for run, g in zip(runs, gens))
        assert torch.equal(conv_a, conv_b)
        assert_port_states_equal(a, b, plane)
        assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_provenance_chunks_chain(case):
    """Two chunks chained by ``prov=`` equal one run, and the JAX
    reference's run."""
    tsim, draws, tracked, want = case
    half = ROUNDS // 2
    st, prov, _ = tsim.run_with_provenance(start(tsim), half, tracked,
                                           cap=ROUNDS, draws=draws[:half])
    _, prov, _ = tsim.run_with_provenance(st, ROUNDS - half, tracked,
                                          prov=prov, draws=draws[half:])
    assert prov.count == ROUNDS
    assert_stream_equal(want["provenance"][1], prov, "provenance",
                        "chained")


def test_tracked_slots_are_checked(case):
    tsim, draws = case[:2]
    st = tsim.init_state()
    with pytest.raises(ValueError, match="at least one"):
        tsim.run_with_provenance(st, 1, (), draws=draws)
    with pytest.raises(ValueError, match="outside"):
        tsim.run_with_provenance(st, 1, (tsim.p.m,), draws=draws)
    assert tprov.default_tracked(tsim.p.m, 2) == (0, tsim.p.m - 1)
