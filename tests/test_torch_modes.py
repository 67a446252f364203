"""The port's execution modes against the JAX reference, exactly: the
sparse-frontier round, the software-pipelined round, the per-node tick
cadence and the staggered rounds, on both models, with chunk resume.

* Runs: the port and the reference from the same minted (compressed) or
  cold-start (exact) state, the port fed the reference's draws
  (``torch_parity``; a pipelined run takes one more, for the prime).
  Every state field, every metric sample and the sparse stats must be
  equal.  The sparse runs use a ``sparse_cap`` small enough that early
  rounds overflow to the dense round and late rounds run compacted; a
  cap of 1 makes nearly every round overflow.
* The port against itself: sparse equals dense, chunked equals
  straight (the sparse stats accumulated; the pipelined carry handed
  on), the stepwise probes equal the runs.
* The pieces: ``compact_rows``, the publish selection's plain version
  with ``row_ids``, ``select_messages``/``record_transmissions`` with
  ``row_ids``, the arbiter, and the mode and cadence resolution.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.ops import gossip as jgossip
from sidecar_tpu.ops import sparse as jsparse
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.ops.kernels.publish_gather import publish_board_xla
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.ops import gossip as tgossip
from sidecar_tpu_torch.ops import pipeline as tpipeline
from sidecar_tpu_torch.ops import sparse as tsparse
from sidecar_tpu_torch.ops.kernels import publish_gather as tpg
from sidecar_tpu_torch.ops.status import TOMBSTONE
from sidecar_tpu_torch.parallel import ShardedCompressedSim
from tests.torch_parity import (
    BENCH_TIME,
    assert_exact_states_equal,
    assert_states_equal,
    bench_burst,
    exact_port_pair,
    jax_draw_seq,
    jax_exact_draw_seq,
    port_pair,
    port_topology,
)

KEY = jax.random.PRNGKey(0)

# The compressed model: the bench's protocol constants at n = 48.
N = 48
PARAMS = dict(n=N, services_per_node=4, cache_lines=32, fanout=3, budget=6,
              fold_quorum=0.995, deep_sweep_every=0)
ROUNDS, EVERY = 30, 5
# The exact model: a cold start at n = 32, half the slots live, refresh
# off, push-pull every 10 rounds.
XN = 32
XPARAMS = dict(n=XN, services_per_node=4, fanout=3, budget=6)
XTIME = dict(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
XROUNDS = 40

# Per-node cadences (seeded): periods in {1, 2, 4}, phases in [0, 4).
_rng = np.random.default_rng(12)
PERIODS = _rng.choice([1, 2, 4], N).astype(np.int32)
PHASES = _rng.integers(0, 4, N).astype(np.int32)
XPERIODS = PERIODS[:XN].copy()
XPHASES = PHASES[:XN].copy()


def er(n):
    return jtopo.erdos_renyi(n, 6.0, seed=3)


def minted(jsim, tsim):
    slots = bench_burst(jsim.p.m, 0.1)
    return jsim.mint(jsim.init_state(), slots, 10), \
        tsim.mint(tsim.init_state(), slots, 10)


def cold(jsim, tsim):
    return jsim.init_state(0.5, seed=1), tsim.init_state(0.5, seed=1)


def assert_port_equal(a, b, ctx=""):
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for f in x:
        np.testing.assert_array_equal(x[f], y[f], err_msg=f"{ctx} {f}")


def stats_of(sim):
    return np.asarray(sim.last_sparse_stats)


# -- the compressed model -------------------------------------------------------


@pytest.mark.parametrize("cap,drop", [(8, 0.0), (8, 0.1), (1, 0.0)],
                         ids=["cap8", "cap8-loss", "overflow"])
def test_compressed_sparse_matches_jax(cap, drop):
    jsim, tsim = port_pair(dict(PARAMS, sparse_cap=cap, drop_prob=drop),
                           er(N), BENCH_TIME)
    js, ts = minted(jsim, tsim)
    draws = jax_draw_seq(jsim, KEY, 0, ROUNDS)
    jf, jb = jsim.run_behind(js, KEY, ROUNDS, every=EVERY, donate=False,
                             sparse=True)
    tf, tb = tsim.run_behind(ts, ROUNDS, EVERY, draws=draws, sparse=True)
    assert_states_equal(jf, tf, "sparse")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    stats = stats_of(tsim)
    np.testing.assert_array_equal(stats, stats_of(jsim))
    assert stats[0] + stats[1] == ROUNDS
    if cap == 1:
        assert stats[1] > stats[0]
    else:
        assert stats[0] > 0 and stats[1] > 0     # both branches ran
    # Sparse equals dense.
    df, db = tsim.run_behind(ts, ROUNDS, EVERY, draws=draws)
    assert tsim.last_sparse_stats is None
    assert_port_equal(df, tf, "dense vs sparse")
    assert torch.equal(db, tb)


def test_compressed_sparse_defences_match_jax():
    """The compacted board's admission with the future bound and the
    per-origin budget on (each compacted row's origin is its global
    id), on a burst with tombstones."""
    time_kw = dict(BENCH_TIME, future_fudge_s=0.4, origin_budget=1)
    jsim, tsim = port_pair(dict(PARAMS, sparse_cap=8), er(N), time_kw)
    js, ts = minted(jsim, tsim)
    tombs = bench_burst(jsim.p.m, 0.02, seed=9)
    js = jsim.mint(js, tombs, 12, TOMBSTONE)
    ts = tsim.mint(ts, tombs, 12, TOMBSTONE)
    draws = jax_draw_seq(jsim, KEY, 0, 60)
    jf, jb = jsim.run_behind(js, KEY, 60, every=10, donate=False,
                             sparse=True)
    tf, tb = tsim.run_behind(ts, 60, 10, draws=draws, sparse=True)
    assert_states_equal(jf, tf, "sparse, defences on")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    stats = stats_of(tsim)
    np.testing.assert_array_equal(stats, stats_of(jsim))
    assert stats[0] > 0 and stats[1] > 0


def test_compressed_sparse_chunked_equals_straight():
    _, tsim = port_pair(dict(PARAMS, sparse_cap=8), er(N), BENCH_TIME)
    ts = tsim.mint(tsim.init_state(), bench_burst(tsim.p.m, 0.1), 10)
    gen = torch.Generator().manual_seed(3)
    draws = [tsim.draw(gen, r) for r in range(1, ROUNDS + 1)]
    sf, sb = tsim.run_behind(ts, ROUNDS, EVERY, draws=draws, sparse=True)
    straight = tsim.last_sparse_stats
    st, acc, curve = ts, tsparse.zero_stats(), []
    for lo in range(0, ROUNDS, 10):
        st, b = tsim.run_behind(st, 10, EVERY, draws=draws[lo:lo + 10],
                                start_round=lo, sparse=True)
        acc = tsparse.accumulate_stats(acc, tsim.last_sparse_stats)
        curve.append(b)
    assert_port_equal(st, sf, "chunked")
    assert torch.equal(torch.cat(curve), sb)
    assert torch.equal(acc, straight)
    # The stepwise probe, round by round, with the same stats.
    st, acc = ts, tsparse.zero_stats()
    for d in draws:
        st, s = tsim.step_sparse(st, draws=d)
        acc = tsparse.accumulate_stats(acc, s)
    assert_port_equal(st, sf, "stepwise")
    assert torch.equal(acc, straight)


@pytest.mark.parametrize("drop", [0.0, 0.1], ids=["lossless", "loss"])
def test_compressed_pipelined_matches_jax(drop):
    jsim, tsim = port_pair(dict(PARAMS, drop_prob=drop), er(N), BENCH_TIME)
    js, ts = minted(jsim, tsim)
    draws = jax_draw_seq(jsim, KEY, 0, ROUNDS + 1)
    jf, jc, jinf = jsim.run_pipelined(js, KEY, ROUNDS, EVERY, donate=False)
    tf, tc, tinf = tsim.run_pipelined(ts, ROUNDS, EVERY, draws=draws)
    assert_states_equal(jf, tf, "pipelined")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tinf.round_idx == ROUNDS + 1
    for got, want in zip(tinf.publish, jinf):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The lockstep run differs (one round stale) but converges too.
    lf, lc = tsim.run(ts, ROUNDS, EVERY, draws=draws)
    assert not torch.equal(lc, tc)
    # run(pipeline=True) is run_pipelined.
    pf, pc = tsim.run(ts, ROUNDS, EVERY, draws=draws, pipeline=True)
    assert_port_equal(pf, tf, "run(pipeline=True)")
    assert torch.equal(pc, tc)


def test_compressed_pipelined_chunked_equals_straight():
    _, tsim = port_pair(dict(PARAMS, drop_prob=0.1), er(N), BENCH_TIME)
    ts = tsim.mint(tsim.init_state(), bench_burst(tsim.p.m, 0.1), 10)
    gen = torch.Generator().manual_seed(4)
    draws = [tsim.draw(gen, r) for r in range(1, ROUNDS + 2)]
    sf, sc, sinf = tsim.run_pipelined(ts, ROUNDS, EVERY, draws=draws)
    half = ROUNDS // 2
    st, c1, inf = tsim.run_pipelined(ts, half, EVERY,
                                     draws=draws[:half + 1])
    st, c2, inf = tsim.run_pipelined(st, half, EVERY, inflight=inf,
                                     draws=draws[half + 1:],
                                     start_round=half)
    assert_port_equal(st, sf, "chunked")
    assert torch.equal(torch.cat([c1, c2]), sc)
    for a, b in zip(inf.publish, sinf.publish):
        assert torch.equal(a, b)
    # The stepwise probes, and the generator-driven run: the same draws
    # in the same order as the lockstep runs take them.
    st, inf = tsim.prime_pipeline(ts, draws=draws[0])
    for d in draws[1:]:
        st, inf = tsim.step_pipelined(st, inf, draws=d)
    assert_port_equal(st, sf, "stepwise")
    gf, _ = tsim.run_fast_pipelined(
        ts, ROUNDS, generator=torch.Generator().manual_seed(4))
    assert_port_equal(gf, sf, "generator")


@functools.lru_cache(maxsize=None)
def compressed_cadence_run(case):
    """The reference's run and the port's for one cadence case:
    ``scalar`` (lockstep), ``vector`` (sparse, cap 8) or ``stagger``
    (pipelined, with a vector cadence on top)."""
    topo, kw, params = er(N), {}, dict(PARAMS)
    if case == "scalar":
        kw = dict(tick_period=2, tick_phase=1)
    elif case == "vector":
        kw = dict(tick_period=PERIODS, tick_phase=PHASES)
        params["sparse_cap"] = 8
    else:
        topo = jtopo.with_stagger(topo, 3, seed=5)
        kw = dict(tick_period=PERIODS, tick_phase=PHASES)
    jsim, tsim = port_pair(params, topo, BENCH_TIME, **kw)
    js, ts = minted(jsim, tsim)
    draws = jax_draw_seq(jsim, KEY, 0, ROUNDS + 1)
    if case == "stagger":
        jf, jb, _ = jsim.run_pipelined(js, KEY, ROUNDS, EVERY, donate=False)
        tf, tb, _ = tsim.run_pipelined(ts, ROUNDS, EVERY, draws=draws)
    else:
        sparse = case == "vector"
        jf, jb = jsim.run(js, KEY, ROUNDS, EVERY, donate=False,
                          sparse=sparse)
        tf, tb = tsim.run(ts, ROUNDS, EVERY, draws=draws[:ROUNDS],
                          sparse=sparse)
    return jsim, tsim, ts, draws, jf, np.asarray(jb), tf, tb


@pytest.mark.parametrize("case", ["scalar", "vector", "stagger"])
def test_compressed_cadence_matches_jax(case):
    jsim, tsim, ts, draws, jf, jb, tf, tb = compressed_cadence_run(case)
    assert_states_equal(jf, tf, case)
    np.testing.assert_array_equal(tb.numpy(), jb)
    # Premise: the gate changes the trajectory.
    _, plain = port_pair(PARAMS, er(N), BENCH_TIME)
    pf = plain.run_fast(ts, ROUNDS, draws=draws[:ROUNDS])
    assert not torch.equal(pf.cache_val, tf.cache_val)


def test_sharded_cadence_matches_jax_single_device():
    """The sharded twin at d = 2 with a per-node cadence equals the
    reference's single-device model (its sparse run, which equals its
    dense one)."""
    jsim, tsim, ts, draws, jf, jb, _, _ = compressed_cadence_run("vector")
    sim = ShardedCompressedSim(
        tsim.p, port_topology(er(N)), tsim.t, d=2, board_exchange="ring",
        device="cpu", tick_period=PERIODS, tick_phase=PHASES)
    sf, sb = sim.run(ts, ROUNDS, EVERY, draws=draws[:ROUNDS])
    assert_states_equal(jf, sf, "sharded d=2")
    np.testing.assert_array_equal(sb.numpy(), jb)


# -- the exact model -----------------------------------------------------------


@pytest.mark.parametrize("cap,drop", [(8, 0.0), (8, 0.1), (1, 0.0)],
                         ids=["cap8", "cap8-loss", "overflow"])
def test_exact_sparse_matches_jax(cap, drop):
    jsim, tsim = exact_port_pair(dict(XPARAMS, sparse_cap=cap,
                                      drop_prob=drop), er(XN), XTIME)
    js, ts = cold(jsim, tsim)
    draws = jax_exact_draw_seq(jsim, KEY, 0, XROUNDS)
    jf, jc = jsim.run(js, KEY, XROUNDS, donate=False, sparse=True)
    tf, tc = tsim.run(ts, XROUNDS, draws=draws, donate=False, sparse=True)
    assert_exact_states_equal(jf, tf, "sparse")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    stats = stats_of(tsim)
    np.testing.assert_array_equal(stats, stats_of(jsim))
    assert stats[0] + stats[1] == XROUNDS
    if cap == 1:
        assert stats[1] > stats[0]
    else:
        assert stats[0] > 0 and stats[1] > 0
    df, dc = tsim.run(ts, XROUNDS, draws=draws, donate=False)
    assert_port_equal(df, tf, "dense vs sparse")
    assert torch.equal(dc, tc)


def test_exact_sparse_defences_match_jax():
    """The compacted senders' budget exemption (each row's sender is its
    global id) with the future bound on, and records expiring into
    SUSPECT and TOMBSTONE."""
    time_kw = dict(XTIME, future_fudge_s=0.4, origin_budget=1,
                   alive_lifespan_s=8.0, suspicion_window_s=2.0)
    jsim, tsim = exact_port_pair(dict(XPARAMS, sparse_cap=8), er(XN),
                                 time_kw)
    js, ts = cold(jsim, tsim)
    draws = jax_exact_draw_seq(jsim, KEY, 0, 60)
    jf, jc = jsim.run(js, KEY, 60, donate=False, sparse=True)
    tf, tc = tsim.run(ts, 60, draws=draws, donate=False, sparse=True)
    assert_exact_states_equal(jf, tf, "sparse, defences on")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    stats = stats_of(tsim)
    np.testing.assert_array_equal(stats, stats_of(jsim))
    assert stats[0] > 0 and stats[1] > 0
    assert int(((tf.known & 7) == TOMBSTONE).sum()) > 0


def test_exact_sparse_chunked_equals_straight():
    _, tsim = exact_port_pair(dict(XPARAMS, sparse_cap=8), er(XN), XTIME)
    ts = tsim.init_state(0.5, seed=1)
    gen = torch.Generator().manual_seed(5)
    draws = [tsim.draw(gen, r) for r in range(1, XROUNDS + 1)]
    sf, sc = tsim.run(ts, XROUNDS, draws=draws, donate=False, sparse=True)
    straight = tsim.last_sparse_stats
    assert straight[0] > 0
    st, acc = ts, tsparse.zero_stats()
    for lo in range(0, XROUNDS, 10):
        st = tsim.run_fast(st, 10, draws=draws[lo:lo + 10], donate=False,
                           start_round=lo, sparse=True)
        acc = tsparse.accumulate_stats(acc, tsim.last_sparse_stats)
    assert_port_equal(st, sf, "chunked")
    assert torch.equal(acc, straight)
    st, acc = ts, tsparse.zero_stats()
    for d in draws:
        st, s = tsim.step_sparse(st, draws=d)
        acc = tsparse.accumulate_stats(acc, s)
    assert_port_equal(st, sf, "stepwise")
    assert torch.equal(acc, straight)


@pytest.mark.parametrize("drop", [0.0, 0.1], ids=["lossless", "loss"])
def test_exact_pipelined_matches_jax(drop):
    jsim, tsim = exact_port_pair(dict(XPARAMS, drop_prob=drop), er(XN),
                                 XTIME)
    js, ts = cold(jsim, tsim)
    draws = jax_exact_draw_seq(jsim, KEY, 0, XROUNDS + 1)
    jf, jc, jinf = jsim.run_pipelined(js, KEY, XROUNDS, donate=False)
    tf, tc, tinf = tsim.run_pipelined(ts, XROUNDS, draws=draws,
                                      donate=False)
    assert_exact_states_equal(jf, tf, "pipelined")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for got, want in zip(tinf.publish, jinf):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pf, pc = tsim.run(ts, XROUNDS, draws=draws, donate=False,
                      pipeline=True)
    assert_port_equal(pf, tf, "run(pipeline=True)")
    assert torch.equal(pc, tc)


def test_exact_pipelined_chunked_equals_straight():
    _, tsim = exact_port_pair(dict(XPARAMS, drop_prob=0.1), er(XN), XTIME)
    ts = tsim.init_state(0.5, seed=1)
    gen = torch.Generator().manual_seed(6)
    draws = [tsim.draw(gen, r) for r in range(1, XROUNDS + 2)]
    sf, sc, sinf = tsim.run_pipelined(ts, XROUNDS, draws=draws,
                                      donate=False)
    half = XROUNDS // 2
    st, inf = tsim.run_fast_pipelined(ts, half, draws=draws[:half + 1],
                                      donate=False)
    st, inf = tsim.run_fast_pipelined(st, half, inflight=inf,
                                      draws=draws[half + 1:],
                                      start_round=half)
    assert_port_equal(st, sf, "chunked")
    for a, b in zip(inf.publish, sinf.publish):
        assert torch.equal(a, b)
    st, inf = tsim.prime_pipeline(ts, draws=draws[0])
    for d in draws[1:]:
        st, inf = tsim.step_pipelined(st, inf, draws=d)
    assert_port_equal(st, sf, "stepwise")
    # The probes leave their input intact.
    assert_port_equal(ts, tsim.init_state(0.5, seed=1), "input")


@pytest.mark.parametrize("case", ["scalar", "vector", "stagger"])
def test_exact_cadence_matches_jax(case):
    topo, kw, params = er(XN), {}, dict(XPARAMS)
    if case == "scalar":
        kw = dict(tick_period=3, tick_phase=2)
    elif case == "vector":
        kw = dict(tick_period=XPERIODS, tick_phase=XPHASES)
        params["sparse_cap"] = 8
    else:
        topo = jtopo.with_stagger(topo, 2, seed=7)
    jsim, tsim = exact_port_pair(params, topo, XTIME, **kw)
    js, ts = cold(jsim, tsim)
    draws = jax_exact_draw_seq(jsim, KEY, 0, XROUNDS + 1)
    if case == "stagger":
        jf, jc, _ = jsim.run_pipelined(js, KEY, XROUNDS, donate=False)
        tf, tc, _ = tsim.run_pipelined(ts, XROUNDS, draws=draws,
                                       donate=False)
    else:
        sparse = case == "vector"
        jf, jc = jsim.run(js, KEY, XROUNDS, donate=False, sparse=sparse)
        tf, tc = tsim.run(ts, XROUNDS, draws=draws[:XROUNDS], donate=False,
                          sparse=sparse)
    assert_exact_states_equal(jf, tf, case)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # Premise: the gate changes the trajectory.
    _, plain = exact_port_pair(XPARAMS, er(XN), XTIME)
    _, pc = plain.run(ts, XROUNDS, draws=draws[:XROUNDS], donate=False)
    assert not torch.equal(pc, tc)


# -- the pieces ----------------------------------------------------------------


@pytest.mark.parametrize("n,cap,density", [(6, 4, 0.5), (40, 8, 0.1),
                                           (40, 8, 0.6), (40, 40, 1.0),
                                           (17, 5, 0.0)])
def test_compact_rows_matches_jax(n, cap, density):
    rng = np.random.default_rng(n * 100 + cap)
    mask = rng.random(n) < density
    want = jsparse.compact_rows(jnp.asarray(mask), cap)
    got = tsparse.compact_rows(torch.as_tensor(mask), cap)
    for name, g, w in zip(("idx", "row", "valid", "pos"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    # The contract itself: the first cap set rows ascending, padded
    # with n, and the inverse map on them.
    idx, row, valid, pos = (x.numpy() for x in got)
    first = np.nonzero(mask)[0][:cap]
    np.testing.assert_array_equal(idx[:len(first)], first)
    assert (idx[len(first):] == n).all() and valid.sum() == len(first)
    assert (row == np.minimum(idx, n - 1)).all()
    assert (pos[first] == np.arange(len(first))).all()


def tied_cache(rng, c, k, occupancy=0.8):
    cv = np.where(rng.random((c, k)) < 0.5, 80 << 3,
                  rng.integers(1, 200, (c, k)) << 3).astype(np.int32)
    cs = rng.integers(0, 1000, (c, k)).astype(np.int32)
    occ = rng.random((c, k)) < occupancy
    return (np.where(occ, cv, 0).astype(np.int32),
            np.where(occ, cs, -1).astype(np.int32),
            rng.integers(0, 4, (c, k)).astype(np.int8))


@pytest.mark.parametrize("label", ["pads", "one-row", "arange", "cap"])
def test_publish_row_ids_matches_xla(label):
    """The publish selection's plain version with ``row_ids`` against
    the reference's ``publish_board_xla(row_ids=)``: ascending ids with
    pad ids n, a single row, ``arange(N)`` (which is ``row_offset=0``),
    and a compacted block of a wider cluster."""
    rng = np.random.default_rng(len(label))
    n, k = 100, 32
    c = {"pads": 12, "one-row": 1, "arange": n, "cap": 40}[label]
    cache = tied_cache(rng, c, k)
    if label == "arange":
        ids = np.arange(n, dtype=np.int32)
    else:
        real = np.sort(rng.choice(n, max(1, c - 3) if c > 1 else 1,
                                  replace=False))
        ids = np.full(c, n, np.int32)
        ids[:len(real)] = real
    kw = dict(budget=6, limit=4, fanout=3, cache_lines=k)
    want = publish_board_xla(*(jnp.asarray(a) for a in cache),
                             row_ids=jnp.asarray(ids), **kw)
    got = tpg.publish_board_torch(*(torch.as_tensor(a) for a in cache),
                                  row_ids=torch.as_tensor(ids), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if label == "arange":
        plain = tpg.publish_board_torch(*(torch.as_tensor(a)
                                          for a in cache), **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("m", [96, 5000], ids=["one-stage", "two-stage"])
def test_select_and_record_row_ids_match_jax(m):
    """``select_messages`` on compacted rows with their global ids, and
    ``record_transmissions`` charging them back into the full ``sent``,
    against the reference — with pad rows (id n) and the real row n - 1
    in the batch, whose cells the pads must not touch."""
    rng = np.random.default_rng(m)
    n, c, budget, limit, fanout = 24, 8, 5, 6, 3
    known = np.where(rng.random((n, m)) < 0.3,
                     rng.integers(1, 6, (n, m)) << 3, 0).astype(np.int32)
    sent = rng.integers(0, 8, (n, m)).astype(np.int8)
    ids = np.full(c, n, np.int32)
    ids[:5] = [2, 7, 11, 20, n - 1]
    rows = np.minimum(ids, n - 1)
    known_c = np.where((ids < n)[:, None], known[rows], 0)
    want = jgossip.select_messages(jnp.asarray(known_c),
                                   jnp.asarray(sent[rows]), budget, limit,
                                   row_ids=jnp.asarray(ids))
    got = tgossip.select_messages(torch.as_tensor(known_c),
                                  torch.as_tensor(sent[rows]), budget,
                                  limit, row_ids=torch.as_tensor(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    svc, msg = got
    assert (msg[5:] == 0).all() and (msg[4] > 0).any()
    want_sent = jgossip.record_transmissions(
        jnp.asarray(sent), jnp.asarray(svc.numpy()),
        jnp.asarray(msg.numpy()), fanout, limit, row_ids=jnp.asarray(ids))
    got_sent = tgossip.record_transmissions(
        torch.as_tensor(sent), svc, msg, fanout,
        row_ids=torch.as_tensor(ids))
    np.testing.assert_array_equal(got_sent.numpy(), np.asarray(want_sent))


# -- the arbiter -----------------------------------------------------------------


class TestArbiter:
    def test_hysteresis_no_thrash_on_oscillating_census(self):
        arb = tsparse.SparseArbiter("auto", enter_below=100.0,
                                    exit_above=200.0)
        assert arb.sparse is False
        assert arb.update_census(90.0) is True
        for census in (150.0, 99.0, 180.0, 120.0, 101.0):
            assert arb.update_census(census) is True
        assert arb.run_switches == 1
        assert arb.update_census(250.0) is False
        assert arb.run_switches == 2
        for census in (150.0, 199.0, 101.0):
            assert arb.update_census(census) is False
        assert arb.run_switches == 2

    def test_overflow_forces_dense_with_cooldown(self):
        arb = tsparse.SparseArbiter("auto", enter_below=100.0, cooldown=2)
        arb.update_census(50.0)
        assert arb.sparse is True
        arb.record_chunk(10, torch.tensor([7, 3, 42], dtype=torch.int32))
        assert arb.sparse is False
        assert arb.run_overflow_rounds == 3
        assert arb.update_census(10.0) is False
        assert arb.update_census(10.0) is False
        assert arb.update_census(10.0) is True

    def test_pinned_modes_ignore_census(self):
        always = tsparse.SparseArbiter("1", enter_below=1.0)
        assert always.sparse is True
        assert always.update_census(1e12) is True
        never = tsparse.SparseArbiter("0", enter_below=1e12)
        assert never.sparse is False
        assert never.update_census(0.0) is False

    def test_dispatch_kwargs_always_explicit(self):
        assert tsparse.SparseArbiter("0", enter_below=1.0) \
            .dispatch_kwargs() == {"sparse": False}
        assert tsparse.SparseArbiter("1", enter_below=1.0) \
            .dispatch_kwargs() == {"sparse": True}
        auto = tsparse.SparseArbiter("auto", enter_below=10.0)
        assert auto.dispatch_kwargs() == {"sparse": False}
        auto.update_census(1.0)
        assert auto.dispatch_kwargs() == {"sparse": True}
        # An explicit False runs the dense program on a sim whose own
        # mode is "1".
        _, tsim = port_pair(dict(PARAMS, n=8, services_per_node=2),
                            jtopo.complete(8), {}, sparse="1")
        tsim.run_fast(tsim.init_state(), 2,
                      generator=torch.Generator().manual_seed(0),
                      **tsparse.SparseArbiter(
                          "0", enter_below=1.0).dispatch_kwargs())
        assert tsim.last_sparse_stats is None

    def test_per_run_reset_and_same_decisions_as_jax(self):
        arb = tsparse.SparseArbiter.for_census("auto", 100)
        ref = jsparse.SparseArbiter.for_census("auto", 100)
        censuses = (500.0, 90.0, 150.0, 250.0, 80.0, 40.0)
        chunks = (None, [10, 0, 33], [6, 4, 90], None, [10, 0, 12], None)
        for census, stats in zip(censuses, chunks):
            got = arb.update_census(census)
            assert got == ref.update_census(census)
            arb.record_chunk(10, None if stats is None
                             else torch.tensor(stats, dtype=torch.int32))
            ref.record_chunk(10, None if stats is None
                             else np.asarray(stats, np.int32))
            assert arb.dispatch_kwargs() == ref.dispatch_kwargs()
        assert arb.snapshot() == ref.snapshot()
        assert arb.snapshot()["frontier_hwm"] == 90
        arb.new_trajectory()
        assert arb.snapshot() == {"sparse_rounds": 0, "dense_rounds": 0,
                                  "overflow_rounds": 0, "switches": 0,
                                  "frontier_hwm": 0}

    def test_invalid_band_rejected(self):
        with pytest.raises(ValueError, match="hysteresis|enter"):
            tsparse.SparseArbiter("auto", enter_below=100.0,
                                  exit_above=50.0)
        with pytest.raises(ValueError, match="mode"):
            tsparse.SparseArbiter("sometimes", enter_below=1.0)


# -- mode and cadence resolution -------------------------------------------------


def test_mode_resolution():
    for resolve in (tsparse.resolve_sparse, tpipeline.resolve_pipeline):
        assert resolve(None) == "auto"
        assert resolve("on") == "1" and resolve("off") == "0"
        assert resolve("0") == "0" and resolve("auto") == "auto"
        with pytest.raises(ValueError, match="mode"):
            resolve("fast")
    for request in (tsparse.resolve_request, tpipeline.resolve_request):
        assert request("auto", None) is False
        assert request("1", None) is True
        assert request("1", None, False) is False   # degrades
        assert request("auto", True) is True
        assert request("1", False) is False
        with pytest.raises(ValueError, match="disabled or unsupported"):
            request("0", True)
        with pytest.raises(ValueError, match="disabled or unsupported"):
            request("auto", True, False)


@pytest.mark.parametrize("model", ["compressed", "exact"])
def test_composition_errors(model):
    if model == "compressed":
        _, sim = port_pair(dict(PARAMS, n=8, services_per_node=2),
                           jtopo.complete(8), {}, sparse="0")
        st = sim.init_state()
    else:
        _, sim = exact_port_pair(dict(XPARAMS, n=8), jtopo.complete(8), {},
                                 sparse="0")
        st = sim.init_state()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="disabled or unsupported"):
        sim.run_fast(st, 1, generator=gen, sparse=True)
    with pytest.raises(ValueError, match="disabled or unsupported"):
        sim.step_sparse(st, generator=gen)
    sim._sparse_mode = "auto"
    with pytest.raises(ValueError, match="does not compose"):
        sim.run_fast(st, 1, generator=gen, sparse=True, pipeline=True)
    sim._sparse_mode = "1"
    with pytest.raises(ValueError, match="does not compose"):
        sim.run_fast(st, 1, generator=gen, pipeline=True)
    sim._pipeline_mode = "0"
    with pytest.raises(ValueError, match="disabled or unsupported"):
        sim.run_fast_pipelined(st, 1, generator=gen)


def test_cadence_resolution():
    dev = torch.device("cpu")
    assert common.resolve_cadence(None, None, 4, dev) == (1, 0)
    assert common.resolve_cadence(1, 3, 4, dev) == (1, 0)
    assert common.resolve_cadence(2, 1, 4, dev) == (2, 1)
    per, pha = common.resolve_cadence([1, 2, 4, 2], 1, 4, dev)
    assert per.dtype == torch.int32 and per.tolist() == [1, 2, 4, 2]
    assert pha.tolist() == [1]
    with pytest.raises(ValueError, match="≥ 1"):
        common.resolve_cadence(0, 0, 4, dev)
    with pytest.raises(ValueError, match="≥ 1"):
        common.resolve_cadence([1, 0, 1, 1], 0, 4, dev)
    with pytest.raises(ValueError, match="length-4"):
        common.resolve_cadence([1, 2], 0, 4, dev)
    # The gate itself against the reference's.
    dst = np.arange(24, dtype=np.int32).reshape(8, 3) % 8
    per = np.array([1, 2, 3, 4, 2, 1, 3, 5], np.int32)
    pha = np.array([0, 1, 2, 3, -1, 0, 7, 2], np.int32)
    for r in range(6):
        want = jgossip.cadence_gate(jnp.asarray(dst), r, jnp.asarray(per),
                                    jnp.asarray(pha))
        got = tgossip.cadence_gate(torch.as_tensor(dst), r,
                                   torch.as_tensor(per),
                                   torch.as_tensor(pha))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_with_stagger_matches_reference():
    topo = jtopo.with_stagger(er(20), 3, seed=2)
    from sidecar_tpu_torch.ops import topology as ttopo

    ours = ttopo.with_stagger(port_topology(er(20)), 3, seed=2)
    np.testing.assert_array_equal(ours.stagger, topo.stagger)
    assert ours.stagger_period == 3
    assert ttopo.with_stagger(ours, 1).stagger is None
    assert dataclasses.replace(ours, stagger=None).stagger is None
    with pytest.raises(ValueError, match="shape"):
        ttopo.with_stagger(ours, 3, offsets=np.zeros(5))
