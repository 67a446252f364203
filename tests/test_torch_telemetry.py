"""The port's telemetry ops against the JAX reference's, exactly: the
digest (hash lanes, buckets, node digests, ladder folds, the coherence
record) on idents with the top bit set, the flight recorder's record functions
and buffer, the delta extraction below, at and above its capacity, the
provenance ``seed``/``observe`` and every host-side view, the cost
phase scopes, and the metrics registry after the same runs.

Inputs are made from a seed with numpy and go through both functions;
uint32 results are compared as numpy ``uint32``.  There is no
tolerance: the bar is equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu import metrics as jmetrics
from sidecar_tpu.models.compressed import CompressedState as JCState
from sidecar_tpu.models.exact import SimState as JXState
from sidecar_tpu.ops import delta as jdelta
from sidecar_tpu.ops import digest as jdigest
from sidecar_tpu.ops import provenance as jprov
from sidecar_tpu.ops import sparse as jsparse
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.ops import trace as jtrace
from sidecar_tpu.parallel.mesh import make_mesh
from sidecar_tpu.parallel.sharded_compressed import \
    ShardedCompressedSim as JSharded
from sidecar_tpu.telemetry import cost as jcost
from sidecar_tpu_torch import convert
from sidecar_tpu_torch import metrics as tmetrics
from sidecar_tpu_torch.ops import delta as tdelta
from sidecar_tpu_torch.ops import digest as tdigest
from sidecar_tpu_torch.ops import provenance as tprov
from sidecar_tpu_torch.ops import sparse as tsparse
from sidecar_tpu_torch.ops import topology as ttopo
from sidecar_tpu_torch.ops import trace as ttrace
from sidecar_tpu_torch.parallel import ShardedCompressedSim
from sidecar_tpu_torch.telemetry import cost as tcost
from tests.torch_parity import (
    BENCH_TIME,
    bench_burst,
    jax_draw_seq,
    jax_sharded_draws,
    port_pair,
    port_topology,
)

RNG_SEED = 5


def u32(x) -> np.ndarray:
    """A port uint32 tensor (int64) or a JAX uint32 array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.uint32)
    return np.asarray(x).astype(np.uint32)


def idents_top_bit(m: int, seed: int = RNG_SEED) -> np.ndarray:
    """Random uint32 idents, half of them with the top bit set."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2**32, size=m, dtype=np.uint64).astype(np.uint32)
    ids[::2] |= np.uint32(1 << 31)
    return ids


def t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def packed(rng, shape, p_known=0.7, statuses=(0, 1, 2, 4, 5),
           max_tick=50_000) -> np.ndarray:
    """Random packed keys ``ts << 3 | status``, some unknown (0)."""
    ts = rng.integers(1, max_tick, size=shape)
    st = rng.choice(statuses, size=shape)
    keys = (ts << 3) | st
    return np.where(rng.random(shape) < p_known, keys, 0).astype(np.int32)


# -- digest ----------------------------------------------------------------


@pytest.mark.parametrize("fn", ["mix32", "record_lanes", "record_lanes_hi0",
                                "bucket_ids"])
def test_digest_lanes_match_jax(fn):
    rng = np.random.default_rng(RNG_SEED)
    ids = idents_top_bit(257)
    lo = rng.integers(0, 2**32, size=257, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, size=257, dtype=np.uint64).astype(np.uint32)
    hi[:4] = 0
    if fn == "mix32":
        got = [tdigest.mix32(t64(ids))]
        want = [jdigest.mix32(jnp.asarray(ids))]
    elif fn == "record_lanes":
        got = tdigest.record_lanes(t64(ids), t64(lo), t64(hi))
        want = jdigest.record_lanes(jnp.asarray(ids), jnp.asarray(lo),
                                    jnp.asarray(hi))
    elif fn == "record_lanes_hi0":
        got = tdigest.record_lanes(t64(ids), t64(lo), 0)
        want = jdigest.record_lanes(jnp.asarray(ids), jnp.asarray(lo),
                                    jnp.zeros_like(jnp.asarray(lo)))
    else:
        got = [tdigest.bucket_ids(t64(ids), b) for b in (1, 2, 64, 1024)]
        want = [jdigest.bucket_ids(jnp.asarray(ids), b)
                for b in (1, 2, 64, 1024)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.uint32)
                                      .astype(np.int64))


@pytest.fixture(scope="module")
def digest_case():
    """A packed [12, 96] belief matrix (including 2³¹-sized keys near
    the top of the int32 range) with top-bit idents."""
    rng = np.random.default_rng(RNG_SEED + 1)
    bel = packed(rng, (12, 96), max_tick=(1 << 28) - 1)
    alive = rng.random(12) < 0.8
    alive[0] = True
    return bel, alive, idents_top_bit(96)


def test_node_digests_and_diff_counts_match_jax(digest_case):
    bel, _alive, ids = digest_case
    for b in (1, 8, 64):
        got = tdigest.node_digests(torch.as_tensor(bel), t64(ids), b)
        want = jdigest.node_digests(jnp.asarray(bel), jnp.asarray(ids), b)
        np.testing.assert_array_equal(u32(got), u32(want))
        np.testing.assert_array_equal(u32(got),
                                      tdigest.node_digests_np(bel, ids, b))
        ref = got[3]
        np.testing.assert_array_equal(
            tdigest.diff_counts(got, ref).numpy(),
            np.asarray(jdigest.diff_counts(want, want[3])))


def test_fold_and_ladder_match_jax(digest_case):
    bel, _alive, ids = digest_case
    got = tdigest.ladder_digests(torch.as_tensor(bel), t64(ids), base=4,
                                 depth=4)
    want = jdigest.ladder_digests(jnp.asarray(bel), jnp.asarray(ids),
                                  base=4, depth=4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g), u32(w))
    np.testing.assert_array_equal(
        u32(tdigest.fold_digest(got[-1])),
        u32(jdigest.fold_digest_jnp(jnp.asarray(u32(want[-1])))))
    np.testing.assert_array_equal(
        tdigest.fold_digest_np(u32(got[-1])), u32(want[-2]))
    with pytest.raises(ValueError, match="cannot fold"):
        tdigest.fold_digest(got[0][:, :1])


def test_state_digest_record_matches_jax(digest_case):
    bel, alive, ids = digest_case
    for b in (4, 64):
        got = tdigest.state_digest_record(
            7, torch.as_tensor(bel), torch.as_tensor(alive), t64(ids), b)
        want = jdigest.state_digest_record(
            7, jnp.asarray(bel), jnp.asarray(alive), jnp.asarray(ids), b)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # A fully coherent matrix: every alive node agrees.
    same = np.broadcast_to(bel.max(axis=0), bel.shape).copy()
    rec = tdigest.state_digest_record(3, torch.as_tensor(same),
                                      torch.as_tensor(alive), t64(ids), 64)
    assert rec.tolist() == [3, int(alive.sum()), int(alive.sum()), 0, 0]


def test_digest_host_helpers_match_reference():
    ids = idents_top_bit(50)
    keys = np.arange(50, dtype=np.uint64) << np.uint64(29)
    np.testing.assert_array_equal(tdigest.digest_np(ids, keys, 16),
                                  jdigest.digest_np(ids, keys, 16))
    np.testing.assert_array_equal(tdigest.default_idents(300),
                                  jdigest.default_idents(300))
    names = [("host-a", "svc-1"), ("hôst-b", "svc-2")]
    np.testing.assert_array_equal(tdigest.catalog_idents(names),
                                  jdigest.catalog_idents(names))
    for x in (0, 1, 0x80000000, 0xFFFFFFFF, 123456789):
        assert tdigest.fmix32_py(x) == jdigest.fmix32_py(x)
    assert tdigest.ident_of("h", "s") == jdigest.ident_of("h", "s")
    assert tdigest.live_key(2**62, 5) == jdigest.live_key(2**62, 5)
    a = jdigest.node_digests_np(packed(np.random.default_rng(1), (3, 20)),
                                ids[:20], 8)
    np.testing.assert_array_equal(tdigest.diff_counts_np(a, a[0]),
                                  jdigest.diff_counts_np(a, a[0]))
    lad = tdigest.ladder_digests_np(packed(np.random.default_rng(2),
                                           (3, 20)), ids[:20], 2, 3)
    want = jdigest.ladder_digests_np(packed(np.random.default_rng(2),
                                            (3, 20)), ids[:20], 2, 3)
    for g, w in zip(lad, want):
        np.testing.assert_array_equal(g, w)


def test_digest_trace_buffer_matches_jax():
    recs = np.arange(4 * tdigest.DIGEST_WIDTH, dtype=np.int32).reshape(
        4, tdigest.DIGEST_WIDTH) % 7 + 1
    tb = tdigest.zero_digest(3)
    jb = jdigest.zero_digest(3)
    for r in recs:
        tb = tdigest.append_digest(tb, torch.as_tensor(r))
        jb = jdigest.append_digest(jb, jnp.asarray(r))
    assert (tb.count, tb.overflow) == (int(jb.count), bool(jb.overflow))
    np.testing.assert_array_equal(tb.rec.numpy(), np.asarray(jb.rec))


# -- the flight recorder -----------------------------------------------------


@pytest.fixture(scope="module")
def exact_pair():
    """Two aligned exact-model states (tombstones entering, suspects,
    a dead node), as JAX and port states."""
    rng = np.random.default_rng(RNG_SEED + 2)
    n, s = 10, 4
    prev = packed(rng, (n, n * s))
    nxt = np.where(rng.random(prev.shape) < 0.3,
                   packed(rng, prev.shape, statuses=(0, 1, 5)), prev)
    sent = rng.integers(0, 9, size=prev.shape).astype(np.int8)
    alive = rng.random(n) < 0.8

    def states(known, sent_, r):
        arrays = dict(known=known, sent=sent_, node_alive=alive,
                      round_idx=np.int32(r))
        j = JXState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        return j, convert.exact_state_from_numpy(arrays, "cpu")

    return states(prev, sent, 4), states(nxt, sent, 5)


@pytest.mark.parametrize("tick", ["uniform", "per-node"])
def test_exact_record_matches_jax(exact_pair, tick):
    (jp, tp), (jn, tn) = exact_pair
    period = phase = None
    if tick == "per-node":
        period = np.array([1, 2, 4, 2, 1, 4, 2, 2, 1, 4], np.int32)
        phase = np.arange(10, dtype=np.int32) % 4
    kw = dict(budget=6, fanout=3, limit=5)
    stats = np.array([1, 0, 7], np.int32)
    want = jtrace.exact_record(jp, jn, stats=jnp.asarray(stats),
                               tick_period=None if period is None
                               else jnp.asarray(period),
                               tick_phase=None if phase is None
                               else jnp.asarray(phase), **kw)
    tper = None if period is None else torch.as_tensor(period)
    tpha = None if phase is None else torch.as_tensor(phase)
    got = ttrace.exact_record(tp, tn, stats=tuple(stats.tolist()),
                              tick_period=tper, tick_phase=tpha, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The census taken ahead of time gives the same record.
    census = ttrace.offer_census(
        (tp.known > 0) & (tp.sent.to(torch.int32) < 5), 6, 3)
    again = ttrace.exact_record(dataclasses.replace(tp, sent=None), tn,
                                stats=tuple(stats.tolist()), tick_period=tper,
                                tick_phase=tpha, census=census, **kw)
    np.testing.assert_array_equal(again.numpy(), np.asarray(want))


def compressed_states(rng, n=12, s=3, k=8):
    m = n * s

    def one(r):
        slot = np.where(rng.random((n, k)) < 0.7,
                        rng.integers(0, m, (n, k)), -1).astype(np.int32)
        arrays = dict(
            own=packed(rng, (n, s), p_known=0.9),
            cache_slot=slot,
            cache_val=np.where(slot >= 0, packed(rng, (n, k), p_known=1.0),
                               0).astype(np.int32),
            cache_sent=rng.integers(0, 9, (n, k)).astype(np.int8),
            floor=packed(rng, (m,), p_known=0.9, statuses=(0, 1)),
            node_alive=rng.random(n) < 0.85,
            round_idx=np.int32(r), evictions=np.int32(0),
            dropped=np.int32(0))
        j = JCState(**{key: jnp.asarray(v) for key, v in arrays.items()})
        return j, convert.state_from_numpy(arrays, "cpu")

    return one(8), one(9)


@pytest.mark.parametrize("behind", [12345.0, 3.5e9],
                         ids=["small", "saturating"])
def test_compressed_record_matches_jax(behind):
    (jp, tp), (jn, tn) = compressed_states(np.random.default_rng(3))
    kw = dict(budget=4, fanout=3, limit=5)
    want = jtrace.compressed_record(jp, jn, jnp.float32(behind), **kw)
    got = ttrace.compressed_record(
        tp, tn, torch.tensor(behind, dtype=torch.float32), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trace_buffer_and_views_match_jax():
    rng = np.random.default_rng(RNG_SEED + 3)
    recs = rng.integers(0, 5000, (5, ttrace.TRACE_WIDTH)).astype(np.int32)
    recs[:, ttrace.TRACE_SPARSE] = [1, 0, 1, 1, 0]
    for cap in (3, 5, 8):
        tb, jb = ttrace.zero_trace(cap), jtrace.zero_trace(cap)
        for r in recs:
            tb = ttrace.append_record(tb, torch.as_tensor(r))
            jb = jtrace.append_record(jb, jnp.asarray(r))
        assert (tb.count, tb.overflow) == (int(jb.count),
                                           bool(jb.overflow))
        assert tb.overflow == (cap < 5)
        np.testing.assert_array_equal(tb.rec.numpy(), np.asarray(jb.rec))
        assert ttrace.trace_to_dicts(tb) == jtrace.trace_to_dicts(jb)
        assert ttrace.summarize(tb) == jtrace.summarize(jb)
    assert ttrace.summarize(ttrace.zero_trace(2)) == \
        jtrace.summarize(jtrace.zero_trace(2))


def test_trace_leaf_ops_match_jax():
    rng = np.random.default_rng(RNG_SEED + 4)
    a, b = packed(rng, (6, 9)), packed(rng, (6, 9))
    alive = rng.random(6) < 0.7
    elig = rng.random((6, 9)) < 0.4
    for got, want in (
            (ttrace.offer_census(torch.as_tensor(elig), 3, 2),
             jtrace.offer_census(jnp.asarray(elig), 3, 2)),
            ((ttrace.count_tombstones(torch.as_tensor(a),
                                      torch.as_tensor(b)),),
             (jtrace.count_tombstones(jnp.asarray(a), jnp.asarray(b)),)),
            ((ttrace.count_suspects(torch.as_tensor(a)),),
             (jtrace.count_suspects(jnp.asarray(a)),)),
            ((ttrace.fp_tombstone_entries(
                torch.as_tensor(a), torch.as_tensor(b),
                torch.as_tensor(alive)[:, None]),),
             (jtrace.fp_tombstone_entries(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(alive)[:, None]),)),
            ((ttrace.ticked_census(5, torch.as_tensor(alive), 2, 1),
              ttrace.ticked_census(5, torch.as_tensor(alive))),
             (jtrace.ticked_census(5, jnp.asarray(alive), 2, 1),
              jtrace.ticked_census(5, jnp.asarray(alive))))):
        for g, w in zip(got, want):
            assert int(g) == int(w)
            assert g.dtype == torch.int32


# -- delta batches ------------------------------------------------------------


@pytest.mark.parametrize("cap", [3, 17, 40], ids=["above", "at", "below"])
def test_extract_delta_matches_jax(cap):
    rng = np.random.default_rng(RNG_SEED + 5)
    prev = packed(rng, (5, 13))
    nxt = prev.copy()
    flat = nxt.reshape(-1)
    hit = rng.choice(flat.size, 17, replace=False)
    flat[hit] = flat[hit] + 8
    got = tdelta.extract_delta(torch.as_tensor(prev), torch.as_tensor(nxt),
                               cap)
    want = jdelta.extract_delta(jnp.asarray(prev), jnp.asarray(nxt), cap)
    for f in ("count", "node", "slot", "val", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert bool(got.overflow) == (cap < 17)
    if cap >= 17:
        assert tdelta.batch_to_dict(got) == jdelta.batch_to_dict(want) \
            == tdelta.oracle_diff(prev, nxt)
    else:
        with pytest.raises(OverflowError):
            tdelta.batch_to_dict(got)


def test_compressed_belief_matches_jax():
    (jp, tp), _ = compressed_states(np.random.default_rng(4))
    got = tdelta.compressed_belief(tp.own, tp.cache_slot, tp.cache_val,
                                   tp.floor, 3)
    want = jdelta.compressed_belief(jp.own, jp.cache_slot, jp.cache_val,
                                    jp.floor, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- provenance ---------------------------------------------------------------


def prov_rounds(rng, n=10, t=3, rounds=4, cap=3):
    """A seeded trace and ``rounds`` observations with pushes and masked
    pulls, through both packages; returns both final traces."""
    bel = packed(rng, (n, t), p_known=0.5)
    jp = jprov.seed(jprov.zero_prov(t, n, cap), jnp.asarray(bel), 2)
    tp = tprov.seed(tprov.zero_prov(t, n, cap), torch.as_tensor(bel), 2)
    prev = bel
    for r in range(3, 3 + rounds):
        nxt = np.maximum(prev, np.where(rng.random((n, t)) < 0.4,
                                        bel.max(axis=0)[None, :], 0))
        dst = rng.integers(0, n, (n, 2)).astype(np.int32)
        src = rng.integers(0, n, (n, 1)).astype(np.int32)
        mask = rng.random((n, 1)) < 0.5
        jp = jprov.observe(
            jp, jprov.holders(jp, jnp.asarray(prev)),
            jprov.holders(jp, jnp.asarray(nxt)), r,
            [(jnp.asarray(dst), None)], [(jnp.asarray(src),
                                          jnp.asarray(mask))])
        tp = tprov.observe(
            tp, tprov.holders(tp, torch.as_tensor(prev)),
            tprov.holders(tp, torch.as_tensor(nxt)), r,
            [(torch.as_tensor(dst), None)],
            [(torch.as_tensor(src), torch.as_tensor(mask))])
        prev = nxt
    return jp, tp


def assert_prov_equal(jp, tp):
    for f in ("ref", "first_seen", "parent", "hops", "coverage"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)),
                                      err_msg=f)
    assert (tp.count, tp.overflow) == (int(jp.count), bool(jp.overflow))


@pytest.mark.parametrize("rounds", [2, 5], ids=["in-cap", "overflow"])
def test_seed_and_observe_match_jax(rounds):
    jp, tp = prov_rounds(np.random.default_rng(RNG_SEED + rounds),
                         rounds=rounds)
    assert_prov_equal(jp, tp)
    assert tp.overflow == (rounds > 3)
    assert (tp.parent.numpy() >= 0).any()   # some arrivals attributed


def test_provenance_views_match_jax():
    jp, tp = prov_rounds(np.random.default_rng(RNG_SEED + 9), rounds=4)
    tracked = (1, 14, 29)
    assert tprov.summarize(tp, tracked, 3) == jprov.summarize(jp, tracked,
                                                              3)
    assert tprov.tree_to_dict(tp, tracked) == jprov.tree_to_dict(jp, tracked)
    assert tprov.blast_radius(tp, tracked, 3, [0, 9]) == \
        jprov.blast_radius(jp, tracked, 3, [0, 9])
    fs = tp.first_seen.numpy()
    assert tprov.pooled_lag(fs) == jprov.pooled_lag(fs)
    assert tprov.p99_lag_rounds(fs) == jprov.p99_lag_rounds(fs)
    for m, c in ((1, 1), (100, 8), (7, 20), (0, 3)):
        assert tprov.default_tracked(m, c) == jprov.default_tracked(m, c)
    ref = torch.tensor([[3, 40], [9, 8]], dtype=torch.int32)
    bel = torch.tensor([[[8, 40], [3, 2]], [[9, 7], [0, 8]]],
                       dtype=torch.int32)
    np.testing.assert_array_equal(
        tprov.holders_batch(ref, bel).numpy(),
        np.asarray(jprov.holders_batch(jnp.asarray(ref.numpy()),
                                       jnp.asarray(bel.numpy()))))


# -- cost phase scopes ----------------------------------------------------------


def test_phase_switch_matches_reference(monkeypatch):
    """Off by default, as the reference is with its environment unset;
    the port reads no environment variable (the reference's switches
    leave it off), and ``set_phases``/``forced_phases`` set it."""
    monkeypatch.delenv("SIDECAR_TPU_COST_PHASES", raising=False)
    monkeypatch.delenv("SIDECAR_TPU_PROFILE_DIR", raising=False)
    assert tcost.phases_enabled() == jcost.phases_enabled() is False
    for env in ({"SIDECAR_TPU_COST_PHASES": "1"},
                {"SIDECAR_TPU_PROFILE_DIR": "prof"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert jcost.phases_enabled() and not tcost.phases_enabled(), env
        with tcost.forced_phases(True):
            assert tcost.phases_enabled()
            with tcost.forced_phases(False):
                assert not tcost.phases_enabled()
            assert tcost.phases_enabled()
        assert not tcost.phases_enabled(), env
        monkeypatch.delenv("SIDECAR_TPU_COST_PHASES", raising=False)
        monkeypatch.delenv("SIDECAR_TPU_PROFILE_DIR", raising=False)
    tcost.set_phases(True)
    try:
        assert tcost.phases_enabled()
    finally:
        tcost.set_phases(False)
    assert tcost.PHASES == jcost.PHASES
    assert tcost.PHASE_PREFIX == jcost.PHASE_PREFIX


def test_phase_scopes_label_the_round_and_change_nothing():
    """With phases on, a profiled round carries every compressed phase
    label (and the push-pull tag) and ends in the same state as with
    phases off."""
    jsim, tsim = port_pair(dict(n=16, services_per_node=2, cache_lines=8,
                                budget=4), jtopo.erdos_renyi(16, 4.0, 1),
                           dict(BENCH_TIME, push_pull_interval_s=1.0,
                                sweep_interval_s=2.0),
                           fused_gather=True)
    state = tsim.mint(tsim.init_state(), [3, 17], 10)
    # Push-pull every 5 rounds, the sweep every 10.
    draws = jax_draw_seq(jsim, jax.random.PRNGKey(0), 0, 10)
    off = tsim.run_fast(state, 10, draws=draws)
    with tcost.forced_phases(True), torch.profiler.profile() as prof:
        on = tsim.run_fast(state, 10, draws=draws)
    for f, v in convert.state_to_numpy(off).items():
        np.testing.assert_array_equal(convert.state_to_numpy(on)[f], v)
    names = {e.name for e in prof.events()}
    for ph in ("publish", "fold", "announce", "exchange", "ttl_sweep"):
        assert tcost.PHASE_PREFIX + ph in names, ph
    assert "push_pull" in names
    with tcost.forced_phases(False), torch.profiler.profile() as prof:
        tsim.run_fast(state, 1, draws=draws)
    assert not any(e.name.startswith(tcost.PHASE_PREFIX)
                   for e in prof.events())


# -- the metrics registry -------------------------------------------------------

PREFIXES = ("sparse.", "pipeline.", "parallel.exchange.",
            "topology.from_name.")


def registry_view(snap) -> dict:
    """The counters and gauges the port records, from either registry."""
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith(PREFIXES)}
            for kind in ("counters", "gauges")}


@pytest.fixture
def registries():
    tmetrics.reset()
    jmetrics.registry._counters.clear()
    jmetrics.registry._gauges.clear()
    yield
    tmetrics.reset()


def test_registry_after_arbiter_sparse_run_matches_jax(registries):
    """A run whose chunks an ``auto`` arbiter decides from the behind
    census, on both packages: the same chunks, the same counters."""
    params = dict(n=32, services_per_node=4, cache_lines=16, budget=4,
                  sparse_cap=4, fold_quorum=0.995, deep_sweep_every=0)
    jsim, tsim = port_pair(params, jtopo.erdos_renyi(32, 6.0, seed=3),
                           BENCH_TIME)
    key = jax.random.PRNGKey(1)
    slots = bench_burst(jsim.p.m, 0.1)
    js, ts = jsim.mint(jsim.init_state(), slots, 10), \
        tsim.mint(tsim.init_state(), slots, 10)
    draws = jax_draw_seq(jsim, key, 0, 40)
    ja = jsparse.SparseArbiter.for_census("auto", 32)
    ta = tsparse.SparseArbiter.for_census("auto", 32)
    for c in range(8):
        jk, tk = ja.dispatch_kwargs(), ta.dispatch_kwargs()
        assert jk == tk
        js, jb = jsim.run_behind(js, key, 5, every=5, donate=False, **jk)
        ts, tb = tsim.run_behind(ts, 5, 5, draws=draws[5 * c:5 * c + 5],
                                 **tk)
        ja.record_chunk(5, jsim.last_sparse_stats if jk["sparse"] else None)
        ta.record_chunk(5, tsim.last_sparse_stats if tk["sparse"] else None)
        ja.update_census(float(jb[-1]))
        ta.update_census(float(tb[-1]))
    assert ta.snapshot() == ja.snapshot()
    assert ta.snapshot()["sparse_rounds"] > 0
    view = registry_view(tmetrics.snapshot())
    assert view == registry_view(jmetrics.snapshot())
    assert view["counters"]["sparse.rounds"] == \
        ta.snapshot()["sparse_rounds"]


def test_registry_after_pipelined_run_and_from_name_matches_jax(registries):
    jsim, tsim = port_pair(dict(n=16, services_per_node=2, cache_lines=8,
                                budget=4), jtopo.ring(16), BENCH_TIME,
                           pipeline="1")
    key = jax.random.PRNGKey(2)
    js, ts = jsim.init_state(), tsim.init_state()
    jsim.run(js, key, 3, donate=False)
    tsim.run(ts, 3, draws=jax_draw_seq(jsim, key, 0, 4))
    for name in ("complete", "ring2", "er4"):
        ttopo.from_name(name, 16, seed=1)
        jtopo.from_name(name, 16, seed=1)
    chord = ttopo.from_name("chord", 16)
    want = jtopo.from_name("chord", 16)
    np.testing.assert_array_equal(chord.nbrs, want.nbrs)
    np.testing.assert_array_equal(chord.deg, want.deg)
    assert chord.name == want.name
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.from_name("torus", 16)
    np.testing.assert_array_equal(ttopo.from_name("er4", 16, 1).nbrs,
                                  jtopo.from_name("er4", 16, 1).nbrs)
    ttopo.from_name("er4", 16, 1)
    jtopo.from_name("er4", 16, 1)
    view = registry_view(tmetrics.snapshot())
    assert view == registry_view(jmetrics.snapshot())
    assert view["counters"]["pipeline.mode.1"] == 1
    assert view["counters"]["topology.from_name.er"] == 3


def test_registry_after_all_to_all_drops_matches_jax(registries):
    """An ``all_to_all`` run at d = 2 with a bucket too small for its
    requests drops pulls; syncing publishes them once, and a fresh
    trajectory counts from zero again."""
    from sidecar_tpu.models.compressed import CompressedParams as JParams
    from sidecar_tpu.models.timecfg import TimeConfig as JTime

    params = dict(n=32, services_per_node=2, cache_lines=8, budget=4,
                  fanout=6)
    topo = jtopo.erdos_renyi(32, 12.0, seed=3)
    jp, jt = JParams(**params), JTime(**BENCH_TIME)
    jsim = JSharded(jp, topo, jt, mesh=make_mesh(jax.devices()[:2]),
                    board_exchange="all_to_all", a2a_slack=1)
    tsim = ShardedCompressedSim(
        convert.params_from_jax_fields(dataclasses.asdict(jp)),
        port_topology(topo),
        convert.timecfg_from_fields(dataclasses.asdict(jt)), d=2,
        board_exchange="all_to_all", a2a_slack=1, device="cpu")
    assert tsim._a2a_cap == jsim._a2a_cap
    key = jax.random.PRNGKey(3)
    slots = bench_burst(jp.m, 0.2)
    js, ts = jsim.mint(jsim.init_state(), slots, 10), \
        tsim.mint(tsim.init_state(), slots, 10)
    jf, _ = jsim.run(js, key, 4, donate=False)
    tf, _ = tsim.run(ts, 4, draws=jax_sharded_draws(jsim, key, 0, 4))
    dropped = tsim.sync_exchange_metrics(tf)
    assert dropped == jsim.sync_exchange_metrics(jf) > 0
    tsim.sync_exchange_metrics(tf)          # no new drops: no count
    jsim.sync_exchange_metrics(jf)
    tsim.sync_exchange_metrics(ts)          # a fresh trajectory resets
    jsim.sync_exchange_metrics(js)
    tsim.sync_exchange_metrics(tf)
    jsim.sync_exchange_metrics(jf)
    view = registry_view(tmetrics.snapshot())
    assert view == registry_view(jmetrics.snapshot())
    assert view["counters"]["parallel.exchange.overflow"] == 2 * dropped
    assert view["counters"]["parallel.exchange.mode.all_to_all"] == 1
    assert view["gauges"]["parallel.exchange.bytes"] == \
        tsim.exchange_bytes_per_round
