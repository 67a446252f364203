"""The port's exact record-level model against the JAX reference, exact:
each op of the round (``merge_packed``, ``select_messages`` in both
stages, ``prepare_deliveries``, ``apply_updates``,
``record_transmissions``, ``push_pull``), the plain versions of the
scatter-max apply and the in-place max, and the whole model in lockstep
from the reference's own draws.

The reference's Pallas kernels of the scatter experiment
(``benchmarks/pallas_scatter.py``: ``make_pallas_scatter`` and
``pallas_rmw_max``) cannot run here: they have no interpret mode and use
the TPU's SMEM memory space, and the JAX package is not edited to add
one.  Their plain versions are held against the JAX expressions the
reference's own check uses instead — ``k.at[r, c].max(v)`` and
``jnp.maximum``.  The CUDA kernels themselves are held against the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Integer state fields are compared exactly; ``convergence`` (a float32
mean and sum whose reduction order differs from XLA's) within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.ops import gossip as jg
from sidecar_tpu.ops import merge as jm
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models.exact import ExactSim, SimParams
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import gossip as tg
from sidecar_tpu_torch.ops import merge as tm
from sidecar_tpu_torch.ops import topology
from sidecar_tpu_torch.ops.kernels import scatter_max as tsm
from sidecar_tpu_torch.ops.status import SUSPECT, TOMBSTONE
from tests.torch_parity import (
    assert_exact_states_equal,
    er,
    exact_port_pair,
    jax_exact_draw_seq,
)

CONV_TOL = 1e-6


def eq(got, want, ctx=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(got, want, err_msg=ctx)
    assert got.dtype == want.dtype, (ctx, got.dtype, want.dtype)


def t(x):
    return torch.tensor(np.asarray(x))


def packed(rng, shape, ts_hi=400, statuses=(0, 0, 0, 1, 4, 5),
           unknown=0.2):
    """Packed keys with ticks in [1, ts_hi), a mix of statuses, and a
    share of unknown cells (ts 0, some with stray status bits)."""
    ts = rng.integers(1, ts_hi, shape)
    st = rng.choice(statuses, shape)
    ts = np.where(rng.random(shape) < unknown, 0, ts)
    return ((ts << 3) | st).astype(np.int32)


# -- ops ---------------------------------------------------------------------

class TestMergeAndPushPull:
    @pytest.mark.parametrize("defences", [None, "future", "both"])
    def test_merge_packed(self, defences):
        rng = np.random.default_rng(1)
        known = packed(rng, (40, 24))
        incoming = packed(rng, (40, 24), ts_hi=500)
        own = rng.random((40, 24)) < 0.3
        ft = None if defences is None else 30
        tb = 2 if defences == "both" else None
        kw = dict(now_tick=420, stale_ticks=300, future_ticks=ft,
                  tomb_budget=tb)
        want = jm.merge_packed(jnp.asarray(known), jnp.asarray(incoming),
                               kw["now_tick"], kw["stale_ticks"], ft, tb,
                               jnp.asarray(own) if tb else None)
        got = tm.merge_packed(t(known), t(incoming), kw["now_tick"],
                              kw["stale_ticks"], ft, tb,
                              t(own) if tb else None)
        eq(got, want)

    @pytest.mark.parametrize("defences", [None, "future", "both"])
    def test_push_pull(self, defences):
        """Partners repeat (the push leg's row scatter-max resolves
        duplicates), some are self, some nodes are dead; with the budget
        on, the owner table exempts each sending side's own slots."""
        rng = np.random.default_rng(2)
        n, s = 30, 4
        known = packed(rng, (n, n * s), ts_hi=600)
        partner = rng.integers(0, n, n).astype(np.int32)
        partner[:4] = 7
        partner[5] = 5
        alive = rng.random(n) < 0.8
        owner = (np.arange(n * s) // s).astype(np.int32)
        ft = None if defences is None else 40
        tb = 1 if defences == "both" else None
        want = jg.push_pull(
            jnp.asarray(known), jnp.asarray(partner), now_tick=580,
            stale_ticks=400, node_alive=jnp.asarray(alive),
            future_ticks=ft, tomb_budget=tb,
            owner=jnp.asarray(owner) if tb else None)
        got = tg.push_pull(
            t(known), t(partner), now_tick=580, stale_ticks=400,
            node_alive=t(alive), future_ticks=ft, tomb_budget=tb,
            owner=t(owner) if tb else None)
        eq(got, want)
        assert not np.array_equal(np.asarray(want), known)   # premise


def select_case(rng, n, m, case):
    """(known, sent) for one select case."""
    if case == "cold_start":       # every record ts=1: all ties
        known = np.full((n, m), 8, np.int32)
        sent = np.zeros((n, m), np.int8)
    elif case == "sparse_rows":    # ~8 eligible records a row
        known = packed(rng, (n, m), ts_hi=50, unknown=0.0)
        sent = np.where(rng.random((n, m)) < 8 / m, 0, 20).astype(np.int8)
    else:                          # a realistic mid-flight mix
        known = packed(rng, (n, m), ts_hi=30)
        sent = rng.integers(0, 14, (n, m)).astype(np.int8)
    return known, sent


class TestSelect:
    @pytest.mark.parametrize("m", [640, 5120])
    @pytest.mark.parametrize("case", ["cold_start", "sparse_rows", "mixed"])
    @pytest.mark.parametrize("row_offset", [0, 13])
    def test_select_messages(self, m, case, row_offset):
        """m=640 takes the single-stage top-k, m=5,120 the two-stage
        group select (M > 4,096)."""
        rng = np.random.default_rng(m + len(case))
        n = 64
        known, sent = select_case(rng, n, m, case)
        want = jg.select_messages(jnp.asarray(known), jnp.asarray(sent),
                                  15, 12, row_offset=row_offset)
        got = tg.select_messages(t(known), t(sent), 15, 12,
                                 row_offset=row_offset)
        eq(got[0], want[0], "svc_idx")
        eq(got[1], want[1], "msg")
        if case == "sparse_rows":   # premise: padding present
            assert (np.asarray(want[0]) == m).any()

    def test_budget_over_m(self):
        known = packed(np.random.default_rng(4), (8, 6), unknown=0.0)
        sent = np.zeros((8, 6), np.int8)
        want = jg.select_messages(jnp.asarray(known), jnp.asarray(sent),
                                  15, 4)
        got = tg.select_messages(t(known), t(sent), 15, 4)
        assert got[0].shape == (8, 6)
        eq(got[0], want[0])
        eq(got[1], want[1])

    def test_top_k_ties_to_lower_index(self):
        x = torch.tensor([[5, 3, 5, 1, 5, 0], [0, 0, 0, 0, 0, 0]],
                         dtype=torch.int32)
        vals, idx = tg.top_k(x, 4)
        want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
        eq(vals, want_v)
        eq(idx.to(torch.int32), want_i)

    def test_eligible_records(self):
        rng = np.random.default_rng(5)
        known, sent = select_case(rng, 20, 50, "mixed")
        eq(tg.eligible_records(t(known), t(sent), 7),
           jg.eligible_records(jnp.asarray(known), jnp.asarray(sent), 7))


class TestDeliveries:
    @pytest.mark.parametrize("defences", [False, True])
    def test_prepare_deliveries(self, defences):
        """Loss mask, dead senders and receivers, DRAINING stickiness
        against the pre-round state, padding column M."""
        rng = np.random.default_rng(6)
        n, s, f = 32, 5, 3
        m = n * s
        known = packed(rng, (n, m), ts_hi=100)
        # ~16 eligible records a row, so some rows pad.
        sent = np.where(rng.random((n, m)) < 0.1, 0, 20).astype(np.int8)
        svc, msg = jg.select_messages(jnp.asarray(known), jnp.asarray(sent),
                                      15, 12)
        dst = rng.integers(0, n, (n, f)).astype(np.int32)
        alive = rng.random(n) < 0.85
        keep = rng.random((n, f, 15)) < 0.8
        owner = np.arange(m) // s
        own = owner[np.minimum(np.asarray(svc), m - 1)] == \
            np.arange(n)[:, None]
        kw = dict(now_tick=110, stale_ticks=60)
        if defences:
            kw.update(future_ticks=5, tomb_budget=1)
        want = jg.prepare_deliveries(
            jnp.asarray(known), jnp.asarray(dst), svc, msg,
            node_alive=jnp.asarray(alive), record_keep=jnp.asarray(keep),
            sender_own=jnp.asarray(own) if defences else None, **kw)
        got = tg.prepare_deliveries(
            t(known), t(dst), t(svc), t(msg), node_alive=t(alive),
            record_keep=t(keep), sender_own=t(own) if defences else None,
            **kw)
        for g, w, name in zip(got, want, ("rows", "cols", "vals", "adv")):
            eq(g, w, name)
        assert (np.asarray(svc) == m).any()     # premise: padding

    def test_apply_updates(self):
        """Row-N and column-M padding (with an (r, M) that a flat index
        would alias to (r+1, 0)), duplicate triples with different
        values, and the sent reset."""
        rng = np.random.default_rng(7)
        n, m, u = 16, 24, 300
        known = packed(rng, (n, m), ts_hi=50)
        sent = rng.integers(0, 10, (n, m)).astype(np.int8)
        rows = rng.integers(0, n + 1, u).astype(np.int32)
        cols = rng.integers(0, m + 1, u).astype(np.int32)
        rows[:5], cols[:5] = 3, m                  # (3, M) vs (4, 0)
        rows[5:9], cols[5:9] = 2, 7                # duplicates
        vals = packed(rng, (u,), ts_hi=80)
        vals[5:9] = [400, 480, 472, 9]
        adv = rng.random(u) < 0.5
        adv[:5] = True
        want = jg.apply_updates(jnp.asarray(known), jnp.asarray(sent),
                                jnp.asarray(rows), jnp.asarray(cols),
                                jnp.asarray(vals), jnp.asarray(adv))
        tk, ts = t(known), t(sent)
        got = tg.apply_updates(tk, ts, t(rows), t(cols), t(vals), t(adv))
        assert got[0] is tk and got[1] is ts        # in place
        eq(got[0], want[0], "known")
        eq(got[1], want[1], "sent")

    def test_record_transmissions(self):
        rng = np.random.default_rng(8)
        for case in ("mixed", "sparse_rows", "cold_start"):
            known, sent = select_case(rng, 40, 300, case)
            svc, msg = jg.select_messages(jnp.asarray(known),
                                          jnp.asarray(sent), 15, 12)
            want = jg.record_transmissions(jnp.asarray(sent), svc, msg, 3,
                                           12)
            ts = t(sent)
            got = tg.record_transmissions(ts, t(svc), t(msg), 3)
            assert got is ts
            eq(got, want, case)


class TestPlainKernels:
    def test_scatter_max_plain_equals_jax_scatter(self):
        """The reference's own check (``pallas_scatter.py``:
        ``k.at[r, c].max(v)``), at a small shape with duplicates, plus
        entries past the end on either axis, which both drop.  (JAX
        wraps a negative index; the round never makes one, and the
        port drops it.)"""
        rng = np.random.default_rng(9)
        n, m, u = 24, 72, 600
        known = rng.integers(1, 1 << 20, (n, m), dtype=np.int32)
        rows = rng.integers(0, n + 2, u).astype(np.int32)
        cols = rng.integers(0, m + 2, u).astype(np.int32)
        vals = rng.integers(1, 1 << 22, u, dtype=np.int32)
        want = jnp.asarray(known).at[rows, cols].max(vals, mode="drop")
        got, _ = tsm.scatter_max_apply_torch(t(known), t(rows), t(cols),
                                             t(vals))
        eq(got, want)
        for u0 in (0, 1):
            got, _ = tsm.scatter_max_apply(t(known), t(rows[:u0]),
                                           t(cols[:u0]), t(vals[:u0]))
            eq(got, jnp.asarray(known).at[rows[:u0], cols[:u0]].max(
                vals[:u0], mode="drop"), f"U={u0}")

    @pytest.mark.parametrize("shape", [(8, 40), (7, 13), (1, 3)])
    def test_rmw_max_plain_equals_jnp_maximum(self, shape):
        rng = np.random.default_rng(10)
        known = rng.integers(1, 1 << 20, shape, dtype=np.int32)
        other = rng.integers(1, 1 << 20, shape, dtype=np.int32)
        tk = t(known)
        got = tsm.rmw_max(tk, t(other))
        assert got is tk
        eq(got, jnp.maximum(jnp.asarray(known), jnp.asarray(other)))

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        k = torch.zeros((4, 4), dtype=torch.int32)
        i = torch.zeros(3, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tsm.scatter_max_apply_cuda(k, i, i, i)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tsm.rmw_max_cuda(k, k)

    def test_cpu_dispatch_launches_nothing(self):
        before = (tsm.scatter_max_apply_cuda.launches,
                  tsm.rmw_max_cuda.launches)
        k = torch.zeros((4, 4), dtype=torch.int32)
        i = torch.ones(3, dtype=torch.int32)
        tsm.scatter_max_apply(k, i, i, i)
        tsm.rmw_max(k, k)
        assert (tsm.scatter_max_apply_cuda.launches,
                tsm.rmw_max_cuda.launches) == before


# -- the model ---------------------------------------------------------------

# Push-pull every 5 rounds, the sweep every 10, records expiring into
# SUSPECT after 3 s and tombstoning after the 1 s window, owners
# refreshing every 10 rounds: every phase fires inside 40 rounds.
BUSY_TIME = dict(push_pull_interval_s=1.0, suspicion_window_s=1.0,
                 alive_lifespan_s=3.0, refresh_interval_s=2.0)


def lockstep(topo, rounds, *, n=64, spn=10, drop=0.0, time_kw=BUSY_TIME,
             live_fraction=1.0):
    params = dict(n=n, services_per_node=spn, fanout=3, budget=15,
                  drop_prob=drop)
    jsim, tsim = exact_port_pair(params, topo, time_kw)
    key = jax.random.PRNGKey(3)
    js0 = jsim.init_state(live_fraction, seed=2)
    ts0 = tsim.init_state(live_fraction, seed=2)
    assert_exact_states_equal(js0, ts0, "init")
    js, jconv = jsim.run(js0, key, rounds, donate=False)
    ts, tconv = tsim.run(ts0, rounds,
                         draws=jax_exact_draw_seq(jsim, key, 0, rounds))
    assert_exact_states_equal(js, ts, f"{topo.name} after {rounds}")
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), rtol=0,
                               atol=CONV_TOL)
    return ts, tconv


class TestExactSim:
    @pytest.mark.parametrize("graph", ["er8", "complete"])
    @pytest.mark.parametrize("drop", [0.0, 0.1])
    def test_lockstep_40_rounds(self, graph, drop):
        topo = er(64) if graph == "er8" else jtopo.complete(64)
        ts, conv = lockstep(topo, 40, drop=drop)
        st = ts.known.numpy() & 7
        # Premises: the sweep suspected records (and tombstoned some on
        # the sparser graph), and the run is still converging.
        assert (st == SUSPECT).any()
        assert graph == "complete" or (st == TOMBSTONE).any()
        assert 0.0 < float(conv[0]) < float(conv.max())

    def test_lockstep_two_stage_select(self):
        """M = 5,120 > 4,096: every round selects in two stages."""
        lockstep(er(64), 10, spn=80, drop=0.1)

    def test_lockstep_defences_and_partial_boot(self):
        time_kw = dict(BUSY_TIME, future_fudge_s=0.4, origin_budget=1)
        lockstep(er(48), 15, n=48, time_kw=time_kw, live_fraction=0.7)

    def test_drivers_in_place_and_chunked(self):
        """``step`` leaves its input intact; ``run_fast`` updates in
        place unless ``donate=False``; chunked equals straight."""
        p = SimParams(n=32, services_per_node=4)
        sim = ExactSim(p, topology.ring(32), TimeConfig(**BUSY_TIME),
                       device="cpu")
        s0 = sim.init_state()
        g1, g2 = torch.Generator().manual_seed(4), \
            torch.Generator().manual_seed(4)
        straight = sim.run_fast(s0, 12, generator=g1, donate=False)
        assert s0.round_idx == 0 and int(s0.known.max()) == 8   # intact
        one = sim.step(s0, generator=g2)
        assert int(s0.known.max()) == 8
        chunk = sim.run_fast(one, 6, generator=g2)
        assert chunk.known is one.known                          # in place
        chunk, conv = sim.run(chunk, 5, generator=g2)
        assert conv.shape == (5,) and chunk.round_idx == 12
        for f, v in convert.state_to_numpy(straight).items():
            np.testing.assert_array_equal(
                v, convert.state_to_numpy(chunk)[f], err_msg=f)
        with pytest.raises(ValueError, match="generator"):
            sim.run_fast(s0, 2)

    def test_push_pull_round_needs_its_partner(self):
        p = SimParams(n=8, services_per_node=2)
        sim = ExactSim(p, topology.complete(8),
                       TimeConfig(push_pull_interval_s=0.2), device="cpu")
        d = sim.draw(torch.Generator().manual_seed(0), 1)
        assert d.pp_slot.shape == (8, 1) and d.keep is None
        with pytest.raises(ValueError, match="pp_slot"):
            sim.step(sim.init_state(),
                     draws=dataclasses.replace(d, pp_slot=None))

    def test_draw_shapes(self):
        p = SimParams(n=20, services_per_node=3, budget=15, drop_prob=0.2)
        sim = ExactSim(p, topology.erdos_renyi(20, 4.0, seed=1),
                       TimeConfig(), device="cpu")
        d = sim.draw(torch.Generator().manual_seed(1), 3)
        assert d.keep.shape == (20, 3, 15) and d.pp_slot is None
        deg = torch.as_tensor(sim.topo.deg)
        assert bool((d.peer_slot < torch.clamp(deg, min=1)[:, None]).all())
