"""Leaf ops of the PyTorch port against the JAX reference, exactly.

The same inputs, made with numpy from a seed, go through the reference
function and its port; every comparison is ``assert_array_equal`` (the
state is all integers).  Covers status packing at tick 0 and
``MAX_TICK``, the merge gates, ``ttl_sweep`` with and without a
suspicion window, the refresh stagger and the cache-line hash over
every slot, peer sampling on the reference's own draws, bit-identical
Erdős–Rényi graphs, and the time/knob bundles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.models import compressed as jc
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import gossip as jg
from sidecar_tpu.ops import knobs as jk
from sidecar_tpu.ops import merge as jm
from sidecar_tpu.ops import status as js
from sidecar_tpu.ops import suspicion as jsus
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.ops import ttl as jttl
from sidecar_tpu_torch.models import compressed as tc
from sidecar_tpu_torch.models.timecfg import TimeConfig as TTimeConfig
from sidecar_tpu_torch.ops import gossip as tg
from sidecar_tpu_torch.ops import knobs as tk
from sidecar_tpu_torch.ops import merge as tm
from sidecar_tpu_torch.ops import status as ts
from sidecar_tpu_torch.ops import suspicion as tsus
from sidecar_tpu_torch.ops import topology as ttopo
from sidecar_tpu_torch.ops import ttl as tttl


def eq(a, b, msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def packed(rng, shape, max_tick=2000, unknown=0.2):
    """Random packed keys: ts in [0, max_tick] (a share of unknown
    cells), every status code."""
    t = rng.integers(1, max_tick + 1, shape)
    t = np.where(rng.random(shape) < unknown, 0, t)
    st = rng.integers(0, 6, shape)
    return ((t << 3) | st).astype(np.int32)


class TestStatus:
    @pytest.mark.parametrize("tick", [0, 1, 12345, js.MAX_TICK])
    @pytest.mark.parametrize("status", [js.ALIVE, js.TOMBSTONE,
                                        js.DRAINING, js.SUSPECT])
    def test_pack_unpack(self, tick, status):
        ticks = np.array([tick, 0, js.MAX_TICK], np.int32)
        j = js.pack(jnp.asarray(ticks), status)
        t = ts.pack(torch.tensor(ticks), status)
        eq(t, j)
        assert t.dtype == torch.int32
        eq(ts.unpack_ts(t), js.unpack_ts(j))
        eq(ts.unpack_status(t), js.unpack_status(j))
        eq(ts.is_known(t), js.is_known(j))
        assert ts.pack(tick, status) == int(js.pack(tick, status))

    def test_constants(self):
        for name in ("ALIVE", "TOMBSTONE", "UNHEALTHY", "UNKNOWN",
                     "DRAINING", "SUSPECT", "STATUS_BITS", "MAX_TICK"):
            assert getattr(ts, name) == getattr(js, name), name


class TestMerge:
    @pytest.fixture
    def data(self):
        rng = np.random.default_rng(5)
        return packed(rng, (40, 32)), packed(rng, (40, 32)), \
            rng.random((40, 32)) < 0.3

    @pytest.mark.parametrize("now,stale", [(1500, 700), (100, 40),
                                           (50, 10_860_000)])
    def test_staleness_and_future(self, data, now, stale):
        v, _, _ = data
        eq(tm.staleness_mask(torch.tensor(v), now, stale),
           jm.staleness_mask(jnp.asarray(v), now, stale))
        eq(tm.future_mask(torch.tensor(v), now, stale // 3),
           jm.future_mask(jnp.asarray(v), now, stale // 3))

    @pytest.mark.parametrize("budget", [0, 1, 3])
    @pytest.mark.parametrize("with_own", [False, True])
    def test_budget_and_admit(self, data, budget, with_own):
        v, _, own = data
        o_t = torch.tensor(own) if with_own else None
        o_j = jnp.asarray(own) if with_own else None
        eq(tm.budget_mask(torch.tensor(v), 900, budget, o_t),
           jm.budget_mask(jnp.asarray(v), 900, budget, o_j))
        for ft in (None, 50):
            eq(tm.admit_gate(torch.tensor(v), 900, 600, ft, budget, o_t),
               jm.admit_gate(jnp.asarray(v), 900, 600, ft, budget, o_j))
        eq(tm.admit_gate(torch.tensor(v), 900, 600),
           jm.admit_gate(jnp.asarray(v), 900, 600))

    def test_stickiness(self, data):
        v, pre, _ = data
        vt, pt = torch.tensor(v), torch.tensor(pre)
        vj, pj = jnp.asarray(v), jnp.asarray(pre)
        eq(tm.sticky_adjust(vt, pt, vt > pt),
           jm.sticky_adjust(vj, pj, vj > pj))
        eq(tm.apply_stickiness(pt, vt), jm.apply_stickiness(pj, vj))


class TestTtl:
    @pytest.mark.parametrize("window", [0, 3000])
    @pytest.mark.parametrize("now", [900, 5000, 90_000])
    def test_sweep(self, window, now):
        rng = np.random.default_rng(now + window)
        v = packed(rng, (64, 16), max_tick=now)
        kw = dict(alive_lifespan=800, draining_lifespan=2500,
                  tombstone_lifespan=4000, one_second=100,
                  suspicion_window=window)
        st, et = tttl.ttl_sweep(torch.tensor(v), now, **kw)
        sj, ej = jttl.ttl_sweep(jnp.asarray(v), now, **kw)
        eq(st, sj)
        eq(et, ej)


class TestGossip:
    @pytest.mark.parametrize("k", [8, 256, 1024])
    def test_hash_line_every_slot(self, k):
        s = 10 if k > 8 else 4
        slots = np.arange(0, 4096 * s, dtype=np.int32)
        eq(tc.hash_line(torch.tensor(slots), k, s),
           jc.hash_line(jnp.asarray(slots), k, s))

    @pytest.mark.parametrize("k", [8, 256, 1024])
    def test_refresh_due_every_slot(self, k):
        rng = np.random.default_rng(k)
        n, s = k, 4
        slots = np.arange(n * s, dtype=np.int32).reshape(n, s)
        own = packed(rng, (n, s), max_tick=4000)
        for round_idx, refresh_rounds in ((7, 13), (300, 300), (41, 1)):
            kw = dict(refresh_rounds=refresh_rounds, round_ticks=200,
                      now=round_idx * 200)
            eq(tg.refresh_due(torch.tensor(own), torch.tensor(slots),
                              round_idx, **kw),
               jg.refresh_due(jnp.asarray(own), jnp.asarray(slots),
                              round_idx, **kw))
            eq(tg.refresh_phase(torch.tensor(slots), refresh_rounds),
               jg.refresh_phase(jnp.asarray(slots), refresh_rounds))

    @pytest.mark.parametrize("graph", ["complete", "er", "ring"])
    def test_sample_peers_on_reference_draws(self, graph):
        """The port resolves the reference's own ``randint`` draws to
        exactly the peers ``sample_peers(k_peers, …)`` returns."""
        n, f = 50, 3
        topo = {"complete": jtopo.complete(n),
                "er": jtopo.erdos_renyi(n, 3.0, seed=2),
                "ring": jtopo.ring(n, 2)}[graph]
        alive = np.ones(n, bool)
        alive[[4, 17]] = False
        key = jax.random.PRNGKey(11)
        nbrs = None if topo.nbrs is None else jnp.asarray(topo.nbrs)
        deg = None if topo.deg is None else jnp.asarray(topo.deg)
        want = jg.sample_peers(key, n, f, nbrs=nbrs, deg=deg,
                               node_alive=jnp.asarray(alive))
        if deg is None:
            slot = jax.random.randint(key, (n, f), 0, n - 1,
                                      dtype=jnp.int32)
        else:
            slot = jax.random.randint(key, (n, f), 0,
                                      jnp.maximum(deg, 1)[:, None],
                                      dtype=jnp.int32)
        got = tg.sample_peers(
            torch.tensor(np.asarray(slot)), n,
            nbrs=None if topo.nbrs is None else torch.tensor(topo.nbrs),
            node_alive=torch.tensor(alive))
        eq(got, want)

    @pytest.mark.parametrize("with_deg", [False, True])
    def test_draw_round_ranges_and_determinism(self, with_deg):
        n, f, k = 64, 3, 16
        deg = torch.tensor(np.r_[np.zeros(4), np.arange(1, 61)] % 9,
                           dtype=torch.int32) if with_deg else None
        a = tg.draw_round(torch.Generator().manual_seed(3), n, f, deg=deg,
                          keep_prob=0.9, keep_width=k)
        b = tg.draw_round(torch.Generator().manual_seed(3), n, f, deg=deg,
                          keep_prob=0.9, keep_width=k)
        assert torch.equal(a.peer_slot, b.peer_slot) and a.stride == b.stride
        assert torch.equal(a.keep, b.keep) and a.keep.shape == (n, f, k)
        assert a.peer_slot.dtype == torch.int32
        hi = n - 1 if deg is None else torch.clamp(deg, min=1)[:, None]
        assert bool((a.peer_slot >= 0).all() & (a.peer_slot < hi).all())
        assert 1 <= a.stride < n
        quiet = tg.draw_round(torch.Generator().manual_seed(3), n, f,
                              deg=deg, push_pull=False)
        assert quiet.stride == 0 and quiet.keep is None

    def test_announce_refute(self):
        rng = np.random.default_rng(9)
        due = rng.random((30, 4)) < 0.3
        st = rng.integers(0, 6, (30, 4)).astype(np.int32)
        present = rng.random((30, 4)) < 0.8
        for on in (False, True):
            dt, stt = tsus.announce_refute(torch.tensor(due),
                                           torch.tensor(st),
                                           torch.tensor(present), on)
            dj, sj = jsus.announce_refute(jnp.asarray(due), jnp.asarray(st),
                                          jnp.asarray(present), on)
            eq(dt, dj)
            eq(stt, sj)


class TestTopology:
    @pytest.mark.parametrize("n", [64, 1000, 5000])
    def test_erdos_renyi_bit_identical(self, n):
        """n = 5,000 draws 7 blocks of rows, on a pool of threads."""
        a, b = ttopo.erdos_renyi(n, 8.0, seed=3), \
            jtopo.erdos_renyi(n, 8.0, seed=3)
        eq(a.nbrs, b.nbrs)
        eq(a.deg, b.deg)
        assert a.nbrs.dtype == b.nbrs.dtype and a.name == b.name
        assert int((a.deg == 0).sum()) >= 0   # isolated nodes allowed

    def test_ring_and_complete(self):
        a, b = ttopo.ring(17, 2), jtopo.ring(17, 2)
        eq(a.nbrs, b.nbrs)
        eq(a.deg, b.deg)
        assert ttopo.complete(9).nbrs is None
        assert ttopo.complete(9).max_degree == 0


class TestConfig:
    CONFIGS = [dict(), dict(refresh_interval_s=10_000.0,
                            push_pull_interval_s=4.0),
               dict(suspicion_window_s=3.5, future_fudge_s=0.5,
                    origin_budget=2, origin_quarantine=6, round_ticks=50)]

    @pytest.mark.parametrize("kw", CONFIGS)
    def test_timecfg_properties(self, kw):
        a, b = TTimeConfig(**kw), JTimeConfig(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for prop in ("alive_lifespan", "draining_lifespan",
                     "tombstone_lifespan", "stale_ticks", "one_second",
                     "suspicion_window", "future_ticks", "tomb_budget",
                     "quarantine_threshold", "refresh_rounds",
                     "push_pull_rounds", "sweep_rounds", "max_safe_rounds"):
            assert getattr(a, prop) == getattr(b, prop), prop
        with pytest.raises(ValueError):
            a.validate_horizon(a.max_safe_rounds + 1)
        with pytest.raises(ValueError):
            b.validate_horizon(b.max_safe_rounds + 1)

    @pytest.mark.parametrize("kw", CONFIGS)
    def test_knobs_from_protocol(self, kw):
        jp = jc.CompressedParams(n=100, drop_prob=0.1, recover_rounds=7)
        tp = tc.CompressedParams(n=100, drop_prob=0.1, recover_rounds=7)
        a = tk.from_protocol(tp, TTimeConfig(**kw), recover_rounds=7)
        b = jk.from_protocol(jp, JTimeConfig(**kw), recover_rounds=7)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.future_arg() == b.future_arg()
        assert a.budget_arg() == b.budget_arg()
        assert a.suspicion_enabled == b.suspicion_enabled
        assert a.needs_drop_draw == b.needs_drop_draw
