"""The port's compressed model, piece by piece, against the JAX
reference: ``init_state``/``mint`` (colliding lines, DRAINING
stickiness, a dead owner), one phase at a time on a mid-flight state
(announce with refreshes and suspicion refutes, push-pull on an
injected stride with the defences on and off, the floor advance and
sweep at quorum 0.995 and 1.0 with the deep free due by cadence and by
a TTL-moved floor), and all three behind-census paths.  Exact.

Mid-flight states come from the port itself (a few CPU rounds from a
seeded generator); each phase is then a pure function of that state,
run on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu.models import compressed as jc
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu_torch import convert
from sidecar_tpu_torch.models import compressed as tc
from sidecar_tpu_torch.ops.status import DRAINING, SUSPECT, TOMBSTONE
from tests.torch_parity import assert_states_equal, port_pair


def to_jax(state):
    """The reference's copy of a port state."""
    arrays = convert.state_to_numpy(state)
    return jc.CompressedState(**{k: jnp.asarray(v)
                                 for k, v in arrays.items()})


def pair(n=48, s=4, k=32, topo=None, time_kw=None, **params):
    kw = dict(n=n, services_per_node=s, cache_lines=k, fanout=3,
              budget=6, **params)
    return port_pair(kw, topo or jtopo.erdos_renyi(n, 6.0, seed=3),
                     time_kw or {})


def mid_flight(tsim, rounds, burst=40, seed=1, tick=10):
    """A port state ``rounds`` rounds after a minted burst."""
    rng = np.random.default_rng(seed)
    slots = np.sort(rng.choice(tsim.p.m, burst, replace=False))
    st = tsim.mint(tsim.init_state(), slots, tick)
    return tsim.run_fast(st, rounds,
                         generator=torch.Generator().manual_seed(seed))


class TestStateAndMint:
    def test_init_state(self):
        jsim, tsim = pair()
        assert_states_equal(jsim.init_state(), tsim.init_state(), "init")

    def test_mint_collisions_stickiness_and_dead_owner(self):
        """K=8 lines for 24 nodes × 4 slots, minted onto caches already
        full of relayed records: fresh mints evict live lines; a
        DRAINING mint then an ALIVE re-mint of the same slots stays
        DRAINING (stickiness against max(own, floor)); a dead owner
        mints nothing; repeated slots in one batch resolve once."""
        jsim, tsim = pair(n=24, s=4, k=8, topo=jtopo.complete(24))
        ts = mid_flight(tsim, 4, burst=60)
        alive = ts.node_alive.clone()
        alive[5] = False
        ts = dataclasses.replace(ts, node_alive=alive)
        js = to_jax(ts)
        before = int(ts.evictions)
        rng = np.random.default_rng(3)
        steps = [(np.sort(rng.choice(96, 30, replace=False)), 900, 0),
                 (np.arange(20, 28), 910, DRAINING),
                 (np.arange(18, 30), 920, 0),
                 (np.array([1, 1, 9, 40, 95]), 930, TOMBSTONE)]
        for slots, tick, status in steps:
            slots = slots.astype(np.int32)
            js = jsim.mint(js, jnp.asarray(slots), tick, status)
            ts = tsim.mint(ts, slots, tick, status)
            assert_states_equal(js, ts, f"mint at {tick}")
        assert int(ts.evictions) > before     # premise: lines collided
        own = convert.state_to_numpy(ts)["own"].reshape(-1)
        assert (own[24:28] & 7 == DRAINING).all()  # premise: sticky
        assert (own[20:24] >> 3 <= 10).all()       # premise: dead owner


class TestPhases:
    @pytest.mark.parametrize("suspicion", [False, True])
    def test_announce(self, suspicion):
        time_kw = dict(refresh_interval_s=2.0,
                       suspicion_window_s=1.0 if suspicion else 0.0)
        jsim, tsim = pair(time_kw=time_kw)
        st = mid_flight(tsim, 21)
        if suspicion:
            own = st.own.clone()
            own[::3, 1] = (own[::3, 1] & ~7) | SUSPECT
            st = dataclasses.replace(st, own=own)
        for round_idx in (22, 30):
            now = round_idx * 200
            want = jsim._announce(to_jax(st), round_idx, now)
            got = tsim._announce(st, round_idx, now)
            assert_states_equal(want, got, f"announce r{round_idx}")

    @pytest.mark.parametrize("defences", [False, True])
    def test_push_pull_injected_stride(self, defences):
        time_kw = dict(future_fudge_s=0.4, origin_budget=1) \
            if defences else {}
        jsim, tsim = pair(time_kw=time_kw)
        st = mid_flight(tsim, 7)
        for seed in (0, 5):
            key = jax.random.PRNGKey(seed)
            stride = int(jax.random.randint(key, (), 1, tsim.p.n,
                                            dtype=jnp.int32))
            now = 8 * 200
            want = jsim._push_pull_stride(to_jax(st), key, now)
            got = tsim._push_pull_stride(st, stride, now)
            assert_states_equal(want, got, f"push-pull stride {stride}")

    @pytest.mark.parametrize("quorum", [0.995, 1.0])
    @pytest.mark.parametrize("deep_every", [0, 1])
    @pytest.mark.parametrize("short_ttl", [False, True])
    def test_floor_advance_and_sweep(self, quorum, deep_every, short_ttl):
        time_kw = dict(push_pull_interval_s=1.0)
        if short_ttl:   # records expire: the floor moves under the sweep
            time_kw.update(alive_lifespan_s=2.0, draining_lifespan_s=3.0,
                           tombstone_lifespan_s=4.0)
        jsim, tsim = pair(time_kw=time_kw, fold_quorum=quorum,
                          deep_sweep_every=deep_every)
        st = mid_flight(tsim, 19, burst=60)
        for round_idx in (20, 30):
            now = round_idx * 200
            want = jsim._floor_advance_and_sweep(to_jax(st), now)
            got = tsim._floor_advance_and_sweep(st, now)
            assert_states_equal(want, got, f"sweep r{round_idx}")
            st = got


class TestCensus:
    def _check(self, jsim, tsim, st, path):
        assert tsim.census_path(st) == path
        js = to_jax(st)
        np.testing.assert_array_equal(tsim.behind(st).numpy(),
                                      np.asarray(jsim.behind(js)))
        np.testing.assert_array_equal(tsim.convergence(st).numpy(),
                                      np.asarray(jsim.convergence(js)))

    def test_fast_list_path(self):
        jsim, tsim = pair()
        st = mid_flight(tsim, 3)
        self._check(jsim, tsim, st, "fast_list")
        assert float(tsim.behind(st)) > 0          # premise: in flight

    def test_fast_path_over_cap(self):
        jsim, tsim = pair(metric_inflight_cap=8)
        st = mid_flight(tsim, 3)
        self._check(jsim, tsim, st, "fast")

    def test_exact_path_draining(self):
        jsim, tsim = pair()
        st = mid_flight(tsim, 3)
        st = tsim.mint(st, np.arange(10, 16), 900, DRAINING)
        st = tsim.run_fast(st, 2, generator=torch.Generator().manual_seed(2))
        self._check(jsim, tsim, st, "exact")

    def test_exact_path_dead_node(self):
        jsim, tsim = pair()
        st = mid_flight(tsim, 3)
        alive = st.node_alive.clone()
        alive[7] = False
        self._check(jsim, tsim, dataclasses.replace(st, node_alive=alive),
                    "exact")

    @pytest.mark.parametrize("rounds", [0, 2, 6, 15])
    def test_paths_agree_when_all_apply(self, rounds):
        _, tsim = pair()
        st = mid_flight(tsim, rounds)
        exact = tsim._behind_exact(st)[0]
        fast = tsim._behind_fast(st)[0]
        listed = tsim._behind_fast_list(st)[0]
        assert torch.equal(exact, fast) and torch.equal(fast, listed)


class TestPortInvariants:
    def test_state_stays_contiguous(self):
        """The CUDA wrappers refuse strided tensors, so every state
        field must stay contiguous through mint and the round."""
        _, tsim = pair(k=8, topo=jtopo.complete(48))
        st = mid_flight(tsim, 21)
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            if isinstance(v, torch.Tensor):
                assert v.is_contiguous(), f.name

    def test_fused_and_unfused_paths_agree(self):
        _, fused = pair()
        unfused = tc.CompressedSim(fused.p, fused.topo, fused.t,
                                   device="cpu", fused_gather=False)
        a = mid_flight(fused, 12)
        b = mid_flight(unfused, 12)
        assert all(np.array_equal(x, y) for x, y in zip(
            convert.state_to_numpy(a).values(),
            convert.state_to_numpy(b).values()))

    def test_drivers_agree_and_chunk(self):
        """step/run_fast/run/run_behind on one generator stream: chunked
        equals straight, and the sampled curves have one point per
        ``every`` rounds."""
        _, tsim = pair()
        st = mid_flight(tsim, 0)
        g1, g2 = torch.Generator().manual_seed(4), \
            torch.Generator().manual_seed(4)
        straight, curve = tsim.run_behind(st, 12, 4, generator=g1)
        chunk = tsim.step(st, generator=g2)
        chunk = tsim.run_fast(chunk, 7, generator=g2)
        chunk, conv = tsim.run(chunk, 4, 2, generator=g2)
        assert curve.shape == (3,) and conv.shape == (2,)
        assert all(np.array_equal(x, y) for x, y in zip(
            convert.state_to_numpy(straight).values(),
            convert.state_to_numpy(chunk).values()))
        assert conv[-1] == tsim.convergence(straight)
        with pytest.raises(ValueError, match="generator"):
            tsim.run_fast(st, 2)
        with pytest.raises(ValueError, match="divisible"):
            tsim.run_behind(st, 5, 2, generator=g1)
