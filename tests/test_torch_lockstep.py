"""The slice as a whole: the port's bench-shaped run against the JAX
reference under ``SIDECAR_TPU_KERNELS=xla``, exactly.

Bench-shaped: ER(avg degree 8, seed 3), refresh 10,000 s, push-pull
4 s, fold quorum 0.995, no periodic deep sweep, a minted churn burst,
then ``run_behind(every=5)`` for 40 rounds — two push-pull exchanges,
four floor sweeps.  The port takes the reference's own draws through
``draws=``; every state field and every behind sample must be equal.
"""

import jax
import numpy as np
import pytest

from sidecar_tpu.ops import kernels as jax_kernels
from tests.torch_parity import (
    BENCH_TIME,
    assert_states_equal,
    bench_burst,
    er,
    jax_draw_seq,
    port_pair,
)

ROUNDS, EVERY = 40, 5


def run_lockstep(monkeypatch, *, mode, n, fused=True, drop_prob=0.0,
                 burst=0.1):
    monkeypatch.setenv(jax_kernels.ENV_VAR, mode)
    if not fused:
        monkeypatch.setenv(jax_kernels.ENV_FUSED, "0")
    params = dict(n=n, services_per_node=4, fanout=3, budget=15,
                  cache_lines=64, fold_quorum=0.995, deep_sweep_every=0,
                  drop_prob=drop_prob)
    jsim, tsim = port_pair(params, er(n), BENCH_TIME, fused_gather=fused)
    assert jsim._kernels == mode
    slots = bench_burst(jsim.p.m, burst)
    js = jsim.mint(jsim.init_state(), slots, 10)
    ts = tsim.mint(tsim.init_state(), slots, 10)
    assert_states_equal(js, ts, "minted")
    key = jax.random.PRNGKey(0)
    draws = jax_draw_seq(jsim, key, 0, ROUNDS)
    js, jb = jsim.run_behind(js, key, ROUNDS, every=EVERY)
    ts, tb = tsim.run_behind(ts, ROUNDS, every=EVERY, draws=draws)
    assert_states_equal(js, ts, f"after {ROUNDS} rounds")
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    return tb.numpy()


@pytest.mark.parametrize("drop_prob", [0.0, 0.1])
def test_bench_shaped_run_matches_xla(monkeypatch, drop_prob):
    curve = run_lockstep(monkeypatch, mode="xla", n=64,
                         drop_prob=drop_prob)
    # Premise: the burst was in flight for several samples.
    assert curve[0] > 0 and (curve > 0).sum() >= 3
