"""The port's simulator bridge (``sidecar_tpu_torch/bridge``) against
the JAX reference's, on the CPU, exactly.

The catalog is built with the reference's ``ServicesState`` (its writer
path), as ``tests/test_bridge.py`` builds it, with mixed statuses and a
host one service short (a padding slot).  The port's bridge reads it
through the same attributes, and also reads the port's
``catalog.decode`` of its encoding.

* ``simulate`` — each option (cold nodes, ``deltas_cap``, ``trace``,
  ``digest`` with and without ``digest_buckets``, ``provenance`` by
  count and by services, ``protocol`` with the damping prediction,
  ``sparse`` true, false and auto, chunked, ``sharded=True`` at
  ``shards=8`` against the reference's 8 virtual devices) gives the
  reference's report field for field, fed the reference's draws through
  ``draws=``; every mutual exclusion and bad request raises the
  reference's message.
* The port alone: a chunked request equals one dispatch, and the
  sharded twin equals the single-device model.
* ``sweep`` — the table, front, exclusions and SLO blocks equal the
  reference's, each batch fed the reference's per-scenario draws
  (``SimBridge._run_sweep_batch``'s ``inputs``); every named 400
  equals the reference's.
* ``autopilot_recommend`` equals the port controller's ``recommend``.
* ``serve_bridge`` answers the three routes with the library's JSON,
  400 with a message, 404 on an unknown route.
"""

import json
import urllib.error
import urllib.request

import jax
import pytest

from sidecar_tpu import service as S
from sidecar_tpu.bridge import SimBridge as JBridge
from sidecar_tpu.catalog import ServicesState
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu_torch import fleet as tfleet
from sidecar_tpu_torch.autopilot import AutopilotController
from sidecar_tpu_torch.bridge import SimBridge, serve_bridge
from sidecar_tpu_torch.catalog import decode
from sidecar_tpu_torch.models.timecfg import TimeConfig
from tests.torch_parity import (
    jax_exact_draw_seq,
    jax_sharded_exact_draws,
    reference_batch,
    reference_inputs,
)

NS = S.NS_PER_SECOND
T0 = 1_700_000_000 * NS
# Push-pull every 10 rounds; refresh pinned out.
CFG = dict(refresh_interval_s=1000.0, push_pull_interval_s=2.0)
# Records outlive their stamps in 3 s: they expire, and the owners'
# refutations flap them (the damping prediction's input).
FLAPPY = dict(refresh_interval_s=1000.0, alive_lifespan_s=3.0,
              sweep_interval_s=0.4, push_pull_interval_s=2.0)
STATUSES = (S.ALIVE, S.ALIVE, S.DRAINING, S.UNHEALTHY, S.TOMBSTONE)


def make_state(hosts=8, spn=3):
    """``hosts`` hosts of ``spn`` services (host h2 one short), stamped
    over a few seconds, with mixed statuses."""
    names = [f"h{i}" for i in range(hosts)]
    state = ServicesState(hostname=names[0])
    state.set_clock(lambda: T0)
    for hi, host in enumerate(names):
        for si in range(spn - (hi == 2)):
            state.add_service_entry(S.Service(
                id=f"{host}-svc{si}", name=f"app{si}", image="i:1",
                hostname=host, updated=T0 + hi * NS // 2 + si * NS // 7,
                status=STATUSES[(hi + si) % len(STATUSES)]))
    return state


STATE = make_state()


def bridges(cfg=CFG, state=STATE, **kw):
    """The reference bridge and the port's (on the CPU) on one catalog."""
    return (JBridge(state, JTimeConfig(**cfg)),
            SimBridge(state, TimeConfig(**cfg), device="cpu", **kw))


def reference_draws(jb, rounds, seed, sharded=False, board_exchange=None):
    """The reference bridge's round draws for a request."""
    _, _, _, jsim = jb.snapshot(sharded=sharded,
                                board_exchange=board_exchange)
    key = jax.random.PRNGKey(seed)
    if sharded:
        return jax_sharded_exact_draws(jsim, key, 0, rounds)
    return jax_exact_draw_seq(jsim, key, 0, rounds)


def assert_docs_equal(got: dict, want: dict, skip=()):
    """Two JSON documents equal key by key, as their JSON text."""
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            assert json.dumps(got[k]) == json.dumps(want[k]), k


def check_simulate(jb, tb, rounds=30, seed=3, **kw):
    want = jb.simulate(rounds=rounds, seed=seed, **kw).to_json()
    draws = reference_draws(jb, rounds, seed, kw.get("sharded", False),
                            kw.get("board_exchange"))
    got = tb.simulate(rounds=rounds, seed=seed, draws=draws, **kw).to_json()
    assert_docs_equal(got, want)
    return got


SIMULATE_CASES = {
    "plain": {},
    "cold": dict(cold_nodes=["h3", "h6"]),
    "deltas": dict(deltas_cap=12, cold_nodes=["h3"]),
    "trace": dict(trace=12, cold_nodes=["h3"]),
    "digest": dict(digest=20, cold_nodes=["h1"]),
    "digest_buckets": dict(digest=8, digest_buckets=16, cold_nodes=["h1"]),
    "provenance_count": dict(provenance={"count": 4}, cold_nodes=["h5"]),
    "provenance_services": dict(provenance={
        "services": [{"node": "h5", "service": "h5-svc1"},
                     {"node": "h2", "service": "h2-svc0"}], "cap": 9},
        cold_nodes=["h2"]),
    "sparse_true": dict(sparse=True, cold_nodes=["h3"]),
    "sparse_false": dict(sparse=False, cold_nodes=["h3"]),
}


@pytest.mark.parametrize("case", sorted(SIMULATE_CASES))
def test_simulate_equals_reference(case):
    jb, tb = bridges()
    got = check_simulate(jb, tb, **SIMULATE_CASES[case])
    if case == "cold":
        assert got["convergence"][0] < 1.0
        assert len(got["projected"]["h3"]) == 8 * 3 - 1


def test_simulate_protocol_damping_equals_reference():
    jb, tb = bridges(FLAPPY)
    got = check_simulate(jb, tb, rounds=40, seed=1, cold_nodes=["h1"],
                         protocol={"damping_threshold": 1.0,
                                   "damping_half_life_s": 60.0})
    assert got["robustness"]["damped"] and got["robustness"]["flaps"]
    check_simulate(jb, tb, rounds=40, seed=1, protocol={
        "suspicion_window_s": 0.4, "damping_threshold": 2.0,
        "future_fudge_s": 0.5, "origin_budget": 2})


@pytest.mark.parametrize("kw", [
    dict(cold_nodes=["h2"], deltas_cap=12),
    dict(cold_nodes=["h2"]),
    dict(cold_nodes=["h2"], trace=9),
    dict(cold_nodes=["h2"], digest=16),
    dict(cold_nodes=["h2"], provenance={"count": 3}),
], ids=["deltas", "auto", "trace", "digest", "provenance"])
def test_chunked_simulate_equals_reference(kw):
    """7 + 7 + 7 + 4 rounds: the chunks chain their streams, and the
    auto arbiter switches to the sparse round after the first."""
    jb, tb = bridges()
    jb.CHUNK_ROUNDS = tb.CHUNK_ROUNDS = 7
    got = check_simulate(jb, tb, rounds=25, **kw)
    if "deltas_cap" in kw:
        assert [d["round"] for d in got["deltas"]] == list(range(1, 26))
    if kw.keys() == {"cold_nodes"}:
        assert got["sparse"]["switches"] >= 1


@pytest.mark.parametrize("kw", [
    dict(),
    dict(board_exchange="ring", cold_nodes=["h4"]),
    dict(cold_nodes=["h4"], provenance={"count": 3}),
    dict(cold_nodes=["h4"], trace=6),
    dict(cold_nodes=["h4"], digest=6),
], ids=["all_gather", "ring", "provenance", "trace", "digest"])
def test_sharded_simulate_equals_reference(kw):
    """``sharded=True`` at ``shards=8``, the reference on its 8 virtual
    devices, chunked across a push-pull round."""
    jb, tb = bridges(shards=8)
    jb.CHUNK_ROUNDS = tb.CHUNK_ROUNDS = 9
    got = check_simulate(jb, tb, rounds=20, sharded=True, **kw)
    assert got["devices"] == 8
    assert got["board_exchange"] == kw.get("board_exchange", "all_gather")


def test_chunked_equals_single_and_sharded_equals_unsharded():
    """The port's own generator: 7-round chunks equal one dispatch (the
    arbiter's counters aside), and the sharded twin at 4 shards equals it at 1 and equals the single
    device model (push-pull every 100 rounds, past the horizon)."""
    kw = dict(rounds=30, seed=5, cold_nodes=["h3"])
    _, tb = bridges(dict(refresh_interval_s=1000.0), shards=4)
    single = tb.simulate(deltas_cap=16, **kw).to_json()
    tb.CHUNK_ROUNDS = 7
    chunked = tb.simulate(deltas_cap=16, **kw).to_json()
    # The arbiter decides chunk by chunk: only its counters differ.
    assert_docs_equal(chunked, single, ("sparse",))
    assert chunked["sparse"]["sparse_rounds"] > 0
    plain = tb.simulate(**kw).to_json()
    sharded = tb.simulate(sharded=True, **kw).to_json()
    tb.shards = 1
    assert tb.simulate(sharded=True, **kw).to_json() == \
        dict(sharded, devices=1)
    skip = ("board_exchange", "devices")
    assert_docs_equal(sharded, plain, skip)
    assert sharded["convergence"][-1] == 1.0


def test_decoded_catalog_gives_the_same_report():
    tb = SimBridge(decode(STATE.encode()), TimeConfig(**CFG), device="cpu")
    _, ref = bridges()
    kw = dict(rounds=20, seed=2, cold_nodes=["h7"], digest=10)
    assert tb.simulate(**kw).to_json() == ref.simulate(**kw).to_json()


def raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except (ValueError, KeyError, TypeError) as exc:
        return type(exc).__name__, str(exc)
    return None


BAD_SIMULATE = [
    dict(sharded=True, protocol={"damping_threshold": 1.0}),
    dict(sharded=True, deltas_cap=5),
    dict(trace=3, deltas_cap=5),
    dict(trace=3, protocol={"damping_threshold": 1.0}),
    dict(provenance="x"),
    dict(provenance={"count": 2}, deltas_cap=5),
    dict(provenance={"count": 2}, trace=3),
    dict(provenance={"count": 2}, protocol={"damping_threshold": 1.0}),
    dict(digest=3, digest_buckets=12),
    dict(digest=3, deltas_cap=5),
    dict(digest=3, trace=3),
    dict(digest=3, provenance={"count": 2}),
    dict(digest=3, protocol={"damping_threshold": 1.0}),
    dict(protocol={"suspicion_windows_s": 1.0}),
    dict(protocol={"damping_half_life_s": 0.0}),
    dict(cold_nodes=["ghost"]),
    dict(provenance={"tracers": 3}),
    dict(provenance={"count": 0}),
    dict(provenance={"count": 2, "cap": -1}),
    dict(provenance={"services": []}),
    dict(provenance={"services": [{"node": "ghost", "service": "x"}]}),
    dict(provenance={"services": [{"node": "h1", "service": "nope"}]}),
]


@pytest.mark.parametrize("kw", BAD_SIMULATE,
                         ids=[str(i) for i in range(len(BAD_SIMULATE))])
def test_simulate_rejections_equal_reference(kw):
    jb, tb = bridges()
    want = raised(jb.simulate, rounds=4, **kw)
    assert want is not None
    assert raised(tb.simulate, rounds=4, **kw) == want


def test_snapshot_rejections_equal_reference():
    empty = ServicesState(hostname="x")
    jb, tb = bridges(state=empty)
    assert raised(tb.snapshot) == raised(jb.snapshot)
    _, tb = bridges(shards=3)
    assert raised(tb.simulate, rounds=2, sharded=True) == \
        ("ValueError", "n=8 must divide the 3-device mesh")


# -- the sweep ---------------------------------------------------------------------

RUN_SWEEP_BATCH = SimBridge._run_sweep_batch


def lockstep_sweep_batch(batch, run_kw, inputs=None):
    """``SimBridge._run_sweep_batch`` fed the reference's per-scenario
    draws and churn masks."""
    draws, masks, faults = reference_inputs(reference_batch(batch),
                                            run_kw["num_rounds"])
    perturb = None
    if batch.has_churn:
        perturb = tfleet.restart_churn_perturb(batch.params, masks=masks)
    return RUN_SWEEP_BATCH(batch, run_kw, (draws, faults, perturb))


SWEEP_SKIP = ("wall_seconds", "scenarios_per_sec")
SWEEPS = {
    "grid": dict(axes={"push_pull_interval_s": [1.0, 4.0],
                       "drop_prob": [0.0, 0.3]},
                 rounds=30, n=16, provenance=4, conv_every=2,
                 slo=["converge <= 12 rounds", "p99 <= 20 rounds"]),
    "batches": dict(axes={"fanout": [2, 3], "churn_prob": [0.0, 0.05]},
                    rounds=24, n=16, stop=False, eps=0.05,
                    base={"retransmit_limit": 5}),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_equals_reference(monkeypatch, name):
    jb, tb = bridges()
    req = SWEEPS[name]
    want = jb.sweep(**req)
    monkeypatch.setattr(SimBridge, "_run_sweep_batch",
                        staticmethod(lockstep_sweep_batch))
    got = tb.sweep(**req)
    assert_docs_equal(got, want, SWEEP_SKIP)
    assert got["table"] and got["pareto_front"]
    if name == "batches":
        assert got["batches"] == 2


BAD_SWEEPS = [
    dict(rounds=0),
    dict(rounds=10, conv_every=3),
    dict(axes={"topology": ["moebius"]}),
    dict(axes={"drop_prob": [0.1]}, base={"topology": "ring0"}),
    dict(axes={"tick_period": [0]}),
    dict(axes={"tick_phase": [True]}),
    dict(axes={"fault_seed": [1]}),
    dict(axes={"drop_prob": [0.1]}, base={"mint_frac": 0.1}),
    dict(provenance=-1),
    dict(slo="converge <= 3 rounds"),
    dict(slo=[]),
    dict(slo=["p99 <= soon"]),
    dict(axes={"warp_factor": [9]}),
    dict(axes={"drop_prob": []}),
    dict(axes={"drop_prob": [0.1]}, base={"colour": 1}),
]


@pytest.mark.parametrize("kw", BAD_SWEEPS,
                         ids=[str(i) for i in range(len(BAD_SWEEPS))])
def test_sweep_rejections_equal_reference(kw):
    jb, tb = bridges()
    kw = dict({"axes": {"drop_prob": [0.0]}, "rounds": 4, "n": 8}, **kw)
    want = raised(jb.sweep, **kw)
    assert want is not None
    assert raised(tb.sweep, **kw) == want


# -- the autopilot -----------------------------------------------------------------

AUTOPILOT_REQ = {
    "rules": ["converge <= 30 rounds"],
    "estimate": {"loss_rate": 0.2},
    "rounds": 20, "n": 16, "seed": 1, "seed_grid": 1, "generations": 1,
    "population": 2,
    "axes": [{"name": "push_pull_interval_s", "lo": 0.5, "hi": 30.0,
              "log": True, "base": 2.0}],
}


def test_autopilot_recommend_equals_controller():
    jb, tb = bridges()
    got = tb.autopilot_recommend(dict(AUTOPILOT_REQ))
    want = AutopilotController(bridge=tb).recommend(
        device="cpu", **{k: v for k, v in AUTOPILOT_REQ.items()})
    assert_docs_equal(got, want, ("wall_seconds",))
    assert got["replay"]["identical"] is True
    assert got["apply"]["applied"] is False
    assert tb.state.autopilot_report is want
    for bad in (dict(AUTOPILOT_REQ, typo_field=1),
                dict(AUTOPILOT_REQ, estimate={"bogus": 0.1})):
        want = raised(jb.autopilot_recommend, bad)
        assert want is not None
        assert raised(tb.autopilot_recommend, bad) == want


# -- HTTP --------------------------------------------------------------------------

def post(port, route, payload):
    data = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=data,
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_http_routes_return_the_library_json():
    _, tb = bridges()
    server = serve_bridge(tb, port=0)
    try:
        port = server.server_address[1]
        sim_req = {"rounds": 12, "seed": 4, "cold_nodes": ["h3"],
                   "trace": 5, "sparse": True}
        status, doc = post(port, "/simulate", sim_req)
        assert status == 200
        lib = tb.simulate(rounds=12, seed=4, cold_nodes=["h3"], trace=5,
                          sparse=True).to_json()
        assert doc == json.loads(json.dumps(lib))

        sweep_req = {"axes": {"drop_prob": [0.0, 0.2]}, "rounds": 10,
                     "n": 8, "provenance": 2, "slo": ["agreement >= 0.5"]}
        status, doc = post(port, "/sweep", sweep_req)
        assert status == 200
        lib = tb.sweep(sweep_req["axes"], rounds=10, n=8, provenance=2,
                       slo=["agreement >= 0.5"])
        assert_docs_equal(doc, json.loads(json.dumps(lib)), SWEEP_SKIP)

        status, doc = post(port, "/autopilot/recommend", AUTOPILOT_REQ)
        assert status == 200
        lib = tb.autopilot_recommend(dict(AUTOPILOT_REQ))
        assert_docs_equal(doc, json.loads(json.dumps(lib)),
                          ("wall_seconds",))

        for route, body in (("/simulate", b"{not json"),
                            ("/simulate", b"[1, 2]"),
                            ("/simulate", {"rounds": 5, "trace": 3,
                                           "provenance": {"count": 2}}),
                            ("/sweep", {"rounds": 5}),
                            ("/sweep", {"axes": {"x": [1]}}),
                            ("/sweep", {"axes": {"drop_prob": [0.1]},
                                        "base": [1]}),
                            ("/autopilot/recommend", {"typo": 1})):
            status, doc = post(port, route, body)
            assert status == 400 and doc["message"], (route, body)
        status, doc = post(port, "/nowhere", {})
        assert (status, doc) == (404, {"message": "not found"})
    finally:
        server.shutdown()
        server.server_close()
