"""The host-side pieces the port's bridge reads, each against the JAX
package's own: ``ops/merge.merge_records``, ``ops/suspicion``'s
``ProtocolParams`` and ``QuarantineScorer``, ``catalog/damping``'s
``FlapDamper`` and ``TransitionReplay``, ``service``'s status names and
JSON forms, ``catalog/state``'s ``Server`` and ``decode``, and the span
ring of ``telemetry/span``.  Every comparison is exact: equal values,
equal decisions, equal error texts."""

import dataclasses
import importlib
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sidecar_tpu import metrics as jmetrics
from sidecar_tpu import service as jsvc
from sidecar_tpu.catalog import damping as jdamp
from sidecar_tpu.catalog import state as jstate
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import merge as jmerge
from sidecar_tpu.ops import suspicion as jsus
from sidecar_tpu_torch import metrics as tmetrics
from sidecar_tpu_torch import service as tsvc
from sidecar_tpu_torch.catalog import damping as tdamp
from sidecar_tpu_torch.catalog import state as tstate
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import merge as tmerge
from sidecar_tpu_torch.ops import suspicion as tsus

# The span modules (the reference's package re-exports the class under
# the module's name).
jspan = importlib.import_module("sidecar_tpu.telemetry.span")
tspan = importlib.import_module("sidecar_tpu_torch.telemetry.span")

NS = jsvc.NS_PER_SECOND
T0 = 1_700_000_000 * NS


def raised(fn, *args, **kw):
    """``(exception type name, text)`` of what ``fn`` raises, else
    None."""
    try:
        fn(*args, **kw)
    except (ValueError, TypeError, KeyError) as exc:
        return type(exc).__name__, str(exc)
    return None


# -- merge_records ---------------------------------------------------------------

@pytest.mark.parametrize("future", [None, 40])
def test_merge_records_equals_reference(future):
    rng = np.random.default_rng(3)
    shape = (16, 24)
    kts = rng.integers(0, 400, shape).astype(np.int32)
    its = rng.integers(0, 400, shape).astype(np.int32)
    kst = rng.integers(0, 6, shape).astype(np.int32)
    ist = rng.integers(0, 6, shape).astype(np.int32)
    now, stale = 300, 150
    want = jmerge.merge_records(jnp.asarray(kts), jnp.asarray(kst),
                                jnp.asarray(its), jnp.asarray(ist), now,
                                stale, future)
    got = tmerge.merge_records(torch.from_numpy(kts),
                               torch.from_numpy(kst),
                               torch.from_numpy(its),
                               torch.from_numpy(ist), now, stale, future)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all()


# -- ProtocolParams and QuarantineScorer -----------------------------------------

PROTOCOL_DOCS = [
    None, {}, {"suspicion_window_s": 2}, {"damping_threshold": "3.5"},
    {"origin_budget": 2.9, "origin_quarantine": "4"},
    {"damping_threshold": 2.0, "damping_reuse_threshold": 0.5,
     "damping_half_life_s": 30, "future_fudge_s": 0.25},
    {"suspicion_windows_s": 1.0}, {"suspicion_window_s": -1.0},
    {"damping_half_life_s": 0.0}, {"damping_threshold": -2.0},
    {"damping_threshold": 1.0, "damping_reuse_threshold": 2.0},
    {"origin_budget": "x"},
]


@pytest.mark.parametrize("doc", PROTOCOL_DOCS)
def test_protocol_params_from_json_equals_reference(doc):
    err = raised(jsus.ProtocolParams.from_json, doc)
    assert raised(tsus.ProtocolParams.from_json, doc) == err
    if err is not None:
        return
    j, t = jsus.ProtocolParams.from_json(doc), tsus.ProtocolParams.from_json(
        doc)
    assert t.to_json() == j.to_json()
    assert [type(v) for v in t.to_json().values()] == \
        [type(v) for v in j.to_json().values()]
    assert t.resolved_reuse_threshold == j.resolved_reuse_threshold
    assert dataclasses.asdict(t.timecfg(TimeConfig())) == \
        dataclasses.asdict(j.timecfg(JTimeConfig()))


def test_protocol_params_from_config():
    cfg = types.SimpleNamespace(suspicion_window=4.0, damping_half_life=30.0,
                                damping_threshold=2.5, future_fudge=0.5,
                                origin_budget=2, origin_quarantine=5)
    assert tsus.ProtocolParams.from_config(cfg).to_json() == \
        jsus.ProtocolParams.from_config(cfg).to_json()


def claim_stream(seed=9, pushes=200):
    """Pushes from five origins, each a packet of (owned, timestamp)
    claims around ``now``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(pushes):
        k = int(rng.integers(0, 5))
        claims = [(bool(rng.random() < 0.3), int(rng.integers(30, 80)))
                  for _ in range(k)]
        out.append((f"o{int(rng.integers(0, 5))}", claims,
                    int(rng.integers(45, 55))))
    return out


@pytest.mark.parametrize("budget,threshold", [(1, 3), (0, 1), (2, 10),
                                              (-1, -1), (0, -1)])
def test_quarantine_scorer_equals_reference(budget, threshold):
    kw = dict(origin_budget=budget, origin_quarantine=threshold)
    j = jsus.QuarantineScorer(jsus.ProtocolParams(**kw))
    t = tsus.QuarantineScorer(tsus.ProtocolParams(**kw))
    assert t.enabled == j.enabled
    for origin, claims, now in claim_stream():
        assert t.observe(origin, claims, now) == \
            j.observe(origin, claims, now)
        assert t.is_quarantined(origin) == j.is_quarantined(origin)
    assert t.violations == j.violations
    assert t.quarantined() == j.quarantined()


# -- the flap damper -------------------------------------------------------------

def damping_counts(mod):
    return {k: mod.metrics.counter(k) for k in (
        "damping.flaps", "damping.suppressed", "damping.reinstated")}


def status_stream(seed, n_svc=6, steps=300):
    """Observations of a few services: a random walk over the statuses
    (SUSPECT and first sightings included) on an advancing clock."""
    rng = np.random.default_rng(seed)
    now = T0
    out = []
    for _ in range(steps):
        now += int(rng.integers(0, 8 * NS))
        sid = f"svc-{int(rng.integers(0, n_svc))}"
        out.append((f"h{sid[-1]}", sid,
                    int(rng.choice([0, 0, 1, 2, 4, 5, -1])), now))
    return out


@pytest.mark.parametrize("knobs", [
    dict(half_life_s=10.0, threshold=2.0),
    dict(half_life_s=60.0, threshold=3.0, reuse_threshold=0.5,
         flap_penalty=1.5),
    dict(half_life_s=1e6, threshold=3.0),
    dict(half_life_s=5.0, threshold=0.0),
])
def test_transition_replay_and_damper_equal_reference(knobs):
    """One observation stream through both packages' replay and damper:
    the same flaps, penalties, suppressions, snapshots and metric
    moves, checked along the way."""
    clock = [T0]
    j = jdamp.FlapDamper(**knobs, now_fn=lambda: clock[0])
    t = tdamp.FlapDamper(**knobs, now_fn=lambda: clock[0])
    jr, tr = jdamp.TransitionReplay(j), tdamp.TransitionReplay(t)
    for sid in ("svc-0", "svc-1"):
        jr.prime(sid, jsvc.ALIVE)
        tr.prime(sid, tsvc.ALIVE)
    jbefore, tbefore = damping_counts(jdamp), damping_counts(tdamp)
    for i, (host, sid, status, now) in enumerate(status_stream(4)):
        clock[0] = now
        jr.see(host, sid, status, now)
        tr.see(host, sid, status, now)
        if i % 25 == 0:
            key = (host, sid)
            assert t.penalty(key) == j.penalty(key)
            assert t.suppressed(key) == j.suppressed(key)
            assert t.damped() == j.damped()
    end = clock[0] + 7 * NS
    assert tr.flaps == jr.flaps
    assert t.damped(end) == j.damped(end)
    assert t.snapshot(end) == j.snapshot(end)
    svc = types.SimpleNamespace(hostname="h1", id="svc-1")
    assert t.admitted(svc, end) == j.admitted(svc, end)
    jafter, tafter = damping_counts(jdamp), damping_counts(tdamp)
    assert {k: tafter[k] - tbefore[k] for k in tafter} == \
        {k: jafter[k] - jbefore[k] for k in jafter}
    assert tmetrics.snapshot()["gauges"]["damping.damped_services"] == \
        jmetrics.snapshot()["gauges"]["damping.damped_services"]


def test_damper_unit_cases_equal_reference():
    """The reference's unit cases: discovery is not a flap, a
    same-liveness transition is not, suppression with hysteresis and
    readmission by decay, threshold 0 never suppresses."""
    for mod_s, mod_d in ((jsvc, jdamp), (tsvc, tdamp)):
        clock = [T0]
        d = mod_d.FlapDamper(half_life_s=10.0, threshold=2.0,
                             now_fn=lambda: clock[0])
        svc = mod_s.Service(id="i1", hostname="h1", updated=T0,
                            status=mod_s.ALIVE)
        d.observe(svc, mod_s.UNKNOWN)
        assert d.penalty(("h1", "i1")) == 0.0
        svc.status = mod_s.DRAINING
        d.observe(svc, mod_s.TOMBSTONE)
        assert d.penalty(("h1", "i1")) == 0.0
        for prev, new in ((mod_s.ALIVE, mod_s.TOMBSTONE),
                          (mod_s.TOMBSTONE, mod_s.ALIVE)):
            svc.status = new
            d.observe(svc, prev)
        assert not d.admitted(svc)
        clock[0] += 5 * NS
        assert not d.admitted(svc)
        clock[0] += 20 * NS
        assert d.admitted(svc)
        zero = mod_d.FlapDamper(half_life_s=10.0, threshold=0.0,
                                now_fn=lambda: clock[0])
        for _ in range(10):
            svc.status = mod_s.TOMBSTONE
            zero.observe(svc, mod_s.ALIVE)
            svc.status = mod_s.ALIVE
            zero.observe(svc, mod_s.TOMBSTONE)
        assert zero.admitted(svc) and zero.damped() == set()
    for bad in (dict(half_life_s=0.0), dict(threshold=1.0,
                                             reuse_threshold=2.0)):
        assert raised(tdamp.FlapDamper, **bad) == \
            raised(jdamp.FlapDamper, **bad)
    proto = dict(damping_threshold=4.0, damping_half_life_s=20.0,
                 damping_flap_penalty=2.0)
    t = tdamp.FlapDamper.from_protocol(tsus.ProtocolParams(**proto))
    j = jdamp.FlapDamper.from_protocol(jsus.ProtocolParams(**proto))
    assert (t.half_life_s, t.threshold, t.reuse_threshold,
            t.flap_penalty) == (j.half_life_s, j.threshold,
                                j.reuse_threshold, j.flap_penalty)


# -- service and catalog wire forms ----------------------------------------------

def test_status_names_equal_reference():
    for code in range(8):
        assert tsvc.status_string(code) == jsvc.status_string(code)
    for name in ("ALIVE", "TOMBSTONE", "UNHEALTHY", "UNKNOWN", "DRAINING",
                 "SUSPECT", "NS_PER_SECOND"):
        assert getattr(tsvc, name) == getattr(jsvc, name)


TIMES = [0, T0, T0 + 1, T0 + 120_000_000, 1_234_567_890_123_456_789]


def test_timestamps_equal_reference():
    for ns in TIMES:
        text = tsvc.ns_to_rfc3339(ns)
        assert text == jsvc.ns_to_rfc3339(ns)
        assert tsvc.rfc3339_to_ns(text) == jsvc.rfc3339_to_ns(text) == ns
    for text in ("2023-11-14T22:13:20+02:00", "2023-11-14T22:13:20.5-01:30",
                 "2023-11-14T22:13:20.123456789z"):
        assert tsvc.rfc3339_to_ns(text) == jsvc.rfc3339_to_ns(text)


def catalog_pair(hosts=3, spn=2):
    """The same catalog built as the reference's state (its writer path)
    and decoded by the port from the reference's encoding."""
    ref = jstate.ServicesState(hostname="h0", cluster_name="c1")
    ref.set_clock(lambda: T0)
    for hi in range(hosts):
        for si in range(spn):
            ref.add_service_entry(jsvc.Service(
                id=f"h{hi}-s{si}", name=f"app{si}", image="img:2",
                created=T0 - NS, hostname=f"h{hi}",
                ports=[jsvc.Port("tcp", 10000 + si, 80, "10.0.0.1")],
                updated=T0 + hi * NS + si,
                status=(jsvc.ALIVE, jsvc.DRAINING)[si % 2]))
    return ref, tstate.decode(ref.encode())


def test_service_and_server_round_trips():
    ref, port = catalog_pair()
    assert port.encode() == ref.encode()
    assert port.to_json() == ref.to_json()
    for host, server in ref.servers.items():
        tserver = port.servers[host]
        assert tserver.to_json() == server.to_json()
        again = tstate.Server.from_json(json.loads(json.dumps(
            server.to_json())))
        assert again.to_json() == server.to_json()
        for sid, svc in server.services.items():
            tsv = tserver.services[sid]
            assert tsv.to_json() == svc.to_json()
            assert tsvc.Service.from_json(json.loads(svc.encode())) == tsv
    assert (port.hostname, port.cluster_name, port.last_changed) == \
        (ref.hostname, ref.cluster_name, ref.last_changed)
    assert port.autopilot_report is None


BAD_STATES = [b"{not json", b"[1, 2]", b'{"Servers": {"h": {"Services": '
              b'{"x": {"Status": "up"}}}}}', b'{"Servers": {"h": '
              b'{"Services": {"x": {"Ports": {"a": 1}}}}}}',
              b'{"Hostname": 7}', b'{"Servers": {"h": {"Services": '
              b'{"x": {"Updated": [1]}}}}}', b'{"LastChanged": "soon"}']


@pytest.mark.parametrize("payload", BAD_STATES)
def test_decode_errors_equal_reference(payload):
    want = raised(jstate.decode, payload)
    assert want is not None and want[0] == "ValueError"
    assert raised(tstate.decode, payload) == want


# -- the span ring ---------------------------------------------------------------

def span_trace(mod, rounds):
    """Nested spans on one thread, read through the ring's cursor (a
    page limit, and a cursor behind the ring): the spans' structure
    (name, error, nesting) with the cursors and ``dropped`` counts
    relative to the start."""
    mod.reset_spans()
    start = mod.spans_since(0)["next_since"]
    for i in range(rounds):
        with mod.span(f"outer{i % 3}"):
            with mod.span("inner"):
                pass
    reads = []
    cursor = start
    while True:
        page = mod.spans_since(cursor, limit=500)
        if not page["spans"]:
            break
        reads.append(([(s["name"], s["error"], s["parent_id"] is None,
                        s["trace_id"] == s["span_id"])
                       for s in page["spans"]],
                      page["next_since"] - start, page["dropped"]))
        cursor = page["next_since"]
    return reads, mod.spans_since(start)["dropped"], len(mod.spans()), \
        len(mod.spans(limit=7))


def test_span_ring_cursor_and_dropped_equal_reference():
    """Both rings hold 1,024 spans: 700 rounds of two spans overflow
    them, so a cursor from the start reads ``dropped`` > 0."""
    want = span_trace(jspan, 700)
    got = span_trace(tspan, 700)
    assert got == want
    assert got[1] == 2 * 700 - tspan.RING_CAPACITY
    chrome = tspan.spans_to_chrome(tspan.spans(limit=4))
    assert chrome == jspan.spans_to_chrome(tspan.spans(limit=4))
    assert [e["ph"] for e in chrome][:1] == ["M"]
