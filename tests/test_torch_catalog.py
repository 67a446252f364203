"""The port's live catalog writer (``sidecar_tpu_torch/catalog/state.py``
and what it runs: ``service``, ``output``, ``runtime/looper``, the
digest ladder of ``ops/digest``, ``telemetry/coherence`` and
``telemetry/propagation``) against the JAX package's.

One seeded script of about 300 operations runs on a port state and a
JAX state on one clock.  After every operation the two states' wire
documents, annotated wire documents, published digests and every
ladder level must be equal; at the end, the listener events, the
broadcasts, ``format()``, the defence counters, the damper, the origin
gate and both monitors.  Then the wire: hostile payloads, the Go
fixture, ``decode`` of an annotated body and ``decode_stream``."""

import io
import json
import pathlib
import threading

import pytest

from tests.torch_live import (
    NS,
    SIDES,
    T0,
    Clock,
    apply,
    counters,
    drain_queue,
    events_json,
    join_senders,
    ladder,
    make_script,
    make_state,
    reset_live,
    service,
)

FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "fixtures"
PORT, JAX = SIDES["port"], SIDES["jax"]
DEFENCE = ("defense.live.", "clock.live.rejectedFuture")


@pytest.fixture
def live(monkeypatch):
    reset_live(monkeypatch)
    yield
    join_senders()


def assert_same_state(a, b, where):
    assert a.encode() == b.encode(), where
    assert a.encode_annotated() == b.encode_annotated(), where
    assert a.digest_snapshot == b.digest_snapshot, where
    assert ladder(a) == ladder(b), where


@pytest.mark.parametrize("seed", [1, 2])
def test_writer_script_equals_reference(live, seed):
    clock = Clock()
    states = {k: make_state(side, clock) for k, side in SIDES.items()}
    steps = {k: {} for k in SIDES}
    ops = make_script(seed)
    kinds = set()
    for i, op in enumerate(ops):
        for k, side in SIDES.items():
            apply(side, states[k], clock, op, steps[k])
        kinds.add(op[0])
        assert_same_state(states["port"], states["jax"], (i, op))
    assert kinds >= {"add", "merge", "expire", "tomb_local", "tomb_others",
                     "bcast", "track", "tick"}
    port, ref = states["port"], states["jax"]
    for name in ("big", "small"):
        lp = {x.name(): x for x in port.get_listeners()}[name]
        lj = {x.name(): x for x in ref.get_listeners()}[name]
        ep, ej = events_json(lp), events_json(lj)
        assert ep == ej, name
    assert len(ep) == 20                       # the small queue filled
    bp, bj = drain_queue(port.broadcasts), drain_queue(ref.broadcasts)
    assert bp == bj
    assert any(b is None for b in bp) and any(b for b in bp)
    assert port.format(["h0", "h1"]) == ref.format(["h0", "h1"])
    cp, cj = counters(PORT, DEFENCE), counters(JAX, DEFENCE)
    assert cp == cj
    assert cp.get("defense.live.rejectedQuarantine", 0) > 0
    assert cp.get("defense.live.originViolations", 0) > 0
    assert cp.get("clock.live.rejectedFuture", 0) > 0
    assert port.origin_gate.violations == ref.origin_gate.violations
    assert port.flap_damper.snapshot() == ref.flap_damper.snapshot()
    assert PORT.telemetry_coherence.snapshot() == \
        JAX.telemetry_coherence.snapshot()
    pp = PORT.telemetry_propagation.snapshot()
    assert pp == JAX.telemetry_propagation.snapshot()
    assert pp["sites"]["catalog"]["origins"]


def test_writer_rules_one_by_one(live):
    """The admission rules, each on its own record, on both packages:
    a newer stamp wins, an equal or older one loses, Draining stays
    sticky against Alive, a stale record and one past the future bound
    are dropped, and a quarantined origin's records are rejected."""
    clock = Clock(T0 + 100 * NS)
    out = {}
    for k, side in SIDES.items():
        st = make_state(side, clock, listeners=False)
        add = st.add_service_entry
        add(service(side, "h1", "h1-s0", T0, 0))
        add(service(side, "h1", "h1-s0", T0 + 1, 4))         # newer: Draining
        add(service(side, "h1", "h1-s0", T0 + 2, 0))         # sticky
        add(service(side, "h1", "h1-s0", T0 + 2, 2))         # equal: loses
        add(service(side, "h1", "h1-s0", T0 - 5, 1))         # older: loses
        add(service(side, "h1", "h1-s1", T0 - 4 * 3600 * NS, 0))   # stale
        add(service(side, "h1", "h1-s2", clock.now + 2 * NS, 0))   # future
        add(service(side, "h1", "h1-s3", clock.now + NS // 5, 0))  # in bound
        quarantined = service(side, "h2", "h2-s0", T0, 0)
        st.origin_gate.violations["h7"] = 3
        quarantined.gossip_origin = "h7"
        add(quarantined)
        out[k] = (st.encode(), ladder(st), counters(side, DEFENCE))
    assert out["port"] == out["jax"]
    doc = json.loads(out["port"][0])
    services = doc["Servers"]["h1"]["Services"]
    assert services["h1-s0"]["Status"] == 4
    assert set(services) == {"h1-s0", "h1-s3"}
    assert "h2" not in doc["Servers"]
    assert out["port"][2]["defense.live.rejectedQuarantine"] == 1


def test_local_lookups_and_views(live):
    clock = Clock(T0 + 10 * NS)
    out = {}
    for k, side in SIDES.items():
        st = make_state(side, clock, listeners=False)
        for h, s, status in (("h0", "h0-s1", 0), ("h0", "h0-s0", 4),
                             ("h3", "h3-s2", 1), ("h3", "h3-s0", 0)):
            st.add_service_entry(service(side, h, s, T0, status,
                                         name="web"))
        got = st.get_local_service_by_id("h0-s1")
        with pytest.raises(KeyError):
            st.get_local_service_by_id("h3-s2")
        svc = st.servers["h0"].services["h0-s1"]
        out[k] = (got.to_json(), svc.version(), svc.listener_name(),
                  svc.port_for_service_port(80),
                  svc.port_for_service_port(81), svc.is_alive(),
                  svc.is_draining(), svc.is_tombstone(),
                  svc.is_stale(now=clock.now),
                  st.servers["h0"].has_service("h0-s0"),
                  [(h, s) for h, s, _ in st.each_service()],
                  [(h, s) for h, s, _ in st.each_service_sorted()],
                  {n: [x.id for x in v] for n, v in st.by_service().items()},
                  st.format(), side.service.format_service(svc, clock.now),
                  st.ladder_geometry(), st.digest_doc(),
                  [x.id for x in st.services_in_buckets(range(512), 1024)],
                  st.is_new_service(svc))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("delta_s", [0, 1, 59, 61, 90, 3599, 3600, 5400,
                                     86_399, 86_400, 200_000, -1])
def test_time_ago_equals_reference(delta_s):
    from sidecar_tpu import output as jout
    from sidecar_tpu_torch import output as tout

    ref = T0 + delta_s * NS
    for when in (0, T0):
        assert tout.time_ago(when, ref) == jout.time_ago(when, ref)


def test_bad_geometry_raises():
    st = PORT.catalog_state
    with pytest.raises(ValueError):
        st.ServicesState(hostname="h", digest_buckets=48)
    with pytest.raises(ValueError):
        st.ServicesState(hostname="h", ladder_depth=0)
    small = st.ServicesState(hostname="h", digest_buckets=16, ladder_depth=2)
    assert small.ladder_geometry() == (16, 2)


def test_listener_registry(live):
    clock = Clock()
    for side in SIDES.values():
        st = make_state(side, clock, listeners=False)
        st.add_listener(side.catalog_state.QueueListener("l1"))
        st.add_listener(side.catalog_state.QueueListener("l0", buffer=0))
        assert [x.name() for x in st.get_listeners()] == ["l1"]
        st.remove_listener("l1")
        with pytest.raises(KeyError):
            st.remove_listener("l1")


def test_writer_thread_and_stop(live):
    """``update_service`` feeds the one writer thread; ``stop_processing``
    ends it; the result equals the reference's."""
    clock = Clock(T0 + 5 * NS)
    out = {}
    for k, side in SIDES.items():
        st = make_state(side, clock, listeners=False)
        writer = threading.Thread(
            target=st.process_service_msgs,
            args=(side.runtime_looper.TimedLooper(0.0),))
        writer.start()
        for i in range(60):
            st.update_service(service(side, f"h{i % 8}", f"h{i % 8}-s{i % 4}",
                                      T0 + i, 0))
        assert st.offer_service(service(side, "h1", "h1-s9", T0, 0),
                                timeout=5.0)
        st.stop_processing()
        writer.join(timeout=30)
        assert not writer.is_alive()
        out[k] = (st.encode(), ladder(st))
    assert out["port"] == out["jax"]


# -- the wire ----------------------------------------------------------------------

CATALOG_PAYLOADS = [
    b"123", b'"str"', b"[]", b"null",
    b'{"Servers": 5}',
    b'{"Servers": {"h": 5}}',
    b'{"Servers": {"h": {"Services": [1, 2]}}}',
    b'{"Servers": {"h": {"Services": {"x": 7}}}}',
    b'{"LastChanged": {}}',
    b'{"Hostname": []}',
    b"\xff\xfe garbage",
]

SERVICE_PAYLOADS = [
    b"123", b"[]", b'{"Ports": 5}', b'{"Ports": [5]}',
    b'{"Ports": [{"Port": []}]}', b'{"Updated": []}',
    b'{"Created": {}}', b'{"Status": "alive-ish"}',
]


@pytest.mark.parametrize("payload", CATALOG_PAYLOADS)
def test_hostile_catalog_payloads_raise_valueerror(payload):
    for side in SIDES.values():
        with pytest.raises(ValueError):
            side.catalog_state.decode(payload)


@pytest.mark.parametrize("payload", SERVICE_PAYLOADS)
def test_hostile_service_payloads_raise_valueerror(payload):
    for side in SIDES.values():
        with pytest.raises(ValueError):
            side.service.decode(payload)


def test_go_fixture_round_trips_byte_for_byte():
    wire = (FIXTURES / "go_wire_state.json").read_bytes()
    st = PORT.catalog_state.decode(wire)
    assert st.encode() == wire
    ann = json.loads(st.encode_annotated())
    assert ann["Digest"] == json.loads(
        JAX.catalog_state.decode(wire).encode_annotated())["Digest"]
    assert ann["Digest"]["Ladder"]["Depth"] >= 1
    for _, _, svc in st.each_service():
        assert PORT.service.decode(svc.encode()).to_json() == svc.to_json()


def test_annotated_wire_carries_the_catalog_across(live):
    """``decode`` of the JAX state's annotated body keeps its
    ``wire_digest``; replaying its records through the port's writer
    finds the JAX state's digest at every level."""
    clock = Clock()
    ref = make_state(JAX, clock)
    steps = {}
    for op in make_script(5, 120):
        apply(JAX, ref, clock, op, steps)
    body = ref.encode_annotated()
    got = PORT.catalog_state.decode(body)
    assert got.wire_digest == ref.digest_doc()
    assert got.encode() == ref.encode()
    live_state = PORT.catalog_state.ServicesState(hostname="copy")
    # The script's start: no record it kept is stale there.
    live_state.set_clock(Clock(T0))
    for _, _, svc in got.each_service_sorted():
        live_state.add_service_entry(svc.copy())
    assert ladder(live_state) == ladder(ref)
    assert live_state.digest_snapshot == ref.digest_snapshot


def test_decode_stream_makes_the_same_callbacks():
    svc = service(PORT, "h1", "h1-s0", T0, 0).to_json()
    lines = [json.dumps({"web": [svc, svc]}), "", json.dumps({"db": []}),
             json.dumps({"web": [{"Ports": 5}]}), json.dumps({"x": []})]
    for bad_first in (False, True):
        text = "\n".join((["[1, 2]"] if bad_first else []) + lines) + "\n"
        calls = {}
        for k, side in SIDES.items():
            got = []

            def cb(mapping, err, got=got):
                got.append(None if mapping is None else
                           {n: [s.to_json() for s in v]
                            for n, v in mapping.items()})
                got.append(None if err is None else type(err).__name__)

            side.catalog_state.decode_stream(io.StringIO(text), cb)
            calls[k] = got
        assert calls["port"] == calls["jax"]
        assert calls["port"][-1] is not None


def test_change_event_round_trip():
    for side in SIDES.values():
        ev = side.catalog_state.ChangeEvent(
            service=service(side, "h1", "h1-s0", T0, 0), previous_status=3,
            time=T0 + 7)
        back = side.catalog_state.ChangeEvent.from_json(ev.to_json())
        assert back.to_json() == ev.to_json()
    assert PORT.catalog_state.ChangeEvent(
        service=service(PORT, "h1", "h1-s0", T0, 0), previous_status=3,
        time=T0).to_json() == JAX.catalog_state.ChangeEvent(
        service=service(JAX, "h1", "h1-s0", T0, 0), previous_status=3,
        time=T0).to_json()


def test_loopers():
    """``FreeLooper`` runs n times; a ``TimedLooper`` stops at its count
    or at ``quit``, whose callbacks run; an error ends the loop and is
    kept."""
    lp = PORT.runtime_looper
    calls = []
    free = lp.FreeLooper(3)
    free.loop(lambda: calls.append(1))
    assert calls == [1, 1, 1] and free.wait(0)
    timed = lp.TimedLooper(0.0, count=4)
    timed.loop(lambda: calls.append(2))
    assert calls.count(2) == 4
    forever = lp.TimedLooper(0.01)
    quits = []
    forever.add_quit_callback(lambda: quits.append(True))
    t = lp.run_in_thread(forever, lambda: None, name="forever")
    forever.quit()
    t.join(timeout=10)
    assert not t.is_alive() and quits == [True] and forever.wait(0)
    boom = lp.FreeLooper(5)

    def fail():
        raise RuntimeError("boom")

    boom.loop(fail)
    assert isinstance(boom.error, RuntimeError)
    assert isinstance(lp.monotonic_ms(), int)
