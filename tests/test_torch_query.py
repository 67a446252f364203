"""The port's query plane (``sidecar_tpu_torch/query/``: snapshots, the
hub, relay tiers), its ``UrlListener`` and the coherence and
propagation monitors, each against the JAX package's.

The writer script of ``tests/torch_live.py`` runs on a port state and a
JAX state with hubs attached and small subscription buffers: the events
each subscriber reads — kind, version and wire bytes — must be equal,
coalescing under backpressure included; only ``published_ns`` and the
lag histograms, which read the wall clock, are left out."""

import http.server
import threading
import time

import pytest

from tests.torch_live import (
    NS,
    SIDES,
    T0,
    Clock,
    apply,
    join_senders,
    make_script,
    make_state,
    reset_live,
)

PORT, JAX = SIDES["port"], SIDES["jax"]


@pytest.fixture
def live(monkeypatch):
    reset_live(monkeypatch)
    yield
    join_senders()


def event_view(ev) -> tuple:
    """Everything of a query event but its wall-clock stamp."""
    if ev.kind == "snapshot":
        return ("snapshot", ev.version, ev.snapshot.resync_doc_bytes(),
                ev.snapshot.watch_doc_bytes(True))
    return ("delta", ev.version, ev.delta_doc_bytes(), ev.change_frag(),
            ev.snapshot.encode())


def query_metrics(side) -> dict:
    snap = side.metrics.snapshot()
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith("query.")}
            for kind in ("counters", "gauges")}


def test_hub_replay_equals_reference(live):
    runs = {}
    for k, side in SIDES.items():
        clock = Clock()
        st = make_state(side, clock, listeners=False)
        hub = st.query_hub()
        fast = hub.subscribe("fast", buffer=8)
        slow = hub.subscribe("slow", buffer=3)
        lazy = hub.subscribe("lazy", prime=False)
        steps, seen = {}, []
        for op in make_script(3):
            apply(side, st, clock, op, steps)
            seen.append([event_view(ev) for ev in fast.drain()])
            seen.append(hub.current().encode())
        seen.append([event_view(ev) for ev in slow.drain()])
        got = lazy.get(timeout=0)
        seen.append(event_view(got) if got is not None else None)
        seen.append((fast.pending(), slow.pending(), hub.subscriber_count()))
        for sub in (fast, slow, lazy):
            sub.close()
        seen.append(hub.subscriber_count())
        seen.append([(h, s) for h, s, _ in hub.current().each_service_sorted()])
        seen.append(hub.current().service_count())
        runs[k] = (seen, query_metrics(side))
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1] == runs["jax"][1]
    counts = runs["port"][1]["counters"]
    assert counts["query.hub.coalesced"] > 0
    assert counts["query.hub.dropped"] > counts["query.hub.coalesced"]
    assert counts["query.hub.published"] > 100


def wait_for(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("timed out")
        time.sleep(0.002)


def test_relay_tree_fan_out_equals_reference(live):
    runs = {}
    for k, side in SIDES.items():
        clock = Clock()
        st = make_state(side, clock, listeners=False)
        hub = st.query_hub()
        leaves, relays = side.query_hub.relay_tree(hub, leaves=3,
                                                   max_fanout=2, buffer=64)
        subs = [leaf.subscribe(f"leaf{i}", buffer=16)
                for i, leaf in enumerate(leaves)]
        steps = {}
        try:
            for op in make_script(4)[:60]:
                apply(side, st, clock, op, steps)
            head = hub.current().version
            wait_for(lambda: all(r._last.version == head for r in relays))
            seen = [[event_view(ev) for ev in sub.drain()] for sub in subs]
            shape = ([r.name for r in leaves], [r.name for r in relays],
                     [r.subscriber_count() for r in relays])
        finally:
            for r in relays:
                r.close()
        runs[k] = (seen, shape, [s.closed for s in subs])
    assert runs["port"] == runs["jax"]
    assert len(runs["port"][1][1]) == 5          # two mid relays, 3 leaves
    with pytest.raises(ValueError):
        PORT.query_hub.relay_tree(None, leaves=0)


class _Sink(http.server.BaseHTTPRequestHandler):
    bodies: dict = {}
    lock = threading.Lock()

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        with self.lock:
            self.bodies.setdefault(self.path, []).append(body)
        code = 500 if self.path == "/fail" else 200
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


def test_url_listener_posts_the_reference_bodies(live):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
    port = server.server_address[1]
    _Sink.bodies = {}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    clock = Clock()
    listeners, states, steps = {}, {}, {}
    try:
        for k, side in SIDES.items():
            st = states[k] = make_state(side, clock, listeners=False)
            lst = listeners[k] = side.catalog_url_listener.UrlListener(
                f"http://127.0.0.1:{port}/{k}", retries=0)
            lst.watch(st)
            steps[k] = {}
        assert [x.name() for x in states["port"].get_listeners()] == \
            [f"UrlListener(http://127.0.0.1:{port}/port)"]
        for op in make_script(6)[:80]:
            for k, side in SIDES.items():
                apply(side, states[k], clock, op, steps[k])
                want = states[k].query_hub().current().version - 1
                wait_for(lambda: len(_Sink.bodies.get(f"/{k}", ()))
                         == want)
        assert _Sink.bodies["/port"] == _Sink.bodies["/jax"]
        assert len(_Sink.bodies["/port"]) > 40
        # The legacy and resync shapes, from the same state and event.
        for k, side in SIDES.items():
            ev = side.catalog_state.ChangeEvent(
                service=next(states[k].each_service_sorted())[2],
                previous_status=3, time=T0)
            ul = side.catalog_url_listener
            snap = states[k].query_hub().current()
            _Sink.bodies[k] = (ul.state_changed_event_json(states[k], ev),
                               ul.delta_event_json(7, ev),
                               ul.resync_event_json(snap))
        assert _Sink.bodies["port"] == _Sink.bodies["jax"]
    finally:
        for lst in listeners.values():
            lst.stop()
        for lst in listeners.values():
            lst._thread.join(timeout=10)
        server.shutdown()
        server.server_close()


def test_with_retries_schedule_equals_reference():
    for count in (0, 1, 3):
        runs = {}
        for k, side in SIDES.items():
            slept, calls = [], []

            def fail():
                calls.append(1)
                raise OSError("down")

            err = side.catalog_url_listener.with_retries(count, fail,
                                                         sleep=slept.append)
            runs[k] = (slept, len(calls), type(err).__name__)
        assert runs["port"] == runs["jax"]


# -- the coherence and propagation monitors --------------------------------------

def coherence_observations():
    """Local digests, peer annotations (good, malformed and of another
    geometry), more peers than ``max_peers`` and a return to agreement."""
    dig = PORT.ops_digest
    a = dig.LadderDigest(16, 1)
    b = dig.LadderDigest(16, 1)
    for i in range(20):
        a.add(dig.ident_of("h", f"s{i}"), dig.live_key(T0 + i, 0))
        if i % 3:
            b.add(dig.ident_of("h", f"s{i}"), dig.live_key(T0 + i, 0))

    def doc(d, buckets=16):
        return {"Buckets": buckets, "Records": d.count, "Hex": d.hex()}

    return [
        ("observe", "me", a.value(), dict(buckets=16, records=20,
                                          local=True, version=3)),
        ("doc", "p1", doc(b)),
        ("doc", "p2", doc(a)),
        ("doc", "p3", {"Buckets": 16, "Hex": "zz"}),
        ("doc", "p3", {"Buckets": 8, "Hex": a.hex()}),
        ("doc", "p3", "not a dict"),
        ("doc", "p4", doc(b)),
        ("doc", "p5", doc(a)),
        ("observe", "wide", (0,) * 64, dict(buckets=32)),
        ("doc", "p1", doc(a)),
        ("doc", "p4", doc(a)),
        ("observe", "me", b.value(), dict(buckets=16, local=True,
                                          version=9)),
        ("doc", "p1", doc(b)),
        ("doc", "p2", doc(b)),
        ("doc", "p4", doc(b)),
    ]


@pytest.mark.parametrize("enabled", [True, False])
def test_coherence_monitor_equals_reference(live, enabled):
    mons = {k: side.telemetry_coherence.CoherenceMonitor(enabled=enabled,
                                                         max_peers=4)
            for k, side in SIDES.items()}
    for i, obs in enumerate(coherence_observations()):
        now = T0 + i * NS // 7
        for mon in mons.values():
            if obs[0] == "observe":
                mon.observe(obs[1], obs[2], now_ns=now, **obs[3])
            else:
                mon.observe_doc(obs[1], obs[2], now_ns=now)
        assert mons["port"].snapshot() == mons["jax"].snapshot(), i
    snap = mons["port"].snapshot()
    if enabled:
        assert snap["overflow_peers"] > 0 and snap["ttc"]["count"] > 0
    for mon in mons.values():
        mon.reset()
    assert mons["port"].snapshot() == mons["jax"].snapshot()
    assert coherence_metrics(PORT) == coherence_metrics(JAX)


def coherence_metrics(side) -> dict:
    snap = side.metrics.snapshot()
    return {k: v for k, v in {**snap["counters"], **snap["gauges"]}.items()
            if k.startswith("coherence.")}


@pytest.mark.parametrize("enabled", [True, False])
def test_propagation_meter_equals_reference(live, enabled):
    meters = {k: side.telemetry_propagation.PropagationMeter(
        enabled=enabled, max_origins=3) for k, side in SIDES.items()}
    for i in range(900):
        site = ("catalog", "query")[i % 2]
        origin = f"o{0 if i % 3 else (i // 3) % 5}"
        lag = ((i * 37) % 101) - 5 + i / 1000
        for m in meters.values():
            m.observe(site, origin, lag)
    assert meters["port"].snapshot() == meters["jax"].snapshot()
    if enabled:
        snap = meters["port"].snapshot()["sites"]["catalog"]
        assert snap["overflow_origins"] > 0
        assert max(o["count"] for o in snap["origins"].values()) > 256
    for m in meters.values():
        m.reset()
    assert meters["port"].snapshot() == meters["jax"].snapshot()


def test_module_configure_equals_reference(live):
    for name in ("telemetry_coherence", "telemetry_propagation"):
        docs = []
        for side in SIDES.values():
            mod = getattr(side, name)
            mod.configure(enabled=False)
            off = mod.snapshot()
            mod.configure()
            docs.append((off, mod.snapshot()))
        assert docs[0] == docs[1]
