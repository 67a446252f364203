"""The port's HTTP API (``sidecar_tpu_torch/web/``) and Prometheus
exposition against the JAX package's.

* On one seeded state (``tests/torch_live.py``'s script, applied to a
  port state and a JAX state on one clock), a port ``SidecarApi`` and a
  JAX one give the same status, content type, headers and body bytes on
  every route of ``dispatch``.  The wall-clock fields, left out by name:
  the timers' and histograms' values in ``/metrics`` and
  ``/metrics.json`` (``measure_since`` reads ``perf_counter``; their
  names and counts are compared), ``/debug/stacks`` (the threads' own
  frames) and ``/debug/profile``'s samples (status, type and header
  line compared).  The span ring is set to one fixed list on both sides
  for ``/trace``, and ``now_ns`` is fixed for the drain.
* ``render_prometheus`` gives the same text on the same registry.
* Over HTTP on loopback, a port ``serve_http`` streams ``/watch``
  documents with the JAX server's versions and bodies while the writers
  add records; the UI and static files are served from the directories
  given.
"""

import collections
import http.client
import http.server
import importlib
import json
import socket
import threading
import types

import pytest

from tests.torch_live import (
    NS,
    SIDES,
    T0,
    Clock,
    apply,
    drain_writer,
    join_senders,
    make_script,
    make_state,
    reset_live,
    service,
)

PACKAGES = {"port": "sidecar_tpu_torch", "jax": "sidecar_tpu"}
WEB = {k: importlib.import_module(f"{p}.web") for k, p in PACKAGES.items()}
SPAN = {k: importlib.import_module(f"{p}.telemetry.span")
        for k, p in PACKAGES.items()}
PROM = {k: importlib.import_module(f"{p}.telemetry.prometheus")
        for k, p in PACKAGES.items()}
JAX_COST = importlib.import_module("sidecar_tpu.telemetry.cost")
MEMBERS = ["h2", "h0", "h1"]


class EnvoyStub:
    """A duck-typed Envoy V1 API (the proxies are mounted the same way
    in both packages)."""

    def registration(self, name):
        return (200, {"hosts": [{"ip_address": "10.0.0.1", "port": 80,
                                 "service": name}]}) if name == "web" \
            else (404, {"hosts": []})

    def clusters(self):
        return 200, {"clusters": [{"name": "web:80"}]}

    def listeners(self):
        return 200, {"listeners": []}


class CsvServer:
    """A loopback server answering every GET with one stats CSV."""

    BODY = b"# pxname,svname,status\nweb,BACKEND,UP\n"

    def __init__(self):
        body = self.BODY

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/;csv"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def closed_port_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}/;csv"


@pytest.fixture
def seeded(monkeypatch):
    """A port state and a JAX state after one seeded script, with the
    coherence, propagation and metrics registries reset first and the
    reference's cost registry cleared."""
    reset_live(monkeypatch)
    JAX_COST.reset()            # the reference's registry of programs
    monkeypatch.delenv("SIDECAR_TPU_COST_PHASES", raising=False)
    monkeypatch.delenv("SIDECAR_TPU_PROFILE_DIR", raising=False)
    clock = Clock()
    states = {k: make_state(side, clock) for k, side in SIDES.items()}
    steps = {k: {} for k in SIDES}
    for op in make_script(3, 150):
        for k, side in SIDES.items():
            apply(side, states[k], clock, op, steps[k])
    yield clock, states
    join_senders()


def apis(states, **kw):
    return {k: WEB[k].SidecarApi(states[k], members_fn=lambda: MEMBERS,
                                 cluster_name="test", **kw)
            for k in PACKAGES}


FIXED_SPANS = [
    {"seq": 5, "name": "catalog.merge", "span_id": 11, "parent_id": None,
     "trace_id": 11, "thread": "writer", "start_unix_s": 1700000000.25,
     "duration_ms": 1.5, "error": False},
    {"seq": 6, "name": "gossip.receive", "span_id": 12, "parent_id": 11,
     "trace_id": 11, "thread": "gossip-bridge",
     "start_unix_s": 1700000000.5, "duration_ms": 0.125, "error": True},
    {"seq": 7, "name": "watch.deliver", "span_id": 13, "parent_id": None,
     "trace_id": 13, "thread": "http", "start_unix_s": 1700000001.0,
     "duration_ms": 2.0, "error": False},
]

GET_ROUTES = [
    "/api/services.json", "/services.json", "/api/services.xml",
    "/api/state.json", "/state.json", "/api/state.yaml",
    "/api/services/app1.json", "/api/services/app2.json",
    "/api/services/nope.json", "/api/services/app1.xml",
    "/api/services/.json", "/servers", "/api/servers",
    "/api/trace", "/trace?limit=2", "/api/trace?since=5",
    "/api/trace?since=5&limit=1", "/api/trace?since=0&limit=0",
    "/api/trace?format=chrome", "/api/trace?format=chrome&since=6",
    "/api/trace?format=xml", "/api/trace?limit=x", "/api/trace?since=x",
    "/api/cost.json", "/api/propagation.json", "/api/propagation",
    "/api/digest.json", "/api/coherence.json", "/api/coherence",
    "/api/autopilot.json", "/api/damping.json", "/api/damping",
    "/api/haproxy/stats.csv", "/api/watch", "/watch?by_service=false",
    "/api/watch?since=4", "/api/watch?since=x",
    "/v1/registration/web", "/v1/registration/db", "/v1/clusters",
    "/v1/clusters/a/b", "/v1/listeners", "/v1/listeners/x/y",
    "/v1/clusters/a", "/v1/other", "/api/nowhere", "/api/debug/nothing",
    "/api/debug/profile?seconds=x", "/api/debug/profile?seconds=nan",
]


def route(api, method, url, client=None):
    path, _, qs = url.partition("?")
    query = {}
    for part in filter(None, qs.split("&")):
        k, _, v = part.partition("=")
        query.setdefault(k, []).append(v)
    return api.dispatch(method, path, query, client=client)


def test_every_route_equals_reference(seeded, monkeypatch):
    clock, states = seeded
    for k in PACKAGES:
        monkeypatch.setattr(SPAN[k], "_ring", collections.deque(
            [dict(s) for s in FIXED_SPANS], maxlen=SPAN[k].RING_CAPACITY))
        monkeypatch.setattr(SPAN[k], "_last_seq", 7)
    csv = CsvServer()
    try:
        answers = {}
        for k, api in apis(states, envoy_v1=EnvoyStub(),
                           haproxy_stats_url=csv.url).items():
            answers[k] = [route(api, "GET", url) for url in GET_ROUTES]
            answers[k].append(route(api, "OPTIONS", "/api/services.json"))
            answers[k].append(route(api, "GET", "/api/debug/profile",
                                    client="10.0.0.9"))
            answers[k].append(route(api, "POST", "/api/services/x"))
            answers[k].append(route(api, "POST",
                                    "/api/services/h1-s0/drain"))
            answers[k].append(route(api, "POST", "/api/services//drain"))
    finally:
        csv.close()
    for url, got, want in zip(GET_ROUTES + ["OPTIONS", "profile 403",
                                            "POST x", "POST remote",
                                            "POST empty"],
                              answers["port"], answers["jax"]):
        assert got == want, url
    by_url = dict(zip(GET_ROUTES, answers["port"]))
    # Premise: the routes answer what they are about.
    assert by_url["/api/services.json"][0] == 200
    assert json.loads(by_url["/api/services.json"][2])["ClusterMembers"]
    assert by_url["/api/haproxy/stats.csv"][2] == CsvServer.BODY
    assert json.loads(by_url["/api/trace?since=5"][2])["next_since"] == 7
    assert by_url["/api/watch"] == ("watch", True, None)
    assert by_url["/api/trace?format=xml"][0] == 400
    assert json.loads(by_url["/v1/registration/web"][2])["hosts"]
    assert json.loads(by_url["/api/coherence.json"][2])["enabled"]
    assert json.loads(by_url["/api/propagation.json"][2])["sites"]


def test_without_proxies_and_unreachable_haproxy(seeded):
    _, states = seeded
    url = closed_port_url()
    answers = {}
    for k in PACKAGES:
        bare = WEB[k].SidecarApi(states[k])
        down = WEB[k].SidecarApi(states[k], haproxy_stats_url=url)
        answers[k] = [route(bare, "GET", "/api/haproxy/stats.csv"),
                      route(bare, "GET", "/v1/registration/web"),
                      route(bare, "GET", "/v1/clusters"),
                      route(bare, "GET", "/api/services.json"),
                      route(down, "GET", "/api/haproxy/stats.csv")]
    assert answers["port"] == answers["jax"]
    assert answers["port"][0][0] == 404
    assert answers["port"][4][0] == 502


def test_drain_equals_reference(seeded, monkeypatch):
    clock, states = seeded
    for side in SIDES.values():
        monkeypatch.setattr(side.service, "now_ns", lambda: clock.now + 7)
    local = sorted(states["port"].servers["h0"].services)
    assert local == sorted(states["jax"].servers["h0"].services)
    out = {}
    for k, api in apis(states).items():
        res = [route(api, "POST", f"/api/services/{sid}/drain")
               for sid in local]
        drain_writer(SIDES[k], states[k])
        out[k] = (res, states[k].encode())
    assert out["port"] == out["jax"]
    assert all(r[0] == 202 for r in out["port"][0])


def test_wall_clock_routes_match_in_form(seeded):
    """The routes left out of the byte comparison: ``/metrics`` and
    ``/metrics.json`` equal in counters, gauges and the timers' and
    histograms' names and counts; ``/debug/stacks`` and
    ``/debug/profile`` equal in status, type and form."""
    _, states = seeded
    got = {k: {u: route(api, "GET", u) for u in (
        "/api/metrics.json", "/metrics", "/api/debug/stacks",
        "/api/debug/profile?seconds=0.1")}
        for k, api in apis(states).items()}
    port, ref = got["port"], got["jax"]
    for url in port:
        assert port[url][0] == ref[url][0] == 200, url
        assert port[url][1] == ref[url][1], url
        assert port[url][3] == ref[url][3], url
    jp = json.loads(port["/api/metrics.json"][2])
    jj = json.loads(ref["/api/metrics.json"][2])
    for block in ("counters", "gauges"):
        assert jp[block] == jj[block], block
    for block in ("timers", "histograms"):
        assert {k: v["count"] for k, v in jp[block].items()} == \
            {k: v["count"] for k, v in jj[block].items()}, block
    assert jp["counters"]

    def families(text):
        return [line for line in text.decode().splitlines()
                if line.startswith("# TYPE") or "_total " in line
                or "_count " in line]

    assert families(port["/metrics"][2]) == families(ref["/metrics"][2])
    assert port["/api/debug/stacks"][2].startswith(b"--- thread ")
    for k in got:
        head = got[k]["/api/debug/profile?seconds=0.1"][2].split(b"\n")[0]
        assert head.startswith(b"# CPU profile: ")


def test_coherence_page_when_disabled(seeded, monkeypatch):
    _, states = seeded
    port = SIDES["port"].telemetry_coherence
    monkeypatch.setattr(port.monitor, "enabled", False)
    status, ctype, body, _ = route(apis(states)["port"], "GET",
                                   "/api/coherence")
    assert (status, ctype) == (200, "text/html")
    assert b"Coherence monitor disabled" in body


def fill_registry(side):
    m = side.metrics
    m.incr("query.hub.published", 3)
    m.incr("transport.shedInbound")
    m.incr("9lives")
    m.set_gauge("engine.udpOut", 12)
    m.set_gauge("coherence.agreement", 0.75)
    for v in (1.0, 2.5, 4.0, 0.125, 9.75):
        m.histogram("coherence.ttc", v)
    reg = m.registry
    reg._timers["notifyMsg"] = [4, 1.25, 0.5]
    reg._timers["getBroadcasts"] = [2, 3.0, 1.5]


def test_render_prometheus_equals_reference(monkeypatch):
    reset_live(monkeypatch)
    for side in SIDES.values():
        fill_registry(side)
    texts = {k: PROM[k].render_prometheus() for k in PACKAGES}
    assert texts["port"] == texts["jax"]
    assert "sidecar_query_hub_published_total 3" in texts["port"]
    assert 'sidecar_coherence_ttc_ms{quantile="0.5"}' in texts["port"]
    assert "sidecar__9lives_total 1" in texts["port"]
    snap = SIDES["jax"].metrics.snapshot()
    assert PROM["port"].render_prometheus(snap) == \
        PROM["jax"].render_prometheus(snap)
    answers = {k: route(WEB[k].SidecarApi(
        SIDES[k].catalog_state.ServicesState(hostname="p")), "GET",
        "/metrics") for k in PACKAGES}
    assert answers["port"] == answers["jax"]


# -- over HTTP -------------------------------------------------------------------

class WatchClient:
    """A ``/watch`` reader that returns one document a chunk."""

    def __init__(self, port, path="/watch"):
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=10)
        self.conn.request("GET", path)
        self.resp = self.conn.getresponse()
        assert self.resp.status == 200
        assert self.resp.getheader("Transfer-Encoding") == "chunked"

    def next_doc(self) -> bytes:
        size = int(self.resp.fp.readline().strip(), 16)
        body = self.resp.fp.read(size)
        assert self.resp.fp.read(2) == b"\r\n"
        return body

    def close(self):
        self.conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_watch_stream_and_files_over_http(monkeypatch, tmp_path):
    reset_live(monkeypatch)
    ui = tmp_path / "ui"
    ui.mkdir()
    (ui / "index.html").write_text("<html>ui</html>")
    static = tmp_path / "static"
    static.mkdir()
    (static / "app.js").write_text("var x = 1;")
    clock = Clock(T0 + 5 * NS)
    nodes, servers, clients = {}, {}, {}
    try:
        for k, side in SIDES.items():
            st = make_state(side, clock, gate=False, damper=False,
                            listeners=False)
            st.query_hub()
            looper = side.runtime_looper.TimedLooper(0.0)
            writer = threading.Thread(target=st.process_service_msgs,
                                      args=(looper,), daemon=True)
            writer.start()
            nodes[k] = types.SimpleNamespace(state=st, looper=looper,
                                             writer=writer)
            servers[k] = WEB[k].serve_http(
                WEB[k].SidecarApi(st, members_fn=lambda: MEMBERS,
                                  cluster_name="test"),
                bind="127.0.0.1", port=0, ui_dir=str(ui),
                static_dir=str(static))
        ports = {k: s.server_address[1] for k, s in servers.items()}
        files = {k: [get(p, path) for path in (
            "/ui/", "/ui/missing.html", "/static/app.js",
            "/static/../../etc/passwd", "/api/state.json",
            "/api/services/none.json")] for k, p in ports.items()}
        assert files["port"] == files["jax"]
        assert files["port"][0][2] == b"<html>ui</html>"
        for n, path in enumerate(("/watch", "/api/watch?by_service=false")):
            clients = {k: WatchClient(p, path) for k, p in ports.items()}
            docs = {k: [c.next_doc()] for k, c in clients.items()}
            for i in range(6):
                host = f"h{1 + i % 3}"
                sid = f"{host}-{n}s{i}"
                for k, side in SIDES.items():
                    nodes[k].state.update_service(
                        service(side, host, sid, clock.now - i, i % 3 * 2))
                    docs[k].append(clients[k].next_doc())
            for c in clients.values():
                c.close()
            assert docs["port"] == docs["jax"], path
            versions = [json.loads(d)["Version"] for d in docs["port"]]
            assert versions == list(range(versions[0], versions[0] + 7))
            assert "Snapshot" in json.loads(docs["port"][0])
            assert json.loads(docs["port"][-1])["Deltas"]
        # A client at the current version gets no snapshot: its first
        # document is the next delta.
        head = {k: n.state.query_hub().current().version
                for k, n in nodes.items()}
        assert head["port"] == head["jax"]
        clients = {k: WatchClient(p, f"/watch?since={head[k]}")
                   for k, p in ports.items()}
        for k, side in SIDES.items():
            nodes[k].state.update_service(
                service(side, "h3", "h3-s9", clock.now, 0))
        docs = {k: c.next_doc() for k, c in clients.items()}
        assert docs["port"] == docs["jax"]
        assert json.loads(docs["port"])["From"] == head["port"] + 1
    finally:
        for c in clients.values():
            c.close()
        for k, n in nodes.items():
            hub = n.state.query_hub()
            for sub in list(hub._subs.values()):
                sub.close()
            n.state.stop_processing()
            n.looper.quit()
            n.writer.join(timeout=5.0)
        for s in servers.values():
            s.shutdown()
            s.server_close()
