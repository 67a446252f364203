"""The port's gossip transport (``sidecar_tpu_torch/transport/gossip.py``)
against the JAX package's, over real sockets on loopback.

* A port node and a JAX node in one cluster converge on one catalog set,
  both ways, through the join's push-pull, UDP gossip and the periodic
  push-pull; when either node dies, SWIM's ``leave`` expires its
  services on the survivor.  Two port nodes converge on their own, and
  the bridge publishes the ``engine.*`` gauges.
* Each process loads each engine once: the port's library (built from
  ``native/transport.cc`` into the port's own ``_build/``) and the JAX
  package's (``native/build/``) are two copies whose symbols stay apart.
* The ``DROP_*`` bits, the argument checks, ``join_with_retry``'s
  backoff histogram and counters under a seeded ``_retry_rng``, and the
  shed accounting of ``_shed_broadcast_backlog`` and
  ``_deliver_inbound`` equal the reference's.
* A failed build raises with the compiler's output.
"""

import ctypes
import importlib
import json
import queue
import random
import threading
import time

import pytest

from sidecar_tpu_torch.transport import gossip as tgossip
from tests.torch_live import SIDES, counters, reset_live

PACKAGES = {"port": "sidecar_tpu_torch", "jax": "sidecar_tpu"}
GOSSIP = {k: importlib.import_module(f"{p}.transport.gossip")
          for k, p in PACKAGES.items()}
SWIM = dict(probe_interval=0.1, probe_timeout=0.15, suspect_timeout=0.6,
            indirect_probes=3)


def wait_for(predicate, timeout=10.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return False


class Node:
    """A state of ``side``'s package, its writer thread and its
    transport (not started)."""

    def __init__(self, side, name, **kw):
        self.side = SIDES[side]
        self.state = self.side.catalog_state.ServicesState(hostname=name)
        self.transport = GOSSIP[side].GossipTransport(
            node_name=name, cluster_name="mixed", bind_ip="127.0.0.1",
            bind_port=0, advertise_ip="127.0.0.1", gossip_interval=0.05,
            push_pull_interval=1.0, **kw)
        self.looper = self.side.runtime_looper.TimedLooper(0.0)
        self.writer = threading.Thread(
            target=self.state.process_service_msgs, args=(self.looper,),
            daemon=True)
        self.writer.start()

    def add(self, sid, name, gossip=True):
        svc = self.side.service
        rec = svc.Service(id=sid, name=name, image="i:1",
                          hostname=self.state.hostname,
                          updated=svc.now_ns(), status=svc.ALIVE,
                          ports=[svc.Port("tcp", 1000, 80, "127.0.0.1")])
        self.state.add_service_entry(rec.copy())
        if gossip:
            self.state.send_services(
                [rec], self.side.runtime_looper.FreeLooper(3))

    def records(self):
        with self.state._lock:
            return {(h, s.id, s.status, s.updated)
                    for h, _, s in self.state.each_service()}

    def holds(self, host, sid):
        server = self.state.servers.get(host)
        return server is not None and sid in server.services

    def stop(self):
        self.transport.stop()
        self.state.stop_processing()
        self.looper.quit()
        self.writer.join(timeout=5.0)
        assert not self.writer.is_alive()


@pytest.fixture
def nodes():
    made = []

    def make(side, name, **kw):
        made.append(Node(side, name, **kw))
        return made[-1]

    yield make
    for node in made:
        node.stop()


def test_mixed_cluster_converges_both_ways(nodes):
    a, b = nodes("jax", "mix-jax"), nodes("port", "mix-port")
    # Before the join: each side's record crosses in the join's
    # push-pull.
    a.add("a-join", "web", gossip=False)
    b.add("b-join", "db", gossip=False)
    port_a = a.transport.start(a.state)
    b.transport.start(b.state)
    b.transport.join("127.0.0.1", port_a)
    assert wait_for(lambda: b.holds("mix-jax", "a-join")
                    and a.holds("mix-port", "b-join"))
    assert wait_for(lambda: set(a.transport.members())
                    == set(b.transport.members())
                    == {"mix-jax", "mix-port"})
    # UDP gossip, both ways.
    a.add("a-gossip", "web")
    b.add("b-gossip", "db")
    assert wait_for(lambda: b.holds("mix-jax", "a-gossip")
                    and a.holds("mix-port", "b-gossip"))
    # The periodic push-pull alone (no broadcast), both ways.
    a.add("a-pushpull", "web", gossip=False)
    b.add("b-pushpull", "db", gossip=False)
    assert wait_for(lambda: b.holds("mix-jax", "a-pushpull")
                    and a.holds("mix-port", "b-pushpull"))
    assert wait_for(lambda: a.records() == b.records())
    assert len(a.records()) == 6


@pytest.mark.parametrize("survivor", ["port", "jax"])
def test_leave_expires_departed_services(nodes, survivor):
    victim_side = "jax" if survivor == "port" else "port"
    s = nodes(survivor, f"leave-{survivor}", **SWIM)
    v = nodes(victim_side, f"leave-{victim_side}", **SWIM)
    v.add("v1", "web", gossip=False)
    v.add("v2", "db", gossip=False)
    port_s = s.transport.start(s.state)
    v.transport.start(v.state)
    v.transport.join("127.0.0.1", port_s)
    assert wait_for(lambda: s.holds(v.state.hostname, "v1")
                    and s.holds(v.state.hostname, "v2"))
    v.transport.stop()          # no goodbye: SWIM must find the death
    tomb = s.side.service.TOMBSTONE

    def expired():
        server = s.state.servers.get(v.state.hostname)
        return all(x.status == tomb for x in server.services.values())

    assert wait_for(expired, timeout=20.0)
    assert v.state.hostname not in s.transport.members()


def test_two_port_nodes_converge_and_publish_engine_stats(nodes,
                                                          monkeypatch):
    reset_live(monkeypatch)
    a, b = nodes("port", "pp-a"), nodes("port", "pp-b")
    a.add("a1", "web", gossip=False)
    port_a = a.transport.start(a.state)
    b.transport.start(b.state, seeds=[f"127.0.0.1:{port_a}"])
    b.add("b1", "db")
    assert wait_for(lambda: a.holds("pp-b", "b1") and b.holds("pp-a", "a1"))
    assert wait_for(lambda: a.records() == b.records())
    assert wait_for(lambda: SIDES["port"].metrics.snapshot()["gauges"].get(
        "engine.udpOut", 0) > 0, timeout=5.0)
    snap = SIDES["port"].metrics.snapshot()
    assert set(tgossip.GossipTransport._STAT_NAMES) <= set(snap["gauges"])
    stats = a.transport.engine_stats()
    assert tuple(stats) == tgossip.GossipTransport._STAT_NAMES
    assert stats["engine.udpOut"] > 0
    assert "pendingBroadcasts" in snap["gauges"]
    assert "getBroadcasts" in snap["timers"]
    assert "notifyMsg" in snap["timers"]
    assert "mergeRemoteState" in snap["timers"]
    names = {s["name"] for s in importlib.import_module(
        "sidecar_tpu_torch.telemetry.span").spans()}
    assert "gossip.receive" in names


# -- one engine copy a package -----------------------------------------------

def test_each_engine_is_its_own_copy():
    port_lib, jax_lib = (GOSSIP[k].load_native() for k in ("port", "jax"))
    assert port_lib is GOSSIP["port"].load_native()     # once a process
    assert tgossip.BUILD_DIR in tgossip.library_path().parents
    assert port_lib._name == str(tgossip.library_path())
    assert "native/build" not in port_lib._name
    assert port_lib._name != jax_lib._name

    def addr(lib, name):
        return ctypes.cast(getattr(lib, name), ctypes.c_void_p).value

    # RTLD_LOCAL: every entry point resolves into its own copy.
    for name in ("st_create", "st_poll_msg", "st_stats", "st_destroy"):
        assert addr(port_lib, name) != addr(jax_lib, name), name
    maps = open("/proc/self/maps").read()
    assert tgossip.library_path().name in maps
    assert "libsidecar_transport.so" in maps


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "transport.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(tgossip, "SOURCE", bad)
    monkeypatch.setattr(tgossip, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native transport build failed"
                       ) as err:
        tgossip.build_native()
    assert "error" in str(err.value)
    assert str(bad) in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))


# -- exact equalities ----------------------------------------------------------

def test_drop_bits_equal_reference():
    names = [n for n in dir(GOSSIP["jax"]) if n.startswith("DROP_")]
    assert len(names) == 8
    for name in names:
        assert getattr(tgossip, name) == getattr(GOSSIP["jax"], name), name
    assert tgossip.GossipTransport._STAT_NAMES == \
        GOSSIP["jax"].GossipTransport._STAT_NAMES


@pytest.mark.parametrize("kw", [
    dict(handoff_queue_depth=0), dict(handoff_queue_depth=-3),
    dict(max_pending_broadcasts=0), dict(max_pending_broadcasts=-1),
    dict(push_pull_retries=-1)])
def test_bad_arguments_raise_the_reference_errors(kw):
    errors = []
    for side in ("port", "jax"):
        with pytest.raises(ValueError) as err:
            GOSSIP[side].GossipTransport(node_name="bad", bind_port=0, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def transport(side, **kw):
    """A transport of ``side``'s package on a state, never started."""
    t = GOSSIP[side].GossipTransport(node_name="acct", bind_port=0, **kw)
    t.state = SIDES[side].catalog_state.ServicesState(hostname="acct")
    return t


def test_join_with_retry_equals_reference(monkeypatch):
    reset_live(monkeypatch)
    results = {}
    for side in ("port", "jax"):
        t = transport(side, push_pull_retries=4, push_pull_backoff_ms=1.0,
                      push_pull_jitter=0.5, push_pull_attempt_timeout=1.0)
        t._retry_rng = random.Random(7)
        calls = []

        def refuse(host, port=7946, calls=calls):
            calls.append((host, port))
            raise OSError("dial refused")

        t.join = refuse
        ok = t.join_with_retry("seed", 7946)
        snap = SIDES[side].metrics.snapshot()
        results[side] = (ok, calls, counters(SIDES[side], ("transport.",)),
                         snap["histograms"]["transport.pushpull.backoff_ms"],
                         SIDES[side].metrics.registry._hists[
                             "transport.pushpull.backoff_ms"])
    assert results["port"][:4] == results["jax"][:4]
    ok, calls, cnt, _, _ = results["port"]
    assert not ok and len(calls) == 5
    assert cnt == {"transport.pushpull.retries": 4,
                   "transport.pushpull.failures": 1}
    # The samples themselves, not only their summary.
    assert list(results["port"][4]) == list(results["jax"][4])


def test_shed_and_backlog_accounting_equal_reference(monkeypatch):
    reset_live(monkeypatch)
    out = {}
    for side in ("port", "jax"):
        t = transport(side, max_pending_broadcasts=8)
        for i in range(20):
            t.state.broadcasts.put([b"payload-%d" % i])
        t._shed_broadcast_backlog()
        head = t.state.broadcasts.get_nowait()
        svc = SIDES[side].service
        rec = svc.Service(id="x", name="web", image="i", hostname="other",
                          updated=svc.now_ns(), status=svc.ALIVE, ports=[])
        while True:
            try:
                t.state.service_msgs.put_nowait(rec)
            except queue.Full:
                break
        t0 = time.monotonic()
        t._deliver_inbound(rec)
        t._deliver_inbound(rec)
        elapsed = time.monotonic() - t0
        out[side] = (head, t.state.broadcasts.qsize(),
                     counters(SIDES[side], ("transport.",)))
        assert elapsed < 0.5
    assert out["port"] == out["jax"]
    assert out["port"] == ([b"payload-12"], 7,
                           {"transport.shedBroadcasts": 12,
                            "transport.shedInbound": 2})


def test_push_local_state_is_the_annotated_body(monkeypatch):
    """The engine's push-pull reply is ``encode_annotated``: what the
    bridge hands ``st_set_local_state`` decodes to the same document in
    both packages."""
    reset_live(monkeypatch)
    bodies = {}
    for side in ("port", "jax"):
        t = transport(side)
        t._handle = 1
        sent = []
        t._lib = type("Lib", (), {"st_set_local_state":
                                  staticmethod(lambda h, d, n:
                                               sent.append(bytes(d)))})()
        t.state.set_clock(lambda: 1_700_000_000_000_000_000)
        t._push_local_state()
        t._handle = None
        bodies[side] = json.loads(sent[0])
    assert bodies["port"] == bodies["jax"]
    assert "Digest" in bodies["port"]
