"""Shared pieces of the live-catalog tests: the two packages side by side
(``SIDES``), the resets of their module-level registries, a clock both
states read, the seeded operation script and the function that
applies it.

A script is a list of plain tuples made with numpy from a seed; the
function ``apply`` runs each on a state of either package, so the port's
``ServicesState`` and the JAX package's see the same operations in the
same order at the same clock."""

import importlib
import json
import random
import threading
import types

import numpy as np

# The reference's environment variables of these modules: unset on the
# JAX side, so that both packages run at the same defaults.
LIVE_ENV = ("SIDECAR_TPU_DIGEST_BUCKETS", "SIDECAR_TPU_ANTIENTROPY_DEPTH",
            "SIDECAR_TPU_COHERENCE", "SIDECAR_TPU_COHERENCE_PEERS",
            "SIDECAR_TPU_PROVENANCE", "SIDECAR_TPU_PROVENANCE_ORIGINS",
            "SIDECAR_TPU_ANTIENTROPY", "SIDECAR_TPU_ANTIENTROPY_RETRIES",
            "SIDECAR_TPU_ANTIENTROPY_TIMEOUT_S",
            "SIDECAR_TPU_ANTIENTROPY_BACKOFF_MS")

MODULES = ("service", "metrics", "catalog.state", "catalog.damping",
           "catalog.url_listener", "ops.digest", "ops.suspicion",
           "runtime.looper", "telemetry.coherence", "telemetry.propagation",
           "query", "query.hub", "transport.antientropy")


def _side(package):
    mods = {name.replace(".", "_"): importlib.import_module(
        f"{package}.{name}") for name in MODULES}
    return types.SimpleNamespace(name=package, **mods)


SIDES = {"port": _side("sidecar_tpu_torch"), "jax": _side("sidecar_tpu")}

NS = 1_000_000_000
T0 = 1_700_000_000 * NS
HOSTS = tuple(f"h{i}" for i in range(8))
SPN = 4
LOCAL = "h0"


def reset_live(monkeypatch):
    """Unset the reference's variables, then clear and re-seed the
    coherence monitor, the propagation meter and the metrics registry
    of both packages."""
    for var in LIVE_ENV:
        monkeypatch.delenv(var, raising=False)
    for side in SIDES.values():
        side.telemetry_coherence.configure()
        side.telemetry_coherence.monitor.reset()
        meter = side.telemetry_propagation.meter
        side.telemetry_propagation.configure()
        meter.max_origins = side.telemetry_propagation.DEFAULT_MAX_ORIGINS
        meter.reset()
        meter._rand = random.Random(0x51DECA)
        reg = side.metrics.registry
        for table in (reg._counters, reg._gauges, reg._timers, reg._hists):
            table.clear()
        reg._rand = random.Random(0xC0FFEE)


class Clock:
    """A settable nanosecond clock."""

    def __init__(self, now: int = T0) -> None:
        self.now = now

    def __call__(self) -> int:
        return self.now


def counters(side, prefixes) -> dict:
    snap = side.metrics.snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


def join_senders():
    """Wait for every ``send_services`` thread: the broadcasts of one
    operation are then all queued, in their one order."""
    for t in threading.enumerate():
        if t.name == "send-services":
            t.join()


def make_state(side, clock, host=LOCAL, *, gate=True, damper=True,
               listeners=True, **kw):
    """A state of ``side``'s package on ``clock``, as the writer tests
    run it: no retransmit sleep, the future bound at 0.5 s, a flap
    damper, an origin gate (budget 1, quarantine at 3 violations) and
    two queue listeners, one large and one of the default 20."""
    st = side.catalog_state.ServicesState(hostname=host,
                                          cluster_name="test", **kw)
    st.set_clock(clock)
    st.tombstone_retransmit = 0.0
    st.future_fudge_s = 0.5
    if damper:
        st.attach_damper(side.catalog_damping.FlapDamper(
            half_life_s=60.0, threshold=2.0, now_fn=clock))
    if gate:
        st.attach_origin_gate(side.ops_suspicion.QuarantineScorer(
            side.ops_suspicion.ProtocolParams(origin_budget=1,
                                              origin_quarantine=3)))
    if listeners:
        st.add_listener(side.catalog_state.QueueListener("big",
                                                          buffer=100_000))
        st.add_listener(side.catalog_state.QueueListener("small"))
    return st


def service(side, host, sid, stamp, status, name=None):
    svc = side.service
    return svc.Service(id=sid, name=name or f"app{sid[-1]}",
                       image=f"img:{int(stamp) % 3}", hostname=host,
                       created=T0, updated=int(stamp), status=int(status),
                       ports=[svc.Port(port=10_000 + int(sid[-1]),
                                       service_port=80, ip="10.0.0.1")])


# -- the script -----------------------------------------------------------------

def make_script(seed: int, n_ops: int = 300) -> list:
    """``n_ops`` operations over 8 hosts × 4 services from
    ``default_rng(seed)``: adds with newer, equal and older stamps, stale
    and future stamps, Draining and back, merges from an honest and a
    flooding peer, expiries, the tombstone, broadcast and tracking loops,
    and clock steps (one of them past the tombstone lifespan)."""
    rng = np.random.default_rng(seed)
    now = T0
    last = {}
    statuses = (0, 0, 0, 2, 4, 1)   # Alive ×3, Unhealthy, Draining, Tombstone
    kinds = ("add", "add", "add", "add", "stale", "future", "drain",
             "merge", "expire", "tomb_local", "tomb_others", "bcast",
             "track", "tick", "tick")
    ops = []

    def rec():
        h = HOSTS[int(rng.integers(0, len(HOSTS)))]
        s = f"{h}-s{int(rng.integers(0, SPN))}"
        return h, s

    def stamp(key, how):
        base = last.get(key, now - 60 * NS)
        if how == "newer":
            t = base + int(rng.integers(1, 3 * NS))
        elif how == "equal":
            t = base
        else:
            t = base - int(rng.integers(1, 3 * NS))
        last[key] = max(base, t)
        return t

    def local_list():
        ids = sorted({f"{LOCAL}-s{int(i)}"
                      for i in rng.integers(0, SPN, 3)})
        return [(LOCAL, sid, now - int(rng.integers(0, 5 * NS)), 0)
                for sid in ids]

    for i in range(n_ops):
        if i == n_ops * 5 // 6:
            # Past the tombstone lifespan: the sweep collects tombstones.
            now += 3 * 3600 * NS + 120 * NS
            ops.append(("tick", now))
            ops.append(("tomb_others",))
            continue
        kind = kinds[int(rng.integers(0, len(kinds)))]
        if kind == "add":
            h, s = rec()
            how = ("newer", "newer", "equal", "older")[
                int(rng.integers(0, 4))]
            ops.append(("add", h, s, stamp((h, s), how),
                        statuses[int(rng.integers(0, len(statuses)))]))
        elif kind == "stale":
            h, s = rec()
            ops.append(("add", h, s, now - 4 * 3600 * NS, 0))
        elif kind == "future":
            h, s = rec()
            ahead = (NS // 5, 2 * NS)[int(rng.integers(0, 2))]
            ops.append(("add", h, s, now + ahead, 0))
        elif kind == "drain":
            h, s = rec()
            ops.append(("add", h, s, stamp((h, s), "newer"), 4))
            ops.append(("add", h, s, stamp((h, s), "newer"), 0))
        elif kind == "merge":
            peer = ("h5", "h6")[int(rng.integers(0, 2))]
            records = []
            for _ in range(int(rng.integers(2, 9))):
                h, s = rec()
                fresh = peer == "h5" and h != peer
                t = now + int(rng.integers(0, NS // 10)) if fresh \
                    else now - int(rng.integers(1, 20 * NS))
                records.append((h, s, t, statuses[
                    int(rng.integers(0, len(statuses)))]))
            ops.append(("merge", peer, tuple(records),
                        bool(rng.integers(0, 2))))
        elif kind == "expire":
            ops.append(("expire", HOSTS[int(rng.integers(0, len(HOSTS)))]))
        elif kind == "tomb_local":
            ops.append(("tomb_local", tuple(local_list())))
        elif kind == "tomb_others":
            ops.append(("tomb_others",))
        elif kind == "bcast":
            ops.append(("bcast", tuple(local_list()),
                        bool(rng.integers(0, 2))))
        elif kind == "track":
            ops.append(("track", tuple(local_list())))
        else:
            now += int(rng.integers(0, 30 * NS)) if rng.random() < 0.8 \
                else 100 * NS
            ops.append(("tick", now))
    return ops


def _peer_body(side, peer, records, annotated):
    """The peer's push-pull body, decoded as the transport would: its
    wire document, with the digest annotation when ``annotated``."""
    st = side.catalog_state
    body = st.ServicesState(hostname=peer, cluster_name="test")
    ladder = side.ops_digest.LadderDigest()
    for h, s, t, status in records:
        server = body.servers.setdefault(h, st.Server(h))
        server.services[s] = service(side, h, s, t, status)
        ladder.add(side.ops_digest.ident_of(h, s),
                   side.ops_digest.live_key(t, status))
    doc = body.to_json()
    if annotated:
        doc["Digest"] = {"Buckets": ladder.buckets, "Records": ladder.count,
                         "Hex": ladder.hex(),
                         "Ladder": {"Depth": ladder.depth,
                                    "Leaf": ladder.leaf_buckets}}
    return st.decode(json.dumps(doc))


def drain_writer(side, st):
    st.process_service_msgs(side.runtime_looper.FreeLooper(
        st.service_msgs.qsize()))


def apply(side, st, clock, op, steps):
    """Apply one operation to ``st``; ``steps`` keeps the state's
    persistent broadcast step (its last-send time)."""
    kind = op[0]
    free = side.runtime_looper.FreeLooper

    def listed(items):
        return lambda: [service(side, *it) for it in items]

    if kind == "add":
        _, h, s, t, status = op
        st.add_service_entry(service(side, h, s, t, status))
    elif kind == "merge":
        _, peer, records, annotated = op
        st.merge(_peer_body(side, peer, records, annotated))
        drain_writer(side, st)
    elif kind == "expire":
        st.expire_server(op[1])
    elif kind == "tomb_local":
        st.broadcast_tombstones(listed(op[1]), free(1))
    elif kind == "tomb_others":
        st.tombstone_others_services()
    elif kind == "bcast":
        if op[2]:
            st.broadcast_services(listed(op[1]), free(1))
        else:
            if "bcast" not in steps:
                steps["bcast"] = st.broadcast_services_step(
                    lambda: [service(side, *it)
                             for it in steps["bcast_items"]])
            steps["bcast_items"] = op[1]
            steps["bcast"]()
    elif kind == "track":
        st.track_new_services(listed(op[1]), free(1))
        drain_writer(side, st)
    elif kind == "tick":
        clock.now = op[1]
    else:
        raise ValueError(op)
    join_senders()


def ladder(st) -> list:
    _, depth = st.ladder_geometry()
    return [st.digest_level(k) for k in range(depth)]


def drain_queue(q) -> list:
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


def events_json(listener) -> list:
    return [e.to_json() for e in drain_queue(listener.chan())]
