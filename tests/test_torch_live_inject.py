"""The port's live fault injector (``sidecar_tpu_torch/chaos/live_inject.py``)
against the JAX package's, and the reference's cross-validation on port
nodes.

* One plan, one virtual clock (each module's ``time`` replaced) and one
  seeded stream of records through a port ``LiveInjector`` and a JAX
  one: the same records released by ``on_recv`` and ``due_records``,
  the same ``filter_send``, ``accept_push_pull``, ``check_fault`` and
  ``skew_ns`` answers, the same ``chaos.live.*`` counters.
* ``AdversaryInjector``: the same forged packets for every attack kind,
  and the same catalog and ``defense.*`` counters after ``push_into``
  on a gated state.  ``LiveChaosController.tick``: the same drop masks
  handed to the same engines at the same rounds.
* The cross-validation plan of ``tests/test_chaos.py``: on three live
  port nodes the split holds, the heal gives [ALIVE, DRAINING, ALIVE]
  and the injector counters move; the port's ``ChaosExactSim`` on the
  CPU under the same plan, fed the reference's draws, equals the
  reference's round by round and ends at the same truth.
"""

import dataclasses
import importlib
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from sidecar_tpu.chaos import plan as jplan
from sidecar_tpu.chaos.sim_inject import ChaosExactSim as JChaosExactSim
from sidecar_tpu.models import exact as jexact
from sidecar_tpu.models.timecfg import TimeConfig as JTimeConfig
from sidecar_tpu.ops import topology as jtopo
from sidecar_tpu.ops.status import pack as jpack
from sidecar_tpu_torch import convert
from sidecar_tpu_torch import service as S
from sidecar_tpu_torch.catalog import ServicesState
from sidecar_tpu_torch.chaos import (
    ChaosExactSim,
    FaultPlan,
    LiveChaosController,
    LiveInjector,
)
from sidecar_tpu_torch.chaos import plan as tplan
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    DRAINING,
    pack,
    unpack_status,
)
from sidecar_tpu_torch.runtime.looper import FreeLooper, TimedLooper
from sidecar_tpu_torch.transport import GossipTransport
from tests.torch_live import (
    SIDES,
    T0,
    Clock,
    counters,
    make_state,
    reset_live,
)
from tests.torch_parity import (
    assert_chaos_states_equal,
    jax_exact_draw_seq,
    jax_fault_draw_seq,
    port_topology,
)

PACKAGES = {"port": "sidecar_tpu_torch", "jax": "sidecar_tpu"}
LIVE = {k: importlib.import_module(f"{p}.chaos.live_inject")
        for k, p in PACKAGES.items()}
ADV = {k: importlib.import_module(f"{p}.chaos.adversary")
       for k, p in PACKAGES.items()}
PLAN = {"port": tplan, "jax": jplan}
NAMES = [f"n{i}" for i in range(6)]


class VirtualClock:
    def __init__(self) -> None:
        self.t = 500.0

    def monotonic(self) -> float:
        return self.t


def virtual_time(monkeypatch, clock):
    for mod in LIVE.values():
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic))


def injector_plan(mod):
    """Drops, delays and duplicates on several edges, a pause and a
    crash window, a clock fault and a health fault."""
    return mod.FaultPlan(
        seed=31,
        edges=(mod.EdgeFault(src=(1, 2), dst=(0,), drop_prob=0.3),
               mod.EdgeFault(src="all", dst=(0, 3), delay_rounds=2,
                             delay_prob=0.25, start_round=3),
               mod.EdgeFault(src=(4, 5), dst="all", duplicate_prob=0.4,
                             delay_rounds=3, end_round=30)),
        nodes=(mod.NodeFault(nodes=(0,), start_round=12, end_round=16,
                             kind="pause"),
               mod.NodeFault(nodes=(3,), start_round=20, end_round=24,
                             kind="crash")),
        clocks=(mod.ClockFault(nodes=(0, 3), start_round=5, end_round=60,
                               offset_ticks=40, drift_ticks_per_round=1.5),),
        health=(mod.HealthFault(id_pattern="web-*", start_round=8,
                                end_round=14, extra_latency_s=0.5,
                                fail=True),),
    ).with_edges(*mod.FaultPlan.partition((0, 1, 2), (3, 4, 5), 25, 28))


def rec_key(svc):
    return (svc.hostname, svc.id, svc.updated, svc.status)


@pytest.mark.parametrize("me", ["n0", "n3"])
def test_live_injector_equals_reference(monkeypatch, me):
    reset_live(monkeypatch)
    clock = VirtualClock()
    virtual_time(monkeypatch, clock)
    round_s = 0.05
    inj = {k: LIVE[k].LiveInjector(injector_plan(PLAN[k]), NAMES, me,
                                   round_s) for k in PACKAGES}
    rng = np.random.default_rng(5)
    log = {k: [] for k in PACKAGES}
    # Before start() the injector passes everything through.
    for k, i in inj.items():
        log[k].append(("inactive", i.round_now(), i.skew_ns(),
                       i.accept_push_pull(), i.filter_send([b"x"])))
    for i in inj.values():
        i.start(clock.t)
    for step in range(600):
        clock.t += float(rng.uniform(0.0, 0.01))
        host = (NAMES + ["stranger"])[int(rng.integers(0, 7))]
        stamp = T0 + step * 1000
        status = int(rng.integers(0, 5))
        sid = f"{host}-s{int(rng.integers(0, 3))}"
        for k, i in inj.items():
            svc = SIDES[k].service.Service(id=sid, name="web",
                                           hostname=host, updated=stamp,
                                           status=status)
            log[k].append(("step", step, i.round_now(),
                           [rec_key(s) for s in i.on_recv(svc)],
                           [rec_key(s) for s in i.due_records()],
                           len(i.filter_send([b"a", b"b"])),
                           i.accept_push_pull(), i.skew_ns(),
                           i.check_fault("web-1"), i.check_fault("db-1"),
                           i.pending_delayed()))
    assert log["port"] == log["jax"]
    got = counters(SIDES["port"], ("chaos.live.",))
    assert got == counters(SIDES["jax"], ("chaos.live.",))
    # Premise: every kind of injection happened.
    for name in ("droppedRecords", "delayedRecords", "duplicatedRecords"):
        assert got.get(f"chaos.live.{name}", 0) > 0, (me, got)
    if me == "n0":
        assert got.get("chaos.live.droppedBroadcasts", 0) > 0
        assert got.get("chaos.live.droppedStateMerges", 0) > 0


def test_install_clock_equals_reference(monkeypatch):
    clock = VirtualClock()
    virtual_time(monkeypatch, clock)
    stamps = {}
    for k in PACKAGES:
        st = SIDES[k].catalog_state.ServicesState(hostname="n3")
        st.set_clock(lambda: T0)
        i = LIVE[k].LiveInjector(injector_plan(PLAN[k]), NAMES, "n3", 0.05)
        i.install_clock(st)
        seen = [st._now()]
        i.start(clock.t)
        for _ in range(40):
            clock.t += 0.05
            seen.append(st._now())
        stamps[k] = seen
    assert stamps["port"] == stamps["jax"]
    assert len(set(stamps["port"])) > 10


def adversary_plan(mod, kind):
    mag = {"future_flood": 5000, "sybil_flood": 300, "past_flood": 4000,
           "replay": 900}.get(kind, 0)
    return mod.AdversaryPlan(seed=2, attacks=(mod.Attack(
        kind=kind, nodes=(1, 4), victims=(2, 3), start_round=2,
        end_round=12, rate=0.5, magnitude_ticks=mag),))


@pytest.mark.parametrize("kind", ADV["jax"].ATTACK_KINDS)
def test_adversary_injector_equals_reference(monkeypatch, kind):
    assert ADV["port"].ATTACK_KINDS == ADV["jax"].ATTACK_KINDS
    reset_live(monkeypatch)
    clock = Clock()
    out = {}
    for k in PACKAGES:
        adv = LIVE[k].AdversaryInjector(adversary_plan(ADV[k], kind), NAMES,
                                        services_per_node=3, budget=6,
                                        base_ns=T0 - 10 ** 9)
        packets = []
        for r in range(14):
            now_ticks = np.full(len(NAMES), 1000 + 200 * r, np.int64)
            packets.append([(origin, [(s.id, s.name, s.hostname, s.updated,
                                       s.status) for s in recs])
                            for origin, recs in adv.forged_packets(
                                r, now_ticks)])
        st = make_state(SIDES[k], clock, host="n0", listeners=False)
        delivered = [adv.push_into(st, r, np.full(len(NAMES),
                                                  1000 + 200 * r))
                     for r in range(14)]
        with st._lock:
            catalog = sorted((h, s.id, s.status, s.updated,
                              s.gossip_origin)
                             for h, _, s in st.each_service())
        out[k] = (packets, delivered, catalog,
                  counters(SIDES[k], ("defense.", "catalog.")))
    assert out["port"] == out["jax"]
    packets, delivered, _, _ = out["port"]
    assert sum(delivered) > 0 and any(packets)


class RecordingTransport:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def test_drop_types(self, node, mask):
        self.log.append((self.name, node, mask))


def test_controller_tick_equals_reference(monkeypatch):
    reset_live(monkeypatch)
    clock = VirtualClock()
    virtual_time(monkeypatch, clock)
    logs = {}
    for k in PACKAGES:
        log = []
        transports = {n: RecordingTransport(n, log) for n in NAMES}
        ctl = LIVE[k].LiveChaosController(injector_plan(PLAN[k]),
                                          transports, 0.05)
        clock.t = 500.0
        ctl.start(clock.t)
        for step in range(700):
            clock.t = 500.0 + step * 0.0031
            ctl.tick()
            log.append(("round", ctl.round_now()))
        logs[k] = log
    assert logs["port"] == logs["jax"]
    assert any(len(e) == 3 and e[2] for e in logs["port"])
    assert counters(SIDES["port"], ("chaos.live.",)) == \
        counters(SIDES["jax"], ("chaos.live.",))


# -- the cross-validation plan (tests/test_chaos.py) ---------------------------

ROUND_S = 0.05
LIVE_NAMES = ["chaos-a", "chaos-b", "chaos-c"]
SIDE_A, SIDE_B = (0,), (1, 2)
P_START, P_END = 10, 50
CHURN_ROUND = 20


def live_plan(mod=tplan, seed=77):
    """A clean 2-way split over rounds [10, 50), with 20 % loss and a
    20 %/1-round delay on the (b, c) → a direction for the whole run."""
    return mod.FaultPlan(
        seed=seed,
        edges=(mod.EdgeFault(src=SIDE_B, dst=SIDE_A, drop_prob=0.2),
               mod.EdgeFault(src=SIDE_B, dst=SIDE_A, delay_rounds=1,
                             delay_prob=0.2)),
    ).with_edges(*mod.FaultPlan.partition(SIDE_A, SIDE_B, P_START, P_END))


def wait_for(predicate, timeout=15.0, step=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return False


def test_cross_validation_live_path(monkeypatch):
    """Three port nodes on loopback under the plan: the split holds (a
    misses b's drain), the heal converges through push-pull, the lossy
    edge moves the injector counters, and the final statuses are the
    sim path's truth."""
    reset_live(monkeypatch)
    metrics = SIDES["port"].metrics
    plan = live_plan()
    states, transports, injectors, loopers, writers = {}, {}, {}, [], []
    for name in LIVE_NAMES:
        states[name] = ServicesState(hostname=name)
        injectors[name] = LiveInjector(plan, LIVE_NAMES, name, ROUND_S)
        transports[name] = GossipTransport(
            node_name=name, cluster_name="chaos-xv", bind_ip="127.0.0.1",
            bind_port=0, advertise_ip="127.0.0.1", gossip_interval=ROUND_S,
            push_pull_interval=1.0, probe_interval=5.0,
            suspect_timeout=60.0, fault_injector=injectors[name])
    controller = LiveChaosController(plan, transports, ROUND_S)
    sids = {"chaos-a": "svc-a", "chaos-b": "svc-b", "chaos-c": "svc-c"}

    def add_local(st, sid):
        svc = S.Service(id=sid, name="web", image="i:1",
                        hostname=st.hostname, updated=S.now_ns(),
                        status=S.ALIVE,
                        ports=[S.Port("tcp", 1000, 80, "127.0.0.1")])
        st.add_service_entry(svc.copy())
        return svc

    def status_of(st, owner, sid):
        server = st.servers.get(owner)
        svc = server.services.get(sid) if server else None
        return None if svc is None else svc.status

    ctl_thread = None
    try:
        for name in LIVE_NAMES:
            looper = TimedLooper(0.0)
            t = threading.Thread(target=states[name].process_service_msgs,
                                 args=(looper,), daemon=True)
            t.start()
            loopers.append(looper)
            writers.append(t)
        svcs = {}
        port_a = transports["chaos-a"].start(states["chaos-a"])
        for name in LIVE_NAMES:
            if name != "chaos-a":
                transports[name].start(states[name])
                transports[name].join("127.0.0.1", port_a)
            svcs[name] = add_local(states[name], sids[name])
            states[name].send_services([svcs[name]], FreeLooper(3))
        assert wait_for(lambda: all(
            status_of(states[n], o, sids[o]) == S.ALIVE
            for n in LIVE_NAMES for o in LIVE_NAMES), 20.0), \
            "pre-chaos convergence failed"

        t0 = time.monotonic()
        for inj in injectors.values():
            inj.start(t0)
        controller.start(t0)
        ctl_thread = controller.run(poll_s=ROUND_S / 2)
        anchor = injectors["chaos-a"]

        assert wait_for(lambda: anchor.round_now() >= CHURN_ROUND, 5.0,
                        step=0.01)
        drained = svcs["chaos-b"].copy()
        drained.status = S.DRAINING
        drained.updated = S.now_ns()
        states["chaos-b"].add_service_entry(drained.copy())
        states["chaos-b"].send_services([drained], FreeLooper(3))
        reminted = svcs["chaos-c"].copy()
        reminted.updated = S.now_ns()
        states["chaos-c"].add_service_entry(reminted.copy())
        states["chaos-c"].send_services([reminted], FreeLooper(3))

        assert wait_for(lambda: status_of(
            states["chaos-c"], "chaos-b", "svc-b") == S.DRAINING, 5.0)
        assert wait_for(lambda: anchor.round_now() >= P_END - 5, 5.0,
                        step=0.01)
        if anchor.round_now() < P_END:   # still split: the cut must hold
            assert status_of(states["chaos-a"], "chaos-b",
                             "svc-b") == S.ALIVE, \
                "partition leaked the drain to the far side"

        expected = {"chaos-a": S.ALIVE, "chaos-b": S.DRAINING,
                    "chaos-c": S.ALIVE}
        assert wait_for(lambda: all(
            status_of(states[n], o, sids[o]) == expected[o]
            for n in LIVE_NAMES for o in LIVE_NAMES), 20.0), \
            "post-heal convergence failed"

        base_drop = metrics.counter("chaos.live.droppedRecords")
        base_delay = metrics.counter("chaos.live.delayedRecords")

        def provoke_and_check():
            fresh = svcs["chaos-c"].copy()
            fresh.updated = S.now_ns()
            states["chaos-c"].add_service_entry(fresh.copy())
            states["chaos-c"].send_services([fresh], FreeLooper(2))
            return metrics.counter("chaos.live.droppedRecords") > base_drop \
                and metrics.counter("chaos.live.delayedRecords") > base_delay

        assert wait_for(provoke_and_check, 15.0, step=0.3), \
            "no injected drops or delays on the lossy edge"
        assert metrics.counter("chaos.live.partitionEdgesCut") > 0
        truth = [ALIVE, DRAINING, ALIVE]       # the sim path's
        for i, owner in enumerate(LIVE_NAMES):
            for n in LIVE_NAMES:
                assert status_of(states[n], owner, sids[owner]) == truth[i]
    finally:
        controller.stop()
        if ctl_thread is not None:
            ctl_thread.join(timeout=5.0)
        for tr in transports.values():
            tr.stop()
        for st in states.values():
            st.stop_processing()
        for looper in loopers:
            looper.quit()
        for t in writers:
            t.join(timeout=5.0)
            assert not t.is_alive()


SIM_ROUNDS = 100
SIM_KEY = 1


def test_cross_validation_sim_path():
    """The reference's sim path on the port (n = 3, complete graph):
    equal to the reference round by round from its draws; a's view of
    b stays stale through the split; the heal ends at [ALIVE, DRAINING,
    ALIVE] everywhere."""
    jt = JTimeConfig(refresh_interval_s=10_000.0, push_pull_interval_s=2.0)
    jp = jexact.SimParams(n=3, services_per_node=1, fanout=2, budget=3)
    topo = jtopo.complete(3)
    jsim = JChaosExactSim(jp, topo, jt, plan=live_plan(jplan))
    tsim = ChaosExactSim(
        convert.exact_params_from_jax_fields(dataclasses.asdict(jp)),
        port_topology(topo),
        convert.timecfg_from_fields(dataclasses.asdict(jt)),
        FaultPlan.loads(live_plan(jplan).dumps()), device="cpu")
    key = jax.random.PRNGKey(SIM_KEY)
    draws = jax_exact_draw_seq(jsim, key, 0, SIM_ROUNDS)
    fdraws = jax_fault_draw_seq(jsim, 0, SIM_ROUNDS)
    js, ts = jsim.init_state(), tsim.init_state()
    mid = None
    for r in range(SIM_ROUNDS):
        if r + 1 == CHURN_ROUND:
            tick = (r + 1) * jt.round_ticks
            for slot, status in ((1, DRAINING), (2, ALIVE)):
                known = js.sim.known.at[slot, slot].set(
                    int(jpack(tick, status)))
                sent = js.sim.sent.at[slot, slot].set(0)
                js = dataclasses.replace(js, sim=dataclasses.replace(
                    js.sim, known=known, sent=sent))
                ts.sim.known[slot, slot] = int(pack(tick, status))
                ts.sim.sent[slot, slot] = 0
        js = jsim.step(js, jax.random.fold_in(key, r))
        ts = tsim.step(ts, draws=draws[r], fault_draws=fdraws[r])
        assert_chaos_states_equal(js, ts, f"round {r + 1}")
        assert float(tsim.convergence(ts)) == float(jsim.convergence(js))
        if r + 1 == P_END - 5:
            mid = int(ts.sim.known[0, 1])
    assert int(unpack_status(torch.tensor(mid))) != DRAINING
    assert float(tsim.convergence(ts)) == 1.0
    known = ts.sim.known.numpy()
    truth = known.max(axis=0)
    assert (known == truth[None, :]).all()
    assert [int(s) for s in unpack_status(torch.tensor(truth))] == \
        [ALIVE, DRAINING, ALIVE]
    assert tsim.injection_counts(ts) == jsim.injection_counts(js)
