"""A ``FaultPlan`` on the live cluster — the port of
``sidecar_tpu/chaos/live_inject.py``.

The shim sits at the live node's host boundaries:

* ``transport/gossip.py`` — a ``GossipTransport`` takes a
  ``fault_injector``; its bridge loop consults it on every decoded
  inbound record (drop, delay, duplicate, per plan edge) and on every
  outbound batch (a pause or crash window silences the node).  Inbound
  edges are named by the record's origin (``svc.hostname``): the wire
  does not show the relaying hop, and who cannot hear about whom is
  what decides the catalog's convergence;
* full partitions also use the engine's receive-drop hook
  (``st_test_drop_types``) through :meth:`LiveChaosController.tick`, so
  SWIM probes and TCP push-pull are cut as user gossip is;
* the health checker (``check_fault``) reads the plan's slow or failing
  check windows;
* ``catalog/state.py`` — :meth:`LiveInjector.install_clock` shims the
  catalog's clock (``ServicesState.set_clock``) with the plan's
  ClockFault skew, the live twin of the sim's per-node ``now``.

Every random decision is :func:`~sidecar_tpu_torch.chaos.plan.coin` — a
blake2b hash of (seed, src, dst, per-edge counter) — so the sequence of
decisions on an edge is a function of the plan seed alone; the wall
clock still decides when packets exist.

Every injection is counted in the metrics registry (``chaos.live.*``).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.chaos.plan import FaultPlan, coin
from sidecar_tpu_torch.transport.gossip import DROP_ALL_UDP, DROP_PUSH_PULL


class LiveInjector:
    """One node's view of the plan: the fate of its inbound records and
    outbound broadcasts.

    ``node_names`` maps the cluster's node names to plan indices (those
    a ``ChaosExactSim`` of the cluster would use); ``node`` is this
    node's name.  ``round_s`` maps the wall clock onto plan rounds — the
    cluster's gossip interval, so a window means the same on both
    paths.
    """

    def __init__(self, plan: FaultPlan, node_names: list[str], node: str,
                 round_s: float, tick_s: float = 0.001) -> None:
        if round_s <= 0:
            raise ValueError("round_s must be positive")
        if tick_s <= 0:
            raise ValueError("tick_s must be positive")
        self.plan = plan
        self.tick_s = tick_s
        self.index = {name: i for i, name in enumerate(node_names)}
        if node not in self.index:
            raise ValueError(f"node {node!r} not in {node_names}")
        self.node = node
        self.me = self.index[node]
        self.round_s = round_s
        # Inert until start(): a scenario converges its cluster first,
        # then anchors every injector (and the controller) at one t0.
        self._t0: Optional[float] = None
        self._lock = threading.Lock()
        self._counters: dict[int, int] = {}     # src index → decision seq
        self._delayed: list = []                # (release, seq, svc)
        self._seq = itertools.count()

    # -- clock -------------------------------------------------------------

    def start(self, t0: Optional[float] = None) -> None:
        """Anchor round 1 at ``t0`` (default: now); give every node's
        injector one shared stamp."""
        self._t0 = time.monotonic() if t0 is None else t0

    @property
    def active(self) -> bool:
        return self._t0 is not None

    def round_now(self) -> int:
        """The plan round of the wall clock (1-based, as the simulator
        counts); 0 before :meth:`start`."""
        if self._t0 is None:
            return 0
        return int((time.monotonic() - self._t0) / self.round_s) + 1

    # -- clock shim --------------------------------------------------------

    def skew_ns(self) -> int:
        """This node's ClockFault offset now, in nanoseconds (a plan
        offset is in ticks of ``tick_s`` seconds); 0 before
        :meth:`start` or without clock entries."""
        if not self.active or not self.plan.clocks:
            return 0
        off = self.plan.clock_offset(self.me, self.round_now())
        return int(off * self.tick_s * 1e9)

    def install_clock(self, state) -> None:
        """Shim the catalog's clock (:meth:`ServicesState.set_clock`) so
        this node stamps, admits and expires by its skewed plan clock;
        its peers keep their own clocks."""
        base = state._now

        def skewed() -> int:
            return int(base()) + self.skew_ns()

        state.set_clock(skewed)

    # -- transport shim: inbound -------------------------------------------

    def _edge_decision(self, src: int, round_idx: int):
        """(drop, delay_rounds, dup_delay_rounds) of the next record on
        the edge src → me (a dup delay of 0: no duplicate).  One counter
        step a record; each active plan entry draws its own coin."""
        with self._lock:
            seq = self._counters.get(src, 0)
            self._counters[src] = seq + 1
        drop = False
        delay = 0
        dup_delay = 0
        for i, e in enumerate(self.plan.edges):
            if not (e.start_round <= round_idx < e.end_round):
                continue
            src_set = e.src == "all" or src in e.src
            dst_set = e.dst == "all" or self.me in e.dst
            if not (src_set and dst_set):
                continue
            if e.drop_prob > 0.0 and \
                    coin(self.plan.seed, "drop", i, src, self.me,
                         seq) < e.drop_prob:
                drop = True
            if e.delay_prob > 0.0 and \
                    coin(self.plan.seed, "delay", i, src, self.me,
                         seq) < e.delay_prob:
                delay = max(delay, e.delay_rounds)
            if e.duplicate_prob > 0.0 and \
                    coin(self.plan.seed, "dup", i, src, self.me,
                         seq) < e.duplicate_prob:
                dup_delay = max(dup_delay, e.ring_rounds)
        return drop, delay, dup_delay

    def on_recv(self, svc) -> list:
        """The inbound boundary: the records to merge now (none, one, or
        one with a later duplicate).  Delayed records come out of
        :meth:`due_records`."""
        if not self.active:
            return [svc]
        r = self.round_now()
        # A paused or crashed node accepts nothing.
        if self.plan.node_down(self.me, r):
            metrics.incr("chaos.live.droppedRecords")
            return []
        src = self.index.get(svc.hostname)
        if src is None or src == self.me:
            return [svc]
        drop, delay, dup_delay = self._edge_decision(src, r)
        if drop:
            metrics.incr("chaos.live.droppedRecords")
            return []
        out = [svc]
        if dup_delay:
            # As the sim's ring: the duplicate arrives later, a late copy
            # of a record the catalog may have moved past.
            metrics.incr("chaos.live.duplicatedRecords")
            release = time.monotonic() + dup_delay * self.round_s
            with self._lock:
                heapq.heappush(self._delayed,
                               (release, next(self._seq), svc.copy()))
        if delay:
            metrics.incr("chaos.live.delayedRecords")
            release = time.monotonic() + delay * self.round_s
            with self._lock:
                heapq.heappush(self._delayed,
                               (release, next(self._seq), out.pop(0)))
        return out

    def due_records(self) -> list:
        """Delayed records whose release time has passed (the bridge
        loop drains this every cycle)."""
        now = time.monotonic()
        out = []
        with self._lock:
            while self._delayed and self._delayed[0][0] <= now:
                out.append(heapq.heappop(self._delayed)[2])
        return out

    def pending_delayed(self) -> int:
        with self._lock:
            return len(self._delayed)

    def accept_push_pull(self) -> bool:
        """False inside this node's pause or crash window: the stalled
        process merges no full-state body either (the bridge's
        ``st_poll_state`` path bypasses :meth:`on_recv`)."""
        if not self.active:
            return True
        if self.plan.node_down(self.me, self.round_now()):
            metrics.incr("chaos.live.droppedStateMerges")
            return False
        return True

    # -- transport shim: outbound ------------------------------------------

    def filter_send(self, prepared: list) -> list:
        """The outbound boundary: a node inside a pause or crash window
        broadcasts nothing."""
        if not self.active:
            return prepared
        if prepared and self.plan.node_down(self.me, self.round_now()):
            metrics.incr("chaos.live.droppedBroadcasts", len(prepared))
            return []
        return prepared

    # -- health shim -------------------------------------------------------

    def check_fault(self, check_id: str) -> tuple[float, bool]:
        """(extra latency in seconds, fail?) of a health check now."""
        if not self.active:
            return 0.0, False
        return self.plan.health_fault_at(check_id, self.round_now())


class AdversaryInjector:
    """An ``AdversaryPlan`` on the live catalog.

    The sim forges packets between ``select_messages`` and
    ``record_transmissions``; the live twin forges the same catalog
    pushes.  For each active attacker and round, the forged
    ``(slot, packed value)`` columns of
    :meth:`CompiledAdversaryPlan.host_overrides` become ``Service``
    records: the hostname is the slot owner's (a forger writes any
    hostname), and ``gossip_origin`` is the attacker's transport name,
    the annotation ``ServicesState.merge`` stamps on push-pull records.

    A pure function of the plan, with no random draw.  Plan tick 0 is
    ``base_ns`` on the catalog's clock, at ``tick_s`` seconds a tick.
    The plan's tables are host arrays (the injector reads only
    ``host_overrides``), so they are built on the CPU.
    """

    def __init__(self, plan, node_names: list[str], *,
                 services_per_node: int, budget: int,
                 tick_s: float = 0.001, base_ns: int = 0) -> None:
        import numpy as np

        from sidecar_tpu_torch.chaos.adversary import CompiledAdversaryPlan

        if services_per_node <= 0:
            raise ValueError("services_per_node must be positive")
        self.names = list(node_names)
        n = len(self.names)
        owner = np.arange(n * services_per_node) // services_per_node
        self.compiled = CompiledAdversaryPlan(plan, n=n, owner=owner,
                                              budget=budget, device="cpu")
        self.services_per_node = int(services_per_node)
        self.tick_s = float(tick_s)
        self.base_ns = int(base_ns)

    def ticks_to_ns(self, ticks: int) -> int:
        return self.base_ns + int(round(ticks * self.tick_s * 1e9))

    def _record(self, slot: int, val: int):
        """One forged column as a live record; the status codes are the
        same numbers in both planes."""
        from sidecar_tpu_torch import service as svc_mod
        from sidecar_tpu_torch.ops import status as svc_status

        hostname = self.names[slot // self.services_per_node]
        ts = int(val) >> svc_status.STATUS_BITS
        stat = int(val) & ((1 << svc_status.STATUS_BITS) - 1)
        return svc_mod.Service(
            id=f"slot{slot}", name=f"svc{slot % self.services_per_node}",
            hostname=hostname, updated=self.ticks_to_ns(ts), status=stat)

    def forged_packets(self, round_idx: int, now_ticks) -> list:
        """The round's forged pushes, ``[(origin_name, [Service, ...])]``:
        one entry an active attacker, one record a forged column.
        ``now_ticks`` is the per-node clock ``[n]`` in plan ticks (with
        any ClockFault offsets applied, as the sim does)."""
        import numpy as np

        mask, slots, vals = self.compiled.host_overrides(
            round_idx, np.asarray(now_ticks, np.int64))
        out = []
        for i in np.where(mask.any(axis=1))[0]:
            cols = np.where(mask[i])[0]
            out.append((self.names[int(i)],
                        [self._record(int(slots[i, c]), int(vals[i, c]))
                         for c in cols]))
        return out

    def push_into(self, state, round_idx: int, now_ticks) -> int:
        """Deliver the round's forged pushes into a live catalog as the
        push-pull merge path would: score each packet against the origin
        gate, stamp each record's transport origin and hand it to the
        writer.  Returns the records handed over (the writer rejects a
        quarantined origin's)."""
        delivered = 0
        for origin, records in self.forged_packets(round_idx, now_ticks):
            gate = state.origin_gate
            if gate is not None:
                over = gate.observe(
                    origin,
                    [(svc.hostname == origin, svc.updated)
                     for svc in records],
                    state._now())
                if over:
                    metrics.incr("defense.live.originViolations", over)
            for svc in records:
                svc.gossip_origin = origin
                state.add_service_entry(svc)
                delivered += 1
        return delivered


class LiveChaosController:
    """The faults outside one node's record stream: full partitions
    (through the engine's receive drops, so SWIM and push-pull are cut
    too) and the isolation of paused nodes.  Call :meth:`tick` once a
    gossip interval, or :meth:`run` on a thread."""

    def __init__(self, plan: FaultPlan, transports: dict,
                 round_s: float) -> None:
        """``transports``: node name → ``GossipTransport`` in plan order
        (the insertion order gives the plan indices; keep it the
        injectors' ``node_names``)."""
        self.plan = plan
        self.transports = transports
        self.names = list(transports)
        self.round_s = round_s
        self._t0 = time.monotonic()
        self._applied: dict[tuple[str, str], int] = {}
        self._quit = threading.Event()

    def start(self, t0: Optional[float] = None) -> None:
        self._t0 = time.monotonic() if t0 is None else t0

    def round_now(self) -> int:
        return int((time.monotonic() - self._t0) / self.round_s) + 1

    def _full_cut(self, src: int, dst: int, round_idx: int) -> bool:
        for e in self.plan.edges:
            if not e.full_cut:
                continue
            if not (e.start_round <= round_idx < e.end_round):
                continue
            if (e.src == "all" or src in e.src) and \
                    (e.dst == "all" or dst in e.dst):
                return True
        return False

    def tick(self) -> None:
        """Set the engines' receive-drop masks to the plan's current
        round.  UDP is cut by direction (src → dst drops every UDP type
        from src on dst's engine); TCP push-pull is refused on both
        engines when either direction is fully cut, as the sim severs
        it; a node in a pause or crash window is cut off whole."""
        r = self.round_now()
        for di, dname in enumerate(self.names):
            dt = self.transports[dname]
            for si, sname in enumerate(self.names):
                if si == di:
                    continue
                down = self.plan.node_down(si, r) or \
                    self.plan.node_down(di, r)
                udp_cut = down or self._full_cut(si, di, r)
                pp_cut = down or udp_cut or self._full_cut(di, si, r)
                mask = (DROP_ALL_UDP if udp_cut else 0) | \
                    (DROP_PUSH_PULL if pp_cut else 0)
                key = (sname, dname)
                if self._applied.get(key, 0) != mask:
                    dt.test_drop_types(sname, mask)
                    self._applied[key] = mask
                    if mask:
                        metrics.incr("chaos.live.partitionEdgesCut")

    def run(self, poll_s: Optional[float] = None) -> threading.Thread:
        """Apply the plan on a daemon thread until :meth:`stop`."""
        poll = poll_s if poll_s is not None else self.round_s

        def loop() -> None:
            while not self._quit.is_set():
                self.tick()
                self._quit.wait(poll)

        t = threading.Thread(target=loop, name="chaos-controller",
                             daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._quit.set()
