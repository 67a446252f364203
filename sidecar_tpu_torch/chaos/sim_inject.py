"""FaultPlan → simulator: the port of ``sidecar_tpu/chaos/sim_inject.py``
(``CompiledFaultPlan``, ``ChaosSimState``, ``ChaosExactSim``).

``ChaosExactSim`` is the exact model's round under a
:class:`~sidecar_tpu_torch.chaos.plan.FaultPlan` and, optionally, an
:class:`~sidecar_tpu_torch.chaos.adversary.AdversaryPlan`:

* **per-edge packet faults** — each plan edge entry resolves to static
  source and destination masks and a round window; every round the
  sampled targets are held against them and whole packets are dropped,
  delayed or duplicated;
* **delay rings** — each entry with ``delay_rounds``/``duplicate_prob``
  owns a ring of depth ``d`` (int32 ``[d, N·F·B]`` rows, columns and
  values; row ``N`` is the empty sentinel).  A diverted packet is
  re-resolved at ARRIVAL: staleness, the future bound and the
  receiver's liveness at the arrival round, stickiness against the
  arrival round's pre-round belief;
* **partitions** — directional ``drop_prob=1`` entries; a full cut in
  either direction also severs the push-pull with a sampled partner;
* **node windows** — pause (state kept) and crash (the row is wiped to
  a cold re-announce of the node's own records the round it restarts);
  a down node stays in the convergence denominator;
* **clock skew** (``ClockFault``) — a skewed node stamps with its own
  clock, ``max(now + offset, 0)``, while every receiver admits, pushes,
  pulls and sweeps by its own;
* **adversaries and defences** — forged columns between select and
  transmit accounting, the per-origin budget's evidence, and the
  quarantine of origins whose cumulative violations cross the
  threshold (read at the start of the round).

The round ends in ONE scatter over the immediate deliveries, the
matured ring batches and the announce: the hand-written CUDA kernel
``scatter_max_apply_kernel`` on the card (``ops/gossip.apply_updates``),
which drops the ring's sentinel rows.  ``known`` and ``sent`` are
updated in place, as by ``ExactSim``; the rings too.

The fault-draw seam: the reference roots every fault draw at
``fold_in(PRNGKey(plan.seed), round)``, never at the driver's key, and
its masks are ``bernoulli`` draws, ``uniform < p``.  The port carries
the uniforms (:class:`FaultDraws`) and computes each mask as ``u < p``
with ``p`` in float32.  :meth:`CompiledFaultPlan.draw` makes them from
a ``torch.Generator`` seeded from ``(fault_seed, round)`` alone, so the
fault schedule is a pure function of the plan and the round, whatever
the driver's seed; the drivers also take them as ``fault_draws=``, one
per round, beside ``draws=``.  Overlapping drop entries combine as
``1 − (1 − a)(1 − b)`` with the product and the subtraction rounded
once, as the reference's fused multiply-add on the CPU does.

An EMPTY plan equals the port's ``ExactSim`` round for the same draws.
The counters are int32 device scalars carried in the state; a driver
reads them on the host once a run, to publish the run's deltas to the
metrics registry under the reference's names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.chaos.adversary import (
    AdversaryPlan,
    CompiledAdversaryPlan,
)
from sidecar_tpu_torch.chaos.plan import FaultPlan, resolve_nodes
from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.models.exact import (
    I32,
    I64,
    ExactSim,
    SimParams,
    SimState,
    clone_state,
)
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import gossip as gossip_ops
from sidecar_tpu_torch.ops import trace as trace_ops
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.merge import (
    budget_mask,
    future_mask,
    staleness_mask,
)
from sidecar_tpu_torch.ops.status import (
    TOMBSTONE,
    pack,
    unpack_status,
    unpack_ts,
)
from sidecar_tpu_torch.ops.topology import Topology
from sidecar_tpu_torch.ops.ttl import ttl_sweep

F32 = torch.float32

# The counters a run publishes, as (registry name, state field).
_COUNTERS = (("chaos.sim.droppedPackets", "injected_drops"),
             ("chaos.sim.delayedPackets", "injected_delays"),
             ("chaos.sim.duplicatedPackets", "injected_dups"),
             ("clock.sim.rejectedFuture", "rejected_future"),
             ("adversary.sim.forgedRecords", "forged_records"),
             ("defense.sim.rejectedBudget", "rejected_budget"))


@dataclasses.dataclass
class ChaosSimState:
    """The exact-model state plus the chaos carry: the delay rings and
    the injection counters (int32 device scalars; ``origin_violations``
    int32 ``[N]``)."""

    sim: SimState
    rings: tuple           # per delay entry: (rows, cols, vals) int32 [d, L]
    injected_drops: torch.Tensor    # fault-dropped non-empty packets
    injected_delays: torch.Tensor   # packets diverted to a delay ring
    injected_dups: torch.Tensor     # packets copied for re-delivery
    rejected_future: torch.Tensor   # record copies the receiver's
                                    # future-admission bound rejected
    forged_records: torch.Tensor    # AdversaryPlan-forged columns
    rejected_budget: torch.Tensor   # record copies the per-origin budget
                                    # rejected
    origin_violations: torch.Tensor  # per-SENDER cumulative violations

    # The ExactSim drivers and planes address the state through these.
    @property
    def round_idx(self) -> int:
        return self.sim.round_idx

    @property
    def node_alive(self):
        return self.sim.node_alive

    @property
    def known(self):
        return self.sim.known

    @property
    def sent(self):
        return self.sim.sent


def clone_chaos_state(cst: ChaosSimState) -> ChaosSimState:
    """A copy of ``cst`` on fresh buffers, rings and counters included."""
    return dataclasses.replace(
        cst, sim=clone_state(cst.sim),
        rings=tuple(tuple(t.clone() for t in ring) for ring in cst.rings),
        **{f: getattr(cst, f).clone()
           for _, f in _COUNTERS + (("", "origin_violations"),)})


@dataclasses.dataclass(frozen=True)
class FaultDraws:
    """One round's fault uniforms, float32 ``[N, F]`` each: the drop
    mask's (None when no plan entry drops) and, per delay ring in ring
    order, its delay and duplicate masks' (None where that entry's
    probability is 0).  A mask is ``u < p``."""

    drop_u: Optional[torch.Tensor]
    delay_u: tuple
    dup_u: tuple

    def to(self, device) -> "FaultDraws":
        def mv(t):
            return None if t is None else t.to(device)
        return FaultDraws(mv(self.drop_u), tuple(map(mv, self.delay_u)),
                          tuple(map(mv, self.dup_u)))


def fault_generator_seed(fault_seed: int, round_idx: int) -> int:
    """The ``torch.Generator`` seed of a round's fault draws: a blake2b
    hash of ``(fault_seed, round_idx)``, so the schedule depends on
    nothing else."""
    payload = repr(("fault", int(fault_seed), int(round_idx))).encode()
    h = hashlib.blake2b(payload, digest_size=8).digest()
    return int.from_bytes(h, "big") & ((1 << 63) - 1)


def _combine_drop(a, b):
    """``1 − (1 − a)(1 − b)`` in float32 as a fused multiply-add gives
    it: the product of the two float32 factors is exact in float64, and
    the difference is rounded to float32 from there (it could differ
    from one rounding only where the float64 difference sits on a
    float32 midpoint)."""
    qa, qb = (1.0 - a).to(torch.float64), (1.0 - b).to(torch.float64)
    return (1.0 - qa * qb).to(F32)


class CompiledFaultPlan:
    """A FaultPlan resolved against a cluster of ``n`` nodes on
    ``device``: node selectors as bool tensors, entries split by
    capability.  Every window is decided on the host from the round
    index (a host int), so a round evaluates only its active entries
    and never reads the device."""

    def __init__(self, plan: FaultPlan, n: int, device="cuda"):
        self.plan = plan
        self.n = int(n)
        self.device = common.resolve_device(device, "CompiledFaultPlan")

        def mask(sel):
            m = np.zeros(n, bool)
            m[list(resolve_nodes(sel, n))] = True
            return torch.as_tensor(m, device=self.device)

        # (src_mask, dst_mask, entry, ring index or None)
        self.edge_entries = []
        ring_specs = []
        for e in plan.edges:
            ring_idx = None
            if e.needs_ring:
                ring_idx = len(ring_specs)
                ring_specs.append(e.ring_rounds)
            self.edge_entries.append((mask(e.src), mask(e.dst), e, ring_idx))
        self.ring_specs = tuple(ring_specs)
        self.node_entries = [(mask(f.nodes), f) for f in plan.nodes]
        # The crash entries' node ids, on the device, for the restarts.
        self._crash_rows = [
            (f.end_round, torch.as_tensor(
                resolve_nodes(f.nodes, n), dtype=I64, device=self.device))
            for f in plan.nodes if f.kind == "crash"]
        self.clock_entries = [(mask(f.nodes), f) for f in plan.clocks]
        self.has_drop = any(e.drop_prob > 0 for e in plan.edges)
        self.has_full_cut = any(e.full_cut for e in plan.edges)

    @staticmethod
    def _active(e, round_idx: int) -> bool:
        return e.start_round <= round_idx < e.end_round

    # -- the fault-draw seam -------------------------------------------------

    def draw(self, round_idx: int, fault_seed: int,
             fanout: int = 1) -> FaultDraws:
        """Round ``round_idx``'s fault uniforms ``[N, fanout]``, from a
        ``torch.Generator`` on the plan's device seeded from
        ``(fault_seed, round_idx)``.  A uniform is drawn only where the
        reference draws a mask: the drop mask when any entry drops, each
        ring entry's delay and duplicate masks where their probability
        is not 0."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(
            fault_generator_seed(fault_seed, round_idx))
        shape = (self.n, fanout)

        def u():
            return torch.rand(shape, generator=gen, device=dev, dtype=F32)

        drop_u = u() if self.has_drop else None
        delay_u, dup_u = [], []
        for _, _, e, ring_idx in self.edge_entries:
            if ring_idx is None:
                continue
            delay_u.append(u() if e.delay_prob > 0.0 else None)
            dup_u.append(u() if e.duplicate_prob > 0.0 else None)
        return FaultDraws(drop_u, tuple(delay_u), tuple(dup_u))

    # -- per-round evaluation -------------------------------------------------

    def edge_masks(self, dst, round_idx: int, fd: FaultDraws,
                   rows=slice(None)):
        """Hold this round's targets ``dst`` [N, F] (of the senders
        ``rows``, every node by default) against the edge entries.
        Returns ``(keep, diverts)``: ``keep`` bool [N, F] (False: the
        packet is dropped), or None when no entry drops; ``diverts`` a
        list of ``(ring_idx, delay_sel, dup_sel)``, bool [N, F] or None
        each.  A dropped packet is never diverted."""
        dst = dst.to(I64)

        def match(src_m, dst_m, e):
            return src_m[rows][:, None] & dst_m[dst] & \
                self._active(e, round_idx)

        drop_p = None
        for src_m, dst_m, e, _ in self.edge_entries:
            if e.drop_prob <= 0.0:
                continue
            p_e = torch.where(match(src_m, dst_m, e),
                              np.float32(e.drop_prob).item(), 0.0).to(F32)
            drop_p = p_e if drop_p is None else _combine_drop(drop_p, p_e)
        keep = None
        if drop_p is not None:
            keep = ~(fd.drop_u < drop_p)

        diverts = []
        for src_m, dst_m, e, ring_idx in self.edge_entries:
            if ring_idx is None:
                continue
            m = match(src_m, dst_m, e)
            if keep is not None:
                m = m & keep
            delay_sel = dup_sel = None
            if e.delay_prob > 0.0:
                delay_sel = (fd.delay_u[ring_idx]
                             < np.float32(e.delay_prob).item()) & m
            if e.duplicate_prob > 0.0:
                dup_sel = (fd.dup_u[ring_idx]
                           < np.float32(e.duplicate_prob).item()) & m
            diverts.append((ring_idx, delay_sel, dup_sel))
        return keep, diverts

    def pp_severed(self, partner, round_idx: int, rows=slice(None)):
        """bool [N]: the push-pull of the initiators ``rows`` (every node
        by default) with ``partner`` is severed (a full directional cut
        in either direction), or None when the plan has no full cut."""
        if not self.has_full_cut:
            return None
        partner = partner.to(I64)
        sev = torch.zeros(partner.shape[-1], dtype=torch.bool,
                          device=partner.device)
        for src_m, dst_m, e, _ in self.edge_entries:
            if e.full_cut and self._active(e, round_idx):
                sev = sev | (src_m[rows] & dst_m[partner]) | (
                    src_m[partner] & dst_m[rows])
        return sev

    def down_mask(self, round_idx: int):
        """bool [N]: inside a pause or crash window, or None when the
        plan has no node entries."""
        if not self.node_entries:
            return None
        down = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        for m, f in self.node_entries:
            if self._active(f, round_idx):
                down = down | m
        return down

    def restart_rows(self, round_idx: int):
        """The nodes whose crash window closes this round (they restart
        cold), an int64 tensor (a node may repeat), or None."""
        rows = [r for end, r in self._crash_rows if end == round_idx]
        return torch.cat(rows) if rows else None

    def clock_offsets(self, round_idx: int):
        """int32 [N]: each node's net skew this round (overlapping
        entries add; drift is a float32 multiply then a floor, as
        :meth:`ClockFault.offset_at`), or None when the plan has no
        clock entries."""
        if not self.clock_entries:
            return None
        off = torch.zeros(self.n, dtype=I32, device=self.device)
        for m, f in self.clock_entries:
            o = f.offset_at(round_idx)
            if o:
                off = off + torch.where(m, o, 0).to(I32)
        return off


class ChaosExactSim(ExactSim):
    """``ExactSim`` under a FaultPlan (and an AdversaryPlan).  Drivers
    ``run``, ``run_fast``, ``step``, ``run_with_trace``,
    ``run_with_digest``, ``run_with_deltas`` and ``run_with_provenance``
    take ``fault_draws=`` (one :class:`FaultDraws` per round) beside
    ``draws=``; without them a round draws its own from the plan.  A
    scenario ``perturb`` hook gets the inner :class:`SimState` with the
    round's faulted liveness and must not change ``node_alive``: the
    fault windows own it for the round.  No sparse or pipelined round:
    asking for either raises."""

    supports_sparse = False
    supports_pipeline = False

    def __init__(self, params: SimParams, topo: Topology,
                 timecfg: TimeConfig = TimeConfig(),
                 plan: FaultPlan = FaultPlan(seed=0), *, device="cuda",
                 perturb=None, cut_mask=None,
                 adversary: Optional[AdversaryPlan] = None):
        super().__init__(params, topo, timecfg, device=device,
                         perturb=perturb, cut_mask=cut_mask)
        self.plan = plan
        # The knobs carry the plan's seed: the fault draws' root.
        self._knobs = dataclasses.replace(self._knobs, fault_seed=plan.seed)
        self._prog = CompiledFaultPlan(plan, params.n, self.device)
        self.adversary = adversary
        self._adv = None
        if adversary is not None and adversary.attacks:
            self._adv = CompiledAdversaryPlan(
                adversary, n=params.n, owner=self.owner,
                budget=min(params.budget, params.m), device=self.device)
        # The horizon guard covers the highest tick a skewed or forged
        # stamp can reach.
        self._skew_ticks = plan.max_clock_offset + (
            adversary.max_future_ticks if adversary is not None else 0)
        self._fault_seq = None
        self._node_ids = torch.arange(params.n, dtype=I32,
                                      device=self.device)

    # -- state ---------------------------------------------------------------

    def init_state(self, live_fraction: float = 1.0,
                   seed: int = 0) -> ChaosSimState:
        base = super().init_state(live_fraction, seed)
        p, dev = self.p, self.device
        flat = p.n * p.fanout * min(p.budget, p.m)
        rings = tuple(
            (torch.full((d, flat), p.n, dtype=I32, device=dev),
             torch.zeros((d, flat), dtype=I32, device=dev),
             torch.zeros((d, flat), dtype=I32, device=dev))
            for d in self._prog.ring_specs)

        def zero():
            return torch.zeros((), dtype=I32, device=dev)

        return ChaosSimState(
            sim=base, rings=rings, injected_drops=zero(),
            injected_delays=zero(), injected_dups=zero(),
            rejected_future=zero(), forged_records=zero(),
            rejected_budget=zero(),
            origin_violations=torch.zeros(p.n, dtype=I32, device=dev))

    @staticmethod
    def _clone_state(state):
        return clone_chaos_state(state)

    # -- the fault draws -----------------------------------------------------

    def fault_draw(self, round_idx: int) -> FaultDraws:
        """Round ``round_idx``'s fault uniforms from the plan's seed."""
        return self._prog.draw(round_idx, self._knobs.fault_seed,
                               fanout=self.p.fanout)

    @contextlib.contextmanager
    def _faults(self, fault_draws):
        """Hand a driver's ``fault_draws`` to its rounds."""
        self._fault_seq = None if fault_draws is None else list(fault_draws)
        try:
            yield
        finally:
            self._fault_seq = None

    def _round_fault(self, i: int, round_idx: int) -> FaultDraws:
        if self._fault_seq is None:
            return self.fault_draw(round_idx)
        if i >= len(self._fault_seq):
            raise ValueError(f"{len(self._fault_seq)} fault draws for "
                             f"round {i + 1} of the run")
        return self._fault_seq[i].to(self.device)

    # -- the chaos round -----------------------------------------------------

    def _step(self, cst: ChaosSimState, draws: RoundDraws,
              fd: Optional[FaultDraws] = None) -> ChaosSimState:
        """One chaos round, in place on ``known``, ``sent`` and the
        rings; the counters are new tensors.  ``fd`` defaults to the
        plan's draws for the round."""
        p, t, prog, kn = self.p, self.t, self._prog, self._knobs
        dev = self.device
        n, fanout = p.n, p.fanout
        state = cst.sim
        round_idx = state.round_idx + 1
        now = round_idx * t.round_ticks
        if fd is None:
            fd = self.fault_draw(round_idx)
        ids = self._node_ids

        # 1. Faulted liveness for this round; the carried liveness stays
        # the base one.
        base_alive = state.node_alive
        down = prog.down_mask(round_idx)
        alive = base_alive if down is None else base_alive & ~down

        # 2. Per-node stamping clocks (None: the global clock).
        off = prog.clock_offsets(round_idx)
        now_n = None if off is None else torch.clamp(now + off, min=0)

        # 3. The knobs; the quarantine set from the round-start evidence.
        ft, tb, qt = kn.future_arg(), kn.budget_arg(), kn.quarantine_arg()
        rej, forged = cst.rejected_future, cst.forged_records
        brej, viol = cst.rejected_budget, cst.origin_violations
        quar = None if qt is None else viol >= qt

        # 4. Crash restarts: the row becomes a cold re-announce of the
        # node's own records, its transmit counts reset.
        known, sent = state.known, state.sent
        r = prog.restart_rows(round_idx)
        if r is not None:
            s = p.services_per_node
            own_cols = r[:, None] * s + torch.arange(s, dtype=I64,
                                                     device=dev)
            own = known[r[:, None], own_cols]
            st = unpack_status(own)
            stamp = now if now_n is None else now_n[r][:, None]
            cold = torch.where((unpack_ts(own) > 0) & (st != TOMBSTONE),
                               pack(stamp, st), 0)
            known[r] = 0
            known[r[:, None], own_cols] = cold
            sent[r] = 0

        # 5. The scenario hook, on the faulted liveness.
        hooked = common.apply_perturb(
            self.perturb, dataclasses.replace(state, node_alive=alive), now,
            kn)
        known, sent = hooked.known, hooked.sent

        # 6. The sample, with the cut.
        dst = gossip_ops.sample_peers(
            draws.peer_slot.to(dev, I32), n, nbrs=self._nbrs,
            node_alive=alive, cut_mask=self._cut)

        # 7. Select, the adversary's forgeries, the transmit charge.
        svc_idx, msg = gossip_ops.select_messages(known, sent, p.budget,
                                                  kn.limit)
        forging = self._adv is not None and self._adv.active_at(round_idx)
        if forging:
            adv_now = ids.new_full((n,), now) if now_n is None else now_n
            svc_idx, msg, nforged = self._adv.corrupt(round_idx, adv_now,
                                                      svc_idx, msg)
            forged = forged + nforged
        gossip_ops.record_transmissions(sent, svc_idx, msg, fanout,
                                        repeats=forging)

        # 8. The edge masks; counts only of non-empty packets.
        keep, diverts = prog.edge_masks(dst, round_idx, fd)
        budget = svc_idx.shape[1]
        nonempty = (msg > 0).any(dim=1)[:, None]

        def count(mask):
            return (mask & nonempty).sum(dtype=I32)

        drops = cst.injected_drops
        if keep is not None:
            drops = drops + count(~keep)

        record_keep = self._keep(draws)
        recv_now = now if now_n is None else now_n[dst.to(I64)][:, :, None]
        cand = msg[:, None, :].expand(n, fanout, budget)
        # 9. Wire copies the receiver's future bound rejects, on the raw
        # candidate set.
        if ft is not None:
            rej = rej + (future_mask(cand, recv_now, ft)
                         & (cand > 0)).sum(dtype=I32)
        # 10. The budget's evidence: fresh third-party claims beyond the
        # budget, charged per packet copy to the sending origin.
        own_sel = None
        if tb is not None:
            own_sel = self.owner[svc_idx.clamp(max=p.m - 1).to(I64)] \
                == ids[:, None]
            own3 = own_sel[:, None, :]
            bcand = torch.where(
                staleness_mask(cand, recv_now, kn.stale_ticks), 0, cand)
            bts = unpack_ts(bcand)
            fresh = (bts > 0) & ~own3 & (bts >= recv_now)
            erank = torch.cumsum(fresh.to(I32), dim=-1, dtype=I32)
            viol = viol + (fresh & (erank > tb)).sum(dim=(1, 2), dtype=I32)
            if ft is not None:
                bcand = torch.where(future_mask(bcand, recv_now, ft), 0,
                                    bcand)
            brej = brej + budget_mask(bcand, recv_now, tb,
                                      own3).sum(dtype=I32)
        # 11. Quarantined origins lose their send channel.
        ekeep = keep
        if quar is not None:
            qkeep = ~quar[:, None]
            ekeep = qkeep if ekeep is None else ekeep & qkeep

        # 12. The deliveries at each receiver's clock.
        rows, cols, vals = gossip_ops.expand_deliveries(
            dst, svc_idx, msg, now_tick=recv_now,
            stale_ticks=kn.stale_ticks, node_alive=alive,
            record_keep=record_keep, edge_keep=ekeep, future_ticks=ft,
            tomb_budget=tb, sender_own=own_sel)

        def flat(mask):
            return mask[:, :, None].expand(n, fanout, budget).reshape(-1)

        # 13. Delays and duplicates split from the immediate batch.
        delays, dups = cst.injected_delays, cst.injected_dups
        delay_any = None
        for _, delay_sel, dup_sel in diverts:
            if delay_sel is not None:
                delays = delays + count(delay_sel)
                delay_any = delay_sel if delay_any is None else \
                    delay_any | delay_sel
            if dup_sel is not None:
                dups = dups + count(dup_sel)
        vals_imm = vals if delay_any is None else \
            torch.where(flat(delay_any), 0, vals)

        # 14. Each ring: pop the batch that matured in this round's slot,
        # re-resolve it at arrival, push this round's diverted packets.
        all_rows, all_cols, all_vals = [rows], [cols], [vals_imm]
        for ring_idx, delay_sel, dup_sel in diverts:
            divert = delay_sel if dup_sel is None else (
                dup_sel if delay_sel is None else delay_sel | dup_sel)
            r_rows, r_cols, r_vals = cst.rings[ring_idx]
            slot = round_idx % r_rows.shape[0]
            m_rows, m_cols = r_rows[slot].clone(), r_cols[slot].clone()
            m_vals = r_vals[slot]
            m_idx = m_rows.clamp(max=n - 1).to(I64)
            m_now = now if now_n is None else now_n[m_idx]
            m_vals = torch.where(
                staleness_mask(m_vals, m_now, kn.stale_ticks), 0, m_vals)
            if ft is not None:
                fm = future_mask(m_vals, m_now, ft)
                rej = rej + (fm & (m_vals > 0)).sum(dtype=I32)
                m_vals = torch.where(fm, 0, m_vals)
            m_vals = torch.where((m_rows < n) & alive[m_idx], m_vals, 0)
            all_rows.append(m_rows)
            all_cols.append(m_cols)
            all_vals.append(m_vals)
            fm = flat(divert)
            r_rows[slot] = torch.where(fm, rows, n)
            r_cols[slot] = cols
            r_vals[slot] = torch.where(fm, vals, 0)

        # 15. Stickiness against the pre-round belief, every batch.
        if len(all_rows) > 1:
            rows, cols = torch.cat(all_rows), torch.cat(all_cols)
            vals = torch.cat(all_vals)
        else:
            vals = vals_imm
        d_vals, d_adv = gossip_ops.finalize_deliveries(known, rows, cols,
                                                       vals)

        # 16-17. The announce at each owner's clock, in the same scatter.
        a_rows, a_cols, a_vals, a_due = self._announce_updates(
            known, alive, round_idx,
            now if now_n is None else now_n[self.owner.to(I64)])
        gossip_ops.apply_updates(
            known, sent, torch.cat([rows, a_rows]), torch.cat([cols, a_cols]),
            torch.cat([d_vals, a_vals]), torch.cat([d_adv, a_due]))

        # 18-19. Push-pull with the partner, cut, severed and quarantine
        # remapped; the pull leg at the initiator's clock, the push leg
        # at the partner's.
        if round_idx % kn.push_pull_rounds == 0:
            if draws.pp_slot is None:
                raise ValueError(f"round {round_idx} runs push-pull and "
                                 "its draws carry no pp_slot")
            partner = gossip_ops.sample_peers(
                draws.pp_slot.to(dev, I32), n, nbrs=self._nbrs,
                node_alive=alive, cut_mask=self._cut)[:, 0]
            sever = prog.pp_severed(partner, round_idx)
            if sever is not None:
                partner = torch.where(sever, ids, partner)
            if quar is not None:
                partner = torch.where(quar | quar[partner.to(I64)], ids,
                                      partner)
            pidx = partner.to(I64)
            pp_now = now if now_n is None else now_n[:, None]
            pp_push = None if now_n is None else now_n[pidx][:, None]
            if ft is not None:
                pulled = known[pidx]
                rej = rej + (future_mask(pulled, pp_now, ft)
                             & (pulled > 0)).sum(dtype=I32)
                del pulled
                push_now = pp_now if pp_push is None else pp_push
                rej = rej + (future_mask(known, push_now, ft)
                             & (known > 0)).sum(dtype=I32)
            merged = gossip_ops.push_pull(
                known, partner, now_tick=pp_now, stale_ticks=kn.stale_ticks,
                node_alive=alive, future_ticks=ft, now_push=pp_push,
                tomb_budget=tb, owner=self.owner if tb is not None else None)
            sent.masked_fill_(merged != known, 0)
            known.copy_(merged)
            del merged

        # 20. The sweep at each node's clock.
        if round_idx % kn.sweep_rounds == 0:
            swept, _ = ttl_sweep(
                known, now if now_n is None else now_n[:, None],
                alive_lifespan=kn.alive_lifespan,
                draining_lifespan=kn.draining_lifespan,
                tombstone_lifespan=kn.tombstone_lifespan,
                one_second=t.one_second,
                suspicion_window=kn.suspicion_window)
            sent.masked_fill_(swept != known, 0)
            known.copy_(swept)

        return ChaosSimState(
            sim=SimState(known=known, sent=sent, node_alive=base_alive,
                         round_idx=round_idx),
            rings=cst.rings, injected_drops=drops, injected_delays=delays,
            injected_dups=dups, rejected_future=rej, forged_records=forged,
            rejected_budget=brej, origin_violations=viol)

    # -- the run loop ---------------------------------------------------------

    def _run(self, state, num_rounds: int, conv: bool, generator, draws,
             sparse: bool, plane=None):
        """``num_rounds`` chaos rounds in place, each with its fault
        draws (the driver's ``fault_draws``, else the plan's); a plane
        sees ``(draws, fault draws)`` as the round's draws."""
        if sparse:
            raise ValueError("the chaos round has no sparse form")
        self.last_sparse_stats = None
        curve = []
        for i, d in enumerate(common.round_draws(
                self, state.round_idx + 1, num_rounds, generator, draws)):
            fd = self._round_fault(i, state.round_idx + 1)
            pre = None if plane is None else plane.before(state, (d, fd))
            state = self._step(state, d, fd)
            if plane is not None:
                plane.after(pre, state, None)
            if conv:
                curve.append(self.convergence(state))
        return state, (torch.stack(curve) if curve else torch.zeros(
            0, dtype=F32, device=self.device))

    # -- counters and metrics ------------------------------------------------

    def _counter_vector(self, cst: ChaosSimState):
        """The run counters as one int64 device vector: the six scalars,
        the violations' sum and the quarantined origins' count."""
        qt = self._knobs.quarantine_arg()
        quarantined = torch.zeros((), dtype=I64, device=self.device) \
            if qt is None else (cst.origin_violations >= qt).sum()
        return torch.stack([getattr(cst, f).to(I64) for _, f in _COUNTERS]
                           + [cst.origin_violations.sum(dtype=I64),
                              quarantined.to(I64)])

    def _published(self, run, state, fault_draws):
        """Run ``run(state)`` with ``fault_draws``, then publish the
        run's counter deltas, read on the host once."""
        before = self._counter_vector(state)
        with self._faults(fault_draws):
            out = run(state)
        final = out[0] if isinstance(out, tuple) else out
        after = self._counter_vector(final)
        delta = torch.cat([after[:7] - before[:7], after[7:]]).tolist()
        for (name, _), v in zip(_COUNTERS, delta[:6]):
            if v:
                metrics.incr(name, v)
        if delta[6]:
            metrics.incr("defense.sim.originViolations", delta[6])
        quarantined = delta[7]
        if quarantined:
            metrics.incr("defense.sim.quarantinedOrigins", quarantined)
        return out

    def injection_counts(self, cst: ChaosSimState) -> dict:
        """The carried counters as host ints (reads the device)."""
        return {"dropped": int(cst.injected_drops),
                "delayed": int(cst.injected_delays),
                "duplicated": int(cst.injected_dups),
                "rejected_future": int(cst.rejected_future),
                "forged": int(cst.forged_records),
                "rejected_budget": int(cst.rejected_budget),
                "quarantined": len(self.quarantined_origins(cst))}

    def quarantined_origins(self, cst: ChaosSimState) -> tuple:
        """Node ids whose cumulative budget violations crossed the
        quarantine threshold; empty with the threshold off."""
        qt = self._knobs.quarantine_arg()
        if qt is None:
            return ()
        viol = cst.origin_violations.cpu().numpy()
        return tuple(int(i) for i in np.where(viol >= qt)[0])

    def convergence(self, cst) -> torch.Tensor:
        return super().convergence(cst.sim if isinstance(
            cst, ChaosSimState) else cst)

    # -- telemetry hooks -----------------------------------------------------

    def _trace_before(self, cst: ChaosSimState):
        return super()._trace_before(cst.sim), cst.rejected_future

    def _trace_record(self, prev, nxt: ChaosSimState, stats):
        """The exact model's record of the wrapped states, with the
        round's ``rejected_future`` count."""
        p, kn = self.p, self._knobs
        (prev_sim, census), rej0 = prev
        return trace_ops.exact_record(
            prev_sim, nxt.sim, budget=min(p.budget, p.m), fanout=p.fanout,
            limit=p.resolved_retransmit_limit(), stats=stats,
            rejected_future=nxt.rejected_future - rej0,
            tick_period=kn.tick_period, tick_phase=kn.tick_phase,
            census=census)

    def _prov_channels(self, cst: ChaosSimState, round_draws):
        """The chaos round's OPEN channels, given the post-round state
        and ``(draws, fault draws)``: gossip pushes that survived the
        edge drops and were not delayed (a matured delay arrives with
        no live channel), and the push-pull edge where the plan has not
        severed it.  The hook is not rerun: it must not touch the
        liveness."""
        d, fd = round_draws
        p, prog, kn = self.p, self._prog, self._knobs
        round_idx = cst.round_idx
        down = prog.down_mask(round_idx)
        alive = cst.node_alive if down is None else cst.node_alive & ~down
        dst = gossip_ops.sample_peers(
            d.peer_slot.to(self.device, I32), p.n, nbrs=self._nbrs,
            node_alive=alive, cut_mask=self._cut)
        keep, diverts = prog.edge_masks(dst, round_idx, fd)
        push_mask = keep
        for _, delay_sel, _ in diverts:
            if delay_sel is not None:
                push_mask = ~delay_sel if push_mask is None else \
                    push_mask & ~delay_sel
        pushes, pulls = [(dst, push_mask)], []
        if round_idx % kn.push_pull_rounds == 0:
            partner = gossip_ops.sample_peers(
                d.pp_slot.to(self.device, I32), p.n, nbrs=self._nbrs,
                node_alive=alive, cut_mask=self._cut)[:, 0]
            sever = prog.pp_severed(partner, round_idx)
            if sever is not None:
                partner = torch.where(sever, self._node_ids, partner)
            pushes.append((partner[:, None], None))
            pulls.append((partner[:, None], None))
        return pushes, pulls

    # -- drivers --------------------------------------------------------------

    def step(self, state: ChaosSimState, *, generator=None,
             draws: Optional[RoundDraws] = None,
             fault_draws: Optional[FaultDraws] = None) -> ChaosSimState:
        """One round on a copy of ``state`` (no metrics published)."""
        self._check_horizon(state, 1)
        (d,) = common.round_draws(self, state.round_idx + 1, 1, generator,
                                  common.one_draw(draws))
        fd = None if fault_draws is None else fault_draws.to(self.device)
        return self._step(self._clone_state(state), d, fd)

    def run(self, state, num_rounds: int, *, generator=None, draws=None,
            fault_draws: Optional[Sequence[FaultDraws]] = None,
            donate: bool = True, start_round=None, sparse=None,
            pipeline=None):
        return self._published(
            lambda st: super(ChaosExactSim, self).run(
                st, num_rounds, generator=generator, draws=draws,
                donate=donate, start_round=start_round, sparse=sparse,
                pipeline=pipeline), state, fault_draws)

    def run_fast(self, state, num_rounds: int, *, generator=None,
                 draws=None,
                 fault_draws: Optional[Sequence[FaultDraws]] = None,
                 donate: bool = True, start_round=None, sparse=None,
                 pipeline=None):
        return self._published(
            lambda st: super(ChaosExactSim, self).run_fast(
                st, num_rounds, generator=generator, draws=draws,
                donate=donate, start_round=start_round, sparse=sparse,
                pipeline=pipeline), state, fault_draws)

    def run_with_trace(self, state, num_rounds: int, *, cap: int = 0,
                       generator=None, draws=None,
                       fault_draws: Optional[Sequence[FaultDraws]] = None,
                       donate: bool = True, start_round=None, sparse=None):
        return self._published(
            lambda st: super(ChaosExactSim, self).run_with_trace(
                st, num_rounds, cap=cap, generator=generator, draws=draws,
                donate=donate, start_round=start_round, sparse=sparse),
            state, fault_draws)

    def run_with_digest(self, state, num_rounds: int, *, cap: int = 0,
                        buckets: int = 64, idents=None, generator=None,
                        draws=None,
                        fault_draws: Optional[Sequence[FaultDraws]] = None,
                        donate: bool = True, start_round=None, sparse=None):
        return self._published(
            lambda st: super(ChaosExactSim, self).run_with_digest(
                st, num_rounds, cap=cap, buckets=buckets, idents=idents,
                generator=generator, draws=draws, donate=donate,
                start_round=start_round, sparse=sparse),
            state, fault_draws)

    def run_with_deltas(self, state, num_rounds: int, cap: int, *,
                        generator=None, draws=None,
                        fault_draws: Optional[Sequence[FaultDraws]] = None,
                        donate: bool = True, start_round=None, sparse=None):
        """As ``ExactSim``'s; like the reference's, it publishes no
        counters."""
        with self._faults(fault_draws):
            return super().run_with_deltas(
                state, num_rounds, cap, generator=generator, draws=draws,
                donate=donate, start_round=start_round, sparse=sparse)

    def run_with_provenance(self, state, num_rounds: int, tracked, *,
                            cap: int = 0, prov=None, generator=None,
                            draws=None,
                            fault_draws: Optional[Sequence[FaultDraws]]
                            = None,
                            donate: bool = True, start_round=None,
                            sparse=None):
        return self._published(
            lambda st: super(ChaosExactSim, self).run_with_provenance(
                st, num_rounds, tracked, cap=cap, prov=prov,
                generator=generator, draws=draws, donate=donate,
                start_round=start_round, sparse=sparse),
            state, fault_draws)
