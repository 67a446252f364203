"""Straight-line NumPy oracle of the exact round — the port of
``sidecar_tpu/sim/oracle.py``, the test-time ground truth.

A sequential, loop-based re-implementation of the catalog's merge,
sweep and anti-entropy semantics on the packed representation the
models use, mirroring the reference's control flow: one record merged
at a time, full-state exchanges pairwise and in order.  Only the
*sampling* is shared with the model — the round's ``RoundDraws``
through ``ops/gossip.sample_peers`` (with the sim's own stagger and
cadence gates) and ``ops/gossip.select_messages``, on CPU tensors.
Every state *transition* is the oracle's own: the announce schedule,
the per-record LWW merge with DRAINING stickiness against the pre-round
snapshot, the transmit accounting, push-pull, the lifespan sweep with
the +1 s rule, the future bound, and the per-origin budget with the
origin quarantine.

Same-round races (a DRAINING-sticky and a plain update to one cell) are
order-dependent in the reference catalog itself; the model resolves them
one way — stickiness against the pre-round state, then the max — and the
oracle does the same, record by record.

* :class:`OracleSim` mirrors ``ExactSim``'s lockstep round, and a
  ``ChaosExactSim`` whose plan only skews clocks (``FaultPlan.
  clock_offset``) and whose adversary forges packets
  (``CompiledAdversaryPlan.host_overrides``);
* :class:`PipelinedOracleSim` mirrors the pipelined round
  (``prime_pipeline`` / ``step_pipelined``);
* :class:`ProvenanceOracle` mirrors ``ops/provenance``'s attribution,
  fed the holder matrices and channels the model's provenance plane
  reads (``ExactSim._prov_belief``, ``ExactSim._prov_channels``).

The oracle works on any sim device: it copies the state to the host and
samples on CPU copies of the sim's graph and gates.
"""

from __future__ import annotations

import numpy as np
import torch

from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.ops import gossip as gossip_ops
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    DRAINING,
    STATUS_BITS,
    STATUS_MASK,
    SUSPECT,
    TOMBSTONE,
)


def _ts(p: int) -> int:
    return p >> STATUS_BITS


def _st(p: int) -> int:
    return p & STATUS_MASK


def _pack(ts: int, st: int) -> int:
    return (int(ts) << STATUS_BITS) | int(st)


def _host(x):
    """A tensor (on any device) on the CPU; None stays None."""
    return None if x is None else x.cpu()


def _np(x) -> np.ndarray:
    """A tensor, array or sequence as a NumPy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class OracleSim:
    """Sequential mirror of :class:`ExactSim`'s round.  Evolves its own
    NumPy state from the round's draws; ``known``/``sent`` match the
    model's bit for bit."""

    def __init__(self, sim, state):
        self.sim = sim
        self.p = sim.p
        self.t = sim.t
        self.known = _np(state.known).copy()
        self.sent = _np(state.sent).astype(np.int32)
        self.node_alive = _np(state.node_alive).copy()
        self.round_idx = int(state.round_idx)
        self.owner = _np(sim.owner)
        self.limit = sim.p.resolved_retransmit_limit()
        self._nbrs, self._cut = _host(sim._nbrs), _host(sim._cut)
        # A clock-only chaos plan leaves the round's structure ExactSim's,
        # so the oracle reads each node's skew off the plan (edge and
        # node faults are not mirrored).
        plan = getattr(sim, "plan", None)
        self.chaos = plan is not None
        self.clocks = plan if plan is not None and plan.clocks else None
        # The future-admission bound: None is off.
        self.future_ticks = sim.t.future_ticks
        # The adversary: its host formulas replay the forged columns on
        # the shared selection; the budget and quarantine knobs mirror
        # the chaos round's defences.
        self.adv = getattr(sim, "_adv", None)
        self.tomb_budget = sim.t.tomb_budget
        self.quarantine_threshold = sim.t.quarantine_threshold
        self.origin_violations = np.zeros(self.p.n, np.int64)

    def _gate_kw(self, round_idx: int) -> dict:
        """The sim's delivery gates at ``round_idx``, on the CPU.  The
        chaos round samples without the stagger and cadence gates."""
        if self.chaos:
            return {}
        return {k: _host(v) if isinstance(v, torch.Tensor) else v
                for k, v in common.gate_kwargs(self.sim, round_idx).items()}

    def _peers(self, slot, legs_gate: dict) -> np.ndarray:
        """Peer slots resolved to targets with the oracle's liveness."""
        return _np(gossip_ops.sample_peers(
            _host(slot).to(torch.int32), self.p.n, nbrs=self._nbrs,
            node_alive=torch.from_numpy(self.node_alive),
            cut_mask=self._cut, **legs_gate))

    def _select(self):
        """The shared top-``budget`` selection on the oracle's state."""
        svc_idx, msg = gossip_ops.select_messages(
            torch.from_numpy(self.known),
            torch.from_numpy(self.sent.astype(np.int8)),
            self.p.budget, self.limit)
        return svc_idx.numpy(), msg.numpy()

    def _offsets(self):
        """Each node's skew ticks this round, or None."""
        if self.clocks is None:
            return None
        return np.array([self.clocks.clock_offset(i, self.round_idx)
                         for i in range(self.p.n)], dtype=np.int64)

    def _too_future(self, ts: int, now_r: int) -> bool:
        """The receiver-side future bound against the receiver's clock
        ``now_r``; False when disabled."""
        return self.future_ticks is not None and \
            ts > now_r + self.future_ticks

    def _drop(self, draws: RoundDraws):
        """The round's loss as a bool ``[N, F, B]`` drop mask, or None."""
        if self.p.drop_prob > 0:
            return ~_np(draws.keep)
        return None

    # -- one delivered or announced value, against the pre-round state -----

    def apply_one(self, node: int, svc: int, incoming: int,
                  pre: np.ndarray) -> None:
        """One update through the merge: accept iff the packed key
        advances the cell; DRAINING stickiness against the pre-round
        snapshot ``pre`` (staleness was gated by the caller)."""
        if incoming == 0:
            return
        pre_val = int(pre[node, svc])
        if incoming > pre_val:
            if (pre_val >> STATUS_BITS) > 0 and _st(pre_val) == DRAINING \
                    and _st(incoming) == ALIVE:
                incoming = _pack(_ts(incoming), DRAINING)
            if incoming > int(self.known[node, svc]):
                self.known[node, svc] = incoming
            # Any advancing update re-enqueues the cell for relay.
            self.sent[node, svc] = 0

    def _announce(self, pre: np.ndarray, clock) -> None:
        """The owners' refresh re-stamps against ``pre``: the hash-spread
        phase and the elapsed-time guard, each by the owner's clock, and
        the Lifeguard refutation of a SUSPECT own record."""
        p, t = self.p, self.t
        guard = (t.refresh_rounds * t.round_ticks) // 4
        for m in range(p.m):
            o = int(self.owner[m])
            if not self.node_alive[o]:
                continue
            cur = int(pre[o, m])
            ts, st = _ts(cur), _st(cur)
            if ts == 0 or st == TOMBSTONE:
                continue
            now_o = clock(o)
            phase = ((m * 2654435761) & 0xFFFFFFFF) % t.refresh_rounds
            due = (self.round_idx % t.refresh_rounds) == phase \
                and (now_o - ts) >= guard
            if t.suspicion_window > 0 and st == SUSPECT:
                due, st = True, ALIVE
            if due:
                self.apply_one(o, m, _pack(now_o, st), pre)

    def _deliver(self, dst, svc_idx, msg, drop, pre, clock,
                 send_ok) -> None:
        """Every packet copy, record by record: staleness and the future
        bound at the receiver's clock, the per-origin budget rank, the
        liveness gates and the loss."""
        p, t = self.p, self.t
        tb = self.tomb_budget
        for s in range(p.n):
            for f in range(p.fanout):
                tgt = int(dst[s, f])
                now_r = clock(tgt)
                stale_floor = now_r - t.stale_ticks
                rank = 0
                for b in range(msg.shape[1]):
                    val = int(msg[s, b])
                    ts = val >> STATUS_BITS
                    if ts > 0 and ts < stale_floor:
                        continue
                    if self._too_future(ts, now_r):
                        continue
                    sv = int(svc_idx[s, b])
                    if tb is not None and ts > 0:
                        # The first ``tb`` suspicious third-party records
                        # of a packet pass, the rest drop.
                        own = int(self.owner[min(sv, p.m - 1)]) == s
                        if (not own) and (_st(val) == TOMBSTONE
                                          or ts > now_r):
                            rank += 1
                            if rank > tb:
                                continue
                    if not send_ok[s] or not self.node_alive[tgt]:
                        continue
                    if drop is not None and drop[s, f, b]:
                        continue
                    self.apply_one(tgt, sv, val, pre)

    def _charge(self, svc_idx, msg) -> None:
        """Transmit accounting: ``fanout`` sends a record offered
        (unclamped; a record over its limit is never offered again)."""
        for node in range(self.p.n):
            for b in range(msg.shape[1]):
                if msg[node, b] > 0:
                    self.sent[node, int(svc_idx[node, b])] += self.p.fanout

    # -- the full round, mirroring ExactSim._step ---------------------------

    def step(self, draws: RoundDraws) -> None:
        """One round from its draws (those the model's step takes)."""
        p, t = self.p, self.t
        self.round_idx += 1
        now = self.round_idx * t.round_ticks
        pre = self.known.copy()

        # 1. Select and deliver (the sampling is the model's); nodes off
        # their stagger or cadence send to themselves and still select
        # and charge.
        dst = self._peers(draws.peer_slot, self._gate_kw(self.round_idx))
        svc_idx, msg = self._select()

        # Per-node clocks: senders stamped with their own skewed clocks;
        # every receiver gates admission, refresh and expiry by its own.
        offs = self._offsets()

        def clock(node: int) -> int:
            return now if offs is None else max(0, now + int(offs[node]))

        # The adversary's forged columns land between the selection and
        # the transmit charge, stamped by each attacker's own clock.
        if self.adv is not None:
            now_vec = np.array([clock(i) for i in range(p.n)], np.int64)
            fmask, fslots, fvals = self.adv.host_overrides(
                self.round_idx, now_vec)
            svc_idx = np.where(fmask, fslots, svc_idx)
            msg = np.where(fmask, fvals, msg)

        # The quarantine gate reads the round-start evidence.
        tb = self.tomb_budget
        qt = self.quarantine_threshold
        quar = (np.zeros(p.n, bool) if qt is None
                else self.origin_violations >= qt)

        self._charge(svc_idx, msg)
        drop = self._drop(draws)

        # The quarantine evidence, on the raw candidates (before the
        # loss and liveness gates): a fresh third-party claim beyond the
        # budget rank charges the sending origin, per packet copy.
        if tb is not None:
            for s in range(p.n):
                for f in range(p.fanout):
                    now_r = clock(int(dst[s, f]))
                    rank = 0
                    for b in range(msg.shape[1]):
                        val = int(msg[s, b])
                        ts = val >> STATUS_BITS
                        if ts <= 0 or ts < now_r - t.stale_ticks:
                            continue
                        sv = int(svc_idx[s, b])
                        own = int(self.owner[min(sv, p.m - 1)]) == s
                        if (not own) and ts >= now_r:
                            rank += 1
                            if rank > tb:
                                self.origin_violations[s] += 1

        # A quarantined origin loses its send channel.
        send_ok = self.node_alive & ~quar
        self._deliver(dst, svc_idx, msg, drop, pre, clock, send_ok)

        # 2. The announce re-stamps (the same scatter in the model).
        self._announce(pre, clock)

        # 3. Push-pull.
        if self.round_idx % t.push_pull_rounds == 0:
            partner = self._peers(draws.pp_slot, {})[:, 0]
            alive = self.node_alive
            partner = np.where(alive & alive[partner], partner,
                               np.arange(p.n))
            if qt is not None:
                # A quarantined origin neither pushes nor is pulled from.
                partner = np.where(quar | quar[partner],
                                   np.arange(p.n), partner)
            self.push_pull(partner, now, offs)

        # 4. The lifespan sweep.
        if self.round_idx % t.sweep_rounds == 0:
            self.sweep(now, offs)

    # -- anti-entropy --------------------------------------------------------

    def push_pull(self, partner: np.ndarray, now: int, offs=None) -> None:
        """Two-way full-state exchange per initiator, every payload read
        from the pre-exchange snapshot; each leg admits at the receiving
        node's clock, with the per-origin budget ranked over the
        exchanged row (the sender's own slots exempt)."""
        n = self.known.shape[0]
        t = self.t
        tb = self.tomb_budget
        pre = self.known.copy()
        for i in range(n):
            tgt = int(partner[i])
            if tgt == i:
                continue
            for node, sender in ((i, tgt), (tgt, i)):
                now_r = now if offs is None \
                    else max(0, now + int(offs[node]))
                rank = 0
                for m in range(self.known.shape[1]):
                    val = int(pre[sender, m])
                    ts = val >> STATUS_BITS
                    if ts == 0 or ts < now_r - t.stale_ticks:
                        continue
                    if self._too_future(ts, now_r):
                        continue
                    if tb is not None:
                        own = int(self.owner[m]) == sender
                        if (not own) and (_st(val) == TOMBSTONE
                                          or ts > now_r):
                            rank += 1
                            if rank > tb:
                                continue
                    self.apply_one(node, m, val, pre)

    # -- the lifespan sweep --------------------------------------------------

    def sweep(self, now: int, offs=None) -> None:
        """Each node expires the others' records by its own clock: the
        +1 s tombstone rule, the tombstone GC, and with a suspicion
        window the SUSPECT quarantine before the tombstone."""
        t = self.t
        window = t.suspicion_window
        n, m_tot = self.known.shape
        now_g = now
        for node in range(n):
            now = now_g if offs is None \
                else max(0, now_g + int(offs[node]))
            for m in range(m_tot):
                cur = int(self.known[node, m])
                ts, st = _ts(cur), _st(cur)
                if ts == 0:
                    continue
                if st == TOMBSTONE:
                    if ts < now - t.tombstone_lifespan:
                        self.known[node, m] = 0
                        self.sent[node, m] = 0
                    continue
                if window > 0:
                    # Non-DRAINING expiry re-packs SUSPECT at the original
                    # ts; an unrefuted suspicion past the window
                    # tombstones (at ts + 1 s).
                    if st == SUSPECT:
                        if ts < now - t.alive_lifespan - window:
                            self.known[node, m] = _pack(
                                ts + t.one_second, TOMBSTONE)
                            self.sent[node, m] = 0
                        continue
                    if st == DRAINING:
                        if ts < now - t.draining_lifespan:
                            self.known[node, m] = _pack(
                                ts + t.one_second, TOMBSTONE)
                            self.sent[node, m] = 0
                        continue
                    if ts < now - t.alive_lifespan:
                        self.known[node, m] = _pack(ts, SUSPECT)
                        self.sent[node, m] = 0
                    continue
                lifespan = (t.draining_lifespan if st == DRAINING
                            else t.alive_lifespan)
                if ts < now - lifespan:
                    self.known[node, m] = _pack(ts + t.one_second, TOMBSTONE)
                    self.sent[node, m] = 0

    def convergence(self) -> float:
        alive = self.node_alive
        truth = np.max(np.where(alive[:, None], self.known, 0), axis=0)
        agree = (self.known == truth[None, :]).mean(axis=1)
        return float((agree * alive).sum() / max(alive.sum(), 1))

    def quarantined_origins(self) -> tuple:
        """Origins at or over the quarantine threshold (empty when the
        knob is off)."""
        qt = self.quarantine_threshold
        if qt is None:
            return ()
        return tuple(int(i) for i in
                     np.where(self.origin_violations >= qt)[0])


class PipelinedOracleSim(OracleSim):
    """Sequential mirror of ``ExactSim``'s pipelined round: the carried
    publish, selected one round stale.  :meth:`prime` takes the draws of
    round ``round_idx + 1`` (as ``prime_pipeline`` does), then each
    :meth:`step` the NEXT round's draws (as ``step_pipelined``); the
    current round's loss and push-pull partner ride the carried draws.
    Plain ``ExactSim`` rounds only: the chaos planes do not pipeline."""

    def __init__(self, sim, state):
        super().__init__(sim, state)
        if self.clocks is not None or self.adv is not None \
                or self.quarantine_threshold is not None:
            raise ValueError(
                "the pipelined oracle mirrors the plain ExactSim round; "
                "chaos planes (clocks/adversary/quarantine) are "
                "lockstep-only (supports_pipeline=False)")
        self.inflight = None

    def _select_inflight(self, draws: RoundDraws, round_sel: int):
        """Round ``round_sel``'s publish from the current belief, charged
        to ``sent`` before the fold (so an advance folded in the same
        tick resets the charge)."""
        dst = self._peers(draws.peer_slot, self._gate_kw(round_sel))
        svc_idx, msg = self._select()
        self._charge(svc_idx, msg)
        return dst, svc_idx, msg, draws

    def prime(self, draws: RoundDraws) -> None:
        """The prologue: select round ``round_idx + 1``'s publish."""
        self.inflight = self._select_inflight(draws, self.round_idx + 1)

    def step(self, draws_next: RoundDraws) -> None:
        """Fold the carried publish, select the next round's from the
        pre-fold belief, then the lockstep push-pull and sweep."""
        if self.inflight is None:
            raise ValueError("pipelined oracle not primed — call "
                             "prime(draws) first")
        p, t = self.p, self.t
        self.round_idx += 1
        now = self.round_idx * t.round_ticks
        pre = self.known.copy()
        dst, svc_idx, msg, draws = self.inflight
        # Round r+1's publish, before the deliveries write the state.
        self.inflight = self._select_inflight(draws_next,
                                              self.round_idx + 1)

        def clock(node: int) -> int:
            return now

        # The carried targets were gated with last round's liveness; the
        # fold drops packets of senders dead now.
        self._deliver(dst, svc_idx, msg, self._drop(draws), pre, clock,
                      self.node_alive)
        self._announce(pre, clock)
        if self.round_idx % t.push_pull_rounds == 0:
            partner = self._peers(draws.pp_slot, {})[:, 0]
            alive = self.node_alive
            partner = np.where(alive & alive[partner], partner,
                               np.arange(p.n))
            self.push_pull(partner, now, None)
        if self.round_idx % t.sweep_rounds == 0:
            self.sweep(now, None)


class ProvenanceOracle:
    """Sequential mirror of ``ops/provenance``: the same version-ref
    holder test and the minimal-(hops, node id) attribution, receiver by
    receiver with plain loops.  Fed the holder matrices and channel
    lists the model's plane reads, ``first_seen``, ``parent``, ``hops``
    and ``coverage`` match element for element."""

    # pack(tick=1, status=0): the floor of ops/provenance._MIN_KNOWN.
    MIN_KNOWN = 8

    def __init__(self, belief0, round0: int):
        belief0 = _np(belief0)                         # packed [N, T]
        self.n, self.t_n = belief0.shape
        self.ref = np.maximum(belief0.max(axis=0).astype(np.int64),
                              self.MIN_KNOWN)
        self.first_seen = np.full((self.t_n, self.n), -1, np.int64)
        self.parent = np.full((self.t_n, self.n), -1, np.int64)
        self.hops = np.full((self.t_n, self.n), -1, np.int64)
        self.coverage: list = []
        hold = self.holders(belief0)
        for ti in range(self.t_n):
            for node in range(self.n):
                if hold[node, ti]:
                    self.first_seen[ti, node] = int(round0)
                    self.hops[ti, node] = 0   # parent stays ORIGIN (-1)

    def holders(self, belief) -> np.ndarray:
        """Bool ``[N, T]``: beliefs that reached the traced version."""
        return _np(belief) >= self.ref[None, :]

    def observe(self, prev_hold, nxt_hold, round_idx: int,
                pushes=(), pulls=()) -> None:
        """Fold one round: every node newly holding a record takes the
        minimal-(hops, sender) open channel whose sender held it before
        the round; with none it is unattributed (−2) at hop 0."""
        prev_hold = _np(prev_hold)
        nxt_hold = _np(nxt_hold)

        def channels(chans):
            return [(_np(i), None if m is None
                     else np.broadcast_to(_np(m), np.shape(_np(i))))
                    for i, m in chans]

        pushes, pulls = channels(pushes), channels(pulls)
        for ti in range(self.t_n):
            for node in range(self.n):
                if not nxt_hold[node, ti] \
                        or self.first_seen[ti, node] >= 0:
                    continue
                best = None                            # (hops, sender)
                for idx, mask in pushes:
                    for s in range(idx.shape[0]):
                        if not prev_hold[s, ti]:
                            continue
                        for k in range(idx.shape[1]):
                            if int(idx[s, k]) != node:
                                continue
                            if mask is not None and not mask[s, k]:
                                continue
                            cand = (max(int(self.hops[ti, s]), 0), s)
                            if best is None or cand < best:
                                best = cand
                for idx, mask in pulls:
                    for k in range(idx.shape[1]):
                        if mask is not None and not mask[node, k]:
                            continue
                        src = int(idx[node, k])
                        if not prev_hold[src, ti]:
                            continue
                        cand = (max(int(self.hops[ti, src]), 0), src)
                        if best is None or cand < best:
                            best = cand
                self.first_seen[ti, node] = int(round_idx)
                if best is None:
                    self.parent[ti, node] = -2
                    self.hops[ti, node] = 0
                else:
                    self.parent[ti, node] = best[1]
                    self.hops[ti, node] = best[0] + 1
        self.coverage.append(
            nxt_hold.sum(axis=0).astype(np.int64).tolist())
