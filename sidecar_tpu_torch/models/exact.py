"""The exact record-level gossip model — the port of
``sidecar_tpu/models/exact.py``'s ``ExactSim`` dense lockstep round on
one device.

State is the packed int32 ``known[N, M]`` (node n's belief about every
service slot; slot m is owned by node ``m // services_per_node``), the
int8 transmit counts ``sent[N, M]`` and ``node_alive[N]``.  One round
(:meth:`ExactSim._step`), from the round's :class:`RoundDraws`:

1. select — each node's top-``budget`` freshest eligible records
   (``ops/gossip.select_messages``), charged to ``sent``;
2. deliver + announce — the messages as update triples to the sampled
   peers, with the merge gates and stickiness against the pre-round
   state, plus the owners' refresh re-stamps, applied in ONE scatter-max
   on ``known`` and one reset of ``sent`` — the hand-written CUDA kernel
   ``scatter_max_apply_kernel`` on the card;
3. push-pull with one sampled partner, every ``push_pull_rounds``;
4. the TTL sweep, every ``sweep_rounds``.

Two more forms of the round, chosen per dispatch (``sparse=``,
``pipeline=``; they do not compose):

* the sparse-frontier round (:meth:`ExactSim._step_sparse`) selects on
  the compacted sender rows only — rows with an eligible record — so
  the select runs on ``[C, M]`` and the deliveries shrink to ``C·F·B``
  triples; the scatter (K4a) still runs once a round.  A round with
  more than ``sparse_cap`` senders runs the dense round instead; the
  overflow check reads the sender count on the host, the round's one
  sync.  It equals the dense round bit for bit;
* the software-pipelined round (:meth:`ExactSim._step_pipelined`)
  applies round r's carried selection while it selects round r+1's from
  the pre-apply belief (one round stale), with one K4a scatter.

Peer sampling takes the topology's round stagger and the per-node tick
cadence (``tick_period``/``tick_phase``) as delivery gates, and the
partition cut (``cut_mask``, bool ``[N, D]`` over the neighbour list; a
cut edge sends to itself) on both the gossip and the push-pull sample.
A scenario hook (``perturb``) runs before each round's sample, in every
form of the round: the reference hands its hook the round's
``k_perturb`` key, and the port draws no threefry, so a port hook is
called ``perturb(state, now)`` — or ``perturb(state, now, knobs)`` when
it sets ``wants_knobs`` — takes its randomness from a generator (or
masks) of its own, may write ``known`` and ``sent`` in place, and
returns the state (``models/common.apply_perturb``).

The reference's ``lax.cond`` on the round counter (steps 3 and 4) is a
host branch on ``state.round_idx``, a Python int.

Telemetry: ``run_with_trace``, ``run_with_digest``, ``run_with_deltas``
and ``run_with_provenance`` run the same rounds (dense, or ``sparse=``)
with a plane of ``models/planes.py`` observing each one, and return
``(final, stream, conv)``.  The round rewrites ``known`` in place, so
the trace and delta planes copy it before each round (the trace plane
also takes the offer census then); provenance gathers only its
``[N, T]`` columns.  The plain run methods build no plane.

In place: the reference's ``run*`` drivers donate their state, so
``run`` and ``run_fast`` here update ``known`` and ``sent`` in place (a
copy of ``known`` is 671 MB at the bench shape) and return a state that
shares them; the input state must not be used afterwards unless the call
passed ``donate=False``, which clones it first.  ``step`` leaves its
input intact, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.models import planes
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import delta as delta_ops
from sidecar_tpu_torch.ops import digest as digest_ops
from sidecar_tpu_torch.ops import gossip as gossip_ops
from sidecar_tpu_torch.ops import knobs as knob_ops
from sidecar_tpu_torch.ops import pipeline as pipeline_ops
from sidecar_tpu_torch.ops import sparse as sparse_ops
from sidecar_tpu_torch.ops import suspicion as suspicion_ops
from sidecar_tpu_torch.ops import trace as trace_ops
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.pipeline import Inflight
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    TOMBSTONE,
    is_known,
    pack,
    unpack_status,
)
from sidecar_tpu_torch.ops.topology import Topology
from sidecar_tpu_torch.ops.ttl import ttl_sweep
from sidecar_tpu_torch.telemetry import cost

I32, I64 = torch.int32, torch.int64


@dataclasses.dataclass
class SimState:
    """One round's state.  ``round_idx`` is a host int (the round
    counter every cadence branch reads)."""

    known: torch.Tensor        # int32 [N, M] packed (ts << 3 | status)
    sent: torch.Tensor         # int8 [N, M] transmit counts
    node_alive: torch.Tensor   # bool [N]
    round_idx: int


def clone_state(state: SimState) -> SimState:
    """A copy of ``state`` on fresh buffers."""
    return dataclasses.replace(state, known=state.known.clone(),
                               sent=state.sent.clone(),
                               node_alive=state.node_alive.clone())


@dataclasses.dataclass(frozen=True)
class SimParams:
    n: int
    services_per_node: int = 10
    fanout: int = 3             # gossip targets per round
    budget: int = 15            # records per message batch
    drop_prob: float = 0.0      # UDP loss fault injection
    retransmit_limit: int = 0   # 0 = auto (RetransmitMult semantics)
    sparse_cap: int = 0         # C — sender-frontier width of the sparse
                                # round (0 = auto); a round with more
                                # senders runs the dense round instead

    def __post_init__(self):
        if self.resolved_retransmit_limit() + self.fanout - 1 > 127:
            raise ValueError(
                f"retransmit_limit={self.resolved_retransmit_limit()} + "
                f"fanout={self.fanout} - 1 exceeds the int8 transmit "
                "counter range (127)")

    @property
    def m(self) -> int:
        return self.n * self.services_per_node

    def resolved_retransmit_limit(self) -> int:
        if self.retransmit_limit > 0:
            return self.retransmit_limit
        return 4 * math.ceil(math.log10(self.n + 1))


class ExactSim:
    """Single-device exact simulator: the dense lockstep round, the
    sparse-frontier round and the software-pipelined round (modes and
    cadence as in :class:`~sidecar_tpu_torch.models.compressed.
    CompressedSim`)."""

    supports_sparse = True
    supports_pipeline = True
    # The shard group whose ranks hold the other node rows, or None
    # (this sim holds every row): the telemetry planes reduce through it.
    _row_group = None

    def __init__(self, params: SimParams, topo: Topology,
                 timecfg: TimeConfig = TimeConfig(), *, device="cuda",
                 perturb=None, cut_mask=None, sparse=None, pipeline=None,
                 tick_period=None, tick_phase=None):
        if topo.n != params.n:
            raise ValueError(
                f"topology has {topo.n} nodes, params say {params.n}")
        self.p = params
        self.t = timecfg
        self.topo = topo
        self.device = common.resolve_device(device, "ExactSim")
        dev = self.device
        self._nbrs = None if topo.nbrs is None else \
            torch.as_tensor(np.asarray(topo.nbrs), dtype=I32, device=dev)
        self._deg = None if topo.deg is None else \
            torch.as_tensor(np.asarray(topo.deg), dtype=I32, device=dev)
        # The scenario hook (common.apply_perturb) and the partition cut,
        # which gates the gossip and the push-pull sample alike.
        self.perturb = perturb
        self._cut = common.cut_tensor(cut_mask, topo, dev)
        # Ticks past the global clock that a stamp can reach (the chaos
        # round's skewed clocks and forged stamps), for the horizon check.
        self._skew_ticks = 0
        self._sparse_mode = sparse_ops.resolve_sparse(sparse)
        self._pipeline_mode = pipeline_ops.resolve_pipeline(pipeline)
        self._sparse_cap = min(
            params.n,
            params.sparse_cap or sparse_ops.default_frontier_cap(params.n))
        # The last sparse dispatch's int32 [3] stats; None after a dense
        # or pipelined one.
        self.last_sparse_stats = None
        tick_period, tick_phase = common.resolve_cadence(
            tick_period, tick_phase, params.n, dev)
        self._knobs = knob_ops.from_protocol(
            params, timecfg, tick_period=tick_period, tick_phase=tick_phase)
        self._stagger = common.stagger_tensor(topo, dev)
        self._stagger_period = int(topo.stagger_period)
        # owner[m] = node that announces slot m; own_flat[m] = the flat
        # index of the owner's own cell of slot m in known.
        self.owner = torch.div(torch.arange(params.m, dtype=I32, device=dev),
                               params.services_per_node,
                               rounding_mode="floor")
        self._own_flat = self.owner.to(I64) * params.m + \
            torch.arange(params.m, dtype=I64, device=dev)

    @staticmethod
    def _clone_state(state):
        """A copy of ``state`` on fresh buffers (the drivers' ``donate=
        False`` and the ``step*`` methods)."""
        return clone_state(state)

    # -- state construction -------------------------------------------------

    def init_state(self, live_fraction: float = 1.0,
                   seed: int = 0) -> SimState:
        """Cold start: every owner knows (only) its own services,
        announced at tick 1; with ``live_fraction`` < 1 a
        ``default_rng(seed)`` draw leaves the rest of the slots empty."""
        p, dev = self.p, self.device
        vals = torch.full((p.m,), pack(1, ALIVE), dtype=I32, device=dev)
        if live_fraction < 1.0:
            rng = np.random.default_rng(seed)
            live = torch.as_tensor(rng.random(p.m) < live_fraction,
                                   device=dev)
            vals = torch.where(live, vals, 0)
        known = torch.zeros((p.n, p.m), dtype=I32, device=dev)
        known.view(-1)[self._own_flat] = vals
        return SimState(
            known=known,
            sent=torch.zeros((p.n, p.m), dtype=torch.int8, device=dev),
            node_alive=torch.ones((p.n,), dtype=torch.bool, device=dev),
            round_idx=0)

    # -- the round's phases -------------------------------------------------

    @cost.phased("announce")
    def _announce_updates(self, known, node_alive, round_idx: int,
                          now: int):
        """Update triples of the owners' refresh re-stamps (hash-spread
        phase and elapsed-time guard, ``ops/gossip.refresh_due``), plus
        the self-refutation of a SUSPECT own record when the suspicion
        window is on.  A cell not due gets row ``N`` and value 0, which
        the scatter drops.  Returns ``(rows, cols, vals, due)``."""
        p, t, kn = self.p, self.t, self._knobs
        cols = torch.arange(p.m, dtype=I32, device=known.device)
        own = known.view(-1)[self._own_flat]
        st = unpack_status(own)
        present = is_known(own) & node_alive[self.owner.to(I64)]
        due = gossip_ops.refresh_due(
            own, cols, round_idx, refresh_rounds=kn.refresh_rounds,
            round_ticks=t.round_ticks, now=now) & present \
            & (st != TOMBSTONE)
        due, st = suspicion_ops.announce_refute(due, st, present,
                                                kn.suspicion_enabled)
        vals = torch.where(due, pack(now, st), 0)
        rows = torch.where(due, self.owner, p.n)
        return rows, cols, vals, due

    def _round_updates(self, known, node_alive, dst, svc_idx, msg, keep,
                       round_idx: int, now: int, *, senders=None,
                       sender_alive=None):
        """The round's update triples ``(rows, cols, vals, advanced)``:
        the deliveries of the selected ``(svc_idx, msg)`` to ``dst`` and
        the owners' announce, both against the current ``known``, for
        the one scatter (:func:`~sidecar_tpu_torch.ops.gossip.
        apply_updates`, K4a on the card).  ``senders`` (int32 ``[C]``)
        are the node ids of a compacted batch's rows, with their
        liveness ``sender_alive``; None is every node in order."""
        p, kn = self.p, self._knobs
        tb = kn.budget_arg()
        sender_own = None
        if tb is not None:
            # A node's own records never count against its budget; the
            # padding column M reads slot M-1's owner with msg 0.
            if senders is None:
                senders = torch.arange(p.n, dtype=I32, device=known.device)
            sender_own = self.owner[svc_idx.clamp(max=p.m - 1).to(I64)] \
                == senders[:, None]
        d_rows, d_cols, d_vals, d_adv = gossip_ops.prepare_deliveries(
            known, dst, svc_idx, msg, now_tick=now,
            stale_ticks=kn.stale_ticks, node_alive=node_alive,
            sender_alive=sender_alive, record_keep=keep,
            future_ticks=kn.future_arg(), tomb_budget=tb,
            sender_own=sender_own)
        a_rows, a_cols, a_vals, a_due = self._announce_updates(
            known, node_alive, round_idx, now)
        return (torch.cat([d_rows, a_rows]), torch.cat([d_cols, a_cols]),
                torch.cat([d_vals, a_vals]), torch.cat([d_adv, a_due]))

    def _round_deliver_announce(self, known, sent, node_alive, dst, keep,
                                round_idx: int, now: int):
        """Phases 1 + 2: select, charge, deliver, announce, and the one
        combined scatter — ``known`` and ``sent`` updated in place.  The
        sparse round's overflow fallback."""
        p, kn = self.p, self._knobs
        svc_idx, msg = gossip_ops.select_messages(known, sent, p.budget,
                                                  kn.limit)
        gossip_ops.record_transmissions(sent, svc_idx, msg, p.fanout)
        updates = self._round_updates(known, node_alive, dst, svc_idx,
                                       msg, keep, round_idx, now)
        gossip_ops.apply_updates(known, sent, *updates)

    def _round_deliver_announce_sparse(self, known, sent, node_alive, dst,
                                       keep, round_idx: int, now: int,
                                       sender):
        """Phases 1 + 2 on the compacted sender frontier — equal to the
        dense form when the frontier fits its cap (the caller checks).
        Every omitted row would offer nothing (no eligible record, so
        ``msg == 0``), and the scatter-max is commutative, so the
        compacted triples give the dense result.  The select runs on
        ``[C, M]``, each row's tie rotation seeded by its global id; the
        charge drops the pad rows; the loss mask is the dense draw,
        sliced."""
        p, kn = self.p, self._knobs
        idx_s, row_s, valid_s, _ = sparse_ops.compact_rows(
            sender, self._sparse_cap)
        rs = row_s.to(I64)
        known_s = torch.where(valid_s[:, None], known[rs], 0)
        svc, msg = gossip_ops.select_messages(known_s, sent[rs], p.budget,
                                              kn.limit, row_ids=idx_s)
        gossip_ops.record_transmissions(sent, svc, msg, p.fanout,
                                        row_ids=idx_s)
        updates = self._round_updates(
            known, node_alive, dst[rs], svc, msg,
            None if keep is None else keep[rs], round_idx, now,
            senders=row_s, sender_alive=node_alive[rs] & valid_s)
        gossip_ops.apply_updates(known, sent, *updates)

    def _push_pull(self, known, sent, node_alive, pp_slot, now: int):
        """Anti-entropy with the round's sampled partner, written back
        into ``known`` (and the reset into ``sent``) in place."""
        p, kn = self.p, self._knobs
        partner = gossip_ops.sample_peers(
            pp_slot.to(known.device, I32), p.n, nbrs=self._nbrs,
            node_alive=node_alive, cut_mask=self._cut)[:, 0]
        tb = kn.budget_arg()
        merged = gossip_ops.push_pull(
            known, partner, now_tick=now, stale_ticks=kn.stale_ticks,
            node_alive=node_alive, future_ticks=kn.future_arg(),
            tomb_budget=tb, owner=self.owner if tb is not None else None)
        sent.masked_fill_(merged != known, 0)
        known.copy_(merged)

    def _sweep(self, known, sent, now: int):
        """The lifespan sweep, written back in place; expired cells get
        their transmit counts reset."""
        t, kn = self.t, self._knobs
        swept, _ = ttl_sweep(
            known, now, alive_lifespan=kn.alive_lifespan,
            draining_lifespan=kn.draining_lifespan,
            tombstone_lifespan=kn.tombstone_lifespan,
            one_second=t.one_second, suspicion_window=kn.suspicion_window)
        sent.masked_fill_(swept != known, 0)
        known.copy_(swept)

    def _sample(self, node_alive, draws: RoundDraws, round_idx: int):
        """Round ``round_idx``'s gossip targets from its draws, gated by
        the stagger and the tick cadence at that round."""
        return gossip_ops.sample_peers(
            draws.peer_slot.to(self.device, I32), self.p.n,
            nbrs=self._nbrs, node_alive=node_alive, cut_mask=self._cut,
            **common.gate_kwargs(self, round_idx))

    def _keep(self, draws: RoundDraws):
        """The round's loss mask on this device, or None without loss."""
        return draws.keep.to(self.device) if self._knobs.needs_drop_draw \
            else None

    def _tail(self, state: SimState, draws: RoundDraws, round_idx: int,
              now: int) -> SimState:
        """Phases 3 + 4 — push-pull and the sweep on their cadences, in
        place and dense in every form of the round — and the round
        counter."""
        kn = self._knobs
        if round_idx % kn.push_pull_rounds == 0:
            if draws.pp_slot is None:
                raise ValueError(f"round {round_idx} runs push-pull and "
                                 "its draws carry no pp_slot")
            self._push_pull(state.known, state.sent, state.node_alive,
                            draws.pp_slot, now)
        if round_idx % kn.sweep_rounds == 0:
            self._sweep(state.known, state.sent, now)
        return dataclasses.replace(state, round_idx=round_idx)

    def _step(self, state: SimState, draws: RoundDraws) -> SimState:
        """One dense lockstep round from this round's draws, updating
        ``state.known`` and ``state.sent`` in place."""
        round_idx = state.round_idx + 1
        now = round_idx * self.t.round_ticks
        state = common.apply_perturb(self.perturb, state, now, self._knobs)
        dst = self._sample(state.node_alive, draws, round_idx)
        self._round_deliver_announce(state.known, state.sent,
                                     state.node_alive, dst,
                                     self._keep(draws), round_idx, now)
        return self._tail(state, draws, round_idx, now)

    def _step_sparse(self, state: SimState, draws: RoundDraws):
        """One round on the sparse path, in place: the compacted sender
        frontier where it fits ``sparse_cap``, else the dense round —
        equal either way.  Returns ``(state, (ran sparse, overflowed,
        senders))`` as host ints."""
        round_idx = state.round_idx + 1
        now = round_idx * self.t.round_ticks
        state = common.apply_perturb(self.perturb, state, now, self._knobs)
        known, sent, alive = state.known, state.sent, state.node_alive
        dst = self._sample(alive, draws, round_idx)
        keep = self._keep(draws)
        sender = gossip_ops.eligible_records(known, sent,
                                             self._knobs.limit).any(dim=1)
        n_s = int(sender.sum())
        overflow = n_s > self._sparse_cap
        if overflow:
            self._round_deliver_announce(known, sent, alive, dst, keep,
                                         round_idx, now)
        else:
            self._round_deliver_announce_sparse(known, sent, alive, dst,
                                                keep, round_idx, now,
                                                sender)
        state = self._tail(state, draws, round_idx, now)
        return state, (int(not overflow), int(overflow), n_s)

    def _select_inflight(self, known, sent, node_alive, draws: RoundDraws,
                         round_sel: int):
        """Select round ``round_sel``'s publish from the current belief:
        its targets (gated at ``round_sel``, with the current liveness —
        stale by one) and the top-``budget`` eligible records, charged
        to ``sent`` in place (a version advance applied in the same tick
        resets the charge, as in the lockstep round)."""
        p = self.p
        dst = self._sample(node_alive, draws, round_sel)
        svc_idx, msg = gossip_ops.select_messages(known, sent, p.budget,
                                                  self._knobs.limit)
        gossip_ops.record_transmissions(sent, svc_idx, msg, p.fanout)
        return Inflight(round_sel, (dst, svc_idx, msg), draws)

    def _step_pipelined(self, state: SimState, inflight: Inflight,
                        draws_next: RoundDraws):
        """One pipelined tick, in place: round r's carried selection
        becomes update triples against the pre-apply ``known`` (with the
        announce), round r+1's publish is selected from that same
        belief and charged, then one scatter applies round r, and
        push-pull and the sweep run as in the lockstep round.  Returns
        ``(state, inflight')``."""
        round_idx = state.round_idx + 1
        if inflight.round_idx != round_idx:
            raise ValueError(
                f"the carried publish is round {inflight.round_idx}'s, "
                f"the state's next round is {round_idx}")
        now = round_idx * self.t.round_ticks
        state = common.apply_perturb(self.perturb, state, now, self._knobs)
        known, sent, alive = state.known, state.sent, state.node_alive
        dst, svc_idx, msg = inflight.publish
        draws = inflight.draws
        # Every read of the pre-apply belief comes before the charge and
        # the scatter write into it.
        updates = self._round_updates(known, alive, dst, svc_idx, msg,
                                      self._keep(draws), round_idx, now)
        nxt = self._select_inflight(known, sent, alive, draws_next,
                                    round_idx + 1)
        gossip_ops.apply_updates(known, sent, *updates)
        return self._tail(state, draws, round_idx, now), nxt

    # -- metrics ------------------------------------------------------------

    def convergence(self, state: SimState) -> torch.Tensor:
        """Fraction of (alive node, slot) cells agreeing with the
        freshest alive belief (float32 0-d tensor; 1.0 = converged)."""
        alive = state.node_alive
        truth = torch.where(alive[:, None], state.known, 0).amax(dim=0)
        agree = state.known == truth[None, :]
        return common.alive_mean(agree.sum(dim=1, dtype=I32), self.p.m,
                                 alive)

    # -- drivers ------------------------------------------------------------
    #
    # As the compressed model's: draws from ``generator`` or ``draws=``,
    # ``sparse=``/``pipeline=`` resolved against the sim's modes,
    # ``start_round`` standing in for ``state.round_idx`` in the horizon
    # check, and chunked runs equal to straight ones.  ``run*`` update
    # the state in place unless ``donate=False``.

    def _check_horizon(self, state, num_rounds: int, start_round=None):
        if start_round is None:
            start_round = state.round_idx
        self.t.validate_horizon(start_round + num_rounds,
                                skew_ticks=self._skew_ticks)

    def _resolve_sparse_request(self, sparse) -> bool:
        return sparse_ops.resolve_request(self._sparse_mode, sparse,
                                          self.supports_sparse)

    def _resolve_pipeline_request(self, pipeline) -> bool:
        return pipeline_ops.resolve_request(self._pipeline_mode, pipeline,
                                            self.supports_pipeline)

    def _pipeline_dispatch(self, sparse) -> None:
        """Guard a pipelined dispatch: the selection it carries is the
        dense select, so the sparse-frontier round does not compose
        with it."""
        if self._resolve_sparse_request(sparse):
            raise ValueError(
                "pipelined execution does not compose with the "
                "sparse-frontier round (the carried selection is the "
                "dense select); pass sparse='0' or pipeline=False")

    def default_generator(self, seed: int) -> torch.Generator:
        """A ``torch.Generator`` on this sim's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def draw(self, generator: torch.Generator, round_idx: int) -> RoundDraws:
        """Draw the randomness of the round that advances the state to
        ``round_idx``: peers, the ``[N, F, B]`` keep mask when loss is
        on, and the push-pull partner on a push-pull round."""
        p, kn = self.p, self._knobs
        return gossip_ops.draw_round(
            generator, p.n, p.fanout, deg=self._deg,
            push_pull=round_idx % kn.push_pull_rounds == 0,
            keep_prob=kn.keep_prob, keep_width=min(p.budget, p.m),
            partner=True)

    def step(self, state: SimState, *, generator=None,
             draws: Optional[RoundDraws] = None) -> SimState:
        """One round, from ``draws`` or from ``generator``, on a copy of
        ``state`` (the input stays intact)."""
        self._check_horizon(state, 1)
        (d,) = common.round_draws(self, state.round_idx + 1, 1, generator,
                                  common.one_draw(draws))
        return self._step(self._clone_state(state), d)

    def step_sparse(self, state: SimState, *, generator=None,
                    draws: Optional[RoundDraws] = None):
        """One sparse-path round on a copy of ``state``; returns
        ``(state, stats)``, stats an int32 ``[3]`` tensor."""
        self._resolve_sparse_request(True)
        self._check_horizon(state, 1)
        (d,) = common.round_draws(self, state.round_idx + 1, 1, generator,
                                  common.one_draw(draws))
        state, stats = self._step_sparse(self._clone_state(state), d)
        return state, torch.tensor(stats, dtype=I32)

    def _run(self, state, num_rounds: int, conv: bool, generator, draws,
             sparse: bool, plane=None):
        """``num_rounds`` lockstep (or sparse) rounds in place, sampling
        :meth:`convergence` after each where ``conv``, with ``plane``
        (``models/planes.py``) observing each round where given; a
        sparse run leaves its stats in ``last_sparse_stats``."""
        self.last_sparse_stats = None
        acc = [0, 0, 0]
        curve = []
        for d in common.round_draws(self, state.round_idx + 1, num_rounds,
                                    generator, draws):
            pre = None if plane is None else plane.before(state, d)
            st = None
            if sparse:
                state, st = self._step_sparse(state, d)
                acc = [acc[0] + st[0], acc[1] + st[1], max(acc[2], st[2])]
            else:
                state = self._step(state, d)
            if plane is not None:
                plane.after(pre, state, st)
            if conv:
                curve.append(self.convergence(state))
        if sparse:
            self.last_sparse_stats = torch.tensor(acc, dtype=I32)
        return state, (torch.stack(curve) if curve else torch.zeros(
            0, dtype=torch.float32, device=self.device))

    def run_fast(self, state: SimState, num_rounds: int, *,
                 generator=None,
                 draws: Optional[Sequence[RoundDraws]] = None,
                 donate: bool = True, start_round=None, sparse=None,
                 pipeline=None) -> SimState:
        """Run ``num_rounds`` rounds in place (see the module note on
        ``donate``); returns the final state."""
        if self._resolve_pipeline_request(pipeline):
            self._pipeline_dispatch(sparse)
            return self.run_fast_pipelined(
                state, num_rounds, generator=generator, draws=draws,
                donate=donate, start_round=start_round)[0]
        self._check_horizon(state, num_rounds, start_round)
        if not donate:
            state = self._clone_state(state)
        return self._run(state, num_rounds, False, generator, draws,
                         self._resolve_sparse_request(sparse))[0]

    def run(self, state: SimState, num_rounds: int, *, generator=None,
            draws: Optional[Sequence[RoundDraws]] = None,
            donate: bool = True, start_round=None, sparse=None,
            pipeline=None):
        """Like :meth:`run_fast`, sampling :meth:`convergence` after every
        round; returns ``(final, conv[num_rounds])``."""
        if self._resolve_pipeline_request(pipeline):
            self._pipeline_dispatch(sparse)
            final, conv, _ = self.run_pipelined(
                state, num_rounds, generator=generator, draws=draws,
                donate=donate, start_round=start_round)
            return final, conv
        self._check_horizon(state, num_rounds, start_round)
        if not donate:
            state = self._clone_state(state)
        return self._run(state, num_rounds, True, generator, draws,
                         self._resolve_sparse_request(sparse))

    # -- telemetry planes ----------------------------------------------------

    def _trace_before(self, state: SimState):
        """What a trace record needs of the pre-round state, taken before
        the round rewrites it: the offer census and a copy of
        ``known``."""
        p = self.p
        census = trace_ops.offer_census(
            gossip_ops.eligible_records(state.known, state.sent,
                                        p.resolved_retransmit_limit()),
            min(p.budget, p.m), p.fanout)
        return dataclasses.replace(state, known=state.known.clone(),
                                   sent=None), census

    def _trace_record(self, prev, nxt: SimState, stats):
        """One round's flight-recorder record; ``prev`` is
        :meth:`_trace_before`'s."""
        p, kn = self.p, self._knobs
        prev, census = prev
        return trace_ops.exact_record(
            prev, nxt, budget=min(p.budget, p.m), fanout=p.fanout,
            limit=p.resolved_retransmit_limit(), stats=stats,
            tick_period=kn.tick_period, tick_phase=kn.tick_phase,
            census=census, group=self._row_group)

    def _digest_record(self, nxt: SimState, idents, buckets: int):
        """One round's coherence record over the post-round belief."""
        return digest_ops.state_digest_record(
            nxt.round_idx, nxt.known, nxt.node_alive, idents, buckets,
            group=self._row_group)

    def _resolve_digest_idents(self, idents):
        """The caller's identity table, or the sim-slot default."""
        return planes.digest_idents(idents, self.p.m, self.device)

    def _delta_belief(self, state: SimState):
        """The belief a delta batch diffs: a copy of ``known``."""
        return state.known.clone()

    @staticmethod
    def _delta_batch(prev, nxt, cap: int):
        """One round's :class:`~sidecar_tpu_torch.ops.delta.DeltaBatch`
        between two beliefs."""
        return delta_ops.extract_delta(prev, nxt, cap)

    def _prov_belief(self, state: SimState, tracked):
        """Packed ``[N, T]`` belief of the tracked slots."""
        return state.known[:, tracked.to(I64)]

    def _prov_channels(self, state: SimState, draws: RoundDraws):
        """The round's sampled channels, from its draws as the step
        resolves them, given the post-round ``state`` (its liveness is
        the one the round sampled with, after the hook): the gossip
        pushes to ``dst`` and, on a push-pull round, the two-way edge to
        the partner."""
        round_idx = state.round_idx
        dst = self._sample(state.node_alive, draws, round_idx)
        pushes, pulls = [(dst, None)], []
        if round_idx % self._knobs.push_pull_rounds == 0:
            partner = gossip_ops.sample_peers(
                draws.pp_slot.to(self.device, I32), self.p.n,
                nbrs=self._nbrs, node_alive=state.node_alive,
                cut_mask=self._cut)
            pushes.append((partner, None))
            pulls.append((partner, None))
        return pushes, pulls

    def _run_plane(self, state, num_rounds: int, make_plane, generator,
                   draws, donate: bool, start_round, sparse):
        self._check_horizon(state, num_rounds, start_round)
        if not donate:
            state = self._clone_state(state)
        plane = make_plane(state)
        final, conv = self._run(state, num_rounds, True, generator, draws,
                                self._resolve_sparse_request(sparse),
                                plane=plane)
        return final, plane.result, conv

    def run_with_trace(self, state: SimState, num_rounds: int, *,
                       cap: int = 0, generator=None,
                       draws: Optional[Sequence[RoundDraws]] = None,
                       donate: bool = True, start_round=None, sparse=None):
        """:meth:`run` with the flight recorder (``ops/trace.py``):
        returns ``(final, RoundTrace, conv)``; ``cap`` bounds the record
        buffer (0 is every round)."""
        cap = cap or num_rounds
        return self._run_plane(
            state, num_rounds, lambda st: planes.TracePlane(self, cap),
            generator, draws, donate, start_round, sparse)

    def run_with_digest(self, state: SimState, num_rounds: int, *,
                        cap: int = 0,
                        buckets: int = digest_ops.DEFAULT_BUCKETS,
                        idents=None, generator=None,
                        draws: Optional[Sequence[RoundDraws]] = None,
                        donate: bool = True, start_round=None,
                        sparse=None):
        """:meth:`run` with the coherence digest (``ops/digest.py``):
        returns ``(final, DigestTrace, conv)``."""
        cap = cap or num_rounds
        idents = self._resolve_digest_idents(idents)
        return self._run_plane(
            state, num_rounds,
            lambda st: planes.DigestPlane(self, cap, idents, buckets),
            generator, draws, donate, start_round, sparse)

    def run_with_deltas(self, state: SimState, num_rounds: int, cap: int,
                        *, generator=None,
                        draws: Optional[Sequence[RoundDraws]] = None,
                        donate: bool = True, start_round=None,
                        sparse=None):
        """:meth:`run` with each round's changed cells
        (``ops/delta.py``): returns ``(final, DeltaBatch[num_rounds],
        conv)``."""
        return self._run_plane(
            state, num_rounds, lambda st: planes.DeltaPlane(self, st, cap),
            generator, draws, donate, start_round, sparse)

    def run_with_provenance(self, state: SimState, num_rounds: int,
                            tracked, *, cap: int = 0, prov=None,
                            generator=None,
                            draws: Optional[Sequence[RoundDraws]] = None,
                            donate: bool = True, start_round=None,
                            sparse=None):
        """:meth:`run` with the provenance tracer of the ``tracked``
        slots (``ops/provenance.py``): returns ``(final, ProvTrace,
        conv)``.  ``cap`` bounds the coverage window (0 is
        ``num_rounds``); a chunked caller passes the previous chunk's
        trace as ``prov``."""
        tracked = planes.check_tracked(tracked, self.p.m)
        cap = cap or num_rounds
        return self._run_plane(
            state, num_rounds,
            lambda st: planes.ProvPlane(
                self, planes.start_prov(self, st, tracked, cap, prov),
                tracked),
            generator, draws, donate, start_round, sparse)

    # -- pipelined runs (draw order as in the compressed model) -------------

    def prime_pipeline(self, state: SimState, *, generator=None,
                       draws: Optional[RoundDraws] = None):
        """Fill the pipeline on a copy of ``state``: select round
        ``state.round_idx + 1``'s publish, charging ``sent``.  Returns
        ``(state, inflight)``."""
        state = self._clone_state(state)
        return self._prime(state, generator, common.one_draw(draws))

    def _prime(self, state, generator, draws):
        (d,) = common.round_draws(self, state.round_idx + 1, 1, generator,
                                  draws)
        inflight = self._select_inflight(state.known, state.sent,
                                         state.node_alive, d,
                                         state.round_idx + 1)
        return state, inflight

    def step_pipelined(self, state: SimState, inflight: Inflight, *,
                       generator=None, draws: Optional[RoundDraws] = None):
        """One pipelined tick on a copy of ``state``; ``draws`` are the
        NEXT round's, ``state.round_idx + 2``.  Returns ``(state,
        inflight)``."""
        self._check_horizon(state, 1)
        (d,) = common.round_draws(self, state.round_idx + 2, 1, generator,
                                  common.one_draw(draws))
        return self._step_pipelined(self._clone_state(state), inflight, d)

    def _run_pipelined(self, state, num_rounds: int, conv: bool, inflight,
                       generator, draws, donate: bool):
        self._resolve_pipeline_request(True)
        self.last_sparse_stats = None
        if not donate:
            state = self._clone_state(state)
        draws = None if draws is None else list(draws)
        if inflight is None:
            state, inflight = self._prime(
                state, generator, None if draws is None else draws[:1])
            draws = None if draws is None else draws[1:]
        curve = []
        for d in common.round_draws(self, state.round_idx + 2, num_rounds,
                                    generator, draws):
            state, inflight = self._step_pipelined(state, inflight, d)
            if conv:
                curve.append(self.convergence(state))
        curve = torch.stack(curve) if curve else \
            torch.zeros(0, dtype=torch.float32, device=self.device)
        return state, curve, inflight

    def run_pipelined(self, state: SimState, num_rounds: int, *,
                      inflight=None, generator=None,
                      draws: Optional[Sequence[RoundDraws]] = None,
                      donate: bool = True, start_round=None):
        """Pipelined :meth:`run`: returns ``(final, conv, inflight)``.
        ``inflight=None`` primes the pipeline first (one more draw:
        ``draws`` then holds ``num_rounds + 1``); a chunked caller passes
        the previous chunk's ``inflight``."""
        self._check_horizon(state, num_rounds, start_round)
        return self._run_pipelined(state, num_rounds, True, inflight,
                                   generator, draws, donate)

    def run_fast_pipelined(self, state: SimState, num_rounds: int, *,
                           inflight=None, generator=None,
                           draws: Optional[Sequence[RoundDraws]] = None,
                           donate: bool = True, start_round=None):
        """Pipelined :meth:`run_fast`: returns ``(final, inflight)``."""
        self._check_horizon(state, num_rounds, start_round)
        final, _, inflight = self._run_pipelined(
            state, num_rounds, False, inflight, generator, draws, donate)
        return final, inflight
