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

The reference's ``lax.cond`` on the round counter (steps 3 and 4) is a
host branch on ``state.round_idx``, a Python int.

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
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import gossip as gossip_ops
from sidecar_tpu_torch.ops import knobs as knob_ops
from sidecar_tpu_torch.ops import suspicion as suspicion_ops
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    TOMBSTONE,
    is_known,
    pack,
    unpack_status,
)
from sidecar_tpu_torch.ops.topology import Topology
from sidecar_tpu_torch.ops.ttl import ttl_sweep

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
    """Single-device exact simulator (the dense lockstep round)."""

    def __init__(self, params: SimParams, topo: Topology,
                 timecfg: TimeConfig = TimeConfig(), *, device="cuda",
                 perturb=None, cut_mask=None, sparse=None, pipeline=None,
                 tick_period=None, tick_phase=None):
        common.reject_deferred(
            topo, perturb=perturb, cut_mask=cut_mask, sparse=sparse,
            pipeline=pipeline, tick_period=tick_period,
            tick_phase=tick_phase)
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
        self._knobs = knob_ops.from_protocol(params, timecfg)
        # owner[m] = node that announces slot m; own_flat[m] = the flat
        # index of the owner's own cell of slot m in known.
        self.owner = torch.div(torch.arange(params.m, dtype=I32, device=dev),
                               params.services_per_node,
                               rounding_mode="floor")
        self._own_flat = self.owner.to(I64) * params.m + \
            torch.arange(params.m, dtype=I64, device=dev)

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

    def _round_deliver_announce(self, known, sent, node_alive, dst, keep,
                                round_idx: int, now: int):
        """Phases 1 + 2: select, charge, deliver, announce, and the one
        combined scatter — ``known`` and ``sent`` updated in place."""
        p, kn = self.p, self._knobs
        svc_idx, msg = gossip_ops.select_messages(known, sent, p.budget,
                                                  kn.limit)
        gossip_ops.record_transmissions(sent, svc_idx, msg, p.fanout)
        tb = kn.budget_arg()
        sender_own = None
        if tb is not None:
            # A node's own records never count against its budget; the
            # padding column M reads slot M-1's owner with msg 0.
            nodes = torch.arange(p.n, dtype=I32, device=known.device)
            sender_own = self.owner[svc_idx.clamp(max=p.m - 1).to(I64)] \
                == nodes[:, None]
        d_rows, d_cols, d_vals, d_adv = gossip_ops.prepare_deliveries(
            known, dst, svc_idx, msg, now_tick=now,
            stale_ticks=kn.stale_ticks, node_alive=node_alive,
            record_keep=keep, future_ticks=kn.future_arg(),
            tomb_budget=tb, sender_own=sender_own)
        a_rows, a_cols, a_vals, a_due = self._announce_updates(
            known, node_alive, round_idx, now)
        gossip_ops.apply_updates(
            known, sent, torch.cat([d_rows, a_rows]),
            torch.cat([d_cols, a_cols]), torch.cat([d_vals, a_vals]),
            torch.cat([d_adv, a_due]))

    def _push_pull(self, known, sent, node_alive, pp_slot, now: int):
        """Anti-entropy with the round's sampled partner, written back
        into ``known`` (and the reset into ``sent``) in place."""
        p, kn = self.p, self._knobs
        partner = gossip_ops.sample_peers(
            pp_slot.to(known.device, I32), p.n, nbrs=self._nbrs,
            node_alive=node_alive)[:, 0]
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

    def _step(self, state: SimState, draws: RoundDraws) -> SimState:
        """One dense lockstep round from this round's draws, updating
        ``state.known`` and ``state.sent`` in place."""
        p, t, kn = self.p, self.t, self._knobs
        round_idx = state.round_idx + 1
        now = round_idx * t.round_ticks
        known, sent, alive = state.known, state.sent, state.node_alive
        dst = gossip_ops.sample_peers(
            draws.peer_slot.to(self.device, I32), p.n, nbrs=self._nbrs,
            node_alive=alive)
        keep = draws.keep.to(self.device) if kn.needs_drop_draw else None
        self._round_deliver_announce(known, sent, alive, dst, keep,
                                     round_idx, now)
        if round_idx % kn.push_pull_rounds == 0:
            if draws.pp_slot is None:
                raise ValueError(f"round {round_idx} runs push-pull and "
                                 "its draws carry no pp_slot")
            self._push_pull(known, sent, alive, draws.pp_slot, now)
        if round_idx % kn.sweep_rounds == 0:
            self._sweep(known, sent, now)
        return dataclasses.replace(state, round_idx=round_idx)

    # -- metrics ------------------------------------------------------------

    def convergence(self, state: SimState) -> torch.Tensor:
        """Fraction of (alive node, slot) cells agreeing with the
        freshest alive belief (float32 0-d tensor; 1.0 = converged)."""
        alive = state.node_alive
        truth = torch.where(alive[:, None], state.known, 0).amax(dim=0)
        agree = state.known == truth[None, :]
        alive_f = alive.to(torch.float32)
        per_node = agree.to(torch.float32).mean(dim=1)
        return (per_node * alive_f).sum() / torch.clamp(alive_f.sum(),
                                                        min=1.0)

    # -- drivers ------------------------------------------------------------

    def _check_horizon(self, state, num_rounds: int):
        self.t.validate_horizon(state.round_idx + num_rounds)

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
        seq = None if draws is None else [draws]
        (d,) = list(common.round_draws(self, state, 1, generator, seq))
        return self._step(clone_state(state), d)

    def run_fast(self, state: SimState, num_rounds: int, *,
                 generator=None,
                 draws: Optional[Sequence[RoundDraws]] = None,
                 donate: bool = True) -> SimState:
        """Run ``num_rounds`` rounds in place (see the module note on
        ``donate``); returns the final state."""
        self._check_horizon(state, num_rounds)
        if not donate:
            state = clone_state(state)
        for d in common.round_draws(self, state, num_rounds, generator,
                                    draws):
            state = self._step(state, d)
        return state

    def run(self, state: SimState, num_rounds: int, *, generator=None,
            draws: Optional[Sequence[RoundDraws]] = None,
            donate: bool = True):
        """Like :meth:`run_fast`, sampling :meth:`convergence` after every
        round; returns ``(final, conv[num_rounds])``."""
        self._check_horizon(state, num_rounds)
        if not donate:
            state = clone_state(state)
        conv = []
        for d in common.round_draws(self, state, num_rounds, generator,
                                    draws):
            state = self._step(state, d)
            conv.append(self.convergence(state))
        curve = torch.stack(conv) if conv else \
            torch.zeros(0, dtype=torch.float32, device=self.device)
        return state, curve
