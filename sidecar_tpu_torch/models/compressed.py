"""The compressed large-cluster gossip model — the port of
``sidecar_tpu/models/compressed.py``'s dense lockstep round on one
device.

State is O(N·K + M): owner-authoritative ``own[N, S]``, each node's
bounded line cache ``cache_{slot,val,sent}[N, K]`` (a slot sits on the
SAME line on every node, :func:`hash_line`), and the shared converged
baseline ``floor[M]``.  One round (:meth:`CompressedSim._step`):

1. sample peers (from the round's :class:`RoundDraws`);
2. publish + pull + merge — the board of each sampled peer, through
   the hand-written CUDA kernel ``fused_publish_gather`` (or, with
   ``fused_gather=False``, ``publish_board`` plus a gather), then an
   elementwise lexicographic max into the cache;
3. announce — staggered owner refreshes and recovery re-offers;
4. push-pull with the node ``stride`` away, every ``push_pull_rounds``;
5. per-line census, floor advance and TTL sweep, every
   ``sweep_rounds``.

Idiom of the port: plain functions on tensors, a dataclass state, an
explicit device.  The reference's ``lax.cond`` on the round counter
(steps 4 and 5) is a host branch on ``state.round_idx``, a Python int.
The branch on a DEVICE predicate — the deep below-floor free,
``deep_due`` — is a ``torch.where`` (same values, no host sync).  The
behind census picks its path on the host (it reads two device scalars
at each metric sample, where the caller reads the metric anyway).

``.at[].max(mode="drop")`` with a row-``n`` or slot-``m`` sentinel
becomes ``scatter_reduce_(…, "amax")`` into a buffer padded by one
sentinel row or column, sliced off afterwards.
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
from sidecar_tpu_torch.ops import kernels as kernel_ops
from sidecar_tpu_torch.ops import knobs as knob_ops
from sidecar_tpu_torch.ops import suspicion as suspicion_ops
from sidecar_tpu_torch.ops.gossip import MASK32, RoundDraws
from sidecar_tpu_torch.ops.merge import (
    admit_gate,
    apply_stickiness,
    budget_mask,
    future_mask,
    sticky_adjust,
)
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    DRAINING,
    TOMBSTONE,
    is_known,
    pack,
    unpack_status,
    unpack_ts,
)
from sidecar_tpu_torch.ops.topology import Topology
from sidecar_tpu_torch.ops.ttl import ttl_sweep

_K1 = 2654435761   # Knuth multiplicative
_K3 = 0xC2B2AE35   # murmur3 finalizer constant

I32, I64 = torch.int32, torch.int64


def hash_line(slot, cache_lines: int, services_per_node: int):
    """Global owner-run hash: slot id → cache line, the SAME line on
    every node — ``line = (H(owner) + col) mod K`` with ``H`` a
    multiplicative mix of the owner id (uint32 arithmetic in int64,
    masked after every multiply)."""
    slot = slot.to(I64)
    owner = torch.div(slot, services_per_node, rounding_mode="floor")
    col = slot - owner * services_per_node
    u = (owner * _K1) & MASK32
    u = ((u ^ (u >> 15)) * _K3) & MASK32
    shift = 32 - int(math.log2(cache_lines))
    base = u >> shift
    return ((base + col) & (cache_lines - 1)).to(I32)


def _scatter_amax(buf, index, values):
    """``buf.at[index].max(values, mode="drop")`` on a 1-D buffer whose
    LAST element is the drop sentinel: returns a new buffer."""
    out = buf.clone()
    out.scatter_reduce_(0, index.to(I64).reshape(-1), values.reshape(-1),
                        "amax", include_self=True)
    return out


@dataclasses.dataclass
class CompressedState:
    """One round's state.  ``round_idx`` is a host int (the round
    counter every cadence branch reads); the counters are 0-d int32
    tensors on the state's device, accumulated without a sync."""

    own: torch.Tensor          # int32 [N, S] owner-authoritative keys
    cache_slot: torch.Tensor   # int32 [N, K] slot id per line (-1 = empty)
    cache_val: torch.Tensor    # int32 [N, K] packed belief
    cache_sent: torch.Tensor   # int8 [N, K] transmit counts
    floor: torch.Tensor        # int32 [M] shared converged baseline
    node_alive: torch.Tensor   # bool [N]
    round_idx: int
    evictions: torch.Tensor    # int32 scalar — live beliefs lost to capacity
    dropped: torch.Tensor      # int32 scalar — always 0 on one device


@dataclasses.dataclass(frozen=True)
class CompressedParams:
    n: int
    services_per_node: int = 10
    cache_lines: int = 256       # K — must be a power of two
    fanout: int = 3
    budget: int = 15
    drop_prob: float = 0.0
    retransmit_limit: int = 0    # 0 = auto (RetransmitMult semantics)
    recover_rounds: int = 10     # unconverged-own re-offer cadence
    fold_quorum: float = 0.995   # census fold threshold (< 1.0 folds the
                                 # straggler tail after a push-pull age)
    deep_sweep_every: int = 1    # every k-th sweep runs the exact
                                 # below-floor line free (0 = never
                                 # periodically; TTL-driven floor moves
                                 # still trigger it)
    metric_inflight_cap: int = 1024
                                 # P — width of the behind metric's
                                 # in-flight slot list (the fastest census
                                 # path); more in flight → the gather path

    def __post_init__(self):
        if self.cache_lines & (self.cache_lines - 1):
            raise ValueError("cache_lines must be a power of two")
        if self.budget > self.cache_lines:
            raise ValueError("budget cannot exceed cache_lines")
        if self.services_per_node > self.cache_lines:
            raise ValueError(
                f"services_per_node={self.services_per_node} cannot "
                f"exceed cache_lines={self.cache_lines}")
        if not 0.0 < self.fold_quorum <= 1.0:
            raise ValueError("fold_quorum must be in (0, 1]")
        if self.deep_sweep_every < 0:
            raise ValueError("deep_sweep_every must be >= 0 (0 = never)")
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


class CompressedSim:
    """Single-device compressed simulator (the dense lockstep round)."""

    def __init__(self, params: CompressedParams, topo: Topology,
                 timecfg: TimeConfig = TimeConfig(), *,
                 device="cuda", fused_gather: bool = True,
                 perturb=None, cut_mask=None, node_side=None,
                 sparse=None, pipeline=None, tick_period=None,
                 tick_phase=None):
        common.reject_deferred(
            topo, perturb=perturb, cut_mask=cut_mask, node_side=node_side,
            sparse=sparse, pipeline=pipeline, tick_period=tick_period,
            tick_phase=tick_phase)
        if topo.n != params.n:
            raise ValueError(
                f"topology has {topo.n} nodes, params say {params.n}")
        self.p = params
        self.t = timecfg
        self.topo = topo
        self.device = common.resolve_device(device, "CompressedSim")
        # Both publish kernels lie on this path: the fused kernel by
        # default, the publish-only kernel plus a gather without it.
        self.fused_gather = bool(fused_gather)
        self._nbrs = None if topo.nbrs is None else \
            torch.as_tensor(np.asarray(topo.nbrs), dtype=I32,
                            device=self.device)
        self._deg = None if topo.deg is None else \
            torch.as_tensor(np.asarray(topo.deg), dtype=I32,
                            device=self.device)
        self._knobs = knob_ops.from_protocol(
            params, timecfg, recover_rounds=params.recover_rounds)

    # -- state construction -------------------------------------------------

    def init_state(self) -> CompressedState:
        """Converged boot state: the whole catalog in the floor at tick
        1, owners holding matching records, caches empty."""
        p, dev = self.p, self.device
        boot = pack(1, ALIVE)
        return CompressedState(
            own=torch.full((p.n, p.services_per_node), boot, dtype=I32,
                           device=dev),
            cache_slot=torch.full((p.n, p.cache_lines), -1, dtype=I32,
                                  device=dev),
            cache_val=torch.zeros((p.n, p.cache_lines), dtype=I32,
                                  device=dev),
            cache_sent=torch.zeros((p.n, p.cache_lines), dtype=torch.int8,
                                   device=dev),
            floor=torch.full((p.m,), boot, dtype=I32, device=dev),
            node_alive=torch.ones((p.n,), dtype=torch.bool, device=dev),
            round_idx=0,
            evictions=torch.zeros((), dtype=I32, device=dev),
            dropped=torch.zeros((), dtype=I32, device=dev),
        )

    def mint(self, state: CompressedState, slots, now_tick: int,
             status: int = ALIVE) -> CompressedState:
        """Inject new record versions at the given global slots: owners
        re-stamp their authoritative copy and seed their cache line,
        with DRAINING stickiness against ``max(own, floor)``."""
        p = self.p
        s = p.services_per_node
        if not isinstance(slots, torch.Tensor):
            slots = torch.as_tensor(np.asarray(slots))
        slots = slots.to(self.device, I64)
        owner = torch.div(slots, s, rounding_mode="floor")
        col = slots - owner * s
        val = torch.full(slots.shape, pack(int(now_tick), int(status)),
                         dtype=I32, device=self.device)
        val = torch.where(state.node_alive[owner], val, 0)
        cur = torch.maximum(state.own[owner, col], state.floor[slots])
        val = sticky_adjust(val, cur, val > cur)
        rows = torch.where(val > 0, owner, p.n)
        own_p = torch.cat([state.own.reshape(-1),
                           torch.zeros(s, dtype=I32, device=self.device)])
        own = _scatter_amax(own_p, rows * s + col, val)[:p.m]
        cs, cv, se, ev = _line_compete(
            state.cache_slot, state.cache_val, state.cache_sent,
            owner, slots, val, p.cache_lines, s, state.floor)
        return dataclasses.replace(
            state, own=own.reshape(p.n, s), cache_slot=cs, cache_val=cv,
            cache_sent=se, evictions=(state.evictions + ev).to(I32))

    # -- the round's phases -------------------------------------------------

    def _publish(self, state: CompressedState, limit: int,
                 row_offset: int = 0):
        """The message board ``(bval, bslot, sent)`` — the publish-only
        kernel on the card, its plain version on the CPU.  ``state`` may
        be a shard's row block; ``row_offset`` is the global id of its
        row 0 (the tie-rotation seed)."""
        p = self.p
        return kernel_ops.publish_board(
            state.cache_val, state.cache_slot, state.cache_sent,
            budget=min(p.budget, p.cache_lines), limit=limit,
            fanout=p.fanout, cache_lines=p.cache_lines,
            row_offset=row_offset)

    @staticmethod
    def _lex_max(wv, ws, cv, cs):
        """Line competition, elementwise: largest val wins, value ties
        break to the larger slot id."""
        adv = (cv > wv) | ((cv == wv) & (cs > ws))
        return torch.where(adv, cv, wv), torch.where(adv, cs, ws)

    def _pull_merge(self, state, sent, bval, bslot, src, alive, now: int,
                    keep=None):
        """Deliver from a materialised board: gate it once (staleness,
        and the future/budget defences when on), gather the sampled
        rows, and fold them into the cache."""
        kn = self._knobs
        tb = kn.budget_arg()
        b_own = None
        if tb is not None:
            rows = torch.arange(bval.shape[0], dtype=I32,
                                device=bval.device)[:, None]
            b_own = torch.div(bslot, self.p.services_per_node,
                              rounding_mode="floor") == rows
        bval = admit_gate(bval, now, kn.stale_ticks, kn.future_arg(), tb,
                          b_own)
        idx = src.to(I64)
        pv, ps = bval[idx], bslot[idx]
        ok = alive[idx] & state.node_alive[:, None]
        return self._merge_pulled(state, sent, pv, ps, ok, now, keep=keep,
                                  stale_filtered=True)

    def _fold_pulled(self, cv0, cs0, wv, ws, pv, ps, ok, now: int,
                     keep=None, stale_filtered=False):
        """Fold pulled candidates ``pv``/``ps`` ([N, F, K]) into the
        running line winners, each resolved against the PRE-round cache
        ``(cv0, cs0)``."""
        kn = self._knobs
        pv = torch.where(ok[:, :, None], pv, 0)
        if keep is not None:
            pv = torch.where(keep, pv, 0)
        if not stale_filtered:
            pv = admit_gate(pv, now, kn.stale_ticks, kn.future_arg())
        ps = torch.where(pv > 0, ps, -1)
        for f in range(pv.shape[1]):
            cand_v, cand_s = pv[:, f], ps[:, f]
            cand_v = sticky_adjust(cand_v, cv0,
                                   (cand_s == cs0) & (cand_v > cv0))
            wv, ws = self._lex_max(wv, ws, cand_v, cand_s)
        return wv, ws

    def _finalize_merge(self, state, sent, wv, ws):
        """Reset transmit counts at changed lines and count live
        evictions, both against the PRE-round cache."""
        cv0, cs0 = state.cache_val, state.cache_slot
        changed = (wv != cv0) | (ws != cs0)
        sent = torch.where(changed, 0, sent)
        evicted = (cs0 >= 0) & (ws != cs0)
        return dataclasses.replace(
            state, cache_slot=ws, cache_val=wv, cache_sent=sent,
            evictions=(state.evictions + evicted.sum()).to(I32))

    def _merge_pulled(self, state, sent, pv, ps, ok, now: int, keep=None,
                      stale_filtered=False):
        """Merge pre-gathered peer board rows into the cache."""
        wv, ws = self._fold_pulled(
            state.cache_val, state.cache_slot, state.cache_val,
            state.cache_slot, pv, ps, ok, now, keep=keep,
            stale_filtered=stale_filtered)
        return self._finalize_merge(state, sent, wv, ws)

    def _insert_own_offers(self, cache_val, cache_slot, cache_sent,
                           offer_val, base_slot, reset_on_hold=False):
        """Insert owner offers: ``offer_val[r, c]`` is offered for slot
        ``base_slot[r] + c`` (one owner's consecutive run per row).
        Under the owner-run layout the run sits on S DISTINCT lines
        ``(H(owner) + c) mod K`` (S ≤ K), so each line receives at most
        one candidate: the reference's [N, K, S] broadcast-compare
        reduction equals a collision-free ``scatter_`` of the S offers
        onto their lines, which is what this does (no [N, K, S]
        temporary).  Candidates are sticky-adjusted against the
        PRE-insert line; ``reset_on_hold`` (the owner's own announce)
        resets the transmit budget of a line that ends up holding the
        offered slot even if nothing changed.  Returns the cache triple
        + evictions."""
        p = self.p
        s, k = p.services_per_node, p.cache_lines
        cv0, cs0 = cache_val, cache_slot
        slots = base_slot.to(I32)[:, None] + \
            torch.arange(s, dtype=I32, device=cv0.device)
        lines = hash_line(slots, k, s).to(I64)                  # [N, S]
        cand_v = torch.zeros_like(cv0).scatter_(1, lines, offer_val)
        cand_s = torch.full_like(cs0, -1).scatter_(1, lines, slots)
        cand_s = torch.where(cand_v > 0, cand_s, -1)
        cand_v = sticky_adjust(cand_v, cv0,
                               (cand_s == cs0) & (cand_v > cv0))
        cache_val, cache_slot = self._lex_max(cv0, cs0, cand_v, cand_s)
        if reset_on_hold:
            holds = (cand_v > 0) & (cand_s == cache_slot)
            cache_sent = torch.where(holds, 0, cache_sent)
        changed = (cache_slot != cs0) | (cache_val != cv0)
        cache_sent = torch.where(changed, 0, cache_sent)
        ev = ((cache_slot != cs0) & (cs0 >= 0)).sum()
        return cache_val, cache_slot, cache_sent, ev

    def _announce_offers(self, own0, floor0, node_alive, round_idx: int,
                         now: int, row_offset: int = 0):
        """Owner refresh (a fresh version of every due, present,
        non-tombstone own record; one the whole cluster already holds
        folds straight into the floor) and recovery re-offers of own
        slots still above the floor.  ``own0``/``node_alive`` may be a
        shard's row block whose row 0 is global node ``row_offset``:
        slot ids and recovery phases are then global, and only the
        block's floor slice is read and rewritten.  Returns ``(own,
        floor, offer_val, base_slot)``."""
        p, t = self.p, self.t
        kn = self._knobs
        s = p.services_per_node
        n = own0.shape[0]
        dev = own0.device
        node = row_offset + torch.arange(n, dtype=I32, device=dev)[:, None]
        lo, hi = row_offset * s, (row_offset + n) * s
        slots = torch.arange(lo, hi, dtype=I32, device=dev).reshape(n, s)
        floor_l = floor0[lo:hi].reshape(n, s)

        st = unpack_status(own0)
        present = is_known(own0) & node_alive[:, None]
        refresh_due = gossip_ops.refresh_due(
            own0, slots, round_idx, refresh_rounds=kn.refresh_rounds,
            round_ticks=t.round_ticks, now=now) & present \
            & (st != TOMBSTONE)
        refresh_due, st = suspicion_ops.announce_refute(
            refresh_due, st, present, kn.suspicion_enabled)
        new_val = pack(now, st)
        fold = refresh_due & (own0 == floor_l)
        own = torch.where(refresh_due, new_val, own0)
        floor_l = torch.where(fold, new_val, floor_l)
        if hi - lo == floor0.shape[0]:
            floor = floor_l.reshape(-1)
        else:
            floor = floor0.clone()
            floor[lo:hi] = floor_l.reshape(-1)

        rphase = node % kn.recover_rounds
        recover_due = ((round_idx % kn.recover_rounds) == rphase) \
            & present & (own > floor_l)
        offer = (refresh_due & ~fold) | recover_due
        offer_val = torch.where(offer, own, 0)
        return own, floor, offer_val, slots[:, 0]

    def _announce(self, state, round_idx: int, now: int,
                  row_offset: int = 0):
        own, floor, offer_val, base_slot = self._announce_offers(
            state.own, state.floor, state.node_alive, round_idx, now,
            row_offset=row_offset)
        cv, cs, se, ev = self._insert_own_offers(
            state.cache_val, state.cache_slot, state.cache_sent,
            offer_val, base_slot, reset_on_hold=True)
        return dataclasses.replace(
            state, own=own, floor=floor, cache_slot=cs, cache_val=cv,
            cache_sent=se, evictions=(state.evictions + ev).to(I32))

    def _push_pull_stride(self, state, stride: int, now: int):
        """Anti-entropy: two-way exchange with the node ``stride``
        positions away — each side's full cache (line-aligned, so a
        ``roll`` + elementwise lex-merge) plus its own rows (through the
        owner-offer insert)."""
        p = self.p
        kn = self._knobs
        s = p.services_per_node
        dev = state.own.device
        alive = state.node_alive
        own_slots = torch.arange(p.m, dtype=I32, device=dev).reshape(p.n, s)
        floor_rs = state.floor.reshape(p.n, s)
        node_ids = torch.arange(p.n, dtype=I32, device=dev)
        tb = kn.budget_arg()

        cv0, cs0 = state.cache_val, state.cache_slot
        wv, ws = cv0, cs0
        sent = state.cache_sent
        for roll_amt in (-stride, stride):
            ok = alive & torch.roll(alive, roll_amt, 0)
            okc = ok[:, None]
            p_slot = torch.roll(cs0, roll_amt, 0)
            p_val = torch.roll(cv0, roll_amt, 0)
            p_val = torch.where(okc & (p_slot >= 0), p_val, 0)
            p_own = None
            if tb is not None:
                p_own = torch.div(p_slot, s, rounding_mode="floor") == \
                    torch.roll(node_ids, roll_amt, 0)[:, None]
            p_val = admit_gate(p_val, now, kn.stale_ticks, kn.future_arg(),
                               tb, p_own)
            p_slot = torch.where(p_val > 0, p_slot, -1)
            p_val = sticky_adjust(p_val, cv0,
                                  (p_slot == cs0) & (p_val > cv0))
            wv, ws = self._lex_max(wv, ws, p_val, p_slot)
            t_slot = torch.roll(own_slots, roll_amt, 0)
            t_val = torch.where(okc, torch.roll(state.own, roll_amt, 0), 0)
            t_floor = torch.roll(floor_rs, roll_amt, 0)
            t_val = torch.where(t_val > t_floor, t_val, 0)
            t_val = admit_gate(t_val, now, kn.stale_ticks, kn.future_arg())
            wv, ws, sent, _ = self._insert_own_offers(
                wv, ws, sent, t_val, t_slot[:, 0])

        changed = (wv != cv0) | (ws != cs0)
        sent = torch.where(changed, 0, sent)
        ev = ((cs0 >= 0) & (ws != cs0)).sum()
        return dataclasses.replace(
            state, cache_slot=ws, cache_val=wv, cache_sent=sent,
            evictions=(state.evictions + ev).to(I32))

    def _line_census(self, state):
        """Per-line winner ``(ws, wv)`` and its holder count across
        alive nodes — column reductions over the node axis; the owner
        counts through ``own`` (its cached copy is excluded)."""
        p = self.p
        s = p.services_per_node
        dev = state.own.device
        occupied = (state.cache_slot >= 0) & state.node_alive[:, None]
        val = torch.where(occupied, state.cache_val, 0)
        wv = val.amax(dim=0)                                    # [K]
        ws = torch.where(occupied & (val == wv[None, :]),
                         state.cache_slot, -1).amax(dim=0)      # [K]

        node = torch.arange(p.n, dtype=I32, device=dev)[:, None]
        holder = occupied & (state.cache_slot == ws[None, :]) & \
            (state.cache_val == wv[None, :])
        owner_of_ws = torch.where(
            ws >= 0, torch.div(ws, s, rounding_mode="floor"), -1)
        holder = holder & (node != owner_of_ws[None, :])
        count = holder.sum(dim=0, dtype=I32)                    # [K]

        own_flat = state.own.reshape(p.m)
        owner_alive = state.node_alive[owner_of_ws.clamp(min=0).to(I64)]
        own_at = own_flat[ws.clamp(min=0).to(I64)]
        owner_holds = (ws >= 0) & owner_alive & (own_at >= wv)
        return ws, wv, count + owner_holds.to(I32)

    def _floor_advance_and_sweep(self, state, now: int):
        """Per-line census → floor advance → line free → TTL sweep →
        (when due) the exact below-floor free."""
        p, t = self.p, self.t
        kn = self._knobs
        ws, wv, hits = self._line_census(state)
        n_alive = state.node_alive.sum(dtype=I32)
        safe_ws = ws.clamp(min=0).to(I64)
        above = (ws >= 0) & (wv > state.floor[safe_ws])
        caught_up = above & (hits >= n_alive)
        if p.fold_quorum < 1.0:
            # Quorum fold (the straggler-tail model): float32 ceiling,
            # as in the reference.
            q_hits = torch.ceil(
                torch.tensor(p.fold_quorum, dtype=torch.float32,
                             device=ws.device)
                * n_alive.to(torch.float32)).to(I32)
            age_ok = now - unpack_ts(wv) >= \
                kn.push_pull_rounds * t.round_ticks
            caught_up = caught_up | (above & (hits >= q_hits) & age_ok)

        fold_idx = torch.where(caught_up, safe_ws, p.m)
        fold_val = torch.where(caught_up, wv, 0)
        floor_p = torch.cat([state.floor,
                             torch.zeros(1, dtype=I32, device=ws.device)])
        floor = _scatter_amax(floor_p, fold_idx, fold_val)[:p.m]
        floor = apply_stickiness(state.floor, floor)

        # Free folded lines (and lines whose winner is at/below the
        # floor) elementwise.
        stale_win = (ws >= 0) & ~above
        below = (state.cache_slot == ws[None, :]) & \
            (caught_up | stale_win)[None, :] & \
            (state.cache_val <= wv[None, :])
        cache_slot = torch.where(below, -1, state.cache_slot)
        cache_val = torch.where(below, 0, state.cache_val)
        cache_sent = torch.where(below, 0, state.cache_sent)

        kw = dict(alive_lifespan=kn.alive_lifespan,
                  draining_lifespan=kn.draining_lifespan,
                  tombstone_lifespan=kn.tombstone_lifespan,
                  one_second=t.one_second,
                  suspicion_window=kn.suspicion_window)
        own, _ = ttl_sweep(state.own, now, **kw)
        floor_swept, _ = ttl_sweep(floor, now, **kw)
        swept_val, _ = ttl_sweep(cache_val, now, **kw)
        cache_sent = torch.where(swept_val != cache_val, 0, cache_sent)

        # Exact below-floor free: due when the sweep moved the floor (a
        # device predicate — selected with torch.where, no sync) or on
        # the periodic deep-sweep cadence (a host branch).
        periodic = False
        if p.deep_sweep_every > 0:
            deep_rounds = kn.sweep_rounds * p.deep_sweep_every
            periodic = (now // t.round_ticks) % deep_rounds == 0
        orphaned = (cache_slot >= 0) & (
            swept_val <= floor_swept[cache_slot.clamp(min=0).to(I64)])
        if not periodic:
            orphaned = orphaned & (floor_swept != floor).any()
        cache_slot = torch.where(orphaned, -1, cache_slot)
        swept_val = torch.where(orphaned, 0, swept_val)
        cache_sent = torch.where(orphaned, 0, cache_sent)

        return dataclasses.replace(
            state, own=own, floor=floor_swept, cache_slot=cache_slot,
            cache_val=swept_val, cache_sent=cache_sent)

    def _round_gossip_announce(self, state, src, keep, round_idx: int,
                               now: int):
        """Phases 1 + 2 of the round: publish/pull/merge + announce."""
        p = self.p
        kn = self._knobs
        if self.fused_gather:
            sent, pv, ps = kernel_ops.fused_publish_gather(
                state.cache_val, state.cache_slot, state.cache_sent,
                src, now, stale_ticks=kn.stale_ticks,
                budget=min(p.budget, p.cache_lines), limit=kn.limit,
                fanout=p.fanout, cache_lines=p.cache_lines)
            ft = kn.future_arg()
            if ft is not None:
                # The kernel gates staleness only; the future bound runs
                # on the gathered candidates (same ``now``).
                pv = torch.where(future_mask(pv, now, ft), 0, pv)
            tb = kn.budget_arg()
            if tb is not None:
                # Per-origin budget, post-kernel: candidate [r, f] is a
                # copy of origin src[r, f]'s board row.
                own3 = torch.div(ps, p.services_per_node,
                                 rounding_mode="floor") == src[:, :, None]
                pv = torch.where(budget_mask(pv, now, tb, own3), 0, pv)
            idx = src.to(I64)
            ok = state.node_alive[idx] & state.node_alive[:, None]
            state = self._merge_pulled(state, sent, pv, ps, ok, now,
                                       keep=keep, stale_filtered=True)
        else:
            bval, bslot, sent = self._publish(state, kn.limit)
            state = self._pull_merge(state, sent, bval, bslot, src,
                                     state.node_alive, now, keep=keep)
        return self._announce(state, round_idx, now)

    def _step(self, state: CompressedState,
              draws: RoundDraws) -> CompressedState:
        """One dense lockstep round from this round's draws."""
        p, t = self.p, self.t
        kn = self._knobs
        round_idx = state.round_idx + 1
        now = round_idx * t.round_ticks
        src = gossip_ops.sample_peers(
            draws.peer_slot.to(self.device, I32), p.n, nbrs=self._nbrs,
            node_alive=state.node_alive)
        keep = None
        if kn.needs_drop_draw:
            keep = draws.keep.to(self.device)
        state = self._round_gossip_announce(state, src, keep, round_idx,
                                            now)
        if round_idx % kn.push_pull_rounds == 0:
            state = self._push_pull_stride(state, int(draws.stride), now)
        if round_idx % kn.sweep_rounds == 0:
            state = self._floor_advance_and_sweep(state, now)
        return dataclasses.replace(state, round_idx=round_idx)

    # -- metrics ------------------------------------------------------------

    def convergence(self, state: CompressedState) -> torch.Tensor:
        """Fraction of (alive node, slot) beliefs agreeing with the
        freshest belief (float32 0-d tensor)."""
        behind, denom = self._behind_and_denom(state)
        return 1.0 - behind / denom

    def behind(self, state: CompressedState) -> torch.Tensor:
        """The raw behind COUNT — #(alive node, slot) beliefs not at the
        freshest version, as a float32 0-d tensor."""
        return self._behind_and_denom(state)[0]

    def census_path(self, state: CompressedState) -> str:
        """Which census :meth:`behind` takes for this state:
        ``"exact"`` (a dead node or a DRAINING record anywhere),
        ``"fast_list"`` (≤ ``metric_inflight_cap`` slots in flight) or
        ``"fast"``.  Reads two device scalars."""
        p = self.p
        draining = is_known(state.own) & \
            (unpack_status(state.own) == DRAINING)
        draining_f = is_known(state.floor) & \
            (unpack_status(state.floor) == DRAINING)
        draining_c = (state.cache_slot >= 0) & \
            (unpack_status(state.cache_val) == DRAINING)
        fast_ok = state.node_alive.all() & ~draining.any() & \
            ~draining_f.any() & ~draining_c.any()
        n_if = (torch.maximum(state.floor, state.own.reshape(p.m))
                > state.floor).sum()
        small = n_if <= min(p.metric_inflight_cap, p.m)
        if not bool(fast_ok):
            return "exact"
        return "fast_list" if bool(small) else "fast"

    def _behind_and_denom(self, state: CompressedState):
        path = self.census_path(state)
        if path == "exact":
            return self._behind_exact(state)
        if path == "fast_list":
            return self._behind_fast_list(state)
        return self._behind_fast(state)

    def _denom_all(self, dev):
        p = self.p
        return torch.clamp(
            torch.tensor(p.n, dtype=torch.float32, device=dev)
            * torch.tensor(p.m, dtype=torch.float32, device=dev), min=1.0)

    def _behind_exact(self, state):
        """The exact per-slot scatter census (:func:`_census`)."""
        p = self.p
        _truth, hits, n_alive = _census(state, p)
        behind = torch.clamp(n_alive - hits, min=0)
        denom = torch.clamp(
            n_alive.to(torch.float32)
            * torch.tensor(p.m, dtype=torch.float32, device=hits.device),
            min=1.0)
        return behind.to(torch.float32).sum(), denom

    def _behind_fast(self, state):
        """Every node alive, nothing DRAINING: truth is ``max(floor,
        own)`` and a slot is in flight iff its owner is ahead of the
        floor; one [N, K] gather counts the cache entries at truth."""
        p = self.p
        dev = state.own.device
        s = p.services_per_node
        own_flat = state.own.reshape(p.m)
        truth = torch.maximum(state.floor, own_flat)
        in_flight = truth > state.floor
        aux = torch.where(in_flight, truth, 2**31 - 1)
        node = torch.arange(p.n, dtype=I32, device=dev)[:, None]
        occ = state.cache_slot >= 0
        not_own = torch.where(
            occ, torch.div(state.cache_slot, s, rounding_mode="floor"),
            -1) != node
        at_truth = occ & not_own & (
            state.cache_val
            >= aux[state.cache_slot.clamp(min=0).to(I64)])
        n_inflight = in_flight.sum(dtype=I32)
        sum_hits = at_truth.sum(dtype=I32) + n_inflight
        return self._fast_behind(n_inflight, sum_hits), self._denom_all(dev)

    def _behind_fast_list(self, state):
        """≤ P slots in flight: enumerate them (``nonzero`` padded to P
        with the sentinel ``m``) and count holders down their line
        columns."""
        p = self.p
        dev = state.own.device
        s = p.services_per_node
        cap = min(p.metric_inflight_cap, p.m)
        own_flat = state.own.reshape(p.m)
        truth = torch.maximum(state.floor, own_flat)
        in_flight = truth > state.floor
        n_inflight = in_flight.sum(dtype=I32)
        nz = torch.nonzero(in_flight).reshape(-1)[:cap]
        idx = torch.full((cap,), p.m, dtype=I64, device=dev)
        idx[:nz.shape[0]] = nz
        valid = idx < p.m
        slot = torch.clamp(idx, max=p.m - 1)
        t_if = truth[slot]                                   # [P]
        lines_if = hash_line(slot, p.cache_lines, s).to(I64)
        held_s = state.cache_slot[:, lines_if]               # [N, P]
        held_v = state.cache_val[:, lines_if]
        owner = torch.div(slot, s, rounding_mode="floor")
        node = torch.arange(p.n, dtype=I64, device=dev)[:, None]
        match = (held_s == slot[None, :]) & (held_v >= t_if[None, :]) & \
            (node != owner[None, :]) & valid[None, :]
        sum_hits = match.sum(dtype=I32) + n_inflight
        return self._fast_behind(n_inflight, sum_hits), self._denom_all(dev)

    def _fast_behind(self, n_inflight, sum_hits):
        """``float32(n) · float32(#in flight) − float32(hits)``, in
        float32 as the reference computes it."""
        n_f = torch.tensor(self.p.n, dtype=torch.float32,
                           device=n_inflight.device)
        return n_f * n_inflight.to(torch.float32) - \
            sum_hits.to(torch.float32)

    # -- drivers ------------------------------------------------------------

    def _check_horizon(self, state, num_rounds: int):
        self.t.validate_horizon(state.round_idx + num_rounds)

    def default_generator(self, seed: int) -> torch.Generator:
        """A ``torch.Generator`` on this sim's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def draw(self, generator: torch.Generator, round_idx: int) -> RoundDraws:
        """Draw the randomness of the round that advances the state to
        ``round_idx`` (its stride only on a push-pull round)."""
        p, kn = self.p, self._knobs
        return gossip_ops.draw_round(
            generator, p.n, p.fanout, deg=self._deg,
            push_pull=round_idx % kn.push_pull_rounds == 0,
            keep_prob=kn.keep_prob, keep_width=p.cache_lines)

    def step(self, state: CompressedState, *, generator=None,
             draws: Optional[RoundDraws] = None) -> CompressedState:
        """One round, from ``draws`` or from ``generator``."""
        self._check_horizon(state, 1)
        seq = None if draws is None else [draws]
        (d,) = list(common.round_draws(self, state, 1, generator, seq))
        return self._step(state, d)

    def run_fast(self, state: CompressedState, num_rounds: int, *,
                 generator=None,
                 draws: Optional[Sequence[RoundDraws]] = None):
        """Run ``num_rounds`` rounds; returns the final state."""
        self._check_horizon(state, num_rounds)
        for d in common.round_draws(self, state, num_rounds, generator,
                                    draws):
            state = self._step(state, d)
        return state

    def _run_sampled(self, state, num_rounds: int, every: int, metric,
                     generator, draws):
        if num_rounds % every:
            raise ValueError(
                f"num_rounds={num_rounds} not divisible by every={every}")
        self._check_horizon(state, num_rounds)
        samples = []
        for i, d in enumerate(common.round_draws(self, state, num_rounds,
                                                 generator, draws)):
            state = self._step(state, d)
            if (i + 1) % every == 0:
                samples.append(metric(state))
        curve = torch.stack(samples) if samples else \
            torch.zeros(0, dtype=torch.float32, device=self.device)
        return state, curve

    def run(self, state: CompressedState, num_rounds: int,
            conv_every: int = 1, *, generator=None,
            draws: Optional[Sequence[RoundDraws]] = None):
        """Run ``num_rounds``, sampling :meth:`convergence` every
        ``conv_every`` rounds; returns ``(final, curve)``."""
        return self._run_sampled(state, num_rounds, conv_every,
                                 self.convergence, generator, draws)

    def run_behind(self, state: CompressedState, num_rounds: int,
                   every: int = 1, *, generator=None,
                   draws: Optional[Sequence[RoundDraws]] = None):
        """Like :meth:`run` but sampling the raw behind COUNT."""
        return self._run_sampled(state, num_rounds, every, self.behind,
                                 generator, draws)


# -- host-path kernels ------------------------------------------------------

def _line_compete(cache_slot, cache_val, cache_sent, rows, slots, vals,
                  cache_lines: int, services_per_node: int, floor):
    """Scatter-based line competition for ``mint``: the largest val wins
    each line (ties to the larger slot id), existing content included;
    entries with val ≤ 0, slot < 0 or val ≤ floor are no-ops.  Returns
    ``(slot, val, sent, evicted-live-count)``."""
    n, k = cache_slot.shape
    dev = cache_slot.device
    rows, slots = rows.to(I64), slots.to(I64)
    valid = (vals > 0) & (slots >= 0)
    valid = valid & (vals > floor[torch.where(valid, slots, 0)])
    line = torch.where(
        valid, hash_line(slots.clamp(min=0), cache_lines,
                         services_per_node).to(I64), k)
    rows = torch.where(valid, rows, n)
    flat = rows * (k + 1) + line       # into the [n+1, k+1] padded buffer

    def padded(x, fill):
        out = torch.full((n + 1, k + 1), fill, dtype=x.dtype, device=dev)
        out[:n, :k] = x
        return out.reshape(-1)

    val1 = _scatter_amax(padded(cache_val, 0), flat, vals)
    got = val1[torch.where(valid, flat, 0)]
    val1 = val1.reshape(n + 1, k + 1)[:n, :k].contiguous()
    won = valid & (vals == got)
    cand_slot = torch.where(won, slots.to(I32), -1)
    slot1 = torch.where(cache_val == val1, cache_slot, -1)
    slot1 = _scatter_amax(padded(slot1, -1), flat, cand_slot)
    slot1 = slot1.reshape(n + 1, k + 1)[:n, :k].contiguous()

    changed = (val1 != cache_val) | (slot1 != cache_slot)
    sent1 = torch.where(changed, 0, cache_sent)
    old_live = (cache_slot >= 0) & \
        (cache_val > floor[cache_slot.clamp(min=0).to(I64)])
    evicted = old_live & (slot1 != cache_slot)
    return slot1, val1, sent1, evicted.sum(dtype=I32)


def _census(state: CompressedState, p: CompressedParams):
    """Per-slot truth (freshest belief among alive nodes) and hit count
    (#alive nodes whose belief is at truth).  O(N·K + M)."""
    s, m, k = p.services_per_node, p.m, p.cache_lines
    dev = state.own.device
    alive = state.node_alive
    n_alive = alive.sum(dtype=I32)

    own_flat = state.own.reshape(m)
    owner_alive = torch.repeat_interleave(alive, s)
    own_val = torch.where(owner_alive, own_flat, 0)

    truth = torch.maximum(state.floor, own_val)
    cslot = state.cache_slot.reshape(-1)
    cval = state.cache_val.reshape(-1)
    centry_alive = torch.repeat_interleave(alive, k)
    cval = torch.where((cslot >= 0) & centry_alive, cval, 0)
    cidx = torch.where(cslot >= 0, cslot, m).to(I64)
    pad = torch.zeros(1, dtype=I32, device=dev)
    truth = _scatter_amax(torch.cat([truth, pad]), cidx, cval)[:m]

    all_know = state.floor >= truth
    node_of_entry = torch.repeat_interleave(
        torch.arange(p.n, dtype=I32, device=dev), k)
    entry_owner = torch.where(
        cslot >= 0, torch.div(cslot, s, rounding_mode="floor"), -1)
    counts = (cval >= truth[cslot.clamp(min=0).to(I64)]) & (cslot >= 0) \
        & centry_alive & (entry_owner != node_of_entry)
    hits = torch.zeros(m + 1, dtype=I32, device=dev)
    hits.index_add_(0, cidx, counts.to(I32))
    hits = hits[:m] + (owner_alive & (own_flat >= truth)).to(I32)
    hits = torch.where(all_know, n_alive, hits)
    return truth, hits, n_alive
