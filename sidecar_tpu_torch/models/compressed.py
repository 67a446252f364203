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

Two more forms of the round, chosen per dispatch (``sparse=``,
``pipeline=``; they do not compose):

* the sparse-frontier round (:meth:`CompressedSim._step_sparse`,
  ``ops/sparse.py``) runs publish, pull, merge and announce on the
  compacted rows that can change — senders, receivers that sampled
  one, announcers — and falls back to the dense round when a frontier
  exceeds its cap (``sparse_cap``); it equals the dense round bit for
  bit.  The compacted publish is the publish-only kernel with
  ``row_ids``;
* the software-pipelined round (:meth:`CompressedSim._step_pipelined`,
  ``ops/pipeline.py``) folds round r's carried board while it publishes
  round r+1's from the pre-fold cache (one round stale), through the
  publish-only kernel.

Peer sampling takes the topology's round stagger and the per-node tick
cadence (``tick_period``/``tick_phase``) as delivery gates, and the
partition cut (``cut_mask``); ``node_side`` (int ``[N]``) keeps the
stride push-pull within a side, and the quorum fold is off while a cut
is modelled.  A scenario hook (``perturb``, the contract of
``models/common.apply_perturb``) runs before each round's sample in
every form of the round and returns the new state.

Idiom of the port: plain functions on tensors, a dataclass state, an
explicit device.  The reference's ``lax.cond`` on the round counter
(steps 4 and 5) is a host branch on ``state.round_idx``, a Python int.
The branch on a DEVICE predicate — the deep below-floor free,
``deep_due`` — is a ``torch.where`` (same values, no host sync).  The
sparse round's ``lax.cond`` on frontier overflow is a host branch: it
reads the three frontier sizes once a round, its only sync.  The
behind census picks its path on the host (it reads two device scalars
at each metric sample, where the caller reads the metric anyway).

``.at[].max(mode="drop")`` with a row-``n`` or slot-``m`` sentinel
becomes ``scatter_reduce_(…, "amax")`` into a buffer padded by one
sentinel row or column, sliced off afterwards.

Telemetry: ``run_with_trace``, ``run_with_digest``, ``run_with_deltas``
and ``run_with_provenance`` run the same rounds with a plane of
``models/planes.py`` observing each one, and return ``(final,
stream)``.  The round builds a new state and leaves the old one's
tensors untouched, so the trace plane diffs against the pre-round state
itself, with no copy.  The digest and delta planes read the ``[N, M]``
belief view (``ops/delta.compressed_belief``), a tool of the test and
bridge sizes.  The round's phases carry the reference's cost scopes
(``telemetry/cost.py``), off unless switched on.
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
from sidecar_tpu_torch.ops import kernels as kernel_ops
from sidecar_tpu_torch.ops import knobs as knob_ops
from sidecar_tpu_torch.ops import pipeline as pipeline_ops
from sidecar_tpu_torch.ops import sparse as sparse_ops
from sidecar_tpu_torch.ops import suspicion as suspicion_ops
from sidecar_tpu_torch.ops import trace as trace_ops
from sidecar_tpu_torch.ops.gossip import MASK32, RoundDraws
from sidecar_tpu_torch.ops.pipeline import Inflight
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
from sidecar_tpu_torch.telemetry import cost

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
    sparse_cap: int = 0          # C — width of the sparse round's sender
                                 # and announcer compaction (receivers
                                 # get C·fanout); 0 = auto
                                 # (ops/sparse.default_frontier_cap).  A
                                 # round whose frontier exceeds it runs
                                 # the dense round instead

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
    """Single-device compressed simulator: the dense lockstep round, the
    sparse-frontier round and the software-pipelined round.

    ``sparse`` and ``pipeline`` are the modes (``"auto"``, ``"0"``,
    ``"1"``; None is ``"auto"``) that a dispatch's ``sparse=`` and
    ``pipeline=`` resolve against (``ops/sparse.py``,
    ``ops/pipeline.py``); ``tick_period``/``tick_phase`` the per-node
    tick cadence (ints, or scalar or ``[N]`` sequences)."""

    # Whether this sim runs the sparse-frontier and pipelined rounds.
    supports_sparse = True
    supports_pipeline = True
    # The shard group whose ranks hold the other node rows, or None
    # (this sim holds every row): the telemetry planes reduce through it.
    _row_group = None

    def __init__(self, params: CompressedParams, topo: Topology,
                 timecfg: TimeConfig = TimeConfig(), *,
                 device="cuda", fused_gather: bool = True,
                 perturb=None, cut_mask=None, node_side=None,
                 sparse=None, pipeline=None, tick_period=None,
                 tick_phase=None):
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
        # The scenario hook (common.apply_perturb), the partition cut
        # (gossip sample) and each node's side (the stride push-pull
        # exchanges only within a side).
        self.perturb = perturb
        self._cut = common.cut_tensor(cut_mask, topo, self.device)
        self._side = common.side_tensor(node_side, params.n, self.device)
        self._sparse_mode = sparse_ops.resolve_sparse(sparse)
        self._pipeline_mode = pipeline_ops.resolve_pipeline(pipeline)
        tick_period, tick_phase = common.resolve_cadence(
            tick_period, tick_phase, params.n, self.device)
        self._knobs = knob_ops.from_protocol(
            params, timecfg, recover_rounds=params.recover_rounds,
            tick_period=tick_period, tick_phase=tick_phase)
        self._stagger = common.stagger_tensor(topo, self.device)
        self._stagger_period = int(topo.stagger_period)
        cap = params.sparse_cap or sparse_ops.default_frontier_cap(params.n)
        # (senders, receivers, announcers)
        self._sparse_caps = (min(params.n, cap),
                             min(params.n, cap * params.fanout),
                             min(params.n, cap))
        # The last sparse dispatch's int32 [3] stats (sparse rounds,
        # overflow rounds, frontier high-water mark); None after a dense
        # or pipelined one.
        self.last_sparse_stats = None

    # -- the node rows this sim holds -----------------------------------------
    #
    # The global phases (push-pull, the sweep's census, mint, the behind
    # census) read every node's row.  This model holds them all, so the
    # hooks below are the identity; a rank of the sharded twin's
    # distributed group holds a contiguous range of rows and overrides
    # them with its group's collectives.

    def _rows(self) -> slice:
        """The global node rows this sim's state holds."""
        return slice(0, self.p.n)

    @staticmethod
    def _gather_rows(x):
        """Every holder's rows of ``x``, in node order: the global
        tensor."""
        return x

    @staticmethod
    def _shift_rows(x, k: int):
        """Row ``i`` of the result is global row ``(i + k) mod N``."""
        return torch.roll(x, -k, 0)

    @staticmethod
    def _reduce_max(x):
        """The elementwise max of a holder-local reduction over every
        holder."""
        return x

    @staticmethod
    def _reduce_sum(x):
        """The elementwise sum of a holder-local count over every
        holder."""
        return x

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
        # The slots whose owners are this sim's rows, owners as local
        # row ids.
        rows_held = self._rows()
        owner = torch.div(slots, s, rounding_mode="floor")
        held = (owner >= rows_held.start) & (owner < rows_held.stop)
        slots, owner = slots[held], owner[held] - rows_held.start
        n = rows_held.stop - rows_held.start
        col = slots - (owner + rows_held.start) * s
        val = torch.full(slots.shape, pack(int(now_tick), int(status)),
                         dtype=I32, device=self.device)
        val = torch.where(state.node_alive[owner], val, 0)
        cur = torch.maximum(state.own[owner, col], state.floor[slots])
        val = sticky_adjust(val, cur, val > cur)
        rows = torch.where(val > 0, owner, n)
        own_p = torch.cat([state.own.reshape(-1),
                           torch.zeros(s, dtype=I32, device=self.device)])
        own = _scatter_amax(own_p, rows * s + col, val)[:n * s]
        cs, cv, se, ev = _line_compete(
            state.cache_slot, state.cache_val, state.cache_sent,
            owner, slots, val, p.cache_lines, s, state.floor)
        return dataclasses.replace(
            state, own=own.reshape(n, s), cache_slot=cs, cache_val=cv,
            cache_sent=se,
            evictions=(state.evictions + self._reduce_sum(ev)).to(I32))

    # -- the round's phases -------------------------------------------------

    @cost.phased("publish")
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

    @cost.phased("gather")
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

    @cost.phased("fold")
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

    @cost.phased("announce")
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

    @cost.phased("announce")
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

    @cost.phased("exchange", tag="push_pull")
    def _push_pull_stride(self, state, stride: int, now: int):
        """Anti-entropy: two-way exchange with the node ``stride``
        positions away — each side's full cache (line-aligned, so a
        ``roll`` + elementwise lex-merge) plus its own rows (through the
        owner-offer insert)."""
        p = self.p
        kn = self._knobs
        s = p.services_per_node
        dev = state.own.device
        rows = self._rows()
        alive = self._gather_rows(state.node_alive)
        floor_rs = state.floor.reshape(p.n, s)
        node_ids = torch.arange(rows.start, rows.stop, dtype=I32, device=dev)
        tb = kn.budget_arg()

        cv0, cs0 = state.cache_val, state.cache_slot
        wv, ws = cv0, cs0
        sent = state.cache_sent
        for roll_amt in (-stride, stride):
            # Row i exchanges with node i - roll_amt (mod N).
            partner = (node_ids - roll_amt) % p.n
            ok = common.exchange_ok(alive, self._side, roll_amt)[rows]
            okc = ok[:, None]
            p_slot = self._shift_rows(cs0, -roll_amt)
            p_val = self._shift_rows(cv0, -roll_amt)
            p_val = torch.where(okc & (p_slot >= 0), p_val, 0)
            p_own = None
            if tb is not None:
                p_own = torch.div(p_slot, s, rounding_mode="floor") == \
                    partner[:, None]
            p_val = admit_gate(p_val, now, kn.stale_ticks, kn.future_arg(),
                               tb, p_own)
            p_slot = torch.where(p_val > 0, p_slot, -1)
            p_val = sticky_adjust(p_val, cv0,
                                  (p_slot == cs0) & (p_val > cv0))
            wv, ws = self._lex_max(wv, ws, p_val, p_slot)
            t_val = torch.where(okc, self._shift_rows(state.own, -roll_amt),
                                0)
            t_floor = floor_rs[partner.to(I64)]
            t_val = torch.where(t_val > t_floor, t_val, 0)
            t_val = admit_gate(t_val, now, kn.stale_ticks, kn.future_arg())
            wv, ws, sent, _ = self._insert_own_offers(
                wv, ws, sent, t_val, partner * s)

        changed = (wv != cv0) | (ws != cs0)
        sent = torch.where(changed, 0, sent)
        ev = self._reduce_sum(((cs0 >= 0) & (ws != cs0)).sum())
        return dataclasses.replace(
            state, cache_slot=ws, cache_val=wv, cache_sent=sent,
            evictions=(state.evictions + ev).to(I32))

    def _line_census(self, state):
        """Per-line winner ``(ws, wv)``, its holder count across alive
        nodes and the alive count — column reductions over the node
        axis; the owner counts through ``own`` (its cached copy is
        excluded)."""
        p = self.p
        s = p.services_per_node
        dev = state.own.device
        rows = self._rows()
        occupied = (state.cache_slot >= 0) & state.node_alive[:, None]
        val = torch.where(occupied, state.cache_val, 0)
        wv = self._reduce_max(val.amax(dim=0))                  # [K]
        ws = self._reduce_max(torch.where(
            occupied & (val == wv[None, :]), state.cache_slot,
            -1).amax(dim=0))                                    # [K]

        node = torch.arange(rows.start, rows.stop, dtype=I32,
                            device=dev)[:, None]
        holder = occupied & (state.cache_slot == ws[None, :]) & \
            (state.cache_val == wv[None, :])
        owner_of_ws = torch.where(
            ws >= 0, torch.div(ws, s, rounding_mode="floor"), -1)
        holder = holder & (node != owner_of_ws[None, :])
        count = holder.sum(dim=0, dtype=I32)                    # [K]

        # The owner's own copy counts where this sim holds the owner.
        own_flat = state.own.reshape(-1)
        at = ws.to(I64) - rows.start * s
        held = (ws >= 0) & (at >= 0) & (at < own_flat.numel())
        owner_alive = state.node_alive[
            (owner_of_ws.to(I64) - rows.start).clamp(0, rows.stop
                                                     - rows.start - 1)]
        own_at = own_flat[at.clamp(0, own_flat.numel() - 1)]
        owner_holds = held & owner_alive & (own_at >= wv)
        hits = self._reduce_sum(count + owner_holds.to(I32))
        return ws, wv, hits, self._reduce_sum(
            state.node_alive.sum(dtype=I32))

    @cost.phased("ttl_sweep")
    def _floor_advance_and_sweep(self, state, now: int):
        """Per-line census → floor advance → line free → TTL sweep →
        (when due) the exact below-floor free."""
        p, t = self.p, self.t
        kn = self._knobs
        ws, wv, hits, n_alive = self._line_census(state)
        safe_ws = ws.clamp(min=0).to(I64)
        above = (ws >= 0) & (wv > state.floor[safe_ws])
        caught_up = above & (hits >= n_alive)
        if p.fold_quorum < 1.0 and self._cut is None:
            # Quorum fold (the straggler-tail model): float32 ceiling,
            # as in the reference.  Off while a cut is modelled: a
            # minority side would be handed, through the shared floor,
            # records it could never have received.
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
                               now: int, ann=None):
        """Phases 1 + 2 of the round: publish/pull/merge + announce —
        the dense form, which is also the sparse round's overflow
        fallback.  ``ann`` is the announce's own/floor half when the
        caller has computed it already (the sparse round has)."""
        p = self.p
        kn = self._knobs
        if self.fused_gather:
            with cost.phase("publish"):
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
        if ann is None:
            return self._announce(state, round_idx, now)
        return self._insert_announce(state, ann)

    def _insert_announce(self, state, ann):
        """The announce's cache half: insert the offers of ``ann`` (the
        own/floor half's ``(own, floor, offer_val, base_slot)``)."""
        own1, floor1, offer_val, base_slot = ann
        cv, cs, se, ev = self._insert_own_offers(
            state.cache_val, state.cache_slot, state.cache_sent,
            offer_val, base_slot, reset_on_hold=True)
        return dataclasses.replace(
            state, own=own1, floor=floor1, cache_slot=cs, cache_val=cv,
            cache_sent=se, evictions=(state.evictions + ev).to(I32))

    def _sample(self, state, draws: RoundDraws, round_idx: int):
        """Round ``round_idx``'s gossip targets from its draws, gated by
        the stagger and the tick cadence at that round."""
        return gossip_ops.sample_peers(
            draws.peer_slot.to(self.device, I32), self.p.n,
            nbrs=self._nbrs, node_alive=self._gather_rows(state.node_alive),
            cut_mask=self._cut, **common.gate_kwargs(self, round_idx))

    def _keep(self, draws: RoundDraws):
        """The round's loss mask on this device, or None without loss."""
        return draws.keep.to(self.device) if self._knobs.needs_drop_draw \
            else None

    def _tail(self, state, draws: RoundDraws, round_idx: int, now: int):
        """Phases 3 + 4 — push-pull and the floor sweep on their
        cadences, dense in every form of the round — and the round
        counter."""
        kn = self._knobs
        if round_idx % kn.push_pull_rounds == 0:
            state = self._push_pull_stride(state, int(draws.stride), now)
        if round_idx % kn.sweep_rounds == 0:
            state = self._floor_advance_and_sweep(state, now)
        return dataclasses.replace(state, round_idx=round_idx)

    def _step(self, state: CompressedState,
              draws: RoundDraws) -> CompressedState:
        """One dense lockstep round from this round's draws."""
        round_idx = state.round_idx + 1
        now = round_idx * self.t.round_ticks
        state = common.apply_perturb(self.perturb, state, now, self._knobs,
                                     rows=self._rows())
        src = self._sample(state, draws, round_idx)
        state = self._round_gossip_announce(state, src, self._keep(draws),
                                            round_idx, now)
        return self._tail(state, draws, round_idx, now)

    # -- the sparse-frontier round ------------------------------------------

    def _sparse_frontiers(self, state, src, round_idx: int, now: int):
        """The round's three frontiers, and the announce's own/floor
        half that both branches use:

        * senders — rows with an eligible line (occupied, transmits
          left); every other row publishes an empty board;
        * receivers — alive rows that sampled a sender; every other
          row's pull folds only empty boards, a no-op;
        * announcers — rows with a refresh or recovery offer."""
        sender = kernel_ops.eligible_lines(
            state.cache_slot, state.cache_sent, self._knobs.limit).any(dim=1)
        recv = state.node_alive & sender[src.to(I64)].any(dim=1)
        ann = self._announce_offers(state.own, state.floor,
                                    state.node_alive, round_idx, now)
        announcer = (ann[2] > 0).any(dim=1)
        return sender, recv, announcer, ann

    def _round_gossip_announce_sparse(self, st, src, keep, now: int,
                                      sender, recv, announcer, ann):
        """Phases 1 + 2 on the compacted frontiers — equal to
        :meth:`_round_gossip_announce` when no frontier overflows (the
        caller checks).  Every write-back is a gather and a select
        (``compact[pos]`` under the frontier mask)."""
        p = self.p
        kn = self._knobs
        k, s = p.cache_lines, p.services_per_node
        cs_cap, cr_cap, ca_cap = self._sparse_caps
        own1, floor1, offer_val, base_slot = ann
        dev = st.cache_val.device

        # Senders: the compacted board, each row's tie rotation seeded
        # by its global id (pad rows carry id n and publish nothing).
        idx_s, row_s, valid_s, pos_s = sparse_ops.compact_rows(sender,
                                                               cs_cap)
        rs = row_s.to(I64)
        cv_s = torch.where(valid_s[:, None], st.cache_val[rs], 0)
        sl_s = torch.where(valid_s[:, None], st.cache_slot[rs], -1)
        bval_c, bslot_c, sent_c = kernel_ops.publish_board(
            cv_s, sl_s, st.cache_sent[rs], budget=min(p.budget, k),
            limit=kn.limit, fanout=p.fanout, cache_lines=k, row_ids=idx_s)
        sent = torch.where(sender[:, None], sent_c[pos_s.to(I64)],
                           st.cache_sent)
        tb = kn.budget_arg()
        b_own_c = None
        if tb is not None:
            b_own_c = torch.div(bslot_c, s, rounding_mode="floor") == \
                idx_s[:, None]
        bval_c = admit_gate(bval_c, now, kn.stale_ticks, kn.future_arg(),
                            tb, b_own_c)
        # Board row cs_cap is the inactive sender's: all zeros, slots -1.
        bval_p = torch.cat([bval_c, torch.zeros((1, k), dtype=I32,
                                                device=dev)])
        bslot_p = torch.cat([bslot_c, torch.full((1, k), -1, dtype=I32,
                                                 device=dev)])
        bpos = torch.where(sender, pos_s, cs_cap)              # [N]

        # Receivers: pull the compacted boards and fold.
        idx_r, row_r, valid_r, pos_r = sparse_ops.compact_rows(recv,
                                                               cr_cap)
        rr = row_r.to(I64)
        src_r = src[rr].to(I64)                                # [Cr, F]
        b = bpos[src_r].to(I64)
        pv, ps = bval_p[b], bslot_p[b]                         # [Cr, F, K]
        ok = st.node_alive[src_r] & (st.node_alive[rr] & valid_r)[:, None]
        keep_r = None if keep is None else keep[rr]
        cv0_r, cs0_r = st.cache_val[rr], st.cache_slot[rr]
        wv, ws = self._fold_pulled(cv0_r, cs0_r, cv0_r, cs0_r, pv, ps, ok,
                                   now, keep=keep_r, stale_filtered=True)
        changed = (wv != cv0_r) | (ws != cs0_r)
        sent_r = torch.where(changed, 0, sent[rr])
        ev = ((cs0_r >= 0) & (ws != cs0_r)).sum(dtype=I32)
        pr = pos_r.to(I64)
        recv_c = recv[:, None]
        cache_val = torch.where(recv_c, wv[pr], st.cache_val)
        cache_slot = torch.where(recv_c, ws[pr], st.cache_slot)
        cache_sent = torch.where(recv_c, sent_r[pr], sent)

        # Announcers: the cache insert on the compacted rows, after the
        # merge, as in the dense round.
        idx_a, row_a, valid_a, pos_a = sparse_ops.compact_rows(announcer,
                                                               ca_cap)
        ra = row_a.to(I64)
        off_a = torch.where(valid_a[:, None], offer_val[ra], 0)
        cv2, cs2, se2, ev_a = self._insert_own_offers(
            cache_val[ra], cache_slot[ra], cache_sent[ra], off_a,
            base_slot[ra], reset_on_hold=True)
        pa = pos_a.to(I64)
        ann_c = announcer[:, None]
        return dataclasses.replace(
            st, own=own1, floor=floor1,
            cache_slot=torch.where(ann_c, cs2[pa], cache_slot),
            cache_val=torch.where(ann_c, cv2[pa], cache_val),
            cache_sent=torch.where(ann_c, se2[pa], cache_sent),
            evictions=(st.evictions + ev + ev_a).to(I32))

    def _step_sparse(self, state: CompressedState, draws: RoundDraws):
        """One round on the sparse path: the compacted phases where the
        frontiers fit their caps, else the dense round — equal either
        way.  Returns ``(state, (ran sparse, overflowed, frontier
        size))`` as host ints; reading the three frontier sizes is the
        round's one host sync."""
        round_idx = state.round_idx + 1
        now = round_idx * self.t.round_ticks
        state = common.apply_perturb(self.perturb, state, now, self._knobs,
                                     rows=self._rows())
        src = self._sample(state, draws, round_idx)
        keep = self._keep(draws)
        sender, recv, announcer, ann = self._sparse_frontiers(
            state, src, round_idx, now)
        overflow, frontier = self._sparse_overflow(sender, recv, announcer)
        if overflow:
            state = self._round_gossip_announce(state, src, keep, round_idx,
                                                now, ann=ann)
        else:
            state = self._round_gossip_announce_sparse(
                state, src, keep, now, sender, recv, announcer, ann)
        state = self._tail(state, draws, round_idx, now)
        return state, (int(not overflow), int(overflow), frontier)

    def _sparse_overflow(self, sender, recv, announcer):
        """Whether a frontier exceeds its cap, and the largest frontier
        size, from the three sizes read on the host."""
        sizes = torch.stack([sender.sum(), recv.sum(),
                             announcer.sum()]).tolist()
        return (any(c > cap for c, cap in zip(sizes, self._sparse_caps)),
                max(sizes))

    # -- the software-pipelined round ---------------------------------------

    def _select_inflight(self, state, draws: RoundDraws, round_sel: int):
        """Select round ``round_sel``'s publish from the current cache:
        its peers (gated at ``round_sel``, with the current liveness —
        stale by one) and the raw board, through the publish-only
        kernel, with the transmit bump charged at once.  The admission
        gates run at fold time.  Returns ``(inflight, cache_sent)``."""
        src = self._sample(state, draws, round_sel)
        bval, bslot, sent = self._publish(state, self._knobs.limit)
        return Inflight(round_sel, (src, bval, bslot), draws), sent

    def _step_pipelined(self, state, inflight: Inflight,
                        draws_next: RoundDraws):
        """One pipelined tick: fold the carried round-r boards (gated at
        this tick's ``now`` and liveness) while round r+1's publish is
        selected from the pre-fold cache, then announce, push-pull and
        sweep as the lockstep round does.  Round r's loss mask and
        stride come with the carry; ``draws_next`` are round r+1's.
        Returns ``(state, inflight')``."""
        round_idx = state.round_idx + 1
        if inflight.round_idx != round_idx:
            raise ValueError(
                f"the carried publish is round {inflight.round_idx}'s, "
                f"the state's next round is {round_idx}")
        now = round_idx * self.t.round_ticks
        state = common.apply_perturb(self.perturb, state, now, self._knobs,
                                     rows=self._rows())
        src, bval, bslot = inflight.publish
        draws = inflight.draws
        nxt, sent = self._select_inflight(state, draws_next, round_idx + 1)
        state = self._pull_merge(state, sent, bval, bslot, src,
                                 state.node_alive, now,
                                 keep=self._keep(draws))
        state = self._announce(state, round_idx, now)
        return self._tail(state, draws, round_idx, now), nxt

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
        s = p.services_per_node
        rows = self._rows()
        draining = is_known(state.own) & \
            (unpack_status(state.own) == DRAINING)
        draining_f = is_known(state.floor) & \
            (unpack_status(state.floor) == DRAINING)
        draining_c = (state.cache_slot >= 0) & \
            (unpack_status(state.cache_val) == DRAINING)
        bad = self._reduce_max(torch.stack([
            ~state.node_alive.all(), draining.any(),
            draining_c.any()]).any().to(I32))
        fast_ok = (bad == 0) & ~draining_f.any()
        floor_l = state.floor[rows.start * s:rows.stop * s]
        n_if = self._reduce_sum(
            (torch.maximum(floor_l, state.own.reshape(-1)) > floor_l).sum())
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
        _truth, hits, n_alive = _census(state, p, self)
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
        rows = self._rows()
        own_flat = self._gather_rows(state.own).reshape(p.m)
        truth = torch.maximum(state.floor, own_flat)
        in_flight = truth > state.floor
        aux = torch.where(in_flight, truth, 2**31 - 1)
        node = torch.arange(rows.start, rows.stop, dtype=I32,
                            device=dev)[:, None]
        occ = state.cache_slot >= 0
        not_own = torch.where(
            occ, torch.div(state.cache_slot, s, rounding_mode="floor"),
            -1) != node
        at_truth = occ & not_own & (
            state.cache_val
            >= aux[state.cache_slot.clamp(min=0).to(I64)])
        n_inflight = in_flight.sum(dtype=I32)
        sum_hits = self._reduce_sum(at_truth.sum(dtype=I32)) + n_inflight
        return self._fast_behind(n_inflight, sum_hits), self._denom_all(dev)

    def _behind_fast_list(self, state):
        """≤ P slots in flight: enumerate them (``nonzero`` padded to P
        with the sentinel ``m``) and count holders down their line
        columns."""
        p = self.p
        dev = state.own.device
        s = p.services_per_node
        rows = self._rows()
        cap = min(p.metric_inflight_cap, p.m)
        own_flat = self._gather_rows(state.own).reshape(p.m)
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
        node = torch.arange(rows.start, rows.stop, dtype=I64,
                            device=dev)[:, None]
        match = (held_s == slot[None, :]) & (held_v >= t_if[None, :]) & \
            (node != owner[None, :]) & valid[None, :]
        sum_hits = self._reduce_sum(match.sum(dtype=I32)) + n_inflight
        return self._fast_behind(n_inflight, sum_hits), self._denom_all(dev)

    def _fast_behind(self, n_inflight, sum_hits):
        """``float32(n) · float32(#in flight) − float32(hits)``, in
        float32 as the reference computes it."""
        n_f = torch.tensor(self.p.n, dtype=torch.float32,
                           device=n_inflight.device)
        return n_f * n_inflight.to(torch.float32) - \
            sum_hits.to(torch.float32)

    # -- run methods --------------------------------------------------------
    #
    # Every run method takes its draws from ``generator`` (through
    # :meth:`draw`) or from ``draws=``, one per round; ``sparse=`` and
    # ``pipeline=`` resolve against the sim's modes.  ``start_round``, a
    # caller's own round counter, stands in for ``state.round_idx`` in
    # the horizon check, as in the reference's chunked runs.  A run
    # in chunks equals a straight one: the sparse stats add up across
    # chunks, and a pipelined chunk hands its ``inflight`` carry on.

    def _check_horizon(self, state, num_rounds: int, start_round=None):
        if start_round is None:
            start_round = state.round_idx
        self.t.validate_horizon(start_round + num_rounds)

    def _resolve_sparse_request(self, sparse) -> bool:
        return sparse_ops.resolve_request(self._sparse_mode, sparse,
                                          self.supports_sparse)

    def _resolve_pipeline_request(self, pipeline) -> bool:
        return pipeline_ops.resolve_request(self._pipeline_mode, pipeline,
                                            self.supports_pipeline)

    def _pipeline_dispatch(self, sparse) -> None:
        """Guard a pipelined dispatch: the carried board is the dense
        one, so the sparse-frontier round does not compose with it."""
        if self._resolve_sparse_request(sparse):
            raise ValueError(
                "pipelined execution does not compose with the "
                "sparse-frontier round (the carried publish is dense); "
                "pass sparse='0' or pipeline=False")

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
        (d,) = common.round_draws(self, state.round_idx + 1, 1, generator,
                                  common.one_draw(draws))
        return self._step(state, d)

    def step_sparse(self, state: CompressedState, *, generator=None,
                    draws: Optional[RoundDraws] = None):
        """One sparse-path round; returns ``(state, stats)``, stats an
        int32 ``[3]`` tensor (``ops/sparse.py`` layout)."""
        self._resolve_sparse_request(True)
        self._check_horizon(state, 1)
        (d,) = common.round_draws(self, state.round_idx + 1, 1, generator,
                                  common.one_draw(draws))
        state, stats = self._step_sparse(state, d)
        return state, torch.tensor(stats, dtype=I32)

    def _run(self, state, num_rounds: int, every: int, metric, generator,
             draws, sparse: bool, plane=None):
        """``num_rounds`` lockstep (or sparse) rounds, sampling
        ``metric`` every ``every`` rounds (none where ``metric`` is
        None), with ``plane`` (``models/planes.py``) observing each
        round where given; a sparse run leaves its stats in
        ``last_sparse_stats``."""
        if num_rounds % every:
            raise ValueError(
                f"num_rounds={num_rounds} not divisible by every={every}")
        self.last_sparse_stats = None
        acc = [0, 0, 0]
        samples = []
        for i, d in enumerate(common.round_draws(
                self, state.round_idx + 1, num_rounds, generator, draws)):
            pre = None if plane is None else plane.before(state, d)
            st = None
            if sparse:
                state, st = self._step_sparse(state, d)
                acc = [acc[0] + st[0], acc[1] + st[1], max(acc[2], st[2])]
            else:
                state = self._step(state, d)
            if plane is not None:
                plane.after(pre, state, st)
            if metric is not None and (i + 1) % every == 0:
                samples.append(metric(state))
        if sparse:
            self.last_sparse_stats = torch.tensor(acc, dtype=I32)
        curve = torch.stack(samples) if samples else \
            torch.zeros(0, dtype=torch.float32, device=self.device)
        return state, curve

    def run_fast(self, state: CompressedState, num_rounds: int, *,
                 generator=None,
                 draws: Optional[Sequence[RoundDraws]] = None,
                 start_round=None, sparse=None, pipeline=None):
        """Run ``num_rounds`` rounds; returns the final state."""
        if self._resolve_pipeline_request(pipeline):
            self._pipeline_dispatch(sparse)
            return self.run_fast_pipelined(
                state, num_rounds, generator=generator, draws=draws,
                start_round=start_round)[0]
        self._check_horizon(state, num_rounds, start_round)
        return self._run(state, num_rounds, 1, None, generator, draws,
                         self._resolve_sparse_request(sparse))[0]

    def run(self, state: CompressedState, num_rounds: int,
            conv_every: int = 1, *, generator=None,
            draws: Optional[Sequence[RoundDraws]] = None,
            start_round=None, sparse=None, pipeline=None):
        """Run ``num_rounds``, sampling :meth:`convergence` every
        ``conv_every`` rounds; returns ``(final, curve)``."""
        if self._resolve_pipeline_request(pipeline):
            self._pipeline_dispatch(sparse)
            final, conv, _ = self.run_pipelined(
                state, num_rounds, conv_every, generator=generator,
                draws=draws, start_round=start_round)
            return final, conv
        self._check_horizon(state, num_rounds, start_round)
        return self._run(state, num_rounds, conv_every, self.convergence,
                         generator, draws,
                         self._resolve_sparse_request(sparse))

    def run_behind(self, state: CompressedState, num_rounds: int,
                   every: int = 1, *, generator=None,
                   draws: Optional[Sequence[RoundDraws]] = None,
                   start_round=None, sparse=None):
        """Like :meth:`run` but sampling the raw behind COUNT."""
        self._check_horizon(state, num_rounds, start_round)
        return self._run(state, num_rounds, every, self.behind, generator,
                         draws, self._resolve_sparse_request(sparse))

    # -- telemetry planes ---------------------------------------------------

    def _trace_before(self, state: CompressedState):
        """The pre-round state, which the round leaves intact."""
        return state

    def _trace_record(self, prev, nxt: CompressedState, stats):
        """One round's flight-recorder record; ``behind`` goes through
        :meth:`behind`, the twin's census included."""
        p, kn = self.p, self._knobs
        return trace_ops.compressed_record(
            prev, nxt, self.behind(nxt),
            budget=min(p.budget, p.cache_lines), fanout=p.fanout,
            limit=p.resolved_retransmit_limit(), stats=stats,
            tick_period=kn.tick_period, tick_phase=kn.tick_phase,
            group=self._row_group)

    def _delta_belief(self, state: CompressedState):
        """The ``[N, M]`` belief view ``max(floor, cache hit, own)``."""
        return delta_ops.compressed_belief(
            state.own, state.cache_slot, state.cache_val, state.floor,
            self.p.services_per_node, row_offset=self._rows().start)

    def _delta_batch(self, prev, nxt, cap: int):
        """One round's :class:`~sidecar_tpu_torch.ops.delta.DeltaBatch`
        between two belief views; over a row group, every rank's batch
        (rows made global) gathered and merged in node order."""
        batch = delta_ops.extract_delta(prev, nxt, cap)
        g = self._row_group
        if g is None:
            return batch
        node = torch.where(batch.node >= 0,
                           batch.node + self._rows().start, -1)
        got = g.gather_rows(torch.stack([node, batch.slot, batch.val])[None])
        return delta_ops.merge_deltas(g.gather_rows(batch.count.reshape(1)),
                                      got[:, 0], got[:, 1], got[:, 2], cap)

    def _digest_record(self, nxt: CompressedState, idents, buckets: int):
        """One round's coherence record over the belief view."""
        return digest_ops.state_digest_record(
            nxt.round_idx, self._delta_belief(nxt), nxt.node_alive, idents,
            buckets, group=self._row_group)

    def _resolve_digest_idents(self, idents):
        """The caller's identity table, or the sim-slot default."""
        return planes.digest_idents(idents, self.p.m, self.device)

    def _prov_belief(self, state: CompressedState, tracked):
        """Packed ``[N, T]`` belief of the tracked slots: the belief
        view's columns, ``max(floor, cache hit, own row)``, every
        holder's rows gathered."""
        p = self.p
        s = p.services_per_node
        rows = self._rows()
        tr = tracked.to(I64)
        lines = hash_line(tr, p.cache_lines, s).to(I64)
        hit = state.cache_slot[:, lines] == tracked[None, :]
        cached = torch.where(hit, state.cache_val[:, lines], 0)
        owner = torch.div(tr, s, rounding_mode="floor")
        own_b = torch.where(
            owner[None, :] == torch.arange(rows.start, rows.stop, dtype=I64,
                                           device=tr.device)[:, None],
            state.own[:, tr - owner * s], 0)
        return self._gather_rows(torch.maximum(
            torch.maximum(state.floor[tr][None, :], cached), own_b))

    def _prov_channels(self, state: CompressedState, draws: RoundDraws):
        """The round's channels, from its draws as the step resolves
        them, given the post-round ``state`` (its liveness is the one
        the round sampled with, after the hook): the board pulls from
        ``src`` and, on a push-pull round, the stride exchange's two
        legs (the nodes ``stride`` ahead and behind, where both ends are
        alive and on one side).  Every exchange pulls; a floor fold is
        no channel."""
        p = self.p
        round_idx = state.round_idx
        pulls = [(self._sample(state, draws, round_idx), None)]
        if round_idx % self._knobs.push_pull_rounds == 0:
            stride = int(draws.stride)
            alive = self._gather_rows(state.node_alive)
            idx = torch.arange(p.n, dtype=I32, device=alive.device)
            for roll_amt, partner in ((-stride, (idx + stride) % p.n),
                                      (stride, (idx - stride) % p.n)):
                ok = common.exchange_ok(alive, self._side, roll_amt)
                pulls.append((partner[:, None], ok[:, None]))
        return [], pulls

    def _run_plane(self, state, num_rounds: int, make_plane, generator,
                   draws, start_round, sparse):
        self._check_horizon(state, num_rounds, start_round)
        plane = make_plane(state)
        final, _ = self._run(state, num_rounds, 1, None, generator, draws,
                             self._resolve_sparse_request(sparse),
                             plane=plane)
        return final, plane.result

    def run_with_trace(self, state: CompressedState, num_rounds: int, *,
                       cap: int = 0, generator=None,
                       draws: Optional[Sequence[RoundDraws]] = None,
                       start_round=None, sparse=None):
        """:meth:`run_fast` with the flight recorder (``ops/trace.py``):
        returns ``(final, RoundTrace)``; ``cap`` bounds the record
        buffer (0 is every round)."""
        cap = cap or num_rounds
        return self._run_plane(
            state, num_rounds, lambda st: planes.TracePlane(self, cap),
            generator, draws, start_round, sparse)

    def run_with_digest(self, state: CompressedState, num_rounds: int, *,
                        cap: int = 0,
                        buckets: int = digest_ops.DEFAULT_BUCKETS,
                        idents=None, generator=None,
                        draws: Optional[Sequence[RoundDraws]] = None,
                        start_round=None, sparse=None):
        """:meth:`run_fast` with the coherence digest
        (``ops/digest.py``): returns ``(final, DigestTrace)``."""
        cap = cap or num_rounds
        idents = self._resolve_digest_idents(idents)
        return self._run_plane(
            state, num_rounds,
            lambda st: planes.DigestPlane(self, cap, idents, buckets),
            generator, draws, start_round, sparse)

    def run_with_deltas(self, state: CompressedState, num_rounds: int,
                        cap: int, *, generator=None,
                        draws: Optional[Sequence[RoundDraws]] = None,
                        start_round=None, sparse=None):
        """:meth:`run_fast` with each round's changed beliefs
        (``ops/delta.py``): returns ``(final,
        DeltaBatch[num_rounds])``."""
        return self._run_plane(
            state, num_rounds, lambda st: planes.DeltaPlane(self, st, cap),
            generator, draws, start_round, sparse)

    def run_with_provenance(self, state: CompressedState, num_rounds: int,
                            tracked, *, cap: int = 0, prov=None,
                            generator=None,
                            draws: Optional[Sequence[RoundDraws]] = None,
                            start_round=None, sparse=None):
        """:meth:`run_fast` with the provenance tracer of the
        ``tracked`` slots (``ops/provenance.py``): returns ``(final,
        ProvTrace)``; ``prov`` chains a chunked run."""
        tracked = planes.check_tracked(tracked, self.p.m)
        cap = cap or num_rounds
        return self._run_plane(
            state, num_rounds,
            lambda st: planes.ProvPlane(
                self, planes.start_prov(self, st, tracked, cap, prov),
                tracked),
            generator, draws, start_round, sparse)

    # -- pipelined runs -----------------------------------------------------
    #
    # Priming selects round r0+1's publish from the state (one draw);
    # each tick folds round r and selects round r+1 (one draw), so a
    # pipelined run takes the same draws from a generator, in the same
    # order, as a lockstep run — plus the one for the next round's
    # carried publish.

    def prime_pipeline(self, state: CompressedState, *, generator=None,
                       draws: Optional[RoundDraws] = None):
        """Fill the pipeline: select round ``state.round_idx + 1``'s
        publish from the current cache, from that round's draws.
        Returns ``(state, inflight)``."""
        (d,) = common.round_draws(self, state.round_idx + 1, 1, generator,
                                  common.one_draw(draws))
        inflight, sent = self._select_inflight(state, d,
                                               state.round_idx + 1)
        return dataclasses.replace(state, cache_sent=sent), inflight

    def step_pipelined(self, state: CompressedState, inflight: Inflight, *,
                       generator=None, draws: Optional[RoundDraws] = None):
        """One pipelined tick; ``draws`` (or the generator's next draw)
        are the NEXT round's, ``state.round_idx + 2``.  Returns
        ``(state, inflight)``."""
        self._check_horizon(state, 1)
        (d,) = common.round_draws(self, state.round_idx + 2, 1, generator,
                                  common.one_draw(draws))
        return self._step_pipelined(state, inflight, d)

    def _run_pipelined(self, state, num_rounds: int, every: int, metric,
                       inflight, generator, draws):
        self._resolve_pipeline_request(True)
        if num_rounds % every:
            raise ValueError(
                f"num_rounds={num_rounds} not divisible by every={every}")
        self.last_sparse_stats = None
        draws = None if draws is None else list(draws)
        if inflight is None:
            state, inflight = self.prime_pipeline(
                state, generator=generator,
                draws=None if draws is None else draws[0])
            draws = None if draws is None else draws[1:]
        samples = []
        for i, d in enumerate(common.round_draws(
                self, state.round_idx + 2, num_rounds, generator, draws)):
            state, inflight = self._step_pipelined(state, inflight, d)
            if metric is not None and (i + 1) % every == 0:
                samples.append(metric(state))
        curve = torch.stack(samples) if samples else \
            torch.zeros(0, dtype=torch.float32, device=self.device)
        return state, curve, inflight

    def run_pipelined(self, state: CompressedState, num_rounds: int,
                      conv_every: int = 1, *, inflight=None, generator=None,
                      draws: Optional[Sequence[RoundDraws]] = None,
                      start_round=None):
        """Pipelined :meth:`run`: returns ``(final, curve, inflight)``.
        ``inflight=None`` primes the pipeline first (taking one more
        draw: ``draws`` then holds ``num_rounds + 1``); a chunked caller
        passes the previous chunk's ``inflight``."""
        self._check_horizon(state, num_rounds, start_round)
        return self._run_pipelined(state, num_rounds, conv_every,
                                   self.convergence, inflight, generator,
                                   draws)

    def run_fast_pipelined(self, state: CompressedState, num_rounds: int,
                           *, inflight=None, generator=None,
                           draws: Optional[Sequence[RoundDraws]] = None,
                           start_round=None):
        """Pipelined :meth:`run_fast`: returns ``(final, inflight)``."""
        self._check_horizon(state, num_rounds, start_round)
        final, _, inflight = self._run_pipelined(
            state, num_rounds, 1, None, inflight, generator, draws)
        return final, inflight


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


def _census(state: CompressedState, p: CompressedParams, sim):
    """Per-slot truth (freshest belief among alive nodes) and hit count
    (#alive nodes whose belief is at truth).  O(N·K + M).  ``state``
    holds ``sim``'s node rows; their partial truths and counts are
    reduced over every holder (``sim._reduce_max``/``_reduce_sum``)
    before anything is compared with them."""
    s, m, k = p.services_per_node, p.m, p.cache_lines
    dev = state.own.device
    rows = sim._rows()
    lo, hi = rows.start * s, rows.stop * s
    alive = state.node_alive
    n_alive = sim._reduce_sum(alive.sum(dtype=I32))

    own_flat = state.own.reshape(-1)
    owner_alive = torch.repeat_interleave(alive, s)
    own_val = torch.where(owner_alive, own_flat, 0)

    truth = state.floor.clone()
    truth[lo:hi] = torch.maximum(state.floor[lo:hi], own_val)
    cslot = state.cache_slot.reshape(-1)
    cval = state.cache_val.reshape(-1)
    centry_alive = torch.repeat_interleave(alive, k)
    cval = torch.where((cslot >= 0) & centry_alive, cval, 0)
    cidx = torch.where(cslot >= 0, cslot, m).to(I64)
    pad = torch.zeros(1, dtype=I32, device=dev)
    truth = sim._reduce_max(
        _scatter_amax(torch.cat([truth, pad]), cidx, cval)[:m])

    all_know = state.floor >= truth
    node_of_entry = torch.repeat_interleave(
        torch.arange(rows.start, rows.stop, dtype=I32, device=dev), k)
    entry_owner = torch.where(
        cslot >= 0, torch.div(cslot, s, rounding_mode="floor"), -1)
    counts = (cval >= truth[cslot.clamp(min=0).to(I64)]) & (cslot >= 0) \
        & centry_alive & (entry_owner != node_of_entry)
    hits = torch.zeros(m + 1, dtype=I32, device=dev)
    hits.index_add_(0, cidx, counts.to(I32))
    hits = hits[:m]
    hits[lo:hi] += (owner_alive & (own_flat >= truth[lo:hi])).to(I32)
    hits = torch.where(all_know, n_alive, sim._reduce_sum(hits))
    return truth, hits, n_alive
