"""The node-axis-sharded twin of the exact model — the port of
``sidecar_tpu/parallel/sharded.py`` ``ShardedSim``.

The node axis splits into ``d`` contiguous blocks of ``nl = N / d``
rows.  Shard ``s`` owns rows ``[s·nl, (s+1)·nl)`` of ``known`` and
``sent``: a node's whole row (its replicated catalog) stays with its
shard, and only the round's bounded offers cross shards.  Each round,
as phases over the loop of shards with the shard group's collectives
between them (:meth:`ShardedSim._gossip_shards`):

1. select — each shard's top-``budget`` freshest eligible records
   (``select_messages`` at ``row_offset = r0``, the global tie
   rotation), charged to its ``sent`` rows; on the sparse round on the
   shard's compacted sender rows when they fit its cap;
2. own-shard candidates — the shard's own offers as update triples to
   its own rows, gated (admission, liveness, loss) and resolved against
   the pre-round block;
3. the announce stamps over global slot ids, with the Lifeguard refute;
4. the remote sender blocks, in the mode's order (``board_exchange``):
   ``all_gather`` replicates every offer, ``ring`` passes each block
   ``d − 1`` hops, ``zoned`` ships only the rows the overlay can make
   another shard a target of (``ops/topology.zoned_exchange_plan``,
   push direction; pad rows ship ``msg = 0``).  With ``digest_gate`` a
   zoned hop is skipped when every shard's block is uniform and the
   receiver's and sender's digests agree (decided on the host, one read
   a round);
5. one combined scatter a shard — the hand-written CUDA kernel
   ``scatter_max_apply_kernel`` (K4a) on the shard's row slice
   ``known[r0:r0+nl]``, local row ``nl`` the dropped pad;
6. the TTL sweep on sweep rounds.

Then the anti-entropy: the random-stride ring exchange
(:meth:`ShardedSim._push_pull_stride`) in place of the single-device
model's uniform partner — every node exchanges full rows with node
``(i + stride) mod N``.  A partition is ``cut_mask`` on the sample (as on
one device) and ``node_side``, which keeps the stride exchange within a
side; the pipelined round refuses the sides, as the reference's does.

The shard group (``group=``, ``parallel/mesh.py``) decides where the
rows live.  With the default :class:`LocalShardGroup` every shard is in
this process.  With a :class:`~sidecar_tpu_torch.parallel.dist.
DistShardGroup` of ``world`` ranks the state is RANK-LOCAL: ``known``,
``sent`` and ``node_alive`` hold only the rank's ``dl·nl`` rows
(``init_state`` builds them from the global state; ``convert.
shard_state`` splits a given one).  Then:

* per local shard, as above — select, own-shard candidates, announce,
  the remote blocks of every mode (and the digest gate), one K4a a
  shard and the sweep;
* with collectives — the liveness vector (``gather_rows``, once a
  round, for the sample and the delivery gates), the stride push-pull
  (``shift_rows`` fetches only the partner rows, from at most two ranks
  each way), the convergence metric (an ``all_reduce`` max of each
  rank's per-column truth, the integer agreement counts gathered, the
  float32 mean taken once on the whole vector, so it is the one-process
  value bit for bit), and every host decision: the sparse round's
  per-shard sender counts and the digest gate's skip are gathered
  before they are read, so every rank takes the same branch;
* the telemetry planes — trace, digest and provenance — ride the run
  loop on the rank's rows: the record's counts are each rank's share,
  summed over the group (the freshest belief max-reduced, the liveness
  gathered); provenance gathers its ``[N, T]`` tracked columns and
  folds the whole trace on every rank.  Every rank returns the
  one-process stream;
* the host replica ``gate_predicates`` digests the rank's rows and
  gathers only each shard's first-row digest and uniformity flag;
* the pipelined round is the single-device model's round on the rank's
  rows (:class:`_RankPipeline`): the carry is rank-local, the carried
  offers reach their receivers through the exchange mode's blocks, and
  the uniform push-pull partner's rows are fetched from, and the pushed
  rows max-folded into, whichever rank holds them (``fetch_rows``,
  ``scatter_max_rows``).

Every rank draws the round's global :class:`RoundDraws` (its cost: one
``[N, F, B]`` loss mask a rank) and uses the rows it needs, so the
trajectory is the same at every world size.

Every candidate resolves against the pre-round block and the scatter-
max and the ``sent`` reset commute, so the order in which blocks are
consumed does not matter: with the same peers and loss mask every mode
at every ``d`` ends each round in the same state.

Randomness comes through the ``RoundDraws`` seam: ``peer_slot [N, F]``,
the loss mask ``keep [N, F, B]`` indexed by sender (the loss of message
``(s, f, b)``), and ``stride`` on push-pull rounds.  With the port's
generator the trajectory is the same at every ``d`` and in every mode.
The reference draws per shard (shard ``s`` splits ``fold_in(k_round,
s)`` into its peer and loss keys, and each shard's full ``[N, F, B]``
loss mask decides the messages that target its rows); the tests
rebuild those streams into this shape.

The software-pipelined round is the single-device ``ExactSim``'s, run
by delegation (:meth:`ShardedSim._pipeline_twin`) with that model's
draws, as in the reference: on the global tensors on one rank, on the
rank's rows over several.  The telemetry planes (trace, digest,
provenance) ride the inherited run loop; the reference twin streams no
delta batches, and neither does this one.

``known`` and ``sent`` are updated in place, as by ``ExactSim``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.models import common, planes
from sidecar_tpu_torch.models.exact import (
    I32,
    I64,
    ExactSim,
    SimParams,
    SimState,
)
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import digest as digest_ops
from sidecar_tpu_torch.ops import gossip as gossip_ops
from sidecar_tpu_torch.ops import sparse as sparse_ops
from sidecar_tpu_torch.ops import suspicion as suspicion_ops
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.pipeline import Inflight
from sidecar_tpu_torch.ops.merge import admit_gate, merge_packed, sticky_adjust
from sidecar_tpu_torch.ops.status import (
    TOMBSTONE,
    is_known,
    pack,
    unpack_status,
)
from sidecar_tpu_torch.ops.topology import Topology, zoned_exchange_plan
from sidecar_tpu_torch.parallel.mesh import (
    local_rows,
    resolve_board_exchange,
    resolve_group,
)
from sidecar_tpu_torch.telemetry import cost


@dataclasses.dataclass
class _Shard:
    """One shard's working set, carried through the phases of a round."""

    index: int
    r0: int                  # global id of the shard's row 0
    known: torch.Tensor      # int32 [nl, M] view of the global known …
    sent: torch.Tensor       # … and int8 [nl, M] of sent
    dst: torch.Tensor        # int32 [nl, F] sampled peers (global ids)
    senders: torch.Tensor    # int32 [nl] the global ids of its rows
    svc: Optional[torch.Tensor] = None   # int32 [nl, B] selected slots
    msg: Optional[torch.Tensor] = None   # int32 [nl, B] their values
    groups: list = dataclasses.field(default_factory=list)


class ShardedSim(ExactSim):
    """The exact model over ``d`` node shards (default 1): on one device
    (a :class:`LocalShardGroup`, the default) or over the ranks of
    ``group`` (a ``DistShardGroup`` of ``d`` shards; the state is then
    rank-local, see the module docstring).  Same ``run*`` methods as
    :class:`ExactSim`; ``board_exchange`` (``all_gather``, ``ring``, and
    ``zoned`` on a neighbour-list graph), ``exchange_stub``,
    ``digest_gate`` and ``gate_buckets`` as in the reference.
    ``digest_gate=None`` is off: the port reads no environment
    variable."""

    supports_sparse = True
    # By delegation to the single-device model (see _pipeline_twin).
    supports_pipeline = True

    def __init__(self, params: SimParams, topo: Topology,
                 timecfg: TimeConfig = TimeConfig(), *, d: int = 1,
                 board_exchange: Optional[str] = None,
                 exchange_stub: bool = False, sparse=None,
                 digest_gate: Optional[bool] = None, gate_buckets: int = 8,
                 pipeline=None, tick_period=None, tick_phase=None,
                 device="cuda", cut_mask=None, node_side=None,
                 group=None):
        super().__init__(params, topo, timecfg, device=device,
                         cut_mask=cut_mask, sparse=sparse,
                         pipeline=pipeline, tick_period=tick_period,
                         tick_phase=tick_phase)
        # Each node's side of a partition: the stride push-pull
        # exchanges only within a side.  (The cut gates the sample.)
        self._side = common.side_tensor(node_side, params.n, self.device)
        # The raw cadence arguments, for the pipelined twin.
        self._cadence_args = (tick_period, tick_phase)
        self._pipe_twin = None
        # The dense twin exchanges bounded OFFER tensors, not boards;
        # all_to_all request routing exists only on the compressed twin.
        if board_exchange == "zoned" and topo.nbrs is None:
            raise ValueError(
                "board_exchange='zoned' requires a neighbor-list "
                "topology: the complete graph reaches every shard "
                "(use all_gather there)")
        supported = ("all_gather", "ring")
        if topo.nbrs is not None:
            supported += ("zoned",)
        self.board_exchange = resolve_board_exchange(board_exchange,
                                                     supported=supported)
        # Measurement only: fold own-shard offers alone and skip the
        # exchange.  The trajectory is wrong by construction; the
        # reference uses it to time the exposed exchange.
        self._exchange_stub = exchange_stub
        if d < 1 or params.n % d:
            raise ValueError(f"n={params.n} must divide into d={d} shards")
        self.d = d
        self.group = resolve_group(group, d)
        if self.group.world > 1:
            self._row_group = self.group
        nl = params.n // d
        # The per-shard sparse sender cap: the global cap split over the
        # shards with 2x slack for imbalance.
        self._sparse_cap_shard = min(
            nl, max(16, -(-self._sparse_cap // d) * 2))
        payload_ints = params.fanout + 2 * min(params.budget, params.m)

        self._zoned_plan = None
        self._zoned_tabs = None
        if self.board_exchange == "zoned":
            # Push direction: shard s ships sender row r wherever r has
            # a neighbour on another shard.
            self._zoned_plan = zoned_exchange_plan(topo, d,
                                                   direction="push")
            self._zoned_tabs = tuple(
                None if h is None else (
                    torch.as_tensor(h.rows.astype(np.int64),
                                    device=self.device),
                    torch.as_tensor(h.valid, device=self.device))
                for h in self._zoned_plan.hops)
            metrics.set_gauge("parallel.exchange.zoned_rows",
                              float(self._zoned_plan.total_rows))

        if digest_gate and self.board_exchange != "zoned":
            raise ValueError(
                "digest_gate composes with board_exchange='zoned' "
                f"only (got {self.board_exchange!r}): all_gather and "
                "ring ship whole blocks a digest cannot split")
        self.digest_gate = bool(digest_gate)
        self._gate_buckets = int(gate_buckets)
        self._gate_idents = None
        if self.digest_gate:
            digest_ops.bucket_ids_np(np.zeros(1, np.uint32),
                                     self._gate_buckets)  # validates
            self._gate_idents = planes.digest_idents(None, params.m,
                                                     self.device)

        self.exchange_bytes_per_round = {
            "all_gather": (params.n - nl) * payload_ints * 4,
            "ring": (d - 1) * nl * payload_ints * 4,
            "zoned": (0 if self._zoned_plan is None
                      else self._zoned_plan.total_rows * payload_ints * 4),
        }[self.board_exchange]
        metrics.set_gauge("parallel.exchange.bytes",
                          float(self.exchange_bytes_per_round))

    # -- draws ----------------------------------------------------------------

    def draw(self, generator: torch.Generator, round_idx: int) -> RoundDraws:
        """The randomness of the round that advances the state to
        ``round_idx``: peers, the ``[N, F, B]`` keep mask when loss is
        on, and the stride on a push-pull round."""
        p, kn = self.p, self._knobs
        return gossip_ops.draw_round(
            generator, p.n, p.fanout, deg=self._deg,
            push_pull=round_idx % kn.push_pull_rounds == 0,
            keep_prob=kn.keep_prob, keep_width=min(p.budget, p.m))

    # -- the digest gate -----------------------------------------------------

    def gate_predicates(self, state: SimState) -> np.ndarray:
        """Host replica of the digest gate's skip predicate, in numpy:
        bool ``[d - 1]``, entry ``h - 1`` True iff zoned hop ``h`` would
        be skipped on the next round (every shard internally uniform and
        every receiver/sender pair digest-equal).  Each rank digests its
        own rows; only each shard's first-row digest and whether it is
        internally uniform are gathered, so every rank returns the same
        vector."""
        if not self.digest_gate:
            raise ValueError("gate_predicates requires digest_gate=True")
        g = self.group
        known = state.known.cpu().numpy()
        dig = digest_ops.node_digests_np(
            known, digest_ops.default_idents(self.p.m), self._gate_buckets)
        nl = self.p.n // self.d
        blocks = [dig[j * nl:(j + 1) * nl] for j in range(g.dl)]
        uniform = g.gather_rows(torch.tensor(
            [bool((b == b[:1]).all()) for b in blocks], device=self.device))
        first = g.gather_rows(torch.as_tensor(
            np.stack([b[0] for b in blocks]).astype(np.int64),
            device=self.device)).cpu().numpy()
        uniform = bool(uniform.all())
        return np.array([uniform and bool(
            (first == np.roll(first, -h, axis=0)).all())
            for h in range(1, self.d)], dtype=bool)

    def _gate_skips(self, shards, live) -> set:
        """The zoned hops of ``live`` the digest gate skips this round,
        from the pre-round blocks of every shard (each rank's gathered):
        one host read."""
        if not live:
            return set()
        g = self.group
        digs = [digest_ops.node_digests(x.known, self._gate_idents,
                                        self._gate_buckets) for x in shards]
        uniform = g.gather_rows(
            torch.stack([(dg == dg[:1]).all() for dg in digs])).all()
        first = g.gather_rows(torch.stack([dg[0] for dg in digs]))
        # first: [d, gb, 2]
        agree = torch.stack([
            uniform & (first == torch.roll(first, -h, 0)).all()
            for h in live]).tolist()
        return {h for h, a in zip(live, agree) if a}

    # -- the shard body -------------------------------------------------------

    def _select(self, x: _Shard, sender=None):
        """Phase 1: shard ``x``'s offers and their charge.  ``sender``
        (bool ``[nl]``, the shard's eligible senders, within its cap)
        selects on the compacted rows; None is the dense select."""
        p, kn = self.p, self._knobs
        if sender is None:
            x.svc, x.msg = gossip_ops.select_messages(
                x.known, x.sent, p.budget, kn.limit, row_offset=x.r0)
            gossip_ops.record_transmissions(x.sent, x.svc, x.msg, p.fanout)
            return
        idx_s, row_s, valid_s, pos_s = sparse_ops.compact_rows(
            sender, self._sparse_cap_shard)
        rs = row_s.to(I64)
        kn_s = torch.where(valid_s[:, None], x.known[rs], 0)
        svc_c, msg_c = gossip_ops.select_messages(
            kn_s, x.sent[rs], p.budget, kn.limit, row_ids=idx_s + x.r0)
        gossip_ops.record_transmissions(x.sent, svc_c, msg_c, p.fanout,
                                        row_ids=idx_s)
        snd = sender[:, None]
        pos = pos_s.to(I64)
        x.svc = torch.where(snd, svc_c[pos], p.m)
        x.msg = torch.where(snd, msg_c[pos], 0)

    def _block_candidates(self, x: _Shard, dst_b, svc_b, msg_b, senders,
                          alive, now: int, keep_b):
        """Update triples ``(rows, cols, vals, advanced)`` of one sender
        block's offers to shard ``x``'s rows, localized (a target on
        another shard gets local row ``nl``, which the scatter drops) and
        resolved against the pre-round block."""
        p, kn = self.p, self._knobs
        nl = x.known.shape[0]
        bn, fanout = dst_b.shape
        shape = (bn, fanout, svc_b.shape[1])
        val = msg_b[:, None, :].expand(shape)
        tgt = dst_b[:, :, None].expand(shape)
        svc = svc_b[:, None, :].expand(shape)
        tb = kn.budget_arg()
        b_own = None
        if tb is not None:
            # Sender-owned slots are exempt from the per-origin budget;
            # the no-offer column M maps to owner N, never a sender.
            b_own = torch.div(svc, p.services_per_node,
                              rounding_mode="floor") == senders[:, None, None]
        val = admit_gate(val, now, kn.stale_ticks, kn.future_arg(), tb,
                         b_own)
        val = torch.where(alive[senders.to(I64)][:, None, None], val, 0)
        val = torch.where(alive[tgt.to(I64)], val, 0)
        if keep_b is not None:
            val = torch.where(keep_b, val, 0)
        tgt_local = (tgt - x.r0).reshape(-1)
        cols = svc.reshape(-1)
        val = val.reshape(-1)
        local = (tgt_local >= 0) & (tgt_local < nl)
        val = torch.where(local, val, 0)
        flat = tgt_local.to(I64).clamp(0, nl - 1) * p.m + \
            cols.to(I64).clamp(0, p.m - 1)
        pre = x.known.reshape(-1)[flat]
        advanced = (val > pre) & local
        val = sticky_adjust(val, pre, advanced)
        x.groups.append((torch.where(local, tgt_local, nl), cols, val,
                         advanced))

    @cost.phased("announce")
    def _shard_announce(self, x: _Shard, alive, round_idx: int, now: int):
        """The owners' refresh re-stamps of shard ``x``'s own slots (the
        single-device announce over global slot ids), as local update
        triples."""
        p, t, kn = self.p, self.t, self._knobs
        s = p.services_per_node
        nl = x.known.shape[0]
        dev = x.known.device
        lr = torch.div(torch.arange(nl * s, dtype=I32, device=dev), s,
                       rounding_mode="floor")
        cols = x.r0 * s + torch.arange(nl * s, dtype=I32, device=dev)
        own = x.known.reshape(-1)[lr.to(I64) * p.m + cols.to(I64)]
        st = unpack_status(own)
        present = is_known(own) & alive[(x.r0 + lr).to(I64)]
        due = gossip_ops.refresh_due(
            own, cols, round_idx, refresh_rounds=kn.refresh_rounds,
            round_ticks=t.round_ticks, now=now) & present \
            & (st != TOMBSTONE)
        due, st = suspicion_ops.announce_refute(due, st, present,
                                                kn.suspicion_enabled)
        x.groups.append((torch.where(due, lr, nl), cols,
                         torch.where(due, pack(now, st), 0), due))

    def _remote_blocks(self, shards, alive, keep, now: int,
                       gate: bool = True):
        """Phase 4: the remote sender blocks of every shard, through the
        shard group in the mode's order (``gate=False``: no hop is
        skipped, the digest gate notwithstanding)."""
        p, d, g = self.p, self.d, self.group
        nl = p.n // d
        mode = self.board_exchange
        dev = alive.device

        def keep_rows(senders):
            return None if keep is None else keep[senders.to(I64)]

        if mode == "all_gather":
            with cost.phase("exchange"):
                dst_all = g.all_gather([x.dst for x in shards])
                svc_all = g.all_gather([x.svc for x in shards])
                msg_all = g.all_gather([x.msg for x in shards])
            for x, da, sa, ma in zip(shards, dst_all, svc_all, msg_all):
                # The other N - nl senders, in ring order from the block
                # after this shard's.
                snd = (x.r0 + nl + torch.arange(p.n - nl, dtype=I32,
                                                device=dev)) % p.n
                si = snd.to(I64)
                self._block_candidates(x, da[si], sa[si], ma[si], snd,
                                       alive, now, keep_rows(snd))
        elif mode == "zoned":
            live = [h for h in range(1, d)
                    if self._zoned_tabs[h - 1] is not None]
            skip = self._gate_skips(shards, live) \
                if self.digest_gate and gate else set()
            for h in live:
                if h in skip:
                    continue
                zrows, zvalid = self._zoned_tabs[h - 1]
                perm = [(i, (i - h) % d) for i in range(d)]
                with cost.phase("exchange"):
                    got = [g.ppermute(b, perm) for b in (
                        [x.dst[zrows[x.index]] for x in shards],
                        [x.svc[zrows[x.index]] for x in shards],
                        [torch.where(zvalid[x.index][:, None],
                                     x.msg[zrows[x.index]], 0)
                         for x in shards])]
                for x, bd, bs, bm in zip(shards, *got):
                    ss = (x.index + h) % d                  # sender shard
                    snd = (ss * nl + zrows[ss]).to(I32)
                    self._block_candidates(x, bd, bs, bm, snd, alive, now,
                                           keep_rows(snd))
        else:  # ring: d - 1 hops pass each block to shard (s - 1) mod d
            perm = [(i, (i - 1) % d) for i in range(d)]
            cur = ([x.dst for x in shards], [x.svc for x in shards],
                   [x.msg for x in shards])
            for h in range(1, d):
                with cost.phase("exchange"):
                    cur = tuple(g.ppermute(b, perm) for b in cur)
                for x, bd, bs, bm in zip(shards, *cur):
                    snd = (x.index + h) % d * nl + torch.arange(
                        nl, dtype=I32, device=dev)
                    self._block_candidates(x, bd, bs, bm, snd, alive, now,
                                           keep_rows(snd))

    def _open_shards(self, known, sent, dst) -> list:
        """This rank's shards over its rows of ``known``, ``sent`` and
        the sampled peers ``dst``."""
        nl = self.p.n // self.d
        dev = known.device
        return [_Shard(index=s, r0=s * nl,
                       known=known[j * nl:(j + 1) * nl],
                       sent=sent[j * nl:(j + 1) * nl],
                       dst=dst[j * nl:(j + 1) * nl],
                       senders=s * nl + torch.arange(nl, dtype=I32,
                                                     device=dev))
                for j, s in enumerate(self.group.local)]

    def _gossip_shards(self, known, sent, alive, dst, keep, round_idx: int,
                       now: int, sparse: bool):
        """Phases 1-6 of the round over the loop of this rank's shards,
        in place: ``known`` and ``sent`` are its rows, ``alive``, ``dst``
        and ``keep`` global.  Returns the sparse stats ``(ran sparse,
        overflowed, senders)`` as host ints on a sparse round, else
        None."""
        p, kn, d, g = self.p, self._knobs, self.d, self.group
        nl = p.n // d
        shards = self._open_shards(known, sent, dst[local_rows(g, p.n)])

        # 1. Select and charge; on the sparse round each shard compacts
        # its eligible senders unless they overflow its cap, reading the
        # d frontier sizes (every rank's, gathered) once.
        stats = None
        senders = [None] * len(shards)
        if sparse:
            elig = [gossip_ops.eligible_records(x.known, x.sent,
                                                kn.limit).any(dim=1)
                    for x in shards]
            sizes = g.gather_rows(torch.stack([e.sum() for e in elig]))
            sizes = sizes.tolist()
            over = [c > self._sparse_cap_shard for c in sizes]
            senders = [None if over[x.index] else e
                       for x, e in zip(shards, elig)]
            ov = int(any(over))
            stats = (1 - ov, ov, sum(sizes))
        for x, sender in zip(shards, senders):
            self._select(x, sender)

        # 2-3. Own-shard candidates and the announce stamps.
        for x in shards:
            self._block_candidates(
                x, x.dst, x.svc, x.msg, x.senders, alive, now,
                None if keep is None else keep[x.r0:x.r0 + nl])
            self._shard_announce(x, alive, round_idx, now)

        # 4. The remote blocks.
        if d > 1 and not self._exchange_stub:
            self._remote_blocks(shards, alive, keep, now)

        # 5-6. One combined scatter a shard, then the sweep.
        for x in shards:
            rows, cols, vals, adv = (torch.cat(c) for c in zip(*x.groups))
            gossip_ops.apply_updates(x.known, x.sent, rows, cols, vals, adv)
            if round_idx % kn.sweep_rounds == 0:
                self._sweep(x.known, x.sent, now)
        return stats

    # -- the stride anti-entropy ---------------------------------------------

    @cost.phased("exchange", tag="push_pull")
    def _push_pull_stride(self, known, sent, alive, stride: int, now: int):
        """Two-way full-row exchange with the node ``stride`` positions
        away on the ring, written back in place into this rank's rows
        (``alive`` is global): pull the forward partner's row through the
        merge gates, and take the backward partner's admitted row,
        sticky-adjusted against the pre-exchange row; ``sent`` resets
        where the row moved.  The partner rows come through the group's
        ``shift_rows``."""
        p, kn, g = self.p, self._knobs, self.group
        tb, ft = kn.budget_arg(), kn.future_arg()
        rows = local_rows(g, p.n)
        own_pull = own_push = None
        if tb is not None:
            # The pulled row's origin is the forward partner; the
            # offered row's origin is the offering (backward) partner.
            node_ids = torch.arange(rows.start, rows.stop, dtype=I32,
                                    device=known.device)
            own_pull = self.owner[None, :] == \
                ((node_ids + stride) % p.n)[:, None]
            own_push = self.owner[None, :] == \
                ((node_ids - stride) % p.n)[:, None]
        ok = common.exchange_ok(alive, self._side, -stride)[rows]
        fwd = torch.where(ok[:, None], g.shift_rows(known, stride), 0)
        pulled = merge_packed(known, fwd, now, kn.stale_ticks, ft, tb,
                              own_pull)
        del fwd
        offered = admit_gate(g.shift_rows(known, -stride), now,
                             kn.stale_ticks, ft, tb, own_push)
        ok_back = common.exchange_ok(alive, self._side, stride)[rows]
        back = torch.where(ok_back[:, None], offered, 0)
        del offered
        back = sticky_adjust(back, known, back > known)
        merged = torch.maximum(pulled, back)
        sent.masked_fill_(merged != known, 0)
        known.copy_(merged)

    # -- the round ------------------------------------------------------------

    def _round(self, state: SimState, draws: RoundDraws, sparse: bool):
        round_idx = state.round_idx + 1
        now = round_idx * self.t.round_ticks
        alive = self.group.gather_rows(state.node_alive)
        dst = self._sample(alive, draws, round_idx)
        stats = self._gossip_shards(state.known, state.sent, alive, dst,
                                    self._keep(draws), round_idx, now,
                                    sparse)
        if round_idx % self._knobs.push_pull_rounds == 0:
            self._push_pull_stride(state.known, state.sent, alive,
                                   int(draws.stride), now)
        return dataclasses.replace(state, round_idx=round_idx), stats

    # -- the rank-local state and metric --------------------------------------

    def init_state(self, live_fraction: float = 1.0,
                   seed: int = 0) -> SimState:
        """:meth:`ExactSim.init_state`'s cold start, this rank's rows of
        it."""
        state = super().init_state(live_fraction, seed)
        if self.group.world == 1:
            return state
        rows = local_rows(self.group, self.p.n)
        return dataclasses.replace(
            state, known=state.known[rows].clone(),
            sent=state.sent[rows].clone(),
            node_alive=state.node_alive[rows].clone())

    def convergence(self, state: SimState) -> torch.Tensor:
        """:meth:`ExactSim.convergence` over every rank's rows: the
        per-column truth is an all-reduce max of each rank's, each
        node's integer agreement count is gathered, and the float32
        mean runs once on the whole vector."""
        g = self.group
        alive = state.node_alive
        truth = g.all_reduce_max(
            torch.where(alive[:, None], state.known, 0).amax(dim=0))
        agree = (state.known == truth[None, :]).sum(dim=1, dtype=I32)
        return common.alive_mean(g.gather_rows(agree), self.p.m,
                                 g.gather_rows(alive))

    def _step(self, state: SimState, draws: RoundDraws) -> SimState:
        """One dense round from this round's draws, in place: the shard
        loop (with the sweep), then the stride push-pull."""
        return self._round(state, draws, False)[0]

    def _step_sparse(self, state: SimState, draws: RoundDraws):
        """One round on the sparse path, in place: each shard selects on
        its compacted senders where they fit its cap, else densely —
        equal either way.  Returns ``(state, (ran sparse, overflowed,
        senders))`` as host ints; a round counts sparse only when no
        shard overflowed."""
        return self._round(state, draws, True)

    # -- telemetry ------------------------------------------------------------

    def _prov_belief(self, state: SimState, tracked):
        """Packed ``[N, T]`` belief of the tracked slots, every rank's
        rows gathered."""
        return self.group.gather_rows(super()._prov_belief(state, tracked))

    def _prov_channels(self, state: SimState, draws: RoundDraws):
        """The round's channels, given the post-round ``state``: the
        pushes to the sampled peers, and the two stride partners ``(i ±
        stride) mod N`` as pulls, each where both ends are alive (and on
        one side) on a push-pull round — over every node, on every
        rank."""
        p = self.p
        round_idx = state.round_idx
        alive = self.group.gather_rows(state.node_alive)
        dst = self._sample(alive, draws, round_idx)
        stride = int(draws.stride)
        idx = torch.arange(p.n, dtype=I32, device=alive.device)
        pp_on = round_idx % self._knobs.push_pull_rounds == 0
        pulls = []
        for roll_amt, partner in ((-stride, (idx + stride) % p.n),
                                  (stride, (idx - stride) % p.n)):
            ok = common.exchange_ok(alive, self._side, roll_amt) & pp_on
            pulls.append((partner[:, None], ok[:, None]))
        return [(dst, None)], pulls

    def run_with_deltas(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedSim streams no delta batches: the reference's "
            "node-sharded exact twin has no run_with_deltas")

    # -- the pipelined round, by delegation -----------------------------------

    def _pipeline_dispatch(self, sparse) -> None:
        """Guard a pipelined dispatch: the pipelined program is the
        single-device model's, which composes with neither the
        sparse-frontier round nor the partition sides."""
        if self._resolve_sparse_request(sparse):
            raise ValueError(
                "pipelined execution does not compose with the "
                "sparse-frontier round (the carried publish is dense); "
                "pass sparse='0' or pipeline=False")
        if self._side is not None:
            raise ValueError(
                "pipelined execution does not support node_side: the "
                "single-chip pipelined program draws uniform push-pull "
                "partners, which have no side mask")

    def _pipeline_twin(self) -> ExactSim:
        """The single-device ``ExactSim`` whose pipelined round this twin
        runs, built once: same params, graph, time config, cut and
        cadence, ``pipeline="1"``.  It draws its own draws
        (``ExactSim.draw``).  On one rank it runs on the global tensors;
        over ranks it is :class:`_RankPipeline`, the same round on the
        rank's rows."""
        if self._pipe_twin is None:
            tp, tph = self._cadence_args
            make = ExactSim if self.group.world == 1 else \
                functools.partial(_RankPipeline, self)
            self._pipe_twin = make(
                self.p, self.topo, self.t, device=self.device,
                cut_mask=None if self._cut is None else self._cut.cpu(),
                pipeline="1", tick_period=tp, tick_phase=tph)
        return self._pipe_twin

    def _delegate(self):
        self._resolve_pipeline_request(True)
        self._pipeline_dispatch(False)
        self.last_sparse_stats = None
        return self._pipeline_twin()

    def prime_pipeline(self, state: SimState, *, generator=None,
                       draws: Optional[RoundDraws] = None):
        """Fill the pipeline (the single-device twin's prologue)."""
        return self._delegate().prime_pipeline(state, generator=generator,
                                               draws=draws)

    def step_pipelined(self, state: SimState, inflight, *, generator=None,
                       draws: Optional[RoundDraws] = None):
        """One pipelined tick (the single-device twin's)."""
        return self._delegate().step_pipelined(state, inflight,
                                               generator=generator,
                                               draws=draws)

    def run_pipelined(self, state: SimState, num_rounds: int, *,
                      inflight=None, generator=None,
                      draws: Optional[Sequence[RoundDraws]] = None,
                      donate: bool = True, start_round=None):
        """Pipelined :meth:`run` → ``(final, conv, inflight)``: the
        single-device twin's pipelined rounds on the global tensors."""
        return self._delegate().run_pipelined(
            state, num_rounds, inflight=inflight, generator=generator,
            draws=draws, donate=donate, start_round=start_round)

    def run_fast_pipelined(self, state: SimState, num_rounds: int, *,
                           inflight=None, generator=None,
                           draws: Optional[Sequence[RoundDraws]] = None,
                           donate: bool = True, start_round=None):
        """Pipelined :meth:`run_fast` → ``(final, inflight)``."""
        return self._delegate().run_fast_pipelined(
            state, num_rounds, inflight=inflight, generator=generator,
            draws=draws, donate=donate, start_round=start_round)


class _RankPipeline(ExactSim):
    """The single-device model's pipelined round on one rank's rows of a
    :class:`ShardedSim` over several ranks: the run methods, draws and
    carry order of :class:`ExactSim`, with the phases that read other
    nodes' rows going through the twin's shard group.

    * select — this rank's senders' peers (sampled from the gathered
      liveness) and top-``budget`` records (the global tie rotation),
      charged to its ``sent`` rows; the carry holds them rank-local;
    * deliver — the carried offers become update triples through the
      twin's shard body: each local shard's own offers, the announce,
      and the remote blocks in the twin's exchange mode (no hop gated),
      resolved against the pre-apply rows; one scatter kernel a local
      shard, after the next selection's charge;
    * push-pull with the single-device uniform partner: the partner
      rows are fetched from their ranks (``fetch_rows``) and the pushed
      rows max-folded into theirs (``scatter_max_rows``); the sweep on
      the rank's rows.

    Each phase reads only the pre-round rows its single-device form
    reads, and the scatter-max commutes, so every round ends in the
    single-device model's state."""

    def __init__(self, twin: ShardedSim, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._twin = twin

    def convergence(self, state: SimState) -> torch.Tensor:
        return self._twin.convergence(state)

    def _select_inflight(self, known, sent, node_alive, draws: RoundDraws,
                         round_sel: int):
        p, g = self.p, self._twin.group
        rows = local_rows(g, p.n)
        dst = self._sample(g.gather_rows(node_alive), draws, round_sel)
        svc_idx, msg = gossip_ops.select_messages(
            known, sent, p.budget, self._knobs.limit, row_offset=rows.start)
        gossip_ops.record_transmissions(sent, svc_idx, msg, p.fanout)
        return Inflight(round_sel, (dst[rows], svc_idx, msg), draws)

    def _step_pipelined(self, state: SimState, inflight: Inflight,
                        draws_next: RoundDraws):
        round_idx = state.round_idx + 1
        if inflight.round_idx != round_idx:
            raise ValueError(
                f"the carried publish is round {inflight.round_idx}'s, "
                f"the state's next round is {round_idx}")
        now = round_idx * self.t.round_ticks
        tw, nl = self._twin, self.p.n // self._twin.d
        known, sent = state.known, state.sent
        alive = tw.group.gather_rows(state.node_alive)
        dst, svc_idx, msg = inflight.publish
        keep = self._keep(inflight.draws)
        shards = tw._open_shards(known, sent, dst)
        for j, x in enumerate(shards):
            x.svc = svc_idx[j * nl:(j + 1) * nl]
            x.msg = msg[j * nl:(j + 1) * nl]
            tw._block_candidates(
                x, x.dst, x.svc, x.msg, x.senders, alive, now,
                None if keep is None else keep[x.r0:x.r0 + nl])
            tw._shard_announce(x, alive, round_idx, now)
        if tw.d > 1 and not tw._exchange_stub:
            tw._remote_blocks(shards, alive, keep, now, gate=False)
        nxt = self._select_inflight(known, sent, state.node_alive,
                                    draws_next, round_idx + 1)
        for x in shards:
            rows, cols, vals, adv = (torch.cat(c) for c in zip(*x.groups))
            gossip_ops.apply_updates(x.known, x.sent, rows, cols, vals, adv)
        return self._tail(state, inflight.draws, round_idx, now), nxt

    @cost.phased("exchange", tag="push_pull")
    def _push_pull(self, known, sent, node_alive, pp_slot, now: int):
        """:func:`~sidecar_tpu_torch.ops.gossip.push_pull` with the
        round's sampled partner, on this rank's rows."""
        p, kn, g = self.p, self._knobs, self._twin.group
        rows = local_rows(g, p.n)
        alive = g.gather_rows(node_alive)
        partner = gossip_ops.sample_peers(
            pp_slot.to(known.device, I32), p.n, nbrs=self._nbrs,
            node_alive=alive, cut_mask=self._cut)[:, 0]
        ids = torch.arange(p.n, dtype=I32, device=known.device)
        partner = torch.where(alive & alive[partner.to(I64)], partner,
                              ids)[rows]
        pidx = partner.to(I64)
        tb, ft = kn.budget_arg(), kn.future_arg()
        own_pull = own_push = None
        if tb is not None:
            own_pull = self.owner[None, :] == partner[:, None]
            own_push = self.owner[None, :] == ids[rows][:, None]
        pre_tgt = g.fetch_rows(known, pidx)
        pulled = merge_packed(known, pre_tgt, now, kn.stale_ticks, ft, tb,
                              own_pull)
        offered = admit_gate(known, now, kn.stale_ticks, ft, tb, own_push)
        offered = sticky_adjust(offered, pre_tgt, offered > pre_tgt)
        del pre_tgt
        merged = g.scatter_max_rows(pulled, pidx, offered)
        sent.masked_fill_(merged != known, 0)
        known.copy_(merged)
