"""The node-axis-sharded twin of the compressed model — the port of
``sidecar_tpu/parallel/sharded_compressed.py`` ``ShardedCompressedSim``.

The node axis splits into ``d`` contiguous blocks of ``nl = N / d``
rows.  Shard ``s`` owns rows ``[s·nl, (s+1)·nl)``: their own records,
cache lines and board rows, and one replica of the shared floor.  Each
round the shards publish their boards, exchange board rows in one of
four modes (``board_exchange``), pull the rows their nodes sampled, and
re-merge the floor replicas:

* ``all_gather`` — every shard receives the whole ``[N, K]`` board;
* ``all_to_all`` — each shard requests only the rows its nodes sampled,
  bucketed by source shard into a fixed capacity per shard pair
  (``a2a_slack · ceil(nl·F / d)``, at least 16); a request past its
  bucket's capacity is a dropped pull, counted in ``state.dropped``;
* ``ring`` — ``d − 1`` hops pass each shard's block around a ring;
* ``zoned`` — each hop carries only the rows the overlay can make
  another shard sample (``ops/topology.zoned_exchange_plan``).

The state is the single-device :class:`CompressedState`; a shard works
on its row slice of it, and its kernels run on that slice (a contiguous
block, which the kernel wrappers accept).  The round replaces the
single-device gossip-and-announce half with the reference's split-phase
shard body (``_gossip_shard_body``), run as phases over the loop of the
shards this process holds with the shard group's collectives between
them:

1. the ``all_to_all`` request leg (routing is index math only);
2. each shard's board — the publish kernel at ``row_offset = r0`` —
   through the admission gate;
3. the own-shard early fold through the board row gather kernel at
   ``base = r0`` (every mode but ``all_gather``);
4. the announce's own/floor half at ``row_offset = r0``, on the shard's
   floor replica;
5. the exchange and the fold of the remote rows, in the reference's
   fold order;
6. the finalize (transmit resets, evictions) and the owner-offer insert;
7. ``pmax`` of the floor replicas, ``psum`` of evictions and drops.

The push-pull and the sweep then run as the single-device model's
phases over the node rows this process holds (``CompressedSim``'s row
hooks).  The round stagger and the tick cadence gate the sampled peers
on the global node ids, as the reference's sharded round does.

The shard group (``group=``, ``parallel/mesh.py``) decides where the
rows live.  With the default :class:`LocalShardGroup` every shard is in
this process and the row hooks are the identity.  With a
:class:`~sidecar_tpu_torch.parallel.dist.DistShardGroup` of ``world``
ranks the node-major leaves (``own``, ``cache_*``, ``node_alive``) hold
only the rank's rows, while ``floor`` and the counters stay whole on
every rank (``init_state`` builds the rank's state from the global one;
``convert.shard_state`` splits a given one).  Then:

* per local shard — phases 1–6 above, K2 and K3 once a local shard, the
  ``all_to_all`` request buffers of every local shard in one exchange;
* with collectives, where the reference's GSPMD inserts them — the
  liveness vector (gathered once a round), the sparse frontiers (the
  senders gathered, the announce's floor replicas max-reduced, the
  per-shard sizes gathered before the one host read), the stride
  push-pull (the partner rows fetched by ``shift_rows``), the sweep's
  line census (max of the winners, sum of the holder counts, the floor
  advance then the same on every rank), ``mint`` (on the owners' rank),
  the ``behind`` census and ``convergence`` (integer counts reduced
  before the float is taken once), and the counters (``psum``);
* the telemetry planes on the rank's rows: the trace record's counts
  summed over the group (the shared floor counted once), the digest's
  truth max-reduced and its counts summed, the delta batches' changed
  cells gathered with global rows in node order, the provenance
  columns gathered and folded on every rank — every rank returns the
  one-process stream;
* the pipelined round: the publish kernel on the rank's rows selects
  round r+1's carry (rank-local), and the carried boards fold through
  the shard body above — gated at the tick, pulled through the
  exchange mode, the board row gather kernel a local shard;
* a scenario hook (``perturb``) that is ``row_local``: it is called
  with the rank's global row range (``models/common.apply_perturb``)
  and applies its whole-cluster masks to those rows; any other hook
  raises at construction.

With the same peers, the same loss mask and no dropped pull, every mode
at every ``d`` ends each round in the single-device model's state: the
line fold is a max, so the order in which groups of pulled rows fold
does not matter.

The sparse-frontier round (the inherited ``_step_sparse``) takes the
frontiers and the announce's own/floor half over all rows, then one
overflow decision for every shard from the per-shard frontier sizes
against the per-shard caps (:meth:`ShardedCompressedSim.
_sparse_overflow`, one host read): the dense shard body,
or the compacted one — the publish kernel on each shard's compacted
senders with explicit global ids, scattered back to its ``[nl, K]``
block so every exchange mode runs unchanged, and the pulls (the board
row gather kernel), the fold, the finalize and the announce insert on
the compacted receiver and announcer rows.  The software-pipelined round
is the single-device model's, inherited and run on the global tensors
on one rank, as in the reference; over several ranks its fold runs
through the shard body (above), which ends each tick in the same state.

Randomness comes through the ``RoundDraws`` seam as one ``[N, F]``
``peer_slot`` (and ``[N, F, K]`` ``keep``) per round, so with the
port's generator this twin draws exactly what the single-device model
draws, on every rank alike (each uses the rows it needs).  The
reference draws per shard (``fold_in(k_peers, shard)``);
the tests rebuild those streams and feed them in through ``draws=``.
Its pipelined round draws the single-device stream at any world size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.models.compressed import (
    I32,
    I64,
    CompressedParams,
    CompressedSim,
)
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import kernels as kernel_ops
from sidecar_tpu_torch.ops import sparse as sparse_ops
from sidecar_tpu_torch.ops.gossip import RoundDraws
from sidecar_tpu_torch.ops.merge import admit_gate
from sidecar_tpu_torch.ops.pipeline import Inflight
from sidecar_tpu_torch.ops.topology import Topology, zoned_exchange_plan
from sidecar_tpu_torch.telemetry import cost
from sidecar_tpu_torch.parallel.mesh import (
    local_rows,
    resolve_board_exchange,
    resolve_group,
)


def _cat(xs):
    return xs[0] if len(xs) == 1 else torch.cat(xs)


@dataclasses.dataclass(frozen=True)
class A2aRoute:
    """One shard's ``all_to_all`` requests: ``req[d, C]`` local row ids
    per source shard, and per flat request ``[nl·F]`` its source shard
    and row, whether it is served locally, whether it got a bucket
    place (``valid``) and which (``rank``); ``n_dropped`` counts the
    cross-shard requests past their bucket's capacity."""

    req: torch.Tensor
    src_shard: torch.Tensor
    src_row: torch.Tensor
    is_local: torch.Tensor
    valid: torch.Tensor
    rank: torch.Tensor
    n_dropped: torch.Tensor


@dataclasses.dataclass
class _Shard:
    """One shard's working set, carried through the phases of a round."""

    index: int
    r0: int                  # global id of the shard's row 0
    rows: slice              # its rows of the state's tensors
    grows: slice             # its rows of the global tensors
    dst: torch.Tensor        # int32 [nl, F] sampled peers (global ids)
    ok: torch.Tensor         # bool [nl, F] source and receiver alive
    keep: Optional[torch.Tensor]   # bool [nl, F, K] loss mask, or None
    cv0: torch.Tensor        # the pre-round cache lines …
    cs0: torch.Tensor
    wv: torch.Tensor         # … and the running line winners
    ws: torch.Tensor
    src_shard: torch.Tensor  # [nl, F] the peers' shards …
    src_row: torch.Tensor    # … and their rows there
    bval: Optional[torch.Tensor] = None    # gated board block [nl, K]
    bslot: Optional[torch.Tensor] = None
    sent: Optional[torch.Tensor] = None
    route: Optional[A2aRoute] = None
    # The sparse round's compacted receivers: the frontier mask [nl],
    # the rows [Cr] (int64) and the inverse map [nl].  The pull and fold
    # fields above then hold the compacted rows only.
    recv: Optional[torch.Tensor] = None
    rr: Optional[torch.Tensor] = None
    pos_r: Optional[torch.Tensor] = None


class ShardedCompressedSim(CompressedSim):
    """The compressed model over ``d`` node shards (default 1).  Same
    ``run*`` methods as :class:`CompressedSim`, the sparse and pipelined
    rounds included; ``board_exchange`` (default ``all_gather``),
    ``a2a_slack`` and ``exchange_stub`` as in the reference.  The shards
    share one device (a :class:`LocalShardGroup`, the default) or lie on
    the ranks of ``group`` (a ``DistShardGroup`` of ``d`` shards; the
    state is then rank-local, see the module docstring)."""

    def __init__(self, params: CompressedParams, topo: Topology,
                 timecfg: TimeConfig = TimeConfig(), *, d: int = 1,
                 board_exchange: Optional[str] = None, a2a_slack: int = 2,
                 exchange_stub: bool = False, device="cuda",
                 perturb=None, cut_mask=None, node_side=None, sparse=None,
                 pipeline=None, tick_period=None, tick_phase=None,
                 group=None):
        super().__init__(params, topo, timecfg, device=device,
                         fused_gather=False, perturb=perturb,
                         cut_mask=cut_mask, node_side=node_side,
                         sparse=sparse, pipeline=pipeline,
                         tick_period=tick_period, tick_phase=tick_phase)
        if board_exchange == "zoned" and topo.nbrs is None:
            raise ValueError(
                "board_exchange='zoned' requires a neighbor-list "
                "topology: the complete graph reaches every shard "
                "(use all_gather there)")
        supported = ("all_gather", "all_to_all", "ring")
        if topo.nbrs is not None:
            supported += ("zoned",)
        self.board_exchange = resolve_board_exchange(board_exchange,
                                                     supported=supported)
        if a2a_slack < 1:
            raise ValueError("a2a_slack must be >= 1")
        self.a2a_slack = a2a_slack
        # Measurement only: skip the cross-shard exchange and fold only
        # own-shard rows.  The trajectory is wrong by construction; the
        # reference uses it to time the exposed exchange.
        self._exchange_stub = exchange_stub
        if d < 1 or params.n % d:
            raise ValueError(f"n={params.n} must divide into d={d} shards")
        self.d = d
        self.group = resolve_group(group, d)
        if self.group.world > 1:
            self._row_group = self.group
            if perturb is not None and not getattr(perturb, "row_local",
                                                   False):
                raise ValueError(
                    "a scenario hook on a group of "
                    f"{self.group.world} ranks sees a rank's rows: it "
                    "must set row_local and take rows= "
                    "(models/common.apply_perturb)")
        nl = params.n // d
        self._a2a_cap = max(16, -(-nl * params.fanout // d) * a2a_slack)
        # Per-shard sparse frontier caps (senders, receivers,
        # announcers): the global caps split over the shards with 2x
        # slack for imbalance.
        self._sparse_caps_shard = tuple(
            min(nl, max(16, -(-c // d) * 2)) for c in self._sparse_caps)

        self._zoned_plan = None
        self._zoned_tabs = None
        if self.board_exchange == "zoned":
            # Pull direction: boards are pulled by the samplers, so
            # shard s ships row r wherever some node holds r in its
            # neighbour table.
            self._zoned_plan = zoned_exchange_plan(topo, d,
                                                   direction="pull")
            self._zoned_tabs = tuple(
                None if h is None else tuple(
                    torch.as_tensor(a, device=self.device)
                    for a in (h.rows.astype("int64"), h.valid,
                              h.pos.astype("int64")))
                for h in self._zoned_plan.hops)
            metrics.set_gauge("parallel.exchange.zoned_rows",
                              float(self._zoned_plan.total_rows))
        # The host watermark of sync_exchange_metrics.
        self._overflow_synced = 0

        # Per-round, per-shard receive bytes of the board exchange: the
        # int32 bval + bslot payloads each mode moves.
        k, cap = params.cache_lines, self._a2a_cap
        self.exchange_bytes_per_round = {
            "all_gather": (params.n - nl) * k * 4 * 2,
            "all_to_all": d * cap * 4 + 2 * d * cap * k * 4,
            "ring": (d - 1) * nl * k * 4 * 2,
            "zoned": (0 if self._zoned_plan is None
                      else self._zoned_plan.total_rows * k * 4 * 2),
        }[self.board_exchange]
        metrics.set_gauge("parallel.exchange.bytes",
                          float(self.exchange_bytes_per_round))

    def sync_exchange_metrics(self, state) -> int:
        """Publish the cumulative count of ``all_to_all`` pulls dropped
        at a full bucket (``state.dropped``) to the registry as
        ``parallel.exchange.overflow`` and return it.  Reads one device
        scalar, so call it after a run, not between chunks.  The
        watermark is per trajectory: a count below it (a fresh state on
        a reused sim) resets it, so the new trajectory counts from
        zero."""
        dropped = int(state.dropped)
        if dropped < self._overflow_synced:
            self._overflow_synced = 0
        delta = dropped - self._overflow_synced
        if delta > 0:
            metrics.incr("parallel.exchange.overflow", delta)
        self._overflow_synced = dropped
        return dropped

    # -- the rows this rank holds (CompressedSim's row hooks) ---------------

    def _rows(self) -> slice:
        return local_rows(self.group, self.p.n)

    def _gather_rows(self, x):
        return self.group.gather_rows(x)

    def _shift_rows(self, x, k: int):
        return self.group.shift_rows(x, k)

    def _reduce_max(self, x):
        return self.group.all_reduce_max(x)

    def _reduce_sum(self, x):
        return self.group.all_reduce_sum(x)

    def init_state(self) -> "CompressedState":
        """:meth:`CompressedSim.init_state`'s boot state, this rank's
        rows of its node-major leaves."""
        state = super().init_state()
        if self.group.world == 1:
            return state
        rows = self._rows()
        return dataclasses.replace(state, **{
            f: getattr(state, f)[rows].clone() for f in (
                "own", "cache_slot", "cache_val", "cache_sent",
                "node_alive")})

    # -- the pipelined round at more than one rank --------------------------

    def _select_inflight(self, state, draws, round_sel: int):
        """:meth:`CompressedSim._select_inflight`; over ranks, on this
        rank's rows: their peers and their raw board (one publish
        kernel at ``row_offset`` = the rank's first row), the carry
        rank-local."""
        if self.group.world == 1:
            return super()._select_inflight(state, draws, round_sel)
        rows = self._rows()
        src = self._sample(state, draws, round_sel)[rows]
        bval, bslot, sent = self._publish(state, self._knobs.limit,
                                          row_offset=rows.start)
        return Inflight(round_sel, (src, bval, bslot), draws), sent

    def _step_pipelined(self, state, inflight: Inflight,
                        draws_next: RoundDraws):
        """:meth:`CompressedSim._step_pipelined`; over ranks, the carried
        boards fold through the shard body (gated at this tick, pulled
        through the exchange mode, the board row gather kernel a local
        shard), after round r+1's publish was selected from the
        pre-fold cache."""
        if self.group.world == 1:
            return super()._step_pipelined(state, inflight, draws_next)
        round_idx = state.round_idx + 1
        if inflight.round_idx != round_idx:
            raise ValueError(
                f"the carried publish is round {inflight.round_idx}'s, "
                f"the state's next round is {round_idx}")
        now = round_idx * self.t.round_ticks
        state = common.apply_perturb(self.perturb, state, now, self._knobs,
                                     rows=self._rows())
        draws = inflight.draws
        nxt, sent = self._select_inflight(state, draws_next, round_idx + 1)
        state = self._shard_round(state, None, self._keep(draws),
                                  self._gather_rows(state.node_alive),
                                  round_idx, now, None,
                                  carried=(*inflight.publish, sent))
        return self._tail(state, draws, round_idx, now), nxt

    # -- the all_to_all request routing -----------------------------------

    def _a2a_route(self, dst, shard: int, nl: int) -> A2aRoute:
        """Split each sampled peer id into (source shard, source row);
        own-shard rows are served locally, the others are ranked within
        their source shard's bucket by one stable sort and placed in
        ``req`` while the rank is under the capacity ``C``."""
        d, cap = self.d, self._a2a_cap
        dev = dst.device
        flat = dst.reshape(-1).to(I64)                   # [R], R = nl·F
        src_shard = torch.div(flat, nl, rounding_mode="floor")
        src_row = flat - src_shard * nl
        is_local = src_shard == shard
        src_eff = torch.where(is_local, d, src_shard)    # locals → bucket d
        order = torch.argsort(src_eff, stable=True)
        counts = torch.zeros(d + 1, dtype=I64, device=dev).index_add_(
            0, src_eff, torch.ones_like(src_eff))
        starts = torch.cumsum(counts, 0) - counts       # exclusive prefix
        rank = torch.empty_like(order)
        rank[order] = torch.arange(flat.numel(), dtype=I64, device=dev) \
            - starts[src_eff[order]]
        valid = ~is_local & (rank < cap)
        n_dropped = (~is_local & (rank >= cap)).sum(dtype=I32)
        # Row d of the padded buffer takes every request without a place.
        req = torch.zeros((d + 1, cap), dtype=I32, device=dev)
        req[torch.where(valid, src_shard, d),
            torch.where(valid, rank, 0)] = src_row.to(I32)
        return A2aRoute(req=req[:d], src_shard=src_shard, src_row=src_row,
                        is_local=is_local, valid=valid, rank=rank,
                        n_dropped=n_dropped)


    # -- the shard body -----------------------------------------------------

    def _open_shard(self, state, dst, keep, alive, s: int, j: int,
                    nl: int) -> _Shard:
        """Global shard ``s``, the ``j``-th this rank holds, whose nodes
        sampled ``dst``; ``keep`` and ``alive`` are global."""
        rows = slice(j * nl, (j + 1) * nl)
        grows = slice(s * nl, (s + 1) * nl)
        src_shard = torch.div(dst, nl, rounding_mode="floor")
        return _Shard(
            index=s, r0=s * nl, rows=rows, grows=grows, dst=dst,
            ok=alive[dst.to(I64)] & alive[grows][:, None],
            keep=None if keep is None else keep[grows],
            cv0=state.cache_val[rows], cs0=state.cache_slot[rows],
            wv=state.cache_val[rows], ws=state.cache_slot[rows],
            src_shard=src_shard, src_row=dst - src_shard * nl)

    def _gate_board(self, bval, bslot, now: int, r0: int, idx=None):
        """The admission gate on a shard's board; its row r is published
        by global node ``r0 + r``, or ``r0 + idx[r]`` for a compacted
        board (the per-origin budget's owner)."""
        kn = self._knobs
        tb = kn.budget_arg()
        b_own = None
        if tb is not None:
            if idx is None:
                idx = torch.arange(bval.shape[0], dtype=I32,
                                   device=bval.device)
            b_own = torch.div(bslot, self.p.services_per_node,
                              rounding_mode="floor") == (r0 + idx)[:, None]
        return admit_gate(bval, now, kn.stale_ticks, kn.future_arg(), tb,
                          b_own)

    def _publish_block(self, state, x: _Shard, now: int):
        """Shard ``x``'s board — the publish kernel at ``row_offset =
        r0`` — gated once before it travels."""
        block = dataclasses.replace(
            state, cache_val=state.cache_val[x.rows],
            cache_slot=state.cache_slot[x.rows],
            cache_sent=state.cache_sent[x.rows])
        bval, x.bslot, x.sent = self._publish(block, self._knobs.limit,
                                              row_offset=x.r0)
        x.bval = self._gate_board(bval, x.bslot, now, x.r0)

    def _publish_compacted(self, state, x: _Shard, sender, now: int):
        """Shard ``x``'s board from its compacted senders — the publish
        kernel with explicit global ids ``idx + r0`` — scattered back to
        the dense ``[nl, K]`` block (a row without an eligible line
        publishes ``(0, -1)`` in the dense form too), so every exchange
        mode runs on it unchanged."""
        p = self.p
        k = p.cache_lines
        idx_s, row_s, valid_s, pos_s = sparse_ops.compact_rows(
            sender, self._sparse_caps_shard[0])
        rs = (x.rows.start + row_s).to(I64)
        cv_s = torch.where(valid_s[:, None], state.cache_val[rs], 0)
        sl_s = torch.where(valid_s[:, None], state.cache_slot[rs], -1)
        with cost.phase("publish"):
            bval_c, bslot_c, sent_c = kernel_ops.publish_board(
                cv_s, sl_s, state.cache_sent[rs], budget=min(p.budget, k),
                limit=self._knobs.limit, fanout=p.fanout, cache_lines=k,
                row_ids=idx_s + x.r0)
        snd = sender[:, None]
        pos = pos_s.to(I64)
        x.sent = torch.where(snd, sent_c[pos], state.cache_sent[x.rows])
        bval_c = self._gate_board(bval_c, bslot_c, now, x.r0, idx_s)
        x.bval = torch.where(snd, bval_c[pos], 0)
        x.bslot = torch.where(snd, bslot_c[pos], -1)

    def _compact_receivers(self, x: _Shard, recv, alive):
        """Narrow shard ``x``'s pull and fold fields to its compacted
        receivers (rows that sampled a sender); pad rows fold nothing."""
        nl, f = x.dst.shape
        _idx, row_r, valid_r, pos_r = sparse_ops.compact_rows(
            recv, self._sparse_caps_shard[1])
        rr = row_r.to(I64)
        x.recv, x.rr, x.pos_r = recv, rr, pos_r.to(I64)
        x.dst = x.dst[rr]
        x.ok = alive[x.dst.to(I64)] & (alive[x.r0 + rr] & valid_r)[:, None]
        x.keep = None if x.keep is None else x.keep[rr]
        x.cv0, x.cs0 = x.cv0[rr], x.cs0[rr]
        x.wv, x.ws = x.cv0, x.cs0
        x.src_shard, x.src_row = x.src_shard[rr], x.src_row[rr]
        if x.route is not None:
            rt = x.route

            def narrow(t):
                return t.reshape(nl, f)[rr].reshape(-1)

            x.route = dataclasses.replace(
                rt, src_shard=narrow(rt.src_shard),
                src_row=narrow(rt.src_row), is_local=narrow(rt.is_local),
                valid=narrow(rt.valid), rank=narrow(rt.rank))

    def _fold(self, x: _Shard, pv, ps, ok, now: int):
        """Fold one group of pulled rows into shard ``x``'s winners."""
        x.wv, x.ws = self._fold_pulled(x.cv0, x.cs0, x.wv, x.ws, pv, ps,
                                       ok, now, keep=x.keep,
                                       stale_filtered=True)

    def _exchange_fold(self, shards, req_in, now: int):
        """The board exchange in the mode's order, and the fold of the
        remote rows into each shard's winners (over its receiver rows:
        all of them, or the compacted ones)."""
        g, d, nl = self.group, self.d, self.p.n // self.d
        k = self.p.cache_lines
        mode = self.board_exchange
        if mode == "all_gather":
            with cost.phase("exchange"):
                boards = zip(g.all_gather([x.bval for x in shards]),
                             g.all_gather([x.bslot for x in shards]))
            for x, (bval, bslot) in zip(shards, boards):
                pv, ps = kernel_ops.board_row_gather(bval, bslot, x.dst, 0)
                self._fold(x, pv, ps, x.ok, now)
        elif mode == "all_to_all":
            rows = [torch.clamp(r, 0, nl - 1).to(I64) for r in req_in]
            with cost.phase("exchange"):
                resp_v = g.all_to_all([x.bval[r]
                                       for x, r in zip(shards, rows)])
                resp_s = g.all_to_all([x.bslot[r]
                                       for x, r in zip(shards, rows)])
            for x, rv, rs in zip(shards, resp_v, resp_s):
                rt = x.route
                f = x.dst.shape[1]
                shard = torch.where(rt.valid, rt.src_shard, 0)
                rank = torch.where(rt.valid, rt.rank, 0)
                on = rt.valid[:, None]
                pv = torch.where(on, rv[shard, rank], 0).reshape(-1, f, k)
                ps = torch.where(on, rs[shard, rank], -1).reshape(-1, f, k)
                self._fold(x, pv, ps, x.ok & ~rt.is_local.reshape(-1, f),
                           now)
        elif mode == "zoned":
            # Hop h carries each shard's statically reachable rows to
            # shard (s - h) mod d; the receiver looks sampled rows up
            # through the hop's pos table, and a row the plan never
            # ships reads the appended (0, -1) pad row (its fold is
            # masked off anyway).
            for h in range(1, d):
                if self._zoned_tabs[h - 1] is None:
                    continue
                zrows, zvalid, zpos = self._zoned_tabs[h - 1]
                perm = [(i, (i - h) % d) for i in range(d)]
                blk_v = [torch.where(zvalid[x.index][:, None],
                                     x.bval[zrows[x.index]], 0)
                         for x in shards]
                blk_s = [torch.where(zvalid[x.index][:, None],
                                     x.bslot[zrows[x.index]], -1)
                         for x in shards]
                with cost.phase("exchange"):
                    got_v = g.ppermute(blk_v, perm)
                    got_s = g.ppermute(blk_s, perm)
                for x, bv, bs in zip(shards, got_v, got_s):
                    ss = (x.index + h) % d
                    sel = x.src_shard == ss
                    pos = zpos[ss][torch.where(sel, x.src_row, 0).to(I64)]
                    bv = torch.cat([bv, bv.new_zeros((1, k))])
                    bs = torch.cat([bs, bs.new_full((1, k), -1)])
                    self._fold(x, bv[pos], bs[pos], x.ok & sel, now)
        else:  # ring: d - 1 hops pass each block to shard (s - 1) mod d
            perm = [(i, (i - 1) % d) for i in range(d)]
            cur_v = [x.bval for x in shards]
            cur_s = [x.bslot for x in shards]
            for h in range(1, d):
                with cost.phase("exchange"):
                    cur_v = g.ppermute(cur_v, perm)
                    cur_s = g.ppermute(cur_s, perm)
                for x, bv, bs in zip(shards, cur_v, cur_s):
                    sel = x.src_shard == (x.index + h) % d
                    rows_h = torch.where(sel, x.src_row, 0).to(I64)
                    self._fold(x, bv[rows_h], bs[rows_h], x.ok & sel, now)

    def _finalize_dense(self, state, x: _Shard, offer_val, base_slot):
        """One batch resolution against the pre-round cache, then the
        owner-offer insert: the single-device op sequence.  Returns the
        shard's cache triple and its evictions."""
        changed = (x.wv != x.cv0) | (x.ws != x.cs0)
        sent = torch.where(changed, 0, x.sent)
        ev_merge = ((x.cs0 >= 0) & (x.ws != x.cs0)).sum(dtype=I32)
        cv, cs, se, ev_ann = self._insert_own_offers(
            x.wv, x.ws, sent, offer_val, base_slot, reset_on_hold=True)
        return cv, cs, se, ev_merge + ev_ann.to(I32)

    def _finalize_compacted(self, state, x: _Shard, announcer, offer_val,
                            base_slot):
        """The finalize on the compacted receiver rows and the announce
        insert on the compacted announcer rows, each written back into
        the shard's block by a gather and a select."""
        changed = (x.wv != x.cv0) | (x.ws != x.cs0)
        sent_r = torch.where(changed, 0, x.sent[x.rr])
        ev_merge = ((x.cs0 >= 0) & (x.ws != x.cs0)).sum(dtype=I32)
        rc = x.recv[:, None]
        cv = torch.where(rc, x.wv[x.pos_r], state.cache_val[x.rows])
        cs = torch.where(rc, x.ws[x.pos_r], state.cache_slot[x.rows])
        se = torch.where(rc, sent_r[x.pos_r], x.sent)
        _idx, row_a, valid_a, pos_a = sparse_ops.compact_rows(
            announcer, self._sparse_caps_shard[2])
        ra = row_a.to(I64)
        off_a = torch.where(valid_a[:, None], offer_val[ra], 0)
        cv2, cs2, se2, ev_ann = self._insert_own_offers(
            cv[ra], cs[ra], se[ra], off_a, base_slot[ra],
            reset_on_hold=True)
        pa = pos_a.to(I64)
        ac = announcer[:, None]
        return (torch.where(ac, cv2[pa], cv), torch.where(ac, cs2[pa], cs),
                torch.where(ac, se2[pa], se), ev_merge + ev_ann.to(I32))

    def _shard_round(self, state, src, keep, alive, round_idx, now: int,
                     ann, frontiers=None, carried=None):
        """Publish, exchange, pull and merge, then announce — shard by
        shard, phase by phase (see the module docstring).  ``src``,
        ``keep`` and ``alive`` are global; ``ann`` is the announce's
        own/floor half when the sparse round has computed it already,
        and ``frontiers`` its ``(sender, recv, announcer)`` masks over
        this rank's rows when the compacted body runs.  ``carried`` is
        the pipelined round's ``(src, bval, bslot, sent)`` over this
        rank's rows: the peers and raw boards selected a tick before,
        which replace the sample and the publish, and the transmit
        counts the next selection charged."""
        p, g, d = self.p, self.group, self.d
        nl = p.n // d
        mode = self.board_exchange
        stub = self._exchange_stub
        dsts = src[self._rows()] if carried is None else carried[0]
        shards = [self._open_shard(state, dsts[j * nl:(j + 1) * nl], keep,
                                   alive, s, j, nl)
                  for j, s in enumerate(g.local)]

        # 1. The all_to_all request leg: index math over the peers only
        # (on the sparse round too: requests to a row without an
        # eligible line return its empty board).
        a2a = mode == "all_to_all" and not stub
        req_in = None
        if a2a:
            for x in shards:
                x.route = self._a2a_route(x.dst, x.index, nl)
            with cost.phase("exchange"):
                req_in = g.all_to_all([x.route.req for x in shards])

        # 2. Each shard's board, gated once before it travels; on the
        # sparse round from the compacted senders, and the pulls narrow
        # to the compacted receivers.
        for x in shards:
            if carried is not None:
                _src, bval, x.bslot, x.sent = (t[x.rows] for t in carried)
                x.bval = self._gate_board(bval, x.bslot, now, x.r0)
            elif frontiers is None:
                self._publish_block(state, x, now)
            else:
                self._publish_compacted(state, x, frontiers[0][x.rows], now)
                self._compact_receivers(x, frontiers[1][x.rows], alive)

        # 3. Own-shard rows fold at once.  all_gather skips this: its
        # remote buffer is the whole board, local rows included.
        if mode != "all_gather" or stub:
            for x in shards:
                pv, ps = kernel_ops.board_row_gather(x.bval, x.bslot, x.dst,
                                                     x.r0)
                self._fold(x, pv, ps, x.ok & (x.src_shard == x.index), now)

        # 4. The announce's own/floor half, on each shard's floor replica
        # (or the sparse round's, computed once for all rows).
        if ann is None:
            offers = [self._announce_offers(
                state.own[x.rows], state.floor, state.node_alive[x.rows],
                round_idx, now, row_offset=x.r0) for x in shards]
        else:
            own1, floor1, offer_val, base_slot = ann
            offers = [(own1[x.rows], floor1, offer_val[x.rows],
                       base_slot[x.rows]) for x in shards]

        # 5. The exchange, and the fold of the remote rows.
        if not stub:
            self._exchange_fold(shards, req_in, now)

        # 6. Finalize and insert the owner offers.
        own, cv, cs, se, ev = [], [], [], [], []
        for x, (own_s, _floor_s, offer_val, base_slot) in zip(shards,
                                                               offers):
            if frontiers is None:
                out = self._finalize_dense(state, x, offer_val, base_slot)
            else:
                out = self._finalize_compacted(
                    state, x, frontiers[2][x.rows], offer_val, base_slot)
            own.append(own_s)
            for acc, v in zip((cv, cs, se, ev), out):
                acc.append(v)

        # 7. Re-merge the floor replicas (each announce wrote only its
        # own slice); sum the counters.
        floor = g.pmax([o[1] for o in offers])[0] if ann is None \
            else ann[1]
        evictions = g.psum(ev)[0]
        zero = torch.zeros((), dtype=I32, device=state.own.device)
        dropped = g.psum([zero if x.route is None else x.route.n_dropped
                          for x in shards])[0]
        return dataclasses.replace(
            state, own=_cat(own), cache_slot=_cat(cs), cache_val=_cat(cv),
            cache_sent=_cat(se), floor=floor,
            evictions=(state.evictions + evictions).to(I32),
            dropped=(state.dropped + dropped).to(I32))

    # -- the round (CompressedSim._step and _step_sparse call these) -------

    def _round_gossip_announce(self, state, src, keep, round_idx: int,
                               now: int, ann=None):
        """The shard body, dense (see :meth:`_shard_round`)."""
        return self._shard_round(state, src, keep,
                                 self._gather_rows(state.node_alive),
                                 round_idx, now, ann)

    def _round_gossip_announce_sparse(self, st, src, keep, now: int,
                                      sender, recv, announcer, ann):
        """The shard body on the compacted frontiers (the caller checked
        that no shard's frontier overflows its cap)."""
        return self._shard_round(st, src, keep,
                                 self._gather_rows(st.node_alive), None,
                                 now, ann, (sender, recv, announcer))

    def _sparse_frontiers(self, state, src, round_idx: int, now: int):
        """The three frontiers over this rank's rows (a receiver's
        senders may lie on any rank: the sender mask is gathered) and
        the announce's own/floor half (each rank refreshes its slice of
        the floor replica; the replicas are max-merged)."""
        rows = self._rows()
        sender = kernel_ops.eligible_lines(
            state.cache_slot, state.cache_sent, self._knobs.limit).any(dim=1)
        sender_all = self.group.gather_rows(sender)
        recv = state.node_alive & \
            sender_all[src[rows].to(I64)].any(dim=1)
        own, floor, offer_val, base_slot = self._announce_offers(
            state.own, state.floor, state.node_alive, round_idx, now,
            row_offset=rows.start)
        announcer = (offer_val > 0).any(dim=1)
        return sender, recv, announcer, (
            own, self.group.all_reduce_max(floor), offer_val, base_slot)

    def _sparse_overflow(self, sender, recv, announcer):
        """ONE overflow decision for every shard: whether any shard's
        frontier exceeds its per-shard cap, from the ``3 × d`` sizes
        (every rank's, gathered) read on the host; and the largest
        global frontier size."""
        g, nl = self.group, self.p.n // self.d
        sizes = g.gather_rows(torch.stack([
            m.reshape(g.dl, nl).sum(dim=1)
            for m in (sender, recv, announcer)]).T).T.tolist()
        return (any(c > cap for row, cap in
                    zip(sizes, self._sparse_caps_shard) for c in row),
                max(sum(row) for row in sizes))
