"""The batched rounds the fleet drives: S scenarios of one model in one
round, each scenario's row equal to its unbatched round.

A batched state carries a leading ``[S]`` on every tensor field and a
tuple of S host round indices; a round runs over a group of scenarios
that share the round index (the whole batch unless an early-exit run
froze some).  The knobs arrive as :class:`~sidecar_tpu_torch.ops.knobs.
BatchedKnobs`, and each scenario's draws as its unbatched sim's own
:class:`~sidecar_tpu_torch.ops.gossip.RoundDraws`.

* **Exact** (:func:`exact_step`) and **chaos** (:func:`chaos_step`):
  the ``[S, N, M]`` belief is viewed as ``[S·N, M]`` rows.  The select
  runs once over every row, each row with its scenario's transmit limit
  and its node id as the tie-rotation seed; targets, partners and the
  announce's owner rows are offset by ``s·N``; a dropped triple's row
  is ``S·N``, the view's row count (``s·N + N`` would land in scenario
  s+1).  The round's triples — deliveries, the chaos delay rings'
  matured batches and the announce — go through ONE scatter
  (``ops/gossip.apply_updates``, the CUDA kernel
  ``scatter_max_apply_kernel`` on the card) for the whole group.
* **Compressed** (:func:`compressed_step`): the fused publish gather
  (K1, ``fused_publish_gather_kernel`` on the card) takes its transmit
  limit as a host int, so it launches once per scenario on that
  scenario's contiguous ``cache_*[s]``; the round is each scenario's own
  ``CompressedSim._step`` on its views.  A round batched over
  ``[S, N, …]`` measured no faster on the card (the compressed round is
  device-bound either way), so there is no second copy of it to keep in
  step; only the census and the convergence sample are batched here.

The node axis (:class:`NodeBlock`): on a rank of a fleet laid over a
``("scenario", "node")`` layout the exact and chaos rounds run on the
rank's rows ``[B, N_l, M]`` of each scenario, every row still named by
its global node id.  Every rank of a node group draws each scenario's
whole draws and keeps its rows; the liveness (and the chaos round's
quarantine set) is gathered over the node group once a round; each
sender's deliveries (and the chaos rings' matured batches, kept on the
sender's rank) travel as ``(row, col, val)`` triples to the rank that
owns the row, whose one scatter (K4a) takes them with its announce;
push-pull fetches the partner rows from their ranks and max-folds the
pushed rows back; the census and the chaos counters count the rank's
senders (summed where read), and the convergence max-reduces the
column truth and gathers the per-node counts for one ``alive_mean``.
``NodeBlock(n)`` holds every node: the one-process round, unchanged.

On the exact and chaos rounds, push-pull and the sweep keep their
per-scenario cadences: the host knows each scenario's round and cadence,
so a phase runs on the due scenarios only — the reference's vmapped
``lax.cond``.  The heavy elementwise phases (push-pull, the sweep, the
convergence metric) walk the due scenarios in chunks of at most
:data:`CHUNK_CELLS` cells, bounding their temporaries; a chunk of
consecutive scenarios is a view, any other a copy written back.
"""

from __future__ import annotations

import dataclasses

import torch

from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.ops import gossip as gossip_ops
from sidecar_tpu_torch.ops import kernels as kernel_ops
from sidecar_tpu_torch.ops import suspicion as suspicion_ops
from sidecar_tpu_torch.ops.merge import (
    admit_gate,
    budget_mask,
    future_mask,
    merge_packed,
    staleness_mask,
    sticky_adjust,
)
from sidecar_tpu_torch.ops.status import (
    TOMBSTONE,
    is_known,
    pack,
    unpack_status,
    unpack_ts,
)
from sidecar_tpu_torch.ops.trace import RECORD_WIRE_BYTES
from sidecar_tpu_torch.ops.ttl import ttl_sweep

I32, I64 = torch.int32, torch.int64
F32 = torch.float32

# Cells of [scenario, node, column] an elementwise phase handles at once.
CHUNK_CELLS = 1 << 27


def chunks(idx, cells_per_scenario: int):
    """``idx`` (positions in the group) in runs of at most
    :data:`CHUNK_CELLS` cells."""
    per = max(1, CHUNK_CELLS // max(1, cells_per_scenario))
    idx = list(idx)
    for lo in range(0, len(idx), per):
        yield idx[lo:lo + per]


def on_rows(tensors, idx, fn):
    """Call ``fn`` on the ``[idx]`` rows of each tensor in ``tensors``
    (dim 0), which it updates in place: slices where ``idx`` is a run of
    consecutive positions, else gathered copies written back after.
    Returns what ``fn`` returns."""
    a, b = idx[0], idx[-1] + 1
    if list(idx) == list(range(a, b)):
        return fn(*(t[a:b] for t in tensors))
    sel = torch.as_tensor(idx, dtype=I64, device=tensors[0].device)
    subs = [t[sel] for t in tensors]
    out = fn(*subs)
    for t, s in zip(tensors, subs):
        t[sel] = s
    return out


def node_ids(b: int, n: int, device):
    """Each row's node id within its scenario, int32 ``[b·n]``."""
    return torch.arange(n, dtype=I32, device=device).repeat(b)


class NodeBlock:
    """The node rows ``[lo, hi)`` of every scenario that this rank holds
    of ``n``; the other blocks, in block order, on the ranks of
    ``group`` (a shard group of one shard a rank: the fleet's node
    group).  Without a group (or in a group of one rank) every node is
    here and each collective is the identity."""

    def __init__(self, n: int, group=None):
        self.n = n
        self.group = group if group is not None and group.world > 1 \
            else None
        world = 1 if self.group is None else self.group.world
        rank = 0 if self.group is None else self.group.rank
        if n % world:
            raise ValueError(f"n={n} must divide the node mesh axis "
                             f"({world})")
        self.nl = n // world
        self.lo, self.hi = rank * self.nl, (rank + 1) * self.nl
        self.rows = slice(self.lo, self.hi)

    @property
    def whole(self) -> bool:
        return self.group is None

    def ids(self, b: int, device):
        """Each of the rank's ``b·N_l`` rows' global node id, int32."""
        return torch.arange(self.lo, self.hi, dtype=I32,
                            device=device).repeat(b)

    def gather(self, x):
        """``[B, N_l, …]`` of every rank as ``[B, N, …]``."""
        if self.whole:
            return x
        full = self.group.gather_rows(x.transpose(0, 1).contiguous())
        return full.transpose(0, 1).contiguous()

    def sum(self, x):
        return x if self.whole else self.group.all_reduce_sum(x)

    def max(self, x):
        return x if self.whole else self.group.all_reduce_max(x)

    def route(self, rows, cols, vals, b: int):
        """Triples whose ``rows`` are global flat rows ``s·N + node`` of
        ``b`` scenarios (``b·N`` for a dropped one) to the ranks that own
        the rows, as rank-local rows ``s·N_l + node − lo``.  Only the
        triples that can change a cell travel (``vals > 0``: a 0 never
        advances a cell, and a dropped triple carries 0)."""
        if self.whole:
            return rows, cols, vals
        keep = vals > 0
        rows, cols, vals = rows[keep].to(I64), cols[keep], vals[keep]
        scen = torch.div(rows, self.n, rounding_mode="floor")
        node = rows - scen * self.n
        dest = torch.div(node, self.nl, rounding_mode="floor")
        local = scen * self.nl + node - dest * self.nl
        got = self.group.route(dest, torch.stack(
            [local.to(I32), cols.to(I32), vals.to(I32)], dim=1))
        return got[:, 0], got[:, 1], got[:, 2]

    def global_rows(self, nodes):
        """Node ids ``[C, N_l]`` (each row's partner in its scenario) as
        row ids of the node group's ``[C·N_l]``-a-rank rows, int64."""
        c = nodes.shape[0]
        nodes = nodes.to(I64)
        owner = torch.div(nodes, self.nl, rounding_mode="floor")
        scen = torch.arange(c, dtype=I64, device=nodes.device)[:, None]
        return (owner * (c * self.nl) + scen * self.nl + nodes
                - owner * self.nl).reshape(-1)

    def fetch(self, known, partner):
        """The rows of ``partner`` (``[C, N_l]`` node ids) from the
        rank's ``[C·N_l, M]`` rows and the other ranks'."""
        if self.whole:
            c = partner.shape[0]
            return known[(partner + row_base(c, self.n, known.device)[
                :, None]).reshape(-1).to(I64)]
        return self.group.fetch_rows(known, self.global_rows(partner))

    def push_pull(self, known, partner, alive, alive_n, *, now_tick,
                  stale_ticks, future_ticks=None, now_push=None,
                  tomb_budget=None, owner=None, fetched=None):
        """:func:`ops.gossip.push_pull` on the rank's rows ``known``
        ``[C·N_l, M]`` with ``partner`` ``[C, N_l]`` (node ids; ``alive``
        the rows' liveness, ``alive_n`` every node's).  Over a node
        group the partner rows are fetched from their ranks (``fetched``:
        :meth:`fetch` of the partners before the liveness gate, when the
        caller has them), then pushed.  A partner's merged row is at
        least its pre-exchange row (the merge only raises a cell, and the
        stickiness keeps a raised cell's timestamp), so a pushed cell at
        or below that row — which the pusher has fetched — changes
        nothing: only the cells that advance travel, as ``(row, col,
        val)`` triples max-folded into the owner's merged rows.  Returns
        the merged rows."""
        c = partner.shape[0]
        gates = dict(now_tick=now_tick, stale_ticks=stale_ticks,
                     future_ticks=future_ticks, now_push=now_push,
                     tomb_budget=tomb_budget, owner=owner)
        if self.whole:
            return gossip_ops.push_pull(
                known, (partner + row_base(c, self.n, known.device)[:, None])
                .reshape(-1), node_alive=alive.reshape(-1),
                row_ids=node_ids(c, self.n, known.device), **gates)
        ids = self.ids(c, known.device)
        ok = (alive.reshape(-1)
              & torch.gather(alive_n, 1, partner.to(I64)).reshape(-1))
        if fetched is None:
            fetched = self.fetch(known, partner)
        partner = torch.where(ok, partner.reshape(-1), ids)
        pre_tgt = torch.where(ok[:, None], fetched, known)
        del fetched
        own_pull = own_push = None
        if tomb_budget is not None and owner is not None:
            own_pull = owner[None, :] == partner[:, None]
            own_push = owner[None, :] == ids[:, None]
        pulled = merge_packed(known, pre_tgt, now_tick, stale_ticks,
                              future_ticks, tomb_budget, own_pull)
        offered = admit_gate(known, now_tick if now_push is None else
                             now_push, stale_ticks, future_ticks,
                             tomb_budget, own_push)
        offered = sticky_adjust(offered, pre_tgt, offered > pre_tgt)
        row, col = torch.nonzero(offered > pre_tgt, as_tuple=True)
        vals = offered[row, col]
        del pre_tgt, offered
        rows = c * self.nl
        at = self.global_rows(partner.view(c, self.nl))[row]
        dest = torch.div(at, rows, rounding_mode="floor")
        got = self.group.route(dest, torch.stack(
            [(at - dest * rows).to(I32), col.to(I32), vals], dim=1))
        m = known.shape[1]
        return pulled.view(-1).scatter_reduce_(
            0, got[:, 0].to(I64) * m + got[:, 1].to(I64), got[:, 2],
            "amax").view(rows, m)


def row_base(b: int, n: int, device):
    """Each scenario's first row in the flattened ``[b·n]`` rows, int32
    ``[b]``."""
    return torch.arange(b, dtype=I32, device=device) * n


def sample_batch(sim, slot, alive, round_idx: int, kn=None, cut=True,
                 rows=slice(None)):
    """The batched ``ops/gossip.sample_peers``: resolve ``slot`` (int32
    ``[B, R, L]`` draws of the senders ``rows``, every node by default)
    to targets WITHIN each scenario, ``[B, R, L]`` node ids.  Dead
    senders (``alive`` ``[B, R]``) and cut edges send to themselves;
    with ``kn`` the topology's stagger and each scenario's tick cadence
    gate the round as in the unbatched sample (None: no gates — the
    push-pull partner and the chaos round)."""
    b, r, _ = slot.shape
    dev = slot.device
    lo = rows.start or 0
    self_idx = torch.arange(lo, lo + r, dtype=I32, device=dev)[None, :, None]
    if sim._nbrs is None:
        dst = slot + (slot >= self_idx).to(I32)
    else:
        s64 = slot.to(I64)
        dst = torch.gather(sim._nbrs[rows].expand(b, -1, -1), 2, s64)
        if cut and sim._cut is not None:
            dst = torch.where(
                torch.gather(sim._cut[rows].expand(b, -1, -1), 2, s64),
                self_idx, dst)
    dst = torch.where(alive[:, :, None], dst, self_idx)
    if kn is None:
        return dst
    if sim._stagger is not None and sim._stagger_period > 1:
        off = ((round_idx + sim._stagger[rows]) % sim._stagger_period) != 0
        dst = torch.where(off[None, :, None], self_idx, dst)
    if kn.cadence_enabled:
        period = torch.clamp(kn.tensors["tick_period"], min=1)
        off = ((round_idx + kn.tensors["tick_phase"]) % period) != 0
        dst = torch.where(off[:, None, None], self_idx, dst)
    return dst


def stacked_keep(draws, kn, shape, device, rows=slice(None)):
    """The group's loss masks stacked ``[B·R, F, W]``: each lossy
    scenario's draw (its senders ``rows``), all-true for a scenario
    without loss; None when no scenario loses packets."""
    if not kn.needs_drop_draw:
        return None
    parts = [d.keep[rows].to(device) if h.needs_drop_draw else
             torch.ones(shape, dtype=torch.bool, device=device)
             for d, h in zip(draws, kn.host)]
    return torch.cat(parts)


def select_rows(sim, known, sent, kn, ax=None):
    """Select on the ``[B·N_l, M]`` rows (every node without ``ax``, a
    :class:`NodeBlock`): each row's limit is its scenario's, its tie
    rotation seeded by its global node id."""
    ax = ax or NodeBlock(sim.p.n)
    b = known.shape[0] // ax.nl
    svc, msg = gossip_ops.select_messages(
        known, sent, sim.p.budget, kn.rows("limit", ax.nl),
        row_ids=ax.ids(b, known.device))
    return svc, msg


def announce_batch(sim, known, alive, round_idx: int, now, kn, ax=None):
    """The owners' refresh re-stamps (and the suspicion refutation) of a
    group as flat triples: the batched ``ExactSim._announce_updates``.
    ``known`` is ``[B, N_l, M]``, the rows of ``ax`` (every node
    without one), whose owners announce their own slots; ``now`` an int
    or a per-slot ``[M]`` clock.  A cell not due gets the rank-local
    row ``B·N_l`` and value 0."""
    p, t = sim.p, sim.t
    b, nl, m = known.shape
    dev = known.device
    ax = ax or NodeBlock(p.n)
    spn = p.services_per_node
    cols = torch.arange(ax.lo * spn, ax.hi * spn, dtype=I32, device=dev)
    owner = sim.owner[cols.to(I64)] - ax.lo
    own_flat = owner.to(I64) * m + cols.to(I64)
    if isinstance(now, torch.Tensor):
        now = now[cols.to(I64)]
    mc = cols.shape[0]
    own = known.view(b, nl * m)[:, own_flat]                    # [B, Mc]
    st = unpack_status(own)
    present = is_known(own) & alive[:, owner.to(I64)]
    due = gossip_ops.refresh_due(
        own, cols, round_idx, refresh_rounds=kn.rows("refresh_rounds", 1),
        round_ticks=t.round_ticks, now=now) & present & (st != TOMBSTONE)
    due, st = suspicion_ops.announce_refute(due, st, present,
                                            kn.suspicion_rows(1))
    vals = torch.where(due, pack(now, st), 0)
    rows = torch.where(due, owner[None, :] + row_base(b, nl, dev)[:, None],
                       b * nl)
    return (rows.reshape(-1), cols.expand(b, mc).reshape(-1),
            vals.reshape(-1), due.reshape(-1))


def sweep_rows(sim, known, sent, kn, idx, now):
    """The lifespan sweep on the scenarios at ``idx`` of ``known``/
    ``sent`` (``[B, N, M]``), in place; ``now`` an int or a per-node
    ``[N]`` clock.  Expired cells get their transmit counts reset."""
    n, m = known.shape[1], known.shape[2]

    def run(kv, sv, kn_c):
        c = kv.shape[0]
        kf, sf = kv.view(c * n, m), sv.view(c * n, m)
        now_r = now if isinstance(now, int) else now.repeat(c)[:, None]
        swept, _ = ttl_sweep(
            kf, now_r, alive_lifespan=kn_c.rows("alive_lifespan", n),
            draining_lifespan=kn_c.rows("draining_lifespan", n),
            tombstone_lifespan=kn_c.rows("tombstone_lifespan", n),
            one_second=sim.t.one_second,
            suspicion_window=kn_c.rows("suspicion_window", n))
        sf.masked_fill_(swept != kf, 0)
        kf.copy_(swept)

    for ch in chunks(idx, n * m):
        kn_c = kn.take(ch)
        on_rows((known, sent), ch, lambda kv, sv: run(kv, sv, kn_c))


def exact_convergence(known, alive, ax=None):
    """Each scenario's fraction of (alive node, slot) cells agreeing with
    its freshest alive belief, float32 ``[B]`` — ``ExactSim.convergence``
    a scenario at a time, in chunks.  On a node block (``ax``) the
    column truth is max-reduced over the node group and each node's
    agreeing count gathered, so the float32 mean is the one-process
    one."""
    b, nl, m = known.shape
    ax = ax or NodeBlock(nl)
    out = []
    for ch in chunks(range(b), nl * m):
        a, z = ch[0], ch[-1] + 1
        k, al = known[a:z], alive[a:z]
        truth = ax.max(torch.where(al[:, :, None], k, 0).amax(dim=1))
        # Each node's count of agreeing cells, without a float copy.
        agree = (k == truth[:, None, :]).sum(dim=2, dtype=I32)
        out.append(common.alive_mean(ax.gather(agree), m, ax.gather(al)))
    return torch.cat(out)


def exact_census(sim, known, sent, kn, ax=None):
    """Each scenario's pre-round offer census — ``ops/trace.offer_census``
    of its eligible records: ``(frontier, exchange_bytes)``, int32
    ``[B]`` each (a node block's counts summed over its node group)."""
    p = sim.p
    per_row = gossip_ops.eligible_records(
        known, sent, kn.rows("limit", 1, 3)).sum(
        dim=2, dtype=I64).to(I32)                              # [B, N_l]
    frontier = (per_row > 0).sum(dim=1, dtype=I64).to(I32)
    budget = min(p.budget, p.m)
    recs = torch.clamp(per_row, max=budget).sum(dim=1, dtype=I64).to(I32)
    if ax is not None and not ax.whole:
        frontier, recs = ax.sum(torch.stack([frontier, recs]))
    return frontier, recs * (p.fanout * RECORD_WIRE_BYTES)


# -- the exact round -----------------------------------------------------------

def hook_rows(ax):
    """The ``rows=`` a row-local scenario hook gets on ``ax``."""
    return None if ax.whole else ax.rows


def exact_step(sim, state, draws, kn, perturb=None, ax=None):
    """One batched exact round of the group ``state`` (``known``/``sent``
    ``[B, N_l, M]``, ``node_alive`` ``[B, N_l]``: the rows of the node
    block ``ax``, every node without one; a tuple of B equal round
    indices), in place on ``known`` and ``sent``: the batched
    ``ExactSim._step``.  ``draws`` are the B scenarios' own draws,
    whole."""
    p, t = sim.p, sim.t
    n = p.n
    ax = ax or NodeBlock(n)
    b, nl, m = state.known.shape
    dev = state.known.device
    round_idx = state.round_idx[0] + 1
    now = round_idx * t.round_ticks
    state = common.apply_perturb(perturb, state, now, kn, hook_rows(ax))
    known, sent, alive = state.known, state.sent, state.node_alive
    rows = b * nl
    kf, sf, af = known.view(rows, m), sent.view(rows, m), alive.reshape(rows)
    alive_n = ax.gather(alive)                                  # [B, N]

    slot = torch.stack([d.peer_slot[ax.rows].to(dev, I32) for d in draws])
    dst = (sample_batch(sim, slot, alive, round_idx, kn, rows=ax.rows)
           + row_base(b, n, dev)[:, None, None]).reshape(rows, p.fanout)
    keep = stacked_keep(draws, kn, (nl, p.fanout, min(p.budget, p.m)), dev,
                        ax.rows)

    svc, msg = select_rows(sim, kf, sf, kn, ax)
    gossip_ops.record_transmissions(sf, svc, msg, p.fanout)
    tb = kn.budget_arg(nl, 3)
    sender_own = None
    if tb is not None:
        sender_own = sim.owner[svc.clamp(max=p.m - 1).to(I64)] == \
            ax.ids(b, dev)[:, None]
    d_rows, d_cols, d_vals = gossip_ops.expand_deliveries(
        dst, svc, msg, now_tick=now,
        stale_ticks=kn.rows("stale_ticks", nl, 3),
        node_alive=alive_n.reshape(-1), sender_alive=af, record_keep=keep,
        future_ticks=kn.future_arg(nl, 3), tomb_budget=tb,
        sender_own=sender_own)
    d_rows, d_cols, d_vals = ax.route(d_rows, d_cols, d_vals, b)
    d_vals, d_adv = gossip_ops.finalize_deliveries(kf, d_rows, d_cols,
                                                   d_vals)
    a_rows, a_cols, a_vals, a_due = announce_batch(sim, known, alive,
                                                   round_idx, now, kn, ax)
    gossip_ops.apply_updates(
        kf, sf, torch.cat([d_rows, a_rows]), torch.cat([d_cols, a_cols]),
        torch.cat([d_vals, a_vals]), torch.cat([d_adv, a_due]))

    pp = [i for i, h in enumerate(kn.host)
          if round_idx % h.push_pull_rounds == 0]
    if pp:
        exact_push_pull(sim, known, sent, alive, alive_n, draws, kn, pp, now,
                        ax)
    sw = [i for i, h in enumerate(kn.host)
          if round_idx % h.sweep_rounds == 0]
    if sw:
        sweep_rows(sim, known, sent, kn, sw, now)
    return dataclasses.replace(state, round_idx=(round_idx,) * b)


def exact_push_pull(sim, known, sent, alive, alive_n, draws, kn, idx, now,
                    ax):
    """Anti-entropy of the scenarios at ``idx`` with their sampled
    partners, in place (``ExactSim._push_pull`` a chunk of scenarios at
    a time); on a node block the partner rows travel
    (:meth:`NodeBlock.push_pull`), ``alive_n`` the gathered liveness."""
    m, nl = sim.p.m, ax.nl
    dev = known.device

    def run(kv, sv, av, an, slot, kn_c):
        c = kv.shape[0]
        partner = sample_batch(sim, slot, av, 0, rows=ax.rows)[:, :, 0]
        kf, sf = kv.view(c * nl, m), sv.view(c * nl, m)
        tb = kn_c.budget_arg(nl)
        merged = ax.push_pull(
            kf, partner, av, an, now_tick=now,
            stale_ticks=kn_c.rows("stale_ticks", nl),
            future_ticks=kn_c.future_arg(nl), tomb_budget=tb,
            owner=sim.owner if tb is not None else None)
        sf.masked_fill_(merged != kf, 0)
        kf.copy_(merged)

    for ch in chunks(idx, nl * m):
        for i in ch:
            if draws[i].pp_slot is None:
                raise ValueError("a push-pull round's draws carry no "
                                 "pp_slot")
        slot = torch.stack([draws[i].pp_slot[ax.rows].to(dev, I32)
                            for i in ch])
        kn_c = kn.take(ch)
        on_rows((known, sent), ch,
                lambda kv, sv: run(kv, sv, alive[ch], alive_n[ch], slot,
                                   kn_c))


# -- the chaos round -----------------------------------------------------------

def stack_faults(fds, device, rows=slice(None)):
    """B scenarios' ``FaultDraws`` as one whose uniforms are ``[B, R,
    F]``, the senders ``rows`` (the plan is shared, so the same fields
    are None in each)."""
    from sidecar_tpu_torch.chaos.sim_inject import FaultDraws

    def st(ts):
        return None if ts[0] is None else torch.stack(
            [x[rows].to(device) for x in ts])

    return FaultDraws(
        st([f.drop_u for f in fds]),
        tuple(st([f.delay_u[i] for f in fds])
              for i in range(len(fds[0].delay_u))),
        tuple(st([f.dup_u[i] for f in fds])
              for i in range(len(fds[0].dup_u))))


def chaos_step(sim, cst, draws, fds, kn, perturb=None, ax=None):
    """One batched chaos round of the group ``cst`` (a ``ChaosSimState``
    whose tensors carry a leading ``[B]``: the rings ``[B, d, L]`` with
    scenario-local rows, the counters ``[B]``, ``origin_violations``
    ``[B, N]``), in place on ``known``, ``sent`` and the rings: the
    batched ``ChaosExactSim._step``.  The plan is shared, so its windows,
    liveness, clocks and restarts are decided once; ``fds`` are the B
    scenarios' own fault draws.

    On a node block ``ax`` the state holds the block's rows: ``known``,
    ``sent``, ``node_alive`` and ``origin_violations`` its ``N_l``
    nodes, each ring its senders' ``N_l·F·B`` lanes (rows still global
    node ids), each counter its senders' counts (the node group's sum is
    the scenario's)."""
    from sidecar_tpu_torch.chaos.sim_inject import ChaosSimState
    from sidecar_tpu_torch.models.exact import SimState

    p, t, prog = sim.p, sim.t, sim._prog
    n, m, fanout = p.n, p.m, p.fanout
    ax = ax or NodeBlock(n)
    nl = ax.nl
    state = cst.sim
    b = state.known.shape[0]
    rows_n = b * nl
    dev = state.known.device
    round_idx = state.round_idx[0] + 1
    now = round_idx * t.round_ticks
    fd = stack_faults(fds, dev, ax.rows)
    base = row_base(b, n, dev)
    ids = ax.ids(b, dev)

    # 1-2. Faulted liveness and the per-node clocks, shared by the batch;
    # every node's liveness gathered once.
    base_alive = state.node_alive
    down = prog.down_mask(round_idx)
    alive = base_alive if down is None else \
        base_alive & ~down[ax.rows][None, :]
    alive_n = ax.gather(alive)                                  # [B, N]
    off = prog.clock_offsets(round_idx)
    now_n = None if off is None else torch.clamp(now + off, min=0)
    now_r = None if now_n is None else now_n.repeat(b)          # [B·N]

    # 3. The knobs; the quarantine set from the round-start evidence.
    ft3, tb3 = kn.future_arg(nl, 3), kn.budget_arg(nl, 3)
    stale3 = kn.rows("stale_ticks", nl, 3)
    qt = kn.quarantine_arg(1)
    rej, forged = cst.rejected_future, cst.forged_records
    brej, viol = cst.rejected_budget, cst.origin_violations
    quar = None if qt is None else viol >= qt                   # [B, N_l]

    # 4. Crash restarts (of the block's nodes).
    known, sent = state.known, state.sent
    r = prog.restart_rows(round_idx)
    if r is not None and not ax.whole:
        r = r[(r >= ax.lo) & (r < ax.hi)]
        r = r if r.numel() else None
    if r is not None:
        s = p.services_per_node
        own_cols = r[:, None] * s + torch.arange(s, dtype=I64, device=dev)
        rl = r - ax.lo
        own = known[:, rl[:, None], own_cols]
        st = unpack_status(own)
        stamp = now if now_n is None else now_n[r][:, None]
        cold = torch.where((unpack_ts(own) > 0) & (st != TOMBSTONE),
                           pack(stamp, st), 0)
        known[:, rl] = 0
        known[:, rl[:, None], own_cols] = cold
        sent[:, rl] = 0

    # 5. The scenario hook, on the faulted liveness.
    hooked = common.apply_perturb(
        perturb, dataclasses.replace(state, node_alive=alive), now, kn,
        hook_rows(ax))
    known, sent = hooked.known, hooked.sent
    kf, sf, af = known.view(rows_n, m), sent.view(rows_n, m), \
        alive.reshape(rows_n)

    # 6. The sample, with the cut (no stagger or cadence gate).
    slot = torch.stack([d.peer_slot[ax.rows].to(dev, I32) for d in draws])
    dst_l = sample_batch(sim, slot, alive, round_idx,
                         rows=ax.rows)                          # [B, N_l, F]
    dst = (dst_l + base[:, None, None]).reshape(rows_n, fanout)

    # 7. Select and charge.
    svc, msg = select_rows(sim, kf, sf, kn, ax)
    gossip_ops.record_transmissions(sf, svc, msg, fanout)

    # 8. The edge masks; counts only of non-empty packets, per scenario.
    keep, diverts = prog.edge_masks(dst_l, round_idx, fd, rows=ax.rows)
    budget = svc.shape[1]
    nonempty = (msg > 0).any(dim=1).reshape(b, nl, 1)

    def count(mask):
        return (mask & nonempty).sum(dim=(1, 2), dtype=I32)

    def per_scen(x):
        return x.reshape(b, -1).sum(dim=1, dtype=I32)

    drops = cst.injected_drops
    if keep is not None:
        drops = drops + count(~keep)

    record_keep = stacked_keep(draws, kn, (nl, fanout, budget), dev,
                               ax.rows)
    recv_now = now if now_r is None else now_r[dst.to(I64)][:, :, None]
    cand = msg[:, None, :].expand(rows_n, fanout, budget)
    # 9. Wire copies the receivers' future bound rejects.
    if ft3 is not None:
        rej = rej + per_scen(future_mask(cand, recv_now, ft3) & (cand > 0))
    # 10. The budget's evidence, charged to the sending origin.
    own_sel = None
    if tb3 is not None:
        own_sel = sim.owner[svc.clamp(max=m - 1).to(I64)] == ids[:, None]
        own3 = own_sel[:, None, :]
        bcand = torch.where(staleness_mask(cand, recv_now, stale3), 0, cand)
        bts = unpack_ts(bcand)
        fresh = (bts > 0) & ~own3 & (bts >= recv_now)
        erank = torch.cumsum(fresh.to(I32), dim=-1, dtype=I32)
        viol = viol + (fresh & (erank > tb3)).sum(
            dim=(1, 2), dtype=I32).reshape(b, nl)
        if ft3 is not None:
            bcand = torch.where(future_mask(bcand, recv_now, ft3), 0, bcand)
        brej = brej + per_scen(budget_mask(bcand, recv_now, tb3, own3))
    # 11. Quarantined origins lose their send channel.
    ekeep = None if keep is None else keep.reshape(rows_n, fanout)
    if quar is not None:
        qkeep = ~quar.reshape(rows_n, 1)
        ekeep = qkeep if ekeep is None else ekeep & qkeep

    # 12. The deliveries at each receiver's clock.
    rows, cols, vals = gossip_ops.expand_deliveries(
        dst, svc, msg, now_tick=recv_now, stale_ticks=stale3,
        node_alive=alive_n.reshape(-1), sender_alive=af,
        record_keep=record_keep, edge_keep=ekeep, future_ticks=ft3,
        tomb_budget=tb3, sender_own=own_sel)

    def flat(mask):
        return mask.reshape(rows_n, fanout, 1).expand(
            rows_n, fanout, budget).reshape(-1)

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

    # 14. Each ring: pop the matured batch (rows made global, its
    # sentinel N made B·N), re-resolve it at arrival, push this round's
    # diverted packets (rows made local again).  A ring holds its
    # senders' lanes: the matured triples travel to their rows' ranks
    # with the immediate ones.
    stale1, ft1 = kn.rows("stale_ticks", 1), kn.future_arg(1)
    all_rows, all_cols, all_vals = [rows], [cols], [vals_imm]
    for ring_idx, delay_sel, dup_sel in diverts:
        divert = delay_sel if dup_sel is None else (
            dup_sel if delay_sel is None else delay_sel | dup_sel)
        r_rows, r_cols, r_vals = cst.rings[ring_idx]
        slot_r = round_idx % r_rows.shape[1]
        m_loc, m_cols = r_rows[:, slot_r].clone(), r_cols[:, slot_r].clone()
        m_vals = r_vals[:, slot_r]                              # [B, L]
        m_idx = m_loc.clamp(max=n - 1).to(I64)
        m_now = now if now_n is None else now_n[m_idx]
        m_vals = torch.where(staleness_mask(m_vals, m_now, stale1), 0,
                             m_vals)
        if ft1 is not None:
            fm = future_mask(m_vals, m_now, ft1)
            rej = rej + (fm & (m_vals > 0)).sum(dim=1, dtype=I32)
            m_vals = torch.where(fm, 0, m_vals)
        real = m_loc < n
        m_vals = torch.where(real & torch.gather(alive_n, 1, m_idx),
                             m_vals, 0)
        all_rows.append(torch.where(real, m_loc + base[:, None],
                                    b * n).reshape(-1))
        all_cols.append(m_cols.reshape(-1))
        all_vals.append(m_vals.reshape(-1))
        fm = flat(divert).reshape(b, -1)
        r_rows[:, slot_r] = torch.where(
            fm, rows.reshape(b, -1) - base[:, None], n)
        r_cols[:, slot_r] = cols.reshape(b, -1)
        r_vals[:, slot_r] = torch.where(fm, vals.reshape(b, -1), 0)

    # 15. Every batch to its rows' ranks; stickiness against the
    # pre-round belief.
    if len(all_rows) > 1:
        rows, cols = torch.cat(all_rows), torch.cat(all_cols)
        vals = torch.cat(all_vals)
    else:
        vals = vals_imm
    rows, cols, vals = ax.route(rows, cols, vals, b)
    d_vals, d_adv = gossip_ops.finalize_deliveries(kf, rows, cols, vals)

    # 16-17. The announce at each owner's clock, in the same scatter.
    a_rows, a_cols, a_vals, a_due = announce_batch(
        sim, known, alive, round_idx,
        now if now_n is None else now_n[sim.owner.to(I64)], kn, ax)
    gossip_ops.apply_updates(
        kf, sf, torch.cat([rows, a_rows]), torch.cat([cols, a_cols]),
        torch.cat([d_vals, a_vals]), torch.cat([d_adv, a_due]))

    # 18-19. Push-pull on the due scenarios.
    pp = [i for i, h in enumerate(kn.host)
          if round_idx % h.push_pull_rounds == 0]
    if pp:
        rej = chaos_push_pull(sim, known, sent, alive, alive_n, draws, kn,
                              pp, now, now_n, quar, rej, round_idx, ax)

    # 20. The sweep at each node's clock.
    sw = [i for i, h in enumerate(kn.host)
          if round_idx % h.sweep_rounds == 0]
    if sw:
        sweep_rows(sim, known, sent, kn, sw,
                   now if now_n is None else now_n[ax.rows])

    return ChaosSimState(
        sim=SimState(known=known, sent=sent, node_alive=base_alive,
                     round_idx=(round_idx,) * b),
        rings=cst.rings, injected_drops=drops, injected_delays=delays,
        injected_dups=dups, rejected_future=rej, forged_records=forged,
        rejected_budget=brej, origin_violations=viol)


def chaos_push_pull(sim, known, sent, alive, alive_n, draws, kn, idx, now,
                    now_n, quar, rej, round_idx, ax):
    """The chaos round's push-pull on the scenarios at ``idx``, in place,
    a chunk at a time: the partner cut, severed and quarantine-remapped,
    the pull leg at the initiator's clock and the push leg at the
    partner's.  On a node block the partner rows travel and the
    partners' quarantine is gathered.  Returns ``rej`` with the future
    bound's rejections (of the block's initiators) added."""
    prog, m, nl = sim._prog, sim.p.m, ax.nl
    dev = known.device
    counted = []
    quar_n = None if quar is None else ax.gather(quar)          # [B, N]

    def run(kv, sv, av, an, slot, qv, qn, kn_c):
        c = kv.shape[0]
        rows_c = c * nl
        ids = torch.arange(ax.lo, ax.hi, dtype=I32, device=dev)
        partner = sample_batch(sim, slot, av, round_idx,
                               rows=ax.rows)[:, :, 0]           # [C, N_l]
        sever = prog.pp_severed(partner, round_idx, rows=ax.rows)
        if sever is not None:
            partner = torch.where(sever, ids[None, :], partner)
        if qv is not None:
            partner = torch.where(
                qv | torch.gather(qn, 1, partner.to(I64)), ids[None, :],
                partner)
        kf, sf = kv.view(rows_c, m), sv.view(rows_c, m)
        ft = kn_c.future_arg(nl)
        # The partner rows before the liveness gate: the future bound
        # counts them, and over a node group the push-pull reuses them.
        fetched = None if ft is None and ax.whole else ax.fetch(kf, partner)
        pp_now, pp_push = now, None
        if now_n is not None:
            pp_now = now_n[ax.rows].repeat(c)[:, None]
            pp_push = now_n[partner.reshape(-1).to(I64)][:, None]
        if ft is not None:
            got = (future_mask(fetched, pp_now, ft) & (fetched > 0)).reshape(
                c, -1).sum(dim=1, dtype=I32)
            push_now = pp_now if pp_push is None else pp_push
            got = got + (future_mask(kf, push_now, ft) & (kf > 0)).reshape(
                c, -1).sum(dim=1, dtype=I32)
            counted.append(got)
        if ax.whole:
            fetched = None      # one process reads its partners itself
        tb = kn_c.budget_arg(nl)
        merged = ax.push_pull(
            kf, partner, av, an, now_tick=pp_now,
            stale_ticks=kn_c.rows("stale_ticks", nl), future_ticks=ft,
            now_push=pp_push, tomb_budget=tb,
            owner=sim.owner if tb is not None else None, fetched=fetched)
        del fetched
        sf.masked_fill_(merged != kf, 0)
        kf.copy_(merged)

    for ch in chunks(idx, nl * m):
        for i in ch:
            if draws[i].pp_slot is None:
                raise ValueError("a push-pull round's draws carry no "
                                 "pp_slot")
        slot = torch.stack([draws[i].pp_slot[ax.rows].to(dev, I32)
                            for i in ch])
        kn_c = kn.take(ch)
        qv = None if quar is None else quar[ch]
        qn = None if quar is None else quar_n[ch]
        counted.clear()
        on_rows((known, sent), ch,
                lambda kv, sv: run(kv, sv, alive[ch], alive_n[ch], slot, qv,
                                   qn, kn_c))
        if counted:
            sel = torch.as_tensor(ch, dtype=I64, device=dev)
            rej = rej.index_add(0, sel, counted[0])
    return rej


# -- the compressed round ------------------------------------------------------

def compressed_step(sims, state, draws):
    """One compressed round of the group ``state`` (every tensor field
    with a leading ``[B]``; a tuple of B equal round indices): each
    scenario's own ``CompressedSim._step`` (``sims``, one a scenario of
    the group, each with its static knobs) on its views, the fused
    publish gather launching once per scenario on its ``cache_*[s]``.
    Returns the new batched state."""
    from sidecar_tpu_torch.fleet.engine import scenario_state, stack_states

    return stack_states([sim._step(scenario_state(state, j), d)
                         for j, (sim, d) in enumerate(zip(sims, draws))])


def compressed_convergence(sims, state):
    """Each scenario's ``CompressedSim.convergence``, float32 ``[S]``:
    the unbatched metric of each scenario's sim on its views (its census
    path is a host decision per scenario)."""
    from sidecar_tpu_torch.fleet.engine import scenario_state

    return torch.stack([sim.convergence(scenario_state(state, i))
                        for i, sim in enumerate(sims)])


def compressed_census(sim, state, kn):
    """Each scenario's pre-round offer census over its eligible cache
    lines: ``(frontier, exchange_bytes)``, int32 ``[B]`` each."""
    p = sim.p
    per_row = kernel_ops.eligible_lines(
        state.cache_slot, state.cache_sent, kn.rows("limit", 1, 3)).sum(
        dim=2, dtype=I64).to(I32)
    frontier = (per_row > 0).sum(dim=1, dtype=I64).to(I32)
    budget = min(p.budget, p.cache_lines)
    recs = torch.clamp(per_row, max=budget).sum(dim=1, dtype=I64).to(I32)
    return frontier, recs * (p.fanout * RECORD_WIRE_BYTES)
