"""FleetSim — the scenario-fleet driver, the port of
``sidecar_tpu/fleet/engine.py``: S independent scenarios of one
:class:`~sidecar_tpu_torch.fleet.batch.ScenarioBatch` advance together
(``fleet/rounds.py``): one batched round a round for the whole batch on
the exact family (plain, or under a shared FaultPlan), and each
scenario's own ``CompressedSim`` round on the compressed family.

Each scenario draws from a ``torch.Generator`` of its own, seeded with
its spec's seed, through its unbatched sim's own ``draw`` with its own
static knobs (so whether a round draws a loss mask or a push-pull
partner is that scenario's decision); the tests feed the reference's
draws in instead (``draws=``, one sequence a scenario).

Early exit (the converged-mask contract): with ``stop=True`` a scenario
that crossed ``1 − eps`` at a convergence sample is frozen — its state,
curve, round count and byte accounting stop advancing, because the
rounds run only the live scenarios — and once every scenario has
crossed, the remaining rounds are skipped.  The live mask stays on the
device; knowing which scenarios to run costs one host read of it per
convergence sample (``FleetRun.host_reads``).  ``stop=False`` runs the
full horizon: each row then equals its unbatched run.

Over ranks — the reference's ``fleet_mesh(sd, nd)``, a ``("scenario",
"node")`` layout: with ``group=`` (a shard group of the ``world`` ranks,
``parallel/dist.py``) and ``node_devices=nd`` the ranks form ``sd =
world / nd`` scenario blocks of ``nd`` consecutive ranks, as the
reference reshapes its devices ``(sd, nd)``: rank ``r`` holds scenario
block ``r // nd`` (``S / sd`` scenarios, contiguous) and node block ``r
% nd`` (``N / nd`` rows of each of them).  With ``nd = 1`` each rank
runs its scenarios through the batched round and exchanges nothing
while it runs.  With ``nd > 1`` (the exact and chaos families only, as
in the reference) the ``nd`` ranks of a block form its node group
(``group.split(nd)``; every rank builds every block's group, in block
order) and run the round on their rows together (``fleet/rounds.py``
:class:`~sidecar_tpu_torch.fleet.rounds.NodeBlock`): the liveness
gathered, the deliveries routed to their rows' ranks, the push-pull
partner rows fetched and folded back, the census and convergence reduced
over the node group.  Every leaf whose second axis is ``N`` holds the
rank's rows (``known``, ``sent``, ``node_alive``, ``origin_violations``;
``first_seen``'s last axis); each chaos ring its senders' lanes; each
counter its senders' counts.

The whole world gathers the live mask at each convergence sample (so
the early exit decides from every scenario's), at the end every
per-scenario row — curves, rounds, crossings, bytes, frontiers,
``first_seen`` — and, when the first ``table(...)`` or
``digest_agreement`` asks (on every rank: it is collective), the
end-state digest agreement (on the node axis each rank digests its own
alive rows and the node group gathers the digests, never a scenario's
``[N, M]`` belief), so each rank's ``table(...)`` equals the
one-process run's, row for row.  The final states stay rank-local:
``convert.join_state`` joins the ranks' parts (``fleet_state_to_numpy``
of each, with ``node_devices=``) into the one-process state.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Optional

import numpy as np
import torch

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.fleet import rounds as fleet_rounds
from sidecar_tpu_torch.fleet.batch import (
    ScenarioBatch,
    churn_seed,
    restart_churn_perturb,
)
from sidecar_tpu_torch.fleet.rounds import NodeBlock
from sidecar_tpu_torch.ops import provenance as prov_ops
from sidecar_tpu_torch.ops.topology import Topology, complete, from_name

I32, I64 = torch.int32, torch.int64
F32 = torch.float32


@dataclasses.dataclass
class FleetStats:
    """Per-scenario summary accumulators of a run — the flight
    recorder's census columns, folded: ``rounds`` executed (host ints),
    the first round at ``1 − eps`` (-1 before), the analytic offer bytes
    (float32, summed a round at a time as the reference sums them), the
    sender-frontier high-water mark, and the provenance plane's
    ``first_seen`` of the tracked slots (int32 ``[S, T, N]``, -1 where
    not reached) against their pinned keys ``prov_ref`` (``[S, T]``)."""

    rounds: list
    eps_round: torch.Tensor       # int32 [S]
    exchange_bytes: torch.Tensor  # float32 [S]
    frontier_max: torch.Tensor    # int32 [S]
    prov_ref: torch.Tensor        # int32 [S, T]
    first_seen: torch.Tensor      # int32 [S, T, N]


@dataclasses.dataclass
class FleetRun:
    """Host-side result of one fleet dispatch."""

    names: list
    convergence: np.ndarray       # [R // conv_every, S]
    rounds: np.ndarray            # [S] executed rounds
    eps_round: list               # [S] Optional[int]
    exchange_bytes: np.ndarray    # [S] analytic offer bytes (to freeze)
    frontier_max: np.ndarray      # [S]
    conv_every: int
    wall_seconds: float
    scenarios_per_sec: float
    final_states: object = None   # the batched final state
    tracked: tuple = ()           # traced slots (ops/provenance.py)
    first_seen: np.ndarray = None  # [S, T, N] absolute rounds; -1
    host_reads: dict = dataclasses.field(default_factory=dict)
    # Host reads the run made: "live" (one a convergence sample with
    # stop=True) and "stride" (a compressed push-pull partner a scenario
    # a push-pull round, drawn on a CUDA generator).
    belief_fn: object = None      # i -> (final [N, M] belief, alive [N])
    # Over ranks: a collective giving every scenario's digest agreement,
    # run by the first digest_agreement call (every rank must ask, as
    # table() does).
    gather_digests: object = None
    _digests: dict = dataclasses.field(default_factory=dict)

    def lag_summary(self, i: int):
        """Scenario ``i``'s pooled per-record lag CDF, or None when the
        run traced nothing."""
        if not self.tracked:
            return None
        return prov_ops.pooled_lag(self.first_seen[i])

    def digest_agreement(self, i: int) -> Optional[float]:
        """Scenario ``i``'s end-state coherence: the fraction of alive
        nodes whose catalog digest (:func:`row_digests` of the final
        belief) matches the modal digest — 1.0 iff every alive node holds
        the same catalog."""
        if self.gather_digests is not None:
            self._digests, self.gather_digests = self.gather_digests(), None
        if i in self._digests:
            return self._digests[i]
        if self.belief_fn is None:
            return None
        self._digests[i] = agreement(*self.belief_fn(i))
        return self._digests[i]

    def table(self, round_ticks: int, ticks_per_second: int) -> list:
        """Per-scenario rows for the sweep's Pareto table."""
        out = []
        for i, name in enumerate(self.names):
            er = self.eps_round[i]
            lag = self.lag_summary(i)
            out.append({
                "name": name,
                "rounds_to_eps": er,
                "seconds_to_eps": (er * round_ticks / ticks_per_second
                                   if er is not None else None),
                "exchange_bytes": int(self.exchange_bytes[i]),
                "frontier_max": int(self.frontier_max[i]),
                "rounds_run": int(self.rounds[i]),
                "final_convergence": float(self.convergence[-1, i])
                if len(self.convergence) else None,
                "p99_lag_rounds": None if lag is None else lag["p99"],
                "digest_agreement": self.digest_agreement(i),
            })
        return out


# Cells of the belief a digest block hashes at once (its int64
# temporaries are a few times this many words).
DIGEST_BLOCK_CELLS = 1 << 24


def row_digests(known, alive) -> np.ndarray:
    """The catalog digests of the alive rows of ``known`` (int32 ``[N,
    M]``), uint32 ``[A, B, 2]`` on the host: on the card
    ``ops/digest.node_digests``, a block of rows at a time; on the CPU
    the reference's ``node_digests_np`` over those rows, which it
    equals (and which is the faster of the two there)."""
    from sidecar_tpu_torch.ops import digest as digest_ops

    m = known.shape[1]
    if known.device.type != "cuda":
        return digest_ops.node_digests_np(
            known.cpu().numpy()[alive.cpu().numpy().astype(bool)],
            digest_ops.default_idents(m))
    idents = torch.as_tensor(digest_ops.default_idents(m).astype(np.int64),
                             device=known.device)
    rows = torch.nonzero(alive.to(known.device)).reshape(-1)
    per = max(1, DIGEST_BLOCK_CELLS // max(1, m))
    parts = [digest_ops.node_digests(known[rows[a:a + per]], idents,
                                     digest_ops.DEFAULT_BUCKETS).cpu()
             for a in range(0, rows.numel(), per)]
    if not parts:
        return np.zeros((0, digest_ops.DEFAULT_BUCKETS, 2), np.uint32)
    return torch.cat(parts).numpy().astype(np.uint32)


def agreement(known, alive) -> Optional[float]:
    """The modal share of the alive rows' digests of ``known`` (None
    when no row is alive)."""
    digs = row_digests(known, alive)
    return modal_share(digs) if len(digs) else None


def modal_share(digs) -> float:
    """The fraction of the rows of ``digs`` (one digest a node) equal to
    the most common one."""
    counts: dict = {}
    for d in digs:
        k = d.tobytes()
        counts[k] = counts.get(k, 0) + 1
    return max(counts.values()) / len(digs)


# -- batched states ------------------------------------------------------------

def _is_all(idx, s: int) -> bool:
    return len(idx) == s and list(idx) == list(range(s))


def take_state(state, idx, s: int):
    """The scenarios at positions ``idx`` of a batched state: the state
    itself for all of them, slices for a run of consecutive positions,
    else copies (``put_state`` writes them back)."""
    if _is_all(idx, s):
        return state
    a, b = idx[0], idx[-1] + 1
    run = list(idx) == list(range(a, b))
    sel = None if run else torch.as_tensor(idx, dtype=I64)

    def take(v):
        if isinstance(v, torch.Tensor):
            return v[a:b] if run else v[sel.to(v.device)]
        return v

    return _map_state(state, take, lambda r: tuple(r[i] for i in idx))


def put_state(state, idx, sub, s: int):
    """Write the group ``sub`` (from :func:`take_state`) back into
    ``state`` at positions ``idx``; returns the batched state."""
    if _is_all(idx, s):
        return sub
    a, b = idx[0], idx[-1] + 1
    run = list(idx) == list(range(a, b))
    sel = None if run else torch.as_tensor(idx, dtype=I64)
    pairs = []
    _pair_leaves(state, sub, pairs)
    for full, part in pairs:
        dst = full[a:b] if run else None
        if run:
            if dst.data_ptr() != part.data_ptr():
                dst.copy_(part)
        else:
            full[sel.to(full.device)] = part
    rnd = list(state_rounds(state))
    for j, i in enumerate(idx):
        rnd[i] = state_rounds(sub)[j]
    return _map_state(state, lambda v: v, lambda r: tuple(rnd))


def state_rounds(state) -> tuple:
    """The per-scenario round indices of a batched state."""
    return state.sim.round_idx if hasattr(state, "rings") else \
        state.round_idx


def _map_state(state, fn, fn_round):
    """A copy of ``state`` with ``fn`` applied to every tensor leaf (the
    rings' too) and ``fn_round`` to the round-index tuple."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "round_idx":
            kw[f.name] = fn_round(v)
        elif f.name == "sim":
            kw[f.name] = _map_state(v, fn, fn_round)
        elif f.name == "rings":
            kw[f.name] = tuple(tuple(fn(x) for x in ring) for ring in v)
        else:
            kw[f.name] = fn(v)
    return dataclasses.replace(state, **kw)


def _pair_leaves(a, b, out):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "sim":
            _pair_leaves(x, y, out)
        elif f.name == "rings":
            for ra, rb in zip(x, y):
                out.extend(zip(ra, rb))
        elif isinstance(x, torch.Tensor):
            out.append((x, y))


def stack_states(parts):
    """S unbatched states (one dataclass each) as one batched state."""
    first = parts[0]
    kw = {}
    for f in dataclasses.fields(first):
        vals = [getattr(p, f.name) for p in parts]
        if f.name == "round_idx":
            kw[f.name] = tuple(int(v) for v in vals)
        elif f.name == "sim":
            kw[f.name] = stack_states(vals)
        elif f.name == "rings":
            kw[f.name] = tuple(
                tuple(torch.stack([v[i][j] for v in vals])
                      for j in range(len(first.rings[i])))
                for i in range(len(first.rings)))
        else:
            kw[f.name] = torch.stack(vals).contiguous()
    return dataclasses.replace(first, **kw)


def scenario_state(state, i: int):
    """Scenario ``i``'s unbatched state: views of the batched one."""
    return _map_state(state, lambda v: v[i] if isinstance(
        v, torch.Tensor) else v, lambda r: int(r[i]))


def clone_batched(state):
    return _map_state(state, lambda v: v.clone() if isinstance(
        v, torch.Tensor) else v, lambda r: tuple(r))


# -- the driver ----------------------------------------------------------------

class FleetSim:
    """S scenarios of one :class:`ScenarioBatch`, advanced together on the
    batch's device.  ``perturb`` overrides the knob-driven churn hook a
    batch with churn gets (``restart_churn_perturb``, its generators
    seeded by ``churn_seed(spec.seed)``).  ``group`` (every rank of the
    world) and ``node_devices`` lay the scenarios and their nodes over
    the ranks (see the module docstring): ``batch`` is then this rank's
    scenario block, ``names`` every scenario's, ``nodes`` its node
    block.  Over ranks a given ``perturb`` must be a knob-aware,
    row-local hook over the whole batch (``restart_churn_perturb(p,
    masks=…)``: each scenario finds its masks by its index in the
    whole batch)."""

    def __init__(self, batch: ScenarioBatch, topo: Optional[Topology] = None,
                 *, perturb=None, group=None, node_devices: int = 1):
        nd = int(node_devices)
        world = 1 if group is None else group.world
        if nd < 1 or world % nd:
            raise ValueError(f"node_devices={nd} must divide the group's "
                             f"{world} ranks")
        sd = world // nd
        if batch.size % sd:
            raise ValueError(
                f"batch size {batch.size} must divide the scenario mesh "
                f"axis ({sd})")
        if nd > 1 and batch.family != "exact":
            raise ValueError(
                "the node mesh axis composes on the exact family only "
                "(compressed state is not node-major on every leaf); use "
                "node_devices=1")
        if nd > 1 and batch.params.n % nd:
            raise ValueError(
                f"n={batch.params.n} must divide the node mesh axis ({nd})")
        self.group = group
        self.node_devices = nd
        self.names = [sp.name for sp in batch.specs]
        self.scenarios = range(batch.size)
        seeds = [churn_seed(s.seed) for s in batch.specs]
        node_group = None
        if world > 1:
            if perturb is not None and not (
                    getattr(perturb, "wants_knobs", False)
                    and getattr(perturb, "row_local", False)):
                raise ValueError(
                    "over ranks a given perturb hook must be knob-aware "
                    "and row_local (restart_churn_perturb(params, "
                    "masks=...)): it runs on a rank's scenarios and rows")
            per = batch.size // sd
            blk = group.rank // nd
            self.scenarios = range(blk * per, (blk + 1) * per)
            batch = ScenarioBatch.build(
                batch.specs[self.scenarios.start:self.scenarios.stop],
                batch.params, batch.timecfg, family=batch.family,
                plan=batch.plan, device=batch.device)
            # The hooks find a scenario by its index in the whole batch.
            batch.knobs = dataclasses.replace(batch.knobs,
                                              scen=tuple(self.scenarios))
            if nd > 1:
                node_group = group.split(nd)
        self.batch = batch
        p = batch.params
        dev = batch.device
        self.nodes = NodeBlock(p.n, node_group)
        if topo is None:
            topo = (from_name(batch.topology, p.n) if batch.topology
                    else complete(p.n))
        self.topo = topo
        if perturb is None and batch.has_churn:
            perturb = restart_churn_perturb(p, seeds=seeds)
        self.perturb = perturb
        if batch.family == "exact":
            if batch.plan is not None:
                from sidecar_tpu_torch.chaos.sim_inject import ChaosExactSim
                self.sim = ChaosExactSim(p, topo, batch.timecfg,
                                         plan=batch.plan, device=dev)
                self.family = "chaos"
            else:
                from sidecar_tpu_torch.models.exact import ExactSim
                self.sim = ExactSim(p, topo, batch.timecfg, device=dev)
                self.family = "exact"
        else:
            from sidecar_tpu_torch.models.compressed import CompressedSim

            def scenario_sim(i):
                period, phase = batch.scenario_cadence(i)
                return CompressedSim(
                    batch.scenario_params(i), topo, batch.scenario_timecfg(i),
                    device=dev, tick_period=period, tick_phase=phase)

            # The compressed round is each scenario's own sim's round.
            self.scenario_sims = [scenario_sim(i)
                                  for i in range(batch.size)]
            self.sim = self.scenario_sims[0]
            self.family = "compressed"
        # Each scenario's draw: its unbatched sim's own ``draw`` on a view
        # holding its static params and knobs.
        self._views = self.scenario_sims if self.family == "compressed" \
            else [types.SimpleNamespace(
                p=batch.scenario_params(i), _knobs=batch.knobs.host[i],
                _deg=self.sim._deg) for i in range(batch.size)]
        self.generators = batch.generators()

    @property
    def device(self):
        return self.batch.device

    # -- state construction -------------------------------------------------

    def init_states(self):
        """The batched initial state: a cold start on the exact family,
        the converged boot plus each scenario's mint burst on the
        compressed family."""
        b = self.batch
        parts = []
        for i in range(b.size):
            sim = self._views[i] if b.family == "compressed" else self.sim
            st = sim.init_state()
            slots = b.mint_slots(i) if b.family == "compressed" else None
            if slots is not None:
                st = sim.mint(st, slots, b.specs[i].mint_tick)
            parts.append(self._block_rows(st))
        return stack_states(parts)

    def _block_rows(self, st):
        """This rank's node block of an unbatched state: the rows of the
        node-major leaves, its senders' lanes of each chaos ring."""
        ax = self.nodes
        if ax.whole:
            return st
        if hasattr(st, "rings"):
            lanes = st.rings[0][0].shape[1] // ax.n if st.rings else 0
            return dataclasses.replace(
                st, sim=self._block_rows(st.sim),
                rings=tuple(tuple(t[:, ax.lo * lanes:ax.hi * lanes].clone()
                                  for t in ring) for ring in st.rings),
                origin_violations=st.origin_violations[ax.rows].clone())
        return dataclasses.replace(
            st, known=st.known[ax.rows].clone(), sent=st.sent[ax.rows].clone(),
            node_alive=st.node_alive[ax.rows].clone())

    # -- one round ----------------------------------------------------------

    def draw(self, i: int, round_idx: int):
        """Scenario ``i``'s draws for the round that advances it to
        ``round_idx``, from its generator."""
        return type(self.sim).draw(self._views[i], self.generators[i],
                                   round_idx)

    def fault_draw(self, i: int, round_idx: int):
        """Scenario ``i``'s fault draws (the chaos family), rooted at its
        fault seed."""
        return self.sim._prog.draw(round_idx,
                                   self.batch.knobs.host[i].fault_seed,
                                   fanout=self.batch.params.fanout)

    def _step(self, sub, grp, draws, faults):
        """One round of the scenarios at ``grp``, whose state is ``sub``."""
        if self.family == "compressed":
            return fleet_rounds.compressed_step(
                [self.scenario_sims[i] for i in grp], sub, draws)
        kn = self.batch.knobs.take(grp)
        if self.family == "exact":
            return fleet_rounds.exact_step(self.sim, sub, draws, kn,
                                           self.perturb, self.nodes)
        return fleet_rounds.chaos_step(self.sim, sub, draws, faults, kn,
                                       self.perturb, self.nodes)

    def convergence(self, state):
        """Each scenario's convergence metric, float32 ``[S]``."""
        if self.family == "compressed":
            return fleet_rounds.compressed_convergence(self.scenario_sims,
                                                       state)
        st = state.sim if self.family == "chaos" else state
        return fleet_rounds.exact_convergence(st.known, st.node_alive,
                                              self.nodes)

    def _census(self, state, idx):
        """The pre-round offer census of the scenarios at ``idx``."""
        kn = self.batch.knobs.take(idx)
        sub = take_state(state, idx, self.batch.size)
        if self.family == "compressed":
            return fleet_rounds.compressed_census(self.sim, sub, kn)
        st = sub.sim if self.family == "chaos" else sub
        return fleet_rounds.exact_census(self.sim, st.known, st.sent, kn,
                                         self.nodes)

    def _prov_belief(self, state, tracked, idx):
        """Packed ``[len(idx), N_l, T]`` belief of the tracked slots (the
        node block's rows)."""
        if self.family == "compressed":
            return torch.stack([
                self.scenario_sims[i]._prov_belief(scenario_state(state, i),
                                                   tracked)
                for i in idx])
        st = state.sim if self.family == "chaos" else state
        sel = torch.as_tensor(list(idx), dtype=I64, device=st.known.device)
        return st.known[sel][:, :, tracked.to(I64)]

    # -- the driver ----------------------------------------------------------

    def run(self, states, num_rounds: int, conv_every: int = 1,
            eps: float = 0.01, stop: bool = False, donate: bool = True,
            curve: bool = True, tracked=None, draws=None,
            fault_draws=None) -> FleetRun:
        """Run every scenario ``num_rounds`` rounds (fewer where the
        converged mask freezes them, ``stop=True``), sampling each
        scenario's convergence every ``conv_every`` rounds.

        ``stop=False`` runs the full horizon (each row equals its
        unbatched run); ``eps`` still sets where ``eps_round`` is
        recorded.  ``tracked`` (service slots) turns on the provenance
        plane's ``first_seen``.  ``draws`` (and, on the chaos family,
        ``fault_draws``): one sequence a scenario of the whole batch,
        consumed a round at a time as that scenario runs, in place of its
        generator (its fault seed).  The state is updated in place unless
        ``donate=False``."""
        b = self.batch
        ranks = self.group is not None and self.group.world > 1
        mine = slice(self.scenarios.start, self.scenarios.stop)
        # This rank's block of a world-gathered [world · S_l] row.
        gathered = slice(self.group.rank * b.size,
                         (self.group.rank + 1) * b.size) if ranks else None
        if draws is not None:
            draws = list(draws)[mine]
        if fault_draws is not None:
            fault_draws = list(fault_draws)[mine]
        s_n = b.size
        p = b.params
        dev = self.device
        tracked = tuple(int(x) for x in tracked) if tracked else ()
        for slot in tracked:
            if not 0 <= slot < p.m:
                raise ValueError(
                    f"tracked slot {slot} outside [0, {p.m})")
        if num_rounds % conv_every:
            raise ValueError(
                f"num_rounds={num_rounds} not divisible by "
                f"conv_every={conv_every}")
        start = max(state_rounds(states))
        b.timecfg.validate_horizon(start + num_rounds,
                                   skew_ticks=getattr(self.sim,
                                                      "_skew_ticks", 0))
        if not donate:
            states = clone_batched(states)
        draw_it = None if draws is None else [iter(d) for d in draws]
        fault_it = None if fault_draws is None else \
            [iter(d) for d in fault_draws]
        stride_reads = [0]

        def scenario_draw(i, r):
            if draw_it is not None:
                return next(draw_it[i])
            d = self.draw(i, r)
            if d.stride and self.generators[i].device.type == "cuda":
                stride_reads[0] += 1
            return d

        def scenario_fault(i, r):
            if self.family != "chaos":
                return None
            if fault_it is not None:
                return next(fault_it[i])
            return self.fault_draw(i, r)

        t0 = time.perf_counter()
        tr = torch.as_tensor(tracked, dtype=I64, device=dev)
        fs = self._seed_stats(states, tr)
        live = torch.ones(s_n, dtype=torch.bool, device=dev)
        live_host = [True] * s_n
        samples = []
        live_reads = 0
        for _ in range(num_rounds // conv_every):
            for _ in range(conv_every):
                idx = [i for i in range(s_n) if live_host[i]]
                if not idx:
                    break       # the whole-batch skip
                frontier, xbytes = self._census(states, idx)
                groups: dict = {}
                rnd = state_rounds(states)
                for i in idx:
                    groups.setdefault(rnd[i], []).append(i)
                for r0, grp in sorted(groups.items()):
                    sub = take_state(states, grp, s_n)
                    ds = [scenario_draw(i, r0 + 1) for i in grp]
                    fds = [scenario_fault(i, r0 + 1) for i in grp]
                    sub = self._step(sub, grp, ds, fds)
                    states = put_state(states, grp, sub, s_n)
                sel = torch.as_tensor(idx, dtype=I64, device=dev)
                fs.exchange_bytes.index_add_(0, sel, xbytes.to(F32))
                fs.frontier_max[sel] = torch.maximum(fs.frontier_max[sel],
                                                     frontier)
                for i in idx:
                    fs.rounds[i] += 1
                if tracked:
                    self._observe(states, tr, fs, idx)
            conv = self.convergence(states)
            rounds_t = torch.as_tensor(fs.rounds, dtype=I32, device=dev)
            crossed = live & (conv >= 1.0 - eps) & (fs.eps_round < 0)
            fs.eps_round = torch.where(crossed, rounds_t, fs.eps_round)
            if stop:
                live = live & (conv < 1.0 - eps)
                # Over ranks: decided from every scenario's live mask.
                live_host = (self.group.gather_rows(live).tolist()[gathered]
                             if ranks else live.tolist())
                live_reads += 1
            if curve:
                samples.append(conv)
        conv_t = torch.stack(samples) if samples else \
            torch.zeros((0, s_n), dtype=F32, device=dev)
        wall = time.perf_counter() - t0
        if ranks:
            fs, conv_t, wall, stride_reads[0] = self._gather_rows(
                fs, conv_t, wall, stride_reads[0])
        conv_np = conv_t.cpu().numpy()
        eps_np = fs.eps_round.cpu().numpy()

        rounds = np.asarray(fs.rounds, dtype=np.int32)
        s_n = len(rounds)
        metrics.incr("fleet.batches")
        metrics.incr("fleet.scenarios", s_n)
        metrics.incr("fleet.rounds", int(rounds.sum()))
        metrics.incr("fleet.rounds_saved",
                     int(s_n * num_rounds - rounds.sum()))
        if self.family == "chaos":
            # The chaos fleet publishes the batch's injection totals, as
            # the reference's does (a node block's summed over its node
            # group).
            totals = self.nodes.sum(torch.stack([
                getattr(states, f).sum(dtype=I64) for f in
                ("injected_drops", "injected_delays",
                 "injected_dups")])).tolist()
            for name, total in zip(("chaos.sim.droppedPackets",
                                    "chaos.sim.delayedPackets",
                                    "chaos.sim.duplicatedPackets"), totals):
                if total:
                    metrics.incr(name, total)
        belief_fn = None if ranks else self._belief_fn(states)
        run = FleetRun(
            names=list(self.names),
            convergence=conv_np,
            rounds=rounds,
            eps_round=[int(r) if r >= 0 else None for r in eps_np],
            exchange_bytes=fs.exchange_bytes.cpu().numpy(),
            frontier_max=fs.frontier_max.cpu().numpy(),
            conv_every=conv_every,
            wall_seconds=wall,
            scenarios_per_sec=s_n / wall if wall > 0 else 0.0,
            final_states=states,
            tracked=tracked,
            first_seen=fs.first_seen.cpu().numpy(),
            host_reads={"live": live_reads, "stride": stride_reads[0]},
            belief_fn=belief_fn,
        )
        if ranks:
            run.gather_digests = lambda: self._gather_digests(states)
        return run

    def _world_rows(self, x):
        """Every scenario block's rows ``x`` (``[S_l, …]``, equal on the
        ranks of a node group) gathered over the world, in scenario
        order."""
        g, nd = self.group, self.node_devices
        y = g.gather_rows(x)
        if nd == 1:
            return y
        tail = tuple(x.shape[1:])
        s_n = self.batch.size
        return y.reshape((g.world // nd, nd, s_n) + tail)[:, 0].reshape(
            (g.world // nd * s_n,) + tail)

    def _gather_digests(self, states) -> dict:
        """Every scenario's end-state digest agreement over ranks, by
        scenario: each rank's scenarios from its states (on the node axis
        from the node group's digests of its rows), gathered."""
        s_n = self.batch.size
        if self.nodes.whole:
            belief = self._belief_fn(states)
            agree = [agreement(*belief(i)) for i in range(s_n)]
        else:
            agree = [self._block_digest_agreement(states, i)
                     for i in range(s_n)]
        agree = self._world_rows(torch.tensor(
            [np.nan if a is None else a for a in agree],
            dtype=torch.float64, device=self.device)).tolist()
        return {i: None if a != a else a for i, a in enumerate(agree)}

    def _gather_rows(self, fs, conv_t, wall: float, stride_reads: int):
        """Every rank's per-scenario rows of a run, in scenario order: the
        stats and the curve; the slowest rank's wall and the ranks'
        stride reads summed."""
        g, dev, ax = self.group, self.device, self.nodes
        rows = self._world_rows
        # first_seen [S_l, T, N_l]: the node group's nodes, then the rows.
        first_seen = ax.gather(fs.first_seen.transpose(1, 2)).transpose(1, 2)
        rounds = rows(torch.as_tensor(fs.rounds, dtype=I32,
                                      device=dev)).tolist()
        fs = dataclasses.replace(
            fs, rounds=rounds,
            eps_round=rows(fs.eps_round),
            exchange_bytes=rows(fs.exchange_bytes),
            frontier_max=rows(fs.frontier_max),
            prov_ref=rows(fs.prov_ref),
            first_seen=rows(first_seen.contiguous()))
        conv_t = rows(conv_t.T.contiguous()).T
        extra = g.all_reduce_max(torch.tensor(
            [wall], dtype=torch.float64, device=dev))
        reads = g.all_reduce_sum(torch.tensor(
            [stride_reads], dtype=torch.int64, device=dev))
        return fs, conv_t, float(extra[0]), int(reads[0])

    def _block_digest_agreement(self, states, i: int) -> Optional[float]:
        """Scenario ``i``'s digest agreement on the node axis: this rank
        digests its own alive rows (a node's digest reads only its row),
        the node group gathers the ``[N]`` digests and the liveness, and
        the modal share is taken over the alive nodes."""
        from sidecar_tpu_torch.ops import digest as digest_ops

        st = states.sim if self.family == "chaos" else states
        ng = self.nodes.group
        alive = st.node_alive[i].cpu().numpy().astype(bool)
        digs = np.zeros((len(alive), digest_ops.DEFAULT_BUCKETS, 2),
                        np.uint32)
        digs[alive] = row_digests(st.known[i], st.node_alive[i])
        lanes = torch.as_tensor(digs.view(np.int32).reshape(len(digs), -1),
                                device=self.device)
        every = ng.gather_rows(lanes).cpu().numpy().view(np.uint32)
        every_alive = ng.gather_rows(st.node_alive[i]).cpu().numpy()
        picked = every[every_alive.astype(bool)]
        return modal_share(picked) if len(picked) else None

    def _belief_fn(self, states):
        """``i -> (final [N, M] belief, alive [N])`` of this sim's
        scenario ``i``."""
        if self.family == "compressed":
            def belief_fn(i, st=states):
                return (self.scenario_sims[i]._delta_belief(
                    scenario_state(st, i)), st.node_alive[i])
            return belief_fn
        st_x = states.sim if self.family == "chaos" else states

        def belief_fn(i, st=st_x):
            return st.known[i], st.node_alive[i]
        return belief_fn

    def _seed_stats(self, states, tr) -> FleetStats:
        """Zero stats, with the provenance plane seeded: each scenario's
        tracked refs pinned to the freshest current keys and the origin
        holders marked at its round."""
        s_n, n, dev = self.batch.size, self.nodes.nl, self.device
        t = tr.numel()
        fs = FleetStats(rounds=[0] * s_n,
                        eps_round=torch.full((s_n,), -1, dtype=I32,
                                             device=dev),
                        exchange_bytes=torch.zeros(s_n, dtype=F32,
                                                   device=dev),
                        frontier_max=torch.zeros(s_n, dtype=I32, device=dev),
                        prov_ref=torch.zeros((s_n, t), dtype=I32, device=dev),
                        first_seen=torch.full((s_n, t, n), -1, dtype=I32,
                                              device=dev))
        if not t:
            return fs
        belief0 = self._prov_belief(states, tr, range(s_n))  # [S, N_l, T]
        fs.prov_ref = self.nodes.max(belief0.amax(dim=1).to(I32))
        hold0 = prov_ops.holders_batch(fs.prov_ref, belief0)
        rnd = torch.as_tensor(state_rounds(states), dtype=I32, device=dev)
        fs.first_seen = torch.where(hold0.transpose(1, 2),
                                    rnd[:, None, None], fs.first_seen)
        return fs

    def _observe(self, states, tr, fs, idx):
        """Mark the tracked records' first holders after a round of the
        scenarios at ``idx``."""
        dev = self.device
        sel = torch.as_tensor(idx, dtype=I64, device=dev)
        hold = prov_ops.holders_batch(fs.prov_ref[sel],
                                      self._prov_belief(states, tr, idx))
        first = fs.first_seen[sel]
        newly = hold.transpose(1, 2) & (first < 0)
        rnd = torch.as_tensor([state_rounds(states)[i] for i in idx],
                              dtype=I32, device=dev)
        fs.first_seen[sel] = torch.where(newly, rnd[:, None, None], first)


def cpu_inputs(batch: ScenarioBatch, rounds: int):
    """One set of inputs for ``rounds`` rounds of ``batch``, drawn on the
    CPU, so that a run fed them gives the same result on any device:
    each scenario's round draws and, under a plan, its fault draws, as
    a copy of the batch on the CPU draws them, and a churn hook
    replaying each churning scenario's masks (``sim/scenarios``
    ``churn_masks`` seeded with ``churn_seed(spec.seed)``).  Returns
    ``(draws, fault_draws, perturb)`` for
    ``FleetSim(batch, perturb=perturb).run(..., draws=draws,
    fault_draws=fault_draws)``."""
    from sidecar_tpu_torch.sim.scenarios import churn_masks

    cpu_b = ScenarioBatch.build(batch.specs, batch.params, batch.timecfg,
                                family=batch.family, plan=batch.plan,
                                device="cpu")
    probe = FleetSim(cpu_b)
    span = range(1, rounds + 1)
    draws = [[probe.draw(i, r) for r in span] for i in range(batch.size)]
    faults = None if batch.plan is None else [
        [probe.fault_draw(i, r) for r in span] for i in range(batch.size)]
    perturb = None
    if batch.has_churn:
        perturb = restart_churn_perturb(batch.params, masks=[
            churn_masks(batch.params.m, s.churn_prob, (1, rounds + 1),
                        churn_seed(s.seed)) if s.churn_prob > 0 else None
            for s in batch.specs])
    return draws, faults, perturb
