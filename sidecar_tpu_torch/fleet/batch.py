"""ScenarioBatch: S scenarios' protocol knobs stacked for the fleet — the
port of ``sidecar_tpu/fleet/batch.py``.

A :class:`ScenarioSpec` is ONE scenario's configuration in host terms
(seconds, probabilities, seeds).  :meth:`ScenarioBatch.build` validates
S of them against a shared base (``SimParams`` / ``CompressedParams`` +
``TimeConfig`` + an optional ``FaultPlan`` structure), with the
reference's named errors, and stacks the data axes into
:class:`~sidecar_tpu_torch.ops.knobs.BatchedKnobs` on the batch's
device: ``[S]`` tensors beside the S host knob bundles.  The reference's
per-scenario PRNG keys become per-scenario ``torch.Generator`` seeds
(:meth:`ScenarioBatch.generators`).

Axes that shape the program — ``fanout``, ``budget``, ``n``,
``services_per_node``, ``cache_lines``, the topology and the FaultPlan
structure — must be batch-uniform; everything else (transmit limit,
loss, cadences, suspicion window, lifespans, churn, fault seed, tick
cadence) varies freely within a batch.

Equality contract (``tests/test_torch_fleet.py``): scenario *i* of a
fleet run equals an unbatched run of the matching sim —
``scenario_params(i)``, ``scenario_timecfg(i)``, ``scenario_cadence(i)``
and ``scenario_plan(i)`` build exactly that sim, its draws come from
``generators()[i]``, and :func:`restart_churn_perturb` with a static
``prob`` (and ``seed=churn_seed(spec.seed)``) is the unbatched twin of
the fleet's knob-driven churn hook.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

import numpy as np
import torch

from sidecar_tpu_torch.models import common
from sidecar_tpu_torch.models.timecfg import TimeConfig
from sidecar_tpu_torch.ops import knobs as knob_ops
from sidecar_tpu_torch.ops.knobs import BatchedKnobs
from sidecar_tpu_torch.ops.status import (
    ALIVE,
    TOMBSTONE,
    pack,
    unpack_status,
    unpack_ts,
)
from sidecar_tpu_torch.sim.scenarios import validate_protocol_config

# TimeConfig fields a spec may override per scenario.
_TIMECFG_FIELDS = (
    "push_pull_interval_s", "sweep_interval_s", "refresh_interval_s",
    "suspicion_window_s", "alive_lifespan_s", "draining_lifespan_s",
    "tombstone_lifespan_s", "future_fudge_s", "origin_budget",
    "origin_quarantine",
)

# _TIMECFG_FIELDS entries where any negative value means "knob off".
_SIGNED_TIMECFG_FIELDS = ("future_fudge_s", "origin_budget",
                          "origin_quarantine")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One scenario of a fleet batch, in host units.

    ``None`` means "inherit the batch base".  ``fanout``/``budget`` may
    be stated but MUST match the batch's params (``fleet/grid.py``
    groups grid points by them, so a mixed grid sweeps them across
    batches)."""

    name: str
    seed: int = 0
    retransmit_limit: Optional[int] = None   # None/0 = params rule
    drop_prob: Optional[float] = None
    churn_prob: float = 0.0          # exact family: per-round restart churn
    fault_seed: Optional[int] = None  # chaos: per-scenario FaultPlan seed
    fanout: Optional[int] = None     # must match the batch
    budget: Optional[int] = None     # must match the batch
    topology: Optional[str] = None   # batch-uniform; ops/topology.from_name
    mint_frac: float = 0.0           # compressed: initial churn burst
    mint_tick: int = 10
    push_pull_interval_s: Optional[float] = None
    sweep_interval_s: Optional[float] = None
    refresh_interval_s: Optional[float] = None
    suspicion_window_s: Optional[float] = None
    alive_lifespan_s: Optional[float] = None
    draining_lifespan_s: Optional[float] = None
    tombstone_lifespan_s: Optional[float] = None
    future_fudge_s: Optional[float] = None   # negative = bound disabled
    origin_budget: Optional[int] = None      # negative = budget disabled
    origin_quarantine: Optional[int] = None  # negative = quarantine off
    tick_period: Optional[int] = None        # rounds between gossip ticks
    tick_phase: Optional[int] = None         # cadence phase offset

    def axes(self) -> dict:
        """The non-default knobs, for report and Pareto tables."""
        out: dict = {}
        for f in dataclasses.fields(self):
            if f.name in ("name",):
                continue
            v = getattr(self, f.name)
            d = f.default
            if v is not None and v != d:
                out[f.name] = v
        return out


def churn_seed(seed: int) -> int:
    """The seed of a scenario's churn generator: a blake2b hash of
    ``("churn", seed)``, apart from the round draws' generator, which the
    scenario seed roots."""
    payload = repr(("churn", int(seed))).encode()
    h = hashlib.blake2b(payload, digest_size=8).digest()
    return int.from_bytes(h, "big") & ((1 << 63) - 1)


@dataclasses.dataclass
class ScenarioBatch:
    """S validated scenarios stacked for one fleet dispatch."""

    family: str                      # "exact" | "compressed"
    params: Any                      # SimParams | CompressedParams (base)
    timecfg: TimeConfig              # batch base clock
    specs: tuple                     # [S] ScenarioSpec
    knobs: BatchedKnobs              # [S] data axes on ``device``
    seeds: tuple                     # [S] round-draw generator seeds
    device: torch.device
    plan: Any = None                 # shared FaultPlan structure, or None
    topology: Optional[str] = None   # batch-uniform overlay name, or None
    #                                  (= complete; ops/topology.from_name)

    @property
    def size(self) -> int:
        return len(self.specs)

    @property
    def has_churn(self) -> bool:
        return any(s.churn_prob > 0 for s in self.specs)

    # -- per-scenario unbatched configs ------------------------------------

    def scenario_params(self, i: int):
        """Scenario ``i``'s static params: the unbatched sim's."""
        s = self.specs[i]
        kw = {}
        if s.retransmit_limit is not None:
            kw["retransmit_limit"] = s.retransmit_limit
        if s.drop_prob is not None:
            kw["drop_prob"] = s.drop_prob
        return dataclasses.replace(self.params, **kw)

    def scenario_timecfg(self, i: int) -> TimeConfig:
        s = self.specs[i]
        kw = {f: getattr(s, f) for f in _TIMECFG_FIELDS
              if getattr(s, f) is not None}
        return dataclasses.replace(self.timecfg, **kw)

    def scenario_cadence(self, i: int) -> tuple:
        """Scenario ``i``'s ``(tick_period, tick_phase)`` for the
        unbatched sim's constructor — ``(1, 0)`` when the spec states
        neither."""
        s = self.specs[i]
        return (s.tick_period if s.tick_period is not None else 1,
                s.tick_phase if s.tick_phase is not None else 0)

    def scenario_plan(self, i: int):
        """Scenario ``i``'s FaultPlan: the shared structure re-seeded
        with its fault seed."""
        if self.plan is None:
            return None
        s = self.specs[i]
        if s.fault_seed is None:
            return self.plan
        return dataclasses.replace(self.plan, seed=s.fault_seed)

    def mint_slots(self, i: int) -> Optional[np.ndarray]:
        """Compressed family: scenario ``i``'s initial churn-burst slots
        (None when the spec mints nothing), from ``default_rng(seed)``
        as the reference draws them."""
        s = self.specs[i]
        if s.mint_frac <= 0:
            return None
        m = self.params.m
        count = max(1, int(m * s.mint_frac))
        rng = np.random.default_rng(s.seed)
        return np.sort(rng.choice(m, size=count,
                                  replace=False)).astype(np.int32)

    def generators(self, device=None) -> list:
        """One ``torch.Generator`` a scenario, seeded with its spec's
        seed, on ``device`` (the batch's by default): the fleet's round
        draws, and its unbatched twins'."""
        dev = self.device if device is None else torch.device(device)
        return [torch.Generator(device=dev).manual_seed(int(s))
                for s in self.seeds]

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, specs, params, timecfg: TimeConfig = TimeConfig(),
              *, family: str = "exact", plan=None,
              device="cuda") -> "ScenarioBatch":
        """Validate ``specs`` against the batch statics and stack the
        knobs on ``device`` (the card unless the caller asks for the
        CPU).  Raises ``ValueError`` naming the offending scenario and
        knob."""
        specs = tuple(specs)
        if not specs:
            raise ValueError("a ScenarioBatch needs at least 1 scenario")
        if family not in ("exact", "compressed"):
            raise ValueError(
                f"family must be 'exact' or 'compressed', got {family!r}")
        if plan is not None and family != "exact":
            raise ValueError(
                "FaultPlan scenarios run on the exact family only "
                "(the chaos plane, sidecar_tpu/chaos/)")
        dev = common.resolve_device(device, "ScenarioBatch")

        seen: set = set()
        for s in specs:
            if s.name in seen:
                raise ValueError(
                    f"duplicate scenario name {s.name!r} in batch (two "
                    "scenarios silently shadowing each other would make "
                    "the sweep report the wrong config's numbers)")
            seen.add(s.name)
            if s.fanout is not None and s.fanout != params.fanout:
                raise ValueError(
                    f"{s.name}: fanout={s.fanout} is a compile-key axis "
                    f"and must equal the batch's fanout={params.fanout} "
                    "(it shapes the sampled-peer tensor; sweep it "
                    "ACROSS batches — fleet/grid.py groups by it)")
            if s.budget is not None and s.budget != params.budget:
                raise ValueError(
                    f"{s.name}: budget={s.budget} is a compile-key axis "
                    f"and must equal the batch's budget={params.budget}")
            if s.topology != specs[0].topology:
                raise ValueError(
                    f"{s.name}: topology={s.topology!r} is a compile-key "
                    "axis (it shapes the neighbor tables baked into the "
                    f"round) and must be batch-uniform; this batch is "
                    f"{specs[0].topology!r} — sweep it ACROSS batches "
                    "(fleet/grid.py groups by it)")
            validate_protocol_config(
                params.n, fanout=params.fanout, budget=params.budget,
                retransmit_limit=s.retransmit_limit or 0,
                services_per_node=params.services_per_node, name=s.name)
            for knob in ("drop_prob", "churn_prob", "mint_frac"):
                v = getattr(s, knob)
                if v is not None and not 0.0 <= v <= 1.0:
                    raise ValueError(
                        f"{s.name}: {knob}={v} not in [0, 1]")
            for f in _TIMECFG_FIELDS:
                v = getattr(s, f)
                if f in _SIGNED_TIMECFG_FIELDS:
                    continue  # any negative value means "knob off"
                if v is not None and v < 0:
                    raise ValueError(f"{s.name}: {f}={v} must be >= 0")
            if s.tick_period is not None and (
                    isinstance(s.tick_period, bool)
                    or not isinstance(s.tick_period, int)
                    or s.tick_period < 1):
                raise ValueError(
                    f"{s.name}: tick_period={s.tick_period!r} must be "
                    "an int >= 1 (rounds between gossip ticks; 1 = "
                    "every round)")
            if s.tick_phase is not None and (
                    isinstance(s.tick_phase, bool)
                    or not isinstance(s.tick_phase, int)
                    or s.tick_phase < 0):
                raise ValueError(
                    f"{s.name}: tick_phase={s.tick_phase!r} must be "
                    "an int >= 0 (cadence phase offset in rounds)")
            if s.fault_seed is not None and plan is None:
                raise ValueError(
                    f"{s.name}: fault_seed={s.fault_seed} needs a "
                    "batch FaultPlan (the seed re-roots the shared "
                    "plan structure)")
            if family == "compressed" and s.churn_prob > 0:
                raise ValueError(
                    f"{s.name}: churn_prob is the exact family's "
                    "restart-churn hook; compressed scenarios churn "
                    "via mint_frac (the initial burst)")
            if family == "exact" and s.mint_frac > 0:
                raise ValueError(
                    f"{s.name}: mint_frac is the compressed family's "
                    "churn burst; exact scenarios churn via churn_prob")

        batch = cls(family=family, params=params, timecfg=timecfg,
                    specs=specs, knobs=None,
                    seeds=tuple(int(s.seed) for s in specs), device=dev,
                    plan=plan, topology=specs[0].topology)
        recover = getattr(params, "recover_rounds", 1)
        host = []
        for i, s in enumerate(specs):
            period, phase = batch.scenario_cadence(i)
            kn = knob_ops.from_protocol(
                batch.scenario_params(i), batch.scenario_timecfg(i),
                recover_rounds=recover, tick_period=period,
                tick_phase=phase)
            fault_seed = (s.fault_seed if s.fault_seed is not None
                          else (plan.seed if plan is not None else 0))
            host.append(dataclasses.replace(
                kn, churn_prob=float(s.churn_prob),
                fault_seed=int(fault_seed)))
        batch.knobs = BatchedKnobs.stack(host, dev)
        return batch


def restart_churn_perturb(params, prob: Optional[float] = None, *,
                          seed: int = 0, masks=None, seeds=None):
    """The config3-shaped restart churn as a perturb hook: each round a
    Bernoulli subset of the live slots restarts — an ALIVE record is
    tombstoned by its owner, any other re-announced ALIVE, at ``now``,
    its transmit count reset.

    With a static ``prob`` it is the unbatched hook ``perturb(state,
    now)``: the round's mask is ``masks[round]`` (a dict of bool ``[M]``
    by the round index after the step; a round it lacks churns nothing)
    when given, else ``rand(M) < prob`` from a generator of its own,
    seeded with ``seed`` on the state's device.

    The static hook is ``row_local`` (``models/common.apply_perturb``):
    given ``rows``, the global node rows a sharded state holds, it
    restarts only the slots those rows own, from the mask over all
    ``M`` — so a rank of a shard group applies its part of the same
    churn.

    With ``prob=None`` it is the fleet's knob-aware hook (``wants_knobs``)
    ``perturb(state, now, kn)`` on a batched state (``known``/``sent``
    ``[S, N, M]``) with the scenarios' :class:`BatchedKnobs`: scenario
    ``i`` (``kn.scen``) draws with its ``kn.host`` churn probability from
    ``masks[i]`` or a generator seeded with ``seeds[i]`` — so a fleet row
    equals the static hook with ``seed=seeds[i]``.  A scenario with no
    churn draws nothing.  It is ``row_local`` too: on a rank of the
    fleet's node axis it gets ``rows=`` and restarts only the slots its
    rows own, from each scenario's whole mask."""
    n, spn, m = params.n, params.services_per_node, params.m
    gens: dict = {}

    def draw(key, p, sd, given, round_idx, dev):
        if given is not None:
            return given[round_idx].to(dev)
        g = gens.get(key)
        if g is None:
            g = gens[key] = torch.Generator(device=dev).manual_seed(int(sd))
        return torch.rand(m, generator=g, device=dev) < p

    def flip_rows(known, sent, alive, churn, now, rows=None):
        # known/sent [B, R·M] views, alive [B, R], churn bool [B, M]: R
        # rows from global node ``lo`` on.
        dev = known.device
        lo, hi = (0, n) if rows is None else (rows.start, rows.stop)
        cols = torch.arange(lo * spn, hi * spn, dtype=torch.int64,
                            device=dev)
        owner = torch.div(cols, spn, rounding_mode="floor") - lo
        own_flat = owner * m + cols
        own = known[:, own_flat]
        flip = churn[:, cols] & (unpack_ts(own) > 0) & alive[:, owner]
        new_status = torch.where(unpack_status(own) == ALIVE, TOMBSTONE,
                                 ALIVE)
        known[:, own_flat] = torch.where(flip, pack(now, new_status), own)
        sent[:, own_flat] = torch.where(flip, 0, sent[:, own_flat])

    def static_hook(state, now, rows=None):
        round_idx = state_round(state) + 1
        if masks is not None and round_idx not in masks:
            return state
        churn = draw(None, prob, seed, masks, round_idx,
                     state.known.device)
        flip_rows(state.known.view(1, -1), state.sent.view(1, -1),
                  state.node_alive[None], churn[None], now, rows)
        return state

    def fleet_hook(state, now, kn, rows=None):
        dev = state.known.device
        b = state.known.shape[0]
        round_idx = state_round(state) + 1
        churning = [i for i, h in enumerate(kn.host) if h.churn_prob > 0]
        if not churning:
            return state
        churn = torch.zeros((b, m), dtype=torch.bool, device=dev)
        for i in churning:
            s = kn.scen[i]
            churn[i] = draw(s, kn.host[i].churn_prob,
                            0 if seeds is None else seeds[s],
                            None if masks is None else masks[s],
                            round_idx, dev)
        flip_rows(state.known.view(b, -1), state.sent.view(b, -1),
                  state.node_alive, churn, now, rows)
        return state

    hook = static_hook if prob is not None else fleet_hook
    hook.wants_knobs = prob is None
    hook.row_local = True
    return hook


def state_round(state) -> int:
    """The round index of an unbatched state, or the (common) round index
    of a batched one's scenarios (a hook runs before the step, so the
    round it perturbs is this plus one)."""
    r = state.round_idx
    return r if isinstance(r, int) else int(r[0])
