"""Per-round protocol knobs — the static half of
``sidecar_tpu/ops/knobs.py``: :class:`RoundKnobs` with Python scalars
only, built once per sim by :func:`from_protocol`.

The reference also carries traced (batched) knobs for its scenario
fleet; the port runs one scenario per sim, so every knob here is a host
scalar and every "is this gate on" question is a plain Python branch.
The one exception is the tick cadence, which may be a per-node int32
tensor (:func:`sidecar_tpu_torch.models.common.resolve_cadence`).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class RoundKnobs:
    """One scenario's data-axis protocol values.  Durations are ticks;
    cadences are gossip rounds."""

    limit: int              # resolved TransmitLimited limit
    keep_prob: float        # 1 - drop_prob, computed in double precision
    push_pull_rounds: int   # anti-entropy cadence (rounds)
    sweep_rounds: int       # TTL sweep cadence (rounds)
    refresh_rounds: int     # owner refresh cadence (rounds)
    recover_rounds: int     # compressed recovery re-offer cadence
    suspicion_window: int   # SWIM quarantine window (ticks; 0 = off)
    alive_lifespan: int
    draining_lifespan: int
    tombstone_lifespan: int
    stale_ticks: int        # merge staleness bound (ticks)
    fault_seed: int = 0     # FaultPlan seed (the chaos round's fault draws)
    future_ticks: int = -1  # future-admission bound (negative = off)
    tomb_budget: int = -1   # per-origin suspicious budget (negative = off)
    quarantine_threshold: int = -1  # cumulative budget violations that
                            # quarantine an origin (negative = off)
    tick_period: Any = 1    # gossip cadence (rounds between ticks): an
                            # int, or an int32 tensor (scalar or [N])
    tick_phase: Any = 0     # cadence phase: node i ticks iff
                            # (round_idx + phase) % period == 0

    @property
    def cadence_enabled(self) -> bool:
        """False only for the static period 1 (no gate); a tensor period
        keeps the gate, a value no-op where it is 1."""
        return not (isinstance(self.tick_period, int)
                    and self.tick_period <= 1)

    @property
    def suspicion_enabled(self) -> bool:
        return self.suspicion_window > 0

    @property
    def needs_drop_draw(self) -> bool:
        return self.keep_prob < 1.0

    def future_arg(self):
        """``future_ticks`` for the merge gates: None when disabled."""
        return None if self.future_ticks < 0 else int(self.future_ticks)

    def budget_arg(self):
        """``tomb_budget`` for the merge gates: None when disabled."""
        return None if self.tomb_budget < 0 else int(self.tomb_budget)

    def quarantine_arg(self):
        """The origin-quarantine threshold of the chaos round: None when
        disabled."""
        qt = self.quarantine_threshold
        return None if qt < 0 else int(qt)


def from_protocol(params, timecfg, *, recover_rounds: int = 1,
                  tick_period=1, tick_phase=0) -> RoundKnobs:
    """The bundle read off ``CompressedParams`` or ``SimParams`` +
    ``TimeConfig``, with the resolved tick cadence.  ``fault_seed``
    stays 0: the chaos round sets it from its plan."""
    return RoundKnobs(
        limit=params.resolved_retransmit_limit(),
        keep_prob=1.0 - params.drop_prob,
        push_pull_rounds=timecfg.push_pull_rounds,
        sweep_rounds=timecfg.sweep_rounds,
        refresh_rounds=timecfg.refresh_rounds,
        recover_rounds=recover_rounds,
        suspicion_window=timecfg.suspicion_window,
        alive_lifespan=timecfg.alive_lifespan,
        draining_lifespan=timecfg.draining_lifespan,
        tombstone_lifespan=timecfg.tombstone_lifespan,
        stale_ticks=timecfg.stale_ticks,
        future_ticks=(-1 if timecfg.future_ticks is None
                      else timecfg.future_ticks),
        tomb_budget=(-1 if timecfg.tomb_budget is None
                     else timecfg.tomb_budget),
        quarantine_threshold=(-1 if timecfg.quarantine_threshold is None
                              else timecfg.quarantine_threshold),
        tick_period=tick_period,
        tick_phase=tick_phase,
    )
