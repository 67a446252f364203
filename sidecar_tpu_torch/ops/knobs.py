"""Per-round protocol knobs — the port of ``sidecar_tpu/ops/knobs.py``,
in two forms.

* :class:`RoundKnobs` — one scenario's knobs as Python scalars, built
  once per sim by :func:`from_protocol`; every "is this gate on"
  question is a plain Python branch, so an unbatched round's program is
  the one it had before the fleet existed.  The one exception is the
  tick cadence, which may be a per-node int32 tensor
  (:func:`sidecar_tpu_torch.models.common.resolve_cadence`).
* :class:`BatchedKnobs` — S scenarios' knobs for the scenario fleet
  (``fleet/``): each data knob an ``[S]`` tensor on the device, beside
  the S host :class:`RoundKnobs` it was stacked from.  The fleet decides
  cadences and draws on the host from the host values (no sync), and
  hands the batched round per-row tensors (:meth:`BatchedKnobs.rows`),
  or a host int where every scenario agrees.  The gates follow the
  reference's traced-knob contract: a disabled future bound becomes
  ``MAX_TICK``, a disabled budget or quarantine ``BUDGET_OFF`` — values
  no real stamp or rank reaches, so the gate passes everything.

Float-knob rule (the reference's): ``keep_prob`` is ``1 - drop_prob``
computed on the host in double precision, never derived on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from sidecar_tpu_torch.ops.merge import BUDGET_OFF
from sidecar_tpu_torch.ops.status import MAX_TICK


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
    churn_prob: float = 0.0  # per-round restart churn (read by knob-aware
                            # hooks, ``fleet/batch.restart_churn_perturb``)
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


# Knobs stacked as float32 on the device (the reference's dtypes); every
# other knob is int32.
_FLOAT_KNOBS = ("keep_prob", "churn_prob")
KNOB_FIELDS = tuple(f.name for f in dataclasses.fields(RoundKnobs))


@dataclasses.dataclass(frozen=True)
class BatchedKnobs:
    """S scenarios' knobs: ``host[i]`` scenario i's :class:`RoundKnobs`
    (its tick cadence a host int pair) and ``tensors[name]`` the ``[S]``
    stack of one knob on ``device`` — float32 for ``keep_prob`` and
    ``churn_prob``, int32 otherwise.  ``scen`` are the scenarios' indices
    in their batch (a subset keeps them, so a hook can find its
    scenarios' generators)."""

    host: tuple
    tensors: dict
    scen: tuple
    device: torch.device

    @classmethod
    def stack(cls, knobs: Sequence[RoundKnobs], device) -> "BatchedKnobs":
        knobs = tuple(knobs)
        if not knobs:
            raise ValueError("BatchedKnobs needs at least one scenario")
        for kn in knobs:
            for name in ("tick_period", "tick_phase"):
                if not isinstance(getattr(kn, name), int):
                    raise ValueError(f"a batched {name} is one int per "
                                     "scenario")
        dev = torch.device(device)
        tensors = {
            name: torch.tensor(
                [getattr(kn, name) for kn in knobs],
                dtype=torch.float32 if name in _FLOAT_KNOBS else torch.int32,
                device=dev)
            for name in KNOB_FIELDS}
        return cls(host=knobs, tensors=tensors,
                   scen=tuple(range(len(knobs))), device=dev)

    @property
    def size(self) -> int:
        return len(self.host)

    def values(self, name: str) -> list:
        """The S host values of knob ``name``."""
        return [getattr(kn, name) for kn in self.host]

    def take(self, idx: Sequence[int]) -> "BatchedKnobs":
        """The knobs of the scenarios at positions ``idx`` (host ints)."""
        idx = [int(i) for i in idx]
        sel = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        return BatchedKnobs(
            host=tuple(self.host[i] for i in idx),
            tensors={k: v[sel] for k, v in self.tensors.items()},
            scen=tuple(self.scen[i] for i in idx), device=self.device)

    def _expand(self, t, n: int, ndim: int):
        """``[S]`` → ``[S·n, 1, …]`` (``ndim`` dims in all): one value per
        row of the flattened ``[S·n, …]`` batch."""
        return t.repeat_interleave(n).reshape((-1,) + (1,) * (ndim - 1))

    def rows(self, name: str, n: int, ndim: int = 2):
        """Knob ``name`` for the flattened ``[S·n, …]`` rows of the batch:
        the host value where every scenario agrees (the unbatched
        program's constant), else an ``[S·n, 1, …]`` tensor of
        ``ndim`` dims."""
        vals = self.values(name)
        if all(v == vals[0] for v in vals):
            return vals[0]
        return self._expand(self.tensors[name], n, ndim)

    def _gate(self, name: str, off, n: int, ndim: int):
        """A negative-is-off gate knob for the flattened rows: None when
        every scenario has it off, the host int where all agree, else
        per-row values with ``off`` where a scenario has it off."""
        vals = self.values(name)
        if all(v < 0 for v in vals):
            return None
        if all(v == vals[0] for v in vals):
            return int(vals[0])
        t = self.tensors[name]
        return self._expand(torch.where(t < 0, off, t), n, ndim)

    def future_arg(self, n: int, ndim: int = 2):
        """The future bound for the merge gates (``MAX_TICK`` where a
        scenario has it off)."""
        return self._gate("future_ticks", MAX_TICK, n, ndim)

    def budget_arg(self, n: int, ndim: int = 2):
        """The per-origin budget for the merge gates (``BUDGET_OFF``
        where a scenario has it off)."""
        return self._gate("tomb_budget", BUDGET_OFF, n, ndim)

    def quarantine_arg(self, n: int, ndim: int = 2):
        """The quarantine threshold of the chaos round (``BUDGET_OFF``
        where a scenario has it off: no origin accrues that many
        violations)."""
        return self._gate("quarantine_threshold", BUDGET_OFF, n, ndim)

    @property
    def suspicion_enabled(self) -> bool:
        """Whether any scenario has a suspicion window."""
        return any(kn.suspicion_enabled for kn in self.host)

    def suspicion_rows(self, n: int, ndim: int = 2):
        """The announce's refutation switch for the flattened rows: a
        host bool where every scenario agrees, else a bool ``[S·n, 1,
        …]`` tensor."""
        vals = [kn.suspicion_enabled for kn in self.host]
        if all(v == vals[0] for v in vals):
            return vals[0]
        return self._expand(self.tensors["suspicion_window"] > 0, n, ndim)

    @property
    def needs_drop_draw(self) -> bool:
        """Whether any scenario loses packets."""
        return any(kn.needs_drop_draw for kn in self.host)

    @property
    def cadence_enabled(self) -> bool:
        """Whether any scenario ticks slower than every round."""
        return any(kn.cadence_enabled for kn in self.host)
