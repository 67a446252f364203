"""The reference's wall-clock protocol constants on logical ticks — a
pure-Python copy of ``sidecar_tpu/models/timecfg.py`` (no tensors).

1 tick = 1 ms by default, ``round_ticks`` per gossip round; every
lifecycle constant is a tick count derived from the same wall-clock
values the reference uses (gossip interval 200 ms, alive lifespan 80 s,
draining lifespan 10 min, tombstone retention 3 h, staleness fudge
1 min, refresh 1 min, push-pull 20 s, sweep 2 s).
"""

from __future__ import annotations

import dataclasses

from sidecar_tpu_torch.ops.status import MAX_TICK


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    ticks_per_second: int = 1000
    round_ticks: int = 200            # GossipInterval 200 ms
    alive_lifespan_s: float = 80.0    # ALIVE_LIFESPAN
    draining_lifespan_s: float = 600.0  # DRAINING_LIFESPAN
    tombstone_lifespan_s: float = 10800.0  # TOMBSTONE_LIFESPAN
    staleness_fudge_s: float = 60.0   # clock-drift fudge
    refresh_interval_s: float = 60.0  # ALIVE_BROADCAST_INTERVAL
    push_pull_interval_s: float = 20.0  # PushPullInterval
    sweep_interval_s: float = 2.0     # TOMBSTONE_SLEEP_INTERVAL
    # SWIM-style suspicion grace window; 0 disables the subprotocol.
    suspicion_window_s: float = 0.0
    # Future-admission bound; negative disables it.
    future_fudge_s: float = -1.0
    # Per-origin suspicious-record budget (a count); negative disables.
    origin_budget: int = -1
    # Budget violations before an origin is quarantined; negative = off.
    origin_quarantine: int = -1

    def ticks(self, seconds: float) -> int:
        return int(round(seconds * self.ticks_per_second))

    @property
    def alive_lifespan(self) -> int:
        return self.ticks(self.alive_lifespan_s)

    @property
    def draining_lifespan(self) -> int:
        return self.ticks(self.draining_lifespan_s)

    @property
    def tombstone_lifespan(self) -> int:
        return self.ticks(self.tombstone_lifespan_s)

    @property
    def stale_ticks(self) -> int:
        """Merge-time staleness bound: tombstone lifespan + fudge."""
        return self.ticks(self.tombstone_lifespan_s + self.staleness_fudge_s)

    @property
    def one_second(self) -> int:
        return self.ticks_per_second

    @property
    def suspicion_window(self) -> int:
        """Suspicion grace window in ticks (0 = subprotocol disabled)."""
        return self.ticks(self.suspicion_window_s)

    @property
    def future_ticks(self):
        """Future-admission bound in ticks, or None when disabled."""
        if self.future_fudge_s < 0:
            return None
        return self.ticks(self.future_fudge_s)

    @property
    def tomb_budget(self):
        """Per-origin suspicious-record budget, or None when disabled."""
        if self.origin_budget < 0:
            return None
        return int(self.origin_budget)

    @property
    def quarantine_threshold(self):
        """Origin-quarantine violation threshold, or None when
        disabled."""
        if self.origin_quarantine < 0:
            return None
        return int(self.origin_quarantine)

    def rounds(self, seconds: float) -> int:
        """Number of gossip rounds in a wall-clock duration."""
        return max(1, self.ticks(seconds) // self.round_ticks)

    @property
    def refresh_rounds(self) -> int:
        return self.rounds(self.refresh_interval_s)

    @property
    def push_pull_rounds(self) -> int:
        return self.rounds(self.push_pull_interval_s)

    @property
    def sweep_rounds(self) -> int:
        return self.rounds(self.sweep_interval_s)

    @property
    def max_safe_rounds(self) -> int:
        """Largest round count whose tick clock stays inside the int32
        packed-key range."""
        return MAX_TICK // self.round_ticks

    def validate_horizon(self, num_rounds: int, skew_ticks: int = 0) -> None:
        """Raise when ``num_rounds`` rounds of tick advance (plus any
        skew) would run the int32 packed-key clock into the sign bit."""
        horizon = num_rounds * self.round_ticks + skew_ticks
        if horizon > MAX_TICK:
            skew = (f" + {skew_ticks} skew ticks" if skew_ticks else "")
            raise ValueError(
                f"{num_rounds} rounds x {self.round_ticks} ticks{skew} "
                f"overflows the int32 packed-key tick range ({MAX_TICK}); "
                f"use a coarser tick"
            )
