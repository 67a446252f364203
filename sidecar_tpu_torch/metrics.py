"""The process-wide metrics registry of the port — its copy of
``sidecar_tpu/metrics.py``'s ``Metrics``: counters, gauges, timers
(:meth:`Metrics.measure_since`: count, total and last) and histograms
(:meth:`Metrics.histogram`: a 512-sample reservoir, Algorithm R beyond
it, read as p50/p95/p99 in :func:`snapshot`; every histogram also
mirrors count, total and last into the ``timers`` block), kept in memory
under a lock.

The port records under the reference's names:

* ``sparse.mode.<mode>`` and ``pipeline.mode.<mode>`` — each sim's
  resolved execution modes, once at construction
  (``ops/sparse.resolve_sparse``, ``ops/pipeline.resolve_pipeline``);
* ``sparse.rounds``, ``sparse.overflow``, ``sparse.switches`` and the
  ``sparse.frontier_size`` gauge — the chunk arbiter's accounting
  (``ops/sparse.SparseArbiter``);
* ``parallel.exchange.mode.<mode>``, the ``parallel.exchange.bytes`` and
  ``parallel.exchange.zoned_rows`` gauges and ``parallel.exchange.
  overflow`` — the sharded twin's board exchange
  (``parallel/sharded_compressed.py``);
* ``topology.from_name.<family>`` — ``ops/topology.from_name``;
* ``chaos.sim.droppedPackets``, ``chaos.sim.delayedPackets``,
  ``chaos.sim.duplicatedPackets``, ``clock.sim.rejectedFuture``,
  ``adversary.sim.forgedRecords``, ``defense.sim.rejectedBudget``,
  ``defense.sim.originViolations`` and ``defense.sim.quarantinedOrigins``
  — a chaos run's counter deltas (``chaos/sim_inject.py``), read on the
  host once a run;
* ``fleet.batches``, ``fleet.scenarios``, ``fleet.rounds`` and
  ``fleet.rounds_saved`` — a fleet run's accounting (``fleet/engine.py``,
  host counts), and on a chaos fleet the batch's injection totals under
  ``chaos.sim.droppedPackets``, ``chaos.sim.delayedPackets`` and
  ``chaos.sim.duplicatedPackets``, read on the host once a run;
* ``autopilot.recommendations``, ``autopilot.evaluations``,
  ``autopilot.applied``, ``autopilot.apply_blocked``, the
  ``autopilot.best_score``, ``autopilot.baseline_score``,
  ``autopilot.slo_pass`` and ``autopilot.replay_identical`` gauges and
  the ``autopilot.recommend`` histogram — one recommendation pass
  (``autopilot/controller.py``);
* ``slo.<rule>.observed`` and ``slo.<rule>.ok`` — a published SLO
  verdict (``telemetry/slo.py``).

Every update is host-side: it reads only values the caller already
holds on the host (the chaos counters: one read at the end of a run),
so recording adds no device read a round.  The reference's statsd sink
is not ported: nothing in the port emits to it.
"""

from __future__ import annotations

import random
import threading
import time


def _percentile(sorted_samples: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list."""
    if not sorted_samples:
        return 0.0
    rank = max(1, int(-(-q * len(sorted_samples) // 1)))  # ceil(q·n)
    return sorted_samples[min(rank, len(sorted_samples)) - 1]


class Metrics:
    """Counters (ints that add up), gauges (last value wins), timers and
    histograms (milliseconds)."""

    # Reservoir bound per histogram, the reference's.
    HIST_RESERVOIR = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, list] = {}  # name → [count, total_ms, last]
        # name → [count, total_ms, last, max, min, samples]
        self._hists: dict[str, list] = {}
        # The reservoir's replacement draws, seeded as the reference's.
        self._rand = random.Random(0xC0FFEE)

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def measure_since(self, name: str, t0: float) -> None:
        """Record the time since ``t0`` (a ``time.perf_counter()``
        stamp) as a timer: count, total and last."""
        ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            agg = self._timers.setdefault(name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += ms
            agg[2] = ms

    def histogram(self, name: str, ms: float) -> None:
        """Record one sample (milliseconds) into the reservoir behind
        ``name``, mirrored into the ``timers`` block."""
        ms = float(ms)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = [0, 0.0, 0.0, ms, ms, []]
            h[0] += 1
            h[1] += ms
            h[2] = ms
            h[3] = max(h[3], ms)
            h[4] = min(h[4], ms)
            samples = h[5]
            if len(samples) < self.HIST_RESERVOIR:
                samples.append(ms)
            else:
                # Vitter's Algorithm R: uniform over the whole stream.
                j = self._rand.randrange(h[0])
                if j < self.HIST_RESERVOIR:
                    samples[j] = ms
            agg = self._timers.setdefault(name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += ms
            agg[2] = ms

    def histogram_since(self, name: str, t0: float) -> None:
        """``histogram(name, ms since t0)``."""
        self.histogram(name, (time.perf_counter() - t0) * 1000.0)

    def counter(self, name: str) -> int:
        """One counter's value (0 if never incremented)."""
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """``{"counters", "gauges", "timers", "histograms"}``, copies; a
        histogram reads as count, total, last, max, min and the
        reservoir's p50/p95/p99, in milliseconds."""
        with self._lock:
            hists = {}
            for k, h in self._hists.items():
                s = sorted(h[5])
                hists[k] = {
                    "count": h[0],
                    "total_ms": round(h[1], 3),
                    "last_ms": round(h[2], 3),
                    "max_ms": round(h[3], 3),
                    "min_ms": round(h[4], 3),
                    "p50_ms": round(_percentile(s, 0.50), 3),
                    "p95_ms": round(_percentile(s, 0.95), 3),
                    "p99_ms": round(_percentile(s, 0.99), 3),
                }
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: {"count": v[0],
                               "total_ms": round(v[1], 3),
                               "last_ms": round(v[2], 3)}
                           for k, v in self._timers.items()},
                "histograms": hists,
            }

    def reset(self) -> None:
        """Forget every counter, gauge, timer and histogram."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._hists.clear()


# The process-global registry.
registry = Metrics()

incr = registry.incr
set_gauge = registry.set_gauge
measure_since = registry.measure_since
histogram = registry.histogram
histogram_since = registry.histogram_since
counter = registry.counter
snapshot = registry.snapshot
reset = registry.reset
