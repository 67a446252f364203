"""The process-wide metrics registry of the port — its copy of
``sidecar_tpu/metrics.py``'s ``Metrics``: counters and gauges, kept in
memory under a lock and read through :func:`snapshot`.

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
  ``chaos.sim.duplicatedPackets``, read on the host once a run.

Every update is host-side: it reads only values the caller already
holds on the host (the chaos counters: one read at the end of a run),
so recording adds no device read a round.  The reference's
statsd sink, timers and histograms are not ported: no port code records
them.
"""

from __future__ import annotations

import threading


class Metrics:
    """Counters (ints that add up) and gauges (last value wins)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}}``, copies."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def reset(self) -> None:
        """Forget every counter and gauge."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


# The process-global registry.
registry = Metrics()

incr = registry.incr
set_gauge = registry.set_gauge
snapshot = registry.snapshot
reset = registry.reset
