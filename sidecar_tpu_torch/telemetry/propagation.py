"""Live propagation lag — the port of
``sidecar_tpu/telemetry/propagation.py``, the live twin of the
simulator's provenance plane.

A live node sees its own receive times: every gossiped record carries
its origin's ``Updated`` stamp, so merge time minus that stamp, here, is
the lag of the record's path to this node.  Two sites observe it:

* ``catalog`` — the catalog writer admitted a record
  (``ServicesState._add_service_entry``);
* ``query`` — the query hub published the change to its subscribers
  (``QueryHub.publish``).

Each observation lands in the pooled ``propagation.<site>.lag``
histogram of the metrics registry and in a per-origin reservoir, whose
replacement draws come from the meter's own ``random.Random(0x51DECA)``
in the reference's order.  Where the reference reads
``SIDECAR_TPU_PROVENANCE`` and ``_ORIGINS``, the port takes ``enabled``
and ``max_origins`` (:func:`configure`); beyond ``max_origins`` origins
the table stops growing and counts ``overflow_origins``.
"""

from __future__ import annotations

import random
import threading
from typing import Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.metrics import _percentile

DEFAULT_MAX_ORIGINS = 64
# Per-origin reservoir bound.
RESERVOIR = 256

SITES = ("catalog", "query")


class PropagationMeter:
    """Per-(site, origin) lag accounting, thread-safe."""

    def __init__(self, enabled: bool = True,
                 max_origins: int = DEFAULT_MAX_ORIGINS) -> None:
        self.enabled = enabled
        self.max_origins = max_origins
        self._lock = threading.Lock()
        # site → origin → [count, total_ms, last_ms, max_ms, samples]
        self._origins: dict[str, dict[str, list]] = {}
        self._overflow: dict[str, int] = {}
        self._rand = random.Random(0x51DECA)

    def observe(self, site: str, origin: str, lag_ms: float) -> None:
        """One admitted record's lag at ``site``; a negative lag (clock
        skew inside the admission fudge) counts as 0."""
        if not self.enabled:
            return
        lag_ms = max(0.0, float(lag_ms))
        metrics.histogram(f"propagation.{site}.lag", lag_ms)
        with self._lock:
            table = self._origins.setdefault(site, {})
            ent = table.get(origin)
            if ent is None:
                if len(table) >= self.max_origins:
                    self._overflow[site] = \
                        self._overflow.get(site, 0) + 1
                    return
                ent = table[origin] = [0, 0.0, 0.0, 0.0, []]
            ent[0] += 1
            ent[1] += lag_ms
            ent[2] = lag_ms
            ent[3] = max(ent[3], lag_ms)
            samples = ent[4]
            if len(samples) < RESERVOIR:
                samples.append(lag_ms)
            else:
                j = self._rand.randrange(ent[0])
                if j < RESERVOIR:
                    samples[j] = lag_ms

    def snapshot(self) -> dict:
        """The ``/api/propagation`` document: per site, each origin's
        lag percentiles and the overflow count."""
        with self._lock:
            doc: dict = {"enabled": self.enabled,
                         "max_origins": self.max_origins, "sites": {}}
            for site, table in self._origins.items():
                origins = {}
                for origin, ent in table.items():
                    s = sorted(ent[4])
                    origins[origin] = {
                        "count": ent[0],
                        "mean_ms": round(ent[1] / ent[0], 3)
                        if ent[0] else 0.0,
                        "last_ms": round(ent[2], 3),
                        "max_ms": round(ent[3], 3),
                        "p50_ms": round(_percentile(s, 0.50), 3),
                        "p95_ms": round(_percentile(s, 0.95), 3),
                        "p99_ms": round(_percentile(s, 0.99), 3),
                    }
                doc["sites"][site] = {
                    "origins": origins,
                    "overflow_origins": self._overflow.get(site, 0),
                }
            return doc

    def reset(self) -> None:
        """Clear the origin tables."""
        with self._lock:
            self._origins.clear()
            self._overflow.clear()


# The process-wide meter: the catalog writer and the query hub record
# through it.
meter = PropagationMeter()


def configure(enabled: bool = True,
              max_origins: Optional[int] = None) -> None:
    """Set the global meter's gates (the reference's ``configure`` with
    its environment variables unset: on by default); ``max_origins=None``
    keeps the bound as it is."""
    meter.enabled = enabled
    if max_origins is not None:
        meter.max_origins = max_origins


def observe(site: str, origin: str, lag_ms: float) -> None:
    meter.observe(site, origin, lag_ms)


def snapshot() -> dict:
    return meter.snapshot()
