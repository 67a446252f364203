"""Measurement-side instruments of the port: ``cost.py`` (the phase
scopes of the round and the document of ``/api/cost.json``),
``slo.py`` (the SLO rule grammar and its evaluator), ``span.py`` (the
span ring the sweep, the catalog writer and the transport record into),
``prometheus.py`` (the registry's Prometheus exposition, ``GET
/metrics``), and the live catalog's monitors, ``coherence.py`` (peer
digests, quorum agreement, time to coherence) and ``propagation.py``
(per-origin propagation lag)."""

from sidecar_tpu_torch.telemetry.prometheus import render_prometheus
from sidecar_tpu_torch.telemetry.span import (reset_spans, span, spans,
                                              spans_since)

__all__ = ["render_prometheus", "span", "spans", "spans_since",
           "reset_spans"]
