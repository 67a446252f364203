"""Prometheus text exposition of the metrics registry — the port of
``sidecar_tpu/telemetry/prometheus.py``.

``GET /metrics`` (and ``/api/metrics``) serves the registry in the
Prometheus text format, version 0.0.4, with the numbers
``metrics.snapshot()`` reports:

* counters → ``sidecar_<name>_total`` (TYPE counter);
* gauges → ``sidecar_<name>`` (TYPE gauge);
* histograms → a summary ``sidecar_<name>_ms`` with
  ``{quantile="0.5|0.95|0.99"}`` lines and ``_sum``/``_count``;
* plain timers → a summary with ``_sum``/``_count`` only.  A timer that
  mirrors a histogram of the same name is skipped: Prometheus refuses a
  family twice.

A name is mapped onto the Prometheus charset (a dot or any other
invalid character becomes an underscore): ``query.hub.published`` is
``sidecar_query_hub_published_total``.
"""

from __future__ import annotations

import re
from typing import Optional

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    clean = _INVALID.sub("_", name)
    if clean and clean[0].isdigit():
        clean = "_" + clean
    return f"sidecar_{clean}"


def _fmt(value) -> str:
    # An integral float prints as an integer.
    f = float(value)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(snapshot: Optional[dict] = None) -> str:
    """The registry (or a given ``metrics.snapshot()``) as Prometheus
    exposition text."""
    if snapshot is None:
        from sidecar_tpu_torch import metrics
        snapshot = metrics.snapshot()
    lines: list[str] = []

    for name in sorted(snapshot.get("counters", {})):
        metric = _sanitize(name) + "_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(snapshot['counters'][name])}")

    for name in sorted(snapshot.get("gauges", {})):
        metric = _sanitize(name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_fmt(snapshot['gauges'][name])}")

    hists = snapshot.get("histograms", {})
    for name in sorted(hists):
        h = hists[name]
        metric = _sanitize(name) + "_ms"
        lines.append(f"# TYPE {metric} summary")
        for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                       ("0.99", "p99_ms")):
            lines.append(f'{metric}{{quantile="{q}"}} {_fmt(h[key])}')
        lines.append(f"{metric}_sum {_fmt(h['total_ms'])}")
        lines.append(f"{metric}_count {_fmt(h['count'])}")

    for name in sorted(snapshot.get("timers", {})):
        if name in hists:
            continue  # the summary above is this metric
        t = snapshot["timers"][name]
        metric = _sanitize(name) + "_ms"
        lines.append(f"# TYPE {metric} summary")
        lines.append(f"{metric}_sum {_fmt(t['total_ms'])}")
        lines.append(f"{metric}_count {_fmt(t['count'])}")

    return "\n".join(lines) + "\n"
