"""The Sidecar HTTP API — the port of ``sidecar_tpu/web/api.py``
(reference: sidecarhttp/http_api.go:18-371, http_listener.go:12-38).

Route logic is an object that returns ``(status, content_type, body,
headers)`` tuples, so a test drives it directly;
``sidecar_tpu_torch.web.server`` mounts it on a threading HTTP server.

Routes (http.go:64-76, http_api.go:35-45):
  GET  /api/services.json           grouped by service, with the members
  GET  /api/state.json              the raw state
  GET  /api/services/{name}.json    one service's instances
  POST /api/services/{id}/drain     set a local instance DRAINING
  GET  /api/watch (+ /watch)        the versioned snapshot and delta
                                    stream (?since=V cursor)
  GET  /servers                     the state as a page
  GET  /metrics (+ /api/metrics)    the registry in Prometheus text
  GET  /api/metrics.json            the registry as JSON
  GET  /api/trace (+ /trace)        the span ring as JSON (?limit=N
                                    newest spans; ?since=S cursor;
                                    ?format=chrome)
  GET  /api/cost.json               the cost-report registry
  GET  /api/propagation.json        per-origin propagation lag and SLO
                                    verdicts
  GET  /api/propagation             the lag table as a page
  GET  /api/digest.json             the local catalog's digest
  GET  /api/coherence.json          the cluster's digest agreement and
                                    SLO verdicts
  GET  /api/coherence               the coherence table as a page
  GET  /api/autopilot.json          the last autopilot report
  GET  /api/debug/stacks            every thread's stack
  GET  /api/debug/profile           a sampling profile of the threads
  GET  /api/haproxy/stats.csv       the managed HAProxy's stats CSV
  GET  /api/damping.json            flap-damper penalties
  GET  /v1/...                      the Envoy V1 REST routes, when an
                                    ``envoy_v1`` object is mounted
  OPTIONS                           CORS headers
The deprecated aliases /services.json and /state.json are served too.
"""

from __future__ import annotations

import json
import logging
import queue
import time
from typing import Callable, Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch import service as svc_mod
from sidecar_tpu_torch.catalog.state import Listener, ServicesState
from sidecar_tpu_torch.service import DRAINING, ns_to_rfc3339

log = logging.getLogger(__name__)


class _DropOldestQueue(queue.Queue):
    """Bounded queue whose non-blocking put evicts the OLDEST entry
    instead of failing: a slow /watch client keeps receiving the newest
    events (and a ``web.watch.dropped`` count says how many it lost)
    rather than silently freezing on a full buffer."""

    def put_nowait(self, item) -> None:
        while True:
            try:
                super().put_nowait(item)
                return
            except queue.Full:
                try:
                    self.get_nowait()
                    metrics.incr("web.watch.dropped")
                except queue.Empty:
                    pass  # racing consumer freed space; retry


class HttpListener(Listener):
    """The queue-shaped catalog listener (http_listener.go:12-38):
    larger buffer for slow consumers, drop-oldest beyond it.  The
    /watch HTTP stream itself rides the query hub now; this class is
    the surface for in-process ``add_listener`` consumers (embedders,
    tools) that want a plain bounded queue of ChangeEvents — its
    ``web.watch.dropped`` counter reports THAT queue's evictions (hub
    subscribers report through ``query.hub.dropped`` instead)."""

    def __init__(self) -> None:
        self._name = f"httpListener-{time.time_ns()}"
        self._chan: "queue.Queue" = _DropOldestQueue(maxsize=50)

    def chan(self):
        return self._chan

    def name(self) -> str:
        return self._name

    def managed(self) -> bool:
        return False


class ApiServer:
    """Cluster-member info in /services.json (http_api.go:18-22)."""

    def __init__(self, name: str, last_updated: int,
                 service_count: int) -> None:
        self.name = name
        self.last_updated = last_updated
        self.service_count = service_count

    def to_json(self) -> dict:
        return {"Name": self.name,
                "LastUpdated": ns_to_rfc3339(self.last_updated),
                "ServiceCount": self.service_count}


CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET",
}


class SidecarApi:
    """http_api.go:30-32 — state + cluster membership view."""

    def __init__(self, state: ServicesState,
                 members_fn: Optional[Callable[[], list[str]]] = None,
                 cluster_name: str = "",
                 envoy_v1=None,
                 haproxy_stats_url: Optional[str] = None) -> None:
        import threading

        self.state = state
        self.members_fn = members_fn
        self.cluster_name = cluster_name
        self._profile_gate = threading.Semaphore(1)
        # When the node manages an HAProxy, the UI reads its stats CSV
        # THROUGH this API (GET /api/haproxy/stats.csv) instead of
        # hitting :3212 directly like the reference UI does
        # (ui/app/services/services.js:21-33) — same data, no
        # cross-origin fetch to a second port.  None = no HAProxy.
        self.haproxy_stats_url = haproxy_stats_url
        # The deprecated Envoy V1 REST API (an EnvoyApiV1) rides on the
        # main HTTP server, like the reference's sidecarhttp mux
        # (envoy_api.go:428-438 mounted in http.go:64-76).
        self.envoy_v1 = envoy_v1

    # -- route dispatch ----------------------------------------------------

    def dispatch(self, method: str, path: str,
                 query: Optional[dict] = None,
                 client: Optional[str] = None):
        """Returns (status, content_type, body_bytes) or a stream marker
        ("watch", by_service, since) for the stream route.  ``client`` is
        the peer IP when the call arrives over HTTP (None = a trusted
        in-process caller)."""
        query = query or {}
        parts = [p for p in path.split("/") if p]
        # Strip the /api prefix; deprecated unprefixed aliases hit the
        # same handlers (http.go:72-75).
        if parts and parts[0] == "api":
            parts = parts[1:]

        if method == "OPTIONS":
            return 200, "application/json", b"", CORS_HEADERS

        if parts == ["watch"] and method == "GET":
            by_service = query.get("by_service", ["true"])[0] != "false"
            since = None
            raw = query.get("since", [None])[0]
            if raw is not None:
                try:
                    since = int(raw)
                except ValueError:
                    return self._error(400, "since must be an integer "
                                            "version cursor")
            return ("watch", by_service, since)

        if method == "POST":
            if len(parts) == 3 and parts[0] == "services" \
                    and parts[2] == "drain":
                return self.drain_service(parts[1])
            return self._error(404, "Not Found")

        if parts == ["servers"]:
            return self.servers_page()

        # Envoy V1 REST: SDS /v1/registration/{service}, CDS
        # /v1/clusters[/{x}/{y}], LDS /v1/listeners[/{x}/{y}]
        # (envoy_api.go:428-438 — the trailing segments of the cluster/
        # listener routes are Envoy-supplied and unused).
        if self.envoy_v1 is not None and parts[:1] == ["v1"] \
                and method == "GET":
            if len(parts) == 3 and parts[1] == "registration":
                status, doc = self.envoy_v1.registration(parts[2])
                return self._json(status, doc)
            if parts[1] == "clusters" and len(parts) in (2, 4):
                status, doc = self.envoy_v1.clusters()
                return self._json(status, doc)
            if parts[1] == "listeners" and len(parts) in (2, 4):
                status, doc = self.envoy_v1.listeners()
                return self._json(status, doc)
            return self._error(404, "Not Found")

        # Observability surface — the go-metrics + net/http/pprof analog
        # (sidecarhttp/http.go:5, main.go:156-166): live hot-path
        # counters/timers/histograms, Prometheus exposition, the span
        # tracer, and thread stack dumps.
        if parts == ["metrics.json"]:
            return self.metrics_dump()
        if parts == ["metrics"]:
            return self.metrics_prometheus()
        if parts == ["trace"]:
            return self.trace_dump(query)
        if parts == ["cost.json"]:
            return self.cost_dump()
        if parts == ["propagation.json"]:
            return self.propagation_dump()
        if parts == ["propagation"]:
            return self.propagation_page()
        if parts == ["digest.json"]:
            return self.digest_dump()
        if parts == ["coherence.json"]:
            return self.coherence_dump()
        if parts == ["autopilot.json"]:
            return self.autopilot_dump()
        if parts == ["coherence"]:
            return self.coherence_page()
        if parts == ["damping.json"] or parts == ["damping"]:
            return self.damping_dump()
        if parts == ["debug", "stacks"]:
            return self.debug_stacks()
        if parts == ["debug", "profile"]:
            return self.debug_profile(query, client=client)
        if parts == ["haproxy", "stats.csv"]:
            return self.haproxy_stats()

        if len(parts) == 1 and parts[0].startswith("services."):
            return self.services(parts[0].rsplit(".", 1)[1])
        if len(parts) == 1 and parts[0].startswith("state."):
            return self.state_dump(parts[0].rsplit(".", 1)[1])
        if len(parts) == 2 and parts[0] == "services":
            name, _, ext = parts[1].rpartition(".")
            return self.one_service(name, ext)
        return self._error(404, "Not Found")

    # -- handlers ----------------------------------------------------------

    def _members(self) -> list[str]:
        return sorted(self.members_fn()) if self.members_fn else []

    def damping_dump(self):
        """Flap-damper state (``GET /api/damping.json`` —
        catalog/damping.py): per-instance penalties + the suppressed
        set, or ``{"enabled": false}`` when damping is off."""
        damper = getattr(self.state, "flap_damper", None)
        if damper is None:
            return self._json(200, {"enabled": False})
        return self._json(200, {"enabled": True, **damper.snapshot()})

    def services(self, extension: str):
        """Grouped-by-service + cluster members
        (http_api.go:202-268)."""
        if extension != "json":
            return self._error(
                404, "Not Found - Invalid content type extension")
        members = {}
        for name in self._members():
            server = self.state.servers.get(name)
            members[name] = ApiServer(
                name=name,
                last_updated=server.last_updated if server else 0,
                service_count=len(server.services) if server else 0,
            ).to_json()
        result = {
            "Services": {name: [svc.to_json() for svc in instances]
                         for name, instances
                         in self.state.by_service().items()},
            "ClusterName": self.cluster_name,
        }
        if members:
            result["ClusterMembers"] = members
        body = json.dumps(result, indent=2).encode()
        return 200, "application/json", body, CORS_HEADERS

    def state_dump(self, extension: str):
        """Raw state dump (http_api.go:272-291) — the bootstrap source
        for receivers (receiver.FetchInitialState)."""
        if extension != "json":
            return self._error(
                404, "Not Found - Invalid content type extension")
        return 200, "application/json", self.state.encode(), CORS_HEADERS

    def one_service(self, name: str, extension: str):
        """One service's instances (http_api.go:135-199)."""
        if extension != "json":
            return self._error(
                404, "Not Found - Invalid content type extension")
        if not name:
            return self._error(404, "Not Found - No service name provided")
        instances = []
        with self.state._lock:
            for _, _, svc in self.state.each_service():
                if svc.name == name:
                    instances.append(svc.to_json())
        if not instances:
            return self._error(404, f"no instances of {name} found")
        body = json.dumps({
            "Services": {name: instances},
            "ClusterName": self.cluster_name,
        }, indent=2).encode()
        return 200, "application/json", body, CORS_HEADERS

    def drain_service(self, service_id: str):
        """Set a local instance DRAINING (http_api.go:297-343); re-enters
        the merge path, where DRAINING is sticky
        (services_state.go:329-331)."""
        if not service_id:
            return self._error(404, "Not Found - No service ID provided")
        try:
            svc = self.state.get_local_service_by_id(service_id)
        except KeyError:
            return self._error(
                404, f'Not Found - Service ID "{service_id}" not found')
        svc.updated = svc_mod.now_ns()
        svc.status = DRAINING
        self.state.update_service(svc)
        body = json.dumps({
            "Message": f'Service "{svc.name}" instance "{svc.id}" set to '
                       "DRAINING"
        }, indent=2).encode()
        return 202, "application/json", body, {}

    def servers_page(self):
        """Auto-refreshing human-readable dump (http.go:28-45)."""
        body = ("\n \t\t\t<head>\n \t\t\t<meta http-equiv=\"refresh\" "
                "content=\"4\">\n \t\t\t</head>\n\t    \t<pre>"
                + self.state.format(self._members())
                + "</pre>").encode()
        return 200, "text/html", body, {}

    # -- observability -----------------------------------------------------

    def metrics_dump(self):
        """Hot-path counters/gauges/timers (the statsd registry's
        in-memory view) — the observability read the reference only had
        via an external statsd pipeline."""
        body = json.dumps(metrics.snapshot(), indent=2).encode()
        return 200, "application/json", body, CORS_HEADERS

    def metrics_prometheus(self):
        """The registry in Prometheus text exposition format (``GET
        /metrics`` — the standard scrape path; counters, gauges, and
        the histogram instruments' quantiles, docs/telemetry.md)."""
        from sidecar_tpu_torch.telemetry import render_prometheus

        body = render_prometheus().encode()
        return (200, "text/plain; version=0.0.4; charset=utf-8", body,
                CORS_HEADERS)

    def trace_dump(self, query: dict):
        """The span tracer's ring buffer as JSON (``GET /api/trace`` —
        end-to-end timing of the live propagation path, receive →
        merge → publish → watcher delivery; docs/telemetry.md).
        ``?limit=N`` returns only the newest N spans; ``?since=<seq>``
        is the incremental cursor — spans completed after that
        sequence number, oldest first, with ``next_since`` to resume
        from and ``dropped`` when the ring overwrote spans the cursor
        never read (with both, ``limit`` pages FORWARD from the
        cursor).  ``?format=chrome`` returns the same selection as
        Chrome trace-event JSON (Perfetto-loadable; the cursor keys
        ride along at the top level next to ``traceEvents``)."""
        from sidecar_tpu_torch.telemetry import spans, spans_since
        from sidecar_tpu_torch.telemetry.span import spans_to_chrome

        fmt = query.get("format", ["json"])[0]
        if fmt not in ("json", "chrome"):
            return self._error(400, "format must be json or chrome")
        limit = None
        raw = query.get("limit", [None])[0]
        if raw is not None:
            try:
                limit = int(raw)
            except ValueError:
                return self._error(400, "limit must be an integer")
        raw_since = query.get("since", [None])[0]
        if raw_since is not None:
            try:
                since = int(raw_since)
            except ValueError:
                return self._error(
                    400, "since must be an integer span cursor")
            doc = spans_since(since, limit)
        else:
            doc = {"spans": spans(limit)}
        if fmt == "chrome":
            chrome = {"traceEvents": spans_to_chrome(doc["spans"]),
                      "displayTimeUnit": "ms"}
            for key in ("next_since", "dropped"):
                if key in doc:
                    chrome[key] = doc[key]
            doc = chrome
        body = json.dumps(doc, indent=2).encode()
        return 200, "application/json", body, CORS_HEADERS

    def cost_dump(self):
        """The cost-report registry (``GET /api/cost.json`` —
        telemetry/cost.py): every report published in this process, the
        phase-scope state and the ``compile.*`` counters."""
        from sidecar_tpu_torch.telemetry import cost

        body = json.dumps(cost.snapshot(), indent=2).encode()
        return 200, "application/json", body, CORS_HEADERS

    def propagation_dump(self):
        """Live propagation-lag view (``GET /api/propagation.json`` —
        telemetry/propagation.py, the sim provenance plane's live
        twin): per observation site (catalog writer, query hub) the
        per-origin merge-lag percentiles, plus the convergence-SLO
        verdicts when an evaluator is attached (telemetry/slo.py)."""
        from sidecar_tpu_torch.telemetry import propagation

        doc = propagation.snapshot()
        slo = getattr(self.state, "slo_evaluator", None)
        if slo is not None:
            doc["slo"] = slo.evaluate_live()
        return self._json(200, doc)

    def propagation_page(self):
        """Auto-refreshing human view of the propagation meter
        (``GET /api/propagation`` — the /servers convention): one row
        per (site, origin) with the lag percentiles."""
        from sidecar_tpu_torch.telemetry import propagation

        doc = propagation.snapshot()
        rows = []
        for site, block in sorted(doc.get("sites", {}).items()):
            for origin, ent in sorted(block["origins"].items()):
                rows.append(
                    f"<tr><td>{site}</td><td>{origin}</td>"
                    f"<td>{ent['count']}</td>"
                    f"<td>{ent['p50_ms']}</td><td>{ent['p95_ms']}</td>"
                    f"<td>{ent['p99_ms']}</td><td>{ent['max_ms']}</td>"
                    f"</tr>")
            if block.get("overflow_origins"):
                rows.append(
                    f"<tr><td>{site}</td><td><i>(+"
                    f"{block['overflow_origins']} origins beyond cap)"
                    f"</i></td><td colspan=5></td></tr>")
        body = (
            "\n\t\t\t<head>\n\t\t\t<meta http-equiv=\"refresh\" "
            "content=\"4\">\n\t\t\t</head>\n\t\t\t"
            "<h3>Propagation lag (ms) — merge time − record stamp"
            "</h3>\n<table border=1 cellpadding=4>"
            "<tr><th>site</th><th>origin</th><th>count</th>"
            "<th>p50</th><th>p95</th><th>p99</th><th>max</th></tr>"
            + "".join(rows) + "</table>"
        ).encode()
        return 200, "text/html", body, CORS_HEADERS

    def digest_dump(self):
        """The local catalog's coherence digest
        (``GET /api/digest.json`` — ops/digest.py live twin): the same
        ``{"Buckets", "Records", "Hex"}`` document the push-pull
        annotation carries.  Lock-free: one immutable-snapshot read,
        the coherence plane's read-path contract."""
        doc_fn = getattr(self.state, "digest_doc", None)
        if doc_fn is None:
            return self._json(200, {"enabled": False})
        return self._json(200, doc_fn())

    def autopilot_dump(self):
        """The last autopilot recommendation report
        (``GET /api/autopilot.json`` — the autopilot package, which
        the bridge publishes into ``state.autopilot_report``): the
        fitted condition estimate, SLO rules, baseline-vs-recommended
        verdicts, search cost, the replay
        bit-identity check, and the apply-gate outcome.  ``{"enabled":
        false}`` until a recommendation has run (the digest_dump
        graceful-absence convention)."""
        report = getattr(self.state, "autopilot_report", None)
        if report is None:
            return self._json(200, {"enabled": False})
        return self._json(200, {"enabled": True, **report})

    def coherence_dump(self):
        """Cluster coherence view (``GET /api/coherence.json`` —
        telemetry/coherence.py): per-host digest agreement, the quorum
        digest, the pairwise differing-bucket matrix (each entry
        lower-bounds the records diverged between that host pair),
        the diverged-record estimate, and time-to-coherence — plus the
        coherence-SLO verdicts when an evaluator is attached
        (``state.slo_evaluator``, telemetry/slo.py)."""
        from sidecar_tpu_torch.telemetry import coherence

        doc = coherence.snapshot()
        slo = getattr(self.state, "slo_evaluator", None)
        if slo is not None and doc.get("enabled"):
            doc["slo"] = slo.evaluate_coherence()
        return self._json(200, doc)

    def coherence_page(self):
        """Auto-refreshing human view of the coherence monitor
        (``GET /api/coherence`` — the /api/propagation convention):
        one summary row per host, then the pairwise differing-bucket
        matrix as a compact heat table (0 = the pair agrees; darker =
        more buckets — at least that many records — apart)."""
        from sidecar_tpu_torch.telemetry import coherence

        doc = coherence.snapshot()
        if not doc.get("enabled"):
            return (200, "text/html",
                    b"<h3>Coherence monitor disabled "
                    b"(coherence.configure(enabled=False))</h3>",
                    CORS_HEADERS)
        rows = []
        for host, ent in sorted(doc.get("hosts", {}).items()):
            mark = " (local)" if ent["local"] else ""
            rows.append(
                f"<tr><td>{host}{mark}</td><td>{ent['records']}</td>"
                f"<td>{'yes' if ent['agree'] else 'no'}</td>"
                f"<td>{ent['diff_vs_quorum']}</td></tr>")
        quorum = doc.get("quorum") or {}
        matrix = doc.get("matrix") or {}
        hosts = matrix.get("hosts") or []
        heat = []
        if hosts:
            heat.append("<tr><th></th>" + "".join(
                f"<th>{h}</th>" for h in hosts) + "</tr>")
            buckets = max(1, doc.get("buckets") or 1)
            for a, row in zip(hosts, matrix.get("diff") or []):
                cells = []
                for d in row:
                    # Heat shading: white at 0 diverging to red as the
                    # differing-bucket count approaches the full width.
                    frac = min(1.0, d / buckets)
                    g = int(255 - 195 * frac)
                    cells.append(
                        f"<td style=\"background:rgb(255,{g},{g})\">"
                        f"{d}</td>")
                heat.append(f"<tr><th>{a}</th>" + "".join(cells)
                            + "</tr>")
        ttc = doc.get("ttc") or {}
        body = (
            "\n\t\t\t<head>\n\t\t\t<meta http-equiv=\"refresh\" "
            "content=\"4\">\n\t\t\t</head>\n\t\t\t"
            "<h3>Cluster coherence — catalog digest agreement</h3>"
            f"<p>agreement: <b>{quorum.get('agreement', 'n/a')}</b>"
            f" &nbsp; diverged-record estimate (lower bound): "
            f"<b>{doc.get('diverged_estimate', 'n/a')}</b>"
            f" &nbsp; time-to-coherence: last "
            f"{ttc.get('last_ms', 'n/a')} ms over {ttc.get('count', 0)}"
            " changes</p>"
            "\n<table border=1 cellpadding=4>"
            "<tr><th>host</th><th>records</th><th>quorum?</th>"
            "<th>diff buckets</th></tr>"
            + "".join(rows) + "</table>"
            "<h4>Pairwise differing buckets</h4>"
            "\n<table border=1 cellpadding=4>"
            + "".join(heat) + "</table>"
        ).encode()
        return 200, "text/html", body, CORS_HEADERS

    def debug_stacks(self):
        """Per-thread stack dump — the live-pprof analog the reference
        gets from net/http/pprof's side-effect import."""
        import sys
        import threading
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in sys._current_frames().items():
            out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
            out.extend(line.rstrip()
                       for line in traceback.format_stack(frame))
        body = "\n".join(out).encode()
        return 200, "text/plain", body, CORS_HEADERS

    def haproxy_stats(self):
        """Relay the managed HAProxy's stats CSV (the reference UI's
        second data source, fetched straight off :3212 —
        ui/app/services/services.js:21-33).  404 when this node runs no
        HAProxy; 502 when HAProxy is expected but unreachable (the UI
        treats both as "no proxy data", like the reference's catch)."""
        import urllib.error
        import urllib.request

        if not self.haproxy_stats_url:
            return self._error(404, "this node manages no HAProxy")
        try:
            with urllib.request.urlopen(self.haproxy_stats_url,
                                        timeout=1.0) as resp:
                body = resp.read(4 << 20)
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            return self._error(502, f"HAProxy stats unreachable: {exc}")
        return 200, "text/plain", body, CORS_HEADERS

    def debug_profile(self, query: dict, client: Optional[str] = None):
        """On-demand CPU profile of the LIVE node —
        ``/api/debug/profile?seconds=N`` (the net/http/pprof CPU-profile
        analog, sidecarhttp/http.go:5; offline profiling stays behind
        ``--cpuprofile``).

        Loopback-only: the endpoint burns up to 60 s of CPU per request
        and the API is served with CORS ``*``, so an off-host (or
        cross-origin) caller could keep a node permanently profiling.
        net/http/pprof expects to live on a debug listener; the analog
        here is rejecting non-local peers outright.

        Like pprof's, this is a SAMPLING profile: every thread's stack
        is captured at ~100 Hz for N seconds and aggregated into
        flamegraph-collapsed lines (``frame;frame;frame count``) plus a
        self-time leaderboard.  cProfile is deliberately not used here —
        its tracer only hooks threads started after enabling, so it
        cannot see a running node's loops, and its per-call overhead
        would distort the hot paths it's meant to measure."""
        import math
        import sys
        import threading
        import time as time_mod

        if client is not None and client not in ("127.0.0.1", "::1",
                                                 "localhost") \
                and not client.startswith("127."):
            return self._error(
                403, "profiling is restricted to loopback clients")
        try:
            seconds = float(query.get("seconds", ["5"])[0])
        except ValueError:
            return self._error(400, "seconds must be a number")
        if not math.isfinite(seconds):
            return self._error(400, "seconds must be finite")
        seconds = min(max(seconds, 0.1), 60.0)
        interval = 0.01                       # 100 Hz, pprof's default
        # One profile at a time, like net/http/pprof: concurrent
        # samplers would multiply CPU burn and record each other.
        if not self._profile_gate.acquire(blocking=False):
            return self._error(409, "a CPU profile is already running")
        me = threading.get_ident()

        stacks: dict[tuple, int] = {}
        self_time: dict[str, int] = {}
        samples = 0
        try:
            deadline = time_mod.monotonic() + seconds
            while time_mod.monotonic() < deadline:
                for ident, frame in sys._current_frames().items():
                    if ident == me:
                        continue              # the sampler itself
                    stack = []
                    f = frame
                    while f is not None:
                        code = f.f_code
                        stack.append(
                            f"{code.co_name} "
                            f"({code.co_filename.rsplit('/', 1)[-1]}"
                            f":{f.f_lineno})")
                        f = f.f_back
                    stack.reverse()
                    stacks[tuple(stack)] = stacks.get(tuple(stack), 0) + 1
                    self_time[stack[-1]] = self_time.get(stack[-1], 0) + 1
                samples += 1
                time_mod.sleep(interval)
        finally:
            self._profile_gate.release()

        top = sorted(self_time.items(), key=lambda kv: -kv[1])[:25]
        lines = [f"# CPU profile: {samples} sampling passes over "
                 f"{seconds:g}s at ~{1 / interval:.0f} Hz "
                 f"(all threads; counts are samples observed)",
                 "", "# -- self time (leaf frame) --"]
        lines += [f"{count:8d}  {frame}" for frame, count in top]
        lines += ["", "# -- collapsed stacks (flamegraph format) --"]
        lines += [f"{';'.join(stack)} {count}"
                  for stack, count in
                  sorted(stacks.items(), key=lambda kv: -kv[1])]
        return 200, "text/plain", "\n".join(lines).encode(), CORS_HEADERS

    # -- watch plumbing ----------------------------------------------------

    def watch_snapshot_doc(self, by_service: bool, snapshot=None) -> dict:
        """The /watch snapshot document (docs/query.md): the catalog at
        one version, from the hub's immutable snapshot — no state lock,
        serialization cached per version."""
        if snapshot is None:
            snapshot = self.state.query_hub().current()
        body = (snapshot.by_service_json() if by_service
                else snapshot.to_json())
        return {"Version": snapshot.version, "Snapshot": body}

    def watch_delta_doc(self, events: list) -> dict:
        """One coalesced /watch delta document covering the contiguous
        version range [From, Version] — one ChangeEvent per version."""
        return {
            "From": events[0].version,
            "Version": events[-1].version,
            "Deltas": [ev.change.to_json() for ev in events],
        }

    # Zero-copy variants (docs/query.md): same document CONTENT as the
    # dict builders above, but served from the per-version buffers the
    # snapshot/event objects cache — every subscriber of a version
    # writes the SAME bytes object, so fan-out serialization is O(1)
    # per version instead of O(subscribers).

    def watch_snapshot_bytes(self, by_service: bool,
                             snapshot=None) -> bytes:
        if snapshot is None:
            snapshot = self.state.query_hub().current()
        return snapshot.watch_doc_bytes(by_service)

    def watch_delta_bytes(self, events: list) -> bytes:
        frags = [ev.change_frag() for ev in events]
        return (b'{"From":%d,"Version":%d,"Deltas":[%s]}'
                % (events[0].version, events[-1].version,
                   b",".join(frags)))


    def _json(self, status: int, doc: dict):
        body = json.dumps(doc, indent=2).encode()
        return status, "application/json", body, {}

    def _error(self, status: int, message: str):
        body = json.dumps({"status": "error", "message": message}).encode()
        return status, "application/json", body, {}
