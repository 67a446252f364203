"""Cluster coherence monitor — the port of
``sidecar_tpu/telemetry/coherence.py``, the live digest plane.

A live node keeps the order-invariant digest of its own catalog
(``ServicesState`` updates it under the writer's lock) and learns its
peers' from the ``"Digest"`` annotation of every push-pull body
(``encode_annotated`` → ``merge``).  From those it derives:

* the coherence matrix — differing-bucket counts between every pair of
  known hosts, each a lower bound on the records the two disagree on;
* the quorum agreement — the modal digest and the share of hosts that
  carry it;
* the diverged estimate — the non-quorum hosts' summed differing
  buckets;
* time to coherence — when the local digest leaves agreement, the
  change is stamped with the catalog clock and the query-plane version;
  when every known host agrees again the elapsed ms lands in the
  ``coherence.ttc`` histogram.

Metrics: ``coherence.observed``, ``coherence.agreement``,
``coherence.peers``, ``coherence.diverged.estimate``,
``coherence.ttc``.  Where the reference reads ``SIDECAR_TPU_COHERENCE``
and ``_PEERS``, the port takes ``enabled`` and ``max_peers``
(:func:`configure`); peers beyond ``max_peers`` count in
``overflow_peers``, and the local host always fits.
"""

from __future__ import annotations

import threading
from typing import Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.ops import digest as digest_ops

DEFAULT_MAX_PEERS = 64


class CoherenceMonitor:
    """A per-host digest table and its verdicts, thread-safe."""

    def __init__(self, enabled: bool = True,
                 max_peers: int = DEFAULT_MAX_PEERS) -> None:
        self.enabled = enabled
        self.max_peers = max_peers
        self._lock = threading.Lock()
        # host → {value, buckets, records, seen_ns, local}
        self._hosts: dict[str, dict] = {}
        self._local: Optional[str] = None
        self._overflow = 0
        # The earliest local change not yet cohered: (hub version, clock
        # ns), held across later changes so ttc counts from the first
        # write that left coherence.
        self._mark: Optional[tuple] = None
        self._ttc = {"count": 0, "last_ms": None, "max_ms": 0.0,
                     "version": None}

    # -- observation ----------------------------------------------------------

    def observe(self, host: str, value, *, buckets: int,
                records: int = 0, local: bool = False,
                version: int = 0, now_ns: Optional[int] = None) -> None:
        """Record one host's digest.  ``local=True`` marks this node's
        own catalog; peers come from push-pull annotations.  ``now_ns``
        is the catalog's clock, so time to coherence follows an injected
        clock."""
        if not self.enabled or not host:
            return
        value = digest_ops.digest_value(value)
        with self._lock:
            ent = self._hosts.get(host)
            if ent is None and not local \
                    and len(self._hosts) >= self.max_peers:
                self._overflow += 1
                return
            changed = ent is None or ent["value"] != value
            self._hosts[host] = {"value": value, "buckets": int(buckets),
                                 "records": int(records),
                                 "seen_ns": now_ns, "local": local}
            if local:
                self._local = host
                if changed and self._mark is None:
                    self._mark = (int(version), now_ns)
            metrics.incr("coherence.observed")
            self._refresh(now_ns)

    def observe_doc(self, host: str, doc,
                    now_ns: Optional[int] = None) -> bool:
        """Take a peer's wire annotation (``{"Buckets", "Records",
        "Hex"}``).  A malformed one returns False and never raises: it
        comes from a peer, and must not end the merge."""
        if not self.enabled or not host or not isinstance(doc, dict):
            return False
        try:
            buckets = int(doc["Buckets"])
            value = digest_ops.digest_from_hex(str(doc["Hex"]))
            if len(value) != 2 * buckets:
                return False
            records = int(doc.get("Records", 0))
        except (KeyError, TypeError, ValueError, OverflowError):
            return False
        self.observe(host, value, buckets=buckets, records=records,
                     now_ns=now_ns)
        return True

    # -- verdicts (under self._lock) -------------------------------------------

    def _comparable(self) -> tuple:
        """The hosts whose geometry is the local one's (or the first
        seen, before any local digest), sorted, and that bucket count."""
        if not self._hosts:
            return (), 0
        ref = self._hosts.get(self._local) if self._local else None
        buckets = ref["buckets"] if ref else \
            next(iter(self._hosts.values()))["buckets"]
        hosts = tuple(sorted(h for h, e in self._hosts.items()
                             if e["buckets"] == buckets))
        return hosts, buckets

    def _quorum(self, hosts) -> tuple:
        """(modal digest, its count) over ``hosts``; ties go to the
        smallest value."""
        tally: dict = {}
        for h in hosts:
            v = self._hosts[h]["value"]
            tally[v] = tally.get(v, 0) + 1
        value, count = min(tally.items(), key=lambda kv: (-kv[1], kv[0]))
        return value, count

    def _refresh(self, now_ns: Optional[int]) -> None:
        hosts, _ = self._comparable()
        metrics.set_gauge("coherence.peers", len(self._hosts))
        if not hosts:
            return
        quorum, count = self._quorum(hosts)
        agreement = count / len(hosts)
        diverged = sum(
            digest_ops.diff_buckets_py(self._hosts[h]["value"], quorum)
            for h in hosts if self._hosts[h]["value"] != quorum)
        metrics.set_gauge("coherence.agreement", agreement)
        metrics.set_gauge("coherence.diverged.estimate", diverged)
        if agreement == 1.0 and self._mark is not None:
            if len(hosts) >= 2:
                # Coherence regained across real peers closes the
                # window; a view of one host holds the mark.
                version, t0 = self._mark
                if now_ns is not None and t0 is not None:
                    ttc_ms = max(0.0, (now_ns - t0) / 1e6)
                    metrics.histogram("coherence.ttc", ttc_ms)
                    self._ttc["count"] += 1
                    self._ttc["last_ms"] = round(ttc_ms, 3)
                    self._ttc["max_ms"] = max(self._ttc["max_ms"],
                                              round(ttc_ms, 3))
                    self._ttc["version"] = version
                self._mark = None

    # -- reading ----------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/api/coherence.json`` document."""
        with self._lock:
            doc: dict = {"enabled": self.enabled,
                         "max_peers": self.max_peers,
                         "local": self._local,
                         "overflow_peers": self._overflow}
            if not self.enabled:
                return doc
            hosts, buckets = self._comparable()
            doc["buckets"] = buckets
            doc["hosts"] = {}
            if hosts:
                quorum, count = self._quorum(hosts)
                diffs = {h: digest_ops.diff_buckets_py(
                    self._hosts[h]["value"], quorum) for h in hosts}
                for h in hosts:
                    ent = self._hosts[h]
                    doc["hosts"][h] = {
                        "records": ent["records"],
                        "local": ent["local"],
                        "agree": diffs[h] == 0,
                        "diff_vs_quorum": diffs[h],
                    }
                doc["quorum"] = {
                    "hex": digest_ops.digest_to_hex(quorum),
                    "count": count,
                    "agreement": round(count / len(hosts), 6),
                }
                doc["diverged_estimate"] = sum(diffs.values())
                doc["matrix"] = {
                    "hosts": list(hosts),
                    "diff": [[digest_ops.diff_buckets_py(
                        self._hosts[a]["value"], self._hosts[b]["value"])
                        for b in hosts] for a in hosts],
                }
            doc["ttc"] = dict(self._ttc)
            doc["pending_change"] = self._mark is not None
            return doc

    def reset(self) -> None:
        """Clear the host table and the ttc accounting."""
        with self._lock:
            self._hosts.clear()
            self._local = None
            self._overflow = 0
            self._mark = None
            self._ttc = {"count": 0, "last_ms": None, "max_ms": 0.0,
                         "version": None}


# The process-wide monitor: the catalog writer publishes local digests
# through it and merge() feeds it the peers' annotations.
monitor = CoherenceMonitor()


def configure(enabled: bool = True,
              max_peers: Optional[int] = None) -> None:
    """Set the global monitor's gates (the reference's ``configure`` with
    its environment variables unset: on by default); ``max_peers=None``
    keeps the bound as it is."""
    monitor.enabled = enabled
    if max_peers is not None:
        monitor.max_peers = max_peers


def observe(host: str, value, *, buckets: int, records: int = 0,
            local: bool = False, version: int = 0,
            now_ns: Optional[int] = None) -> None:
    monitor.observe(host, value, buckets=buckets, records=records,
                    local=local, version=version, now_ns=now_ns)


def observe_doc(host: str, doc, now_ns: Optional[int] = None) -> bool:
    return monitor.observe_doc(host, doc, now_ns=now_ns)


def snapshot() -> dict:
    return monitor.snapshot()
