"""Digest-directed anti-entropy — the port of
``sidecar_tpu/transport/antientropy.py``, the rsync-style push-pull
body.

A full-catalog push-pull body costs O(catalog) bytes however little
diverged.  Two peers that both advertise a Merkle ladder (the
``"Ladder"`` key in the ``"Digest"`` annotation of
``encode_annotated``, the version gate) walk it level by level and then
exchange only the records that hash into differing leaf buckets, so a
session's body is O(divergence · depth).

The initiator drives request and response over a :class:`Channel`:

1. **HELLO** — geometry ``(base, depth)`` and the level-0 digest.
   Equal digests end the session with no record bytes; a geometry
   mismatch falls back.
2. **NARROW** — for each deeper level, the initiator sends its digests
   of the children of the differing parents; the responder answers
   with the children that differ on its side.
3. **TRANSFER** — the initiator sends its records in the differing leaf
   buckets; the responder takes its own records in those buckets
   before it merges, merges the initiator's (the ``add_service_entry``
   kernel, latest stamp wins) and replies with its own, which the
   initiator merges.  Tombstones travel too.
4. **VERIFY** — one more level-0 compare seals the verdict.

Every request runs with bounded retries and exponential backoff with
jitter (deterministic under an injected ``rng`` and ``sleep``).  Any
failure — channel errors past the retries, a ladder mismatch, a
protocol surprise — falls back to one full-body exchange over the same
channel (``antientropy.fallbacks``); if that fails too the session
reports ``failed`` (``antientropy.failures``).  A plain-wire peer (no
``"Ladder"``) goes straight to the full body (``antientropy.plainwire``).

Metrics: ``antientropy.sessions``, ``.fallbacks``, ``.plainwire``,
``.retries``, ``.failures``, ``.records``, ``.backoff_ms``, ``.bytes``.
Where the reference reads ``SIDECAR_TPU_ANTIENTROPY*``, the port takes
``ReconcileSession(..., enabled=True)`` and the :class:`SessionConfig`
defaults (the ladder depth is ``ServicesState(..., ladder_depth=)``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import time
from typing import Callable, List, Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.catalog import state as state_mod
from sidecar_tpu_torch.ops import digest as digest_ops
from sidecar_tpu_torch.service import Service
from sidecar_tpu_torch.telemetry import coherence as _coherence

log = logging.getLogger(__name__)


class ChannelError(Exception):
    """A transport-level failure of one request attempt (retryable)."""


class ProtocolError(Exception):
    """The peer answered, but not in the session's language — a ladder
    mismatch, an error document, or a shape surprise (NOT retryable:
    the same request would fail the same way; fall back instead)."""


class SessionError(Exception):
    """A request exhausted its retry budget."""


class Channel:
    """Minimal request/response transport the session drives.  One
    ``send`` is one attempt; raise :class:`ChannelError` (or
    ``TimeoutError``/``OSError``) to signal a retryable failure."""

    def send(self, doc: dict, timeout: float) -> dict:
        raise NotImplementedError


class LoopbackChannel(Channel):
    """In-process channel onto a responder — the test/bench transport.
    ``fail`` is an optional hook called per attempt (raise from it to
    inject channel failures deterministically)."""

    def __init__(self, responder: "AntiEntropyResponder",
                 fail: Optional[Callable[[dict], None]] = None):
        self.responder = responder
        self.fail = fail
        self.requests: List[dict] = []

    def send(self, doc: dict, timeout: float) -> dict:
        self.requests.append(doc)
        if self.fail is not None:
            self.fail(doc)
        return self.responder.handle(doc)


def _doc_bytes(doc: dict) -> int:
    return len(json.dumps(doc, separators=(",", ":")).encode())


def _bucket_hex(value: tuple, bucket: int) -> str:
    return f"{value[2 * bucket]:08x}{value[2 * bucket + 1]:08x}"


def deliver_records(state, docs, origin: str = "") -> int:
    """Apply a list of Service JSON docs through the LWW merge kernel
    (synchronous — the session's VERIFY step must observe the result).
    Malformed records are skipped loudly, never fatally: one bad
    record must not abort the whole reconciliation."""
    n = 0
    for d in docs:
        try:
            svc = Service.from_json(d)
        except (TypeError, ValueError, KeyError, AttributeError) as exc:
            log.warning("anti-entropy: dropping malformed record from "
                        "%s: %s", origin or "peer", exc)
            continue
        state.add_service_entry(svc)
        n += 1
    if n:
        metrics.incr("antientropy.records", n)
    return n


class AntiEntropyResponder:
    """The passive side of a session: answers HELLO / LEVEL / PULL /
    FULL requests against one :class:`ServicesState`.  Stateless
    between requests — every answer is computed from the catalog as it
    is now, so a responder can serve many concurrent initiators."""

    def __init__(self, state):
        self.state = state

    def handle(self, doc: dict) -> dict:
        try:
            kind = doc.get("T")
            if kind == "hello":
                return self._hello()
            if kind == "level":
                return self._level(doc)
            if kind == "pull":
                return self._pull(doc)
            if kind == "full":
                return self._full(doc)
            return {"T": "error", "Reason": f"unknown request {kind!r}"}
        except Exception as exc:  # noqa: BLE001 — answer, don't kill
            log.warning("anti-entropy responder error: %s", exc)
            return {"T": "error", "Reason": str(exc)}

    def _hello(self) -> dict:
        base, depth = self.state.ladder_geometry()
        count, value = self.state.digest_snapshot
        return {"T": "hello", "Base": base, "Depth": depth,
                "Records": count,
                "Hex": digest_ops.digest_to_hex(value)}

    def _level(self, doc: dict) -> dict:
        level = int(doc["Level"])
        _, depth = self.state.ladder_geometry()
        if not 0 < level < depth:
            return {"T": "error", "Reason": f"bad level {level}"}
        mine = self.state.digest_level(level)
        diff = []
        for raw_id, hex16 in doc["Buckets"].items():
            b = int(raw_id)
            if _bucket_hex(mine, b) != hex16:
                diff.append(b)
        return {"T": "level", "Level": level, "Diff": sorted(diff)}

    def _pull(self, doc: dict) -> dict:
        leaf = int(doc["Leaf"])
        buckets = [int(b) for b in doc["Buckets"]]
        # Capture OUR divergent view BEFORE merging the initiator's
        # records — afterwards the buckets would contain their records
        # too and the reply would echo bytes the peer already has.
        mine = self.state.services_in_buckets(buckets, leaf)
        deliver_records(self.state, doc.get("Services") or (),
                        origin=str(doc.get("From") or ""))
        return {"T": "push",
                "Services": [svc.to_json() for svc in mine]}

    def _full(self, doc: dict) -> dict:
        # Capture our body BEFORE merging theirs (the _pull convention).
        body = json.loads(self.state.encode_annotated())
        merge_body(self.state, doc.get("Body"))
        return {"T": "full", "Body": body}


def merge_body(state, body) -> int:
    """Merge a full-state JSON document (the ``encode_annotated`` wire
    form) synchronously: harvest the coherence annotation like
    ``merge()`` does, then run every record through the LWW kernel."""
    if not isinstance(body, dict):
        raise ProtocolError("full-body exchange: body is not an object")
    remote = state_mod.decode(json.dumps(body))
    origin = remote.hostname
    if origin and origin != state.hostname and remote.wire_digest:
        _coherence.observe_doc(origin, remote.wire_digest,
                               now_ns=state._now())
    n = 0
    for _, _, svc in remote.each_service_sorted():
        state.add_service_entry(svc.copy())
        n += 1
    return n


@dataclasses.dataclass
class SessionConfig:
    """Retry and backoff of one session, at the reference's defaults."""

    retries: int = 3           # extra attempts per request
    timeout_s: float = 2.0     # per-attempt budget handed to the channel
    backoff_ms: float = 50.0   # base delay; attempt k waits base * 2^k
    jitter: float = 0.5        # uniform [0, jitter) multiplier on top
    verify: bool = True        # seal with a second level-0 compare


@dataclasses.dataclass
class SessionReport:
    """What one session did — the bench's raw material.  ``mode`` is
    ``digest`` (ladder walk ran), ``full`` (fallback or plain-wire
    full-body exchange), or ``failed`` (even the fallback failed)."""

    mode: str = "digest"
    coherent: Optional[bool] = None
    bytes_sent: int = 0
    bytes_received: int = 0
    digest_bytes: int = 0      # hello/level/verify traffic
    record_bytes: int = 0      # pull/push/full traffic
    records_sent: int = 0
    records_received: int = 0
    levels_walked: int = 0
    retries: int = 0
    fallback_reason: Optional[str] = None
    states: List[str] = dataclasses.field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return self.bytes_sent + self.bytes_received


class ReconcileSession:
    """One initiator-side reconciliation against one peer channel.

    ``peer_doc`` — the peer's ``"Digest"`` annotation when already
    known (harvested from a previous push-pull body): a peer without a
    ``"Ladder"`` advertisement is version-gated straight to the
    full-body exchange without burning a hello round-trip.
    ``rng``/``sleep`` are injectable for deterministic backoff tests.
    """

    def __init__(self, state, channel: Channel,
                 config: Optional[SessionConfig] = None,
                 peer_doc: Optional[dict] = None,
                 enabled: bool = True,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.state = state
        self.channel = channel
        self.cfg = config or SessionConfig()
        self.peer_doc = peer_doc
        self.enabled = enabled
        self._rng = rng or random.Random()
        self._sleep = sleep
        self.report = SessionReport()

    # -- retry/backoff spine ------------------------------------------------

    def _send(self, doc: dict, kind: str) -> dict:
        """One request with the session's retry discipline.  ``kind``
        routes byte accounting (digest vs record traffic)."""
        last: Optional[BaseException] = None
        for attempt in range(self.cfg.retries + 1):
            if attempt:
                delay_ms = self.cfg.backoff_ms * (2 ** (attempt - 1))
                delay_ms *= 1.0 + self.cfg.jitter * self._rng.random()
                metrics.histogram("antientropy.backoff_ms", delay_ms)
                metrics.incr("antientropy.retries")
                self.report.retries += 1
                self._sleep(delay_ms / 1000.0)
            try:
                resp = self.channel.send(doc, timeout=self.cfg.timeout_s)
            except (ChannelError, TimeoutError, OSError) as exc:
                last = exc
                log.warning("anti-entropy %s attempt %d/%d failed: %s",
                            doc.get("T"), attempt + 1,
                            self.cfg.retries + 1, exc)
                continue
            sent = _doc_bytes(doc)
            got = _doc_bytes(resp) if isinstance(resp, dict) else 0
            self.report.bytes_sent += sent
            self.report.bytes_received += got
            if kind == "digest":
                self.report.digest_bytes += sent + got
            else:
                self.report.record_bytes += sent + got
            metrics.incr("antientropy.bytes", sent + got)
            if not isinstance(resp, dict):
                raise ProtocolError(f"non-object response to "
                                    f"{doc.get('T')!r}")
            if resp.get("T") == "error":
                raise ProtocolError(str(resp.get("Reason")))
            return resp
        raise SessionError(
            f"{doc.get('T')!r} failed after {self.cfg.retries + 1} "
            f"attempts: {last}")

    # -- the state machine --------------------------------------------------

    def run(self) -> SessionReport:
        metrics.incr("antientropy.sessions")
        rep = self.report
        if not self.enabled:
            return self._full_body("disabled")
        if self.peer_doc is not None and \
                not isinstance(self.peer_doc.get("Ladder"), dict):
            # Version gate: the peer never advertised a ladder — it
            # speaks today's full-body wire, so give it exactly that.
            metrics.incr("antientropy.plainwire")
            return self._full_body("plain-wire peer", plain=True)
        try:
            return self._digest_directed()
        except (ProtocolError, SessionError) as exc:
            metrics.incr("antientropy.fallbacks")
            log.warning(
                "anti-entropy: digest-directed session failed (%s) — "
                "falling back to ONE full-body exchange", exc)
            return self._full_body(str(exc))
        finally:
            rep.states.append("DONE" if rep.mode != "failed"
                              else "FAILED")

    def _digest_directed(self) -> SessionReport:
        rep = self.report
        base, depth = self.state.ladder_geometry()
        leaf_buckets = base << (depth - 1)

        rep.states.append("HELLO")
        hello = self._send({"T": "hello", "Base": base, "Depth": depth,
                            "From": self.state.hostname,
                            "Hex": digest_ops.digest_to_hex(
                                self.state.digest_snapshot[1])},
                           "digest")
        try:
            if int(hello["Base"]) != base or int(hello["Depth"]) != depth:
                raise ProtocolError(
                    f"ladder mismatch: peer ({hello.get('Base')}, "
                    f"{hello.get('Depth')}) vs local ({base}, {depth})")
            theirs0 = digest_ops.digest_from_hex(str(hello["Hex"]))
        except (KeyError, TypeError, ValueError) as exc:
            raise ProtocolError(f"malformed hello: {exc}") from exc
        mine0 = self.state.digest_level(0)
        if len(theirs0) != len(mine0):
            raise ProtocolError("ladder mismatch: level-0 width")
        diff = digest_ops.diff_bucket_ids(mine0, theirs0)
        if not diff:
            rep.coherent = True
            return rep

        rep.states.append("NARROW")
        for level in range(1, depth):
            children = sorted(c for b in diff for c in (2 * b, 2 * b + 1))
            mine = self.state.digest_level(level)
            resp = self._send(
                {"T": "level", "Level": level,
                 "Buckets": {str(c): _bucket_hex(mine, c)
                             for c in children}},
                "digest")
            try:
                diff = sorted(int(b) for b in resp["Diff"])
            except (KeyError, TypeError, ValueError) as exc:
                raise ProtocolError(
                    f"malformed level response: {exc}") from exc
            rep.levels_walked += 1
            if not diff:
                break

        if diff:
            rep.states.append("TRANSFER")
            mine_recs = self.state.services_in_buckets(diff, leaf_buckets)
            rep.records_sent = len(mine_recs)
            resp = self._send(
                {"T": "pull", "Leaf": leaf_buckets, "Buckets": diff,
                 "From": self.state.hostname,
                 "Services": [svc.to_json() for svc in mine_recs]},
                "record")
            rep.records_received = deliver_records(
                self.state, resp.get("Services") or (), origin="peer")

        if self.cfg.verify:
            rep.states.append("VERIFY")
            seal = self._send({"T": "hello", "Base": base,
                               "Depth": depth}, "digest")
            rep.coherent = (str(seal.get("Hex")) ==
                            digest_ops.digest_to_hex(
                                self.state.digest_snapshot[1]))
        return rep

    def _full_body(self, reason: str, plain: bool = False
                   ) -> SessionReport:
        rep = self.report
        rep.mode = "full"
        rep.fallback_reason = reason
        rep.states.append("FULL")
        body = json.loads(self.state.encode_annotated()
                          if not plain else self.state.encode())
        try:
            resp = self._send({"T": "full", "Body": body}, "record")
            got = merge_body(self.state, resp.get("Body"))
            rep.records_received = got
            rep.coherent = None   # a one-shot body proves nothing
        except (ProtocolError, SessionError) as exc:
            rep.mode = "failed"
            rep.coherent = False
            metrics.incr("antientropy.failures")
            log.error("anti-entropy: full-body fallback failed: %s", exc)
        return rep


def reconcile(state, channel: Channel, **kw) -> SessionReport:
    """Run one session (the module's one-call surface)."""
    return ReconcileSession(state, channel, **kw).run()
