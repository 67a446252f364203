"""A small span tracer — the port of ``sidecar_tpu/telemetry/span.py``.

``with span("bridge.sweep.run"): ...`` times a block and records it,
on exit, into one lock-guarded ring of completed spans (bounded: a
busy path overwrites the oldest).  Spans on one thread nest: a span
opened inside another becomes its child and shares its ``trace_id``.

Every completed span carries a monotonic ``seq``, assigned under the
ring's lock, so seq order is ring order.  :func:`spans_since` is the
cursor read: the spans after ``since``, the resume cursor, and a
``dropped`` count when the cursor fell behind the ring.  ``seq`` never
wraps and keeps counting across :func:`reset_spans`, so an old cursor
stays safe.  :func:`spans_to_chrome` gives the Chrome trace-event form.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Optional

# Ring bound: ~1k completed spans ≈ a few seconds of a busy live path —
# enough to reconstruct recent deliveries, small enough to never matter.
RING_CAPACITY = 1024

_lock = threading.Lock()
_ring: "collections.deque[dict]" = collections.deque(maxlen=RING_CAPACITY)
_ids = itertools.count(1)
# Completion-order cursor: assigned under the lock as a span enters the
# ring, so ring order and seq order agree (span_id is ENTRY order and
# can't page the ring — children complete before their parents).
# ``_last_seq`` mirrors the newest assigned value so the cursor survives
# an empty ring (reset, or everything evicted).
_seq = itertools.count(1)
_last_seq = 0
_tls = threading.local()


class span:
    """Context manager: ``with span("catalog.merge"): ...`` times the
    block and records it into the ring on exit.  Nested spans link to
    their parent and inherit its trace id."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id",
                 "_t0", "_wall0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        with _lock:
            self.span_id = next(_ids)
        parent: Optional[span] = stack[-1] if stack else None
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = parent.trace_id if parent is not None \
            else self.span_id
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        stack = getattr(_tls, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()
        global _last_seq
        with _lock:
            _last_seq = next(_seq)
            _ring.append({
                "seq": _last_seq,
                "name": self.name,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "trace_id": self.trace_id,
                "thread": threading.current_thread().name,
                "start_unix_s": round(self._wall0, 6),
                "duration_ms": round(dur_ms, 3),
                "error": exc_type is not None,
            })
        return False


def spans(limit: Optional[int] = None) -> list[dict]:
    """Completed spans, oldest first (the ring's natural order); with
    ``limit``, only the newest ``limit``."""
    with _lock:
        items = list(_ring)
    if limit is not None and limit >= 0:
        items = items[len(items) - min(limit, len(items)):]
    return items


def spans_since(since: int, limit: Optional[int] = None) -> dict:
    """Cursor read: spans completed after cursor ``since``, OLDEST
    first so ``limit`` pages forward.

    Returns ``{"spans": [...], "next_since": s, "dropped": d}`` —
    resume with ``since=next_since`` to read exactly once.  ``dropped``
    counts spans the ring overwrote before this read (cursor fell more
    than RING_CAPACITY behind); it is never silent truncation.  With
    ``limit``, the FIRST ``limit`` matching spans are returned and
    ``next_since`` points at the last returned one, so a lagging
    reader catches up over successive pages."""
    since = max(0, int(since))
    with _lock:
        items = [s for s in _ring if s["seq"] > since]
        oldest = _ring[0]["seq"] if _ring else _last_seq + 1
        newest = _last_seq
    dropped = max(0, oldest - 1 - since)
    if limit is not None and limit >= 0:
        items = items[:limit]
    next_since = items[-1]["seq"] if items else max(since, newest)
    return {"spans": items, "next_since": next_since,
            "dropped": dropped}


def reset_spans() -> None:
    """Clear the ring (tests).  ``seq`` keeps counting — a cursor from
    before the reset stays valid and simply reads nothing new."""
    with _lock:
        _ring.clear()


def spans_to_chrome(span_dicts: list, pid: int = 1) -> list:
    """Chrome trace-event form of a span list (Perfetto / chrome://
    tracing loadable).

    Each span becomes one complete ("X") event — ``ts``/``dur`` in
    microseconds per the trace-event spec — with its linkage ids
    (span/parent/trace, plus the ring ``seq``) riding in ``args``.
    Thread names map to stable small integer ``tid``s, announced via
    ``thread_name`` metadata events so the viewer shows real names."""
    tids: dict = {}
    events = []
    for s in span_dicts:
        thread = str(s.get("thread") or "main")
        tid = tids.setdefault(thread, len(tids) + 1)
        args = {k: s[k] for k in ("span_id", "parent_id", "trace_id",
                                  "seq") if s.get(k) is not None}
        if s.get("error"):
            args["error"] = s["error"]
        events.append({
            "name": s.get("name", ""),
            "cat": "span",
            "ph": "X",
            "ts": round(float(s.get("start_unix_s") or 0.0) * 1e6, 3),
            "dur": round(float(s.get("duration_ms") or 0.0) * 1e3, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": thread}}
            for thread, tid in tids.items()]
    return meta + events
