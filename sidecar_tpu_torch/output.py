"""Human-readable output helpers — the port of ``sidecar_tpu/output.py``
(the reference's output/output.go:8-31)."""

from __future__ import annotations

from sidecar_tpu_torch.service import NS_PER_SECOND


def time_ago(when_ns: int, ref_ns: int) -> str:
    """Elapsed time in words, in output.TimeAgo's steps."""
    if when_ns == 0:
        return "never"
    diff = (ref_ns - when_ns) / NS_PER_SECOND
    if diff < 0:
        return "in the future"
    if diff < 1.5:
        return "1 sec ago"
    if diff < 60:
        return f"{int(diff)} secs ago"
    mins = diff / 60
    if mins < 1.5:
        return "1 min ago"
    if mins < 60:
        return f"{int(mins)} mins ago"
    hours = mins / 60
    if hours < 1.5:
        return "1 hour ago"
    if hours < 24:
        return f"{int(hours)} hours ago"
    days = hours / 24
    if days < 1.5:
        return "1 day ago"
    return f"{int(days)} days ago"
