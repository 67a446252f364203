"""Software-pipelined round execution — the port of
``sidecar_tpu/ops/pipeline.py``: the mode resolution shared by both
models, and the carry of a pipelined run (:class:`Inflight`).

A pipelined tick folds round r's carried publish while it selects round
r+1's from the PRE-fold state: a message selected for round r+1
reflects its sender's belief before round r's deliveries landed (one
round stale, honestly).  The mode changes round semantics, so
``"auto"`` never turns it on: only ``pipeline=True`` on a dispatch, or
mode ``"1"``, does.

Modes come from the constructor argument only (None is ``"auto"``;
``"on"``/``"off"`` alias ``"1"``/``"0"``); each resolution is counted as
``pipeline.mode.<mode>`` in the process registry
(``sidecar_tpu_torch/metrics.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from sidecar_tpu_torch import metrics
from sidecar_tpu_torch.ops.gossip import RoundDraws

PIPELINE_MODES = ("auto", "0", "1")


def resolve_pipeline(explicit: Optional[str] = None) -> str:
    """The pipelined-execution mode of a sim, ``"auto" | "0" | "1"``,
    from its constructor argument (None is ``"auto"``), counted as
    ``pipeline.mode.<mode>``."""
    mode = "auto" if explicit is None else explicit
    mode = {"on": "1", "off": "0"}.get(mode, mode)
    if mode not in PIPELINE_MODES:
        raise ValueError(
            f"pipeline mode must be one of {PIPELINE_MODES}, got "
            f"{explicit!r}")
    metrics.incr(f"pipeline.mode.{mode}")
    return mode


def resolve_request(mode: str, pipeline,
                    supports_pipeline: bool = True) -> bool:
    """Per-dispatch resolution: ``pipeline=None`` follows the sim's mode
    (on only under ``"1"``, and off on a sim without the path); an
    explicit ``True`` raises under mode ``"0"`` or on a sim that cannot
    run it."""
    if pipeline is None:
        pipeline = mode == "1"
        if pipeline and not supports_pipeline:
            return False
    if pipeline and (mode == "0" or not supports_pipeline):
        raise ValueError(
            "pipelined execution is disabled or unsupported on this sim "
            f"(mode={mode!r}, supports_pipeline={supports_pipeline})")
    return bool(pipeline)


@dataclasses.dataclass(frozen=True)
class Inflight:
    """The carry of a pipelined run: round r's publish, selected in the
    tick before (the compressed model's ``(src, bval, bslot)``, the
    exact model's ``(dst, svc_idx, msg)``), and round r's whole
    :class:`RoundDraws`, whose loss mask, stride and push-pull partner
    the tick that folds round r uses."""

    round_idx: int          # the round this publish belongs to
    publish: tuple
    draws: RoundDraws
