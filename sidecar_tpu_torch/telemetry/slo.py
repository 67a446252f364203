"""Convergence-SLO evaluator — the port of ``sidecar_tpu/telemetry/
slo.py``: declarative rules of the form "p99 lag <= R rounds", "converge
<= S s" or "agreement >= f", turned into verdicts over a lag summary
(:meth:`SloEvaluator.evaluate_lag`), a fleet result row
(:meth:`SloEvaluator.evaluate_row`, the contract the autopilot's
objective shares) or the port's metrics registry
(:meth:`SloEvaluator.evaluate_live` over the ``propagation.query.lag``
histogram, :meth:`SloEvaluator.evaluate_coherence` over ``coherence.ttc``
and the ``coherence.agreement`` gauge).  A published verdict sets the
``slo.<rule>.observed`` and ``slo.<rule>.ok`` gauges.

Rule syntax (one string per rule): ``"<pctl> <= <threshold> <unit>"``
with pctl in {p50, p95, p99, max, converge} and unit in {rounds, s,
seconds, ms}, or the floor form ``"agreement >= <fraction>"``.  The
error texts are the reference's, word for word.

The reference's ``from_env`` and ``coherence_from_env`` read the
``BENCH_SLO*`` environment variables; the port reads none, so they are
not ported: a caller passes its rules (or :data:`DEFAULT_RULES`,
:data:`DEFAULT_COHERENCE_RULES`) to :class:`SloEvaluator`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from sidecar_tpu_torch import metrics

DEFAULT_RULES = ("p99 <= 16 rounds", "p99 <= 2 s")
DEFAULT_COHERENCE_RULES = ("p99 <= 2 s", "agreement >= 0.99")

_RULE_RE = re.compile(
    r"^\s*(p50|p95|p99|max|converge)\s*<=\s*([0-9.]+)\s*"
    r"(rounds?|seconds?|s|ms)\s*$", re.IGNORECASE)
# Floor form — a LOWER bound on a unitless fraction gauge
# ("agreement >= 0.99"): the coherence plane's quorum-agreement SLO.
_FLOOR_RE = re.compile(
    r"^\s*(agreement)\s*>=\s*([0-9.]+)\s*$", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One declarative bound: a lag-percentile ceiling (``<=``) or a
    fraction floor (``>=``)."""

    percentile: str          # p50 | p95 | p99 | max | converge | agreement
    threshold: float         # in `unit`
    unit: str                # "rounds" | "s" | "ms" | "fraction"
    direction: str = "<="    # "<=" ceiling | ">=" floor

    @classmethod
    def parse(cls, text: str) -> "SloRule":
        m = _RULE_RE.match(text)
        if m:
            pctl, raw, unit = m.group(1).lower(), m.group(2), \
                m.group(3).lower()
            unit = {"round": "rounds", "rounds": "rounds", "s": "s",
                    "second": "s", "seconds": "s", "ms": "ms"}[unit]
            return cls(percentile=pctl, threshold=float(raw), unit=unit)
        m = _FLOOR_RE.match(text)
        if m:
            return cls(percentile=m.group(1).lower(),
                       threshold=float(m.group(2)), unit="fraction",
                       direction=">=")
        raise ValueError(
            f"bad SLO rule {text!r}: expected "
            "'<p50|p95|p99|max|converge> <= <threshold> "
            "<rounds|s|ms>' or 'agreement >= <fraction>'")

    @property
    def key(self) -> str:
        """The metric-name fragment: ``slo.<key>.ok`` /
        ``slo.<key>.observed``."""
        thr = f"{self.threshold:g}".replace(".", "_")
        suffix = "" if self.unit == "fraction" else self.unit
        return f"{self.percentile}_{thr}{suffix}"

    def text(self) -> str:
        if self.direction == ">=":
            return f"{self.percentile} >= {self.threshold:g}"
        if self.percentile == "converge":
            return f"converge <= {self.threshold:g} {self.unit}"
        return (f"{self.percentile} lag <= {self.threshold:g} "
                f"{self.unit}")

    def check(self, observed: float) -> bool:
        return observed >= self.threshold if self.direction == ">=" \
            else observed <= self.threshold


def _threshold_seconds(rule: SloRule) -> float:
    return rule.threshold / 1e3 if rule.unit == "ms" \
        else rule.threshold


class SloEvaluator:
    """Evaluate a rule set against lag summaries and publish the
    verdicts as gauges."""

    def __init__(self, rules) -> None:
        self.rules = tuple(SloRule.parse(r) if isinstance(r, str)
                           else r for r in rules)

    # -- evaluation ---------------------------------------------------------

    def evaluate_lag(self, lag: Optional[dict],
                     seconds_per_round: Optional[float] = None,
                     publish: bool = True) -> dict:
        """Verdict block for a sim-side pooled lag summary
        (ops/provenance.pooled_lag: percentiles in ROUNDS).  Rules in
        seconds are checked through ``seconds_per_round`` (the
        protocol clock) and skipped — verdict null — when no clock or
        no samples are available; a rule that cannot be evaluated
        never passes silently."""
        verdicts = []
        for rule in self.rules:
            observed = None
            if rule.direction == "<=" and lag and lag.get("samples"):
                rounds_v = lag.get(rule.percentile)
                if rounds_v is not None:
                    if rule.unit == "rounds":
                        observed, thr = float(rounds_v), rule.threshold
                    elif seconds_per_round is not None:
                        observed = float(rounds_v) * seconds_per_round
                        thr = _threshold_seconds(rule)
            ok = None if observed is None else observed <= thr
            verdicts.append(self._verdict(rule, observed, ok, publish))
        return self._block(verdicts)

    def evaluate_row(self, row: dict, lag: Optional[dict] = None,
                     seconds_per_round: Optional[float] = None,
                     publish: bool = False) -> dict:
        """Verdict block for ONE fleet-sweep result row
        (fleet/engine.FleetRun.table): the contract ``POST /sweep``
        per-config verdicts and the autopilot objective share.

        * ``converge`` rules bound ``rounds_to_eps`` (rounds unit) or
          ``seconds_to_eps`` (s/ms).  A row that RAN but never reached
          ε is an honest FAIL (observed null, pass false) — never a
          null verdict: "never converged" violates every convergence
          ceiling.
        * percentile rules (p50/p95/p99/max) bound the row's pooled
          propagation-lag summary (``lag``), rounds directly, s/ms via
          ``seconds_per_round``; unevaluable → null.
        * ``agreement >= f`` floors bound ``digest_agreement``;
          null when the row carries no digest."""
        verdicts = []
        for rule in self.rules:
            observed, ok = None, None
            if rule.direction == ">=":
                g = row.get("digest_agreement")
                if g is not None:
                    observed = float(g)
                    ok = observed >= rule.threshold
            elif rule.percentile == "converge":
                if rule.unit == "rounds":
                    v = row.get("rounds_to_eps")
                    thr = rule.threshold
                else:
                    v = row.get("seconds_to_eps")
                    thr = _threshold_seconds(rule)
                if v is not None:
                    observed = float(v)
                    ok = observed <= thr
                elif row.get("rounds_run"):
                    ok = False      # ran the horizon, never converged
            elif lag and lag.get("samples"):
                rounds_v = lag.get(rule.percentile)
                if rounds_v is not None:
                    if rule.unit == "rounds":
                        observed = float(rounds_v)
                        ok = observed <= rule.threshold
                    elif seconds_per_round is not None:
                        observed = float(rounds_v) * seconds_per_round
                        ok = observed <= _threshold_seconds(rule)
            verdicts.append(self._verdict(rule, observed, ok, publish))
        return self._block(verdicts)

    def evaluate_live(self, publish: bool = True) -> dict:
        """Verdict block for the LIVE path: seconds/ms rules checked
        against the pooled ``propagation.query.lag`` histogram (the
        end-to-end site); rounds rules are sim-only and report null
        here."""
        hists = metrics.snapshot().get("histograms", {})
        h = hists.get("propagation.query.lag")
        verdicts = []
        for rule in self.rules:
            observed = None
            if rule.direction == "<=" and rule.unit != "rounds" \
                    and h and h.get("count"):
                pct_ms = h.get(f"{rule.percentile}_ms") \
                    if rule.percentile != "max" else h.get("max_ms")
                if pct_ms is not None:
                    observed = float(pct_ms) / 1e3
                    thr = _threshold_seconds(rule)
            ok = None if observed is None else observed <= thr
            verdicts.append(self._verdict(rule, observed, ok, publish))
        return self._block(verdicts)

    def evaluate_coherence(self, publish: bool = True) -> dict:
        """Verdict block for the coherence plane
        (telemetry/coherence.py): percentile rules (s/ms) bound the
        ``coherence.ttc`` time-to-coherence histogram; floor rules
        (``agreement >= f``) bound the live ``coherence.agreement``
        gauge.  Rounds rules are sim-only and report null, as does any
        rule whose signal has no observations yet — an unevaluable
        rule never passes silently.  Gauges land under
        ``slo.coherence.<rule>.*``."""
        snap = metrics.snapshot()
        h = snap.get("histograms", {}).get("coherence.ttc")
        gauges = snap.get("gauges", {})
        verdicts = []
        for rule in self.rules:
            observed = None
            thr = rule.threshold
            if rule.direction == ">=":
                g = gauges.get("coherence.agreement")
                if g is not None:
                    observed = float(g)
            elif rule.unit != "rounds" and h and h.get("count"):
                pct_ms = h.get(f"{rule.percentile}_ms") \
                    if rule.percentile != "max" else h.get("max_ms")
                if pct_ms is not None:
                    observed = float(pct_ms) / 1e3
                    thr = _threshold_seconds(rule)
            ok = None if observed is None else (
                observed >= thr if rule.direction == ">="
                else observed <= thr)
            verdicts.append(self._verdict(rule, observed, ok, publish,
                                          prefix="coherence."))
        return self._block(verdicts)

    def _verdict(self, rule: SloRule, observed, ok,
                 publish: bool, prefix: str = "") -> dict:
        if publish and ok is not None:
            if observed is not None:
                metrics.set_gauge(f"slo.{prefix}{rule.key}.observed",
                                  observed)
            metrics.set_gauge(f"slo.{prefix}{rule.key}.ok",
                              1.0 if ok else 0.0)
        return {"rule": rule.text(),
                "percentile": rule.percentile,
                "threshold": rule.threshold,
                "unit": rule.unit,
                "direction": rule.direction,
                "observed": observed,
                "pass": ok}

    @staticmethod
    def _block(verdicts: list) -> dict:
        evaluated = [v for v in verdicts if v["pass"] is not None]
        return {"rules": verdicts,
                "evaluated": len(evaluated),
                "pass": all(v["pass"] for v in evaluated)
                if evaluated else None}
