"""Operator SLOs → one scalar over fleet rows — the port of
``sidecar_tpu/autopilot/objective.py``, its arithmetic in Python floats
in the reference's order, so equal rows give equal scores.

The objective is the autopilot's contract with the operator: the SAME
``telemetry/slo.py`` rule grammar humans write for ``POST /sweep``
verdicts and the bench gate ("converge <= 5 s", "agreement >= 0.99",
"p99 <= 12 rounds") is what the optimizer minimizes — there is no
second, private notion of "good" that could diverge from the one the
verdict surface reports.

Scoring (minimized):

* every PASSING rule contributes 0;
* a FAILING rule contributes ``PENALTY · (1 + violation)`` where
  ``violation`` is the relative overshoot (capped — one hopeless rule
  must not flatten the gradient of the others);
* a rule that could not be evaluated contributes the base ``PENALTY``
  and a never-converged row the capped maximum — unevaluable never
  outranks measured-and-failing, and neither ever beats a pass;
* ties among SLO-clean candidates break on a bounded-in-[0,1) blend
  of normalized rounds-to-ε and exchange bytes, so the recommendation
  is the CHEAPEST config meeting the SLO, not merely any config.

The penalty scale dwarfs the tiebreaker by construction: no volume of
saved bytes can buy back a failed SLO.
"""

from __future__ import annotations

from typing import Optional

from sidecar_tpu_torch.telemetry.slo import SloEvaluator

PENALTY = 1000.0      # one failed/unevaluable rule
VIOLATION_CAP = 10.0  # relative-overshoot cap per rule


def _violation(verdict: dict) -> float:
    """Relative overshoot of a failed rule, 0 when unmeasurable."""
    obs, thr = verdict.get("observed"), float(verdict["threshold"])
    if obs is None:
        return VIOLATION_CAP
    if verdict.get("unit") == "ms":
        thr /= 1e3            # observed is in seconds (slo.py contract)
    scale = max(abs(thr), 1e-9)
    if verdict["direction"] == ">=":
        return min(max((thr - obs) / scale, 0.0), VIOLATION_CAP)
    return min(max((obs - thr) / scale, 0.0), VIOLATION_CAP)


class Objective:
    """Scalarize SLO verdicts + cost over one fleet result row."""

    def __init__(self, rules, *, seconds_per_round: Optional[float] = None,
                 bytes_scale: float = 1e8) -> None:
        self.evaluator = rules if isinstance(rules, SloEvaluator) \
            else SloEvaluator(rules)
        self.seconds_per_round = seconds_per_round
        self.bytes_scale = float(bytes_scale)

    @property
    def rules_text(self) -> list:
        return [r.text() for r in self.evaluator.rules]

    def score_row(self, row: dict, lag: Optional[dict] = None,
                  horizon: Optional[int] = None) -> tuple:
        """(score, verdict block) for one ``FleetRun.table`` row —
        lower is better; the verdict block is the ``evaluate_row``
        document the sweep surface returns for the same row."""
        block = self.evaluator.evaluate_row(
            row, lag=lag, seconds_per_round=self.seconds_per_round,
            publish=False)
        score = 0.0
        for v in block["rules"]:
            if v["pass"] is True:
                continue
            if v["pass"] is False:
                score += PENALTY * (1.0 + _violation(v))
            else:                      # unevaluable — never a free pass
                score += PENALTY
        r = row.get("rounds_to_eps")
        hz = max(int(horizon or row.get("rounds_run") or 1), 1)
        rounds_term = min((r if r is not None else hz) / hz, 1.0)
        xb = float(row.get("exchange_bytes") or 0.0)
        bytes_term = xb / (xb + self.bytes_scale)
        return score + 0.45 * rounds_term + 0.45 * bytes_term, block
