"""Measurement-side instruments of the port: ``cost.py`` (the phase
scopes of the round) and ``slo.py`` (the SLO rule grammar and its
evaluator)."""
