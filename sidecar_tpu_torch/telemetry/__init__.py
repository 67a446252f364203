"""Measurement-side instruments of the port: ``cost.py`` (the phase
scopes of the round), ``slo.py`` (the SLO rule grammar and its
evaluator) and ``span.py`` (the span ring the sweep records into)."""
