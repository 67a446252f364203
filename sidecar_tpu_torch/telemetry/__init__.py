"""Measurement-side instruments of the port: ``cost.py`` (the phase
scopes of the round), ``slo.py`` (the SLO rule grammar and its
evaluator), ``span.py`` (the span ring the sweep and the catalog writer
record into), and the live catalog's monitors, ``coherence.py`` (peer
digests, quorum agreement, time to coherence) and ``propagation.py``
(per-origin propagation lag)."""
