"""Measurement-side instruments of the port (``cost.py``: the phase
scopes of the round)."""
