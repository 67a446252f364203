"""The scenario registry of the port (``sim/scenarios.py``)."""
