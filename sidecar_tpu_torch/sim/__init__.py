"""The scenario configs and registry (``sim/scenarios.py``) and the
checkpoints (``sim/checkpoint.py``) of the port."""
