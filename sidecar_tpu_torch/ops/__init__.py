"""Leaf ops of the port: plain functions on tensors (see the package
docstring)."""
