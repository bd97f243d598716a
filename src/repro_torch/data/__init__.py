"""Deterministic data pipelines of the port (numpy, host side)."""
