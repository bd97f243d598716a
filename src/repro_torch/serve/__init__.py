"""Serving steps of the port (decode against a KV cache)."""
