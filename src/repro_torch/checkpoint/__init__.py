"""Committed checkpoints (``manager``): the store's durable base snapshots
and, later, training state; the reference's file format."""
