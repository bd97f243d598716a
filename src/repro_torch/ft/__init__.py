"""Fault tolerance: the restart supervisor and heartbeats (``failures``),
straggler detection (``stragglers``). Pure Python, no device."""
