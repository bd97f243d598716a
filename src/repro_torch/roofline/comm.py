"""Collective bytes per device, by the ring model.

The port has no compiled HLO to parse: its collectives are calls into
:mod:`repro_torch.launch.collectives` (one process, a list of shard
tensors) or into its process-group backend (one rank per card).  Each
call records itself here while a :class:`CommCounter` is active, with the
bytes one device's operand and result hold and the size of the group it
joins.  A device moves, for one call over a group of ``s``:

    all-reduce      2 (s-1)/s * operand bytes
    all-gather        (s-1)/s * result bytes
    reduce-scatter    (s-1)/s * operand bytes
    all-to-all        (s-1)/s * operand bytes
    collective-permute          operand bytes

A call over a group of one moves nothing and is not counted.  Besides
the collectives, ``collectives.shard`` records each block it copies to
another device (:func:`record_copy`) under ``"shard-copy"``: the bytes
themselves, not a ring model, kept out of ``per_device_bytes``.
"""

from __future__ import annotations

import threading
from collections import Counter, defaultdict
from typing import Dict, List

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
COPY = "shard-copy"


def ring_bytes(op: str, operand_bytes: float, result_bytes: float, group_size: int) -> float:
    """Bytes one device moves for one ``op`` over a group of ``group_size``."""
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}; one of {OPS}")
    s = int(group_size)
    if s <= 1:
        return 0.0
    frac = (s - 1) / s
    if op == "all-reduce":
        return 2 * frac * operand_bytes
    if op == "all-gather":
        return frac * result_bytes
    if op in ("reduce-scatter", "all-to-all"):
        return frac * operand_bytes
    return float(operand_bytes)  # collective-permute


class CommCounter:
    """Counts the collectives called while it is active (``with``):
    :meth:`stats` gives what ``collective_stats`` gives for a compiled
    step, per device."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.per_device_bytes = 0.0
        self.raw_operand_bytes = 0
        self.counts: Counter = Counter()
        self.bytes_by_op: Dict[str, float] = defaultdict(float)

    def add(self, op: str, operand_bytes: int, result_bytes: int, group_size: int) -> None:
        if group_size <= 1:
            return
        b = ring_bytes(op, operand_bytes, result_bytes, group_size)
        with self._lock:
            self.per_device_bytes += b
            self.raw_operand_bytes += int(operand_bytes)
            self.counts[op] += 1
            self.bytes_by_op[op] += b

    def add_copy(self, nbytes: int) -> None:
        """One block ``shard`` copied to another device."""
        with self._lock:
            self.counts[COPY] += 1
            self.bytes_by_op[COPY] += float(nbytes)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "per_device_bytes": self.per_device_bytes,
                "raw_operand_bytes": self.raw_operand_bytes,
                "counts": dict(self.counts),
                "bytes_by_op": dict(self.bytes_by_op),
            }

    def __enter__(self) -> "CommCounter":
        with _active_lock:
            _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _active_lock:
            _active.remove(self)


_active: List[CommCounter] = []
_active_lock = threading.Lock()


def record(op: str, operand_bytes: int, result_bytes: int, group_size: int) -> None:
    """One collective call, into every active counter (none: nothing)."""
    if not _active:
        return
    with _active_lock:
        counters = list(_active)
    for c in counters:
        c.add(op, operand_bytes, result_bytes, group_size)


def record_copy(nbytes: int) -> None:
    """One block copied to another device by ``collectives.shard``, into
    every active counter."""
    if not _active:
        return
    with _active_lock:
        counters = list(_active)
    for c in counters:
        c.add_copy(nbytes)


__all__ = ["COPY", "CommCounter", "OPS", "record", "record_copy", "ring_bytes"]
