"""Reader tracer (paper §5.2.2).

A fixed array of ``k`` slots; each slot is conceptually an 8-byte word whose
high bit is the *status* (in use / free) and whose low 63 bits store a read
query's start timestamp.  Registration scans for a free slot and claims it
with CAS; unregistration resets the slot to FREE with timestamp = +inf so GC
treats it as "not pinning anything".

CPython has no raw 8-byte CAS, so each slot is an integer guarded by a
per-slot lock used *only* for the claim transition (Python's closest analogue
to CAS; reads remain lock-free).  The encoding (status bit | timestamp) is
kept exactly as in the paper so the slot contents round-trip to an int64.
"""

from __future__ import annotations

import threading
from typing import List

from ..obs.metrics import REGISTRY as _REGISTRY

_STATUS_BIT = 1 << 63
_TS_MASK = _STATUS_BIT - 1
FREE_TS = _TS_MASK  # "maximum representable" timestamp per the paper


class ReaderTracer:
    """k-slot registration table for active read queries."""

    def __init__(self, k: int = 32) -> None:
        if k <= 0:
            raise ValueError(f"reader tracer needs k >= 1, got {k}")
        self.k = k
        # slot value = status_bit | start_ts ; start with FREE slots.
        self._slots: List[int] = [FREE_TS] * k
        self._claim_locks = [threading.Lock() for _ in range(k)]

    # -- registration -------------------------------------------------------
    def register(self, start_ts: int) -> int:
        """Claim a free slot for a reader pinned at ``start_ts``.

        Returns the slot id. Raises ``RuntimeError`` when all ``k`` slots are
        busy (the paper sizes ``k`` to the core count; callers may retry).
        """
        if not 0 <= start_ts < _TS_MASK:
            raise ValueError(f"start_ts out of range: {start_ts}")
        for slot in range(self.k):
            if self._slots[slot] & _STATUS_BIT:
                continue  # in use
            # CAS-like claim: re-check under the per-slot lock.
            with self._claim_locks[slot]:
                if not self._slots[slot] & _STATUS_BIT:
                    self._slots[slot] = _STATUS_BIT | start_ts
                    return slot
        # slot exhaustion is an operational event, not just an exception:
        # count it on the process registry so dashboards and the telemetry
        # report surface the pressure even when callers retry and succeed
        _REGISTRY.counter("reader_slots_exhausted").add()
        raise RuntimeError(f"reader tracer full (k={self.k})")

    def update(self, slot: int, start_ts: int) -> None:
        """Monotonically bump a claimed slot's timestamp.

        Used by the registration protocol to close the register/GC race: a
        reader re-reads ``t_r`` after claiming its slot and advances its pin
        if a writer published in between (see store.begin_read).
        """
        cur = self._slots[slot]
        if not cur & _STATUS_BIT:
            raise RuntimeError(f"slot {slot} not claimed")
        if start_ts > (cur & _TS_MASK):
            self._slots[slot] = _STATUS_BIT | start_ts

    def unregister(self, slot: int) -> None:
        """Free ``slot``: clear status bit, park timestamp at FREE_TS."""
        if not 0 <= slot < self.k:
            raise ValueError(f"bad slot {slot}")
        # Single aligned write — atomic under the GIL, no lock needed.
        self._slots[slot] = FREE_TS

    # -- GC support ----------------------------------------------------------
    def active_timestamps(self) -> List[int]:
        """Snapshot the start timestamps of all active readers (lock-free).

        Writers call this during GC (paper §5.3 step 1): each slot is read
        with a single atomic load; FREE slots contribute nothing.
        """
        out = []
        for slot in range(self.k):
            v = self._slots[slot]
            if v & _STATUS_BIT:
                out.append(v & _TS_MASK)
        return out

    def min_active_timestamp(self) -> int:
        """Smallest pinned timestamp, or FREE_TS when no reader is active."""
        ts = self.active_timestamps()
        return min(ts) if ts else FREE_TS

    def n_active(self) -> int:
        return sum(1 for v in self._slots if v & _STATUS_BIT)

    def busy_slots(self) -> int:
        """Occupancy gauge: claimed slots out of ``k`` (lock-free scan).

        Exported as the ``reader_tracer_busy_slots`` gauge on the owning
        store's registry; ``busy_slots() == k`` is the saturation signal
        that precedes the ``reader tracer full`` RuntimeError (which is
        additionally counted as ``reader_slots_exhausted``).
        """
        return self.n_active()

    def slot_value(self, slot: int) -> int:
        """Raw 8-byte slot encoding (status_bit | ts) — for tests."""
        return self._slots[slot]
