"""Span tracing: a fixed-size, lock-striped ring buffer of spans.

A *span* is one timed stage of the commit or read lifecycle (see the
package docstring for the span vocabulary).  Recording is designed for
the store's hot paths:

- **Disabled** (the default): the only cost at an instrumentation site
  is one attribute check — ``TRACER.enabled`` — because
  :meth:`Tracer.begin` returns 0 and :meth:`Tracer.end` bails on a
  falsy token.  ``REPRO_TELEMETRY=1`` in the environment (read once at
  import) or :func:`enable` turns recording on.
- **Enabled**: a span costs two ``perf_counter_ns`` calls, one
  :class:`Span` build, and one append into a lock stripe chosen by
  thread id — concurrent readers/writers on different threads hit
  different locks, so tracing never serializes the store.
- **Bounded**: the ring holds ``REPRO_TELEMETRY_RING`` spans (default
  32768) split across stripes; saturation overwrites the oldest span in
  the recording thread's stripe.  Per-name *counts* are tracked
  separately and survive wraparound — the smoke harness's span-balance
  invariants (every read closed, commit spans == ``stats["commits"]``)
  read counts, not the ring.

Spans carry the commit/view timestamp (``ts``) plus free-form ``args``,
which is what makes one write traceable end to end: its ``enqueue``
span carries the ticket ``seq``, its batch's ``commit`` / ``wal_sync``
/ ``publish`` spans carry the commit ``ts`` (range), and the first
``read`` span with that ``ts`` is the write becoming visible.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

_DEFAULT_CAPACITY = 32768
_N_STRIPES = 8


class Span:
    """One completed span.  ``ts`` is the commit/view timestamp (-1: none)."""

    __slots__ = ("name", "cat", "start_ns", "dur_ns", "tid", "ts", "args")

    def __init__(self, name, cat, start_ns, dur_ns, tid, ts=-1, args=None) -> None:
        self.name = name
        self.cat = cat
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.ts = ts
        self.args = args

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Span({self.name!r}, cat={self.cat!r}, ts={self.ts}, "
            f"dur={self.dur_ns / 1e3:.1f}us)"
        )


class _Stripe:
    __slots__ = ("lock", "buf", "n", "cap")

    def __init__(self, cap: int) -> None:
        self.lock = threading.Lock()
        self.buf: List[Optional[Span]] = [None] * cap
        self.n = 0  # total ever recorded into this stripe
        self.cap = cap


class SpanRing:
    """Fixed-capacity span store, striped by recording thread id."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, n_stripes: int = _N_STRIPES) -> None:
        per = max(1, int(capacity) // int(n_stripes))
        self._stripes = [_Stripe(per) for _ in range(int(n_stripes))]

    @property
    def capacity(self) -> int:
        return sum(s.cap for s in self._stripes)

    def record(self, span: Span) -> None:
        s = self._stripes[threading.get_ident() % len(self._stripes)]
        with s.lock:
            s.buf[s.n % s.cap] = span
            s.n += 1

    def recorded(self) -> int:
        """Total spans ever recorded (including overwritten ones)."""
        return sum(s.n for s in self._stripes)

    def dropped(self) -> int:
        """Spans lost to wraparound."""
        return sum(max(0, s.n - s.cap) for s in self._stripes)

    def spans(self) -> List[Span]:
        """Snapshot of retained spans, oldest first (by start time)."""
        out: List[Span] = []
        for s in self._stripes:
            with s.lock:
                live = s.buf[: min(s.n, s.cap)]
                out.extend(sp for sp in live if sp is not None)
        out.sort(key=lambda sp: sp.start_ns)
        return out

    def clear(self) -> None:
        for s in self._stripes:
            with s.lock:
                s.buf = [None] * s.cap
                s.n = 0


def _env_enabled() -> bool:
    return os.environ.get("REPRO_TELEMETRY", "") not in ("", "0")


def _env_capacity() -> int:
    try:
        return int(os.environ.get("REPRO_TELEMETRY_RING", _DEFAULT_CAPACITY))
    except ValueError:  # pragma: no cover - defensive
        return _DEFAULT_CAPACITY


class Tracer:
    """Span recorder with per-name counts and an enable switch."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.enabled = _env_enabled()
        self.ring = SpanRing(capacity if capacity is not None else _env_capacity())
        self._counts: Dict[str, int] = {}
        self._count_lock = threading.Lock()

    # -- hot path ------------------------------------------------------------
    def begin(self) -> int:
        """Start token (perf ns), or 0 when disabled."""
        if not self.enabled:
            return 0
        return time.perf_counter_ns()

    def end(self, token: int, name: str, cat: str = "store", ts: int = -1,
            args: Optional[dict] = None) -> None:
        """Close a span begun at ``token``.  No-op on a falsy token."""
        if not token or not self.enabled:
            return
        now = time.perf_counter_ns()
        self.ring.record(
            Span(name, cat, token, now - token, threading.get_ident(), ts, args)
        )
        with self._count_lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def instant(self, name: str, cat: str = "store", ts: int = -1,
                args: Optional[dict] = None) -> None:
        """Record a zero-duration marker span."""
        if not self.enabled:
            return
        self.end(time.perf_counter_ns(), name, cat=cat, ts=ts, args=args)

    # -- introspection -------------------------------------------------------
    def count(self, name: str) -> int:
        """Spans completed under ``name`` (wraparound-proof)."""
        with self._count_lock:
            return self._counts.get(name, 0)

    def counts(self) -> Dict[str, int]:
        with self._count_lock:
            return dict(self._counts)

    def spans(self) -> List[Span]:
        return self.ring.spans()

    def clear(self) -> None:
        self.ring.clear()
        with self._count_lock:
            self._counts.clear()


# Process-wide tracer: the store, pipeline, WAL, compactor, assembler,
# device cache and shard plane all record here.
TRACER = Tracer()


def enabled() -> bool:
    return TRACER.enabled


def enable(on: bool = True) -> None:
    """Programmatic switch (the env var only sets the initial state)."""
    TRACER.enabled = bool(on)


__all__ = ["Span", "SpanRing", "Tracer", "TRACER", "enable", "enabled"]
