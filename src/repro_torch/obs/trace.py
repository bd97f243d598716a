"""Span tracing: a fixed-size, lock-striped ring buffer of spans.

A *span* is one timed stage of the commit or read lifecycle (see the
package docstring for the span vocabulary).  Recording is designed for
the store's hot paths:

- **Disabled** (the default): the only cost at an instrumentation site
  is one attribute check — ``TRACER.enabled`` — because
  :meth:`Tracer.begin` returns 0 and :meth:`Tracer.end` bails on a
  falsy token.  ``REPRO_TELEMETRY=1`` in the environment (read once at
  import) or :func:`enable` turns recording on.
- **Enabled**: a span costs two ``perf_counter_ns`` calls (an opened one
  two ``thread_time_ns`` calls more), an id, one :class:`Span` and args
  build, and one append into a lock stripe chosen
  by thread id — concurrent readers/writers on different threads hit
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

**Identity.**  While tracing is on every span's ``args`` hold its ``id``
and, where it has them, its ``parent`` (the span that caused it) and the
``read`` it belongs to.  A span that encloses others on its thread is
opened with :meth:`Tracer.open` and closed with :meth:`Tracer.close`: it
sits on a thread-local stack (made on a thread's first :meth:`open`
while tracing is on, dropped by ``enable(False)``), and a span that ends
while it is the innermost open one of its read becomes its child (a
``device_wait`` child is counted in its ``waits``).  A read's id comes from :func:`new_id`, the
same counter as span ids, and is also the id of its root span (``read``,
recorded with ``root=True``): a span of read ``r`` with no open span of
``r`` beneath it on its thread has ``r`` as its parent.  The read is
taken from the view where the caller has one (:func:`traced`), so two
reads interleaved on one thread stay apart.  An opened span also records
in ``cpu_ns`` the CPU time its thread spent inside it
(``time.thread_time_ns``): waits for the GIL, or for the OS to schedule
the thread, are not in it.

**Clock.**  Spans are timed on ``time.perf_counter_ns``;
:func:`clock_anchor` pairs that clock with the profiler's (the Unix-epoch
nanoseconds that ``torch.profiler`` gives its events), which is how
:func:`repro_torch.obs.export.chrome_trace` writes spans beside a
profiler trace.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

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


class Frame:
    """An open span that encloses others on its thread (:meth:`Tracer.open`).

    ``waits`` counts the ``device_wait`` spans that closed as its
    children; ``note`` is free for the code inside it to say what it did
    (the view assembler names the path it took)."""

    __slots__ = ("start_ns", "cpu_ns", "id", "parent", "read", "up", "waits", "note")

    def __init__(self, sid: int, parent: int, read: int, up: "Optional[Frame]") -> None:
        self.id = sid
        self.parent = parent
        self.read = read
        self.up = up
        self.waits = 0
        self.note = None
        self.start_ns = self.cpu_ns = 0


# span and read ids: next() on an itertools.count is atomic under the GIL
_IDS = itertools.count(1)


def new_id() -> int:
    """A fresh id from the counter that spans draw theirs from (lock-free);
    the store gives each read one, which is also its root span's id."""
    return next(_IDS)


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
        self._local = threading.local()  # .stack: the thread's open Frames

    # -- hot path ------------------------------------------------------------
    def begin(self) -> int:
        """Start token (perf ns), or 0 when disabled."""
        if not self.enabled:
            return 0
        return time.perf_counter_ns()

    def end(self, token: int, name: str, cat: str = "store", ts: int = -1,
            args: Optional[dict] = None, read: int = 0, root: bool = False) -> None:
        """Close a span begun at ``token``.  No-op on a falsy token.

        It becomes a child of the innermost open :class:`Frame` of its
        read on this thread (of any read when ``read`` is 0), else of the
        read's root.  ``root=True`` records the root span of read ``read``
        itself: its id is the read's."""
        if not token or not self.enabled:
            return
        now = time.perf_counter_ns()
        if root:
            sid, parent = read, 0
        else:
            up = self._linked(read)
            sid = next(_IDS)
            if up is not None:
                parent, read = up.id, up.read
            else:
                parent = read
        self._record(name, cat, token, now, ts, args, sid, parent, read)

    def open(self, read: int = 0):
        """Open a span that encloses others on this thread: a :class:`Frame`
        to hand to :meth:`close`, or 0 when disabled."""
        if not self.enabled:
            return 0
        stack = self._stack()
        up = self._linked(read)
        frame = (Frame(next(_IDS), up.id, up.read, up) if up is not None
                 else Frame(next(_IDS), read, read, None))
        stack.append(frame)
        frame.cpu_ns = time.thread_time_ns()
        frame.start_ns = time.perf_counter_ns()
        return frame

    def close(self, frame, name: str, cat: str = "store", ts: int = -1,
              args: Optional[dict] = None) -> None:
        """Record the span of ``frame``, with the thread's CPU time inside
        it as ``cpu_ns``, and take it off this thread's stack (with any
        frame above it that an exception left open)."""
        if not frame or not self.enabled:
            return
        now = time.perf_counter_ns()
        cpu = time.thread_time_ns() - frame.cpu_ns
        stack = getattr(self._local, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is frame:
                    del stack[i:]
                    break
        if name == "device_wait" and frame.up is not None:
            frame.up.waits += 1
        self._record(name, cat, frame.start_ns, now, ts, args, frame.id, frame.parent,
                     frame.read, cpu)

    def current(self) -> Optional[Frame]:
        """The innermost open :class:`Frame` on this thread, or None."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def _stack(self) -> List[Frame]:
        local = self._local
        try:
            return local.stack
        except AttributeError:
            local.stack = []
            return local.stack

    def _linked(self, read: int) -> Optional[Frame]:
        """The frame a span of ``read`` nests under: the innermost open one
        on this thread if it belongs to that read (or ``read`` is 0)."""
        stack = getattr(self._local, "stack", None)
        if not stack:
            return None
        top = stack[-1]
        return top if not read or top.read == read else None

    def _record(self, name, cat, start, now, ts, args, sid, parent, read, cpu=-1) -> None:
        a = dict(args) if args else {}
        a["id"] = sid
        if cpu >= 0:
            a["cpu_ns"] = cpu
        if parent:
            a["parent"] = parent
        if read:
            a["read"] = read
        self.ring.record(Span(name, cat, start, now - start, threading.get_ident(), ts, a))
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
    """Programmatic switch (the env var only sets the initial state).
    Turning tracing off drops every thread's stack of open spans."""
    TRACER.enabled = bool(on)
    if not on:
        TRACER._local = threading.local()


def traced(name: str, args_fn: Callable):
    """Record a span ``name`` (cat ``read``) around ``fn(view, ...)``, opened
    with the view's ``read_id`` so the code inside nests under it; its args
    are ``args_fn(fn, view, frame)``, built as it closes.  Disabled, the
    cost is one attribute check."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(view, *args, **kwargs):
            if not TRACER.enabled:
                return fn(view, *args, **kwargs)
            frame = TRACER.open(getattr(view, "read_id", 0))
            try:
                return fn(view, *args, **kwargs)
            finally:
                if frame:
                    TRACER.close(frame, name, cat="read", ts=getattr(view, "ts", -1),
                                 args=args_fn(fn, view, frame))

        return wrapper

    return deco


def query_span(route: Optional[Callable] = None):
    """:func:`traced` as a ``query`` span around a view-level entry point.

    Its args: ``kind`` (the entry point's name), ``route`` (``plane`` where
    ``route(view)`` gives the shard plane that serves it, with its
    ``n_shards``; else ``single``) and ``waits``, the ``device_wait``
    spans that closed as its children."""

    def args(fn, view, frame):
        plane = route(view) if route is not None else None
        a = {"kind": fn.__name__, "route": "single" if plane is None else "plane",
             "waits": frame.waits}
        if plane is not None:
            a["n_shards"] = plane.n_shards
        return a

    return traced("query", args)


def clock_anchor() -> Tuple[int, int]:
    """``(perf_counter_ns, profiler ns)`` read back to back: of 16 tries,
    the one whose two ``perf_counter_ns`` reads bracket the profiler's
    reading most tightly, the bracket's middle beside it.

    The profiler's clock is the Unix-epoch nanoseconds that
    ``torch.profiler`` stamps its events with (the host's real-time clock,
    ``time.time_ns``); ``profiler_ns - perf_ns`` maps a span onto it."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1], best[2]


__all__ = ["Frame", "Span", "SpanRing", "Tracer", "TRACER", "clock_anchor", "enable",
           "enabled", "new_id", "query_span", "traced"]
