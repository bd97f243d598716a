"""Logical clocks for subgraph-centric concurrency control (paper §5.2).

Two global timestamps coordinate queries:

- ``t_w`` — the global *write* timestamp: incremented atomically by each
  committing write query; the new value is the writer's commit timestamp.
- ``t_r`` — the global *read* timestamp: the newest timestamp whose commit is
  fully visible to readers.  A writer with commit timestamp ``t`` polls and
  advances ``t_r`` from ``t - 1`` to ``t`` (the paper's conditional increment),
  which enforces commit order and guarantees readers always observe a prefix
  of the commit sequence.

The initial graph ``G_0`` carries version 0, so a reader that starts before
any write simply pins ``t = 0``.

Group-commit extensions (write pipeline, see core.write_pipeline):

- :meth:`LogicalClock.reserve` draws ``k`` *consecutive* commit timestamps
  in one atomic step, so a committer that has several prepared batches in
  hand pays the clock lock once for all of them;
- :meth:`LogicalClock.publish_range` advances ``t_r`` across the whole
  reserved run in ONE conditional increment (readers observe the run
  atomically) — the batched publish;
- a configurable *stall deadline*: a writer that dies between
  ``next_commit_timestamp()`` and ``publish()`` would otherwise leave every
  later committer spinning in the publish poll forever.  After
  ``stall_timeout`` seconds the poll raises :class:`ClockStallError` naming
  the missing timestamp instead of hanging the process; ``stall_events`` /
  ``max_stall_wait`` record how often publishes had to wait at all.
- :meth:`LogicalClock.abandon` / :meth:`~LogicalClock.abandon_range` — the
  cooperative fix for the same failure: a writer that errors after reserving
  renounces its timestamps, and ``t_r`` steps over them as published no-ops
  so later committers proceed instead of stalling.
- :meth:`LogicalClock.restore` resets the clock after crash recovery so
  post-replay commits continue the durable timestamp sequence.
"""

from __future__ import annotations

import threading
import time


class ClockStallError(RuntimeError):
    """Publish poll exceeded the stall deadline: a predecessor never published.

    Carries the first missing timestamp (``t_r + 1`` at raise time) — the
    commit whose writer most likely died between ``next_commit_timestamp()``
    and ``publish()`` — so the operator knows exactly which commit to hunt.
    """

    def __init__(self, waiting_for: int, missing: int, t_r: int, waited: float):
        self.waiting_for = waiting_for
        self.missing = missing
        self.t_r = t_r
        super().__init__(
            f"publish({waiting_for}) stalled for {waited:.1f}s: timestamp "
            f"{missing} was reserved but never published (t_r={t_r}); its "
            f"writer likely died between next_commit_timestamp() and publish()"
        )


class LogicalClock:
    """Paper-faithful (t_w, t_r) pair with atomic advance semantics."""

    __slots__ = (
        "_tw", "_tr", "_lock", "_tr_cond", "_abandoned", "stall_timeout",
        "stall_events", "max_stall_wait", "abandon_events",
    )

    def __init__(self, stall_timeout: float = 60.0) -> None:
        self._tw = 0
        self._tr = 0
        self._lock = threading.Lock()
        self._tr_cond = threading.Condition(self._lock)
        # reserved timestamps whose writer gave up (see abandon_range):
        # publish waiters step over these instead of stalling against them
        self._abandoned: set = set()
        #: seconds a publish may poll for its predecessor before raising
        #: ClockStallError; None disables the deadline (legacy hang-forever).
        self.stall_timeout = stall_timeout
        self.stall_events = 0  # publishes that had to wait at least once
        self.max_stall_wait = 0.0  # longest successful publish wait (s)
        self.abandon_events = 0  # timestamps explicitly abandoned

    # -- write side ---------------------------------------------------------
    def next_commit_timestamp(self) -> int:
        """Atomically increment ``t_w`` and return the new commit timestamp."""
        with self._lock:
            self._tw += 1
            return self._tw

    def reserve(self, k: int) -> int:
        """Atomically reserve ``k`` consecutive commit timestamps.

        Returns the FIRST of the run ``[first, first + k)``.  The caller
        must eventually publish every reserved timestamp (publish_range), in
        order, or later committers will stall against the gap.
        """
        if k <= 0:
            raise ValueError(f"reserve needs k >= 1, got {k}")
        with self._lock:
            first = self._tw + 1
            self._tw += k
            return first

    def abandon(self, commit_ts: int) -> None:
        """Renounce one reserved-but-unpublished commit timestamp.

        The error-handling side of the reserve/publish protocol: a writer
        that fails between ``reserve``/``next_commit_timestamp()`` and
        ``publish()`` MUST abandon its timestamps, or every later committer
        stalls against the gap until :class:`ClockStallError`.  An abandoned
        timestamp behaves like a published no-op: once all earlier commits
        publish, ``t_r`` silently steps over it and later publishes proceed.
        """
        self.abandon_range(commit_ts, commit_ts)

    def abandon_range(self, first: int, last: int) -> None:
        """Abandon the whole reserved run ``[first, last]`` (see abandon)."""
        if last < first:
            raise ValueError(f"empty abandon range [{first}, {last}]")
        with self._tr_cond:
            if self._tr >= first:
                raise RuntimeError(
                    f"abandon_range([{first}, {last}]) but t_r={self._tr} "
                    f"already covers {first}: cannot abandon published commits"
                )
            for ts in range(first, last + 1):
                self._abandoned.add(ts)
            self.abandon_events += last - first + 1
            self._advance_over_abandoned_locked()
            self._tr_cond.notify_all()

    def _advance_over_abandoned_locked(self) -> None:
        # step t_r over any contiguous abandoned run now adjacent to it;
        # caller holds _lock and notifies afterwards
        while self._tr + 1 in self._abandoned:
            self._abandoned.discard(self._tr + 1)
            self._tr += 1

    def publish(self, commit_ts: int) -> None:
        """Advance ``t_r`` to ``commit_ts`` once every earlier commit published.

        Implements the paper's *poll + conditional increment*: a writer with
        commit timestamp ``t`` may only move ``t_r`` from ``t - 1`` to ``t``.
        Out-of-order committers wait until their predecessor published, or
        raise :class:`ClockStallError` after ``stall_timeout`` seconds.
        """
        self.publish_range(commit_ts, commit_ts)

    def publish_range(self, first: int, last: int) -> None:
        """Batched publish: advance ``t_r`` from ``first - 1`` to ``last``.

        One conditional increment covers the whole contiguous run a batching
        committer reserved — readers never observe a partially-published
        run.  Semantically identical to publishing each timestamp in
        ``[first, last]`` in order, minus the per-timestamp lock traffic.
        """
        if last < first:
            raise ValueError(f"empty publish range [{first}, {last}]")
        deadline = None
        waited = False
        with self._tr_cond:
            for ts in range(first, last + 1):
                if ts in self._abandoned:
                    raise RuntimeError(
                        f"publish_range([{first}, {last}]): timestamp {ts} "
                        f"was abandoned and cannot be published"
                    )
            while self._tr != first - 1:
                if self._tr >= first:  # double publish — protocol bug
                    raise RuntimeError(
                        f"publish_range([{first}, {last}]) but t_r={self._tr} "
                        f"already covers {first}"
                    )
                now = time.monotonic()
                if deadline is None:
                    waited = True
                    self.stall_events += 1
                    start = now
                    deadline = (
                        now + self.stall_timeout
                        if self.stall_timeout is not None else float("inf")
                    )
                if now >= deadline:
                    raise ClockStallError(
                        waiting_for=first,
                        missing=self._tr + 1,
                        t_r=self._tr,
                        waited=now - start,
                    )
                self._tr_cond.wait(timeout=min(1.0, max(deadline - now, 0.001)))
            if waited:
                self.max_stall_wait = max(
                    self.max_stall_wait, time.monotonic() - start
                )
            self._tr = last
            self._advance_over_abandoned_locked()
            self._tr_cond.notify_all()

    def restore(self, ts: int) -> None:
        """Reset both timestamps to ``ts`` (crash-recovery bootstrap).

        Used by :meth:`RapidStore.recover` after WAL replay: the recovered
        store's clock must resume exactly where the durable history ends so
        post-recovery commits draw contiguous timestamps.  Only valid on a
        quiescent clock (no reserved-but-unpublished timestamps in flight).
        """
        with self._tr_cond:
            if self._tw != self._tr:
                raise RuntimeError(
                    f"restore({ts}) on a non-quiescent clock "
                    f"(t_w={self._tw}, t_r={self._tr})"
                )
            if ts < 0:
                raise ValueError(f"restore needs ts >= 0, got {ts}")
            self._tw = int(ts)
            self._tr = int(ts)
            self._abandoned.clear()
            self._tr_cond.notify_all()

    # -- read side ----------------------------------------------------------
    def read_timestamp(self) -> int:
        """Current ``t_r`` — the snapshot timestamp a new reader pins."""
        return self._tr  # benign race: monotone int read

    def write_timestamp(self) -> int:
        return self._tw

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"LogicalClock(t_w={self._tw}, t_r={self._tr})"
