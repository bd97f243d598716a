"""Per-subgraph version chains (paper §5.1) with writer-driven GC (§5.3).

Each subgraph keeps its committed snapshots newest-first.  A version ``v_i``
is reclaimable when it is not the head and no active reader's start timestamp
falls in ``[v_i.ts, v_{i-1}.ts)`` (the half-open window during which ``v_i``
was the visible version).  Proposition 5.2 bounds the chain length at k+1.

This module also hosts :class:`CommitLineage`, the store-wide commit log the
delta plane (:mod:`repro_torch.core.view_assembler`) consumes: one record per
committed write transaction carrying ``(commit ts, dirty subgraph-id set)``.
A fresh :class:`~repro_torch.core.snapshot.SnapshotView` diffs its timestamp
against its predecessor view's through the lineage to learn exactly which
subgraphs changed between the two reads — the O(d) input that lets view
materialization splice instead of re-concatenating all S subgraphs.
"""

from __future__ import annotations

import bisect
import threading
from typing import FrozenSet, Iterable, List, Optional, Sequence

from .subgraph import SubgraphSnapshot


class CommitLineage:
    """Bounded, timestamp-ordered log of committed writes' dirty-subgraph sets.

    Writers append a record *before* publishing their commit timestamp, so by
    the time any reader observes ``t_r >= ts`` the record for ``ts`` is
    already queryable — :meth:`dirty_between` can therefore answer exactly
    for any window bounded by published timestamps.

    A *group commit* (core.write_pipeline) coalesces many queued logical
    writes into one commit: it appends ONE record whose dirty set is the
    union over the batch and whose ``n_writes`` counts the coalesced logical
    writes.  Readers consume group records exactly like single-write
    records — :meth:`dirty_between` is unchanged, so the delta-plane splice
    sees a group commit as an ordinary lineage entry; ``n_writes`` exists
    for diagnostics and amortization accounting (:meth:`writes_between`,
    :attr:`total_writes`).

    The log is bounded at ``max_records``; trimming advances ``_base_ts``
    (every commit with ``ts > _base_ts`` is still recorded).  A query whose
    window reaches at or below the trimmed region returns ``None`` —
    "unknown", which the view assembler treats as a full-concat fallback.
    """

    __slots__ = (
        "_lock", "_ts", "_sids", "_counts", "_base_ts", "max_records",
        "total_writes", "_ep_ts", "_ep_moves",
    )

    def __init__(self, max_records: int = 4096) -> None:
        self._lock = threading.Lock()
        self._ts: List[int] = []
        self._sids: List[FrozenSet[int]] = []
        self._counts: List[int] = []  # logical writes coalesced per record
        self._base_ts = 0  # every commit with ts > _base_ts is recorded
        self.max_records = int(max_records)
        self.total_writes = 0  # logical writes ever recorded (survives trim)
        # placement epochs (core.reshard): the no-write commits that flipped
        # the shard plane's placement map, recorded here like any other
        # commit so placement is a lineage artifact, not plane-private state
        self._ep_ts: List[int] = []
        self._ep_moves: List[dict] = []  # {sid: dst shard index} per epoch

    def record(self, ts: int, sids: Iterable[int], n_writes: int = 1) -> None:
        """Log one commit.  Called by the writer before publishing ``ts``.

        ``n_writes`` is the number of logical writes this commit coalesced
        (1 for single-shot transactions, the batch size for group commits).
        """
        dirty = frozenset(int(s) for s in sids)
        with self._lock:
            i = bisect.bisect_right(self._ts, ts)
            self._ts.insert(i, int(ts))
            self._sids.insert(i, dirty)
            self._counts.insert(i, int(n_writes))
            self.total_writes += int(n_writes)
            while len(self._ts) > self.max_records:
                self._base_ts = self._ts[0]
                del self._ts[0]
                del self._sids[0]
                del self._counts[0]

    def record_placement(self, ts: int, moves) -> None:
        """Log a placement-epoch flip committed at ``ts``.

        Called by the migration runtime (:mod:`repro_torch.core.reshard`) before
        publishing the epoch timestamp, mirroring :meth:`record`'s
        record-before-publish contract: once a reader observes
        ``t_r >= ts`` the epoch is queryable.  ``moves`` maps subgraph id
        to its new shard index.
        """
        with self._lock:
            i = bisect.bisect_right(self._ep_ts, ts)
            self._ep_ts.insert(i, int(ts))
            self._ep_moves.insert(i, {int(s): int(k) for s, k in moves.items()})

    def placement_epochs_between(self, a: int, b: int):
        """Placement epochs committed in ``(min(a,b), max(a,b)]``.

        Returns ``[(ts, moves), ...]`` ascending, or ``None`` when the
        window reaches into the trimmed region (mirrors
        :meth:`dirty_between`); an empty list means the two timestamps
        resolve the same placement.
        """
        lo, hi = (a, b) if a <= b else (b, a)
        if lo == hi:
            return []
        with self._lock:
            if lo < self._base_ts:
                return None
            i = bisect.bisect_right(self._ep_ts, lo)
            j = bisect.bisect_right(self._ep_ts, hi)
            return [
                (self._ep_ts[k], dict(self._ep_moves[k])) for k in range(i, j)
            ]

    def dirty_between(self, a: int, b: int) -> Optional[FrozenSet[int]]:
        """Union of dirty sets for commits in ``(min(a,b), max(a,b)]``.

        Symmetric in its arguments: the subgraphs *not* in the returned set
        resolve to identical snapshot versions at both timestamps, whichever
        is older.  Returns ``None`` when the window reaches into the trimmed
        region and the diff is unknowable.
        """
        lo, hi = (a, b) if a <= b else (b, a)
        if lo == hi:
            return frozenset()
        with self._lock:
            if lo < self._base_ts:
                return None
            i = bisect.bisect_right(self._ts, lo)
            j = bisect.bisect_right(self._ts, hi)
            out: set = set()
            for k in range(i, j):
                out |= self._sids[k]
        return frozenset(out)

    def writes_between(self, a: int, b: int) -> Optional[int]:
        """Logical writes coalesced into commits in ``(min(a,b), max(a,b)]``.

        The group-commit amortization counter: ``writes_between / records``
        over a window is the mean batch size.  ``None`` when the window
        reaches into the trimmed region (mirrors :meth:`dirty_between`).
        """
        lo, hi = (a, b) if a <= b else (b, a)
        if lo == hi:
            return 0
        with self._lock:
            if lo < self._base_ts:
                return None
            i = bisect.bisect_right(self._ts, lo)
            j = bisect.bisect_right(self._ts, hi)
            return sum(self._counts[i:j])

    def trim_below(self, ts: int) -> int:
        """Drop every record with commit ts <= ``ts``; returns count dropped.

        The compactor calls this after folding all versions at or below its
        horizon into the frozen base level: windows that start at or above
        the fold point (``dirty_between(fold_ts, t)``) still answer exactly,
        while windows reaching below return ``None`` and the view assembler
        falls back to the base+delta splice or full concat.  Never regresses:
        a ``ts`` at or below the current base is a no-op.
        """
        with self._lock:
            if ts <= self._base_ts:
                return 0
            i = bisect.bisect_right(self._ts, ts)
            del self._ts[:i]
            del self._sids[:i]
            del self._counts[:i]
            j = bisect.bisect_right(self._ep_ts, ts)
            del self._ep_ts[:j]
            del self._ep_moves[:j]
            self._base_ts = int(ts)
            return i

    @property
    def base_ts(self) -> int:
        """Oldest timestamp the lineage can still diff against (exclusive)."""
        return self._base_ts

    def memory_bytes(self) -> int:
        """Approximate resident footprint of the record log.

        Counted by :meth:`RapidStore.memory_bytes` so sustained churn shows
        up in the store's accounting instead of hiding in Python lists: three
        list slots + int + frozenset overhead per record, plus 8 bytes per
        recorded dirty subgraph id.
        """
        with self._lock:
            n = len(self._ts)
            sid_entries = sum(len(s) for s in self._sids)
            ep_n = len(self._ep_ts)
            ep_entries = sum(len(m) for m in self._ep_moves)
        # ~88 bytes/record: 3 list slots (24) + small int (28 avg, shared for
        # tiny values but not for timestamps) + frozenset header amortized;
        # placement epochs: 2 list slots + dict header + 16B per move entry
        return 88 * n + 8 * sid_entries + 80 * ep_n + 16 * ep_entries

    def __len__(self) -> int:
        return len(self._ts)


class VersionChain:
    """Newest-first chain of committed subgraph snapshots."""

    __slots__ = ("sid", "_versions", "_lock")

    def __init__(self, sid: int, initial: SubgraphSnapshot) -> None:
        self.sid = sid
        self._versions: List[SubgraphSnapshot] = [initial]  # newest first
        # Guards list mutation only. Readers traverse a list reference that
        # writers replace wholesale, so reads stay lock-free (paper §5.2.2).
        self._lock = threading.Lock()

    # -- writer side -----------------------------------------------------------
    def link(self, snap: SubgraphSnapshot) -> None:
        """Link a freshly committed snapshot at the head."""
        if snap.ts <= self.head.ts:
            raise AssertionError(
                f"non-monotone version link: {snap.ts} after {self.head.ts}"
            )
        with self._lock:
            self._versions = [snap] + self._versions

    def collect(self, active_ts: Sequence[int]) -> int:
        """Reclaim versions not needed by any active reader. Returns count.

        ``active_ts`` is the reader-tracer scan made by the committing writer
        (paper §5.3).  Version v_i (i >= 1, newest-first indexing) is *pinned*
        iff some t in active_ts satisfies v_i.ts <= t < v_{i-1}.ts.
        """
        pinned_ts = sorted(set(active_ts))
        with self._lock:
            versions = self._versions
            keep = [versions[0]]  # head always survives
            dead = []
            for i in range(1, len(versions)):
                newer, cur = versions[i - 1], versions[i]
                import bisect

                j = bisect.bisect_left(pinned_ts, cur.ts)
                pinned = j < len(pinned_ts) and pinned_ts[j] < newer.ts
                if pinned:
                    keep.append(cur)
                else:
                    dead.append(cur)
            self._versions = keep
        for snap in dead:
            snap.release()
        return len(dead)

    # -- reader side -------------------------------------------------------------
    @property
    def head(self) -> SubgraphSnapshot:
        return self._versions[0]

    def resolve(self, t: int) -> SubgraphSnapshot:
        """Latest version with ts <= t (paper §5.2.2 snapshot construction).

        Lock-free: captures the list reference once; writers only ever replace
        the list with a superset-prefix (link) or a pruned copy (collect), and
        collect never removes a version still visible to a registered reader.
        """
        versions = self._versions
        for snap in versions:
            if snap.ts <= t:
                return snap
        raise RuntimeError(
            f"no version of subgraph {self.sid} visible at t={t} "
            f"(chain: {[s.ts for s in versions]})"
        )

    def __len__(self) -> int:
        return len(self._versions)

    def timestamps(self) -> List[int]:
        return [s.ts for s in self._versions]
