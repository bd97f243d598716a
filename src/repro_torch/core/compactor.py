"""Background compactor: fold retired versions into a frozen packed base.

Storage lifecycle (ROADMAP item 2)::

    hot deltas (version chains + CommitLineage, RAM)
        --[ fold: GC + repack ]-->  frozen packed base level (RAM)
        --[ checkpoint cycle  ]-->  durable base snapshot + WAL trim

Without compaction the store's footprint grows without bound under churn:
C-ART insertion splits leaves at B/2 and deletion only merges leaves it
touches, so sustained insert/delete traffic strands half-empty
:class:`~repro_torch.core.leaf_pool.LeafPool` rows; ``fill_ratio`` decays, the
pool doubles, and ``memory_bytes()`` climbs forever (the exact failure the
churn soak test pins).  One fold cycle:

1. **GC below the horizon.**  The fold horizon is the oldest active reader
   timestamp (``t_r`` when idle).  Every chain is collected against the
   live tracer scan, releasing versions retired below the horizon — the
   walk over ``VersionChain`` history the paper's writer-driven GC does
   per-commit, done store-wide.
2. **Repack fragmented heads.**  A head snapshot whose C-ART directories
   strand more than ``min_waste_rows`` max-tier rows' worth of BYTES (vs.
   the maximally-packed, tier-right-sized ideal, counting vertices at or
   below ``high_threshold`` as clustered-index residents) is rebuilt fully
   packed with :func:`~repro_torch.core.subgraph.build_subgraph` and linked as a
   normal commit: lineage-recorded (so delta-plane successors splice the
   new layout instead of serving stale segments) and WAL-logged as a
   *repack record* (so crash recovery replays the identical layout change —
   the clustered-index <-> C-ART split is path-dependent).  On a tiered
   pool the rebuild is also the ONLY tier-migration point: each directory's
   current tier is passed as a hysteresis hint, so a vertex whose degree
   crossed a tier boundary migrates here (WAL-logged with the repack),
   while one hovering inside the ±25% band is held at its tier — counted
   in ``stats['tier_migrations']`` / ``stats['tier_migrations_held']``.
   Waste is measured in bytes, not rows, because a stranded 64-wide row
   costs 8x less than a stranded 512-wide one.  The old version's rows
   free on the GC that follows.
3. **Freeze the base bundle.**  A fresh view materializes the packed
   stream (``SubgraphSnapshot.to_leaf_stream_global`` under the hood) and
   its :class:`~repro_torch.core.view_assembler.ViewAssembly` is pinned as
   ``store._base_assembly`` — the strong-referenced base level the view
   assembler splices against when the weak predecessor chain is broken.
4. **Trim the lineage.**  ``CommitLineage.trim_below(horizon)`` drops
   records no live-reader window can reach; windows starting at or above
   the horizon (including every base+delta splice) still answer exactly,
   and older windows fall back to full concat instead of growing the log.

A *checkpoint cycle* additionally persists the base level through
:mod:`repro_torch.checkpoint.manager` and rewrites the WAL to begin at the
checkpoint timestamp — the bounded replay window
:meth:`RapidStore.recover` relies on.

With a write pipeline attached, the fold runs under
``WritePipeline.quiesce()`` (submissions blocked, queues drained) and
invalidates the pipeline's pending heads for repacked subgraphs; without
one, each repack takes the store's per-subgraph lock.  Readers are never
blocked either way.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import cart
from . import txn as _txn
from .subgraph import build_subgraph
from ..obs.trace import TRACER as _trc


@dataclass
class CompactionReport:
    """What one fold cycle did (returned by :meth:`Compactor.compact_once`)."""

    horizon: int = 0
    versions_reclaimed: int = 0
    repacked: List[int] = field(default_factory=list)
    rows_freed: int = 0
    tier_migrations: int = 0
    lineage_trimmed: int = 0
    base_ts: Optional[int] = None
    checkpoint_ts: Optional[int] = None


class Compactor:
    """Folds retired versions into the frozen base level (see module doc).

    Construct via :meth:`RapidStore.attach_compactor`.  Drive it manually
    with :meth:`compact_once`, or start the background thread with
    :meth:`start` (folds every ``interval`` seconds, running a checkpoint
    cycle every ``checkpoint_every`` folds when a checkpoint dir is set).
    """

    def __init__(
        self,
        store,
        min_waste_rows: int = 4,
        checkpoint_dir=None,
        checkpoint_every: int = 0,
        keep_checkpoints: int = 3,
    ) -> None:
        self.store = store
        self.min_waste_rows = int(min_waste_rows)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.keep_checkpoints = int(keep_checkpoints)
        self.cycles = 0
        self.last_report: Optional[CompactionReport] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._error: Optional[BaseException] = None

    # -- fold horizon --------------------------------------------------------
    def fold_horizon(self) -> int:
        """Oldest active reader timestamp, or ``t_r`` when no reader is live.

        Versions retired below this are unreachable by any current or
        future reader (new readers pin ``t_r`` or later), so folding them
        is invisible.
        """
        active = self.store.tracer.active_timestamps()
        t_r = self.store.clock.read_timestamp()
        return min(min(active), t_r) if active else t_r

    # -- fragmentation test --------------------------------------------------
    def _waste_bytes(self, snap) -> int:
        """Pool BYTES a fully-packed rebuild of ``snap`` would free.

        The clustered index is rebuilt packed on every write, so only C-ART
        leaves fragment.  A directory whose vertex would drop back to the
        clustered index on rebuild (degree <= high_threshold) frees ALL its
        rows; the rest pack to ``ceil(degree / w) * w`` values at the width
        ``w`` a rebuild would pick (hysteresis applied against the current
        tier, so a hover inside the band is not counted as waste).  Bytes,
        not rows: on a tiered pool a stranded narrow row is cheap and a
        stranded wide row is not, and a row count would weight them equally.
        """
        if not snap.dirs:
            return 0
        pool, ht = snap.pool, snap.high_threshold
        waste = 0
        for d in snap.dirs.values():
            used = d.n_leaves * d.tier * 4
            deg = cart.degree(pool, d)
            ideal = 0
            if deg > ht:
                w = int(pool.tier_for_degree(deg, current=d.tier))
                ideal = -(-deg // w) * w * 4
            # clamp per directory: a dir due to migrate UP can have
            # ideal > used, and that deficit must not mask real waste
            waste += max(0, used - ideal)
        return waste

    # -- one fold cycle ------------------------------------------------------
    def compact_once(self, checkpoint: bool = False) -> CompactionReport:
        """Run one fold; optionally a checkpoint cycle.  Thread-safe with
        concurrent readers and writers (quiesces the pipeline / takes the
        per-subgraph locks around each repack commit)."""
        store = self.store
        tok = _trc.begin()
        wp = store.write_pipeline
        if wp is not None:
            with wp.quiesce():
                report = self._fold(locked=True)
                wp.invalidate_heads(report.repacked)
        else:
            report = self._fold(locked=False)
        _trc.end(tok, "compactor_fold", cat="compact", ts=report.horizon, args={
            "versions_reclaimed": report.versions_reclaimed,
            "repacked": len(report.repacked),
            "rows_freed": report.rows_freed,
            "lineage_trimmed": report.lineage_trimmed,
        })
        if checkpoint and self.checkpoint_dir is not None:
            from ..checkpoint import manager as _ckpt

            ts = store.checkpoint(self.checkpoint_dir)
            if store.wal is not None:
                store.wal.reset(ts)
            _ckpt.prune(self.checkpoint_dir, keep=self.keep_checkpoints)
            report.checkpoint_ts = ts
        self.cycles += 1
        self.last_report = report
        return report

    def _fold(self, locked: bool) -> CompactionReport:
        store = self.store
        report = CompactionReport(horizon=self.fold_horizon())
        live_before = store.pool.n_live_rows()

        # 1. GC: walk every chain against the live reader scan
        active = store.tracer.active_timestamps()
        reclaimed = 0
        for chain in store.chains:
            reclaimed += chain.collect(active)
        if reclaimed:
            store.stats.add("versions_reclaimed", reclaimed)
        report.versions_reclaimed = reclaimed

        # 2. repack fragmented heads (one commit per subgraph)
        for sid in range(store.n_subgraphs):
            if locked:
                self._maybe_repack(sid, report)
            else:
                with store.locks[sid]:
                    self._maybe_repack(sid, report)
        if report.repacked:
            # free the superseded (pre-repack) versions where possible
            active = store.tracer.active_timestamps()
            extra = 0
            for sid in report.repacked:
                extra += store.chains[sid].collect(active)
            if extra:
                store.stats.add("versions_reclaimed", extra)
            report.versions_reclaimed += extra
            store.stats.add("compactor_repacks", len(report.repacked))

        # 3. freeze the base level: one fully-materialized packed-stream
        # bundle, strong-referenced by the store for base+delta splicing
        with store.read_view() as v:
            v.to_leaf_stream()
            bundle = v.assembly
        store._base_assembly = bundle
        report.base_ts = bundle.ts

        # 4. trim the lineage to the fold horizon (never past the base —
        # the horizon predates the base view by construction)
        report.lineage_trimmed = store.lineage.trim_below(report.horizon)
        if report.lineage_trimmed:
            store.stats.add("lineage_trimmed", report.lineage_trimmed)

        report.rows_freed = max(0, live_before - store.pool.n_live_rows())
        store.stats.add("compactions", 1)
        return report

    def _maybe_repack(self, sid: int, report: CompactionReport) -> None:
        store = self.store
        head = store.chains[sid].head
        # threshold in max-tier row equivalents: min_waste_rows keeps its
        # single-tier meaning (N stranded B-wide rows) on both pool kinds
        if self._waste_bytes(head) < self.min_waste_rows * store.pool.B * 4:
            return
        src, dst = head.to_coo_global()
        snap = build_subgraph(
            sid, store.p, store.pool,
            src - sid * store.p, dst,
            high_threshold=store.high_threshold,
            tier_hints={int(lu): d.tier for lu, d in head.dirs.items()},
        )
        # build_subgraph assumes a fresh all-active block; carry the real
        # vertex flags over — repack must not resurrect deleted vertices
        snap.active = head.active.copy()
        t = store.clock.next_commit_timestamp()
        try:
            wal = store.wal
            if wal is not None:
                wal.append_repack(t, [sid], store.n_vertices)
                wal.sync()
            # n_writes=0: a layout-only commit, no logical writes coalesced
            _txn.link_at(store, t, {sid: snap}, n_writes=0)
        except BaseException:
            store.clock.abandon(t)
            raise
        store.clock.publish(t)
        report.repacked.append(sid)
        migrated = held = 0
        for lu, nd in snap.dirs.items():
            od = head.dirs.get(lu)
            if od is None:
                continue
            if nd.tier != od.tier:
                migrated += 1
            elif int(store.pool.tier_for_degree(cart.degree(store.pool, nd))) != nd.tier:
                held += 1
        if migrated:
            store.stats.add("tier_migrations", migrated)
            report.tier_migrations += migrated
        if held:
            store.stats.add("tier_migrations_held", held)

    # -- background thread ---------------------------------------------------
    def start(self, interval: float = 1.0) -> None:
        """Fold every ``interval`` seconds on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("compactor already running")
        self._stop_event.clear()

        def _loop() -> None:
            while not self._stop_event.wait(interval):
                try:
                    ckpt = (
                        self.checkpoint_dir is not None
                        and self.checkpoint_every > 0
                        and (self.cycles + 1) % self.checkpoint_every == 0
                    )
                    self.compact_once(checkpoint=ckpt)
                except BaseException as exc:  # pragma: no cover - defensive
                    self._error = exc
                    return

        self._thread = threading.Thread(
            target=_loop, name="rapidstore-compactor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the background thread; re-raises a background failure."""
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


__all__ = ["CompactionReport", "Compactor"]
