"""Elastic shard rebalancing: telemetry-driven tile migration between
shards, committed as versioned placement epochs.

The shard plane places each subgraph's tiles on a shard once, at attach
time.  On power-law graphs that freezes a bad deal: a few hub subgraphs pin
one shard while the rest idle.  This module closes the loop — a
:class:`Rebalancer` watches the telemetry plane's per-shard signals, emits
**migration plans** (small Alpa-shaped instruction streams of
``RUN``/``SEND``/``RECV``/``FREE`` ops over shards), executes them in the
background, and atomically flips the placement map at a commit-timestamp
epoch.  Instructions name shards by their index in the plane, never by
device: several shards may share one card, and each keeps its own
per-(snapshot, shard) cache entries.

Signals
-------

The rebalancer reads the owning store's metrics registry — the same surface
operators scrape:

- ``shard_plane_load{shard=k}``: current-epoch edge weight per shard (the
  primary balance signal, registered by the plane itself);
- ``pipeline_queue_depth{shard=k}``: write-pipeline backlog (a hot writer
  shard is also a hot reader shard under the store's workloads);
- ``shard_plane_uploads{shard=k}`` / ``ShardPlaneStats`` per-shard upload
  and compute counters (``collective_calls`` among them), for diagnostics
  in the plan's ``reason``; with tracing on, each query the plane serves
  records a ``query`` span with ``route`` ``plane`` and ``n_shards``.

Migration-epoch lifecycle
-------------------------

One migration runs in five stages; named hook points
(:data:`repro_torch.core.hooks.RESHARD_HOOKS`) bracket each one so the
deterministic schedule harness (``tests/_torch_schedule.py``) can park the
runtime between any two stages:

1. **SEND** (``hook_before_send``/``hook_after_send``): each moved
   subgraph's head-snapshot tiles (COO + leaf blocks) are uploaded to the
   destination shard's device *unstaged* — no shared state changes, an
   abort here leaves no trace.
2. **RECV** (``hook_after_recv``): the staged tiles are committed into the
   per-(snapshot, shard) cache (``device_cache.install_shard_tiles``), so
   the first post-flip assembly is a cache hit instead of an upload.
3. **RUN** (``hook_after_audit``): the generation-stamp freshness audit —
   ``device_cache.tiles_fresh`` re-verifies that no staged tile describes
   recycled pool rows.  A stale stamp aborts the migration before the flip
   (the staged entries are dropped); readers can never observe a
   half-migrated or stale shard because nothing observable changed yet.
4. **FLIP** (``hook_before_flip``/``hook_after_flip``): the placement
   epoch commits as a WAL-logged no-write commit, exactly the compactor's
   repack shape: reserve ``ts``, append+sync the WAL migrate record,
   record the epoch in the plane (:meth:`ShardPlane.record_epoch`) and in
   :class:`~repro_torch.core.version_chain.CommitLineage`
   (``record_placement``), then publish.  Everything before publish is
   invisible; after it, every view at ``ts >= epoch`` resolves the new
   placement and every older view keeps the old one.  A failure abandons
   ``ts`` so the publish window never sticks.  With a write pipeline
   attached the flip runs under its quiesce barrier (the compactor's
   protocol), so it never lands inside a group commit's publish run.
5. **FREE** (``hook_before_free``): the moved subgraphs' source-shard
   cache entries are dropped.  Views pinned before the epoch keep working
   — their assembled bundles hold their own tensors; only a fresh
   old-timestamp assembly would re-upload.

Over ranks (a plane on a mesh of several processes): every rank holds the
whole store and plans the same moves; SEND and RECV run only on the rank
that owns the destination shard, and each rank flips its own epoch.  The
ranks' placements agree only while every rank runs ``plan_moves`` and
``execute`` at the same point of the same commit sequence, so that its
epoch takes the same timestamp: :meth:`Rebalancer.start` (a timer a rank)
and ``queue_weight`` (a rank's own queue) are refused there.

Durability: the WAL migrate record replays through
:meth:`RapidStore.recover` into ``store._placement_log``;
``attach_shard_plane`` replays that log into the fresh plane, so a
recovered store resolves the same placement history the crashed store did
(exact when the re-attached plane has the same shard count; destination
indices fold modulo the shard count otherwise).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs.trace import TRACER as _trc
from .hooks import RESHARD_HOOKS


class MigrationInstType(enum.IntEnum):
    """Instruction opcodes, the Alpa runtime shape (SNIPPETS.md §1)."""

    RUN = 0    # generation-stamp freshness audit over a staged subgraph
    SEND = 1   # upload one subgraph's tiles to the destination shard
    RECV = 2   # commit staged tiles into the per-(snapshot, shard) cache
    FREE = 3   # drop the subgraph's source-shard cache entries (post-flip)


@dataclass(frozen=True)
class MigrationInstruction:
    """One op of a migration plan's instruction stream."""

    op: MigrationInstType
    sid: int
    src: int  # source shard index
    dst: int  # destination shard index
    kind: Optional[str] = None  # "coo" | "blocks" | None (RUN/FREE: both)

    @classmethod
    def send(cls, sid, src, dst, kind):
        return cls(MigrationInstType.SEND, sid, src, dst, kind)

    @classmethod
    def recv(cls, sid, src, dst, kind):
        return cls(MigrationInstType.RECV, sid, src, dst, kind)

    @classmethod
    def run(cls, sid, src, dst):
        return cls(MigrationInstType.RUN, sid, src, dst)

    @classmethod
    def free(cls, sid, src, dst):
        return cls(MigrationInstType.FREE, sid, src, dst)


@dataclass
class MigrationPlan:
    """An instruction stream plus the placement delta it implements."""

    moves: Dict[int, int]  # sid -> destination shard index
    instructions: List[MigrationInstruction] = field(default_factory=list)
    reason: str = ""

    @property
    def n_moves(self) -> int:
        return len(self.moves)


class Rebalancer:
    """Watches per-shard telemetry, migrates tiles, flips placement epochs.

    Drive it manually (``rebalance_once()``, or ``plan_moves`` +
    ``execute`` for explicit moves) or as a daemon (``start``/``stop``,
    the compactor's thread shape).  ``imbalance_threshold`` is the
    max/mean shard-load ratio below which the plane is considered balanced
    and no plan is emitted.
    """

    def __init__(
        self,
        store,
        plane=None,
        imbalance_threshold: float = 1.5,
        max_moves: Optional[int] = None,
        queue_weight: float = 0.0,
    ) -> None:
        self.store = store
        self.plane = plane if plane is not None else store.shard_plane
        if self.plane is None:
            raise RuntimeError("rebalancer needs an attached shard plane")
        if queue_weight and self.plane.ranks is not None:
            # a rank's pipeline queue is its own: the ranks would plan apart
            raise ValueError("queue_weight needs a plane in one process: over ranks "
                             "every rank must plan the same moves")
        self.imbalance_threshold = float(imbalance_threshold)
        self.max_moves = max_moves
        # optional blend: shard load + queue_weight * pipeline queue depth
        self.queue_weight = float(queue_weight)
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._error: Optional[BaseException] = None
        # pre-register the runtime's counters (StoreStats routes them onto
        # the store registry as store_reshard_*) so exports show zeros
        # before the first migration instead of missing series
        for key in ("reshard_migrations", "reshard_sids_moved",
                    "reshard_bytes_staged", "reshard_aborts"):
            store.stats.add(key, 0)

    # -- signals -------------------------------------------------------------
    def shard_signals(self) -> Dict[int, Dict[str, float]]:
        """Per-shard signal snapshot scraped from the store's registry.

        Keys per shard: ``load`` (current-epoch edge weight), ``queue``
        (write-pipeline backlog, 0 when no pipeline), ``uploads``
        (cumulative host->device segment uploads).
        """
        K = self.plane.n_shards
        out = {k: {"load": 0.0, "queue": 0.0, "uploads": 0.0}
               for k in range(K)}
        names = {
            "shard_plane_load": "load",
            "pipeline_queue_depth": "queue",
            "shard_plane_uploads": "uploads",
        }
        for m in self.store.registry.collect():
            key = names.get(getattr(m, "name", None))
            if key is None:
                continue
            labels = dict(m.labels)
            try:
                k = int(labels.get("shard", ""))
            except ValueError:
                continue
            if 0 <= k < K:
                out[k][key] = float(m.value)
        return out

    # -- planning ------------------------------------------------------------
    def _weighted_loads(self, signals) -> List[float]:
        return [
            signals[k]["load"] + self.queue_weight * signals[k]["queue"]
            for k in sorted(signals)
        ]

    def propose(self) -> Optional[MigrationPlan]:
        """Greedy LPT-style plan from the current signals, or None.

        Repeatedly moves the heaviest shard's heaviest subgraph to the
        lightest shard while the move strictly reduces the max load.  The
        plan is advisory until :meth:`execute` commits it.
        """
        plane = self.plane
        K = plane.n_shards
        if K < 2:
            return None
        signals = self.shard_signals()
        loads = self._weighted_loads(signals)
        mean = sum(loads) / K
        if mean <= 0 or max(loads) / mean < self.imbalance_threshold:
            return None
        placement = plane.placement_for(len(self.store.chains))
        weights = [c.head.n_edges for c in self.store.chains]
        per_shard: Dict[int, List[int]] = {k: [] for k in range(K)}
        for sid, k in enumerate(placement):
            per_shard[int(k)].append(sid)
        moves: Dict[int, int] = {}
        budget = (
            self.max_moves if self.max_moves is not None
            else len(self.store.chains)
        )
        while len(moves) < budget:
            src = max(range(K), key=lambda k: loads[k])
            dst = min(range(K), key=lambda k: loads[k])
            if src == dst:
                break
            cands = sorted(
                per_shard[src], key=lambda s: weights[s], reverse=True
            )
            picked = None
            for sid in cands:
                w = float(weights[sid])
                if w <= 0:
                    break
                # move only if it strictly lowers the pairwise max
                if max(loads[src] - w, loads[dst] + w) < loads[src]:
                    picked = sid
                    break
            if picked is None:
                break
            w = float(weights[picked])
            loads[src] -= w
            loads[dst] += w
            per_shard[src].remove(picked)
            per_shard[dst].append(picked)
            moves[picked] = dst
        if not moves:
            return None
        plan = self.plan_moves(
            moves,
            reason=(
                f"imbalance max/mean={max(self._weighted_loads(signals)) / mean:.2f}"
                f" over {K} shards"
            ),
        )
        return plan

    def plan_moves(self, moves: Dict[int, int], reason: str = "manual"
                   ) -> MigrationPlan:
        """Build the instruction stream for an explicit ``{sid: dst}`` map.

        Drops no-op moves (sid already on dst).  Stream order per moved
        subgraph: SEND(coo), SEND(blocks), RECV(coo), RECV(blocks),
        RUN(audit); all FREE ops trail the stream — the runtime executes
        them only after the flip commits.
        """
        plane = self.plane
        placement = plane.placement_for(
            max([int(s) for s in moves], default=-1) + 1
        )
        eff: Dict[int, int] = {}
        for sid, dst in moves.items():
            sid, dst = int(sid), int(dst) % plane.n_shards
            if int(placement[sid]) != dst:
                eff[sid] = dst
        inst: List[MigrationInstruction] = []
        frees: List[MigrationInstruction] = []
        for sid in sorted(eff):
            src, dst = int(placement[sid]), eff[sid]
            for kind in ("coo", "blocks"):
                inst.append(MigrationInstruction.send(sid, src, dst, kind))
            for kind in ("coo", "blocks"):
                inst.append(MigrationInstruction.recv(sid, src, dst, kind))
            inst.append(MigrationInstruction.run(sid, src, dst))
            frees.append(MigrationInstruction.free(sid, src, dst))
        return MigrationPlan(moves=eff, instructions=inst + frees,
                             reason=reason)

    # -- execution -----------------------------------------------------------
    def execute(self, plan: MigrationPlan) -> Optional[int]:
        """Run a plan's instruction stream; returns the epoch ts, or None.

        ``None`` means the migration aborted before the flip (stale tiles
        or a released snapshot) — nothing observable changed.  See the
        module docstring for the five-stage lifecycle.
        """
        from . import device_cache

        if not plan.moves:
            return None
        store, plane = self.store, self.plane
        tok = _trc.begin()
        # capture one snapshot per moved subgraph for the whole stream: a
        # commit landing mid-migration creates a NEWER snapshot whose tiles
        # upload on first post-flip fetch — staging the captured one is
        # then merely wasted work, never wrong (per-snapshot caching)
        snaps = {sid: store.chains[sid].head for sid in plan.moves}
        staged: Dict[tuple, tuple] = {}  # (sid, kind) -> (key, tiles)
        ok = True
        for ins in plan.instructions:
            if ins.op in (MigrationInstType.SEND, MigrationInstType.RECV) \
                    and not plane.is_local(ins.dst):
                continue  # another process holds the destination shard
            if ins.op == MigrationInstType.SEND:
                RESHARD_HOOKS.fire("hook_before_send", sid=ins.sid,
                                   kind=ins.kind, dst=ins.dst)
                try:
                    key, tiles, nbytes = device_cache.stage_shard_tiles(
                        snaps[ins.sid], ins.dst, plane.devices[ins.dst], ins.kind
                    )
                except RuntimeError:
                    ok = False  # snapshot released mid-stream: abort
                    break
                staged[(ins.sid, ins.kind)] = (key, tiles)
                store.stats.add("reshard_bytes_staged", nbytes)
                RESHARD_HOOKS.fire("hook_after_send", sid=ins.sid,
                                   kind=ins.kind, dst=ins.dst)
            elif ins.op == MigrationInstType.RECV:
                key, tiles = staged[(ins.sid, ins.kind)]
                device_cache.install_shard_tiles(snaps[ins.sid], key, tiles)
                RESHARD_HOOKS.fire("hook_after_recv", sid=ins.sid,
                                   kind=ins.kind, dst=ins.dst)
            elif ins.op == MigrationInstType.RUN:
                if not device_cache.tiles_fresh(snaps[ins.sid]):
                    ok = False  # stale stamp: abort before anything flips
                    break
                RESHARD_HOOKS.fire("hook_after_audit", sid=ins.sid)
            # FREE handled after the flip
        if not ok:
            for sid in plan.moves:
                device_cache.drop_shard_tiles(snaps[sid], plan.moves[sid])
            store.stats.add("reshard_aborts")
            if tok:
                _trc.end(tok, "migration_abort", cat="compact",
                         args={"n_moves": plan.n_moves})
            return None
        epoch = self._commit_flip(plan.moves)
        # FREE: source-shard entries of every version of each moved chain
        for ins in plan.instructions:
            if ins.op != MigrationInstType.FREE:
                continue
            RESHARD_HOOKS.fire("hook_before_free", sid=ins.sid, src=ins.src)
            for snap in store.chains[ins.sid]._versions:
                device_cache.drop_shard_tiles(snap, ins.src)
        store.stats.add("reshard_migrations")
        store.stats.add("reshard_sids_moved", plan.n_moves)
        if tok:
            _trc.end(tok, "migration", cat="compact",
                     args={"n_moves": plan.n_moves, "epoch": epoch,
                           "reason": plan.reason})
        return epoch

    def _commit_flip(self, moves: Dict[int, int]) -> int:
        """Commit the placement epoch — the compactor's no-write shape.

        WAL-append + sync BEFORE recording, record (plane epoch + lineage +
        the store's durable placement log) BEFORE publish, abandon the
        timestamp on any failure.  Under a write pipeline the whole flip
        runs inside its quiesce barrier.
        """
        store = self.store
        wp = store.write_pipeline

        def flip() -> int:
            t = store.clock.next_commit_timestamp()
            try:
                wal = store.wal
                if wal is not None:
                    wal.append_migrate(t, moves, store.n_vertices)
                    wal.sync()
                RESHARD_HOOKS.fire("hook_before_flip", ts=t)
                self.plane.record_epoch(t, moves)
                store.lineage.record_placement(t, moves)
                store._placement_log.append((t, dict(moves)))
            except BaseException:
                store.clock.abandon(t)
                raise
            store.clock.publish(t)
            return t

        if wp is not None:
            with wp.quiesce():
                t = flip()
        else:
            t = flip()
        RESHARD_HOOKS.fire("hook_after_flip", ts=t)
        return t

    def rebalance_once(self) -> Optional[int]:
        """Propose + execute one plan; returns the epoch ts or None."""
        plan = self.propose()
        if plan is None:
            return None
        return self.execute(plan)

    # -- background loop -----------------------------------------------------
    def start(self, interval: float = 1.0) -> None:
        """Rebalance every ``interval`` seconds on a daemon thread.  Not on
        a plane over ranks: each rank's timer would flip its epochs at
        other points of its commit sequence, so the ranks' placements and
        timestamps would part; there, every rank calls ``plan_moves`` and
        ``execute`` (or ``rebalance_once``) at the same point."""
        if self.plane.ranks is not None:
            raise RuntimeError("a plane over ranks rebalances in step on every rank "
                               "(plan_moves and execute), not on a timer")
        if self._thread is not None:
            raise RuntimeError("rebalancer already running")
        self._stop_event.clear()

        def _loop() -> None:
            while not self._stop_event.wait(interval):
                try:
                    self.rebalance_once()
                except BaseException as exc:  # pragma: no cover - defensive
                    self._error = exc
                    return

        self._thread = threading.Thread(
            target=_loop, name="rapidstore-rebalancer", daemon=True
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


__all__ = [
    "MigrationInstType",
    "MigrationInstruction",
    "MigrationPlan",
    "Rebalancer",
]
