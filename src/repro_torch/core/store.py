"""RapidStore: the multi-version dynamic graph store (paper §4-§6).

Composition:

- a :class:`~repro_torch.core.clock.LogicalClock` coordinating (t_w, t_r);
- a :class:`~repro_torch.core.reader_tracer.ReaderTracer` with k slots;
- one :class:`~repro_torch.core.version_chain.VersionChain` per subgraph (vertex
  blocks of ``|P|`` contiguous ids), each version a copy-on-write
  :class:`~repro_torch.core.subgraph.SubgraphSnapshot` over a shared
  :class:`~repro_torch.core.leaf_pool.LeafPool`;
- per-subgraph writer locks (MV2PL, acquired in subgraph-id order).

Readers never lock: ``read_view()`` registers in the tracer, resolves one
snapshot per subgraph at the pinned timestamp, and hands back an immutable
:class:`~repro_torch.core.snapshot.SnapshotView`.

Writes run single-shot (``insert_edges`` = one route -> prepare -> commit
transaction, :mod:`repro_torch.core.txn`) or, after ``attach_write_pipeline()``,
through the decoupled group-commit pipeline (``apply_async``/``flush``,
:mod:`repro_torch.core.write_pipeline`).

Device: the store's views keep their device materializations (leaf tiles,
COO, CSR) as torch tensors on ``store.device`` — the current card
(``cuda:k``, always indexed) unless the
caller passes another device (the tests pass ``"cpu"``).  Without CUDA and
without an explicit ``device`` the constructors raise instead of running
on the CPU.
"""

from __future__ import annotations

import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

import torch

from ..kernels.runtime import default_device, indexed
from .arrays import sorted_unique
from .clock import LogicalClock
from .leaf_pool import LeafPool, TieredLeafPool, env_leaf_tiers, parse_leaf_tiers
from .reader_tracer import FREE_TS, ReaderTracer
from .snapshot import SnapshotView
from .subgraph import SubgraphSnapshot, build_subgraph
from .version_chain import CommitLineage, VersionChain
from . import txn as _txn
from ..obs import metrics as _metrics
from ..obs.trace import TRACER as _trc
from ..obs.trace import new_id as _new_read_id


class StoreStats(dict):
    """Thread-safe counter dict, backed by telemetry-plane counters.

    A plain ``stats[key] += 1`` is a read-modify-write of two bytecodes —
    two writers with disjoint subgraph sets hold no common lock, so
    concurrent increments could interleave and lose updates.  ``add``
    routes every increment through one locked
    :class:`repro_torch.obs.metrics.Counter` (named ``store_<key>``, registered
    on the owning store's registry so it shows up in Prometheus/report
    exports); the counter mirrors its value back into this dict *under
    its lock*, so plain dict reads stay exact under concurrency.
    """

    def __init__(self, *args, registry: Optional[_metrics.MetricsRegistry] = None,
                 **kwargs) -> None:
        super().__init__()
        self.registry = registry if registry is not None else _metrics.MetricsRegistry()
        for key, value in dict(*args, **kwargs).items():
            self._counter(key)
            if value:
                self.add(key, value)

    def _counter(self, key: str) -> _metrics.Counter:
        c = self.registry.counter("store_" + key)
        if c.mirror is None:
            # mirror runs under the counter's lock; bind dict.__setitem__
            # directly so the view update is exact (no re-read)
            store_view = super().__setitem__
            c.mirror = lambda v, _set=store_view, _k=key: _set(_k, v)
            super().setdefault(key, c.value)
        return c

    def add(self, key: str, delta: int = 1) -> int:
        return self._counter(key).add(delta)


@dataclass
class ReadHandle:
    slot: int
    ts: int
    view: SnapshotView
    trace_token: int = 0
    read_id: int = 0  # also ``view.read_id``: joins the read's spans


def _resolve_device(device) -> torch.device:
    """``device`` as an indexed ``torch.device`` (``"cuda"`` names the
    current card: ``cuda:k``); ``None`` means the current CUDA card, and
    raises when there is none (never a silent CPU fallback)."""
    return indexed(device) if device is not None else default_device()


def _make_pool(leaf_tiers, B, initial_rows):
    """Resolve the leaf pool from tier config (paper §6.2 skew adaptation).

    Precedence: explicit ``leaf_tiers`` > ``REPRO_LEAF_TIERS`` env > the
    single-width ``B``.  A multi-tier spec builds a
    :class:`~repro_torch.core.leaf_pool.TieredLeafPool` whose max tier becomes the
    store's compat width ``B``; a single-tier spec (or none) keeps the plain
    :class:`~repro_torch.core.leaf_pool.LeafPool` and today's exact layout.
    Returns ``(tiers_or_None, pool)``.
    """
    tiers = (
        parse_leaf_tiers(leaf_tiers) if leaf_tiers is not None else env_leaf_tiers()
    )
    if tiers is not None and len(tiers) > 1:
        return tiers, TieredLeafPool(tiers=tiers, initial_capacity=initial_rows)
    width = int(tiers[0]) if tiers is not None else int(B)
    return None, LeafPool(B=width, initial_capacity=initial_rows)


class RapidStore:
    """In-memory dynamic graph store for concurrent queries."""

    def __init__(
        self,
        n_vertices: int,
        partition_size: int = 64,
        B: int = 512,
        high_threshold: Optional[int] = None,
        tracer_k: int = 32,
        initial_pool_rows: int = 64,
        clock_stall_timeout: float = 60.0,
        leaf_tiers=None,
        device=None,
    ) -> None:
        if n_vertices <= 0:
            raise ValueError("need at least one vertex")
        self.device = _resolve_device(device)
        self.p = int(partition_size)
        self.leaf_tiers, self.pool = _make_pool(
            leaf_tiers, B, initial_pool_rows
        )
        self.B = self.pool.B
        self.high_threshold = int(
            high_threshold if high_threshold is not None else self.B // 2
        )
        self.n_vertices = int(n_vertices)
        self.n_subgraphs = -(-self.n_vertices // self.p)
        self.clock = LogicalClock(stall_timeout=clock_stall_timeout)
        self.tracer = ReaderTracer(k=tracer_k)
        self.chains: List[VersionChain] = []
        for sid in range(self.n_subgraphs):
            empty = build_subgraph(
                sid, self.p, self.pool, np.empty(0, np.int64), np.empty(0, np.int32),
                high_threshold=self.high_threshold,
            )
            self.chains.append(VersionChain(sid, empty))
        self.locks = [threading.Lock() for _ in range(self.n_subgraphs)]
        # vertex lifecycle (paper §6.5): reusable-id queue + atomic grow
        self._vid_lock = threading.Lock()
        self._free_vids: List[int] = []
        self.registry = _metrics.MetricsRegistry()
        self.stats: Dict[str, int] = StoreStats(
            commits=0, versions_reclaimed=0, registry=self.registry
        )
        # delta plane: commit lineage + the most recent retired view's
        # assembly bundle (strong here, weak in views — see begin_read)
        self.lineage = CommitLineage()
        self._retired_assembly = None
        self._retire_lock = threading.Lock()
        # shard plane (attach_shard_plane); None = single-device paths
        self.shard_plane = None
        # durable placement-epoch history [(ts, {sid: dst})] — appended by
        # each migration flip and replayed from WAL migrate records, so a
        # re-attached plane resolves the same placement history
        self._placement_log: List[Tuple[int, Dict[int, int]]] = []
        # elastic rebalancer (attach_rebalancer); needs a shard plane
        self.rebalancer = None
        # decoupled write pipeline (attach_write_pipeline); None = single-shot
        self.write_pipeline = None
        # durability + tiering (attach_wal / attach_compactor)
        self.wal = None
        self.compactor = None
        # frozen base level: the compactor's fully-materialized packed-stream
        # bundle (strong ref) — the view assembler's base+delta splice source
        self._base_assembly = None
        self._register_gauges()

    def _register_gauges(self) -> None:
        """Derived health gauges (callback-backed: evaluated at export time)."""
        reg = self.registry
        reg.gauge("reader_horizon_lag", fn=self.reader_horizon_lag)
        reg.gauge("reader_tracer_busy_slots", fn=self.tracer.busy_slots)
        reg.gauge(
            "wal_backlog_bytes",
            fn=lambda: self.wal.backlog_bytes() if self.wal is not None else 0,
        )
        for component in ("pool", "versions", "retired", "base", "lineage",
                          "pipeline"):
            reg.gauge(
                "store_memory_bytes",
                fn=lambda c=component: self.memory_breakdown()[c],
                component=component,
            )
        self._h_read = reg.histogram("read_latency_seconds")

    # -- construction -------------------------------------------------------------
    @classmethod
    def from_edges(
        cls,
        n_vertices: int,
        edges: np.ndarray,
        undirected: bool = False,
        **kw,
    ) -> "RapidStore":
        """Bulk-load version 0 from an ``[m, 2]`` edge array."""
        edges = np.asarray(edges)
        if undirected and len(edges):
            edges = np.concatenate([edges, edges[:, ::-1]])
        store = cls.__new__(cls)
        store.device = _resolve_device(kw.get("device"))
        store.p = int(kw.get("partition_size", 64))
        est_rows = max(64, len(edges) // max(1, int(kw.get("B", 512))) * 2)
        store.leaf_tiers, store.pool = _make_pool(
            kw.get("leaf_tiers"), kw.get("B", 512), est_rows
        )
        store.B = store.pool.B
        ht = kw.get("high_threshold")
        store.high_threshold = int(ht if ht is not None else store.B // 2)
        store.n_vertices = int(n_vertices)
        store.n_subgraphs = -(-store.n_vertices // store.p)
        store.clock = LogicalClock(
            stall_timeout=kw.get("clock_stall_timeout", 60.0)
        )
        store.tracer = ReaderTracer(k=int(kw.get("tracer_k", 32)))
        store.locks = [threading.Lock() for _ in range(store.n_subgraphs)]
        store._vid_lock = threading.Lock()
        store._free_vids = []
        store.registry = _metrics.MetricsRegistry()
        store.stats = StoreStats(
            commits=0, versions_reclaimed=0, registry=store.registry
        )
        store.lineage = CommitLineage()
        store._retired_assembly = None
        store._retire_lock = threading.Lock()
        store.shard_plane = None
        store._placement_log = []
        store.rebalancer = None
        store.write_pipeline = None
        store.wal = None
        store.compactor = None
        store._base_assembly = None
        store._register_gauges()

        store.chains = []
        if len(edges):
            u = edges[:, 0].astype(np.int64)
            v = edges[:, 1].astype(np.int32)
            if u.max() >= n_vertices or v.max() >= n_vertices:
                raise ValueError("vertex id out of range")
            if u.min() < 0 or v.min() < 0:
                # negative ids would floor-divide into bogus subgraphs and
                # corrupt the (u << 32) | v dedup key below
                raise ValueError(
                    f"negative vertex id {min(int(u.min()), int(v.min()))}"
                )
            # de-dup (u,v) pairs, sort by (u,v): clustered bulk order
            key = (u << 32) | v.astype(np.int64)
            key = sorted_unique(key)
            u = (key >> 32).astype(np.int64)
            v = (key & 0xFFFFFFFF).astype(np.int32)
            sid_of = u // store.p
            bounds = np.searchsorted(sid_of, np.arange(store.n_subgraphs + 1))
        for sid in range(store.n_subgraphs):
            if len(edges):
                lo, hi = bounds[sid], bounds[sid + 1]
                lu = u[lo:hi] - sid * store.p
                lv = v[lo:hi]
            else:
                lu = np.empty(0, np.int64)
                lv = np.empty(0, np.int32)
            snap = build_subgraph(
                sid, store.p, store.pool, lu, lv, high_threshold=store.high_threshold
            )
            store.chains.append(VersionChain(sid, snap))
        return store

    # -- write API -------------------------------------------------------------
    def _write(self, ins, dels, vset=None) -> int:
        """One logical write: single-shot txn, or routed through the pipeline.

        With no pipeline attached this IS ``txn.execute_write`` (route ->
        lock -> prepare -> commit -> reclaim).  With one attached, the
        write is submitted to its shard queue and waited on — the same
        logical write as a group commit of a batch of one (plus whatever
        the scheduler coalesced alongside it).
        """
        wp = self.write_pipeline
        if wp is not None:
            return wp.submit(ins, dels, vset).wait()
        return _txn.execute_write(self, ins=ins, dels=dels, vset=vset)

    def insert_edges(self, edges: np.ndarray) -> int:
        """Insert a batch of edges in ONE write transaction. Returns commit ts."""
        edges = np.atleast_2d(np.asarray(edges))
        return self._write(ins=edges, dels=np.empty((0, 2), np.int64))

    def delete_edges(self, edges: np.ndarray) -> int:
        edges = np.atleast_2d(np.asarray(edges))
        return self._write(ins=np.empty((0, 2), np.int64), dels=edges)

    def apply(self, ins: np.ndarray, dels: np.ndarray) -> int:
        """Mixed insert+delete transaction."""
        return self._write(
            ins=np.atleast_2d(np.asarray(ins)) if len(ins) else np.empty((0, 2), np.int64),
            dels=np.atleast_2d(np.asarray(dels)) if len(dels) else np.empty((0, 2), np.int64),
        )

    def apply_async(self, ins: np.ndarray, dels: np.ndarray, vset=None):
        """Submit a logical write WITHOUT waiting for its commit.

        Returns a :class:`~repro_torch.core.write_pipeline.WriteTicket`; the write
        becomes visible, atomically with the rest of its group-commit batch,
        at ``ticket.wait()``'s timestamp.  Attaches a default write pipeline
        on first use if none is attached.  Validation still runs on this
        thread, so bad input raises here, not in the worker.
        """
        if self.write_pipeline is None:
            self.attach_write_pipeline()
        ins = np.atleast_2d(np.asarray(ins)) if len(ins) else np.empty((0, 2), np.int64)
        dels = np.atleast_2d(np.asarray(dels)) if len(dels) else np.empty((0, 2), np.int64)
        return self.write_pipeline.submit(ins, dels, vset)

    def flush(self) -> None:
        """Barrier: wait until every submitted async write is published.

        A no-op without a pipeline (single-shot writes are synchronous).
        """
        wp = self.write_pipeline
        if wp is not None:
            wp.flush()

    def insert_edge(self, u: int, v: int) -> int:
        return self.insert_edges(np.array([[u, v]], np.int64))

    def delete_edge(self, u: int, v: int) -> int:
        return self.delete_edges(np.array([[u, v]], np.int64))

    # -- vertex lifecycle (paper §6.5) ------------------------------------------
    def insert_vertex(self) -> int:
        """Add a vertex: reuse a freed id or grow the id space."""
        with self._vid_lock:
            if self._free_vids:
                vid = self._free_vids.pop()
            else:
                vid = self.n_vertices
                self.n_vertices += 1
                if vid // self.p >= self.n_subgraphs:
                    sid = self.n_subgraphs
                    empty = build_subgraph(
                        sid, self.p, self.pool, np.empty(0, np.int64),
                        np.empty(0, np.int32), high_threshold=self.high_threshold,
                    )
                    self.chains.append(VersionChain(sid, empty))
                    self.locks.append(threading.Lock())
                    self.n_subgraphs += 1
        self._write(
            ins=np.empty((0, 2), np.int64),
            dels=np.empty((0, 2), np.int64),
            vset={vid: True},
        )
        return vid

    def delete_vertex(self, u: int) -> int:
        """Delete vertex u: remove incident out-edges, clear flag, recycle id.

        In-edges e(w, u) must be deleted by the caller if tracked (directed
        store semantics; undirected graphs store both directions anyway).
        """
        # the incident-edge scan must see every earlier async write to u
        self.flush()
        with self.read_view() as view:
            nbrs = view.scan(u).copy()
        dels = np.stack([np.full(len(nbrs), u, np.int64), nbrs.astype(np.int64)], 1) \
            if len(nbrs) else np.empty((0, 2), np.int64)
        ts = self._write(
            ins=np.empty((0, 2), np.int64), dels=dels, vset={u: False}
        )
        with self._vid_lock:
            self._free_vids.append(int(u))
        return ts

    # -- read API ---------------------------------------------------------------
    def begin_read(self) -> ReadHandle:
        """Register a read query and build its snapshot view (paper §5.2.2).

        The view is lineage-linked: it receives a *weak* reference to the
        most recently retired view's assembly bundle plus the commit-lineage
        handle, so its materializers can splice only the subgraphs dirtied
        between the two timestamps (delta plane) instead of re-concatenating
        all S.  Weak linkage keeps GC free to reclaim superseded bundles.

        Each read gets an id (``handle.read_id``, ``view.read_id``); with
        tracing on, a ``pin`` span covers this call and the ``read`` span
        (to :meth:`end_read`) is the root of the read's spans.
        """
        rid = _new_read_id()
        token = _trc.begin()
        t = self.clock.read_timestamp()
        slot = self.tracer.register(t)
        # Close the register/GC race: re-read t_r after publishing our slot;
        # if a writer advanced it meanwhile, bump our pin monotonically.
        t2 = self.clock.read_timestamp()
        if t2 != t:
            self.tracer.update(slot, t2)
            t = t2
        snaps = tuple(chain.resolve(t) for chain in self.chains)
        retired = self._retired_assembly
        view = SnapshotView(
            t, self.p, snaps, self.n_vertices, B=self.B,
            pred=weakref.ref(retired) if retired is not None else None,
            lineage=self.lineage,
            plane=self.shard_plane,
            base=self._base_assembly,
            device=self.device,
            read_id=rid,
        )
        self.stats.add("reads_begun")
        if token:
            _trc.end(token, "pin", cat="read", ts=t,
                     args={"ts": t, "chains": len(self.chains)}, read=rid)
        return ReadHandle(slot=slot, ts=t, view=view, trace_token=token, read_id=rid)

    def end_read(self, handle: ReadHandle) -> None:
        self.tracer.unregister(handle.slot)
        self._retire_view(handle.view)
        self.stats.add("reads_ended")
        if handle.trace_token:
            _trc.end(handle.trace_token, "read", cat="read", ts=handle.ts,
                     read=handle.read_id, root=True)
            self._h_read.observe(
                (time.perf_counter_ns() - handle.trace_token) / 1e9
            )

    def _retire_view(self, view: SnapshotView) -> None:
        """Keep the newest retired view's assembly state for successors.

        Only bundles that actually assembled something are kept (a
        point-read-only view must not clobber a materialized predecessor),
        and only the single newest — the previous bundle loses its last
        strong reference here, so Python GC reclaims superseded assembly
        arrays instead of a lineage-linked chain pinning all history.
        """
        a = view.assembly
        if a is None or not a.has_content():
            return
        with self._retire_lock:
            cur = self._retired_assembly
            if cur is None or a.ts >= cur.ts:
                self._retired_assembly = a

    @contextmanager
    def read_view(self) -> Iterator[SnapshotView]:
        h = self.begin_read()
        try:
            yield h.view
        finally:
            self.end_read(h)

    # -- shard plane --------------------------------------------------------------
    def attach_shard_plane(
        self,
        n_devices: Optional[int] = None,
        policy="modulo",
        symmetric: bool = False,
        devices=None,
        mesh=None,
    ):
        """Attach a :class:`~repro_torch.core.shard_plane.ShardPlane`.

        Subsequent ``begin_read`` views route their collective analytics
        (``pagerank_view`` etc. and ``spmm_view``) through the plane's
        per-shard tiles.  ``devices`` lists each shard's ``torch.device``
        (repeats allowed: several shards may share a card); without it
        ``n_devices`` shards follow ``self.device`` — on the CPU every
        shard is ``cpu``, on CUDA shard ``k`` sits on visible card
        ``k % n_cards`` (:func:`repro_torch.launch.mesh.shard_devices`).
        ``symmetric=True`` declares the store holds a symmetrized graph,
        enabling the pull-form PageRank (see the shard_plane docstring).
        ``mesh`` (from :func:`repro_torch.launch.mesh.
        distributed_shard_mesh`) spreads the shards over processes, one
        store each: this process holds only its own shards' tiles.

        Any placement epochs in the store's durable log (earlier
        migrations, or WAL-replayed migrate records) are replayed into the
        fresh plane, so a re-attach — including after :meth:`recover` —
        resolves the same placement history as before.
        """
        from .shard_plane import ShardPlane

        plane = ShardPlane(
            self, devices=devices, n_devices=n_devices, policy=policy,
            symmetric=symmetric, mesh=mesh,
        )
        for ts, moves in self._placement_log:
            plane.record_epoch(ts, moves)
        self.shard_plane = plane
        return plane

    def detach_shard_plane(self) -> None:
        """Drop the plane; new views take the single-device paths again.

        Releases everything the plane pinned: its per-shard telemetry
        metrics (``plane.close()`` — leaving them registered would leak
        dead gauges into every export and keep the plane alive through
        their closures), the retired AND frozen-base bundles' sharded
        twins, and every snapshot's per-(snapshot, shard) tile cache, so
        ``memory_bytes()`` returns to its pre-attach level.
        """
        if self.rebalancer is not None:
            self.detach_rebalancer()
        plane = self.shard_plane
        self.shard_plane = None
        if plane is not None:
            plane.close()
        with self._retire_lock:
            retired = self._retired_assembly
            if retired is not None:
                retired.sharded = None
        base = self._base_assembly
        if base is not None:
            base.sharded = None
        from . import device_cache as _dc

        with _dc._mat_lock:
            for chain in self.chains:
                for snap in chain._versions:
                    if snap._shard_dev_cache:
                        snap._shard_dev_cache.clear()

    # -- elastic rebalancer -------------------------------------------------------
    def attach_rebalancer(self, **kw):
        """Attach a :class:`~repro_torch.core.reshard.Rebalancer` (see its doc).

        Requires an attached shard plane.  Keyword arguments are forwarded
        (``imbalance_threshold``, ``max_moves``, ``queue_weight``).  Drive
        it with ``rebalancer.rebalance_once()`` or ``rebalancer.start()``.
        """
        from .reshard import Rebalancer

        if self.rebalancer is not None:
            raise RuntimeError("a rebalancer is already attached")
        self.rebalancer = Rebalancer(self, **kw)
        return self.rebalancer

    def detach_rebalancer(self) -> None:
        rb = self.rebalancer
        if rb is None:
            return
        try:
            rb.stop()
        finally:
            self.rebalancer = None

    # -- decoupled write pipeline -----------------------------------------------
    def attach_write_pipeline(self, n_shards: int = 4, max_batch: int = 1024):
        """Attach a :class:`~repro_torch.core.write_pipeline.WritePipeline`.

        Subsequent writes — synchronous ``insert_edges``/``delete_edges``/
        ``apply`` and async ``apply_async`` — route through per-shard
        writer queues with group commit and commit pipelining (shard of a
        subgraph = ``sid % n_shards``).  While attached, do NOT call
        ``txn.execute_write`` directly: the pipeline replaces the
        per-subgraph locks with exclusive shard ownership.
        """
        from .write_pipeline import WritePipeline

        if self.write_pipeline is not None:
            raise RuntimeError("a write pipeline is already attached")
        self.write_pipeline = WritePipeline(
            self, n_shards=n_shards, max_batch=max_batch
        )
        return self.write_pipeline

    def detach_write_pipeline(self) -> None:
        """Flush, stop the pipeline threads, restore single-shot writes."""
        wp = self.write_pipeline
        if wp is None:
            return
        try:
            wp.stop()
        finally:
            self.write_pipeline = None

    # -- durability: WAL + compactor + checkpoint + recovery ----------------------
    def attach_wal(self, path, fsync: bool = True):
        """Attach a :class:`~repro_torch.core.wal.WriteAheadLog` at ``path``.

        Every subsequent commit — single-shot and group — is appended and
        fsync'd before it publishes; compactor repacks are logged too, so
        :meth:`recover` replays layout-faithfully.  Attaching an existing
        log resumes it (torn tail truncated); a fresh log starts at the
        clock's current read timestamp.
        """
        from .wal import WriteAheadLog

        if self.wal is not None:
            raise RuntimeError("a WAL is already attached")
        self.wal = WriteAheadLog(
            path, start_ts=self.clock.read_timestamp(), fsync=fsync
        )
        return self.wal

    def detach_wal(self) -> None:
        w = self.wal
        if w is None:
            return
        try:
            w.close()
        finally:
            self.wal = None

    def attach_compactor(self, **kw):
        """Attach a :class:`~repro_torch.core.compactor.Compactor` (see its doc).

        Keyword arguments are forwarded (``min_waste_rows``,
        ``checkpoint_dir``, ``checkpoint_every``, ``keep_checkpoints``).
        Drive it with ``compactor.compact_once()`` or ``compactor.start()``.
        """
        from .compactor import Compactor

        if self.compactor is not None:
            raise RuntimeError("a compactor is already attached")
        self.compactor = Compactor(self, **kw)
        return self.compactor

    def detach_compactor(self) -> None:
        c = self.compactor
        if c is None:
            return
        try:
            c.stop()
        finally:
            self.compactor = None

    def checkpoint(self, directory) -> int:
        """Persist a durable base snapshot; returns its timestamp.

        Captures one consistent view (concurrent writers keep committing)
        and writes its edge set, vertex flags, free-id queue, and store
        config through :mod:`repro_torch.checkpoint.manager`'s committed-save
        protocol (tmp dir + ``_COMPLETE`` marker + atomic rename).  Pair
        with ``wal.reset(ts)`` — the compactor's checkpoint cycle does —
        to bound the recovery replay window.
        """
        from ..checkpoint import manager as _ckpt

        with self.read_view() as v:
            ts = v.ts
            n_vertices = v.n_vertices
            src, dst = v.to_coo()
            active = np.concatenate([s.active for s in v.snaps])[:n_vertices]
        with self._vid_lock:
            free = np.array(sorted(self._free_vids), np.int64)
        tree = {
            "src": np.asarray(src, np.int64),
            "dst": np.asarray(dst, np.int64),
            "active": np.asarray(active, bool),
            "free_vids": free,
        }
        extra = {
            "kind": "rapidstore",
            "ts": int(ts),
            "n_vertices": int(n_vertices),
            "partition_size": int(self.p),
            "B": int(self.B),
            "high_threshold": int(self.high_threshold),
            "leaf_tiers": [int(t) for t in self.leaf_tiers]
            if self.leaf_tiers is not None
            else None,
        }
        _ckpt.save(directory, step=int(ts), tree=tree, extra=extra)
        self.stats.add("checkpoints", 1)
        return int(ts)

    @classmethod
    def recover(
        cls,
        root,
        wal_filename: str = "wal.log",
        checkpoint_subdir: str = "checkpoints",
        attach: bool = True,
        fsync: bool = True,
        device=None,
        **store_kw,
    ) -> "RapidStore":
        """Rebuild a store from ``root`` after a crash: checkpoint + WAL.

        ``root`` is the durability directory holding ``wal.log`` and
        ``checkpoints/`` (the layout :meth:`attach_wal` +
        ``attach_compactor(checkpoint_dir=...)`` produce).  The newest
        committed checkpoint seeds the store (its saved config overrides
        ``store_kw``); the WAL suffix is replayed in timestamp order at the
        ORIGINAL commit timestamps — including repack records, so the
        clustered-index/C-ART layout history is reproduced and recovered
        ``SnapshotView`` materializations are bitwise-identical to a serial
        re-application of the same ops.  A torn WAL tail (crash mid-append)
        is dropped; everything durable before it replays.  With no
        checkpoint, ``store_kw`` must supply ``n_vertices`` and layout
        parameters matching the original store.

        ``attach=True`` re-attaches the WAL (truncating the torn tail on
        disk) so the recovered store continues durable service.  ``device``
        is the constructor's: the recovered views live on the card unless
        the caller names another device, and without a card the default
        raises.
        """
        import os

        from .wal import WriteAheadLog

        store_kw = dict(store_kw, device=_resolve_device(device))
        root = str(root)
        wal_path = os.path.join(root, wal_filename)
        ckpt_dir = os.path.join(root, checkpoint_subdir)

        from ..checkpoint import manager as _ckpt

        step = _ckpt.latest_step(ckpt_dir)
        if step is not None:
            arrays, meta = _ckpt.restore_raw(ckpt_dir, step=step)
            extra = meta["extra"]
            store_kw = dict(store_kw)
            store_kw.pop("n_vertices", None)
            for key in ("partition_size", "B", "high_threshold"):
                store_kw[key] = extra[key]
            # tier config is layout-determining, so the checkpoint's record
            # beats REPRO_LEAF_TIERS: a single-B checkpoint pins a single-B
            # pool (passing (B,) suppresses the env fallback)
            lt = extra.get("leaf_tiers")
            store_kw["leaf_tiers"] = tuple(lt) if lt else (extra["B"],)
            edges = np.stack([arrays["src"], arrays["dst"]], axis=1) \
                if len(arrays["src"]) else np.empty((0, 2), np.int64)
            store = cls.from_edges(extra["n_vertices"], edges, **store_kw)
            # vertex flags: heads are version-0 snapshots nobody has read
            # yet, so direct mutation is safe here (and only here)
            for vid in np.nonzero(~arrays["active"])[0]:
                store.chains[int(vid) // store.p].head.active[
                    int(vid) % store.p
                ] = False
            store._free_vids = [int(v) for v in arrays["free_vids"]]
            store.clock.restore(int(extra["ts"]))
        else:
            if "n_vertices" not in store_kw:
                raise ValueError(
                    "recover() without a checkpoint needs n_vertices (and "
                    "matching layout parameters) in store_kw"
                )
            store_kw = dict(store_kw)
            store = cls(store_kw.pop("n_vertices"), **store_kw)

        replayed = 0
        if os.path.exists(wal_path):
            _, records, clean = WriteAheadLog.replay(wal_path)
            floor = store.clock.read_timestamp()
            for rec in records:
                if rec.ts <= floor:
                    continue  # already covered by the checkpoint
                store._replay_record(rec)
                replayed += 1
            if not clean:
                store.stats.add("wal_torn_tail", 1)
        store.stats.add("wal_replayed", replayed)
        # replay linked every record as its own version with no readers
        # active — collapse the chains down to their heads
        final_ts = store.clock.read_timestamp()
        for chain in store.chains:
            chain.collect([final_ts])
        if attach:
            store.attach_wal(wal_path, fsync=fsync)
        return store

    def _ensure_vertices(self, n: int) -> None:
        """Grow the id space to at least ``n`` vertices (WAL replay path).

        Mirrors :meth:`insert_vertex`'s growth: appends empty version-0
        chains (and locks) for any new subgraphs.
        """
        with self._vid_lock:
            if n <= self.n_vertices:
                return
            self.n_vertices = int(n)
            needed = -(-self.n_vertices // self.p)
            while self.n_subgraphs < needed:
                sid = self.n_subgraphs
                empty = build_subgraph(
                    sid, self.p, self.pool, np.empty(0, np.int64),
                    np.empty(0, np.int32), high_threshold=self.high_threshold,
                )
                self.chains.append(VersionChain(sid, empty))
                self.locks.append(threading.Lock())
                self.n_subgraphs += 1

    def _replay_record(self, rec) -> None:
        """Apply one WAL record at its original commit timestamp.

        Replay is single-threaded: versions are linked directly (prepare +
        link) and the clock is restored past each timestamp instead of
        running the publish protocol, so timestamp gaps (abandoned or
        never-synced commits) are stepped over exactly as the live clock
        stepped over them.
        """
        from .wal import KIND_MIGRATE, KIND_REPACK
        from .subgraph import build_subgraph as _build

        self._ensure_vertices(rec.n_vertices)
        if rec.kind == KIND_MIGRATE:
            # placement flip: a no-write commit — restore the epoch into the
            # durable log (and the plane, if one is already attached) at its
            # original timestamp so recovered views resolve the same
            # placement history the crashed store did
            moves = dict(rec.moves)
            self._placement_log.append((rec.ts, moves))
            self.lineage.record_placement(rec.ts, moves)
            if self.shard_plane is not None:
                self.shard_plane.record_epoch(rec.ts, moves)
            self.clock.restore(rec.ts)
            return
        if rec.kind == KIND_REPACK:
            for sid in rec.sids:
                head = self.chains[sid].head
                src, dst = head.to_coo_global()
                # tier hints mirror the live compactor's: hysteresis against
                # the pre-repack tier, which matches the original run's head
                # by induction over the replayed record sequence
                snap = _build(
                    sid, self.p, self.pool, src - sid * self.p, dst,
                    high_threshold=self.high_threshold,
                    tier_hints={int(lu): d.tier for lu, d in head.dirs.items()},
                )
                snap.active = head.active.copy()
                _txn.link_at(self, rec.ts, {sid: snap}, n_writes=0)
        else:
            rw = _txn.route(self, rec.ins, rec.dels, rec.vset)
            if rw is not None:
                new_snaps = _txn.prepare(self, rw)
                if new_snaps:
                    _txn.link_at(self, rec.ts, new_snaps, n_writes=1)
            if rec.vset:
                with self._vid_lock:
                    for vid, flag in sorted(rec.vset.items()):
                        if flag and vid in self._free_vids:
                            self._free_vids.remove(vid)
                        elif not flag and vid not in self._free_vids:
                            self._free_vids.append(vid)
        self.clock.restore(rec.ts)

    # -- introspection ------------------------------------------------------------
    def memory_breakdown(self) -> Dict[str, int]:
        """Per-component byte accounting (exported as ``store_memory_bytes``
        gauges, one per component; :meth:`memory_bytes` is their sum)."""
        versions = 0
        for chain in self.chains:
            # capture the list reference once, the lock-free convention
            # resolve() follows: collect()/link() replace the attribute with
            # a new list, so a captured reference is a stable snapshot
            snaps = chain._versions
            for snap in snaps:
                versions += snap.ci.values.nbytes + snap.ci.offsets.nbytes
                versions += snap.active.nbytes
                versions += snap.cache_bytes()
                versions += snap.device_cache_bytes()
                for d in snap.dirs.values():
                    versions += d.leaf_ids.nbytes + d.leaf_min.nbytes
        retired = self._retired_assembly
        # the one retained delta-plane bundle (successor splice source)
        retired_b = (
            retired.host_bytes() + retired.device_bytes()
            if retired is not None else 0
        )
        base = self._base_assembly
        # the compactor's frozen base level (strong ref, splice source)
        base_b = (
            base.host_bytes() + base.device_bytes()
            if base is not None and base is not retired else 0
        )
        # logical writes queued/prepared in the pipeline but not yet linked
        wp = self.write_pipeline
        return {
            "pool": self.pool.memory_bytes(),
            "versions": versions,
            "retired": retired_b,
            "base": base_b,
            # commit-lineage log (trimmed by the compactor's fold horizon)
            "lineage": self.lineage.memory_bytes(),
            "pipeline": wp.queued_bytes() if wp is not None else 0,
        }

    def memory_bytes(self) -> int:
        return sum(self.memory_breakdown().values())

    def reader_horizon_lag(self) -> int:
        """How far the oldest active reader pins behind ``t_r`` (0: none)."""
        oldest = self.tracer.min_active_timestamp()
        if oldest == FREE_TS:
            return 0
        return max(0, self.clock.read_timestamp() - oldest)

    def telemetry_report(self) -> str:
        """Human-readable snapshot of counters, gauges, histograms, spans."""
        from ..obs import export as _export

        return _export.telemetry_report(self)

    def fill_ratio(self) -> float:
        return self.pool.fill_ratio()

    def chain_lengths(self) -> np.ndarray:
        return np.array([len(c) for c in self.chains])

    def check_invariants(self) -> None:
        self.pool.check_invariants()
        for chain in self.chains:
            versions = chain._versions  # stable reference; see memory_bytes
            for snap in versions:
                snap.check_invariants()
