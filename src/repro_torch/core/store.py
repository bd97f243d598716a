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
transaction, :mod:`repro_torch.core.txn`).

Device: the store's views keep their device materializations (leaf tiles,
COO, CSR) as torch tensors on ``store.device`` — ``"cuda"`` unless the
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

from ..kernels.runtime import default_device
from .clock import LogicalClock
from .leaf_pool import LeafPool, TieredLeafPool, env_leaf_tiers, parse_leaf_tiers
from .reader_tracer import FREE_TS, ReaderTracer
from .snapshot import SnapshotView
from .subgraph import SubgraphSnapshot, build_subgraph
from .version_chain import CommitLineage, VersionChain
from . import txn as _txn
from ..obs import metrics as _metrics
from ..obs.trace import TRACER as _trc


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


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when there is none (never a silent CPU fallback)."""
    return torch.device(device) if device is not None else default_device()


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
        # write pipeline, WAL and compactor are not part of this package
        # yet: single-shot writes, no log, no frozen base level
        self.write_pipeline = None
        self.wal = None
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
        store.write_pipeline = None
        store.wal = None
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
            key = np.unique(key)
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
        """
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
            base=self._base_assembly,
            device=self.device,
        )
        self.stats.add("reads_begun")
        return ReadHandle(slot=slot, ts=t, view=view, trace_token=token)

    def end_read(self, handle: ReadHandle) -> None:
        self.tracer.unregister(handle.slot)
        self._retire_view(handle.view)
        self.stats.add("reads_ended")
        if handle.trace_token:
            _trc.end(handle.trace_token, "read", cat="read", ts=handle.ts)
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
