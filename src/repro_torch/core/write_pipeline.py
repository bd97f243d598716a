"""Decoupled write pipeline: sharded writer queues + group commit + commit
pipelining (paper's decoupled read/write management, ROADMAP item 1).

The single-shot path (:func:`repro_torch.core.txn.execute_write`) pays the full
commit protocol — clock increment, lineage record, per-subgraph
copy-on-write, publish poll — once per logical write.  Under a
millions-of-users ingest stream that serialized cost is the first
bottleneck.  This module decouples *submission* from *commit*:

- **Sharded writer queues.**  Subgraph ``sid`` is owned by shard
  ``sid % n_shards``; each shard has a FIFO queue drained by its own worker
  thread.  ``submit()`` routes (validates + partitions, on the caller
  thread, so bad input still raises synchronously) and enqueues; writes
  whose subgraphs all live in one shard never contend with other shards.
  A write spanning shards becomes a *fence*: it is enqueued to every
  touched queue under the pipeline's enqueue lock (one consistent order,
  no deadlock), and the last worker to reach it executes it while the
  others are parked — preserving per-subgraph FIFO order across shards.

- **Group commit.**  A worker drains its queue (up to ``max_batch``
  logical writes) and coalesces the run into ONE net write
  (:func:`repro_torch.core.txn.coalesce`: per edge the last op wins, which by
  construction yields exactly the serial-application state), builds ONE
  copy-on-write snapshot per touched subgraph, and hands the prepared
  batch to the committer.  The committer drains every prepared batch
  available, reserves that many *consecutive* commit timestamps in one
  clock operation, links + records ONE
  :class:`~repro_torch.core.version_chain.CommitLineage` entry per batch
  (carrying ``n_writes``), and publishes the whole run with ONE
  conditional increment (``clock.publish_range``) — clock, lineage, and
  snapshot overhead are all amortized across the batch.

- **Commit pipelining.**  After handing a prepared batch off, a worker
  immediately begins preparing its next batch *on top of the
  prepared-but-not-yet-linked snapshots* (the pipeline's pending heads),
  so the prepare of batch N+1 overlaps the commit/reclaim of batch N.
  Exclusive shard ownership replaces the per-subgraph locks: while a
  pipeline is attached, every write MUST route through it
  (``RapidStore.insert_edges``/``apply``/``apply_async`` all do); calling
  ``txn.execute_write`` directly against a pipelined store is unsupported.

Visibility contract (group commit)
----------------------------------
Every logical write in a drained batch becomes visible at ONE commit
timestamp, atomically: a reader either observes the entire batch or none
of it (readers pin ``t_r``, which ``publish_range`` only moves across
fully-linked runs).  Writes on the same shard — and any writes touching a
common subgraph, which the fence forces into every relevant queue — commit
in submission order.  ``WriteTicket.wait()`` returns the batch's shared
commit timestamp (0 when the write's whole batch was a no-op);
``flush()`` is a full barrier: when it returns, every previously submitted
write has been committed AND published (or the pipeline's failure is
re-raised).  The one observable difference from the serial path: a
logical write that is individually a no-op reports its batch's timestamp
rather than 0 when other writes in the batch did commit.
"""

from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from . import txn as _txn
from ..obs import metrics as _metrics
from ..obs.trace import TRACER as _trc


class WriteTicket:
    """Handle for one submitted logical write; resolves at publish time."""

    __slots__ = ("seq", "_event", "_ts", "_error", "_t0")

    def __init__(self, seq: int) -> None:
        self.seq = seq  # global submission order (per-store monotone)
        self._event = threading.Event()
        self._ts: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._t0 = 0  # submit-time perf ns (telemetry on only)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until the write's batch is published; return its commit ts.

        Returns 0 when the batch was a no-op.  Re-raises the worker-side
        exception if the batch failed.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(f"write ticket seq={self.seq} not done")
        if self._error is not None:
            raise self._error
        return self._ts  # type: ignore[return-value]


class _ShardQueue:
    __slots__ = ("items", "cond")

    def __init__(self) -> None:
        self.items: deque = deque()
        self.cond = threading.Condition()


class _Fence:
    """A multi-shard logical write: a barrier entry in every touched queue."""

    __slots__ = ("rw", "ticket", "shards", "lock", "arrived", "done")

    def __init__(self, rw, ticket, shards) -> None:
        self.rw = rw
        self.ticket = ticket
        self.shards = shards
        self.lock = threading.Lock()
        self.arrived = 0
        self.done = threading.Event()


class _PreparedBatch:
    """Output of a worker's prepare phase, awaiting the committer.

    ``net`` is the coalesced :class:`~repro_torch.core.txn.RoutedWrite` — the
    committer logs it to the write-ahead log (one record per batch, one
    fsync per drained run) before publishing.
    """

    __slots__ = ("new_snaps", "tickets", "n_writes", "net")

    def __init__(self, new_snaps, tickets, n_writes, net=None) -> None:
        self.new_snaps = new_snaps
        self.tickets = tickets
        self.n_writes = n_writes
        self.net = net


class PipelineStats:
    """Pipeline-side counters (store-wide counters live in ``store.stats``).

    Backed by locked :mod:`repro_torch.obs.metrics` counters/gauges on the
    store's registry: the old plain ``self.stats.writes += n`` attributes
    were unlocked read-modify-writes hit concurrently by every shard
    worker (and the committer), so counts could be lost under contention.
    Attribute *reads* (``stats.writes`` etc.) are preserved via
    ``__getattr__`` as live counter views, so existing tests and
    benchmarks keep working unchanged.
    """

    _COUNTERS = ("batches", "writes", "fences", "noop_batches", "publish_runs")
    _MAXES = ("max_batch", "max_publish_run")

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None) -> None:
        registry = registry if registry is not None else _metrics.MetricsRegistry()
        # batches: group commits handed to the committer
        # writes: logical writes drained into batches
        # fences: multi-shard writes executed
        # noop_batches: drained runs that netted to nothing
        # publish_runs: committer publish_range calls
        # max_batch / max_publish_run: high watermarks
        self._c = {n: registry.counter("pipeline_" + n) for n in self._COUNTERS}
        self._m = {n: registry.gauge("pipeline_" + n) for n in self._MAXES}

    def add(self, name: str, delta: int = 1) -> None:
        self._c[name].add(delta)

    def note_max(self, name: str, value: int) -> None:
        self._m[name].set_max(value)

    def __getattr__(self, name: str):
        c = self.__dict__["_c"].get(name)
        if c is not None:
            return c.value
        g = self.__dict__["_m"].get(name)
        if g is not None:
            return int(g.value)
        raise AttributeError(name)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"PipelineStats(batches={self.batches}, writes={self.writes}, "
            f"fences={self.fences}, max_batch={self.max_batch}, "
            f"publish_runs={self.publish_runs})"
        )


class WritePipeline:
    """Per-shard writer queues + group-commit scheduler for one store.

    Construct via :meth:`repro_torch.core.store.RapidStore.attach_write_pipeline`
    (mirrors ``attach_shard_plane``); detach with
    ``detach_write_pipeline()``, which flushes and joins the threads.
    """

    def __init__(self, store, n_shards: int = 4, max_batch: int = 1024) -> None:
        if n_shards <= 0:
            raise ValueError(f"need n_shards >= 1, got {n_shards}")
        self.store = store
        self.n_shards = int(n_shards)
        self.max_batch = int(max_batch)
        registry = getattr(store, "registry", None)
        self.stats = PipelineStats(registry)
        self._queues = [_ShardQueue() for _ in range(self.n_shards)]
        if registry is not None:
            # per-shard backlog gauges: the sensing input of the elastic
            # resharding rebalancer (ROADMAP item 3). len(deque) is an
            # atomic read, so the callbacks are safe without the queue lock
            for i, q in enumerate(self._queues):
                registry.gauge(
                    "pipeline_queue_depth",
                    fn=lambda q=q: len(q.items),
                    shard=str(i),
                )
            self._h_visibility = registry.histogram("commit_visibility_seconds")
        else:  # pragma: no cover - store always has a registry
            self._h_visibility = _metrics.Histogram("commit_visibility_seconds")
        # prepared-but-not-yet-linked chain heads; only a sid's owning
        # worker (or a fence executor while the owners are parked) touches
        # its entry, so plain dict ops under the GIL suffice
        self._heads: Dict[int, object] = {}
        self._prepared: deque = deque()
        self._prep_cond = threading.Condition()
        self._enqueue_lock = threading.Lock()  # consistent fence order
        self._seq = 0
        self._pending = 0
        self._pending_cond = threading.Condition()
        self._paused = threading.Event()
        self._stop = False
        self._fatal: Optional[BaseException] = None
        self._threads: List[threading.Thread] = []
        for shard in range(self.n_shards):
            t = threading.Thread(
                target=self._worker, args=(shard,),
                name=f"rapidstore-writer-{shard}", daemon=True,
            )
            self._threads.append(t)
        self._committer = threading.Thread(
            target=self._commit_loop, name="rapidstore-committer", daemon=True
        )
        for t in self._threads:
            t.start()
        self._committer.start()

    # -- submission ---------------------------------------------------------
    def submit(
        self,
        ins: np.ndarray,
        dels: np.ndarray,
        vset: Optional[Dict[int, bool]] = None,
    ) -> WriteTicket:
        """Route + enqueue one logical write; returns its ticket.

        Validation runs here, on the caller thread — out-of-range ids raise
        ``ValueError`` synchronously, exactly like the single-shot path.
        """
        if self._stop:
            raise RuntimeError("write pipeline is detached")
        if self._fatal is not None:
            raise RuntimeError("write pipeline failed") from self._fatal
        tok = _trc.begin()
        rw = _txn.route(self.store, ins, dels, vset)
        with self._enqueue_lock:
            ticket = WriteTicket(self._seq)
            ticket._t0 = tok
            self._seq += 1
            if rw is None:
                ticket._ts = 0
                ticket._event.set()
                return ticket
            with self._pending_cond:
                self._pending += 1
            shards = sorted({sid % self.n_shards for sid in rw.sids})
            if len(shards) == 1:
                q = self._queues[shards[0]]
                with q.cond:
                    q.items.append((rw, ticket))
                    q.cond.notify()
            else:
                fence = _Fence(rw, ticket, shards)
                for s in shards:
                    q = self._queues[s]
                    with q.cond:
                        q.items.append(fence)
                        q.cond.notify()
        _trc.end(tok, "enqueue", cat="write", args={"seq": ticket.seq})
        return ticket

    def flush(self, timeout: Optional[float] = None) -> None:
        """Full barrier: return only when every submitted write is published.

        Covers writes submitted while the flush is in progress too (waits
        for the pending count to reach zero).  Re-raises a pipeline-fatal
        error if one occurred.
        """
        with self._pending_cond:
            if not self._pending_cond.wait_for(
                lambda: self._pending == 0 or self._fatal is not None,
                timeout=timeout,
            ):
                raise TimeoutError(
                    f"flush timed out with {self._pending} writes pending"
                )
        if self._fatal is not None:
            raise RuntimeError("write pipeline failed") from self._fatal

    # -- introspection ------------------------------------------------------
    def queued_bytes(self) -> int:
        """Bytes of logical writes buffered in the pipeline (queues +
        prepared-but-unpublished batches) — charged by
        :meth:`RapidStore.memory_bytes` so a backed-up pipeline shows up in
        the store's accounting instead of hiding in deques."""

        def _rw_bytes(rw) -> int:
            b = rw.ins.nbytes + rw.dels.nbytes
            if rw.vset:
                b += 16 * len(rw.vset)
            return b

        total = 0
        for shard, q in enumerate(self._queues):
            with q.cond:
                for item in q.items:
                    if isinstance(item, _Fence):
                        # a fence sits in every touched queue; charge once
                        if shard == item.shards[0]:
                            total += _rw_bytes(item.rw)
                    else:
                        total += _rw_bytes(item[0])
        with self._prep_cond:
            for pb in self._prepared:
                if pb.net is not None:
                    total += _rw_bytes(pb.net)
        return total

    # -- test hooks ---------------------------------------------------------
    def pause(self) -> None:
        """Stop workers from draining (submissions still enqueue)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()
        for q in self._queues:
            with q.cond:
                q.cond.notify_all()

    # -- compactor integration ----------------------------------------------
    @contextmanager
    def quiesce(self):
        """Block new submissions and drain everything in flight.

        While the context is held, every queue is empty, every prepared
        batch is committed and published, and no worker owns any subgraph —
        the exclusive write access the compactor's repack commits need.
        Submitters block on the enqueue lock (they do not fail) and proceed
        when the context exits.
        """
        with self._enqueue_lock:
            self.flush()
            self.pause()
            try:
                yield self
            finally:
                self.resume()

    def invalidate_heads(self, sids) -> None:
        """Drop pending-head entries for ``sids`` (call under quiesce).

        After the compactor links a repacked snapshot, the pipeline's
        prepared-head cache for that subgraph points at the superseded
        version; the next prepare must build on the chain head instead.
        """
        for sid in sids:
            self._heads.pop(sid, None)

    # -- lifecycle ----------------------------------------------------------
    def stop(self) -> None:
        """Drain everything, then join the worker + committer threads."""
        if not self._stop:
            if self._fatal is None:
                self._paused.clear()
                self.flush()
            self._stop = True
            for q in self._queues:
                with q.cond:
                    q.cond.notify_all()
            with self._prep_cond:
                self._prep_cond.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        self._committer.join(timeout=30)
        registry = getattr(self.store, "registry", None)
        if registry is not None:
            # drop the per-shard depth gauges: a detached pipeline's queues
            # must not linger in the store's exports
            for i in range(self.n_shards):
                registry.unregister("pipeline_queue_depth", shard=str(i))

    # -- worker side --------------------------------------------------------
    def _worker(self, shard: int) -> None:
        q = self._queues[shard]
        while True:
            fence = None
            batch: List = []
            with q.cond:
                while not self._stop and (
                    not q.items or self._paused.is_set()
                ):
                    q.cond.wait(timeout=0.05 if self._paused.is_set() else None)
                if self._stop and not q.items:
                    return
                while q.items and len(batch) < self.max_batch:
                    head = q.items[0]
                    if isinstance(head, _Fence):
                        if not batch:
                            fence = q.items.popleft()
                        break
                    batch.append(q.items.popleft())
            try:
                if fence is not None:
                    self._run_fence(fence)
                elif batch:
                    self._run_batch([rw for rw, _ in batch],
                                    [tk for _, tk in batch])
            except BaseException as exc:  # pragma: no cover - defensive
                self._abort(exc, [fence.ticket] if fence is not None
                            else [tk for _, tk in batch])
                return

    def _run_batch(self, writes, tickets) -> None:
        """Coalesce a drained run, prepare on the pending heads, hand off."""
        tok = _trc.begin()
        net = _txn.coalesce(writes)
        self.stats.add("writes", len(writes))
        self.stats.note_max("max_batch", len(writes))
        if net is None:
            self.stats.add("noop_batches")
            self._complete(tickets, ts=0)
            return
        new_snaps = _txn.prepare(self.store, net, heads=self._heads)
        _trc.end(tok, "prepare", cat="write", args={
            "n_writes": len(writes),
            "seq_first": tickets[0].seq,
            "seq_last": tickets[-1].seq,
        })
        if not new_snaps:
            self.stats.add("noop_batches")
            self._complete(tickets, ts=0)
            return
        self._heads.update(new_snaps)
        self.stats.add("batches")
        with self._prep_cond:
            self._prepared.append(
                _PreparedBatch(new_snaps, tickets, n_writes=len(writes), net=net)
            )
            self._prep_cond.notify()

    def _run_fence(self, fence: _Fence) -> None:
        """Barrier for a multi-shard write: last arriver executes it.

        Every touched shard's worker parks here, so the executor has
        exclusive access to all touched subgraphs; handing the batch off
        BEFORE releasing the parked workers keeps the committer's FIFO
        (and hence each chain's link order) consistent with submission
        order.
        """
        execute = False
        with fence.lock:
            fence.arrived += 1
            if fence.arrived == len(fence.shards):
                execute = True
        if execute:
            self.stats.add("fences")
            self._run_batch([fence.rw], [fence.ticket])
            fence.done.set()
        else:
            while not fence.done.wait(timeout=1.0):
                if self._fatal is not None:
                    return

    # -- committer side -----------------------------------------------------
    def _commit_loop(self) -> None:
        store = self.store
        while True:
            with self._prep_cond:
                while not self._prepared and not self._stop:
                    self._prep_cond.wait()
                if self._stop and not self._prepared:
                    return
                run: List[_PreparedBatch] = list(self._prepared)
                self._prepared.clear()
            try:
                k = len(run)
                tok_run = _trc.begin()
                first = store.clock.reserve(k)
                linked = 0
                try:
                    wal = store.wal
                    tok = _trc.begin()
                    for i, pb in enumerate(run):
                        if wal is not None and pb.net is not None:
                            wal.append_commit(
                                first + i, pb.net.ins, pb.net.dels,
                                pb.net.vset, store.n_vertices,
                            )
                        _txn.link_at(store, first + i, pb.new_snaps,
                                     n_writes=pb.n_writes)
                        linked += 1
                    _trc.end(tok, "link", cat="write", ts=first,
                             args={"ts_first": first, "ts_last": first + k - 1})
                    if wal is not None:
                        # ONE durability barrier per drained run, mirroring
                        # the single publish_range below
                        tok = _trc.begin()
                        wal.sync()
                        _trc.end(tok, "wal_sync", cat="write", ts=first, args={
                            "ts_first": first, "ts_last": first + k - 1,
                        })
                except BaseException:
                    # Renounce the reserved-but-unlinked suffix so later
                    # committers step over it instead of stalling to
                    # ClockStallError; fully-linked prefix batches are
                    # valid commits — publish them so their lineage
                    # records match reader-visible state.
                    if linked < k:
                        store.clock.abandon_range(first + linked,
                                                  first + k - 1)
                    if linked:
                        try:
                            store.clock.publish_range(first,
                                                      first + linked - 1)
                        except BaseException:  # pragma: no cover
                            pass  # don't mask the original failure
                    raise
                tok = _trc.begin()
                store.clock.publish_range(first, first + k - 1)
                _trc.end(tok, "publish", cat="write", ts=first, args={
                    "ts_first": first, "ts_last": first + k - 1,
                })
                store.stats.add("commits", k)
                store.stats.add("group_commits", k)
                store.stats.add(
                    "writes_coalesced", sum(pb.n_writes for pb in run)
                )
                self.stats.add("publish_runs")
                self.stats.note_max("max_publish_run", k)
                if tok_run:
                    # one commit span per batch (so the span count matches
                    # stats["commits"]), each carrying its own timestamp
                    for i, pb in enumerate(run):
                        _trc.end(tok_run, "commit", cat="write", ts=first + i,
                                 args={"n_writes": pb.n_writes})
                for i, pb in enumerate(run):
                    self._complete(pb.tickets, ts=first + i)
                tok = _trc.begin()
                for pb in run:
                    _txn.reclaim(store, pb.new_snaps)
                _trc.end(tok, "reclaim", cat="write", ts=first)
            except BaseException as exc:  # pragma: no cover - defensive
                self._abort(exc, [tk for pb in run for tk in pb.tickets])
                return

    # -- completion ---------------------------------------------------------
    def _complete(self, tickets, ts: int) -> None:
        now = _trc.begin()  # 0 when telemetry is off
        for tk in tickets:
            if now and tk._t0:
                # submit -> publish: the write's visibility latency
                self._h_visibility.observe((now - tk._t0) / 1e9)
            tk._ts = ts
            tk._event.set()
        with self._pending_cond:
            self._pending -= len(tickets)
            self._pending_cond.notify_all()

    def _abort(self, exc: BaseException, tickets) -> None:
        self._fatal = exc
        for tk in tickets:
            tk._error = exc
            tk._event.set()
        with self._pending_cond:
            self._pending -= len(tickets)
            self._pending_cond.notify_all()
