"""Write transactions as an explicit four-phase protocol (paper §5.2-5.3).

The write path is split into phases that compose two ways: the classic
single-shot :func:`execute_write` (one logical write = one commit), and the
decoupled group-commit pipeline (:mod:`repro_torch.core.write_pipeline`), which
runs the same phases over a *batch* of queued logical writes and overlaps
the prepare of batch N+1 with the commit/reclaim of batch N.

Phases
------
``route``
    Validation + subgraph-id partitioning.  Pure: touches no store state
    beyond reading ``n_vertices``/``p``; produces a :class:`RoutedWrite`
    (net edit arrays + the sorted touched-sid set).  Runs on the caller
    thread so bad input raises synchronously even for async submission.
``prepare``
    Copy-on-write snapshot construction, one new (unstamped, ts=-1)
    snapshot per touched subgraph.  Requires exclusive write access to the
    touched subgraphs — either the store's per-subgraph locks (single-shot
    path) or pipeline shard ownership — but touches no global state: no
    clock, no lineage, no stats.  May build on explicit ``heads`` (the
    pipeline's prepared-but-not-yet-linked snapshots) instead of the chain
    heads, which is what makes commit pipelining possible.
``commit``
    The only globally-ordered phase: draw a commit timestamp (``t_w``
    increment), stamp + link the snapshots, record the
    :class:`~repro_torch.core.version_chain.CommitLineage` entry (BEFORE
    publishing — once ``t_r >= t`` any reader may diff a window containing
    ``t``), publish ``t_r`` in commit order, bump stats.  ``link_at`` is
    the lock-release point for the pipeline: after it returns, chain heads
    reflect the batch and ownership may pass on even though publish (and
    the next batch's commit) is still in flight.
``reclaim``
    Writer-driven GC of the touched chains against the reader tracer.

Locking (single-shot): the per-subgraph locks are acquired in ascending
subgraph-id order (deadlock freedom) around prepare+commit, exactly the
MV2PL protocol of the paper.  The pipeline replaces locks with disjoint
shard ownership; see ``write_pipeline`` for that contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..obs.trace import TRACER as _trc

_EMPTY = np.empty((0, 2), np.int64)


@dataclass
class RoutedWrite:
    """A validated logical write, partitioned by subgraph id.

    ``ins``/``dels`` are ``[m, 2]`` int64 global-id edge arrays; ``vset``
    maps global vertex id -> active flag; ``sids`` is the ascending list of
    touched subgraph ids.
    """

    ins: np.ndarray
    dels: np.ndarray
    vset: Optional[Dict[int, bool]]
    sids: List[int] = field(default_factory=list)

    @property
    def n_edits(self) -> int:
        return len(self.ins) + len(self.dels) + (len(self.vset) if self.vset else 0)


def route(
    store,
    ins: np.ndarray,
    dels: np.ndarray,
    vset: Optional[Dict[int, bool]] = None,
    validate: bool = True,
) -> Optional[RoutedWrite]:
    """Phase 1: validate ids and partition the write set by subgraph.

    Returns ``None`` for an empty write (nothing to do).  Raises
    ``ValueError`` on out-of-range vertex ids (a negative id would
    floor-divide into a wrong — or negative — subgraph id and silently
    corrupt routing, so it is rejected up front).
    """
    ins = np.asarray(ins, np.int64).reshape(-1, 2)
    dels = np.asarray(dels, np.int64).reshape(-1, 2)
    p = store.p

    if validate:
        for arr in (ins, dels):
            if len(arr):
                hi = int(arr.max())
                if hi >= store.n_vertices:
                    raise ValueError(
                        f"vertex id {hi} out of range [0, {store.n_vertices})"
                    )
                lo = int(arr.min())
                if lo < 0:
                    raise ValueError(
                        f"vertex id {lo} out of range [0, {store.n_vertices})"
                    )

    sids = set((ins[:, 0] // p).tolist()) | set((dels[:, 0] // p).tolist())
    if vset:
        sids |= {u // p for u in vset}
    sids = sorted(int(s) for s in sids)
    if not sids:
        return None
    return RoutedWrite(ins=ins, dels=dels, vset=vset or None, sids=sids)


def coalesce(writes: Iterable[RoutedWrite]) -> Optional[RoutedWrite]:
    """Fold an ordered run of routed writes into one net routed write.

    Sequential semantics by construction: per edge the LAST op wins (an
    edge inserted then deleted nets to a delete — a no-op if it was never
    present — and vice versa), per vertex the last active flag wins.  The
    net write therefore produces exactly the state serial application
    would, while needing ONE copy-on-write snapshot per touched subgraph
    for the whole run — the group-commit amortization.  Vectorized (one
    ``np.unique`` over ``(u << 32) | v`` keys, the ``from_edges`` dedup
    trick) so large drained runs do not serialize on per-edge Python.
    """
    chunks: List[np.ndarray] = []
    ops: List[np.ndarray] = []
    vset: Dict[int, bool] = {}
    sids: set = set()
    for w in writes:
        if len(w.ins):
            chunks.append(w.ins)
            ops.append(np.ones(len(w.ins), bool))
        if len(w.dels):
            chunks.append(w.dels)
            ops.append(np.zeros(len(w.dels), bool))
        if w.vset:
            vset.update(w.vset)
        sids.update(w.sids)
    if not chunks and not vset:
        return None
    if chunks:
        arr = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        op = np.concatenate(ops) if len(ops) > 1 else ops[0]
        key = (arr[:, 0] << 32) | arr[:, 1]
        # first occurrence in the reversed stream = last op in the original
        _, first_rev = np.unique(key[::-1], return_index=True)
        sel = np.sort(len(key) - 1 - first_rev)
        arr, op = arr[sel], op[sel]
        ins, dels = arr[op], arr[~op]
    else:
        ins = dels = _EMPTY
    return RoutedWrite(ins=ins, dels=dels, vset=vset or None, sids=sorted(sids))


def prepare(
    store,
    rw: RoutedWrite,
    heads: Optional[Dict[int, object]] = None,
) -> Dict[int, object]:
    """Phase 2: copy-on-write snapshot build, one per touched subgraph.

    Caller must hold exclusive write access to every sid in ``rw.sids``.
    ``heads`` optionally overrides the base snapshot per sid — the
    pipeline passes its prepared-but-unlinked heads here so batch N+1 can
    be prepared while batch N's commit is still in flight.  Returns the
    (possibly empty) ``{sid: new snapshot}`` dict; snapshots are unstamped
    (``ts == -1``) until :func:`link_at`.
    """
    p = store.p
    ins, dels = rw.ins, rw.dels
    new_snaps: Dict[int, object] = {}
    for sid in rw.sids:
        m_ins = ins[:, 0] // p == sid
        m_del = dels[:, 0] // p == sid
        local_vset = None
        if rw.vset:
            local_vset = {
                u % p: flag for u, flag in rw.vset.items() if u // p == sid
            }
        base = heads.get(sid) if heads else None
        if base is None:
            base = store.chains[sid].head
        snap = base.apply_updates(
            ins_u=ins[m_ins, 0] % p,
            ins_v=ins[m_ins, 1],
            del_u=dels[m_del, 0] % p,
            del_v=dels[m_del, 1],
            vset_active=local_vset,
        )
        if snap is not None:
            new_snaps[sid] = snap
    return new_snaps


def link_at(store, t: int, new_snaps: Dict[int, object], n_writes: int = 1) -> None:
    """Commit sub-step: stamp + link the snapshots and record lineage at ``t``.

    Lineage BEFORE publish: once ``t_r >= t`` any reader may diff a window
    containing ``t``, so the (ts, dirty sids) record must already be
    queryable (delta-plane splice, see core.view_assembler).  A group
    commit passes ``n_writes > 1`` — the number of logical writes
    coalesced into this one record — which readers see as an ordinary
    lineage entry.
    """
    for sid, snap in new_snaps.items():
        snap.ts = t
        store.chains[sid].link(snap)
    store.lineage.record(t, new_snaps.keys(), n_writes=n_writes)


def commit(
    store,
    new_snaps: Dict[int, object],
    n_writes: int = 1,
    ts: Optional[int] = None,
    rw: Optional[RoutedWrite] = None,
) -> int:
    """Phase 3: timestamp + WAL + link + lineage + publish.

    ``ts`` may be pre-reserved (``clock.reserve``) by a batching committer;
    otherwise one is drawn here.  When the store has a write-ahead log
    attached and ``rw`` (the net routed write) is provided, the commit is
    made durable — appended and fsync'd — BEFORE it is published, so any
    reader-visible commit survives a crash.  A failure between drawing the
    timestamp and publishing abandons it (``clock.abandon``) so later
    committers never stall against the gap.  Returns the commit timestamp.
    """
    tok_commit = _trc.begin()
    t = ts if ts is not None else store.clock.next_commit_timestamp()
    try:
        wal = store.wal
        if wal is not None and rw is not None:
            tok = _trc.begin()
            wal.append_commit(t, rw.ins, rw.dels, rw.vset, store.n_vertices)
            wal.sync()
            _trc.end(tok, "wal_sync", cat="write", ts=t)
        tok = _trc.begin()
        link_at(store, t, new_snaps, n_writes=n_writes)
        _trc.end(tok, "link", cat="write", ts=t)
    except BaseException:
        if ts is None:  # we drew it; a reserving caller owns its own range
            store.clock.abandon(t)
        raise
    tok = _trc.begin()
    store.clock.publish(t)
    _trc.end(tok, "publish", cat="write", ts=t)
    store.stats.add("commits", 1)
    _trc.end(tok_commit, "commit", cat="write", ts=t)
    return t


def reclaim(store, sids: Iterable[int]) -> int:
    """Phase 4: writer-driven GC of the touched chains (paper §5.3)."""
    active = store.tracer.active_timestamps()
    reclaimed = 0
    for sid in sids:
        reclaimed += store.chains[sid].collect(active)
    if reclaimed:
        store.stats.add("versions_reclaimed", reclaimed)
    return reclaimed


def execute_write(
    store,
    ins: np.ndarray,
    dels: np.ndarray,
    vset: Optional[Dict[int, bool]] = None,
) -> int:
    """Run one single-shot write transaction: route -> lock -> prepare ->
    commit -> reclaim -> unlock (a group commit of a batch of one).

    Returns the commit timestamp (> 0) when a version was created, or 0
    when every edit was a no-op (no version linked, clock untouched).
    """
    tok = _trc.begin()
    rw = route(store, ins, dels, vset)
    _trc.end(tok, "route", cat="write")
    if rw is None:
        return 0

    # MV2PL: lock in ascending subgraph-id order (deadlock freedom)
    for sid in rw.sids:
        store.locks[sid].acquire()
    try:
        tok = _trc.begin()
        new_snaps = prepare(store, rw)
        _trc.end(tok, "prepare", cat="write", args={"n_writes": 1})
        if not new_snaps:
            return 0
        t = commit(store, new_snaps, rw=rw)
        tok = _trc.begin()
        reclaim(store, new_snaps)
        _trc.end(tok, "reclaim", cat="write", ts=t)
        return t
    finally:
        for sid in reversed(rw.sids):
            store.locks[sid].release()
