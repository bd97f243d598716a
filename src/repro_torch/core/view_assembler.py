"""Delta-plane view assembly: lineage-linked snapshot views with splicing.

RapidStore decouples version data from graph data so that a commit touching
``d`` of ``S`` subgraphs costs readers O(d).  Before this module, every fresh
:class:`~repro_torch.core.snapshot.SnapshotView` still paid an O(S) *assembly* tax:
``to_coo``/``to_csr``/``to_leaf_blocks`` concatenated all S per-subgraph
cached segments on the host, and the device variants re-concatenated all S
tile sets on the accelerator — even when a single subgraph changed between
two consecutive reads.

The delta plane removes that tax with three cooperating pieces:

1. **Lineage** (:class:`~repro_torch.core.version_chain.CommitLineage`): every
   commit logs ``(ts, dirty subgraph ids)``; a fresh view diffs its timestamp
   against its predecessor's to learn the exact dirty set in O(window).
2. **Assembly state** (:class:`ViewAssembly`): each view owns one bundle
   holding its assembled global arrays *plus per-subgraph segment offsets*.
   When a view is retired (``end_read``), the store keeps a strong reference
   to the single most recent retired bundle; successor views hold only a
   *weak* reference, so chains of views never transitively pin history and
   Python GC reclaims superseded bundles as soon as the store lets go.
3. **Splicing** (this module): a successor view materializes its global
   arrays by taking the predecessor's assembled arrays and replacing only the
   dirty subgraphs' segments — O(d) per-subgraph rebuild + one memmove-style
   pass over the output — instead of touching all S per-subgraph caches.
   The host leaf layout is the *compacted* stream (:func:`host_stream`):
   packed values + ``(leaf_offsets, leaf_lens, leaf_keys)`` sidecars, so the
   splice moves O(dirty-bytes) of live data rather than O(dirty-tiles × B)
   of SENTINEL padding; the padded ``[n, B]`` twin (:func:`host_blocks`) is
   derived from it only on explicit request.
   On device the predecessor's concatenated tensors are reused: equal-sized
   dirty segments are patched into a clone of each predecessor column (never
   in place — older pinned views still read it); resized segments fall back
   to an O(d)-run ``torch.cat``.  Dirty tiles upload per subgraph, host-warm
   snapshots first.

Fallbacks keep the path safe: no predecessor bundle (first read, or GC
reclaimed it mid-chain) and an unknowable lineage window (trimmed log) first
try the compactor's frozen *base* bundle — ``store._base_assembly``, strong-
referenced so it cannot die, with ``base.ts`` at or above the lineage trim
point so its diff window always answers; failing that, and for a dirty
fraction above :func:`max_dirty_frac` (splicing S/2 runs would cost more than
one concat) or ``REPRO_DISABLE_DELTA_SPLICE=1``, they route to the classic
full concatenation — which this module also owns, so the per-subgraph touch
counters in :data:`stats` cover both paths.  ``SnapshotView.to_*_uncached``
remain the independent oracles.

Every function here takes the *view* as its first argument and memoizes on
``view.assembly``; repeat calls are O(1).  Per-subgraph materializer/tile
calls are counted in ``stats.snapshot_touches`` — the observable contract
"a 1-dirty commit re-materializes with touches <= dirty + O(1)" is asserted
by tests and benchmarks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs.trace import TRACER as _trc
from ..obs.trace import traced


# ---------------------------------------------------------------------------
# Stats — the observable O(d) contract
# ---------------------------------------------------------------------------
class AssemblyStats:
    """Counters for delta-plane assembly (process-wide, lock-protected).

    ``snapshot_touches`` counts per-subgraph materializer / device-tile
    calls made during view assembly; a spliced assembly touches exactly the
    dirty subgraphs, a full concat touches all S.  ``reuses`` counts
    assemblies satisfied entirely from the predecessor (empty dirty set).

    Backed by :mod:`repro_torch.obs.metrics` counters (``assembler_<field>`` on
    the process registry) so the values appear in Prometheus exports and
    ``telemetry_report()``; attribute reads are live counter views and
    every increment holds the field's counter lock, so concurrent
    assemblies on different threads never lose counts.
    """

    _FIELDS = (
        "splices",
        "full_concats",
        "reuses",
        "snapshot_touches",
        "spliced_segments",
        "spliced_bytes",
        "prefetch_uploads",
        "base_splices",
        "fallback_no_pred",
        "fallback_lineage",
        "fallback_dirty_frac",
    )

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None) -> None:
        reg = registry if registry is not None else _metrics.REGISTRY
        self._c = {f: reg.counter("assembler_" + f) for f in self._FIELDS}

    def __getattr__(self, name: str) -> int:
        c = self.__dict__["_c"].get(name)
        if c is None:
            raise AttributeError(name)
        return c.value

    def add(self, name: str, delta: int = 1) -> None:
        self._c[name].add(delta)

    def reset(self) -> None:
        for c in self._c.values():
            c.reset()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        body = ", ".join(f"{f}={self._c[f].value}" for f in self._FIELDS)
        return f"AssemblyStats({body})"


stats = AssemblyStats()


# the counters that say which path an assembly took, by the name of the path
_PATHS = {"reuses": "reuse", "splices": "splice", "base_splices": "base_splice",
          "full_concats": "full_concat"}


def _count(**kw: int) -> None:
    for k, v in kw.items():
        stats.add(k, v)
    if _trc.enabled:
        _note_path(kw)


def _note_path(kw) -> None:
    """Name the path on the innermost open ``assemble`` span: the last path
    counter moved, except that a splice or reuse from the base bundle stays
    ``base_splice``."""
    frame = _trc.current()
    if frame is None:
        return
    for k in kw:
        path = _PATHS.get(k)
        if path is not None and not (frame.note == "base_splice"
                                     and path in ("splice", "reuse")):
            frame.note = path


def _traced(kind: str):
    """Record an ``assemble`` span (cat ``read``) around a materializer.

    The span carries the view timestamp, so a read's assembly cost lines
    up with the commit that dirtied it in the Perfetto timeline, and in
    its args the view's ``read`` and the ``path`` it took (``reuse``,
    ``splice``, ``base_splice`` or ``full_concat``: the ``AssemblyStats``
    counter that the call moved; no ``path`` where the view's own bundle
    already held the result and no counter moved).
    """

    def args(_fn, _view, frame):
        return {"kind": kind} if frame.note is None else {"kind": kind, "path": frame.note}

    return traced("assemble", args)


def splice_enabled() -> bool:
    """Delta-splice switch (``REPRO_DISABLE_DELTA_SPLICE`` forces full concat)."""
    return not os.environ.get("REPRO_DISABLE_DELTA_SPLICE")


def max_dirty_frac() -> float:
    """Dirty fraction above which splicing falls back to full concat.

    Splicing assembles O(d) runs; once d approaches S the run bookkeeping
    costs more than one flat concatenation.  Tunable via
    ``REPRO_SPLICE_MAX_DIRTY_FRAC`` (see benchmarks/bench_analytics.py for
    the numbers backing the default).
    """
    return float(os.environ.get("REPRO_SPLICE_MAX_DIRTY_FRAC", "0.25"))


# ---------------------------------------------------------------------------
# Per-view assembly state
# ---------------------------------------------------------------------------
class ViewAssembly:
    """Assembled global arrays of one view + per-subgraph segment offsets.

    One instance per :class:`~repro_torch.core.snapshot.SnapshotView`, created
    lazily on first materialization.  ``coo_offsets`` / ``block_offsets``
    (int64 ``[S+1]``) give each subgraph's contiguous span inside the
    concatenated arrays — the splice map a successor view needs.  All fields
    are filled at most once (views are immutable); host arrays are read-only.
    """

    __slots__ = (
        "ts", "S", "n_vertices", "B",
        "coo_offsets", "block_offsets", "data_offsets",
        "host_coo", "host_stream", "host_blocks", "host_csr",
        "dev_coo", "dev_csr", "dev_blocks",
        "src_order", "src_offsets",
        "sharded",
        "__weakref__",
    )

    def __init__(self, ts: int, S: int, n_vertices: int, B: int) -> None:
        self.ts = ts
        self.S = S
        self.n_vertices = n_vertices
        self.B = B
        self.coo_offsets: Optional[np.ndarray] = None
        self.block_offsets: Optional[np.ndarray] = None
        # per-subgraph spans inside the compacted stream's packed ``data``
        # (block_offsets spans the leaf sidecars) — the dirty-bytes splice map
        self.data_offsets: Optional[np.ndarray] = None
        self.host_coo: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.host_stream = None  # CompactLeafStream — the host blocks layout
        self.host_blocks = None  # LeafBlockView (padded compatibility twin)
        self.host_csr = None  # CSRView
        self.dev_coo: Optional[tuple] = None
        self.dev_csr = None  # DeviceCSRView
        self.dev_blocks = None  # DeviceLeafBlockView
        self.src_order: Optional[np.ndarray] = None
        self.src_offsets: Optional[np.ndarray] = None
        # Shard-plane twin (ShardedViewAssembly): per-shard padded tile
        # bundles the shard plane splices across views — rides in the same
        # retire/weak-predecessor lifecycle as the host/device fields.
        self.sharded = None

    def has_content(self) -> bool:
        return any(
            x is not None
            for x in (
                self.host_coo, self.host_stream, self.host_blocks,
                self.host_csr, self.dev_coo, self.dev_blocks, self.sharded,
            )
        )

    def host_bytes(self) -> int:
        total = 0
        if self.host_coo is not None:
            total += sum(a.nbytes for a in self.host_coo)
        if self.host_stream is not None:
            total += self.host_stream.nbytes()
        if self.host_blocks is not None:
            b = self.host_blocks
            total += b.rows.nbytes
            # a stream-derived padded view shares src/length with the stream
            s = self.host_stream
            if s is None or b.src is not s.leaf_keys:
                total += b.src.nbytes
            if s is None or b.length is not s.leaf_lens:
                total += b.length.nbytes
        if self.host_csr is not None:
            total += self.host_csr.offsets.nbytes
            # direct-spliced CSRs own a standalone indices array; when the
            # COO was assembled the indices ARE its dst column (don't double)
            if self.host_coo is None or self.host_csr.indices is not self.host_coo[1]:
                total += self.host_csr.indices.nbytes
        return total

    def device_bytes(self) -> int:
        total = 0
        if self.dev_coo is not None:
            total += sum(int(a.nbytes) for a in self.dev_coo)
        if self.dev_blocks is not None:
            b = self.dev_blocks
            total += int(b.src.nbytes) + int(b.rows.nbytes) + int(b.length.nbytes)
        if self.dev_csr is not None:
            total += int(self.dev_csr.offsets.nbytes)
            if self.dev_coo is None or self.dev_csr.indices is not self.dev_coo[1]:
                total += int(self.dev_csr.indices.nbytes)
        if self.sharded is not None:
            total += self.sharded.device_bytes()
        return total


def _bundle(view) -> ViewAssembly:
    a = view.assembly
    if a is None:
        a = ViewAssembly(
            ts=view.ts, S=len(view.snaps), n_vertices=view.n_vertices, B=view.B
        )
        view.assembly = a
    return a


# ---------------------------------------------------------------------------
# Splice planning: predecessor bundle + dirty-set diff
# ---------------------------------------------------------------------------
def _plan(view) -> Optional[Tuple[ViewAssembly, List[int]]]:
    """Resolve (predecessor bundle, sorted dirty sids) or None for full path.

    The dirty set is the lineage diff over ``(pred.ts, view.ts]`` (symmetric
    if the retired predecessor is newer than this view), extended with any
    subgraphs appended after the predecessor was assembled.  A dead weakref
    or an unknowable lineage window falls back to the compactor's frozen
    *base* bundle (``view._base``) — a strong reference whose timestamp is
    at or above the lineage trim point by construction, so its window always
    answers — before giving up; a dirty fraction above
    :func:`max_dirty_frac` always routes to the full concat.
    """
    if not splice_enabled():
        return None
    lineage = view._lineage
    ref = view._pred
    pred = ref() if ref is not None else None
    if pred is None:
        diff: Optional[frozenset] = None
        reason = "fallback_no_pred"
    elif pred.ts == view.ts:
        diff = frozenset()
        reason = ""
    else:
        diff = (
            lineage.dirty_between(pred.ts, view.ts) if lineage is not None else None
        )
        reason = "fallback_lineage"
    if diff is None:
        base = view._base
        if (
            base is not None
            and lineage is not None
            and base.ts <= view.ts
        ):
            bdiff = lineage.dirty_between(base.ts, view.ts)
            if bdiff is not None:
                pred, diff = base, bdiff
                _count(base_splices=1)
    if diff is None:
        _count(**{reason: 1})
        return None
    S = len(view.snaps)
    dirty = {s for s in diff if s < S}
    if pred.S < S:  # subgraphs appended since pred: no pred segment to reuse
        dirty |= set(range(pred.S, S))
    if len(dirty) > max(1, int(max_dirty_frac() * S)):
        _count(fallback_dirty_frac=1)
        return None
    return pred, sorted(dirty)


def _segment_offsets(counts: Sequence[int]) -> np.ndarray:
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets


def _spliced_counts(
    pred_offsets: np.ndarray, segs: Dict[int, tuple], S: int
) -> np.ndarray:
    """New per-subgraph segment lengths: predecessor's, dirty ones replaced."""
    pred_counts = np.diff(pred_offsets)
    counts = np.zeros(S, np.int64)
    k = min(S, len(pred_counts))
    counts[:k] = pred_counts[:k]
    for sid, seg in segs.items():
        counts[sid] = seg[0].shape[0]
    return counts


def _splice_runs(pred_cols, pred_offsets, segs, S, concat):
    """Assemble output columns from clean runs of ``pred_cols`` + dirty segs.

    ``pred_cols`` share the segmentation ``pred_offsets``; ``segs`` maps
    dirty sid -> per-column fresh segment.  Consecutive clean subgraphs
    collapse into a single slice of the predecessor array, so the part list
    has at most ``2*len(segs) + 1`` entries — the O(d) splice.
    """
    dirty = sorted(segs)
    parts: List[list] = [[] for _ in pred_cols]
    cursor = 0
    for sid in dirty + [S]:
        if cursor < sid:  # clean run [cursor, sid)
            lo, hi = int(pred_offsets[cursor]), int(pred_offsets[sid])
            if hi > lo:
                for i, col in enumerate(pred_cols):
                    parts[i].append(col[lo:hi])
        if sid == S:
            break
        seg = segs[sid]
        if seg[0].shape[0]:
            for i in range(len(pred_cols)):
                parts[i].append(seg[i])
        cursor = sid + 1
    out = []
    for i, col in enumerate(pred_cols):
        if not parts[i]:
            chosen = col[:0]
        elif len(parts[i]) == 1:
            chosen = parts[i][0]
        else:
            chosen = concat(parts[i])
        if isinstance(chosen, np.ndarray) and chosen.base is not None:
            # a single-run result would otherwise be a VIEW of the
            # predecessor's column: the retained bundle would silently pin
            # the predecessor's full arrays while host_bytes() reports only
            # the slice — copy so bundles own exactly what they account for
            chosen = chosen.copy()
        out.append(chosen)
    return tuple(out)


def _splice_host_cols(pred_cols, pred_offsets, segs, S):
    """Host splice: memmove-style copy+patch when every dirty segment keeps
    its predecessor's length (one contiguous pass + d in-place patches),
    O(d)-run concatenation otherwise."""
    counts = _spliced_counts(pred_offsets, segs, S)
    pred_counts = np.diff(pred_offsets)
    if len(pred_counts) == S and np.array_equal(counts, pred_counts):
        out = []
        for i, col in enumerate(pred_cols):
            patched = col.copy()
            for sid, seg in segs.items():
                patched[pred_offsets[sid] : pred_offsets[sid + 1]] = seg[i]
            out.append(patched)
        return tuple(out), _segment_offsets(counts)
    out = _splice_runs(pred_cols, pred_offsets, segs, S, np.concatenate)
    return out, _segment_offsets(counts)


def _freeze(arrays) -> None:
    for a in arrays:
        if isinstance(a, np.ndarray) and a.flags.owndata:
            a.setflags(write=False)


# ---------------------------------------------------------------------------
# Host COO
# ---------------------------------------------------------------------------
@_traced("host_coo")
def host_coo(view) -> Tuple[np.ndarray, np.ndarray]:
    """Global (src, dst) in (u, v) order — spliced from the predecessor when
    the lineage diff allows, full per-subgraph concat otherwise."""
    a = _bundle(view)
    if a.host_coo is not None:
        return a.host_coo
    plan = _plan(view)
    if plan is not None and plan[0].host_coo is not None \
            and plan[0].coo_offsets is not None:
        pred, dirty = plan
        if not dirty and pred.S == a.S:
            # publish offsets before the guarded column field: a successor
            # splicing from this bundle mid-fill must see both or neither
            a.coo_offsets = pred.coo_offsets
            a.host_coo = pred.host_coo
            _count(reuses=1)
            return a.host_coo
        segs = {}
        for sid in dirty:
            _count(snapshot_touches=1)
            segs[sid] = view.snaps[sid].to_coo_global()
        out, a.coo_offsets = _splice_host_cols(
            pred.host_coo, pred.coo_offsets, segs, a.S
        )
        _freeze(out)
        a.host_coo = out
        _count(splices=1, spliced_segments=len(dirty))
        return a.host_coo
    # full concat
    segs = []
    for s in view.snaps:
        _count(snapshot_touches=1)
        segs.append(s.to_coo_global())
    if not segs:
        src = np.empty(0, np.int64)
        dst = np.empty(0, np.int32)
    else:
        src = np.concatenate([p[0] for p in segs])
        dst = np.concatenate([p[1] for p in segs])
    _freeze((src, dst))
    a.coo_offsets = _segment_offsets([len(p[0]) for p in segs])
    a.host_coo = (src, dst)
    _count(full_concats=1)
    return a.host_coo


def _patched_degrees(view, pred, dirty, seg_src: Dict[int, np.ndarray]) -> np.ndarray:
    """Predecessor degrees with dirty vertex ranges recomputed — the
    cross-snapshot CSR delta for the offsets array (O(V + dirty segments)
    instead of an O(E) bincount)."""
    degs = np.diff(pred.host_csr.offsets).astype(np.int64)
    n, p = view.n_vertices, view.p
    for sid in dirty:
        lo_v, hi_v = sid * p, min((sid + 1) * p, n)
        degs[lo_v:hi_v] = np.bincount(
            (seg_src[sid] - lo_v).astype(np.int64), minlength=hi_v - lo_v
        )
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(degs, out=offsets[1:])
    return offsets


@_traced("host_csr")
def host_csr(view):
    """Global CSR via the cross-snapshot delta.

    CSR ``indices`` are exactly the concatenated per-subgraph dst streams
    (per-subgraph COO is (u sorted, v sorted) and subgraphs are id-ordered),
    so when the view's COO is not already assembled the indices are spliced
    *directly* from the predecessor's CSR — the int64 src column is never
    materialized — and ``offsets`` are patched from the predecessor's
    degrees over the dirty vertex ranges.  Falls back to the COO-derived
    build (bincount) when no predecessor CSR is available.
    """
    from .snapshot import CSRView

    a = _bundle(view)
    if a.host_csr is not None:
        return a.host_csr
    n = view.n_vertices
    plan = _plan(view)
    pred = plan[0] if plan is not None else None
    csr_deltable = (
        plan is not None
        and pred.host_csr is not None
        and pred.coo_offsets is not None
        and pred.n_vertices == n
    )
    if csr_deltable and not plan[1] and pred.S == a.S:
        a.host_csr = pred.host_csr
        if a.coo_offsets is None:
            a.coo_offsets = pred.coo_offsets
        _count(reuses=1)
        return a.host_csr
    if csr_deltable and a.host_coo is None:
        # direct CSR splice: only the dirty subgraphs' (src, dst) are built
        dirty = plan[1]
        dst_segs: Dict[int, tuple] = {}
        src_segs: Dict[int, np.ndarray] = {}
        for sid in dirty:
            _count(snapshot_touches=1)
            s_src, s_dst = view.snaps[sid].to_coo_global()
            dst_segs[sid] = (s_dst,)
            src_segs[sid] = s_src
        (indices,), seg_offsets = _splice_host_cols(
            (pred.host_csr.indices,), pred.coo_offsets, dst_segs, a.S
        )
        offsets = _patched_degrees(view, pred, dirty, src_segs)
        _freeze((indices, offsets))
        if a.coo_offsets is None:
            a.coo_offsets = seg_offsets
        a.host_csr = CSRView(offsets, indices)
        _count(splices=1, spliced_segments=len(dirty))
        return a.host_csr
    # COO-derived build (the COO was wanted anyway, or no predecessor CSR)
    src, dst = host_coo(view)  # fills a.coo_offsets
    if csr_deltable and a.coo_offsets is not None:
        dirty = plan[1]
        seg_src = {
            sid: src[a.coo_offsets[sid] : a.coo_offsets[sid + 1]] for sid in dirty
        }
        offsets = _patched_degrees(view, pred, dirty, seg_src)
        _count(splices=1, spliced_segments=len(dirty))
    else:
        degs = np.bincount(src, minlength=n)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(degs, out=offsets[1:])
    offsets.setflags(write=False)
    a.host_csr = CSRView(offsets, dst)
    return a.host_csr


# ---------------------------------------------------------------------------
# Host leaf tiles: the compacted stream (primary) + padded compatibility twin
# ---------------------------------------------------------------------------
def _host_stream_segs(view, dirty) -> Dict[int, tuple]:
    """Fetch the dirty subgraphs' compacted streams, freshness-audited.

    Each fetch is counted as a snapshot touch; after materialization the
    snapshot's pool-row generation stamp is re-verified — a recycled
    :class:`~repro_torch.core.leaf_pool.LeafPool` row under a live snapshot means
    the spliced span would be stale, so we refuse (mirrors the device-tile
    check in :func:`_device_segs`).
    """
    segs: Dict[int, tuple] = {}
    for sid in dirty:
        snap = view.snaps[sid]
        _count(snapshot_touches=1)
        segs[sid] = snap.to_leaf_stream_global()
        if not snap.stream_fresh():
            raise RuntimeError(
                f"subgraph {sid} host stream went stale during splice "
                "(pool-row generation advanced under a live snapshot)"
            )
    return segs


@_traced("host_stream")
def host_stream(view):
    """Global compacted leaf-tile stream — the host blocks materialization.

    Spliced from the predecessor's packed arrays in O(dirty-bytes): the
    ``(leaf_keys, leaf_lens)`` sidecars splice over the per-subgraph *leaf*
    segmentation (``block_offsets``) and the packed ``data`` column over the
    per-subgraph *value* segmentation (``data_offsets``) — copy+patch when
    every dirty subgraph's span keeps its size, O(d)-run concat otherwise.
    ``leaf_offsets`` is an integer cumsum of the spliced lens (no B-wide
    memcpy anywhere).  Falls back to a full per-subgraph concat exactly
    like the other layout families.
    """
    from .snapshot import CompactLeafStream

    a = _bundle(view)
    if a.host_stream is not None:
        return a.host_stream
    plan = _plan(view)
    if plan is not None and plan[0].host_stream is not None \
            and plan[0].block_offsets is not None \
            and plan[0].data_offsets is not None:
        pred, dirty = plan
        if not dirty and pred.S == a.S:
            a.block_offsets = pred.block_offsets
            a.data_offsets = pred.data_offsets
            a.src_order = pred.src_order  # argsort carries over unchanged
            if pred.n_vertices == a.n_vertices:
                a.src_offsets = pred.src_offsets
            a.host_stream = pred.host_stream
            _count(reuses=1)
            return a.host_stream
        segs = _host_stream_segs(view, dirty)
        ps = pred.host_stream
        # (keys, lens, tiers) share the per-leaf segmentation
        side_segs = {s: (t[3], t[2], t[4]) for s, t in segs.items()}
        data_segs = {s: (t[0],) for s, t in segs.items()}
        (keys, lens, tiers), a.block_offsets = _splice_host_cols(
            (ps.leaf_keys, ps.leaf_lens, ps.leaf_tiers),
            pred.block_offsets,
            side_segs,
            a.S,
        )
        (data,), a.data_offsets = _splice_host_cols(
            (ps.data,), pred.data_offsets, data_segs, a.S
        )
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        _freeze((data, offsets, lens, keys, tiers))
        a.host_stream = CompactLeafStream(data, offsets, lens, keys, tiers)
        _count(
            splices=1,
            spliced_segments=len(dirty),
            spliced_bytes=sum(t[0].nbytes for t in segs.values()),
        )
        return a.host_stream
    segs_l = []
    for s in view.snaps:
        _count(snapshot_touches=1)
        segs_l.append(s.to_leaf_stream_global())
    if not segs_l:
        data = np.zeros(0, np.int32)
        lens = np.zeros(0, np.int32)
        keys = np.zeros(0, np.int32)
        tiers = np.zeros(0, np.int32)
    else:
        data = np.concatenate([t[0] for t in segs_l])
        lens = np.concatenate([t[2] for t in segs_l])
        keys = np.concatenate([t[3] for t in segs_l])
        tiers = np.concatenate([t[4] for t in segs_l])
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    _freeze((data, offsets, lens, keys, tiers))
    a.block_offsets = _segment_offsets([len(t[2]) for t in segs_l])
    a.data_offsets = _segment_offsets([len(t[0]) for t in segs_l])
    a.host_stream = CompactLeafStream(data, offsets, lens, keys, tiers)
    _count(full_concats=1)
    return a.host_stream


@_traced("host_blocks")
def host_blocks(view):
    """Global padded leaf-tile stream — the fixed-B compatibility layout.

    Always assembled *via the compacted stream*: the stream supplies the
    splice map and the dirty data, so per-subgraph snapshots are touched
    once (by :func:`host_stream`) no matter how many layouts a view
    materializes.  With a padded predecessor the dirty subgraphs' spans are
    re-padded and spliced into its arrays (O(dirty) tile work); without one
    the whole padded view derives from the stream in a single pass.
    """
    from .snapshot import LeafBlockView
    from .subgraph import pad_leaf_stream

    a = _bundle(view)
    if a.host_blocks is not None:
        return a.host_blocks
    stream = host_stream(view)  # fills block_offsets / data_offsets
    plan = _plan(view)
    if plan is not None and plan[0].host_blocks is not None \
            and plan[0].block_offsets is not None:
        pred, dirty = plan
        if not dirty and pred.S == a.S:
            a.host_blocks = pred.host_blocks
            _count(reuses=1)
            return a.host_blocks
        # dirty padded segments re-padded from the view's OWN spliced
        # stream spans — zero additional snapshot touches
        segs = {}
        for sid in dirty:
            lo_b = int(a.block_offsets[sid])
            hi_b = int(a.block_offsets[sid + 1])
            lo_d = int(stream.leaf_offsets[lo_b])
            hi_d = int(stream.leaf_offsets[hi_b])
            lens = stream.leaf_lens[lo_b:hi_b]
            rows = pad_leaf_stream(
                stream.data[lo_d:hi_d],
                stream.leaf_offsets[lo_b : hi_b + 1] - lo_d,
                lens,
                view.B,
            )
            segs[sid] = (stream.leaf_keys[lo_b:hi_b], rows, lens)
        pb = pred.host_blocks
        out, _ = _splice_host_cols(
            (pb.src, pb.rows, pb.length), pred.block_offsets, segs, a.S
        )
        _freeze(out)
        a.host_blocks = LeafBlockView(*out)
        _count(splices=1, spliced_segments=len(dirty))
        return a.host_blocks
    lb = stream.to_padded(view.B)
    _freeze((lb.src, lb.rows, lb.length))
    a.host_blocks = lb
    return a.host_blocks


def block_src_index(view) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 src, stable argsort of src) for the view's leaf tiles, both
    memoized so repeated batched edge searches are O(1) — no per-call
    widening copy, no O(n_leaves log n_leaves) re-sort.  Reads the
    compacted stream's ``leaf_keys`` natively (no padded materialization)."""
    a = _bundle(view)
    if a.src_order is None:
        src = host_stream(view).leaf_keys.astype(np.int64)
        order = np.argsort(src, kind="stable")
        src.setflags(write=False)
        order.setflags(write=False)
        a.src_order = (src, order)
    return a.src_order


def block_src_offsets(view) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int64 [n_vertices + 1], order): the leaf tiles of vertex u
    are ``order[offsets[u]:offsets[u + 1]]``, ``order`` being
    :func:`block_src_index`'s stable argsort.  Memoized, so a batched edge
    search finds each query's candidate tiles with two gathers."""
    a = _bundle(view)
    src, order = block_src_index(view)
    if a.src_offsets is None:
        counts = np.bincount(src, minlength=view.n_vertices)
        offsets = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        offsets.setflags(write=False)
        a.src_offsets = offsets
    return a.src_offsets, order


# ---------------------------------------------------------------------------
# Device assembly: splice on the device
# ---------------------------------------------------------------------------
def _device_segs(view, dirty, tiles_fn) -> Dict[int, tuple]:
    """Fetch the dirty subgraphs' device tiles on ``view.device``.

    Host-warm snapshots (memoized host arrays) go first.  Each spliced
    region's pool-row generation stamp is verified after upload.
    """
    from . import device_cache

    order = sorted(dirty, key=lambda s: not view.snaps[s].has_host_cache())
    segs: Dict[int, tuple] = {}
    for sid in order:
        snap = view.snaps[sid]
        _count(snapshot_touches=1, prefetch_uploads=1)
        segs[sid] = tiles_fn(snap, view.device)
        if not device_cache.tiles_fresh(snap):
            raise RuntimeError(
                f"subgraph {sid} device tiles went stale during splice "
                "(pool-row generation advanced under a live snapshot)"
            )
    return segs


def _owned(t):
    """A tensor that owns its storage: a slice of the predecessor's column
    would pin the whole predecessor while ``device_bytes`` counts the
    slice."""
    return t.clone() if t._base is not None else t


def _splice_device(pred_cols, pred_offsets, segs, S):
    """Device-side splice of the predecessor's concatenated tensors.

    Equal-sized dirty segments are patched into a *clone* of each
    predecessor column — never in place: older pinned views still read the
    predecessor's tensors.  Any resize falls back to an O(d)-run
    ``torch.cat``.  Returns ``(columns, offsets)``.
    """
    counts = _spliced_counts(pred_offsets, segs, S)
    pred_counts = np.diff(pred_offsets)
    same_shape = len(pred_counts) == S and np.array_equal(counts, pred_counts)
    if same_shape:
        outs = []
        for i, col in enumerate(pred_cols):
            live = [sid for sid in sorted(segs) if segs[sid][i].shape[0]]
            if not live:
                outs.append(col)
                continue
            base = col.clone()
            for sid in live:
                seg = segs[sid][i]
                lo = int(pred_offsets[sid])
                base[lo : lo + seg.shape[0]] = seg
            outs.append(base)
        return tuple(outs), _segment_offsets(counts)
    out = _splice_runs(pred_cols, pred_offsets, segs, S, torch.cat)
    return tuple(_owned(c) for c in out), _segment_offsets(counts)


def _device_blocks_tiered(view, a):
    """Per-tier global device tiles for multi-tier pools.

    Concatenates each tier's per-snapshot groups (per-snapshot uploads stay
    memoized, so only dirty snapshots transfer) and rebases the per-snapshot
    ``gidx`` maps into global leaf positions.  The predecessor *device*
    splice stays single-tier-only — multi-tier views rebuild the O(S)
    concat from the pinned per-snapshot groups instead; a clean predecessor
    (empty dirty set) is still reused wholesale by the caller.
    """
    from . import device_cache

    parts = []
    for s in view.snaps:
        _count(snapshot_touches=1)
        parts.append(device_cache.leaf_block_tiles(s, view.device))
    nb = [p.n_blocks for p in parts]
    base = np.cumsum([0] + nb)
    groups = {}
    gidx = {}
    for t in sorted({t for p in parts for t in p.groups}):
        cols = [p.groups[t] for p in parts if t in p.groups]
        groups[t] = tuple(torch.cat([c[i] for c in cols]) for i in range(3))
        gidx[t] = np.concatenate(
            [p.gidx[t] + base[i] for i, p in enumerate(parts) if t in p.groups]
        )
    a.block_offsets = _segment_offsets(nb)
    a.dev_blocks = device_cache.DeviceTieredBlocks(
        groups=groups, gidx=gidx, n_blocks=int(base[-1]), B=view.B
    )
    _count(full_concats=1)
    return a.dev_blocks


@_traced("device_blocks")
def device_blocks(view):
    """Device-resident global leaf-tile stream (delta-spliced when possible).

    Tiered pools route to :func:`_device_blocks_tiered` (per-tier groups);
    single-tier pools keep the unified splice path below.
    """
    from . import device_cache

    a = _bundle(view)
    if a.dev_blocks is not None:
        return a.dev_blocks

    if view.snaps and len(view.snaps[0].pool.tiers) > 1:
        plan = _plan(view)
        if plan is not None and plan[0].dev_blocks is not None \
                and plan[0].block_offsets is not None \
                and not plan[1] and plan[0].S == a.S:
            a.block_offsets = plan[0].block_offsets
            a.dev_blocks = plan[0].dev_blocks
            _count(reuses=1)
            return a.dev_blocks
        return _device_blocks_tiered(view, a)

    plan = _plan(view)
    if plan is not None and plan[0].dev_blocks is not None \
            and plan[0].block_offsets is not None:
        pred, dirty = plan
        if not dirty and pred.S == a.S:
            a.block_offsets = pred.block_offsets
            a.dev_blocks = pred.dev_blocks
            _count(reuses=1)
            return a.dev_blocks
        segs = _device_segs(view, dirty, device_cache.leaf_block_tiles)
        pb = pred.dev_blocks
        cols, offsets = _splice_device(
            (pb.src, pb.rows, pb.length), pred.block_offsets, segs, a.S
        )
        a.block_offsets = offsets
        a.dev_blocks = device_cache.DeviceLeafBlockView(*cols)
        _count(splices=1, spliced_segments=len(dirty))
        return a.dev_blocks
    # full concat
    segs_l = []
    for s in view.snaps:
        _count(snapshot_touches=1)
        segs_l.append(device_cache.leaf_block_tiles(s, view.device))
    if not segs_l:
        z = np.zeros(0, np.int32)
        cols = device_cache._device_put(
            (z, np.zeros((0, view.B), np.int32), z), view.device
        )
    else:
        cols = tuple(torch.cat([p[i] for p in segs_l]) for i in range(3))
    a.block_offsets = _segment_offsets([int(p[0].shape[0]) for p in segs_l])
    a.dev_blocks = device_cache.DeviceLeafBlockView(*cols)
    _count(full_concats=1)
    return a.dev_blocks


@_traced("device_coo")
def device_coo(view) -> tuple:
    """Device-resident global int32 (src, dst) COO (delta-spliced when
    possible)."""
    from . import device_cache

    a = _bundle(view)
    if a.dev_coo is not None:
        return a.dev_coo

    plan = _plan(view)
    if plan is not None and plan[0].dev_coo is not None \
            and plan[0].coo_offsets is not None:
        pred, dirty = plan
        if not dirty and pred.S == a.S:
            a.coo_offsets = pred.coo_offsets
            a.dev_coo = pred.dev_coo
            _count(reuses=1)
            return a.dev_coo
        segs = _device_segs(view, dirty, device_cache.coo_tiles)
        cols, offsets = _splice_device(pred.dev_coo, pred.coo_offsets, segs, a.S)
        a.coo_offsets = offsets
        a.dev_coo = cols
        _count(splices=1, spliced_segments=len(dirty))
        return a.dev_coo
    segs_l = []
    for s in view.snaps:
        _count(snapshot_touches=1)
        segs_l.append(device_cache.coo_tiles(s, view.device))
    if not segs_l:
        z = np.zeros(0, np.int32)
        cols = device_cache._device_put((z, z), view.device)
    else:
        cols = tuple(torch.cat([p[i] for p in segs_l]) for i in range(2))
    a.coo_offsets = _segment_offsets([int(p[0].shape[0]) for p in segs_l])
    a.dev_coo = cols
    _count(full_concats=1)
    return a.dev_coo


@_traced("device_csr")
def device_csr(view):
    """Device CSR over the (spliced) device COO; offsets computed on device,
    so no per-subgraph work beyond :func:`device_coo`'s."""
    from . import device_cache

    a = _bundle(view)
    if a.dev_csr is not None:
        return a.dev_csr
    src, dst = device_coo(view)
    a.dev_csr = device_cache.DeviceCSRView(
        device_cache.csr_offsets(src, view.n_vertices), dst
    )
    return a.dev_csr


__all__ = [
    "AssemblyStats",
    "ViewAssembly",
    "block_src_index",
    "block_src_offsets",
    "device_blocks",
    "device_coo",
    "device_csr",
    "host_blocks",
    "host_coo",
    "host_csr",
    "host_stream",
    "max_dirty_frac",
    "splice_enabled",
    "stats",
]
