"""Read-query snapshot views (paper §5.2.2).

A :class:`SnapshotView` is the reader workspace: one resolved subgraph
snapshot pointer per subgraph, pinned at the reader's start timestamp.  All
read operations (Search/Scan/degree) route through it with zero version
checks — the decoupling the paper's design buys.

Materializers produce device-ready layouts:

- ``to_coo`` / ``to_csr`` — global COO/CSR arrays for jitted analytics;
- ``to_leaf_stream`` — the compacted variable-width leaf-tile stream: one
  packed ``data`` array plus ``(leaf_offsets, leaf_lens, leaf_keys)``
  sidecars, no SENTINEL padding.  This is the *host* leaf format: what the
  per-subgraph snapshots cache, what the delta plane splices in
  O(dirty-bytes), and what crosses the host->device boundary;
- ``to_leaf_blocks`` — the padded ``[n_blocks, B]`` compatibility view,
  re-padded from the stream on demand.  The CUDA scan/intersect/spmm
  kernels consume fixed-B tiles, but those are reconstructed *device-side*
  after the packed upload (:mod:`repro_torch.core.device_cache`) — host memory
  only pays for padding when a caller explicitly asks for this layout.

Cache lifecycle — the three-layer memo + delta plane
----------------------------------------------------

Materialization is memoized at three layers, each exploiting snapshot
immutability:

1. **Per-subgraph host** (:meth:`SubgraphSnapshot.to_coo_global` /
   ``to_leaf_stream_global``): each immutable snapshot computes its own
   vectorized COO / compacted leaf-stream arrays once (global src ids baked
   in) and caches them for every view that resolves it.  A write produces a
   *new* snapshot object only for the subgraphs it touches, so only dirty
   subgraphs ever rebuild.  The caches are dropped in
   :meth:`SubgraphSnapshot.release` — GC recycles the version's pool rows,
   so invalidation there is a correctness requirement, not just a leak fix —
   and are charged to :meth:`RapidStore.memory_bytes`.  Each stream cache
   carries a pool-row *generation stamp* (``stream_fresh``), the host twin
   of the device-tile stamp, so a recycled row serving a stale span is
   detectable.
2. **Per-subgraph device** (:mod:`repro_torch.core.device_cache`): each
   snapshot's arrays are uploaded once and pinned on the store's device as
   torch tensors; a warm repeat performs zero host->device transfers.
3. **Per-view delta plane** (:mod:`repro_torch.core.view_assembler`): the
   assembled *global* arrays.  Each view owns a
   :class:`~repro_torch.core.view_assembler.ViewAssembly` bundle recording the
   assembled columns plus per-subgraph segment offsets.  ``begin_read``
   links a fresh view to the most recently retired view's bundle (weakly —
   GC still reclaims superseded bundles) together with the commit-lineage
   handle; materialization then *splices* only the dirty subgraphs'
   segments into the predecessor's arrays — O(d) rebuild + memmove-style
   patch on host, a patched clone / O(d)-run concat on
   device with async per-subgraph upload prefetch — instead of the O(S)
   concatenation a predecessor-less view pays.  Repeat calls on one view
   are O(1).

All cached arrays are read-only; callers needing scratch space must copy.
``to_coo_uncached`` / ``to_leaf_blocks_uncached`` keep the original
per-vertex-loop path alive as the oracle for tests and benchmarks — they
never touch any cache layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..kernels.runtime import indexed
from .subgraph import SubgraphSnapshot


@dataclass(frozen=True)
class CSRView:
    offsets: np.ndarray  # int64 [n_vertices + 1]
    indices: np.ndarray  # int32 [n_edges]

    @property
    def n_vertices(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.offsets[u] : self.offsets[u + 1]]


@dataclass(frozen=True)
class LeafBlockView:
    """Padded leaf-tile stream: the fixed-B scan format.

    ``rows[i]`` holds up to B sorted neighbor ids of vertex ``src[i]``,
    padded with SENTINEL; ``length[i]`` is the live count.  High-degree
    vertices contribute one entry per C-ART leaf; low-degree vertices'
    clustered-index segments are chunked to the same width, so the whole
    graph scan is a single dense [n, B] pass.

    This is a *compatibility/kernel-input* layout: the host of record is
    the compacted :class:`CompactLeafStream`; these padded tiles are
    re-derived from it on demand (host) or device-side after upload.
    """

    src: np.ndarray  # int32 [n_blocks]
    rows: np.ndarray  # int32 [n_blocks, B]
    length: np.ndarray  # int32 [n_blocks]
    # per-leaf native tier width (tiered pools); None when the producer
    # didn't track tiers — rows are always padded to one common width
    tiers: Optional[np.ndarray] = None


@dataclass(frozen=True)
class CompactLeafStream:
    """Compacted variable-width leaf-tile stream: the host leaf format.

    ``data`` packs every leaf's live neighbor ids back to back (no SENTINEL
    padding); leaf ``i`` spans ``data[leaf_offsets[i] : leaf_offsets[i+1]]``,
    holds ``leaf_lens[i]`` sorted values, and belongs to source vertex
    ``leaf_keys[i]``.  Leaf order is identical to the padded layout
    (:class:`LeafBlockView`), so re-padding reproduces it bitwise.

    Host-only consumers (scan/search fallbacks, baselines, edge search
    candidate gathers) read this stream natively; the fixed-B tile shape
    the CUDA kernels need is reconstructed device-side after the packed
    upload (:mod:`repro_torch.core.device_cache`) or via :meth:`to_padded` /
    :meth:`gather_padded` on host.
    """

    data: np.ndarray  # int32 [total_values]
    leaf_offsets: np.ndarray  # int64 [n_leaves + 1]
    leaf_lens: np.ndarray  # int32 [n_leaves]
    leaf_keys: np.ndarray  # int32 [n_leaves] — source vertex per leaf
    leaf_tiers: np.ndarray  # int32 [n_leaves] — native leaf width (tier) per leaf

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_lens)

    @property
    def n_values(self) -> int:
        return int(self.leaf_offsets[-1]) if len(self.leaf_offsets) else 0

    def leaf_values(self, i: int) -> np.ndarray:
        """Leaf ``i``'s live values — zero-copy slice of the packed data."""
        return self.data[self.leaf_offsets[i] : self.leaf_offsets[i + 1]]

    def nbytes(self) -> int:
        return (
            self.data.nbytes
            + self.leaf_offsets.nbytes
            + self.leaf_lens.nbytes
            + self.leaf_keys.nbytes
            + self.leaf_tiers.nbytes
        )

    def gather_padded(self, idx: np.ndarray, B: int) -> np.ndarray:
        """Padded ``[len(idx), B]`` tiles of the selected leaves only.

        The host fallbacks pad just the leaves a query touches instead of
        materializing the full padded stream.  Gathers the selected leaves
        into a small packed sub-stream, then delegates the padding to the
        one canonical scatter (:func:`repro_torch.core.subgraph.pad_leaf_stream`).
        Out-of-range indices clamp to the valid range, mirroring the jnp
        gather semantics of the device-resident tile path — both legs
        behave identically on boundary input.
        """
        from .subgraph import pad_leaf_stream

        idx = np.asarray(idx, np.int64)
        if self.n_leaves:
            idx = np.clip(idx, 0, self.n_leaves - 1)
            lens32 = self.leaf_lens[idx]
        else:
            lens32 = np.zeros(len(idx), np.int32)
        lens = lens32.astype(np.int64)
        offsets = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        if total:
            # pos: each gathered value's offset within its own leaf
            pos = np.arange(total, dtype=np.int64) - np.repeat(offsets[:-1], lens)
            flat = np.repeat(self.leaf_offsets[idx].astype(np.int64), lens) + pos
            data = self.data[flat]
        else:
            data = np.empty(0, np.int32)
        return pad_leaf_stream(data, offsets, lens32, B)

    def to_padded(self, B: int) -> LeafBlockView:
        """The full padded twin (``LeafBlockView``), rebuilt in one pass."""
        from .subgraph import pad_leaf_stream

        return LeafBlockView(
            self.leaf_keys,
            pad_leaf_stream(self.data, self.leaf_offsets, self.leaf_lens, B),
            self.leaf_lens,
            tiers=self.leaf_tiers,
        )


class SnapshotView:
    """Reader workspace over resolved per-subgraph snapshots.

    ``pred`` is a weak reference to the predecessor view's
    :class:`~repro_torch.core.view_assembler.ViewAssembly` (the most recently
    retired view, handed over by :meth:`RapidStore.begin_read`) and
    ``lineage`` the store's commit log — together they let materializers
    splice instead of concatenate.  ``B`` is the store's configured leaf
    width, so even a subgraph-less view emits block shapes matching the
    device path's padding.  ``device`` is the ``torch.device`` the view's
    device materializations (``to_*_device``) live on: the store's.  It is
    required, so that no view lands on the host unless a caller asks.
    ``plane`` is the store's :class:`~repro_torch.core.shard_plane.ShardPlane`
    when one is attached: the view's collective analytics route through it.
    ``read_id`` is the id :meth:`RapidStore.begin_read` gave the read that
    pinned the view (0 where none did): the spans of its queries and
    assemblies carry it as ``read``.
    """

    __slots__ = (
        "ts", "p", "snaps", "n_vertices", "B", "assembly", "_pred", "_lineage",
        "_plane", "_base", "device", "read_id",
    )

    def __init__(
        self,
        ts: int,
        p: int,
        snaps: Tuple[SubgraphSnapshot, ...],
        n_vertices: int,
        B: Optional[int] = None,
        pred=None,
        lineage=None,
        plane=None,
        base=None,
        *,
        device,
        read_id: int = 0,
    ):
        self.ts = ts
        self.p = p
        self.snaps = snaps
        self.n_vertices = n_vertices
        self.B = int(B) if B is not None else (snaps[0].pool.B if snaps else 8)
        self.assembly = None  # ViewAssembly, created lazily on materialization
        self._pred = pred  # weakref to the predecessor view's ViewAssembly
        self._lineage = lineage  # CommitLineage for the dirty-set diff
        self._plane = plane  # ShardPlane routing collective analytics, or None
        self._base = base  # STRONG ref to the compactor's frozen base bundle
        self.device = indexed(device)
        self.read_id = read_id  # the store's id of the read that pinned it (0: none)

    # -- point reads ------------------------------------------------------------
    def _local(self, u: int) -> Tuple[SubgraphSnapshot, int]:
        return self.snaps[u // self.p], u % self.p

    def search(self, u: int, v: int) -> bool:
        s, lu = self._local(u)
        return s.search(lu, int(v))

    def scan(self, u: int) -> np.ndarray:
        s, lu = self._local(u)
        return s.scan(lu)

    def degree(self, u: int) -> int:
        s, lu = self._local(u)
        return s.degree(lu)

    def degrees(self) -> np.ndarray:
        out = np.concatenate([s.degrees() for s in self.snaps])
        return out[: self.n_vertices]

    @property
    def n_edges(self) -> int:
        return sum(s.n_edges for s in self.snaps)

    # -- materialization -----------------------------------------------------------
    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Global (src, dst) in (u, v) order — delta-plane assembled.

        Spliced from the predecessor view's cached arrays when the lineage
        diff allows (O(dirty) segment rebuild + one output pass); full
        per-subgraph concat otherwise.  See :mod:`repro_torch.core.view_assembler`.
        """
        from . import view_assembler

        return view_assembler.host_coo(self)

    def to_coo_uncached(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full-rebuild reference path (per-vertex loops; the seed oracle)."""
        srcs, dsts = [], []
        for s in self.snaps:
            lu, vs = s.to_coo_uncached()
            srcs.append(lu + s.sid * self.p)
            dsts.append(vs)
        src = np.concatenate(srcs).astype(np.int64)
        dst = np.concatenate(dsts).astype(np.int32)
        return src, dst

    def to_csr(self) -> CSRView:
        """Global CSR — cross-snapshot delta: offsets are patched from the
        predecessor's degrees over dirty vertex ranges when splicing."""
        from . import view_assembler

        return view_assembler.host_csr(self)

    def to_leaf_stream(self) -> CompactLeafStream:
        """Global compacted leaf-tile stream — delta-plane assembled.

        The primary host blocks materialization: packed ``data`` +
        ``(leaf_offsets, leaf_lens, leaf_keys)`` sidecars, spliced from the
        predecessor view in O(dirty-bytes) (copy+patch when every dirty
        subgraph's packed span keeps its size, O(d)-run concat otherwise).
        """
        from . import view_assembler

        return view_assembler.host_stream(self)

    def to_leaf_stream_uncached(self) -> CompactLeafStream:
        """Full-rebuild packed-stream oracle (derived from the per-vertex
        loop padded oracle — never touches any cache layer)."""
        ob = self.to_leaf_blocks_uncached()
        B = ob.rows.shape[1] if ob.rows.ndim == 2 else self.B
        lens = ob.length.astype(np.int64)
        mask = np.arange(B)[None, :] < lens[:, None]
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        tiers = (
            ob.tiers
            if ob.tiers is not None
            else np.full(len(lens), B, np.int32)
        )
        return CompactLeafStream(
            ob.rows[mask], offsets, ob.length, ob.src, tiers.astype(np.int32)
        )

    def to_leaf_blocks(self) -> LeafBlockView:
        """Global padded leaf-tile stream (compatibility layout).

        Assembled via the compacted stream: dirty subgraphs are spliced
        into the predecessor's padded arrays when one exists, otherwise the
        whole padded view is re-derived from :meth:`to_leaf_stream`.
        Prefer the stream for host-side work — this layout re-inflates the
        SENTINEL padding the compacted host format eliminates.
        """
        from . import view_assembler

        return view_assembler.host_blocks(self)

    def to_leaf_blocks_uncached(self) -> LeafBlockView:
        """Full-rebuild reference path for the leaf-tile stream (oracle).

        Tier-aware: each clustered-index vertex chunks at its degree's tier
        width and each C-ART leaf reads at its directory's tier, but every
        row is padded out to the view's max width ``self.B`` so the result
        is one dense matrix (the tier per leaf rides in ``tiers``).
        """
        from .leaf_pool import SENTINEL

        srcs, rows, lens, tiers = [], [], [], []
        Bmax = self.B
        for s in self.snaps:
            base = s.sid * self.p
            for lu in range(s.p):
                if lu in s.dirs:
                    continue
                seg = s.scan(lu)
                if len(seg) == 0:
                    continue
                w = int(s.pool.tier_for_degree(len(seg)))
                for o in range(0, len(seg), w):
                    chunk = seg[o : o + w]
                    padded = np.full(Bmax, SENTINEL, np.int32)
                    padded[: len(chunk)] = chunk
                    srcs.append(base + lu)
                    rows.append(padded)
                    lens.append(len(chunk))
                    tiers.append(w)
            for lu, d in sorted(s.dirs.items()):
                lp = s.pool.pool_for(d.tier)
                data = lp.data[d.leaf_ids]  # [n_leaves, tier]
                ln = lp.length[d.leaf_ids]
                keep = ln > 0
                for r, n in zip(data[keep], ln[keep]):
                    padded = np.full(Bmax, SENTINEL, np.int32)
                    padded[: d.tier] = r
                    srcs.append(base + lu)
                    rows.append(padded)
                    lens.append(int(n))
                    tiers.append(d.tier)
        if not rows:
            B = self.B
            return LeafBlockView(
                np.zeros(0, np.int32),
                np.zeros((0, B), np.int32),
                np.zeros(0, np.int32),
                tiers=np.zeros(0, np.int32),
            )
        return LeafBlockView(
            np.asarray(srcs, np.int32),
            np.stack(rows).astype(np.int32),
            np.asarray(lens, np.int32),
            tiers=np.asarray(tiers, np.int32),
        )

    # -- device materialization ---------------------------------------------------
    def to_coo_device(self):
        """Global (src, dst) as int32 tensors on ``self.device``.

        Delta-plane assembled: the predecessor view's concatenated device
        arrays are reused and only dirty subgraphs' tiles are spliced in
        (async-prefetched uploads); a predecessor-less view pays one O(S)
        device concat.  A warm repeat moves zero bytes host->device.
        """
        from . import view_assembler

        return view_assembler.device_coo(self)

    def to_csr_device(self):
        """Device CSR built from the (spliced) device COO (see ``to_csr``)."""
        from . import view_assembler

        return view_assembler.device_csr(self)

    def to_leaf_blocks_device(self):
        """Device-resident leaf-tile stream feeding the CUDA kernels.

        Same layout as :meth:`to_leaf_blocks` but the tiles never leave the
        accelerator once uploaded; repeat kernel calls on an unchanged view
        re-use the pinned arrays directly, and a post-write view splices
        only the dirty subgraphs' tiles on device.
        """
        from . import view_assembler

        return view_assembler.device_blocks(self)

    # -- verification ------------------------------------------------------------
    def edge_set(self) -> set:
        """Python set of (u, v) — oracle comparisons in tests."""
        src, dst = self.to_coo()
        return set(zip(src.tolist(), dst.tolist()))
