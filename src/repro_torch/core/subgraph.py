"""Subgraph snapshots (paper §5.1, §6.1).

A subgraph ``S`` owns the contiguous vertex block ``[sid*|P|, (sid+1)*|P|)``
and every out-edge of those vertices.  A *snapshot* is one immutable version:

- vertex index: per-local-vertex active flag / storage kind,
- clustered index: packed low-degree neighbor sets (paper §6.3),
- C-ART directories: per high-degree vertex (paper §6.2), leaves pooled.

``apply_updates`` is the copy-on-write path (paper Fig. 5): it returns a new
snapshot sharing every untouched leaf row / directory with its predecessor and
never mutates published state — concurrent readers are unaffected.

Reference ownership: every snapshot version owns one pool reference per leaf
row reachable from its directories.  ``apply_updates`` settles the accounting
(new rows are born owned; shared rows gain a reference); ``release`` drops a
reclaimed version's references wholesale (writer-driven GC, paper §5.3/6.4).

Caches a snapshot holds, each filled at most once and all dropped by
``release``: on the host the COO arrays and the compacted leaf stream (with
the pool-generation stamp taken when it was built); on the store's device
the leaf tiles and the COO tensors (:mod:`repro_torch.core.device_cache`,
with their own stamp); and, while a shard plane is attached, the per-shard
tiles keyed by ``(kind, shard index)`` (:mod:`repro_torch.core.shard_plane`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from . import cart, clustered_index as cidx
from .cart import CartDir
from .clustered_index import ClusteredIndex
from .leaf_pool import SENTINEL, LeafPool


class _SubgraphStats:
    """Process-wide CI<->C-ART transition counters.

    Promotion/demotion rebuilds are the expensive storage-kind flips; the
    thrash regression tests counter-assert that the hysteresis band (promote
    above ``high_threshold``, demote below half of it) bounds them under
    degree churn around the boundary.
    """

    __slots__ = ("promotions", "demotions")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.promotions = 0
        self.demotions = 0


stats = _SubgraphStats()


def pad_leaf_stream(
    data: np.ndarray, offsets: np.ndarray, lens: np.ndarray, B: int
) -> np.ndarray:
    """Re-pad a compacted leaf stream to the fixed-B ``[n_leaves, B]`` tiles.

    The inverse of packing: leaf ``i``'s ``lens[i]`` values land in
    ``rows[i, :lens[i]]`` and the tail is SENTINEL — bitwise identical to
    the historical padded host layout (pool rows are SENTINEL-filled past
    their live count).  One vectorized scatter; used by the host
    ``to_leaf_blocks`` compatibility paths (the device twin re-pads after
    the packed upload, see :mod:`repro_torch.core.device_cache`).
    """
    n = len(lens)
    rows = np.full((n, B), SENTINEL, np.int32)
    if len(data):
        lens64 = lens.astype(np.int64)
        pos = np.arange(len(data), dtype=np.int64) - np.repeat(
            offsets[:-1].astype(np.int64), lens64
        )
        rows[np.repeat(np.arange(n, dtype=np.int64), lens64), pos] = data
    return rows


@dataclass
class SubgraphSnapshot:
    sid: int
    ts: int  # commit timestamp (version); stamped by the committing writer
    p: int  # |P|
    pool: LeafPool
    active: np.ndarray  # bool [P] — vertex flag bit (paper §6.5)
    ci: ClusteredIndex
    dirs: Dict[int, CartDir] = field(default_factory=dict)  # local_u -> C-ART
    high_threshold: int = 256
    # Memoized materializations. A snapshot is immutable once published, so
    # each cache is computed at most once and shared by every view resolving
    # this version; a write produces a *new* snapshot object (cold caches)
    # for the touched subgraph only.  Cleared by ``release()`` — pool rows
    # are recycled after GC, so a surviving cache would go stale.
    _coo_cache: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, init=False, repr=False, compare=False
    )
    # Compacted leaf-tile stream (data, leaf_offsets, leaf_lens, leaf_keys,
    # leaf_tiers): the ONLY host leaf materialization cached per snapshot.
    # No SENTINEL padding — padded [n, B_t] tiles are derived on demand
    # (device-side per tier group after upload, or host-side at the max tier
    # width for the to_leaf_blocks compatibility path).
    _blocks_cache: Optional[
        Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    ] = field(default=None, init=False, repr=False, compare=False)
    # (leaf row ids, pool generations) captured when the host stream was
    # materialized — the host twin of the device-tile generation stamp (see
    # core.device_cache): a live snapshot's refcounts pin its rows, so an
    # advanced generation under a live stream cache is a stale-data bug.
    _host_gen_stamp: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, init=False, repr=False, compare=False
    )
    # Device-resident twins of the host caches (torch tensors on the store's
    # device, uploaded once per snapshot by core.device_cache) plus the
    # pool-row generation stamp taken at upload time.  Same lifecycle:
    # dropped in ``release()``, which drops the last reference the cache
    # holds, so the caching allocator reclaims the memory.
    _dev_blocks_cache: Optional[tuple] = field(
        default=None, init=False, repr=False, compare=False
    )
    _dev_coo_cache: Optional[tuple] = field(
        default=None, init=False, repr=False, compare=False
    )
    _dev_gen_stamp: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, init=False, repr=False, compare=False
    )
    # Shard-plane residency: {("coo"|"blocks", shard index) -> tile tensors}
    # pinned on the device of the shard the placement assigned this
    # subgraph to (repro_torch.core.shard_plane).  Keyed by the shard's
    # slot, not its device: several shards may share one card.  Same
    # lifecycle as the default-device caches.
    _shard_dev_cache: Optional[Dict] = field(
        default=None, init=False, repr=False, compare=False
    )
    # Set by ``release()``: the pool may recycle this version's rows, so any
    # further materialization would read unrelated data — refuse instead.
    _released: bool = field(default=False, init=False, repr=False, compare=False)

    # -- degree / kind ---------------------------------------------------------
    def degree(self, lu: int) -> int:
        d = self.dirs.get(lu)
        if d is not None:
            return cart.degree(self.pool, d)
        return cidx.degree(self.ci, lu)

    def degrees(self) -> np.ndarray:
        out = cidx.degrees(self.ci).astype(np.int64)
        for lu, d in self.dirs.items():
            out[lu] = cart.degree(self.pool, d)
        return out

    @property
    def n_edges(self) -> int:
        n = self.ci.n_edges
        for d in self.dirs.values():
            n += cart.degree(self.pool, d)
        return n

    # -- reads -----------------------------------------------------------------
    def search(self, lu: int, v: int) -> bool:
        d = self.dirs.get(lu)
        if d is not None:
            return cart.search(self.pool, d, v)
        return cidx.search(self.ci, lu, v)

    def scan(self, lu: int) -> np.ndarray:
        d = self.dirs.get(lu)
        if d is not None:
            return cart.scan(self.pool, d)
        return cidx.neighbors(self.ci, lu)

    # -- copy-on-write update ----------------------------------------------------
    def apply_updates(
        self,
        ins_u: np.ndarray,
        ins_v: np.ndarray,
        del_u: np.ndarray,
        del_v: np.ndarray,
        vset_active: Optional[Dict[int, bool]] = None,
    ) -> Optional["SubgraphSnapshot"]:
        """Return a new (ts=-1, unstamped) snapshot with the edits applied.

        ``*_u`` are LOCAL vertex ids. Returns None when every edit is a no-op
        (no version is linked — writers skip empty commits per subgraph).
        Handles CI <-> C-ART promotion/demotion around ``high_threshold``.
        """
        ins_u = np.asarray(ins_u, np.int64)
        ins_v = np.asarray(ins_v, np.int32)
        del_u = np.asarray(del_u, np.int64)
        del_v = np.asarray(del_v, np.int32)

        new_dirs = dict(self.dirs)
        changed = False

        # --- C-ART-resident vertices: route their edits to the tree -----------
        dir_keys = np.fromiter(self.dirs.keys(), np.int64, len(self.dirs))
        cart_ins = np.isin(ins_u, dir_keys) if len(dir_keys) else np.zeros(len(ins_u), bool)
        cart_del = np.isin(del_u, dir_keys) if len(dir_keys) else np.zeros(len(del_u), bool)
        for lu in np.unique(ins_u[cart_ins]):
            d0 = new_dirs[int(lu)]
            d1 = cart.insert_many(self.pool, d0, ins_v[ins_u == lu])
            if d1 is not d0:
                new_dirs[int(lu)] = d1
                changed = True
        for lu in np.unique(del_u[cart_del]):
            base = new_dirs[int(lu)]
            d1 = cart.delete_many(self.pool, base, del_v[del_u == lu])
            if d1 is not base:
                orig = self.dirs.get(int(lu))
                if base is not orig:
                    # `base` was built earlier in this txn (insert+delete on
                    # the same vertex): discard rows only it references —
                    # keep rows carried forward into d1 or owned by `orig`.
                    keep = np.union1d(orig.leaf_ids, d1.leaf_ids)
                    drop = np.setdiff1d(base.leaf_ids, keep)
                    if len(drop):
                        # orig/base/d1 share one tier (in-place edits never
                        # migrate), so the set algebra stays subpool-local
                        self.pool.pool_for(d1.tier).decref_many(drop)
                new_dirs[int(lu)] = d1
                changed = True

        # --- CI-resident vertices ---------------------------------------------
        ci_ins_u, ci_ins_v = ins_u[~cart_ins], ins_v[~cart_ins]
        ci_del_u, ci_del_v = del_u[~cart_del], del_v[~cart_del]
        new_ci = self.ci
        if len(ci_ins_u) or len(ci_del_u):
            cand = cidx.apply_edits(self.ci, ci_ins_u, ci_ins_v, ci_del_u, ci_del_v)
            if np.array_equal(cand.values, self.ci.values) and np.array_equal(
                cand.offsets, self.ci.offsets
            ):
                new_ci = self.ci  # all edits were no-ops
            else:
                new_ci = cand
                changed = True

        # --- promotion: CI vertex crossed the high-degree threshold ------------
        if new_ci is not self.ci and len(ci_ins_u):
            for lu in np.unique(ci_ins_u):
                lu = int(lu)
                if lu in new_dirs:
                    continue
                if cidx.degree(new_ci, lu) > self.high_threshold:
                    vs = cidx.neighbors(new_ci, lu)
                    new_dirs[lu] = cart.build(self.pool, vs)
                    new_ci = cidx.extract(new_ci, lu)
                    stats.promotions += 1
                    changed = True

        # --- demotion: C-ART vertex fell below half the threshold --------------
        if len(del_u):
            for lu in np.unique(del_u):
                lu = int(lu)
                d = new_dirs.get(lu)
                if d is None:
                    continue
                deg = cart.degree(self.pool, d)
                if deg < self.high_threshold // 2:
                    vs = cart.scan(self.pool, d)
                    base = self.dirs.get(lu)
                    if base is not None and d is not base:
                        cart.free_exclusive(self.pool, d, base)
                    elif base is None:
                        cart.free(self.pool, d)  # born this txn via promotion
                    del new_dirs[lu]
                    new_ci = cidx.inject(new_ci, lu, vs)
                    stats.demotions += 1
                    changed = True

        new_active = self.active
        if vset_active:
            new_active = self.active.copy()
            for lu, flag in vset_active.items():
                if new_active[lu] != flag:
                    new_active[lu] = flag
                    changed = True

        if not changed:
            return None

        snap = SubgraphSnapshot(
            sid=self.sid,
            ts=-1,
            p=self.p,
            pool=self.pool,
            active=new_active,
            ci=new_ci,
            dirs=new_dirs,
            high_threshold=self.high_threshold,
        )
        # Settle reference ownership for the new version: shared rows gain a
        # reference; brand-new rows were born owned (refcount 1).
        for lu, d1 in new_dirs.items():
            d0 = self.dirs.get(lu)
            if d0 is None:
                continue  # promotion: all rows new
            if d1 is d0:
                cart.incref(self.pool, d1)  # directory shared wholesale
            else:
                cart.incref_shared(self.pool, d1, d0)
        return snap

    def release(self) -> None:
        """Drop this version's leaf references (GC of a reclaimed version).

        Also drops the materialization caches — host AND device: once the
        references are gone the pool recycles the rows, so a cache outliving
        ``release`` would alias rewritten memory — invalidation here is a
        correctness matter.  The snapshot is marked released and refuses any
        later materialization (see core.device_cache lifecycle contract).
        """
        from . import device_cache

        device_cache.note_release(self)
        for d in self.dirs.values():
            cart.free(self.pool, d)
        self.dirs = {}
        self._coo_cache = None
        self._blocks_cache = None
        self._host_gen_stamp = None
        self._dev_blocks_cache = None
        self._dev_coo_cache = None
        self._dev_gen_stamp = None
        self._shard_dev_cache = None
        self._released = True

    # -- materialization ----------------------------------------------------------
    def _check_not_released(self) -> None:
        if self._released:
            raise RuntimeError(
                f"subgraph {self.sid} snapshot ts={self.ts} was released: its "
                "pool rows may have been recycled, materialization would "
                "serve stale tiles"
            )

    def _dir_leaf_ids(self, dir_lus: np.ndarray):
        """(leaves_per_dir, pool row ids, leaf tiers) in (lu, leaf) order —
        the one definition of C-ART leaf ordering every materializer (COO,
        compacted stream, padded blocks) shares.  Row ids are local to their
        leaf's tier subpool; ``all_tiers[i]`` names that subpool's width."""
        ds = [self.dirs[int(lu)] for lu in dir_lus]
        leaves_per = np.array([d.n_leaves for d in ds], np.int64)
        all_ids = np.concatenate([d.leaf_ids for d in ds])
        all_tiers = np.concatenate(
            [np.full(d.n_leaves, d.tier, np.int64) for d in ds]
        )
        return leaves_per, all_ids, all_tiers

    def _dir_gather_packed(self, all_ids: np.ndarray, all_tiers: np.ndarray):
        """Packed ``(values, lens)`` for C-ART leaves in (lu, leaf) order.

        Routes each leaf to its tier's subpool, gathers per tier, and
        scatters the packed runs back into global leaf order — so the
        emitted stream is identical to a single-pool ``gather_packed`` when
        only one tier is populated.  All output arrays are fresh copies.
        """
        tiers = self.pool.tiers
        if len(tiers) == 1:
            return self.pool.pool_for(tiers[0]).gather_packed(all_ids)
        n = len(all_ids)
        lens = np.zeros(n, np.int64)
        parts = []
        for t in tiers:
            m = all_tiers == t
            if not m.any():
                continue
            d, l = self.pool.pool_for(int(t)).gather_packed(all_ids[m])
            parts.append((m, d, l))
            lens[m] = l
        offsets = np.cumsum(lens) - lens  # global start of each leaf's run
        data = np.empty(int(lens.sum()), np.int32)
        for m, d, l in parts:
            if not len(d):
                continue
            local_off = np.cumsum(l) - l
            pos = np.arange(len(d), dtype=np.int64) - np.repeat(local_off, l)
            data[np.repeat(offsets[m], l) + pos] = d
        return data, lens

    def to_coo_global(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) in (u, v) order with GLOBAL src ids — memoized.

        Computed once per snapshot (vectorized — no per-vertex Python loop)
        and cached with the ``sid * p`` base already applied, so assembling a
        global view is pure concatenation.  The returned arrays are read-only
        and shared between callers.
        """
        cached = self._coo_cache
        if cached is None:
            self._check_not_released()
            cached = self._materialize_coo()
            for a in cached:
                a.setflags(write=False)
            self._coo_cache = cached
        return cached

    def _materialize_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        p = self.p
        base = self.sid * p
        ci_lu = np.repeat(
            np.arange(p, dtype=np.int64), np.diff(self.ci.offsets).astype(np.int64)
        )
        ci_v = self.ci.values.astype(np.int32, copy=True)
        if not self.dirs:
            return ci_lu + base, ci_v
        dir_lus = np.fromiter(sorted(self.dirs), np.int64, len(self.dirs))
        leaves_per, all_ids, all_tiers = self._dir_leaf_ids(dir_lus)
        # packed live leaf contents in (lu, leaf) order — stays sorted per lu
        dir_v, lens = self._dir_gather_packed(all_ids, all_tiers)
        lens = lens.astype(np.int64)
        starts = np.cumsum(leaves_per) - leaves_per
        deg_per_dir = np.add.reduceat(lens, starts)
        dir_lu = np.repeat(dir_lus, deg_per_dir)
        # merge the two lu-sorted streams; a vertex lives in exactly one, so a
        # stable sort on lu alone preserves each vertex's sorted neighbor run
        lu_all = np.concatenate([ci_lu, dir_lu])
        v_all = np.concatenate([ci_v, dir_v])
        order = np.argsort(lu_all, kind="stable")
        return lu_all[order] + base, v_all[order]

    def to_coo_uncached(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-vertex-loop reference materializer (oracle for the cache)."""
        p = self.p
        if not self.dirs:
            lu = np.repeat(np.arange(p, dtype=np.int64), np.diff(self.ci.offsets))
            return lu, self.ci.values.copy()
        srcs, dsts = [], []
        for lu in range(p):
            d = self.dirs.get(lu)
            vs = cart.scan(self.pool, d) if d is not None else cidx.neighbors(self.ci, lu)
            if len(vs):
                srcs.append(np.full(len(vs), lu, np.int64))
                dsts.append(vs)
        if not srcs:
            return np.empty(0, np.int64), np.empty(0, np.int32)
        return np.concatenate(srcs), np.concatenate(dsts).astype(np.int32)

    def to_leaf_stream_global(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Memoized compacted leaf-tile stream, GLOBAL src ids.

        Returns ``(data, leaf_offsets, leaf_lens, leaf_keys, leaf_tiers)``:
        ``data`` is the packed concatenation of every leaf's live values (no
        SENTINEL padding), leaf ``i`` spanning ``data[leaf_offsets[i] :
        leaf_offsets[i + 1]]`` with ``leaf_lens[i]`` values belonging to
        source vertex ``leaf_keys[i]`` at leaf width ``leaf_tiers[i]``.
        Leaf order matches the padded layout exactly: clustered-index
        segments chunked to their degree's tier width (in local-vertex
        order), then one leaf per live C-ART row (directories in vertex
        order).  Read-only, computed once per snapshot; the pool rows are
        copied, never aliased.
        """
        cached = self._blocks_cache
        if cached is None:
            self._check_not_released()
            # stamp BEFORE gathering: if a row were recycled while we read
            # it (a refcount bug — the exact hazard the stamp exists to
            # catch), the post-materialization stream_fresh() audit sees the
            # pre-read generations and trips; stamping after would compare
            # new-vs-new and mask the corruption
            self._host_gen_stamp = self._capture_gen_stamp()
            cached = self._materialize_leaf_stream()
            for a in cached:
                a.setflags(write=False)
            self._blocks_cache = cached
        return cached

    def _materialize_leaf_stream(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        p = self.p
        base = self.sid * p
        # clustered index: the values array IS the packed stream; chunking a
        # segment to its tier width only splits the sidecars, not the data.
        # Each CI vertex chunks at the width its degree would be assigned —
        # one global B when the pool is single-tier.
        degs = np.diff(self.ci.offsets).astype(np.int64)
        w = self.pool.tiers_for_degrees(degs)
        chunks_per = -(-degs // w)  # ceil; 0 for empty segments
        n_ci = int(chunks_per.sum())
        chunk_base = np.cumsum(chunks_per) - chunks_per
        ci_keys = np.repeat(np.arange(p, dtype=np.int64), chunks_per)
        c_within = np.arange(n_ci, dtype=np.int64) - np.repeat(chunk_base, chunks_per)
        rep_w = np.repeat(w, chunks_per)
        ci_lens = np.minimum(rep_w, np.repeat(degs, chunks_per) - c_within * rep_w)
        if not self.dirs:
            # this branch returns the CI values directly: copy so the frozen
            # cache never aliases the clustered index's array
            data = self.ci.values.astype(np.int32, copy=True)
            lens = ci_lens
            keys = ci_keys
            tiers = rep_w
        else:
            dir_lus = np.fromiter(sorted(self.dirs), np.int64, len(self.dirs))
            leaves_per, all_ids, all_tiers = self._dir_leaf_ids(dir_lus)
            d_data, d_lens = self._dir_gather_packed(all_ids, all_tiers)
            keep = d_lens > 0
            # concatenate copies; no defensive astype copy needed first
            data = np.concatenate([self.ci.values.astype(np.int32, copy=False), d_data])
            lens = np.concatenate([ci_lens, d_lens[keep]])
            keys = np.concatenate([ci_keys, np.repeat(dir_lus, leaves_per)[keep]])
            tiers = np.concatenate([rep_w, all_tiers[keep]])
        offsets = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        return (
            data,
            offsets,
            lens.astype(np.int32),
            (keys + base).astype(np.int32),
            tiers.astype(np.int32),
        )

    def to_leaf_blocks_global(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded ``(src, rows, length)`` leaf-tile blocks, GLOBAL src ids.

        Compatibility view over :meth:`to_leaf_stream_global`: the padded
        ``[n_leaves, B]`` tiles (B = the max tier width) are reconstructed
        from the compacted stream on every call and NOT cached — host memory
        only pays for padding while a caller explicitly holds the result.
        """
        data, offsets, lens, keys, _tiers = self.to_leaf_stream_global()
        return keys, pad_leaf_stream(data, offsets, lens, self.pool.B), lens

    def _capture_gen_stamp(self) -> Tuple[np.ndarray, np.ndarray]:
        """(global leaf row ids, pool generations) backing this snapshot's
        dirs — ids are gid-encoded so tiered pools decode them back to the
        right subpool (identity on a plain pool)."""
        if not self.dirs:
            e = np.empty(0, np.int64)
            return e, e
        ids = np.concatenate(
            [self.pool.gids(d.leaf_ids, d.tier) for d in self.dirs.values()]
        )
        return ids, np.asarray(self.pool.generation[ids]).copy()

    def stream_fresh(self) -> bool:
        """True iff the host stream cache still describes live pool rows.

        Mirrors :func:`repro_torch.core.device_cache.tiles_fresh` for the host
        side: a live snapshot's refcounts pin its rows, so its stamp can
        never change — a False return means a recycled row went stale under
        a cached stream.  Snapshots without a stream cache are vacuously
        fresh.
        """
        stamp = self._host_gen_stamp
        if stamp is None:
            return True
        ids, gens = stamp
        return bool(np.array_equal(self.pool.generation[ids], gens))

    def has_host_cache(self) -> bool:
        """True when a host materialization memo is already warm.

        The delta plane's async prefetch orders dirty subgraphs host-warm
        first, so their uploads are issued while the cold
        subgraphs still rebuild on host.
        """
        return self._blocks_cache is not None or self._coo_cache is not None

    def cache_bytes(self) -> int:
        """Bytes held by the memoized materializations (memory accounting)."""
        total = 0
        for cached in (self._coo_cache, self._blocks_cache):
            if cached is not None:
                total += sum(a.nbytes for a in cached)
        return total

    def device_cache_bytes(self) -> int:
        """Accelerator bytes pinned by this snapshot's device tiles."""
        total = 0
        for cached in (self._dev_blocks_cache, self._dev_coo_cache):
            if cached is None:
                continue
            if hasattr(cached, "device_bytes"):  # DeviceTieredBlocks
                total += cached.device_bytes()
            else:
                total += sum(int(a.nbytes) for a in cached)
        if self._shard_dev_cache:
            for tiles in self._shard_dev_cache.values():
                total += sum(int(a.nbytes) for a in tiles)
        return total

    def check_invariants(self) -> None:
        cidx.check_invariants(self.ci)
        for lu, d in self.dirs.items():
            cart.check_invariants(self.pool, d)
            if cidx.degree(self.ci, lu) != 0:
                raise AssertionError(f"vertex {lu} in both CI and C-ART")


def build_subgraph(
    sid: int,
    p: int,
    pool: LeafPool,
    local_u: np.ndarray,
    vs: np.ndarray,
    high_threshold: int = 256,
    tier_hints: Optional[Dict[int, int]] = None,
) -> SubgraphSnapshot:
    """Bulk-build the version-0 snapshot of subgraph ``sid`` from its edges.

    ``tier_hints`` maps local vertex -> the vertex's *current* leaf tier in
    the snapshot being rebuilt (compactor repacks pass it): tier selection
    then applies the hysteresis band around the old tier, so a repack only
    migrates vertices whose degree drifted decisively across a boundary.
    """
    local_u = np.asarray(local_u, np.int64)
    vs = np.asarray(vs, np.int32)
    degs = np.bincount(local_u, minlength=p)
    high = np.nonzero(degs > high_threshold)[0]
    dirs: Dict[int, CartDir] = {}
    low_mask = np.ones(len(local_u), bool)
    for lu in high:
        m = local_u == lu
        low_mask &= ~m
        vals = np.sort(np.unique(vs[m]))
        tier = None
        if tier_hints and int(lu) in tier_hints:
            tier = pool.tier_for_degree(len(vals), current=tier_hints[int(lu)])
        dirs[int(lu)] = cart.build(pool, vals, tier=tier)
    ci = cidx.build(p, local_u[low_mask], vs[low_mask])
    return SubgraphSnapshot(
        sid=sid,
        ts=0,
        p=p,
        pool=pool,
        active=np.ones(p, bool),
        ci=ci,
        dirs=dirs,
        high_threshold=high_threshold,
    )
