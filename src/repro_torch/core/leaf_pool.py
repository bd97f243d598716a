"""Leaf memory pools with reference-counting GC (paper §4 "memory pool", §6.4)
and skew-adaptive per-degree leaf tiers.

A *leaf row* holds up to ``B`` sorted neighbor IDs, padded with ``SENTINEL``.
Rows are immutable once published: copy-on-write allocates a fresh row, writes
it fully, and only then links it into a new snapshot's directory — readers
holding older directories never observe the write.

Reference counting (paper §6.4): each row's refcount is the number of snapshot
directories referencing it.  The COW path increments the new row's count;
when concurrency control reclaims a snapshot version, its directory decrements
every referenced row and zero-count rows return to the free list.

The tier contract
-----------------

The paper assumes one global leaf width; power-law graphs punish that choice
from both ends (hub vertices fragment across many B=512 leaves, tail vertices
burn a full 512-slot row each).  :class:`TieredLeafPool` therefore owns 2–3
fixed-width :class:`LeafPool` subpools, ascending widths ``tiers`` (e.g.
``(64, 512, 2048)``), and vertices are assigned the smallest tier whose width
covers their observed degree (:meth:`TieredLeafPool.tier_for_degree`):

- every C-ART directory is *homogeneous*: its ``tier`` tag (the leaf width)
  names the one subpool all of its ``leaf_ids`` live in, so searchsorted
  descent, COW insert/delete, splits/merges and refcounting all run against
  a single fixed-B pool — :mod:`repro_torch.core.cart` resolves the subpool from
  the tag at function entry and is otherwise unchanged;
- refcount ownership is per-tier: row ids are *local to their subpool*, so
  cross-directory set ops (``free_exclusive`` / ``incref_shared``) are only
  meaningful between directories of the same tier — directories of different
  tiers share no rows by construction (tier migration rebuilds every leaf);
- tier *selection* happens at CI→C-ART promotion and bulk build time from
  the observed degree; tier *migration* happens only in compactor repack
  cycles, behind a hysteresis band around each tier boundary (degree must
  drift ``TIER_HYSTERESIS`` past the boundary before a rebuild moves it),
  logged as WAL no-write repack commits like any other repack;
- repack pressure is **byte-waste**: a half-empty B=2048 row wastes 32x the
  bytes of a half-empty B=64 row and the compactor's ``min_waste_rows``
  threshold is expressed in max-tier row equivalents of wasted *bytes*
  (see :meth:`repro_torch.core.compactor.Compactor`).

A single-tier config (``tiers == (B,)``) is represented by a plain
:class:`LeafPool` and is bit-for-bit the historical layout; both classes
implement the same tier protocol (``tiers`` / ``pool_for`` /
``tier_for_degree`` / ``gids`` / ``generation``), so callers never branch.

Generation stamps across tiers use *global row ids*: ``gid = tier_index *
2**40 + row`` (:meth:`TieredLeafPool.gids`), and ``TieredLeafPool.generation``
is an indexable proxy that decodes gids back to per-subpool generations — so
snapshot/device-cache freshness audits compare stamps with the exact same
code on tiered and plain pools.

Host materialization contract — the compacted stream
----------------------------------------------------

The pooled ``[capacity, B]`` matrix is a *write-side* format: it exists so
copy-on-write can allocate and recycle fixed-size rows in O(1).  Snapshot
materialization does NOT keep that padding: :func:`LeafPool.gather_packed`
emits the directory-selected rows as one packed 1-D value stream plus
per-leaf lengths, and every host cache downstream
(``SubgraphSnapshot.to_leaf_stream_global``, the view assembler's spliced
global stream) stores leaves in that compacted variable-width form — host
memory and host->device transfers never pay for the ``B - length`` SENTINEL
tail.  Because the stream is variable-width already, tiers only add a
per-leaf ``leaf_tiers`` sidecar; the fixed-width ``[n, B_t]`` tile shapes the
Pallas scan/intersect/spmm kernels require are reconstructed *device-side*
per tier group after the packed upload (see :mod:`repro_torch.core.device_cache`),
or on host at the max-tier width for the ``to_leaf_blocks`` compatibility
path.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .arrays import sorted_unique

SENTINEL = np.int32(np.iinfo(np.int32).max)

# Degree must drift this fraction past a tier boundary before a compactor
# repack migrates the vertex to the adjacent tier — bounds migration thrash
# for degrees oscillating around a boundary (see TieredLeafPool.tier_for_degree).
TIER_HYSTERESIS = 0.25

# Global row-id encoding for tiered pools: gid = tier_index * STRIDE + row.
# 2**40 rows per subpool is unreachable (that alone would be 4 TiB of leaf
# data at B=64), and 3 tiers stay far inside int64.
TIER_GID_STRIDE = np.int64(1) << 40


def parse_leaf_tiers(spec) -> Optional[Tuple[int, ...]]:
    """Normalize a tier spec to an ascending unique tuple of widths.

    Accepts a sequence of ints or a comma-separated string (the
    ``REPRO_LEAF_TIERS`` env format, e.g. ``"64,512"``).  Returns None for
    None/empty input.
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = [s for s in spec.replace(" ", "").split(",") if s]
    tiers = tuple(sorted({int(t) for t in spec}))
    if not tiers:
        return None
    for t in tiers:
        if t < 4:
            raise ValueError(f"leaf tier width must be >= 4, got {t}")
    return tiers


def env_leaf_tiers() -> Optional[Tuple[int, ...]]:
    """Tier config from ``REPRO_LEAF_TIERS`` (the CI matrix knob), or None."""
    return parse_leaf_tiers(os.environ.get("REPRO_LEAF_TIERS"))


class LeafPool:
    """Refcounted pool of B-wide sorted leaf rows (one tier)."""

    def __init__(self, B: int = 512, initial_capacity: int = 64) -> None:
        if B < 4:
            raise ValueError(f"leaf width B must be >= 4, got {B}")
        self.B = int(B)
        cap = max(4, int(initial_capacity))
        self.data = np.full((cap, self.B), SENTINEL, dtype=np.int32)
        self.length = np.zeros(cap, dtype=np.int32)
        self.refcount = np.zeros(cap, dtype=np.int32)
        # Per-row generation, bumped each time a row is freed (and hence
        # eligible for recycling).  Snapshot/device caches stamp the
        # generations they captured; a changed generation under a live cache
        # is direct evidence of a stale tile (see core.device_cache).
        self.generation = np.zeros(cap, dtype=np.int64)
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._lock = threading.Lock()
        self.n_allocs = 0  # statistics
        self.n_frees = 0

    # -- capacity -------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def _grow(self) -> None:
        old_cap = self.capacity
        new_cap = old_cap * 2
        data = np.full((new_cap, self.B), SENTINEL, dtype=np.int32)
        data[:old_cap] = self.data
        self.data = data
        self.length = np.concatenate([self.length, np.zeros(old_cap, np.int32)])
        self.refcount = np.concatenate([self.refcount, np.zeros(old_cap, np.int32)])
        self.generation = np.concatenate([self.generation, np.zeros(old_cap, np.int64)])
        self._free.extend(range(new_cap - 1, old_cap - 1, -1))

    # -- allocation -------------------------------------------------------------
    def alloc(self, values: np.ndarray) -> int:
        """Allocate a row holding the sorted ``values`` (len <= B), refcount 1."""
        n = len(values)
        if n > self.B:
            raise ValueError(f"leaf overflow: {n} > B={self.B}")
        with self._lock:
            if not self._free:
                self._grow()
            row = self._free.pop()
            self.n_allocs += 1
        self.data[row, :n] = values
        self.data[row, n:] = SENTINEL
        self.length[row] = n
        self.refcount[row] = 1
        return row

    def incref(self, row: int) -> None:
        with self._lock:
            self.refcount[row] += 1

    def incref_many(self, rows: np.ndarray) -> None:
        with self._lock:
            np.add.at(self.refcount, rows, 1)

    def decref(self, row: int) -> None:
        with self._lock:
            self.refcount[row] -= 1
            if self.refcount[row] == 0:
                self.length[row] = 0
                self.generation[row] += 1
                self._free.append(int(row))
                self.n_frees += 1
            elif self.refcount[row] < 0:  # pragma: no cover - invariant guard
                raise RuntimeError(f"negative refcount on row {row}")

    def decref_many(self, rows: np.ndarray) -> None:
        with self._lock:
            np.add.at(self.refcount, rows, -1)
            dead = rows[self.refcount[rows] == 0]
            if len(dead):
                # dedupe (a directory never references a row twice, but be safe)
                dead = sorted_unique(dead)
                self.length[dead] = 0
                self.generation[dead] += 1
                self._free.extend(int(r) for r in dead)
                self.n_frees += len(dead)
            if np.any(self.refcount[rows] < 0):  # pragma: no cover
                raise RuntimeError("negative refcount in decref_many")

    # -- reads ---------------------------------------------------------------
    def row_values(self, row: int) -> np.ndarray:
        """The live (unpadded) values of a row — zero-copy slice."""
        return self.data[row, : self.length[row]]

    def gather_packed(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Packed ``(values, lens)`` of the given rows, in row order.

        ``values`` concatenates each row's live (unpadded) contents —
        ``lens[i]`` values for ``rows[i]`` — with no SENTINEL padding; this
        is the compacted emission the host snapshot caches are built from.
        Both arrays are fresh copies (fancy indexing), so callers never
        alias recyclable pool memory.
        """
        rows = np.asarray(rows, np.int64)
        lens = self.length[rows].astype(np.int64)
        if len(rows) == 0:
            return np.empty(0, np.int32), lens
        tiles = self.data[rows]  # [k, B] copy
        return tiles[np.arange(self.B)[None, :] < lens[:, None]], lens

    # -- tier protocol (single-tier degenerate case) ---------------------------
    @property
    def tiers(self) -> Tuple[int, ...]:
        return (self.B,)

    def pool_for(self, tier: int) -> "LeafPool":
        """The subpool holding ``tier``-wide rows — self, for a plain pool."""
        if int(tier) != self.B:
            raise ValueError(f"pool has no tier {tier} (B={self.B})")
        return self

    def tier_for_degree(self, d: int, current: Optional[int] = None) -> int:
        return self.B

    def tiers_for_degrees(self, degs: np.ndarray) -> np.ndarray:
        """Vectorized ``tier_for_degree`` (no hysteresis) — constant here."""
        return np.full(len(degs), self.B, np.int64)

    def gids(self, rows: np.ndarray, tier: int) -> np.ndarray:
        """Global row ids for generation stamps — identity on a plain pool."""
        return np.asarray(rows, np.int64)

    # -- invariants / stats -----------------------------------------------------
    def n_live_rows(self) -> int:
        return self.capacity - len(self._free)

    def live_rows(self) -> np.ndarray:
        mask = np.ones(self.capacity, bool)
        mask[np.asarray(self._free, dtype=np.int64)] = False
        return np.nonzero(mask)[0]

    def fill_ratio(self) -> float:
        """Occupied fraction of live leaf rows (paper Table 3)."""
        live = self.live_rows()
        if len(live) == 0:
            return 1.0
        return float(self.length[live].sum()) / (len(live) * self.B)

    def memory_bytes(self) -> int:
        return (
            self.data.nbytes
            + self.length.nbytes
            + self.refcount.nbytes
            + self.generation.nbytes
        )

    def check_invariants(self) -> None:
        """Free list and refcounted rows must partition the pool."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate rows in free list")
        for row in range(self.capacity):
            rc = self.refcount[row]
            if row in free:
                if rc != 0:
                    raise AssertionError(f"free row {row} has refcount {rc}")
            else:
                if rc <= 0:
                    raise AssertionError(f"live row {row} has refcount {rc}")
                vals = self.row_values(row)
                if len(vals) and not np.all(np.diff(vals.astype(np.int64)) > 0):
                    raise AssertionError(f"row {row} not strictly sorted")


class _TieredGenerationView:
    """Indexable proxy decoding global row ids to per-subpool generations.

    Lets freshness audits run ``pool.generation[gids]`` identically on plain
    and tiered pools (the gids carry the tier, see ``TieredLeafPool.gids``).
    """

    __slots__ = ("_pools",)

    def __init__(self, pools: Tuple[LeafPool, ...]):
        self._pools = pools

    def __getitem__(self, gids) -> np.ndarray:
        gids = np.asarray(gids, np.int64)
        ti = gids // TIER_GID_STRIDE
        rows = gids % TIER_GID_STRIDE
        out = np.empty(len(gids), np.int64)
        for i, sub in enumerate(self._pools):
            m = ti == i
            if m.any():
                out[m] = sub.generation[rows[m]]
        return out


class TieredLeafPool:
    """2–3 fixed-width :class:`LeafPool` subpools keyed by leaf tier.

    The skew-adaptive pool: each tier is an ordinary refcounted pool, and
    every row id handed out is LOCAL to its tier's subpool — directories
    carry the tier tag, and :mod:`repro_torch.core.cart` resolves the subpool at
    entry.  ``B`` is the max tier width (the compatibility padding width for
    host ``to_leaf_blocks`` and the shard plane's fixed kernel shape).
    """

    def __init__(self, tiers: Sequence[int] = (64, 512), initial_capacity: int = 64):
        parsed = parse_leaf_tiers(tiers)
        if not parsed:
            raise ValueError("TieredLeafPool needs at least one tier width")
        if len(parsed) > 8:
            raise ValueError(f"too many leaf tiers: {parsed}")
        self._tiers: Tuple[int, ...] = parsed
        self.pools: Tuple[LeafPool, ...] = tuple(
            LeafPool(B=t, initial_capacity=initial_capacity) for t in parsed
        )
        self._by_tier = {t: p for t, p in zip(parsed, self.pools)}

    # -- tier protocol ---------------------------------------------------------
    @property
    def tiers(self) -> Tuple[int, ...]:
        return self._tiers

    @property
    def B(self) -> int:
        """Max tier width — the fixed padding width compatibility consumers use."""
        return self._tiers[-1]

    def pool_for(self, tier: int) -> LeafPool:
        try:
            return self._by_tier[int(tier)]
        except KeyError:
            raise ValueError(f"pool has no tier {tier} (tiers={self._tiers})")

    def tier_for_degree(self, d: int, current: Optional[int] = None) -> int:
        """Leaf width for a vertex of degree ``d``.

        Base rule: the smallest tier covering ``d`` in one leaf, else the max
        tier (hubs fragment across the widest leaves).  With ``current`` (the
        vertex's existing tier — compactor repacks pass it), a hysteresis
        band of ``TIER_HYSTERESIS`` around the crossed boundary keeps the
        vertex in place until the degree drifts decisively, bounding
        migration thrash for degrees oscillating at a boundary.
        """
        base = self._tiers[-1]
        for t in self._tiers:
            if d <= t:
                base = t
                break
        if current is None or current == base or current not in self._by_tier:
            return base
        if base > current:
            # grew past `current`: migrate up once d clears the band
            return base if d > current * (1.0 + TIER_HYSTERESIS) else current
        # shrank into `base`: migrate down once d is decisively inside it
        return base if d < base * (1.0 - TIER_HYSTERESIS) else current

    def tiers_for_degrees(self, degs: np.ndarray) -> np.ndarray:
        """Vectorized base-rule ``tier_for_degree`` (no hysteresis)."""
        arr = np.asarray(self._tiers, np.int64)
        idx = np.searchsorted(arr, np.asarray(degs, np.int64), side="left")
        return arr[np.minimum(idx, len(arr) - 1)]

    def tier_index(self, tier: int) -> int:
        return self._tiers.index(int(tier))

    def gids(self, rows: np.ndarray, tier: int) -> np.ndarray:
        """Encode subpool-local row ids as pool-global generation-stamp ids."""
        return (
            np.asarray(rows, np.int64)
            + np.int64(self.tier_index(tier)) * TIER_GID_STRIDE
        )

    @property
    def generation(self) -> _TieredGenerationView:
        return _TieredGenerationView(self.pools)

    # -- aggregate stats / invariants ------------------------------------------
    @property
    def n_allocs(self) -> int:
        return sum(p.n_allocs for p in self.pools)

    @property
    def n_frees(self) -> int:
        return sum(p.n_frees for p in self.pools)

    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self.pools)

    def n_live_rows(self) -> int:
        return sum(p.n_live_rows() for p in self.pools)

    def fill_ratio(self) -> float:
        """Byte-weighted occupied fraction of live rows across all tiers."""
        used = avail = 0
        for p in self.pools:
            live = p.live_rows()
            used += int(p.length[live].sum())
            avail += len(live) * p.B
        return float(used) / avail if avail else 1.0

    def memory_bytes(self) -> int:
        return sum(p.memory_bytes() for p in self.pools)

    def check_invariants(self) -> None:
        for p in self.pools:
            p.check_invariants()
