"""Device-resident leaf-block tile cache — per-snapshot layer of the
three-layer memo + delta-plane design.

View materialization is memoized at three layers, each exploiting snapshot
immutability:

1. **Per-subgraph host** (:meth:`SubgraphSnapshot.to_coo_global` /
   ``to_leaf_stream_global``): each immutable snapshot computes its
   vectorized arrays once — the leaf layout is the *compacted* stream
   (packed values + lens/keys sidecars, no SENTINEL padding); a commit
   creates new (cold) snapshots only for the subgraphs it touches.
2. **Per-subgraph device** (this module): each snapshot's compacted stream
   is uploaded once (``torch.from_numpy(...).to(device)``, as int32) and
   re-padded to the fixed-B ``[n, B]`` tile shape *on the device*
   (:func:`_pad_tiles_on_device`) — the CUDA kernels still see dense tiles,
   but the bus only ever carries live bytes, and only one transfer per
   snapshot version.  A warm repeat query performs **zero** host->device
   leaf-block transfers.
3. **Per-view delta plane** (:mod:`repro_torch.core.view_assembler`): the
   global concatenated tensors of a view.  A fresh view splices only the
   dirty subgraphs' tiles into its *predecessor view's* concatenated device
   tensors (a patched clone when segment sizes are unchanged, an
   O(dirty)-run concat otherwise).  The ``assemble_*`` functions here remain
   the non-delta full-concat reference.

Every upload is issued on PyTorch's current stream of the calling thread,
so any later use on that stream is ordered after it.

Lifecycle contract (release / GC invalidation)
----------------------------------------------

1. **Birth** — the first device request on a snapshot uploads that
   snapshot's host-memoized arrays once and pins the tensors on the
   snapshot object.  The host arrays are themselves *copies* of the
   :class:`~repro_torch.core.leaf_pool.LeafPool` rows, and each upload
   copies again, so no cache layer ever aliases recyclable pool memory.
2. **Sharing** — snapshots are immutable once published; every view that
   resolves the same version shares the same device tiles.
3. **Death** — :meth:`SubgraphSnapshot.release` (writer-driven GC) drops
   the device tiles together with the host caches and marks the snapshot
   *released*; a released snapshot **refuses** to re-materialize.
4. **Audit** — each upload stamps the pool row *generations* backing the
   snapshot's directories (:func:`tiles_fresh`).

Accounting: resident device bytes are charged to
:meth:`RapidStore.memory_bytes` via ``SubgraphSnapshot.device_cache_bytes``,
and module-level :data:`stats` counts hits / misses / uploads / bytes so
tests can assert the zero-transfer warm path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs.trace import TRACER as _trc
from .leaf_pool import SENTINEL as _SENTINEL

SENTINEL = int(_SENTINEL)


# ---------------------------------------------------------------------------
# Cache statistics — the observable transfer contract
# ---------------------------------------------------------------------------
class CacheStats:
    """Counters for the device tile cache (process-wide, lock-protected).

    ``uploads`` counts host->device array copies of leaf-block / COO
    arrays — "warm repeat performs zero host->device transfers" is asserted
    as ``uploads`` staying flat across the repeat.  Backed by
    :mod:`repro_torch.obs.metrics` counters (``device_cache_<field>``).
    """

    _FIELDS = ("hits", "misses", "uploads", "bytes_uploaded", "releases")

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None) -> None:
        reg = registry if registry is not None else _metrics.REGISTRY
        self._c = {f: reg.counter("device_cache_" + f) for f in self._FIELDS}

    def __getattr__(self, name: str):
        c = self.__dict__["_c"].get(name)
        if c is None:
            raise AttributeError(name)
        return c.value

    def add(self, name: str, delta: int = 1) -> None:
        self._c[name].add(delta)

    def hit_ratio(self) -> float:
        """Fraction of tile requests served without an upload (0.0 when idle)."""
        h, m = self._c["hits"].value, self._c["misses"].value
        return h / (h + m) if (h + m) else 0.0

    def reset(self) -> None:
        for c in self._c.values():
            c.reset()

    def snapshot(self) -> Tuple[int, int, int, int, int]:
        return tuple(self._c[f].value for f in self._FIELDS)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        body = ", ".join(f"{f}={self._c[f].value}" for f in self._FIELDS)
        return f"CacheStats({body})"


stats = CacheStats()
_metrics.REGISTRY.gauge("device_cache_hit_ratio", fn=stats.hit_ratio)
# Serializes the miss path: without it two readers racing on a fresh
# snapshot would both materialize + upload.  Hits stay lock-free.
_mat_lock = threading.Lock()


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array as a tensor on ``device``; int64 goes up as int32,
    as under JAX's default 32-bit mode.  Always a fresh copy: host caches
    are read-only and must never alias a device (or CPU) tensor."""
    a = np.asarray(a)
    dt = np.int32 if a.dtype == np.int64 else a.dtype
    return torch.from_numpy(np.array(a, dtype=dt, copy=True)).to(device)


def _device_put(host_arrays: Sequence[np.ndarray], device: torch.device,
                shard: Optional[int] = None) -> tuple:
    """Upload ``host_arrays`` to ``device``, counted in ``stats`` and traced
    (with the shard index, for a shard plane's upload)."""
    tok = _trc.begin()
    out = tuple(_upload(a, device) for a in host_arrays)
    stats.add("uploads", len(host_arrays))
    nbytes = int(sum(o.nbytes for o in out))
    stats.add("bytes_uploaded", nbytes)
    if tok:
        args = {"nbytes": nbytes, "n_arrays": len(host_arrays)}
        if shard is not None:
            args.update(shard=int(shard), device=str(device))
        _trc.end(tok, "upload", cat="read", args=args)
    return out


def _hit() -> None:
    stats.add("hits")


def _miss() -> None:
    stats.add("misses")


# ---------------------------------------------------------------------------
# Per-snapshot device tiles
# ---------------------------------------------------------------------------
def _gen_stamp(snap) -> Tuple[np.ndarray, np.ndarray]:
    """Capture (leaf row ids, pool generations) backing ``snap``'s dirs."""
    if not snap.dirs:
        e = np.empty(0, np.int64)
        return e, e
    ids = np.concatenate(
        [snap.pool.gids(d.leaf_ids, d.tier) for d in snap.dirs.values()]
    )
    return ids, np.asarray(snap.pool.generation[ids]).copy()


def tiles_fresh(snap) -> bool:
    """True iff ``snap``'s device tiles still describe live pool rows."""
    stamp = getattr(snap, "_dev_gen_stamp", None)
    if stamp is None:
        return True
    ids, gens = stamp
    return bool(np.array_equal(np.asarray(snap.pool.generation[ids]), gens))


def _pad_tiles_on_device(data: torch.Tensor, lens: torch.Tensor, B: int) -> torch.Tensor:
    """Re-pad packed leaf values to the fixed-B ``[n, B]`` int32 tiles on
    the device ``data``/``lens`` live on (the device twin of
    :func:`repro_torch.core.subgraph.pad_leaf_stream`).  With no live values
    the result is ``[n, B]`` of SENTINEL."""
    tok = _trc.begin()
    n = int(lens.shape[0])
    if int(data.shape[0]) == 0:
        out = torch.full((n, B), SENTINEL, dtype=torch.int32, device=lens.device)
    else:
        lens64 = lens.long()
        off = torch.cumsum(lens64, 0) - lens64
        col = torch.arange(B, device=lens.device)
        mask = col[None, :] < lens64[:, None]
        safe = torch.where(mask, off[:, None] + col[None, :], 0)
        out = torch.where(mask, data[safe], SENTINEL).to(torch.int32)
    if tok:
        _trc.end(tok, "tier_repad", cat="read", args={"n_tiles": n, "B": B})
    return out


def split_stream_by_tier(data, lens, keys, tiers):
    """Split a packed leaf stream into per-tier packed sub-streams (host).

    Returns ``{tier: (gidx, data_t, lens_t, keys_t)}`` where ``gidx`` holds
    the ascending global leaf positions of that tier's leaves in the input
    stream — the scatter map the per-tier device groups carry so consumers
    can route global leaf indices to the right ``[n_t, B_t]`` group.
    """
    lens64 = np.asarray(lens).astype(np.int64)
    off = np.cumsum(lens64) - lens64
    out = {}
    for t in np.unique(np.asarray(tiers)):
        gidx = np.nonzero(np.asarray(tiers) == t)[0]
        sel = lens64[gidx]
        local_off = np.cumsum(sel) - sel
        pos = np.arange(int(sel.sum()), dtype=np.int64) - np.repeat(local_off, sel)
        data_t = data[np.repeat(off[gidx], sel) + pos]
        out[int(t)] = (gidx, data_t, lens[gidx], keys[gidx])
    return out


def leaf_block_tiles(snap, device: torch.device):
    """Device-resident leaf tiles of one snapshot on ``device``.

    Single-tier pools: the ``(src, rows, length)`` tuple — the host-memoized
    *compacted* stream is uploaded (packed values, lens, keys; no SENTINEL
    padding crosses the bus) then re-padded to ``[n, B]`` on the device; one
    transfer per snapshot version, ever.  Tiered pools: a
    :class:`DeviceTieredBlocks` — the packed stream is split per tier on the
    host, each tier's sub-stream uploads separately, and one re-pad per tier
    yields fixed ``[n_t, B_t]`` groups.  Memoized on the snapshot either
    way; raises RuntimeError on released snapshots.
    """
    cached = snap._dev_blocks_cache
    if cached is not None:
        _hit()
        return cached
    with _mat_lock:
        cached = snap._dev_blocks_cache
        if cached is not None:  # lost the race: another reader just uploaded
            _hit()
            return cached
        _miss()
        # raises if released; the stream is a copy of the pool rows
        data, _offsets, lens, keys, tiers = snap.to_leaf_stream_global()
        if len(snap.pool.tiers) == 1:
            up_data, up_lens, up_keys = _device_put((data, lens, keys), device)
            rows = _pad_tiles_on_device(up_data, up_lens, snap.pool.B)
            tiles = (up_keys, rows, up_lens)
        else:
            groups = {}
            gidx = {}
            for t, (gi, d_t, l_t, k_t) in split_stream_by_tier(
                data, lens, keys, tiers
            ).items():
                up_d, up_l, up_k = _device_put((d_t, l_t, k_t), device)
                groups[t] = (up_k, _pad_tiles_on_device(up_d, up_l, t), up_l)
                gidx[t] = gi
            tiles = DeviceTieredBlocks(
                groups=groups, gidx=gidx, n_blocks=len(lens), B=snap.pool.B
            )
        snap._dev_gen_stamp = _gen_stamp(snap)
        snap._dev_blocks_cache = tiles
        return tiles


def coo_tiles(snap, device: torch.device) -> tuple:
    """Device-resident int32 ``(src, dst)`` COO tiles of one snapshot."""
    cached = snap._dev_coo_cache
    if cached is not None:
        _hit()
        return cached
    with _mat_lock:
        cached = snap._dev_coo_cache
        if cached is not None:
            _hit()
            return cached
        _miss()
        tiles = _device_put(snap.to_coo_global(), device)
        if snap._dev_gen_stamp is None:
            snap._dev_gen_stamp = _gen_stamp(snap)
        snap._dev_coo_cache = tiles
        return tiles


def note_release(snap) -> None:
    """Record (for stats) that a snapshot's device tiles died with GC."""
    if (
        snap._dev_blocks_cache is not None
        or snap._dev_coo_cache is not None
        or snap._shard_dev_cache
    ):
        stats.add("releases")


# ---------------------------------------------------------------------------
# Per-(snapshot, shard) tiles — the shard plane's residency layer.
#
# Same lifecycle as the default-device tiles above (upload once per snapshot
# version, generation-stamped against recycled LeafPool rows, dropped in
# release()), but pinned on the device of an EXPLICIT shard: the shard plane
# (repro_torch.core.shard_plane) places each subgraph's tiles on the shard
# its placement policy chose, so a commit dirtying subgraphs on one shard
# uploads only to that shard.  Entries are keyed ``(kind, k)`` by the
# shard's slot ``k`` in the plane, never by its device: several shards may
# share one card (or the CPU), and a device key would merge their entries.
# The functions return ``(tiles, uploaded_bytes)`` — 0 bytes on a hit — so
# the plane can keep per-shard upload counters on top of ``stats``.
# ---------------------------------------------------------------------------
def _shard_host_tiles(snap, kind: str, k: int, device: torch.device) -> tuple:
    """Upload one snapshot's ``kind`` tiles for shard ``k``: ``(tiles,
    nbytes)``.  COO tiles are ``(src, dst)``; leaf tiles ``(src, rows,
    length)`` with only the packed stream crossing the bus (``rows`` is
    re-padded to the pool's width on the device, so ``nbytes`` counts live
    bytes).  Raises RuntimeError on a released snapshot."""
    if kind == "coo":
        tiles = _device_put(snap.to_coo_global(), device, shard=k)
        return tiles, int(sum(t.nbytes for t in tiles))
    data, _offsets, lens, keys, _tiers = snap.to_leaf_stream_global()
    up = _device_put((data, lens, keys), device, shard=k)
    d, l, s = up
    return (s, _pad_tiles_on_device(d, l, snap.pool.B), l), int(sum(t.nbytes for t in up))


def _install(snap, key, tiles) -> tuple:
    """Cache ``tiles`` under ``key`` (first writer wins) and stamp the
    snapshot; call under ``_mat_lock``.  Returns the cached tiles."""
    if snap._shard_dev_cache is None:
        snap._shard_dev_cache = {}
    if snap._dev_gen_stamp is None:
        snap._dev_gen_stamp = _gen_stamp(snap)
    return snap._shard_dev_cache.setdefault(key, tiles)


def _shard_tiles(snap, kind: str, k: int, device: torch.device) -> Tuple[tuple, int]:
    key = (kind, int(k))
    cache = snap._shard_dev_cache
    if cache is not None and key in cache:
        _hit()
        return cache[key], 0
    with _mat_lock:
        cache = snap._shard_dev_cache
        if cache is not None and key in cache:
            _hit()
            return cache[key], 0
        _miss()
        tiles, nbytes = _shard_host_tiles(snap, kind, k, device)
        return _install(snap, key, tiles), nbytes


def shard_coo_tiles(snap, k: int, device: torch.device) -> Tuple[tuple, int]:
    """int32 ``(src, dst)`` COO tiles of one snapshot for shard ``k``, on
    ``device``.  Memoized per (snapshot, shard); returns ``(tiles,
    uploaded_bytes)`` with 0 bytes on a hit.  Raises RuntimeError on
    released snapshots (the pool may have recycled their rows)."""
    return _shard_tiles(snap, "coo", k, device)


def shard_leaf_tiles(snap, k: int, device: torch.device) -> Tuple[tuple, int]:
    """int32 ``(src, rows, length)`` leaf tiles for shard ``k`` on
    ``device``, ``rows`` at the pool's width ``B`` (the max tier on a tiered
    pool).  Same contract as :func:`shard_coo_tiles`; only the compacted
    stream crosses the bus."""
    return _shard_tiles(snap, "blocks", k, device)


# ---------------------------------------------------------------------------
# Migration staging — the SEND/RECV/FREE halves of the reshard runtime
# (repro_torch.core.reshard).  SEND uploads WITHOUT installing into the
# snapshot cache, so an aborted migration leaves no trace; RECV commits the
# staged tiles under the same lock + generation stamp the normal fetch path
# uses; FREE drops a shard's entries after the placement flip (any straggler
# reader at the old placement just re-uploads — correctness is unaffected,
# only the one transfer is repaid).
# ---------------------------------------------------------------------------
def stage_shard_tiles(snap, k: int, device: torch.device, kind: str):
    """SEND: upload one snapshot's ``kind`` tiles for shard ``k``, unstaged.

    Returns ``(key, tiles, uploaded_bytes)``; 0 bytes when the tiles are
    already resident (the migration then degenerates to a cache no-op).
    Raises RuntimeError on a released snapshot, like the fetch paths.
    """
    key = (kind, int(k))
    cache = snap._shard_dev_cache
    if cache is not None and key in cache:
        return key, cache[key], 0
    tiles, nbytes = _shard_host_tiles(snap, kind, k, device)
    return key, tiles, nbytes


def install_shard_tiles(snap, key, tiles) -> None:
    """RECV: commit staged tiles into the per-(snapshot, shard) cache.

    First writer wins, under the materialization lock: if a concurrent
    view assembly already uploaded the same entry, its tiles stay and the
    staged copy is dropped — both are identical materializations of the
    same immutable snapshot.
    """
    with _mat_lock:
        _install(snap, key, tiles)


def drop_shard_tiles(snap, k: int, kinds=("coo", "blocks")) -> int:
    """FREE: drop ``snap``'s cache entries of shard ``k``; returns the bytes
    released.  Safe against concurrent readers: assembled view bundles hold
    their own tensors, so dropping the entry only makes a future assembly
    at the old placement upload again."""
    freed = 0
    with _mat_lock:
        cache = snap._shard_dev_cache
        if cache:
            for kind in kinds:
                tiles = cache.pop((kind, int(k)), None)
                if tiles is not None:
                    freed += int(sum(int(t.nbytes) for t in tiles))
    return freed


# ---------------------------------------------------------------------------
# View-level assembly: O(dirty) upload + O(S) device concat.
# This is the NON-DELTA reference path: SnapshotView.to_*_device route
# through repro_torch.core.view_assembler (which splices against the
# predecessor view and falls back to an equivalent of these).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DeviceLeafBlockView:
    """Device twin of :class:`~repro_torch.core.snapshot.LeafBlockView`."""

    src: torch.Tensor  # int32 [n_blocks]
    rows: torch.Tensor  # int32 [n_blocks, B]
    length: torch.Tensor  # int32 [n_blocks]

    @property
    def n_blocks(self) -> int:
        return int(self.src.shape[0])


@dataclass(frozen=True)
class DeviceTieredBlocks:
    """Per-tier device leaf tiles of a tiered pool.

    Each tier's leaves live in their own fixed-shape group — ``groups[t] =
    (src, rows [n_t, t], length)`` int32 tensors padded on the device to
    that tier's native width — so the kernels run once per tier with a
    fixed ``[*, B_t]`` shape.  ``gidx[t]`` (host int64, ascending) maps each
    group row back to its global position in the unified leaf stream order.
    ``src``/``rows``/``length`` lazily build the unified max-width twin for
    compatibility consumers and parity asserts.
    """

    groups: dict  # tier -> (src, rows, length) tensors
    gidx: dict  # tier -> np.ndarray int64 global leaf positions (ascending)
    n_blocks: int
    B: int  # unified compat padding width (max tier)
    _unified: list = field(default_factory=list, repr=False, compare=False)

    @property
    def tiers(self):
        return sorted(self.groups)

    def _build_unified(self) -> tuple:
        dev = next(iter(self.groups.values()))[1].device
        src = torch.zeros(self.n_blocks, dtype=torch.int32, device=dev)
        rows = torch.full((self.n_blocks, self.B), SENTINEL, dtype=torch.int32,
                          device=dev)
        length = torch.zeros(self.n_blocks, dtype=torch.int32, device=dev)
        for t in self.tiers:
            s, r, l = self.groups[t]
            gi = torch.from_numpy(self.gidx[t]).to(dev)
            src[gi] = s
            rows[gi, : r.shape[1]] = r
            length[gi] = l
        return src, rows, length

    @property
    def unified(self) -> tuple:
        if not self._unified:
            self._unified.append(self._build_unified())
        return self._unified[0]

    @property
    def src(self):
        return self.unified[0]

    @property
    def rows(self):
        return self.unified[1]

    @property
    def length(self):
        return self.unified[2]

    def device_bytes(self) -> int:
        total = 0
        for cols in self.groups.values():
            total += sum(int(a.nbytes) for a in cols)
        if self._unified:
            total += sum(int(a.nbytes) for a in self._unified[0])
        return total


@dataclass(frozen=True)
class DeviceCSRView:
    """Device twin of :class:`~repro_torch.core.snapshot.CSRView`."""

    offsets: torch.Tensor  # int32 [n_vertices + 1]
    indices: torch.Tensor  # int32 [n_edges]


def csr_offsets(src: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """int32 CSR offsets from a (u-sorted) int32 src column, on its device."""
    degs = torch.bincount(src, minlength=n_vertices)
    zero = torch.zeros(1, dtype=degs.dtype, device=src.device)
    return torch.cat([zero, torch.cumsum(degs, 0)]).to(torch.int32)


def assemble_leaf_blocks(snaps: Sequence, B: int, device: torch.device) -> DeviceLeafBlockView:
    """Concatenate per-snapshot device tiles into the global tile stream."""
    parts = [leaf_block_tiles(s, device) for s in snaps]
    if not parts:
        z = np.zeros(0, np.int32)
        return DeviceLeafBlockView(
            *_device_put((z, np.zeros((0, B), np.int32), z), device)
        )
    cols = [
        (p.src, p.rows, p.length) if isinstance(p, DeviceTieredBlocks) else p
        for p in parts
    ]
    return DeviceLeafBlockView(*(torch.cat([c[i] for c in cols]) for i in range(3)))


def assemble_coo(snaps: Sequence, device: torch.device) -> tuple:
    """Concatenate per-snapshot device COO tiles into global (src, dst)."""
    parts = [coo_tiles(s, device) for s in snaps]
    if not parts:
        z = np.zeros(0, np.int32)
        return _device_put((z, z), device)
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def assemble_csr(snaps: Sequence, n_vertices: int, device: torch.device) -> DeviceCSRView:
    """Device CSR from the cached device COO (offsets computed on device)."""
    src, dst = assemble_coo(snaps, device)
    # per-subgraph COO is (u sorted, v sorted) and subgraphs are id-ordered,
    # so the concatenated dst stream is already in CSR order (as on host).
    return DeviceCSRView(csr_offsets(src, n_vertices), dst)


__all__ = [
    "CacheStats",
    "DeviceCSRView",
    "DeviceLeafBlockView",
    "DeviceTieredBlocks",
    "split_stream_by_tier",
    "assemble_coo",
    "assemble_csr",
    "assemble_leaf_blocks",
    "coo_tiles",
    "csr_offsets",
    "drop_shard_tiles",
    "install_shard_tiles",
    "leaf_block_tiles",
    "note_release",
    "shard_coo_tiles",
    "shard_leaf_tiles",
    "stage_shard_tiles",
    "stats",
    "tiles_fresh",
]
