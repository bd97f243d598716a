"""Sharded tile plane: snapshot views laid over shards, with collective
analytics.

RapidStore's decoupling keeps version data out of graph data so concurrent
readers scale with cores; the same decoupling scales with *devices*.  Each
subgraph's leaf-block/COO tiles are independent immutable units, so placing
them on shards turns view assembly into a set of per-shard splices and
analytics into a local reduce per shard plus a merge — no host re-shard
per call, no cross-device traffic on assembly.

A shard is a slot of the plane, not a device: shard ``k`` sits on
``plane.devices[k]`` (by default visible card ``k % n_cards``,
:func:`repro_torch.launch.mesh.shard_devices`), so several shards may share
one card, and on the CPU every shard is ``cpu``.  Residency is keyed by the
slot, so four shards on one card keep four sets of tiles and count their
uploads apart, as four cards would.

Placement policy
----------------

A policy maps per-subgraph weights (edge counts at attach time) to a shard
index per subgraph.  Built-ins:

- ``"modulo"`` (default): ``sid % n_shards`` — keeps placement trivially
  stable as subgraphs are appended.
- ``"degree_balanced"``: greedy bin packing — subgraphs sorted by weight,
  heaviest first, each assigned to the least-loaded shard.  Evens out
  skewed graphs where modulo would land several hubs on one shard.

Custom callables ``(weights, n_shards) -> assignment`` are accepted.

Placement is **versioned**, not an attach-time constant.  The attach-time
policy result seeds *epoch 0*; each migration committed by the rebalancer
(:mod:`repro_torch.core.reshard`) appends a new epoch ``(commit_ts,
placement)`` with the migrated subgraphs re-assigned.  A view resolves the
placement of the newest epoch at or below its own timestamp
(:meth:`ShardPlane.placement_at`), so every view at ``ts >= epoch`` sees
the new placement and every older view keeps resolving the old one — the
MVCC rule the version chains apply to graph data, applied to placement.
Within one epoch placement is append-only (appended subgraphs get the
policy's choice for the extended id, identically across all epochs), so a
predecessor bundle's clean shards stay reusable for same-epoch successors;
across an epoch boundary only the shards a migration or commit touched are
rebuilt and every other shard's tensors are reused by object identity.
Epochs are recorded in :class:`~repro_torch.core.version_chain.
CommitLineage` (``record_placement``) and WAL-logged as no-write commits,
so recovery restores the same placement history.

Residency lifecycle
-------------------

Per-(snapshot, shard) tiles live in :func:`repro_torch.core.device_cache.
shard_coo_tiles` / ``shard_leaf_tiles``: uploaded once per snapshot version
to the shard the placement chose, generation-stamped against recycled
:class:`~repro_torch.core.leaf_pool.LeafPool` rows (the plane re-verifies
the stamp after every fetch and refuses to splice a stale tile), and
dropped by ``SubgraphSnapshot.release()`` when writer-driven GC reclaims
the version.  Leaf tiles cross the bus compacted (the fixed-B padding is
made on the shard's device), so the per-shard byte counters count live
bytes.  Per-shard upload/byte counters in :class:`ShardPlaneStats` make the
transfer contract observable: after a commit dirtying subgraphs resident
on one shard, every other shard's upload counter stays flat.

Splice contract
---------------

Each view's :class:`~repro_torch.core.view_assembler.ViewAssembly` carries
a :class:`ShardedViewAssembly`: per-shard concatenated tensors padded to a
power-of-two capacity plus per-subgraph segment offsets.  A successor view
resolves its dirty set through the commit lineage (the same ``_plan`` the
single-device delta plane uses) and

- reuses the predecessor bundle wholesale when the dirty set is empty;
- reuses every *clean shard's* tensors by object identity;
- on a dirty shard, uploads only the dirty subgraphs' tiles to that shard
  and splices them in — into a *clone* of each predecessor column when
  every dirty segment keeps its size (never in place: older views pinned
  on the predecessor still read its tensors), an O(dirty)-run rebuild
  otherwise.

Capacities are powers of two, so small writes never resize; when a shard
outgrows its capacity, the other shards re-pad on their own device (no
host->device transfer).  Every fallback (no predecessor, trimmed lineage,
dirty fraction above the splice threshold, ``REPRO_DISABLE_DELTA_SPLICE``)
routes to a full per-shard rebuild that still uploads each subgraph's
tiles at most once per snapshot version.

Collectives
-----------

``pagerank`` / ``bfs`` / ``sssp`` / ``wcc`` run the ``make_*`` functions
of :mod:`repro_torch.core.distributed` over each shard's live prefix: a
local reduce on each shard's device, a merge in shard order on shard 0's
device.  ``spmm``
runs the hand-written ``leaf_spmm`` (``csrc/leaf_spmm.cu`` on the card, its
plain version on the CPU) once per shard over that shard's tiles and sums
the compact per-tile outputs by source with ``index_add_`` into one output
on shard 0's device.  On the CPU the merges give *bitwise*
parity with the single-device ``*_view`` functions:

- min/max merges (BFS, SSSP, WCC) are order-independent, hence exact on
  any store (on the card too);
- SpMM aggregates by *source* vertex: the store's partitioning gives every
  source vertex to exactly one shard, so each vertex's tiles add in the
  single-device order;
- PageRank uses the *pull* form over each shard's own out-edges (gather at
  dst, scatter by src): on a symmetrized store (``symmetric=True``) this
  reproduces the single-device per-vertex sum order exactly, again making
  the merge exact.  On a directed store pass ``symmetric=False`` (the
  default) to get the push form — standard vertex-cut PageRank, equal to
  the single-device answer to rounding.  On the card ``index_add_`` adds
  with atomics, so SpMM and PageRank agree within tolerance there.

One process per card
--------------------

Given a mesh from :func:`repro_torch.launch.mesh.distributed_shard_mesh`,
the plane spans the ranks of a ``torch.distributed`` group: shard ``k``
belongs to rank ``k % world``.  Every rank holds the same store (the same
seeded data and the same commits), so placement — the policy, the epochs
and the rebalancer's moves — is computed alike on every rank and never
crosses the wire.  A rank fetches, pins and splices tiles only for its
own shards (``kind.shards[k]`` is ``None`` for another rank's shard), runs
the collectives' local parts over them, and merges through the
collectives' process-group backend: its own shards in shard order, then
one ``dist.all_reduce`` (sum, max or min) across the ranks.  The bitwise
contract above holds across processes: min and max merges are
order-free, and SpMM's and pull-PageRank's sums give each vertex to one
shard, so the other ranks add exact zeros; push-PageRank agrees within
tolerance.  Per-edge operands (SSSP weights) follow the global COO order,
so a rank counts another rank's subgraphs' edges on the host
(``n_edges``) to find its own segments' global offsets.

``REPRO_DISABLE_SHARD_PLANE=1`` routes the ``*_view`` entry points back to
the single-device paths.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .hooks import RESHARD_HOOKS
from .leaf_pool import SENTINEL


def enabled() -> bool:
    """Shard-plane routing switch (``REPRO_DISABLE_SHARD_PLANE`` opts out)."""
    return not os.environ.get("REPRO_DISABLE_SHARD_PLANE")


def active_plane(view):
    """The plane that should serve ``view``'s collective analytics, or None."""
    plane = getattr(view, "_plane", None)
    if plane is None or not enabled():
        return None
    return plane


# ---------------------------------------------------------------------------
# Placement policies
# ---------------------------------------------------------------------------
def modulo_placement(weights: np.ndarray, n_shards: int) -> np.ndarray:
    """``sid % n_shards`` — stable, oblivious to skew."""
    return np.arange(len(weights), dtype=np.int64) % n_shards


def degree_balanced_placement(weights: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy bin packing: heaviest subgraph first onto the lightest shard.

    Classic LPT scheduling — load within 4/3 of optimal, good enough to keep
    a power-law graph's hub subgraphs off one shard.  Deterministic: ties
    break toward the lowest shard index, equal weights toward the lower
    subgraph id (stable argsort).
    """
    weights = np.asarray(weights, np.int64)
    order = np.argsort(-weights, kind="stable")
    loads = np.zeros(n_shards, np.int64)
    out = np.zeros(len(weights), np.int64)
    for sid in order:
        k = int(np.argmin(loads))
        out[sid] = k
        loads[k] += weights[sid]
    return out


_POLICIES: Dict[str, Callable] = {
    "modulo": modulo_placement,
    "degree_balanced": degree_balanced_placement,
}


# ---------------------------------------------------------------------------
# Stats — the observable per-shard transfer contract
# ---------------------------------------------------------------------------
@dataclass
class ShardPlaneStats:
    """Counters for one plane (lock-protected by the plane's lock).

    ``uploads[k]`` / ``bytes_uploaded[k]`` count host->device segment
    uploads to shard ``k`` during view assembly — "a write dirtying
    subgraphs on one shard uploads only to that shard" is asserted as every
    other shard's counter staying flat.  ``repads`` counts re-pads on a
    shard's own device (no host transfer involved).
    """

    n_shards: int = 1
    uploads: List[int] = field(default_factory=list)
    bytes_uploaded: List[int] = field(default_factory=list)
    assemblies: int = 0
    splices: int = 0
    full_builds: int = 0
    reuses: int = 0
    shard_reuses: int = 0
    repads: int = 0
    spliced_segments: int = 0
    operand_uploads: int = 0
    collective_calls: int = 0
    migration_rebuilds: int = 0

    def __post_init__(self) -> None:
        if not self.uploads:
            self.uploads = [0] * self.n_shards
        if not self.bytes_uploaded:
            self.bytes_uploaded = [0] * self.n_shards

    def reset(self) -> None:
        self.uploads = [0] * self.n_shards
        self.bytes_uploaded = [0] * self.n_shards
        self.assemblies = 0
        self.splices = 0
        self.full_builds = 0
        self.reuses = 0
        self.shard_reuses = 0
        self.repads = 0
        self.spliced_segments = 0
        self.operand_uploads = 0
        self.collective_calls = 0
        self.migration_rebuilds = 0


# ---------------------------------------------------------------------------
# Per-shard bundles
# ---------------------------------------------------------------------------
class ShardBundle:
    """One shard's padded tile columns + per-subgraph segment offsets.

    ``cols`` are tensors on ``device`` with leading dim ``cap``;
    ``offsets[i]`` spans subgraph ``sids[i]``'s segment inside the live
    prefix ``[0:n_live]``.  Padding uses SENTINEL ids (length 0 for leaf
    tiles) and, for COO, an explicit ``valid`` mask.
    """

    __slots__ = ("device", "sids", "offsets", "n_live", "cap", "cols", "valid")

    def __init__(self, device, sids, offsets, n_live, cap, cols, valid=None):
        self.device = device
        self.sids = sids  # np int64, ascending
        self.offsets = offsets  # np int64 [len(sids)+1]
        self.n_live = int(n_live)
        self.cap = int(cap)
        self.cols = cols  # tuple of tensors, leading dim == cap
        self.valid = valid  # bool [cap] (COO kinds only)

    def live(self) -> tuple:
        """The columns' live prefixes (views, no copy) — what the
        collectives read; pad slots never reach a kernel."""
        return tuple(c[: self.n_live] for c in self.cols)

    def nbytes(self) -> int:
        total = sum(int(c.nbytes) for c in self.cols)
        if self.valid is not None:
            total += int(self.valid.nbytes)
        return total


class ShardedKind:
    """One materialization kind (COO or leaf blocks) across all shards;
    ``shards[k]`` is ``None`` where another process holds shard ``k``."""

    __slots__ = ("cap", "shards", "seg_counts")

    def __init__(self, cap: int, shards: List[ShardBundle], seg_counts: np.ndarray):
        self.cap = int(cap)
        self.shards = shards
        # per-subgraph segment length, indexed by sid — the splice map and
        # the global-offset source for per-edge operands (SSSP weights)
        self.seg_counts = seg_counts

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.shards if s is not None)


class ShardedViewAssembly:
    """Shard-plane twin of :class:`~repro_torch.core.view_assembler.ViewAssembly`.

    Held on ``ViewAssembly.sharded`` so it rides the store's existing
    retire / weak-predecessor lifecycle: the newest retired view's bundle
    is the splice source for its successor, and GC of superseded bundles
    frees the per-shard tensors (the per-snapshot tiles stay pinned in the
    device cache until their snapshot is released).
    """

    __slots__ = ("ts", "S", "placement", "coo", "blocks")

    def __init__(self, ts: int, S: int, placement: np.ndarray) -> None:
        self.ts = ts
        self.S = S
        self.placement = placement  # np int64 [S]
        self.coo: Optional[ShardedKind] = None
        self.blocks: Optional[ShardedKind] = None

    def device_bytes(self) -> int:
        total = 0
        for kind in (self.coo, self.blocks):
            if kind is not None:
                total += kind.nbytes()
        return total


def _round_cap(n_live: int, floor: int) -> int:
    """Power-of-two capacity >= max(floor, n_live): small writes never
    resize, so clean shards' padded tensors stay splice-compatible."""
    cap = int(floor)
    while cap < n_live:
        cap *= 2
    return cap


def _host_count(snap, kind: str) -> int:
    """Segment length of a subgraph this process holds no tiles of: its
    edge count for COO (per-edge operands need every segment's global
    offset); 0 for leaf tiles, whose counts nothing reads."""
    return int(snap.n_edges) if kind == "coo" else 0


# ---------------------------------------------------------------------------
# The plane
# ---------------------------------------------------------------------------
class ShardPlane:
    """Sharded tile subsystem for one :class:`~repro_torch.core.store.
    RapidStore` (see the module docstring for the full contract).

    ``devices`` lists each shard's ``torch.device`` (repeats allowed);
    without it ``n_devices`` shards follow the store's device
    (:func:`~repro_torch.launch.mesh.shard_devices`).  A shard never sits on
    another kind of device than the store's.  ``mesh`` (a 1-D mesh from
    :func:`~repro_torch.launch.mesh.distributed_shard_mesh`, in place of
    ``devices``) spreads the shards over processes: this rank holds only
    its own shards' tiles (module docstring, "One process per card").  ``symmetric=True`` declares
    the store holds a symmetrized graph (every edge stored in both
    directions); PageRank then uses the pull form that is bitwise-equal to
    the single-device answer on the CPU.
    """

    _COO_FLOOR = 256  # min edge capacity per shard
    _BLK_FLOOR = 64  # min leaf-tile capacity per shard

    def __init__(
        self,
        store,
        devices: Optional[Sequence] = None,
        n_devices: Optional[int] = None,
        policy: Union[str, Callable] = "modulo",
        symmetric: bool = False,
        mesh=None,
    ) -> None:
        from ..kernels.runtime import indexed
        from ..launch.mesh import shard_devices

        self.store = store
        self.ranks = None if mesh is None else mesh.ranks
        if mesh is not None:
            if devices is not None or (n_devices is not None and int(n_devices) != mesh.size):
                raise ValueError("give a shard plane a mesh or its devices, not both")
            devices = mesh.flat_devices
        if devices is None:
            devices = shard_devices(n_devices, store.device)
        elif n_devices is not None and int(n_devices) != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} devices given")
        self.devices = [indexed(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard plane needs at least one shard")
        wrong = [d for d in self.devices if d.type != store.device.type]
        if wrong:
            raise ValueError(
                f"a {store.device.type} store cannot put shards on {wrong}"
            )
        self.n_shards = len(self.devices)
        self._local = (set(range(self.n_shards)) if mesh is None
                       else set(mesh.local_shards))
        self.symmetric = bool(symmetric)
        self._policy_name = policy if isinstance(policy, str) else "custom"
        self._policy = _POLICIES[policy] if isinstance(policy, str) else policy
        self._lock = threading.Lock()
        self.stats = ShardPlaneStats(self.n_shards)
        weights = np.array(
            [c.head.n_edges for c in store.chains], np.int64
        )
        base = np.asarray(self._policy(weights, self.n_shards), np.int64).copy()
        # versioned placement: ascending (epoch_ts, placement) pairs; epoch 0
        # is the attach-time policy result, each migration flip appends a new
        # pair.  Arrays are immutable once stored (extension and flips both
        # append fresh arrays), so slices handed to views stay valid forever.
        self._epochs: List[tuple] = [(0, base)]
        self._loads = np.bincount(
            base, weights=weights, minlength=self.n_shards
        ).astype(np.int64)
        # nominal weight charged per appended subgraph: without it the
        # least-loaded argmin below would keep answering the same shard and
        # every append would pile onto one shard
        self._nominal = max(1, int(weights.mean()) if len(weights) else 1)
        self._registered: List[tuple] = []
        self._register_metrics()

    # -- telemetry -----------------------------------------------------------
    def _register_metrics(self) -> None:
        """Per-shard gauges on the owning store's registry.

        These are the rebalancer's primary signals (alongside the write
        pipeline's ``pipeline_queue_depth``): per-shard upload counters and
        the current-epoch edge load.  :meth:`close` unregisters every one —
        ``detach_shard_plane`` must leave the registry exactly as it found
        it.
        """
        reg = self.store.registry
        for k in range(self.n_shards):
            labels = {"shard": str(k)}
            reg.gauge("shard_plane_uploads",
                      fn=lambda k=k: self.stats.uploads[k], **labels)
            reg.gauge("shard_plane_bytes_uploaded",
                      fn=lambda k=k: self.stats.bytes_uploaded[k], **labels)
            reg.gauge("shard_plane_load",
                      fn=lambda k=k: self.shard_load(k), **labels)
            self._registered += [
                ("shard_plane_uploads", labels),
                ("shard_plane_bytes_uploaded", labels),
                ("shard_plane_load", labels),
            ]
        reg.gauge("shard_plane_epoch", fn=lambda: self.current_epoch)
        self._registered.append(("shard_plane_epoch", {}))

    def close(self) -> None:
        """Unregister this plane's per-shard metrics (idempotent)."""
        reg = self.store.registry
        for name, labels in self._registered:
            reg.unregister(name, **labels)
        self._registered = []

    def shard_load(self, k: int) -> int:
        """Edge weight resident on shard ``k`` under the current placement."""
        with self._lock:
            placement = self._epochs[-1][1]
        chains = self.store.chains
        lim = min(len(placement), len(chains))
        return int(sum(
            chains[sid].head.n_edges
            for sid in range(lim) if int(placement[sid]) == k
        ))

    def is_local(self, k: int) -> bool:
        """True when this process holds shard ``k``'s tiles."""
        return k in self._local

    @property
    def home(self) -> torch.device:
        """The device this process merges on: its first shard's."""
        return self.devices[min(self._local)]

    # -- placement -----------------------------------------------------------
    @property
    def current_epoch(self) -> int:
        """Commit timestamp of the newest placement epoch (0 = attach)."""
        return self._epochs[-1][0]

    def _extend_locked(self, S: int) -> None:
        """Append-extend every epoch's placement to length ``S``.

        Appended subgraphs get the SAME assignment in every epoch — they
        did not exist when older epochs were committed, so there is nothing
        for those epochs to disagree about, and sharing the assignment
        keeps old-timestamp views (which can still see an appended
        subgraph's empty version-0 snapshot) consistent with new ones.
        """
        cur = self._epochs[-1][1]
        while len(cur) < S:
            sid = len(cur)
            if self._policy is modulo_placement:
                k = sid % self.n_shards
            else:
                k = int(np.argmin(self._loads))
                self._loads[k] += self._nominal
            self._epochs = [
                (ts, np.append(arr, k)) for ts, arr in self._epochs
            ]
            cur = self._epochs[-1][1]

    def placement_for(self, S: int) -> np.ndarray:
        """The *current* (newest-epoch) placement, append-extended to ``S``."""
        with self._lock:
            self._extend_locked(S)
            return self._epochs[-1][1][:S]

    def placement_at(self, ts: int, S: int) -> np.ndarray:
        """Placement of the newest epoch with ``epoch_ts <= ts`` — the MVCC
        read rule for placement: a migration flip at epoch E never changes
        what an older view sees."""
        with self._lock:
            self._extend_locked(S)
            lo, hi = 0, len(self._epochs) - 1
            while lo < hi:  # rightmost epoch with epoch_ts <= ts
                mid = (lo + hi + 1) // 2
                if self._epochs[mid][0] <= ts:
                    lo = mid
                else:
                    hi = mid - 1
            return self._epochs[lo][1][:S]

    def record_epoch(self, ts: int, moves: Dict[int, int]) -> None:
        """Append a placement epoch at commit timestamp ``ts``.

        Called by the migration runtime after its WAL record is durable and
        BEFORE ``ts`` publishes (record-before-publish, like lineage), and
        by ``attach_shard_plane`` replaying a recovered store's placement
        log.  Destination shard indices are folded ``% n_shards`` so a log
        recorded on a larger plane re-attaches deterministically to a
        smaller one (restoration is exact when the shard count matches).
        """
        with self._lock:
            prev_ts, prev = self._epochs[-1]
            if ts <= prev_ts:
                raise ValueError(
                    f"placement epoch {ts} not after newest epoch {prev_ts}"
                )
            if moves:
                self._extend_locked(max(int(s) for s in moves) + 1)
                prev = self._epochs[-1][1]
            nxt = prev.copy()
            for sid, k in moves.items():
                nxt[int(sid)] = int(k) % self.n_shards
            self._epochs.append((int(ts), nxt))
            weights = np.array(
                [c.head.n_edges for c in self.store.chains], np.int64
            )
            lim = min(len(weights), len(nxt))
            self._loads = np.bincount(
                nxt[:lim], weights=weights[:lim], minlength=self.n_shards
            ).astype(np.int64)

    def placement_epochs(self) -> List[tuple]:
        """Snapshot of the epoch history: ``[(epoch_ts, placement), ...]``."""
        with self._lock:
            return [(ts, arr.copy()) for ts, arr in self._epochs]

    # -- residency -----------------------------------------------------------
    def _fetch(self, snap, k: int, fetch_fn) -> tuple:
        """One subgraph's tiles on shard ``k``, upload-counted + stamped."""
        from . import device_cache

        tiles, nbytes = fetch_fn(snap, k, self.devices[k])
        if not device_cache.tiles_fresh(snap):
            raise RuntimeError(
                f"subgraph {snap.sid} shard tiles went stale during assembly "
                "(pool-row generation advanced under a live snapshot)"
            )
        if nbytes:
            with self._lock:
                self.stats.uploads[k] += 1
                self.stats.bytes_uploaded[k] += nbytes
        return tiles

    # -- assembly ------------------------------------------------------------
    def _kind_params(self, kind: str):
        """(fetch function, capacity floor, pad value per column, valid?)."""
        from . import device_cache

        if kind == "coo":
            return device_cache.shard_coo_tiles, self._COO_FLOOR, (SENTINEL, SENTINEL), True
        return (device_cache.shard_leaf_tiles, self._BLK_FLOOR,
                (SENTINEL, SENTINEL, 0), False)

    def _pack(self, parts: List[tuple], k: int, kind: str, cap: int, B: int, device):
        """Shard ``k``'s columns: the ``parts`` (tuples of live column
        pieces) concatenated straight into fresh ``[cap, ...]`` buffers on
        ``device`` filled with the pad values; returns ``(cols, valid)``.
        No piece is aliased, so the bundle owns its memory."""
        _, _, pad_vals, with_valid = self._kind_params(kind)
        tails = ((), ()) if kind == "coo" else ((), (B,), ())
        n_live = sum(int(p[0].shape[0]) for p in parts)
        cols = []
        for i, (pv, tail) in enumerate(zip(pad_vals, tails)):
            buf = torch.full((cap,) + tail, int(pv), dtype=torch.int32, device=device)
            pieces = [p[i] for p in parts if p[i].shape[0]]
            if pieces:
                torch.cat(pieces, out=buf[:n_live])
            cols.append(buf)
        valid = None
        if with_valid:
            valid = torch.arange(cap, device=device) < n_live
        return tuple(cols), valid

    def _repad(self, pred_shard: ShardBundle, k: int, kind: str, cap: int, B: int):
        """A clean shard re-padded to a grown capacity on its own device."""
        cols, valid = self._pack([pred_shard.live()], k, kind, cap, B, pred_shard.device)
        with self._lock:
            self.stats.repads += 1
        return ShardBundle(pred_shard.device, pred_shard.sids, pred_shard.offsets,
                           pred_shard.n_live, cap, cols, valid)

    def _bundle_of(self, k: int, fk: Dict[int, tuple], kind: str, cap: int, B: int):
        """Shard ``k`` built from its subgraphs' tiles ``fk`` (sid -> tiles)."""
        sids = np.asarray(sorted(fk), np.int64)
        counts = [int(fk[int(s)][0].shape[0]) for s in sids]
        offsets = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        cols, valid = self._pack([fk[int(s)] for s in sids], k, kind, cap, B,
                                 self.devices[k])
        return ShardBundle(self.devices[k], sids, offsets, int(offsets[-1]), cap,
                           cols, valid)

    def _build_full(self, view, placement: np.ndarray, kind: str) -> ShardedKind:
        fetch_fn, floor, _, _ = self._kind_params(kind)
        S = len(view.snaps)
        fetched: List[Dict[int, tuple]] = [{} for _ in range(self.n_shards)]
        seg_counts = np.zeros(S, np.int64)
        for sid, snap in enumerate(view.snaps):
            k = int(placement[sid])
            if not self.is_local(k):
                seg_counts[sid] = _host_count(snap, kind)
                continue
            tiles = self._fetch(snap, k, fetch_fn)
            fetched[k][sid] = tiles
            seg_counts[sid] = int(tiles[0].shape[0])
        lives = [int(sum(int(t[0].shape[0]) for t in fetched[k].values()))
                 for k in self._local]
        cap = _round_cap(max(lives), floor)
        shards = [self._bundle_of(k, fetched[k], kind, cap, view.B)
                  if self.is_local(k) else None for k in range(self.n_shards)]
        with self._lock:
            self.stats.full_builds += 1
        return ShardedKind(cap, shards, seg_counts)

    def _splice_kind(
        self,
        view,
        placement: np.ndarray,
        pred_kind: ShardedKind,
        pred_S: int,
        dirty: Sequence[int],
        kind: str,
    ) -> ShardedKind:
        fetch_fn, floor, _, _ = self._kind_params(kind)
        S = len(view.snaps)
        seg_counts = np.zeros(S, np.int64)
        seg_counts[:pred_S] = pred_kind.seg_counts[:pred_S]
        # fetch fresh segments, grouped by shard
        fresh: Dict[int, Dict[int, tuple]] = {}
        for sid in dirty:
            k = int(placement[sid])
            if not self.is_local(k):
                seg_counts[sid] = _host_count(view.snaps[sid], kind)
                continue
            tiles = self._fetch(view.snaps[sid], k, fetch_fn)
            fresh.setdefault(k, {})[sid] = tiles
            seg_counts[sid] = int(tiles[0].shape[0])
        # sid -> index maps, built only for shards with fresh segments:
        # clean shards never consult them, and building all K would cost
        # O(S) host work per splice regardless of the dirty count
        pred_pos_all = {
            k: {int(s): i for i, s in enumerate(pred_kind.shards[k].sids)}
            for k in fresh
        }

        def old_count(k, sid):
            i = pred_pos_all[k].get(sid)
            offs = pred_kind.shards[k].offsets
            return int(offs[i + 1] - offs[i]) if i is not None else 0

        lives = [
            pred_kind.shards[k].n_live + sum(
                int(t[0].shape[0]) - old_count(k, sid)
                for sid, t in fresh.get(k, {}).items())
            for k in self._local
        ]
        cap = max(pred_kind.cap, _round_cap(max(lives), floor))
        shards: List[Optional[ShardBundle]] = []
        n_spliced = 0
        for k in range(self.n_shards):
            pred_shard = pred_kind.shards[k]
            if pred_shard is None:  # another rank's shard
                shards.append(None)
                continue
            fresh_k = fresh.get(k, {})
            if not fresh_k:
                if cap == pred_kind.cap:
                    shards.append(pred_shard)  # wholesale reuse, zero work
                    with self._lock:
                        self.stats.shard_reuses += 1
                else:
                    shards.append(self._repad(pred_shard, k, kind, cap, view.B))
                continue
            n_spliced += len(fresh_k)
            pred_pos = pred_pos_all[k]
            # this shard's sids after the splice (pred set + appended tail)
            sids_k = np.asarray(
                sorted(set(pred_shard.sids.tolist()) | set(fresh_k)), np.int64
            )
            counts = [
                int(fresh_k[int(s)][0].shape[0]) if int(s) in fresh_k
                else old_count(k, int(s))
                for s in sids_k
            ]
            offsets = np.zeros(len(counts) + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            n_live = int(offsets[-1])
            same_layout = (
                cap == pred_kind.cap
                and len(sids_k) == len(pred_shard.sids)
                and all(int(s) in pred_pos for s in sids_k)
                and all(int(t[0].shape[0]) == old_count(k, sid)
                        for sid, t in fresh_k.items())
            )
            if same_layout:
                # patch a clone: the pad region and valid mask carry over,
                # the predecessor's tensors stay as older views see them
                cols = []
                for i, col in enumerate(pred_shard.cols):
                    base = col.clone()
                    for sid in sorted(fresh_k):
                        seg = fresh_k[sid][i]
                        lo = int(pred_shard.offsets[pred_pos[sid]])
                        base[lo: lo + seg.shape[0]] = seg
                    cols.append(base)
                shards.append(ShardBundle(
                    pred_shard.device, sids_k, offsets, n_live, cap,
                    tuple(cols), pred_shard.valid,
                ))
                continue
            # O(dirty)-run rebuild: fresh segments interleave with runs of
            # the pred live prefix; consecutive clean sids collapse into
            # one contiguous pred slice (their pred positions are adjacent,
            # so their offsets span one interval)
            parts: List[tuple] = []
            i = 0
            while i < len(sids_k):
                sid = int(sids_k[i])
                if sid in fresh_k:
                    parts.append(fresh_k[sid])
                    i += 1
                    continue
                j = i
                while (
                    j + 1 < len(sids_k)
                    and int(sids_k[j + 1]) not in fresh_k
                    and pred_pos[int(sids_k[j + 1])] == pred_pos[int(sids_k[j])] + 1
                ):
                    j += 1
                lo = int(pred_shard.offsets[pred_pos[sid]])
                hi = int(pred_shard.offsets[pred_pos[int(sids_k[j])] + 1])
                parts.append(tuple(c[lo:hi] for c in pred_shard.cols))
                i = j + 1
            cols, valid = self._pack(parts, k, kind, cap, view.B, pred_shard.device)
            shards.append(ShardBundle(
                pred_shard.device, sids_k, offsets, n_live, cap, cols, valid
            ))
        with self._lock:
            self.stats.splices += 1
            self.stats.spliced_segments += n_spliced
        return ShardedKind(cap, shards, seg_counts)

    def _rebuild_moved(
        self,
        view,
        placement: np.ndarray,
        pred_kind: ShardedKind,
        pred_placement: np.ndarray,
        pred_S: int,
        dirty: Sequence[int],
        kind: str,
    ) -> ShardedKind:
        """Cross-epoch splice: predecessor from an older placement epoch.

        Only the shards a migration or commit actually touched rebuild —
        the source and destination shard of every moved subgraph, plus the
        shard of every lineage-dirty or appended subgraph; every other
        shard's tensors are reused by object identity.  Touched shards
        refetch all of their subgraphs' tiles, which is a per-(snapshot,
        shard) cache hit for every clean already-resident subgraph and an
        upload only for the moved/dirty ones (the migration runtime
        pre-stages the moved tiles, so even those are usually hits).
        """
        fetch_fn, floor, _, _ = self._kind_params(kind)
        S = len(view.snaps)
        lim = min(int(pred_S), S)
        moved = [
            sid for sid in range(lim)
            if int(pred_placement[sid]) != int(placement[sid])
        ]
        touched = {int(placement[s]) for s in list(dirty) + moved}
        touched |= {int(pred_placement[s]) for s in moved}
        touched &= self._local
        seg_counts = np.zeros(S, np.int64)
        seg_counts[:lim] = pred_kind.seg_counts[:lim]
        for sid in list(dirty) + list(range(lim, S)):
            if not self.is_local(int(placement[sid])):
                seg_counts[sid] = _host_count(view.snaps[sid], kind)
        fetched: Dict[int, Dict[int, tuple]] = {k: {} for k in touched}
        for sid in range(S):
            k = int(placement[sid])
            if k in fetched:
                tiles = self._fetch(view.snaps[sid], k, fetch_fn)
                fetched[k][sid] = tiles
                seg_counts[sid] = int(tiles[0].shape[0])
        lives_touched = [
            sum(int(t[0].shape[0]) for t in fk.values())
            for fk in fetched.values()
        ]
        cap = max(
            pred_kind.cap,
            _round_cap(max(lives_touched) if lives_touched else 0, floor),
        )
        shards: List[Optional[ShardBundle]] = []
        for k in range(self.n_shards):
            pred_shard = pred_kind.shards[k]
            if pred_shard is None:  # another rank's shard
                shards.append(None)
            elif k in touched:
                shards.append(self._bundle_of(k, fetched[k], kind, cap, view.B))
            elif cap == pred_kind.cap:
                # no subgraph moved in or out and none dirty: this shard's
                # sid set and contents are unchanged across the epoch flip
                shards.append(pred_shard)
                with self._lock:
                    self.stats.shard_reuses += 1
            else:
                shards.append(self._repad(pred_shard, k, kind, cap, view.B))
        with self._lock:
            self.stats.migration_rebuilds += 1
        return ShardedKind(cap, shards, seg_counts)

    def _sharded_kind(self, view, kind: str) -> ShardedKind:
        from . import view_assembler

        a = view_assembler._bundle(view)
        sh = a.sharded
        S = len(view.snaps)
        # versioned placement: resolve the epoch current at THIS view's
        # timestamp, so a migration flip never changes an older view
        placement = self.placement_at(view.ts, S)
        RESHARD_HOOKS.fire("hook_before_assembly", ts=view.ts, kind=kind)
        if sh is None:
            sh = ShardedViewAssembly(view.ts, S, np.array(placement))
            a.sharded = sh
        cur = getattr(sh, kind)
        if cur is not None:
            return cur
        with self._lock:
            self.stats.assemblies += 1
        plan = view_assembler._plan(view)
        pred_kind = None
        pred_moved = None  # predecessor from an older placement epoch
        pred_S = 0
        if plan is not None:
            pred_b, dirty = plan
            psh = pred_b.sharded
            cand = getattr(psh, kind, None) if psh is not None else None
            if (
                cand is not None
                and psh.placement is not None
                and len(psh.placement) <= S
                # the bundle must have been built against THIS plane's
                # shards: a re-attached plane with a different shard count
                # or device order cannot splice (or reuse) the old tensors
                and len(cand.shards) == self.n_shards
                and all((b is None) != self.is_local(k) and (b is None or b.device == d)
                        for k, (b, d) in enumerate(zip(cand.shards, self.devices)))
            ):
                if np.array_equal(psh.placement, placement[: len(psh.placement)]):
                    pred_kind = cand
                    pred_S = psh.S
                else:
                    # the predecessor was assembled under a different
                    # placement epoch: its untouched shards are still
                    # reusable, only migrated/dirty shards rebuild
                    pred_moved = (cand, psh.placement, psh.S)
        if pred_kind is not None:
            if not dirty and pred_S == S:
                setattr(sh, kind, pred_kind)  # wholesale bundle reuse
                with self._lock:
                    self.stats.reuses += 1
                return pred_kind
            built = self._splice_kind(view, placement, pred_kind, pred_S, dirty, kind)
        elif pred_moved is not None:
            built = self._rebuild_moved(
                view, placement, pred_moved[0], pred_moved[1], pred_moved[2],
                dirty, kind,
            )
        else:
            built = self._build_full(view, placement, kind)
        setattr(sh, kind, built)
        return built

    def sharded_coo(self, view) -> ShardedKind:
        """The view's per-shard padded (src, dst, valid) COO bundles."""
        return self._sharded_kind(view, "coo")

    def sharded_blocks(self, view) -> ShardedKind:
        """The view's per-shard padded (src, rows, length) leaf-tile bundles."""
        return self._sharded_kind(view, "blocks")

    # -- collectives ---------------------------------------------------------
    def _dispatch(self, fn: Callable, *args):
        """Run one collective, counted in ``stats.collective_calls`` (the
        entry point's ``query`` span covers it, with ``n_shards``)."""
        with self._lock:
            self.stats.collective_calls += 1
        return fn(*args)

    @staticmethod
    def _coo_lists(coo: ShardedKind) -> tuple:
        """Per-shard (srcs, dsts, valids): each of this process's shards'
        live prefix, in shard order."""
        srcs, dsts, valids = [], [], []
        for s in coo.shards:
            if s is None:
                continue
            src, dst = s.live()
            srcs.append(src)
            dsts.append(dst)
            valids.append(s.valid[: s.n_live])
        return srcs, dsts, valids

    def pagerank(self, view, iters: int = 10, damping: float = 0.85,
                 pull: Optional[bool] = None):
        """Collective PageRank over pinned shard tiles (module docstring
        covers the pull-vs-push choice and the bitwise contract); ``pull``
        picks the form, by default pull on a symmetric plane, else push."""
        from . import distributed

        coo = self.sharded_coo(view)
        pull = self.symmetric if pull is None else bool(pull)
        fn = distributed.make_pagerank(view.n_vertices, iters=iters, damping=damping,
                                       pull=pull, ranks=self.ranks)
        return self._dispatch(fn, *self._coo_lists(coo))

    def bfs(self, view, root: int):
        """Collective level-synchronous BFS (bitwise-equal to ``bfs_view``)."""
        from . import distributed

        coo = self.sharded_coo(view)
        fn = distributed.make_bfs(view.n_vertices, ranks=self.ranks)
        return self._dispatch(fn, *self._coo_lists(coo), int(root))

    def _shard_edge_operand(self, coo: ShardedKind, w) -> list:
        """Slice a per-edge operand (global COO order) onto the shards.

        Global order is ascending-sid segments; each shard holds its sids'
        segments in ascending order, so live slot ``j`` of a shard whose
        ``i``-th segment starts at local offset ``offsets[i]`` holds global
        edge ``g_off[sid_i] - offsets[i] + j``: one gather per shard, its
        index built on ``w``'s device from the per-segment starts.  ``w``
        may be a host array or a tensor on any device; uploaded per call
        (weights change per query) and counted in ``stats.operand_uploads``.
        """
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        w = w.to(torch.float32)
        g_off = np.zeros(len(coo.seg_counts) + 1, np.int64)
        np.cumsum(coo.seg_counts, out=g_off[1:])
        if int(w.shape[0]) != int(g_off[-1]):
            raise ValueError(
                f"edge operand length {int(w.shape[0])} != n_edges {int(g_off[-1])}"
            )
        parts = []
        for shard in coo.shards:
            if shard is None:
                continue
            shift = torch.from_numpy(g_off[shard.sids] - shard.offsets[:-1]).to(w.device)
            counts = torch.from_numpy(np.diff(shard.offsets)).to(w.device)
            idx = torch.repeat_interleave(shift, counts, output_size=shard.n_live)
            idx += torch.arange(shard.n_live, device=w.device)
            parts.append(w[idx].to(shard.device))
        with self._lock:
            self.stats.operand_uploads += len(parts)
        return parts

    def sssp(self, view, w, root: int):
        """Collective Bellman-Ford (bitwise-equal to ``sssp_view``); ``w``
        follows the global COO edge order, as for the single-device route."""
        from . import distributed

        coo = self.sharded_coo(view)
        ws = self._shard_edge_operand(coo, w)
        fn = distributed.make_sssp(view.n_vertices, ranks=self.ranks)
        srcs, dsts, valids = self._coo_lists(coo)
        return self._dispatch(fn, srcs, dsts, valids, ws, int(root))

    def wcc(self, view):
        """Collective WCC: both edge directions propagate locally, the
        min-merge is order-free — bitwise-equal to ``wcc_view``."""
        from . import distributed

        coo = self.sharded_coo(view)
        fn = distributed.make_wcc(view.n_vertices, ranks=self.ranks)
        return self._dispatch(fn, *self._coo_lists(coo))

    def spmm(self, view, h):
        """Collective per-vertex SpMM over pinned leaf tiles.

        Each shard runs ``leaf_spmm`` — the hand-written kernel on the card
        — over its own tiles (each read over its live length); the compact
        ``[tiles, d]`` outputs and their sources then go to the first
        shard's device (:attr:`home`) and sum by source vertex there, in
        shard order, with ``index_add_`` into one output; across processes
        the ranks' outputs then add with one all-reduce.  Every source
        vertex lives on exactly one shard, so each vertex's tiles add in
        the single-device route's order and the other shards add zeros.
        """
        from ..kernels.spmm import leaf_spmm
        from ..launch.collectives import merge, replicate

        blocks = self.sharded_blocks(view)
        n = view.n_vertices
        h = torch.as_tensor(h, dtype=torch.float32)
        hs = replicate(h, self.devices)
        home = self.home

        def run():
            out = torch.zeros((n, h.shape[1]), dtype=torch.float32, device=home)
            for shard, hk in zip(blocks.shards, hs):
                if shard is None or not shard.n_live:
                    continue
                src, rows, length = shard.live()
                y = leaf_spmm(rows, hk, length)  # launches on the shard's card
                out.index_add_(0, src.to(home), y.to(home))
            return merge([out], torch.add, self.ranks)  # other ranks add zeros

        return self._dispatch(run)


__all__ = [
    "ShardBundle",
    "ShardPlane",
    "ShardPlaneStats",
    "ShardedKind",
    "ShardedViewAssembly",
    "active_plane",
    "degree_balanced_placement",
    "enabled",
    "modulo_placement",
]
