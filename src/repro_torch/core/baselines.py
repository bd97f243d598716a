"""In-repo baselines the paper compares against (§3, §7.5 ablation).

- :class:`CSRGraph` — the static optimum (paper Table 2/4 "CSR" rows).
- :class:`PerEdgeVersionedAdjacency` — a Sortledton-like store: sorted
  per-vertex adjacency with a version record per edge and 2PL vertex locks;
  every scan/search pays a per-edge version check (the overhead quantified
  in paper Table 1).
- :class:`VecStore` — subgraph-centric concurrency + exact per-vertex vectors
  for low-degree neighbors (the paper's "VEC" ablation row): compact but
  scattered allocations, contrasted with the clustered index.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .clock import LogicalClock


# ---------------------------------------------------------------------------
# CSR static baseline
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CSRGraph:
    offsets: np.ndarray  # int64 [n + 1]
    indices: np.ndarray  # int32 [m], sorted per segment

    @classmethod
    def from_edges(cls, n: int, edges: np.ndarray, undirected: bool = False) -> "CSRGraph":
        edges = np.asarray(edges, np.int64)
        if undirected and len(edges):
            edges = np.concatenate([edges, edges[:, ::-1]])
        if len(edges) == 0:
            return cls(np.zeros(n + 1, np.int64), np.empty(0, np.int32))
        key = (edges[:, 0] << 32) | edges[:, 1]
        key = np.unique(key)
        u = (key >> 32).astype(np.int64)
        v = (key & 0xFFFFFFFF).astype(np.int32)
        deg = np.bincount(u, minlength=n)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=offsets[1:])
        return cls(offsets, v)

    @property
    def n_vertices(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.offsets[u] : self.offsets[u + 1]]

    def search(self, u: int, v: int) -> bool:
        seg = self.neighbors(u)
        pos = int(np.searchsorted(seg, v))
        return pos < len(seg) and seg[pos] == v

    def search_many(self, us: np.ndarray, vs: np.ndarray) -> np.ndarray:
        lo = self.offsets[us]
        hi = self.offsets[us + 1]
        out = np.zeros(len(us), bool)
        for i in range(len(us)):
            seg = self.indices[lo[i] : hi[i]]
            pos = np.searchsorted(seg, vs[i])
            out[i] = pos < len(seg) and seg[pos] == vs[i]
        return out


# ---------------------------------------------------------------------------
# Per-edge versioned store (Sortledton-like)
# ---------------------------------------------------------------------------
class PerEdgeVersionedAdjacency:
    """Per-edge MVCC adjacency: the design the paper improves upon.

    Each vertex stores parallel arrays (neighbor id, created_ts, deleted_ts),
    sorted by neighbor id.  Readers/writers both lock the vertex (2PL); every
    edge access performs the version-window check ``created <= t < deleted``.
    """

    LIVE = np.int64(np.iinfo(np.int64).max)

    def __init__(self, n_vertices: int) -> None:
        self.n = n_vertices
        self.vals: List[np.ndarray] = [np.empty(0, np.int32) for _ in range(n_vertices)]
        self.created: List[np.ndarray] = [np.empty(0, np.int64) for _ in range(n_vertices)]
        self.deleted: List[np.ndarray] = [np.empty(0, np.int64) for _ in range(n_vertices)]
        self.locks = [threading.Lock() for _ in range(n_vertices)]
        self.clock = LogicalClock()

    @classmethod
    def from_edges(cls, n: int, edges: np.ndarray, undirected: bool = False):
        g = CSRGraph.from_edges(n, edges, undirected=undirected)
        store = cls(n)
        for u in range(n):
            nbr = g.neighbors(u)
            store.vals[u] = nbr.copy()
            store.created[u] = np.zeros(len(nbr), np.int64)
            store.deleted[u] = np.full(len(nbr), cls.LIVE, np.int64)
        return store

    # -- writes (2PL on vertices, ids ordered) --------------------------------
    def insert_edges(self, edges: np.ndarray) -> int:
        edges = np.atleast_2d(np.asarray(edges, np.int64))
        us = sorted(set(edges[:, 0].tolist()))
        for u in us:
            self.locks[u].acquire()
        try:
            t = self.clock.next_commit_timestamp()
            for u in us:
                vs = edges[edges[:, 0] == u, 1].astype(np.int32)
                for v in np.sort(vs):
                    self._insert_one(int(u), int(v), t)
            self.clock.publish(t)
            return t
        finally:
            for u in reversed(us):
                self.locks[u].release()

    def _insert_one(self, u: int, v: int, t: int) -> None:
        vals = self.vals[u]
        pos = int(np.searchsorted(vals, v))
        if pos < len(vals) and vals[pos] == v and self.deleted[u][pos] == self.LIVE:
            return  # live duplicate
        if pos < len(vals) and vals[pos] == v:
            # re-insert after delete: new version record appended at same key
            self.deleted[u] = np.insert(self.deleted[u], pos, self.LIVE)
            self.created[u] = np.insert(self.created[u], pos, t)
            self.vals[u] = np.insert(vals, pos, v)
            return
        self.vals[u] = np.insert(vals, pos, v)
        self.created[u] = np.insert(self.created[u], pos, t)
        self.deleted[u] = np.insert(self.deleted[u], pos, self.LIVE)

    def delete_edges(self, edges: np.ndarray) -> int:
        edges = np.atleast_2d(np.asarray(edges, np.int64))
        us = sorted(set(edges[:, 0].tolist()))
        for u in us:
            self.locks[u].acquire()
        try:
            t = self.clock.next_commit_timestamp()
            for u in us:
                vs = edges[edges[:, 0] == u, 1]
                for v in vs:
                    vals = self.vals[u]
                    idx = np.nonzero((vals == v) & (self.deleted[u] == self.LIVE))[0]
                    if len(idx):
                        self.deleted[u][idx[0]] = t
            self.clock.publish(t)
            return t
        finally:
            for u in reversed(us):
                self.locks[u].release()

    # -- reads (shared lock + per-edge version checks) --------------------------
    def scan(self, u: int, t: int | None = None) -> np.ndarray:
        if t is None:
            t = self.clock.read_timestamp()
        with self.locks[u]:
            live = (self.created[u] <= t) & (t < self.deleted[u])
            return self.vals[u][live].copy()

    def search(self, u: int, v: int, t: int | None = None) -> bool:
        if t is None:
            t = self.clock.read_timestamp()
        with self.locks[u]:
            vals = self.vals[u]
            pos = int(np.searchsorted(vals, v))
            while pos < len(vals) and vals[pos] == v:
                if self.created[u][pos] <= t < self.deleted[u][pos]:
                    return True
                pos += 1
            return False

    def memory_bytes(self) -> int:
        return sum(
            self.vals[u].nbytes + self.created[u].nbytes + self.deleted[u].nbytes
            for u in range(self.n)
        )

    def gc(self) -> None:
        """Drop version records no reader can need (min active ts = t_r)."""
        t = self.clock.read_timestamp()
        for u in range(self.n):
            with self.locks[u]:
                keep = ~(self.deleted[u] <= t)
                self.vals[u] = self.vals[u][keep]
                self.created[u] = self.created[u][keep]
                self.deleted[u] = self.deleted[u][keep]


# ---------------------------------------------------------------------------
# VEC ablation store: SC concurrency + exact per-vertex vectors
# ---------------------------------------------------------------------------
class VecStore:
    """Subgraph-centric versioning with per-vertex exact-size vectors.

    Matches RapidStore's concurrency control but replaces C-ART + clustered
    index with one compact numpy vector per vertex (the paper's VEC row in
    Table 6): best-case memory per set, worst-case allocation scatter.
    """

    def __init__(self, n_vertices: int, partition_size: int = 64) -> None:
        self.n = n_vertices
        self.p = partition_size
        self.n_subgraphs = -(-n_vertices // partition_size)
        # one dict version per subgraph: local_u -> sorted np.ndarray
        self.heads: List[Dict[int, np.ndarray]] = [dict() for _ in range(self.n_subgraphs)]
        self.locks = [threading.Lock() for _ in range(self.n_subgraphs)]
        self.clock = LogicalClock()

    @classmethod
    def from_edges(cls, n: int, edges: np.ndarray, partition_size: int = 64):
        g = CSRGraph.from_edges(n, edges)
        store = cls(n, partition_size)
        for u in range(n):
            nbr = g.neighbors(u)
            if len(nbr):
                store.heads[u // store.p][u % store.p] = nbr.copy()
        return store

    def insert_edges(self, edges: np.ndarray) -> int:
        edges = np.atleast_2d(np.asarray(edges, np.int64))
        sids = sorted(set((edges[:, 0] // self.p).tolist()))
        for sid in sids:
            self.locks[sid].acquire()
        try:
            t = self.clock.next_commit_timestamp()
            for sid in sids:
                m = edges[:, 0] // self.p == sid
                new_version = dict(self.heads[sid])  # COW of the subgraph map
                for u, v in edges[m]:
                    lu = int(u % self.p)
                    cur = new_version.get(lu, np.empty(0, np.int32))
                    pos = int(np.searchsorted(cur, v))
                    if pos < len(cur) and cur[pos] == v:
                        continue
                    new_version[lu] = np.insert(cur, pos, np.int32(v))
                self.heads[sid] = new_version
            self.clock.publish(t)
            return t
        finally:
            for sid in reversed(sids):
                self.locks[sid].release()

    def scan(self, u: int) -> np.ndarray:
        return self.heads[u // self.p].get(u % self.p, np.empty(0, np.int32))

    def search(self, u: int, v: int) -> bool:
        seg = self.scan(u)
        pos = int(np.searchsorted(seg, v))
        return pos < len(seg) and seg[pos] == v

    def memory_bytes(self) -> int:
        total = 0
        for h in self.heads:
            for arr in h.values():
                total += arr.nbytes + 112  # numpy object overhead per vector
        return total
