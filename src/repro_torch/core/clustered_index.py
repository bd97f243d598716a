"""Clustered index for low-degree vertices (paper §6.3).

All low-degree neighbor sets of one subgraph are stored contiguously in
``(u, v)`` order: ``offsets[local_u] .. offsets[local_u + 1]`` slices a packed
sorted ``values`` array.  The paper realizes this as a two-level B+ tree; with
|P| = 64 local vertices the "tree" collapses to exactly this offsets/values
pair (a one-node B+ tree), which is also the ideal TPU layout — scanning a
subgraph's low-degree population is one contiguous read.

Functional: updates return a new ClusteredIndex (COW of the packed segment —
the analogue of the paper's path copy; bounded by |P| × degree_threshold).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .arrays import sorted_unique


@dataclass(frozen=True)
class ClusteredIndex:
    offsets: np.ndarray  # int32 [P + 1], monotone
    values: np.ndarray  # int32 [m], per-vertex segments sorted

    @property
    def n_vertices(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_edges(self) -> int:
        return len(self.values)


def empty(p: int) -> ClusteredIndex:
    return ClusteredIndex(np.zeros(p + 1, np.int32), np.empty(0, np.int32))


def build(p: int, local_u: np.ndarray, vs: np.ndarray) -> ClusteredIndex:
    """Bulk-build from (local_u, v) pairs; sorts into clustered (u, v) order."""
    local_u = np.asarray(local_u, np.int64)
    vs = np.asarray(vs, np.int32)
    order = np.lexsort((vs, local_u))
    local_u, vs = local_u[order], vs[order]
    counts = np.bincount(local_u, minlength=p).astype(np.int32)
    offsets = np.zeros(p + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return ClusteredIndex(offsets, vs)


def neighbors(ci: ClusteredIndex, local_u: int) -> np.ndarray:
    return ci.values[ci.offsets[local_u] : ci.offsets[local_u + 1]]


def degree(ci: ClusteredIndex, local_u: int) -> int:
    return int(ci.offsets[local_u + 1] - ci.offsets[local_u])


def degrees(ci: ClusteredIndex) -> np.ndarray:
    return np.diff(ci.offsets)


def search(ci: ClusteredIndex, local_u: int, v: int) -> bool:
    seg = neighbors(ci, local_u)
    pos = int(np.searchsorted(seg, v))
    return pos < len(seg) and seg[pos] == v


def apply_edits(
    ci: ClusteredIndex,
    ins_u: np.ndarray,
    ins_v: np.ndarray,
    del_u: np.ndarray,
    del_v: np.ndarray,
) -> ClusteredIndex:
    """COW batch update: returns a new index with edits applied.

    Inserting an existing edge / deleting a missing edge are no-ops (store
    semantics, §store).  One vectorized pass: tag the packed stream and the
    insert stream with (u, v) keys, merge, drop deletions and duplicates.
    """
    p = ci.n_vertices
    old_u = np.repeat(np.arange(p, dtype=np.int64), np.diff(ci.offsets))
    old_v = ci.values.astype(np.int64)
    key_old = (old_u << 32) | old_v
    parts = [key_old]
    if len(ins_u):
        parts.append((np.asarray(ins_u, np.int64) << 32) | np.asarray(ins_v, np.int64))
    keys = sorted_unique(np.concatenate(parts)) if len(parts) > 1 else key_old
    if len(del_u):
        kdel = (np.asarray(del_u, np.int64) << 32) | np.asarray(del_v, np.int64)
        keys = keys[~np.isin(keys, kdel)]
    new_u = (keys >> 32).astype(np.int64)
    new_v = (keys & 0xFFFFFFFF).astype(np.int32)
    counts = np.bincount(new_u, minlength=p).astype(np.int32)
    offsets = np.zeros(p + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return ClusteredIndex(offsets, new_v)


def extract(ci: ClusteredIndex, local_u: int) -> ClusteredIndex:
    """Remove vertex ``local_u``'s segment (promotion to C-ART)."""
    lo, hi = int(ci.offsets[local_u]), int(ci.offsets[local_u + 1])
    values = np.delete(ci.values, slice(lo, hi))
    offsets = ci.offsets.copy()
    offsets[local_u + 1 :] -= hi - lo
    return ClusteredIndex(offsets, values)


def inject(ci: ClusteredIndex, local_u: int, vs: np.ndarray) -> ClusteredIndex:
    """Insert a full sorted segment for ``local_u`` (demotion from C-ART)."""
    lo = int(ci.offsets[local_u])
    hi = int(ci.offsets[local_u + 1])
    if hi != lo:
        raise AssertionError("inject into non-empty segment")
    values = np.insert(ci.values, lo, vs)
    offsets = ci.offsets.copy()
    offsets[local_u + 1 :] += len(vs)
    return ClusteredIndex(offsets, values)


def check_invariants(ci: ClusteredIndex) -> None:
    if ci.offsets[0] != 0 or ci.offsets[-1] != len(ci.values):
        raise AssertionError("offset bounds broken")
    if np.any(np.diff(ci.offsets) < 0):
        raise AssertionError("offsets not monotone")
    for u in range(ci.n_vertices):
        seg = neighbors(ci, u).astype(np.int64)
        if len(seg) > 1 and not np.all(np.diff(seg) > 0):
            raise AssertionError(f"segment of {u} not strictly sorted")
