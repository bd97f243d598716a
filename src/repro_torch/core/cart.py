"""C-ART: compressed adaptive radix tree, TPU-adapted (paper §6.2), with
per-degree leaf tiers.

The paper's C-ART stores a high-degree neighbor set N(u) as a radix tree whose
*leaves are horizontally compressed*: up to ``B`` sorted vertex IDs per leaf.
Interior nodes exist only to route a 4-byte key to its leaf.

TPU adaptation (see DESIGN.md §2): with 4-byte keys and B >= 256, the interior
radix structure routes among at most ``ceil(d/(B/2))`` leaves — a *sorted
directory* ``leaf_min[i] = min key of leaf i`` is an exact, dense replacement
for the pointer-chased descent: ``searchsorted(leaf_min, v)`` IS the radix
descent, vectorizes on the VPU, and keeps the same O(w + log B) search bound.
Leaves are pooled rows (:mod:`repro_torch.core.leaf_pool`), so scans are contiguous
``[n, B]`` tiles — the property the paper's leaf compression buys.

The tier contract (skew-adaptive leaf width)
--------------------------------------------

Leaf width is a per-vertex *tier*, not a global constant: every
:class:`CartDir` carries a ``tier`` tag — the leaf width of the one
:class:`~repro_torch.core.leaf_pool.LeafPool` subpool all of its rows live in.
Each function here resolves that subpool once at entry (``_sub``), so the
descent, COW insert/delete, split/merge, and refcount paths below are
plain single-B code against the resolved pool; the tag is what makes a
mixed-tier store's directories self-describing.  ``leaf_ids`` are LOCAL to
the tier's subpool: numeric row-id comparisons between directories are only
meaningful at equal tier, so the shared-row set ops (:func:`free_exclusive`,
:func:`incref_shared`) treat different-tier directories as fully disjoint —
which they are, because a tier migration (compactor repack) rebuilds every
leaf in the new tier's subpool.  The tier is chosen from observed degree at
build/promotion time (``pool.tier_for_degree``) and only changes at repack,
behind the hysteresis band documented in :mod:`repro_torch.core.leaf_pool`.

Reference-counting contract (multi-version semantics, paper §6.4):

- every snapshot *version* owns exactly one reference to each row its
  directories contain (in that row's own tier subpool);
- COW ops (`insert*`, `delete*`) allocate replacement rows with refcount 1
  (owned by the version under construction) and NEVER decref replaced rows —
  those still belong to the predecessor version;
- reclaiming a version calls :func:`free` (decref all rows); discarding a
  partially-built directory calls :func:`free_exclusive` against its base.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .arrays import sorted_unique
from .leaf_pool import LeafPool


@dataclass(frozen=True)
class CartDir:
    """Directory of one vertex's C-ART: parallel arrays of leaf rows.

    ``leaf_ids[i]`` is a row of the ``tier``-wide subpool; ``leaf_min[i]``
    its smallest key.  Leaves partition the sorted neighbor set into
    consecutive key ranges.  ``tier`` is the leaf width — all rows of one
    directory live in the same tier subpool (homogeneous by construction).
    """

    leaf_ids: np.ndarray  # int64 [n_leaves], local to the tier's subpool
    leaf_min: np.ndarray  # int32 [n_leaves], strictly increasing
    tier: int  # leaf width == pool.pool_for(tier).B

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_ids)


def _sub(pool, dir_: CartDir) -> LeafPool:
    """The single-tier subpool this directory's rows live in."""
    return pool.pool_for(dir_.tier)


def build(pool, values: np.ndarray, fill: float = 1.0,
          tier: Optional[int] = None) -> CartDir:
    """Bulk-build a C-ART from a sorted unique ``values`` array.

    ``fill`` is the target leaf filling ratio (1.0 = fully packed leaves, best
    scan layout; inserts split leaves toward ~0.67 as in paper Table 3).
    ``tier`` picks the leaf width; default is the pool's degree rule
    (``tier_for_degree`` — no hysteresis: callers doing migration-aware
    rebuilds pass the resolved tier explicitly).
    """
    values = np.asarray(values, dtype=np.int32)
    d = len(values)
    if tier is None:
        tier = pool.tier_for_degree(d)
    lp = pool.pool_for(tier)
    per_leaf = max(1, min(lp.B, int(lp.B * fill)))
    if d == 0:
        row = lp.alloc(values)
        return CartDir(np.array([row], np.int64), np.array([0], np.int32), tier)
    n_leaves = -(-d // per_leaf)
    ids = np.empty(n_leaves, np.int64)
    mins = np.empty(n_leaves, np.int32)
    for i in range(n_leaves):
        chunk = values[i * per_leaf : (i + 1) * per_leaf]
        ids[i] = lp.alloc(chunk)
        mins[i] = chunk[0]
    return CartDir(ids, mins, tier)


def free(pool, dir_: CartDir) -> None:
    """Release one version's references to all rows of this directory."""
    _sub(pool, dir_).decref_many(dir_.leaf_ids)


def free_exclusive(pool, dir_: CartDir, base: CartDir) -> None:
    """Free rows of ``dir_`` that are not shared with ``base``.

    Used to discard a directory built during a transaction (e.g. demotion of
    a vertex modified earlier in the same write) without stealing the base
    version's references.  Different-tier directories share no rows (row ids
    are subpool-local), so everything in ``dir_`` is freed then.
    """
    if dir_.tier != base.tier:
        free(pool, dir_)
        return
    mine = np.setdiff1d(dir_.leaf_ids, base.leaf_ids)
    if len(mine):
        _sub(pool, dir_).decref_many(mine)


def incref(pool, dir_: CartDir) -> None:
    _sub(pool, dir_).incref_many(dir_.leaf_ids)


def incref_shared(pool, new: CartDir, base: CartDir) -> None:
    """Add the new version's reference to rows it shares with ``base``.

    Brand-new rows were allocated with refcount 1 (already owned by the new
    version); shared rows need one more reference.  Different-tier
    directories share nothing — no-op then.
    """
    if new.tier != base.tier:
        return
    shared = np.intersect1d(new.leaf_ids, base.leaf_ids)
    if len(shared):
        _sub(pool, new).incref_many(shared)


def _locate(dir_: CartDir, v: int) -> int:
    """Index of the leaf whose key range covers ``v`` (the radix descent)."""
    i = int(np.searchsorted(dir_.leaf_min, v, side="right")) - 1
    return max(i, 0)


def search(pool, dir_: CartDir, v: int) -> bool:
    """Search(u, v): directory descent + binary search within the leaf."""
    lp = _sub(pool, dir_)
    i = _locate(dir_, v)
    row = dir_.leaf_ids[i]
    n = lp.length[row]
    pos = int(np.searchsorted(lp.data[row, :n], v))
    return pos < n and lp.data[row, pos] == v


def search_many(pool, dir_: CartDir, vs: np.ndarray) -> np.ndarray:
    """Vectorized Search for a batch of candidate neighbors."""
    lp = _sub(pool, dir_)
    vs = np.asarray(vs, dtype=np.int32)
    li = np.maximum(np.searchsorted(dir_.leaf_min, vs, side="right") - 1, 0)
    rows = dir_.leaf_ids[li]
    # Padded rows end with SENTINEL > any valid id, so counting is exact.
    data = lp.data[rows]  # [q, B] gather
    pos = np.sum(data < vs[:, None], axis=1)
    inb = pos < lp.B
    found = np.zeros(len(vs), bool)
    found[inb] = data[inb, pos[inb]] == vs[inb]
    return found


def scan(pool, dir_: CartDir) -> np.ndarray:
    """Scan(u): concatenated live leaf contents, sorted."""
    lp = _sub(pool, dir_)
    rows = dir_.leaf_ids
    lens = lp.length[rows]
    out = np.empty(int(lens.sum()), np.int32)
    o = 0
    for r, n in zip(rows, lens):
        out[o : o + n] = lp.data[r, :n]
        o += n
    return out


def degree(pool, dir_: CartDir) -> int:
    return int(_sub(pool, dir_).length[dir_.leaf_ids].sum())


def insert(pool, dir_: CartDir, v: int) -> CartDir:
    """Insert(u, v) with COW (paper Fig. 7 cases). No-op returns ``dir_``.

    Case 1 (b < B): copy the leaf with v spliced in.
    Case 2/3 (b == B): split at B/2 into two leaves, insert into the half.
    The directory (= the root-to-leaf path) is copied either way; replaced
    rows keep their references (owned by the base version).
    """
    lp = _sub(pool, dir_)
    i = _locate(dir_, v)
    row = int(dir_.leaf_ids[i])
    n = int(lp.length[row])
    vals = lp.data[row, :n]
    pos = int(np.searchsorted(vals, v))
    if pos < n and vals[pos] == v:
        return dir_  # already present
    if n < lp.B:
        new_vals = np.insert(vals, pos, v)
        new_row = lp.alloc(new_vals)
        ids = dir_.leaf_ids.copy()
        mins = dir_.leaf_min.copy()
        ids[i] = new_row
        mins[i] = new_vals[0]
        return CartDir(ids, mins, dir_.tier)
    # Split at B/2 (paper Cases 2 and 3 collapse in the directory encoding:
    # "create a new internal node" == "grow the directory by one entry").
    half = lp.B // 2
    merged = np.insert(vals, pos, v)
    left, right = merged[:half], merged[half:]
    lrow, rrow = lp.alloc(left), lp.alloc(right)
    ids = np.empty(len(dir_.leaf_ids) + 1, np.int64)
    mins = np.empty(len(dir_.leaf_min) + 1, np.int32)
    ids[:i], mins[:i] = dir_.leaf_ids[:i], dir_.leaf_min[:i]
    ids[i], mins[i] = lrow, left[0]
    ids[i + 1], mins[i + 1] = rrow, right[0]
    ids[i + 2 :], mins[i + 2 :] = dir_.leaf_ids[i + 1 :], dir_.leaf_min[i + 1 :]
    return CartDir(ids, mins, dir_.tier)


def delete(pool, dir_: CartDir, v: int) -> CartDir:
    """Delete(u, v) with COW; merges under-filled leaves (paper §6.2-4)."""
    return delete_many(pool, dir_, np.array([v], np.int32))


def insert_many(pool, dir_: CartDir, vs: np.ndarray) -> CartDir:
    """Batch insert: one COW rebuild per touched leaf, splitting as needed.

    Batched writes share COW work within a leaf (paper §B.3: larger batches
    amortize the copy).
    """
    lp = _sub(pool, dir_)
    vs = sorted_unique(np.asarray(vs, dtype=np.int32))
    if len(vs) == 0:
        return dir_
    li = np.maximum(np.searchsorted(dir_.leaf_min, vs, side="right") - 1, 0)
    new_ids: list = []
    new_mins: list = []
    changed = False
    half = lp.B // 2
    for i in range(dir_.n_leaves):
        row = int(dir_.leaf_ids[i])
        add = vs[li == i]
        n = int(lp.length[row])
        if len(add) == 0:
            new_ids.append(row)
            new_mins.append(dir_.leaf_min[i])
            continue
        vals = lp.data[row, :n]
        merged = np.union1d(vals, add)  # sorted unique
        if len(merged) == n:  # all duplicates
            new_ids.append(row)
            new_mins.append(dir_.leaf_min[i])
            continue
        changed = True
        if len(merged) <= lp.B:
            chunks = [merged]
        else:  # split into >= B/2-filled leaves, paper's post-split shape
            k = -(-len(merged) // half)
            k = min(k, -(-len(merged) // 1))
            chunks = np.array_split(merged, k)
        for c in chunks:
            new_ids.append(lp.alloc(c))
            new_mins.append(c[0])
    if not changed:
        return dir_
    return CartDir(np.asarray(new_ids, np.int64), np.asarray(new_mins, np.int32),
                   dir_.tier)


def delete_many(pool, dir_: CartDir, vs: np.ndarray) -> CartDir:
    """Batch delete: one COW rebuild per touched leaf + sibling merge pass."""
    lp = _sub(pool, dir_)
    vs = sorted_unique(np.asarray(vs, dtype=np.int32))
    if len(vs) == 0:
        return dir_
    li = np.maximum(np.searchsorted(dir_.leaf_min, vs, side="right") - 1, 0)
    # Per-leaf surviving values (None = untouched leaf kept as-is).
    survived: list = []
    touched = np.zeros(dir_.n_leaves, bool)
    changed = False
    for i in range(dir_.n_leaves):
        row = int(dir_.leaf_ids[i])
        n = int(lp.length[row])
        vals = lp.data[row, :n]
        rm = vs[li == i]
        if len(rm) == 0:
            survived.append(None)
            continue
        keep = vals[~np.isin(vals, rm)]
        if len(keep) == n:
            survived.append(None)
            continue
        survived.append(keep)
        touched[i] = True
        changed = True
    if not changed:
        return dir_
    # Rebuild the directory, merging under-filled touched leaves with a
    # neighbor when the union fits in one leaf (maintains filling ratio).
    new_ids: list = []
    new_mins: list = []
    pending: np.ndarray | None = None  # values awaiting a merge decision

    def flush(valarr: np.ndarray) -> None:
        r = lp.alloc(valarr)
        new_ids.append(r)
        new_mins.append(valarr[0] if len(valarr) else 0)

    for i in range(dir_.n_leaves):
        row = int(dir_.leaf_ids[i])
        if survived[i] is None:
            vals = lp.data[row, : lp.length[row]]
            if pending is not None:
                if len(pending) + len(vals) <= lp.B:
                    flush(np.concatenate([pending, vals]))
                else:
                    flush(pending)
                    new_ids.append(row)
                    new_mins.append(dir_.leaf_min[i])
                pending = None
            else:
                new_ids.append(row)
                new_mins.append(dir_.leaf_min[i])
            continue
        keep = survived[i]
        if pending is not None:
            if len(pending) + len(keep) <= lp.B:
                pending = np.concatenate([pending, keep])
            else:
                flush(pending)
                pending = keep
        else:
            pending = keep
        if len(pending) >= lp.B // 2:
            flush(pending)
            pending = None
    if pending is not None:
        if len(pending) or not new_ids:
            flush(pending)
    # Untouched rows kept verbatim must not lose their base reference when
    # the caller later increfs shared rows; nothing to do here.
    return CartDir(np.asarray(new_ids, np.int64), np.asarray(new_mins, np.int32),
                   dir_.tier)


def check_invariants(pool, dir_: CartDir) -> None:
    lp = _sub(pool, dir_)
    if dir_.tier != lp.B:
        raise AssertionError(f"tier tag {dir_.tier} != subpool width {lp.B}")
    if dir_.n_leaves == 0:
        raise AssertionError("empty directory")
    if dir_.n_leaves > 1:
        lens = lp.length[dir_.leaf_ids]
        if np.any(lens == 0):
            raise AssertionError("empty leaf in multi-leaf directory")
        mins64 = dir_.leaf_min.astype(np.int64)
        if not np.all(np.diff(mins64) > 0):
            raise AssertionError("leaf_min not strictly increasing")
    last = -1
    for i, row in enumerate(dir_.leaf_ids):
        vals = lp.row_values(int(row))
        if len(vals) == 0:
            continue
        if vals[0] < last:
            raise AssertionError("leaf ranges overlap")
        if i > 0 and vals[0] != dir_.leaf_min[i]:
            raise AssertionError("leaf_min mismatch")
        last = int(vals[-1])
