"""The plain reference: the edge set at a timestamp, and each query's
answer over it, in plain torch on any device.

Written from the semantics the program documents, not from its code:

- ``replay``: the base edges, then every acknowledged transaction with a
  commit timestamp at or below ``ts``, in commit order (an edge's last
  operation wins);
- PageRank: push form, ``iters`` steps of ``(1 - d) / n + d (sum over
  in-edges of p[u] / outdeg[u] + dangling / n)`` from ``1 / n``, the mass
  of vertices without out-edges spread evenly;
- BFS: hop levels along out-edges from the root, -1 where unreached;
- SSSP: the least sum of weights along out-edges, each sum taken edge by
  edge in the weights' precision (float32 for the program, whose
  distances are such sums), ``inf`` where unreached;
- WCC: each vertex labelled with the least id of its weakly connected
  component;
- ``neighbor_sum``: per vertex the sum of a value over its out-neighbours
  (SpMM for rows of H, the scan for x), with the sum of magnitudes beside
  it for a scale-aware error.

Nothing here imports JAX, the JAX package or the program.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

MASK32 = (1 << 32) - 1


def replay(base_keys: torch.Tensor, txns: Iterable[Tuple[int, np.ndarray, np.ndarray]],
           ts: int) -> torch.Tensor:
    """The int64 edge keys ``(u << 32) | v`` at timestamp ``ts``: the base
    set (sorted, unique), then each transaction ``(commit_ts, inserts,
    deletes)`` with ``commit_ts <= ts`` in commit order."""
    last = {}
    for commit_ts, ins, dels in sorted(txns, key=lambda t: t[0]):
        if commit_ts <= 0 or commit_ts > ts:
            continue
        for arr, op in ((np.asarray(dels, np.int64), False), (np.asarray(ins, np.int64), True)):
            for k in ((arr[:, 0] << 32) | arr[:, 1]).tolist():
                last[k] = op
    if not last:
        return base_keys
    dev = base_keys.device
    touched = torch.tensor(sorted(last), dtype=torch.int64, device=dev)
    present = torch.tensor([last[k] for k in sorted(last)], dtype=torch.bool, device=dev)
    pos = torch.searchsorted(touched, base_keys).clamp(max=touched.numel() - 1)
    keep = touched[pos] != base_keys
    return torch.cat([base_keys[keep], touched[present]])


def split_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return keys >> 32, keys & MASK32


def pagerank(src, dst, n: int, iters: int, damping: float = 0.85,
             dtype=torch.float64) -> torch.Tensor:
    src, dst = src.long(), dst.long()
    outdeg = torch.bincount(src, minlength=n).to(dtype)
    share = torch.where(outdeg > 0, 1 / outdeg.clamp(min=1), torch.zeros((), dtype=dtype,
                                                                        device=src.device))
    p = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    d = torch.tensor(damping, dtype=dtype, device=src.device)
    for _ in range(iters):
        agg = torch.zeros(n, dtype=dtype, device=src.device).index_add_(0, dst, (p * share)[src])
        dangling = p[outdeg == 0].sum()
        p = (1 - d) / n + d * (agg + dangling / n)
    return p


def bfs(src, dst, n: int, root: int) -> torch.Tensor:
    src, dst = src.long(), dst.long()
    level = torch.full((n,), -1, dtype=torch.int32, device=src.device)
    level[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=src.device)
    frontier[root] = True
    depth = 0
    while True:
        reached = torch.zeros(n, dtype=torch.bool, device=src.device)
        reached[dst[frontier[src]]] = True
        frontier = reached & (level < 0)
        if not bool(frontier.any()):
            return level
        depth += 1
        level[frontier] = depth


def sssp(src, dst, w, n: int, root: int, dtype=torch.float32) -> torch.Tensor:
    """Bellman-Ford from the vertices that improved last round only."""
    src, dst = src.long(), dst.long()
    w = w.to(dtype)
    dist = torch.full((n,), float("inf"), dtype=dtype, device=src.device)
    dist[root] = 0
    active = torch.zeros(n, dtype=torch.bool, device=src.device)
    active[root] = True
    while bool(active.any()):
        e = active[src]
        cand = torch.full((n,), float("inf"), dtype=dtype, device=src.device)
        cand.scatter_reduce_(0, dst[e], dist[src[e]] + w[e], "amin")
        active = cand < dist
        dist = torch.where(active, cand, dist)
    return dist


def wcc(src, dst, n: int) -> torch.Tensor:
    """Least-id labels by propagation along both directions of every edge
    until nothing changes."""
    src, dst = src.long(), dst.long()
    labels = torch.arange(n, dtype=torch.int64, device=src.device)
    while True:
        new = labels.clone()
        new.scatter_reduce_(0, dst, labels[src], "amin")
        new.scatter_reduce_(0, src, labels[dst], "amin")
        if torch.equal(new, labels):
            return labels.to(torch.int32)
        labels = new


EDGE_CHUNK = 1 << 20


def neighbor_sum(src, dst, vals, n: int, rows: Optional[torch.Tensor] = None,
                 dtype=torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of magnitudes) of ``vals[v]`` over each vertex u's
    out-edges (u, v), for every vertex or for ``rows`` alone (then in the
    order of ``rows``).  ``vals`` is ``[n]`` or ``[n, d]``."""
    src, dst = src.long(), dst.long()
    if rows is not None:
        slot = torch.full((n,), -1, dtype=torch.int64, device=src.device)
        slot[rows.long()] = torch.arange(rows.numel(), device=src.device)
        sel = slot[src] >= 0
        key, dst, size = slot[src[sel]], dst[sel], rows.numel()
    else:
        key, size = src, n
    shape = (size,) + tuple(vals.shape[1:])
    total = torch.zeros(shape, dtype=dtype, device=src.device)
    mag = torch.zeros(shape, dtype=dtype, device=src.device)
    for lo in range(0, key.numel(), EDGE_CHUNK):
        v = vals[dst[lo:lo + EDGE_CHUNK]].to(dtype)
        total.index_add_(0, key[lo:lo + EDGE_CHUNK], v)
        mag.index_add_(0, key[lo:lo + EDGE_CHUNK], v.abs())
    return total, mag
