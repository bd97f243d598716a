"""Distributed analytics over sharded edge lists.

The store's subgraph partitioning is exactly a distribution unit: subgraph
``sid`` (vertex block) maps to a shard by the placement policy, so the COO
materialization of a snapshot shards by source-vertex block.  Each
``make_*`` function below returns a function over per-shard lists of
tensors (``srcs[k]`` on shard ``k``'s device): every shard reduces its
local edges into a full-width vector on its own device, and the partials
merge in shard order on the first shard's device (sum, max or min — the
vertex-cut pattern, :func:`repro_torch.launch.collectives.merge`); the
merged vector is copied back to each shard's device for the next
iteration, a no-op when the shards share one card.  Frontier and rank
vectors are replicated, edges stay on their shards, so what moves between
devices per iteration is O(n_vertices), independent of the edge count.

A shard's step is a segment reduction over its edges.  PageRank's sum is
``index_add_`` on every device.  The relax of BFS (max of the frontier
flag), SSSP (min of distance plus weight) and WCC (min of the
neighbours' labels, both directions) is
:func:`repro_torch.kernels.relax.edge_relax`: on a card one hand-written
kernel a shard and an iteration, which reads the int32 ids in place; on
the CPU its plain version, gathers and ``scatter_reduce_`` into an output
filled with the reduction's identity.  Either way min and max merges are
exact, so every sharding, and either route, gives the same bits.
Loops read one convergence flag per iteration, after the merge.  Each
place where the host blocks on the card records a ``device_wait`` span
when tracing is on, so a query's host self time leaves the waits out:
the flag reads (arg ``iter``), CUDA ``torch.bincount``, which reads its
input's range back to size its output (``op`` ``bincount``), and BFS's
and SSSP's root set from a host scalar, a copy that waits for the stream
(``op`` ``root``).

Across processes (``ranks``, a
:class:`~repro_torch.launch.collectives.RankGroup`), the lists hold this
rank's shards only, and each merge ends with a ``dist.all_reduce`` of
the rank's merged vector: every rank then holds the same vector, so the
loops take the same number of iterations on every rank.

Padding contract
----------------

:func:`shard_edges` pads the final shard with self-loops on vertex 0; the
pad slots are marked in the returned ``valid`` mask.  Every function here
takes a ``valid`` per shard — ``None`` only for a shard without pad slots,
as the single-device functions of :mod:`repro_torch.core.analytics` pass
for their one shard.  The torch reductions apply it twice: a pad slot's
contribution is zeroed / identity-filled on the gather side (its gather
index is routed to 0, so ids out of range such as the shard plane's
SENTINEL pads never fault) AND its scatter key is routed to the extra slot
``n`` of an ``n + 1`` output that is sliced off (:func:`masked_key`), so a
padded slot can never contribute to vertex 0 even if a value sneaks past
the first mask.  The relax kernel skips a pad slot, and any edge with an
id outside ``[0, n)``, before it reads either end.  An unmasked pad slot
would silently inflate vertex 0's degree / rank / distance —
``tests/test_torch_shard_plane.py::test_shard_padding_masked`` guards
exactly that.

This module is also the reference for the shard-plane collectives
(:mod:`repro_torch.core.shard_plane` reads pinned per-shard tiles instead
of re-sharding host COO arrays per call, through these same functions).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.relax import edge_relax
from ..kernels.relax.ref import gather_ids, live as _live, masked_key, scatter_key
from ..launch.collectives import merge, replicate
from ..obs.trace import TRACER as _trc


def shard_edges(
    src: np.ndarray, dst: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad + chunk edges into equal contiguous shards (stacked on axis 0).

    Padding uses self-loops on vertex 0 with zero weight contribution.  The
    returned ``valid`` mask is NOT optional: every function in this module
    requires it, and forgetting it elsewhere miscounts vertex 0 (see the
    module docstring's padding contract).
    """
    m = len(src)
    per = -(-m // n_shards)
    pad = per * n_shards - m
    src_p = np.concatenate([src, np.zeros(pad, src.dtype)])
    dst_p = np.concatenate([dst, np.zeros(pad, dst.dtype)])
    valid = np.concatenate([np.ones(m, bool), np.zeros(pad, bool)])
    return (
        src_p.reshape(n_shards, per),
        dst_p.reshape(n_shards, per),
        valid.reshape(n_shards, per),
    )


def _segment_sum(vals: torch.Tensor, key: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, key, vals)[:n]


def _wait(flag: torch.Tensor, it: int) -> bool:
    """``bool(flag)``: the host waits for the card, under a ``device_wait``
    span (arg ``iter``) when tracing is on."""
    frame = _trc.open()
    out = bool(flag)
    if frame:
        _trc.close(frame, "device_wait", cat="read", args={"iter": it})
    return out


def _scatter_keys(ids, valids, n):
    return [scatter_key(x, v, n) for x, v in zip(ids, valids)]


def _gather_indices(ids, valids):
    return [gather_ids(x, v) for x, v in zip(ids, valids)]


def make_pagerank(n: int, iters: int = 10, damping: float = 0.85, pull: bool = False,
                  ranks=None):
    """PageRank over edge shards: ``pr(srcs, dsts, valids) -> [n] f32``.

    ``pull=False`` is the classic push form: gather at src, scatter by dst,
    merging genuinely overlapping vertex-cut partials (equal to the
    single-device :func:`~repro_torch.core.analytics.pagerank_coo`, this
    function over one shard, to rounding).  ``pull=True`` gathers at dst and scatters by src — each
    shard owns its source vertices, so the merge adds exact zeros and the
    result is *bitwise*-equal to the single-device function on the CPU
    when the edge list is symmetrized (the shard plane's contract; on a
    directed edge list the pull form computes PageRank of the transpose).
    Both take the update ``analytics._pr_step``.
    """
    from .analytics import _pr_step

    def pr(srcs, dsts, valids):
        devs = [s.device for s in srcs]
        skey = _scatter_keys(srcs, valids, n)
        frame = _trc.open()
        counts = [torch.bincount(k, minlength=n + 1) for k in skey]  # reads k's range back
        if frame:
            _trc.close(frame, "device_wait", cat="read", args={"op": "bincount"})
        deg = merge([c[:n].to(torch.float32) for c in counts], torch.add, ranks)
        inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 0.0)
        p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=deg.device)
        if pull:
            gather, key = _gather_indices(dsts, valids), skey
        else:
            gather, key = _gather_indices(srcs, valids), _scatter_keys(dsts, valids, n)
        for _ in range(iters):
            pd = replicate(p * inv_deg, devs)
            agg = merge([_segment_sum(_live(v, x[g], 0.0), k, n)
                         for x, v, g, k in zip(pd, valids, gather, key)], torch.add, ranks)
            dangling = torch.where(deg == 0, p, 0.0).sum()
            p = _pr_step(agg, dangling, n, damping)
        return p

    return pr


def make_bfs(n: int, ranks=None):
    """Level-synchronous BFS, replicated frontier, sharded edges:
    ``bfs(srcs, dsts, valids, root) -> [n] int32`` levels (-1 unreached).
    Max-merges are order-free, so any sharding equals ``bfs_coo`` (this
    function over one shard) bit for bit."""

    def bfs(srcs, dsts, valids, root: int):
        devs = [s.device for s in srcs]
        home = devs[0]
        level = torch.full((n,), -1, dtype=torch.int32, device=home)
        frontier = torch.zeros(n, dtype=torch.bool, device=home)
        frame = _trc.open()
        level[root] = 0  # each a host scalar copied in: the host waits for the stream
        frontier[root] = True
        if frame:
            _trc.close(frame, "device_wait", cat="read", args={"op": "root"})
        d = 0
        while _wait(frontier.any(), d):
            fr = replicate(frontier, devs)
            hit = merge([edge_relax("flag", f, s, t, v)
                         for f, s, t, v in zip(fr, srcs, dsts, valids)], torch.maximum, ranks)
            frontier = (hit > 0) & (level < 0)
            level = torch.where(frontier, d + 1, level)
            d += 1
        bfs.iterations = d
        return level

    bfs.iterations = 0
    return bfs


def make_sssp(n: int, ranks=None):
    """Bellman-Ford over sharded weighted edges, replicated distances:
    ``sssp(srcs, dsts, valids, ws, root) -> [n] f32``.  Min-merges are
    order-independent, so any sharding equals ``sssp_coo`` (this function
    over one shard) bit for bit on the same edges and weights."""
    inf = float("inf")

    def sssp(srcs, dsts, valids, ws, root: int):
        devs = [s.device for s in srcs]
        dist = torch.full((n,), inf, dtype=torch.float32, device=devs[0])
        frame = _trc.open()
        dist[root] = 0.0  # a host scalar copied in: the host waits for the stream
        if frame:
            _trc.close(frame, "device_wait", cat="read", args={"op": "root"})
        changed, it = True, 0
        while changed and it < n:
            dd = replicate(dist, devs)
            cand = merge([edge_relax("min_plus", x, s, t, v, w)
                          for x, s, t, v, w in zip(dd, srcs, dsts, valids, ws)],
                         torch.minimum, ranks)
            new = torch.minimum(dist, cand)
            changed = _wait((new < dist).any(), it)
            dist, it = new, it + 1
        sssp.iterations = it
        return dist

    sssp.iterations = 0
    return sssp


def make_wcc(n: int, ranks=None):
    """Label-propagation WCC over sharded edges: ``wcc(srcs, dsts, valids)
    -> [n] int32`` labels.  Each shard propagates labels across its local
    edges in BOTH directions (the symmetrization never leaves the shard),
    min-merges — any sharding equals ``wcc_coo`` (this function over one
    shard) bit for bit."""

    def wcc(srcs, dsts, valids):
        devs = [s.device for s in srcs]
        labels = torch.arange(n, dtype=torch.int32, device=devs[0])
        changed, it = True, 0
        while changed:
            lab = replicate(labels, devs)
            parts = [edge_relax("min_both", x, s, t, v)
                     for x, s, t, v in zip(lab, srcs, dsts, valids)]
            new = torch.minimum(labels, merge(parts, torch.minimum, ranks))
            new = new[new.long()]  # pointer-jump (path halving)
            changed = _wait((new != labels).any(), it)
            labels, it = new, it + 1
        wcc.iterations = it
        return labels

    wcc.iterations = 0
    return wcc


__all__ = [
    "make_bfs",
    "make_pagerank",
    "make_sssp",
    "make_wcc",
    "masked_key",
    "shard_edges",
]
