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
for their one shard — and applies it twice: a pad slot's
contribution is zeroed / identity-filled on the gather side (its gather
index is routed to 0, so ids out of range such as the shard plane's
SENTINEL pads never fault) AND its scatter key is routed to the extra slot
``n`` of an ``n + 1`` output that is sliced off (:func:`masked_key`), so a
padded slot can never contribute to vertex 0 even if a value sneaks past
the first mask.  An unmasked pad slot would silently inflate vertex 0's
degree / rank / distance — ``tests/test_torch_shard_plane.py::
test_shard_padding_masked`` guards exactly that.

This module is also the reference for the shard-plane collectives
(:mod:`repro_torch.core.shard_plane` reads pinned per-shard tiles instead
of re-sharding host COO arrays per call, through these same functions).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..launch.collectives import merge, replicate
from ..obs.trace import TRACER as _trc

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


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


def masked_key(key: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """int64 scatter key with pad slots routed to ``n``: the extra slot of
    an ``n + 1`` output, sliced off after the reduction (torch's scatter
    ops fault on ids out of range instead of dropping them)."""
    return torch.where(valid, key.long(), n)


def _gather_index(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int64 gather index with pad slots routed to vertex 0 (their gathered
    value is masked out again before any reduction)."""
    return torch.where(valid, idx.long(), 0)


def _live(valid, x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` with pad slots set to ``fill`` (``valid`` None: no pad slots)."""
    return x if valid is None else torch.where(valid, x, fill)


def _segment_sum(vals: torch.Tensor, key: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, key, vals)[:n]


def _segment_reduce(vals: torch.Tensor, key: torch.Tensor, n: int, op: str,
                    identity) -> torch.Tensor:
    """``op`` ("amax"/"amin") per segment; empty segments read ``identity``,
    as under ``jax.ops.segment_max``/``segment_min``."""
    out = torch.full((n + 1,), identity, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, key, vals, op, include_self=False)[:n]


def _wait(flag: torch.Tensor, it: int) -> bool:
    """``bool(flag)``: the host waits for the card, under a ``device_wait``
    span (arg ``iter``) when tracing is on."""
    frame = _trc.open()
    out = bool(flag)
    if frame:
        _trc.close(frame, "device_wait", cat="read", args={"iter": it})
    return out


def _scatter_keys(ids, valids, n):
    return [x.long() if v is None else masked_key(x, v, n) for x, v in zip(ids, valids)]


def _gather_indices(ids, valids):
    return [x.long() if v is None else _gather_index(x, v) for x, v in zip(ids, valids)]


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
        dkey, gsrc = _scatter_keys(dsts, valids, n), _gather_indices(srcs, valids)
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
            hit = merge([_segment_reduce(_live(v, f[g], False).to(torch.int32), k, n,
                                         "amax", _I32_MIN)
                         for f, v, g, k in zip(fr, valids, gsrc, dkey)], torch.maximum,
                        ranks)
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
        dkey, gsrc = _scatter_keys(dsts, valids, n), _gather_indices(srcs, valids)
        dist = torch.full((n,), inf, dtype=torch.float32, device=devs[0])
        frame = _trc.open()
        dist[root] = 0.0  # a host scalar copied in: the host waits for the stream
        if frame:
            _trc.close(frame, "device_wait", cat="read", args={"op": "root"})
        changed, it = True, 0
        while changed and it < n:
            dd = replicate(dist, devs)
            cand = merge([_segment_reduce(_live(v, x[g] + w, inf), k, n, "amin", inf)
                          for x, v, g, w, k in zip(dd, valids, gsrc, ws, dkey)],
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
        skey, dkey = _scatter_keys(srcs, valids, n), _scatter_keys(dsts, valids, n)
        gsrc, gdst = _gather_indices(srcs, valids), _gather_indices(dsts, valids)
        labels = torch.arange(n, dtype=torch.int32, device=devs[0])
        changed, it = True, 0
        while changed:
            lab = replicate(labels, devs)
            parts = []
            for x, v, gs, gd, sk, dk in zip(lab, valids, gsrc, gdst, skey, dkey):
                fwd = _segment_reduce(_live(v, x[gs], _I32_MAX), dk, n, "amin", _I32_MAX)
                bwd = _segment_reduce(_live(v, x[gd], _I32_MAX), sk, n, "amin", _I32_MAX)
                parts.append(torch.minimum(fwd, bwd))
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
