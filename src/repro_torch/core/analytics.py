"""Graph analytics over snapshot views (paper §7 workloads, GAPBS-style).

PR / BFS / SSSP / WCC run as torch programs over the view's COO tensors
on ``view.device`` — the kernels underneath contain zero version logic
(the paper's decoupling).  PageRank's segment sum is ``index_add_``.  The
relax step of BFS, SSSP and WCC is
:func:`repro_torch.kernels.relax.edge_relax` (see
:mod:`repro_torch.core.distributed`): on a card one hand-written kernel
an iteration over the int32 COO, on the CPU gathers and
``scatter_reduce_`` (max / min, initialised with the reduction's identity
so empty segments read as they do under
``jax.ops.segment_max``/``segment_min``); each ``while_loop`` is a Python
loop that reads one convergence flag from the device per iteration (a
``device_wait`` span when tracing is on), and the loop functions record
their last iteration count in ``.iterations``: an attribute of the
function, so one per process, which every thread's call overwrites (a
traced ``query`` span counts its own loop's waits, ``waits``).  Each
view-level entry point records a ``query`` span
(:func:`repro_torch.obs.trace.query_span`).
TC implements the paper's hybrid set-intersection rule (merge when
|N(v)|/|N(u)| < 10, probe otherwise, §6.5) on the host, with a device path
through the CUDA ``intersect`` kernel for leaf-block views.
"""

from __future__ import annotations

import numpy as np
import torch

from .arrays import sorted_unique
from ..obs.trace import query_span
from .distributed import make_bfs, make_pagerank, make_sssp, make_wcc
from .shard_plane import active_plane


# ---------------------------------------------------------------------------
# PageRank (push-style over COO; 10 iterations per GAPBS convention)
# ---------------------------------------------------------------------------
def _pr_step(agg: torch.Tensor, dangling: torch.Tensor, n: int, damping: float) -> torch.Tensor:
    """The PageRank update, built from f32 operations as in the reference."""
    d = torch.tensor(damping, dtype=torch.float32)
    base = (1.0 - d) / n
    return base + d * (agg + dangling / n)


def pagerank_coo(
    src: torch.Tensor, dst: torch.Tensor, n: int, iters: int = 10, damping: float = 0.85
) -> torch.Tensor:
    """Push-form PageRank: the shard plane's collective over one shard.  On
    CUDA the per-iteration ``index_add_`` adds with atomics, so the f32
    order (and the last bits) can change from run to run."""
    return make_pagerank(n, iters=iters, damping=damping)([src], [dst], [None])


# ---------------------------------------------------------------------------
# BFS (level-synchronous, dense frontiers), SSSP (Bellman-Ford with early
# exit) and WCC (label propagation with pointer jumping): each is the shard
# plane's collective of :mod:`repro_torch.core.distributed` over one shard,
# so every loop lives in one place.
# ---------------------------------------------------------------------------
def bfs_coo(src: torch.Tensor, dst: torch.Tensor, n: int, root: int) -> torch.Tensor:
    fn = make_bfs(n)
    level = fn([src], [dst], [None], root)
    bfs_coo.iterations = fn.iterations
    return level


bfs_coo.iterations = 0


def sssp_coo(
    src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, n: int, root: int
) -> torch.Tensor:
    fn = make_sssp(n)
    dist = fn([src], [dst], [None], [w], root)
    sssp_coo.iterations = fn.iterations
    return dist


sssp_coo.iterations = 0


def wcc_coo(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Labels of the weakly connected components: every edge propagates
    labels in both directions, so a directed edge list needs no
    symmetrizing (a symmetrized one gives the same labels)."""
    fn = make_wcc(n)
    labels = fn([src], [dst], [None])
    wcc_coo.iterations = fn.iterations
    return labels


wcc_coo.iterations = 0


# ---------------------------------------------------------------------------
# View-level entry points — analytics over the view's device COO
# (``view.to_coo_device()``): the edge arrays stay resident on
# ``view.device``, so a warm repeat performs zero host->device transfers.
#
# When the view's store has a shard plane attached
# (``RapidStore.attach_shard_plane``), the entry points route through the
# plane's collectives over its per-shard tiles instead
# (``REPRO_DISABLE_SHARD_PLANE`` opts out) — see
# :mod:`repro_torch.core.shard_plane` for the parity contract.
# ---------------------------------------------------------------------------
@query_span(route=active_plane)
def pagerank_view(view, iters: int = 10, damping: float = 0.85) -> torch.Tensor:
    plane = active_plane(view)
    if plane is not None:
        return plane.pagerank(view, iters=iters, damping=damping)
    src, dst = view.to_coo_device()
    return pagerank_coo(src, dst, view.n_vertices, iters=iters, damping=damping)


@query_span(route=active_plane)
def bfs_view(view, root: int) -> torch.Tensor:
    plane = active_plane(view)
    if plane is not None:
        return plane.bfs(view, root)
    src, dst = view.to_coo_device()
    return bfs_coo(src, dst, view.n_vertices, root)


@query_span(route=active_plane)
def sssp_view(view, w, root: int) -> torch.Tensor:
    plane = active_plane(view)
    if plane is not None:
        return plane.sssp(view, w, root)
    src, dst = view.to_coo_device()
    w = torch.as_tensor(w, dtype=torch.float32, device=view.device)
    return sssp_coo(src, dst, w, view.n_vertices, root)


@query_span(route=active_plane)
def wcc_view(view) -> torch.Tensor:
    """WCC over a directed view: both directions of the cached device COO
    propagate (under a shard plane, each shard's local edges)."""
    plane = active_plane(view)
    if plane is not None:
        return plane.wcc(view)
    src, dst = view.to_coo_device()
    return wcc_coo(src, dst, view.n_vertices)


@query_span()
def triangle_count_view(view) -> int:
    """Triangle count over a snapshot view (store an undirected simple graph
    for exact counts), through the CUDA ``sum_intersect_tiles_view`` entry
    point on the view's device-resident leaf tiles: one intersect per
    (leaf-tile, leaf-tile) pair of :func:`triangle_tile_pairs`.

    Each undirected edge is enumerated once as (u, v), u < v, and the
    *full* neighbor tile sets of u and v are intersected on device: every
    common neighbor w closes the triangle {u, v, w}, and each triangle is
    discovered exactly once per edge — three times total — so the
    pair-count sum is 3T.  Tiles are the delta-plane assembled leaf blocks,
    so a repeat count after a small write re-uses every clean subgraph's
    device rows.
    """
    from ..kernels.intersect import sum_intersect_tiles_view

    ia, ib = triangle_tile_pairs(view)
    if len(ia) == 0:
        return 0
    return sum_intersect_tiles_view(view, ia, ib) // 3


def triangle_tile_pairs(view):
    """(ia, ib): int64 leaf-tile indices of every (tile of u, tile of v)
    pair over the undirected edges u < v of ``view``, host side.

    The paper's hybrid rule (merge when the degree ratio < 10, probe
    otherwise) picks the operand *orientation*: probing keeps the smaller
    tile as the probing operand `a`.  Assumes a simple graph (no
    self-loops), like the host oracle.
    """
    from . import view_assembler

    src, order = view_assembler.block_src_index(view)
    # the host side only needs per-leaf lengths: read the compacted stream's
    # sidecar natively — no padded [n, B] host materialization
    lens = np.asarray(view.to_leaf_stream().leaf_lens, np.int64)
    s_sorted = src[order]

    csr = view.to_csr()
    n = csr.n_vertices
    deg = np.diff(csr.offsets)
    eu = np.repeat(np.arange(n, dtype=np.int64), deg)
    ev = csr.indices.astype(np.int64)
    fwd = ev > eu  # orient each undirected edge low -> high, once
    eu, ev = eu[fwd], ev[fwd]
    none = np.zeros(0, np.int64)
    if len(eu) == 0:
        return none, none

    # per-edge tile spans via the src-sorted block index
    lo_u = np.searchsorted(s_sorted, eu, "left")
    hi_u = np.searchsorted(s_sorted, eu, "right")
    lo_v = np.searchsorted(s_sorted, ev, "left")
    hi_v = np.searchsorted(s_sorted, ev, "right")
    ku, kv = hi_u - lo_u, hi_v - lo_v
    pairs_per_edge = ku * kv
    total_pairs = int(pairs_per_edge.sum())
    if total_pairs == 0:
        return none, none
    # all (tile of u) x (tile of v) pairs, vectorized
    e_idx = np.repeat(np.arange(len(eu)), pairs_per_edge)
    rank = np.arange(total_pairs, dtype=np.int64) - np.repeat(
        np.cumsum(pairs_per_edge) - pairs_per_edge, pairs_per_edge
    )
    ia = order[lo_u[e_idx] + rank // kv[e_idx]]
    ib = order[lo_v[e_idx] + rank % kv[e_idx]]
    # hybrid orientation: when the size ratio selects the probe strategy,
    # probe with the smaller tile as operand `a`
    la, lb = lens[ia], lens[ib]
    big, small = np.maximum(la, lb), np.maximum(np.minimum(la, lb), 1)
    swap = (big >= HYBRID_RATIO * small) & (la > lb)
    return np.where(swap, ib, ia), np.where(swap, ia, ib)


# ---------------------------------------------------------------------------
# Triangle counting — the paper's hybrid merge/probe intersection (§6.5)
# ---------------------------------------------------------------------------
HYBRID_RATIO = 10.0


def _intersect_count(a: np.ndarray, b: np.ndarray) -> int:
    """Count |a ∩ b| for sorted arrays with the paper's strategy rule."""
    d1, d2 = len(a), len(b)
    if d1 == 0 or d2 == 0:
        return 0
    if d1 > d2:
        a, b, d1, d2 = b, a, d2, d1
    if d2 / d1 < HYBRID_RATIO:  # merge-based
        return int(len(np.intersect1d(a, b, assume_unique=True)))
    # probe: binary-search each element of the smaller set in the larger
    pos = np.searchsorted(b, a)
    inb = pos < d2
    return int(np.count_nonzero(b[pos[inb]] == a[inb]))


def triangle_count(csr) -> int:
    """TC on an undirected CSR view: sum over edges (u,v), u<v of
    |N+(u) ∩ N+(v)| where N+ keeps only higher-id neighbors."""
    offsets, indices = np.asarray(csr.offsets), np.asarray(csr.indices)
    n = len(offsets) - 1
    # orient edges low->high to count each triangle once
    plus = []
    for u in range(n):
        nbr = indices[offsets[u] : offsets[u + 1]]
        plus.append(nbr[nbr > u])
    total = 0
    for u in range(n):
        for v in plus[u]:
            total += _intersect_count(plus[u], plus[int(v)])
    return total


def triangle_count_fast(csr) -> int:
    """Vectorized host TC used by benchmarks (same hybrid rule, batched)."""
    offsets, indices = np.asarray(csr.offsets), np.asarray(csr.indices)
    n = len(offsets) - 1
    deg = np.diff(offsets)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    mask = indices > src  # orient
    e_src = src[mask]
    total = 0
    # group by src for locality; probe each (u,v) pair's N+(v) against N+(u)
    for u in sorted_unique(e_src):
        nu = indices[offsets[u] : offsets[u + 1]]
        nu = nu[nu > u]
        if len(nu) == 0:
            continue
        for v in nu:
            nv = indices[offsets[v] : offsets[v + 1]]
            nv = nv[nv > v]
            total += _intersect_count(nu, nv)
    return total
