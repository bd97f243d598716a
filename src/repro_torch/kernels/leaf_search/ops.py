"""Batched leaf search: the CUDA kernel on the card, the plain version on
the CPU (``csrc/leaf_search.cu``)."""

from __future__ import annotations

import numpy as np
import torch

from ...obs.trace import query_span
from ..runtime import (check, check_operands, count_launch, cuda_input, kernel_fn,
                       launch_on, on_cpu, stream_ptr)
from .ref import leaf_search_ref


def leaf_search(rows, targets, index=None, length=None):
    """Batched Search(u, v): locate targets[i] in the live prefix of a
    sorted, SENTINEL-padded tile row.

    rows: [n, B] int32, the resident tiles themselves; targets: [Q] int32;
    index: [Q] int32, the tile of each query in [0, n) (None: tile i,
    n == Q); length: [n] int32, each tile's live ids (None: B).  Returns
    (found [Q] bool, pos [Q] int32) on ``rows``' device: pos counts the live
    ids below the target, found says whether one equals it.  That is the
    full-row answer whenever no target is SENTINEL (no vertex id is).  A CPU
    tensor takes the plain version (an index outside [0, n) raises
    IndexError); a CUDA tensor launches the kernel, which binary-searches
    only the live prefix of each named tile (no gathered copy) and traps on
    an index outside [0, n), so the next synchronisation raises.
    """
    rows = torch.as_tensor(rows, dtype=torch.int32)
    check_operands("leaf_search", rows, targets, index, length)
    on = rows.device
    targets = torch.as_tensor(targets, dtype=torch.int32, device=on)
    if index is not None:
        index = torch.as_tensor(index, dtype=torch.int32, device=on)
    if length is not None:
        length = torch.as_tensor(length, dtype=torch.int32, device=on)
    if on_cpu(rows, "leaf_search"):
        return leaf_search_ref(rows, targets, index, length)
    rows = cuda_input(rows, torch.int32, 2, "leaf_search rows")
    targets = cuda_input(targets, torch.int32, 1, "leaf_search targets")
    n, b = rows.shape
    q = targets.shape[0]
    if index is None and q != n:
        raise ValueError("leaf_search: rows and targets disagree on Q")
    if index is not None:
        index = cuda_input(index, torch.int32, 1, "leaf_search index")
        if index.shape[0] != q:
            raise ValueError("leaf_search: index and targets disagree on Q")
    if length is not None:
        length = cuda_input(length, torch.int32, 1, "leaf_search length")
        if length.shape[0] != n:
            raise ValueError("leaf_search: length and rows disagree on n")
    found = torch.empty(q, dtype=torch.uint8, device=on)
    pos = torch.empty(q, dtype=torch.int32, device=on)
    if q:
        fn = kernel_fn("leaf_search", "leaf_search_launch", "ppppppllip")
        with launch_on(on):
            check(fn(rows.data_ptr(), targets.data_ptr(),
                     None if index is None else index.data_ptr(),
                     None if length is None else length.data_ptr(),
                     found.data_ptr(), pos.data_ptr(), q, n, b, stream_ptr(rows)),
                  "leaf_search")
        count_launch(leaf_search, on)
    return found.view(torch.bool), pos


leaf_search.launches = 0


def candidate_ranges(offsets, us):
    """(lo, hi): the candidate tiles of query i are ``order[lo[i]:hi[i]]``,
    the tiles whose source vertex is ``us[i]`` (``offsets`` from
    ``view_assembler.block_src_offsets``); empty for ids outside the view."""
    n = len(offsets) - 1
    ok = (us >= 0) & (us < n)
    u = np.where(ok, us, 0)
    return np.where(ok, offsets[u], 0), np.where(ok, offsets[u + 1], 0)


def flatten_candidates(order, lo, hi):
    """(qidx, flat): every (query, candidate tile) pair, query-major."""
    counts = hi - lo
    total = int(counts.sum())
    qidx = np.repeat(np.arange(len(lo)), counts)
    start = np.repeat(lo - (np.cumsum(counts) - counts), counts)
    return qidx, order[start + np.arange(total)]


def search_tiles(view, vs, qidx, flat, n_queries: int) -> torch.Tensor:
    """Search vs[qidx[j]] in leaf tile flat[j] of ``view``'s resident tiles
    (the view's leaf stream order) and OR the answers per query on the
    device: bool [n_queries] on ``view.device``."""
    dev = view.to_leaf_blocks_device()
    on = view.device
    hits = torch.zeros(n_queries, dtype=torch.int32, device=on)

    def _search(rows, length, tile, sel):
        # tile, target and query of each pair, uploaded in one copy
        pairs = torch.from_numpy(np.stack([tile, vs[qidx[sel]], qidx[sel]]).astype(np.int32))
        index, tgt, query = pairs.to(on)
        found, _ = leaf_search(rows, tgt, index, length)
        hits.index_add_(0, query, found.to(torch.int32))

    if getattr(dev, "groups", None) is not None:
        # tiered tiles: each candidate to its tier group, one search per tier
        cand_t = view.to_leaf_stream().leaf_tiers[flat]
        for t in dev.tiers:
            m = cand_t == t
            if m.any():
                _, rows, length = dev.groups[t]
                _search(rows, length, np.searchsorted(dev.gidx[t], flat[m]), m)
    else:
        _search(dev.rows, dev.length, flat, slice(None))
    return hits > 0


@query_span()
def edge_search_view(view, us, vs) -> np.ndarray:
    """Batched edge-membership Search(u, v) through the device tile cache.

    Resolves each query's candidate tiles via the host block index (the
    delta-plane assembler memoizes the spliced block stream, its src-sorted
    order and each vertex's span in it on the view), then answers every
    (query, tile) pair with one ``leaf_search`` on the resident tiles (one
    per tier) — the kernel reads each named tile's live prefix in place,
    nothing is gathered or re-uploaded — and ORs the pairs per query on the
    device: query i hits iff any tile of ``us[i]`` contains ``vs[i]``.
    Returns a bool [len(us)] numpy array (one copy back per call).
    """
    from ...core import view_assembler

    us = np.asarray(us, np.int64).reshape(-1)
    vs = np.asarray(vs, np.int64).reshape(-1)
    if us.shape != vs.shape:
        raise ValueError("us and vs must have matching shapes")
    offsets, order = view_assembler.block_src_offsets(view)
    lo, hi = candidate_ranges(offsets, us)
    if int((hi - lo).sum()) == 0:
        return np.zeros(len(us), bool)
    qidx, flat = flatten_candidates(order, lo, hi)
    return search_tiles(view, vs, qidx, flat, len(us)).cpu().numpy()


__all__ = ["edge_search_view", "leaf_search", "leaf_search_ref"]
