"""Batched leaf search: the CUDA kernel on the card, the plain version on
the CPU (``csrc/leaf_search.cu``)."""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import check, count_launch, cuda_input, kernel_fn, on_cpu, stream_ptr
from .ref import leaf_search_ref


def leaf_search(rows, targets):
    """Batched Search(u, v): locate targets[i] in sorted padded rows[i].

    rows: [Q, B] int32, targets: [Q] int32. Returns (found [Q] bool,
    pos [Q] int32) on ``rows``' device.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (Q is not padded).
    """
    rows = torch.as_tensor(rows, dtype=torch.int32)
    targets = torch.as_tensor(targets, dtype=torch.int32, device=rows.device)
    if on_cpu(rows, "leaf_search"):
        return leaf_search_ref(rows, targets)
    rows = cuda_input(rows, torch.int32, 2, "leaf_search rows")
    targets = cuda_input(targets, torch.int32, 1, "leaf_search targets")
    q, b = rows.shape
    if targets.shape[0] != q:
        raise ValueError("leaf_search: rows and targets disagree on Q")
    found = torch.empty(q, dtype=torch.uint8, device=rows.device)
    pos = torch.empty(q, dtype=torch.int32, device=rows.device)
    if q:
        fn = kernel_fn("leaf_search", "leaf_search_launch", "pppplip")
        check(fn(rows.data_ptr(), targets.data_ptr(), found.data_ptr(),
                 pos.data_ptr(), q, b, stream_ptr(rows)), "leaf_search")
        count_launch(leaf_search)
    return found.view(torch.bool), pos


leaf_search.launches = 0


def edge_search_view(view, us, vs) -> np.ndarray:
    """Batched edge-membership Search(u, v) through the device tile cache.

    Resolves each query's candidate tiles via the host block index (the
    delta-plane assembler memoizes both the spliced block stream and its
    src-sorted order on the view), gathers those rows *on device* — the leaf
    blocks themselves are never re-uploaded — and answers every query with
    one batched ``leaf_search``: query i hits iff any tile of ``us[i]``
    contains ``vs[i]``.  Returns a bool [len(us)] numpy array.
    """
    from ...core import view_assembler

    us = np.asarray(us, np.int64).reshape(-1)
    vs = np.asarray(vs, np.int64).reshape(-1)
    if us.shape != vs.shape:
        raise ValueError("us and vs must have matching shapes")
    src, order = view_assembler.block_src_index(view)
    lo = np.searchsorted(src[order], us, "left")
    hi = np.searchsorted(src[order], us, "right")
    counts = hi - lo
    out = np.zeros(len(us), bool)
    if counts.sum() == 0:
        return out
    qidx = np.repeat(np.arange(len(us)), counts)
    flat = np.concatenate([order[l:h] for l, h in zip(lo, hi) if h > l])
    dev = view.to_leaf_blocks_device()
    on = view.device

    def _search(rows_all, idx, q):
        rows_sel = rows_all[torch.from_numpy(np.ascontiguousarray(idx)).to(on)]
        tgt = torch.from_numpy(vs[q].astype(np.int32)).to(on)
        found, _ = leaf_search(rows_sel, tgt)
        np.logical_or.at(out, q, found.cpu().numpy())

    if getattr(dev, "groups", None) is not None:
        # tiered tiles: route each candidate leaf to its tier group and
        # run one fixed-[*, B_t] batched search per tier
        cand_t = view.to_leaf_stream().leaf_tiers[flat]
        for t in dev.tiers:
            m = cand_t == t
            if m.any():
                _search(dev.groups[t][1], np.searchsorted(dev.gidx[t], flat[m]),
                        qidx[m])
        return out
    _search(dev.rows, flat, qidx)
    return out


__all__ = ["edge_search_view", "leaf_search", "leaf_search_ref"]
