"""Intersection counts over leaf tiles, including the paper's hybrid
strategy rule: the CUDA kernel (``csrc/intersect_count.cu``) on the card,
the plain version on the CPU."""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import check, count_launch, cuda_input, kernel_fn, on_cpu, stream_ptr
from .ref import SENTINEL, intersect_count_ref


def intersect_count(a, b) -> torch.Tensor:
    """|a_i ∩ b_i| for SENTINEL-padded [Q, Ba] / [Q, Bb] int32 batches whose
    ``b`` rows are sorted ascending (as leaf tiles are).  The widths may
    differ; the result is int32 [Q] on ``a``'s device."""
    a = torch.as_tensor(a, dtype=torch.int32)
    b = torch.as_tensor(b, dtype=torch.int32, device=a.device)
    if a.shape[0] != b.shape[0]:
        raise ValueError("intersect_count: a and b disagree on Q")
    if on_cpu(a, "intersect_count"):
        return intersect_count_ref(a, b)
    a = cuda_input(a, torch.int32, 2, "intersect_count a")
    b = cuda_input(b, torch.int32, 2, "intersect_count b")
    q, ba = a.shape
    bb = b.shape[1]
    out = torch.empty(q, dtype=torch.int32, device=a.device)
    if q:
        fn = kernel_fn("intersect_count", "intersect_count_launch", "pppliip")
        check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), q, ba, bb,
                 stream_ptr(a)), "intersect_count")
        count_launch(intersect_count)
    return out


intersect_count.launches = 0


def intersect_count_hybrid(a, b) -> torch.Tensor:
    """Paper §6.5 hybrid: the strategy choice selects the *operand
    orientation* — the smaller set probes (``a``), the larger is searched
    (``b``).  ``a`` and ``b`` share one shape here."""
    a = torch.as_tensor(a, dtype=torch.int32)
    b = torch.as_tensor(b, dtype=torch.int32, device=a.device)
    na = (a != SENTINEL).sum(dim=1)
    nb = (b != SENTINEL).sum(dim=1)
    swap = (na > nb)[:, None]
    return intersect_count(torch.where(swap, b, a), torch.where(swap, a, b))


def _index(idx, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(idx, np.int64).reshape(-1)).to(device)


def intersect_tiles_view(view, idx_a, idx_b) -> torch.Tensor:
    """|tile_a ∩ tile_b| for pairs of a view's device-resident leaf tiles.

    ``idx_a``/``idx_b`` index rows of ``view.to_leaf_blocks_device()`` (the
    delta-plane assembled tile stream — after a small write only the dirty
    subgraphs' tiles were spliced on device); the gathers happen on device,
    so warm repeats move no leaf data host->device.
    """
    dev = view.to_leaf_blocks_device()
    if getattr(dev, "groups", None) is not None:
        return _intersect_tiles_tiered(view, dev, idx_a, idx_b)
    rows = dev.rows
    return intersect_count(rows[_index(idx_a, view.device)],
                           rows[_index(idx_b, view.device)])


def _intersect_tiles_tiered(view, dev, idx_a, idx_b) -> torch.Tensor:
    """Per-(tier_a, tier_b) pair-group dispatch for tiered device tiles.

    Pairs are bucketed by their operands' tiers; each bucket gathers from
    its two fixed-shape groups and runs one kernel call at the two native
    widths (the kernel takes ``Ba != Bb``, so nothing is padded).
    """
    idx_a = np.asarray(idx_a, np.int64).reshape(-1)
    idx_b = np.asarray(idx_b, np.int64).reshape(-1)
    tiers = view.to_leaf_stream().leaf_tiers
    ta = tiers[idx_a] if len(idx_a) else np.zeros(0, np.int32)
    tb = tiers[idx_b] if len(idx_b) else np.zeros(0, np.int32)
    out = torch.zeros(len(idx_a), dtype=torch.int32, device=view.device)

    def _gather(t, idx):
        pos = np.searchsorted(dev.gidx[int(t)], idx)
        return dev.groups[int(t)][1][_index(pos, view.device)]

    for t1 in dev.tiers:
        for t2 in dev.tiers:
            m = (ta == t1) & (tb == t2)
            if not m.any():
                continue
            counts = intersect_count(_gather(t1, idx_a[m]), _gather(t2, idx_b[m]))
            out[_index(np.nonzero(m)[0], view.device)] = counts
    return out


def sum_intersect_tiles_view(view, idx_a, idx_b, batch: int = 8192) -> int:
    """Sum of |tile_a ∩ tile_b| over many tile pairs, batched on device.

    The workhorse of device-path triangle counting: pair lists can reach
    O(E) entries, so the [pairs, B] gathers are chunked to ``batch`` rows to
    bound device memory; partial sums are accumulated in int64 on host.
    """
    idx_a = np.asarray(idx_a, np.int64).reshape(-1)
    idx_b = np.asarray(idx_b, np.int64).reshape(-1)
    if idx_a.shape != idx_b.shape:
        raise ValueError("idx_a and idx_b must have matching shapes")
    total = 0
    for lo in range(0, len(idx_a), batch):
        counts = intersect_tiles_view(
            view, idx_a[lo : lo + batch], idx_b[lo : lo + batch]
        )
        total += int(counts.sum(dtype=torch.int64))
    return total


__all__ = [
    "intersect_count",
    "intersect_count_hybrid",
    "intersect_count_ref",
    "intersect_tiles_view",
    "sum_intersect_tiles_view",
]
