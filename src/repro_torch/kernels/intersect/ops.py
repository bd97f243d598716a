"""Intersection counts over leaf tiles, including the paper's hybrid
strategy rule: the CUDA kernel (``csrc/intersect_count.cu``) on the card,
the plain version on the CPU."""

from __future__ import annotations

import numpy as np
import torch

from ...obs.trace import query_span
from ..runtime import (check, check_operands, count_launch, cuda_input, kernel_fn,
                       launch_on, on_cpu, stream_ptr)
from .ref import SENTINEL, intersect_count_ref


SUM_BATCH = 1 << 20  # pairs per launch of sum_intersect_tiles_view
MAX_WIDTHS = 227 * 1024 // 4  # Ba + Bb: one pair's two rows in a block's shared memory


def intersect_count(a, b, index_a=None, index_b=None, length_a=None, length_b=None
                    ) -> torch.Tensor:
    """|a_i ∩ b_i| for pairs of SENTINEL-padded int32 tiles whose rows are
    sorted ascending over their live prefix (as leaf tiles are).

    a: [n_a, Ba], b: [n_b, Bb], the resident tiles themselves (the widths
    may differ); index_a, index_b: [Q] int32, the tiles of each pair (None:
    tile i, and then n == Q); length_a [n_a], length_b [n_b] int32: each
    tile's live ids (None: the full width).  Returns int32 [Q] on ``a``'s
    device.  A CPU tensor takes the plain version (an index outside [0, n)
    raises IndexError); a CUDA tensor launches the kernel, a warp per pair
    reading only the two live prefixes in place (no gathered copy), which
    traps on an index outside [0, n), so the next synchronisation raises.
    The kernel stages a pair's two rows in shared memory, so on the card
    Ba + Bb may be at most ``MAX_WIDTHS`` (58,112) ids: wider tiles raise
    ValueError before any launch.
    """
    a = torch.as_tensor(a, dtype=torch.int32)
    check_operands("intersect_count", a, b, index_a, index_b, length_a, length_b)
    on = a.device
    b = torch.as_tensor(b, dtype=torch.int32, device=on)
    index_a, index_b, length_a, length_b = (
        None if t is None else torch.as_tensor(t, dtype=torch.int32, device=on)
        for t in (index_a, index_b, length_a, length_b))
    q = a.shape[0] if index_a is None else index_a.shape[0]
    if q != (b.shape[0] if index_b is None else index_b.shape[0]):
        raise ValueError("intersect_count: a and b disagree on Q")
    if on_cpu(a, "intersect_count"):
        return intersect_count_ref(a, b, index_a, index_b, length_a, length_b)
    if a.shape[1] + b.shape[1] > MAX_WIDTHS:
        raise ValueError(f"intersect_count: Ba + Bb = {a.shape[1] + b.shape[1]} ids exceed "
                         f"the {MAX_WIDTHS} one block's shared memory holds")
    a = cuda_input(a, torch.int32, 2, "intersect_count a")
    b = cuda_input(b, torch.int32, 2, "intersect_count b")
    ptrs = []
    for t, what, n in ((index_a, "index_a", q), (index_b, "index_b", q),
                       (length_a, "length_a", a.shape[0]), (length_b, "length_b", b.shape[0])):
        if t is not None:
            t = cuda_input(t, torch.int32, 1, f"intersect_count {what}")
            if t.shape[0] != n:
                raise ValueError(f"intersect_count: {what} has {t.shape[0]} entries, "
                                 f"expected {n}")
        ptrs.append(t)
    out = torch.empty(q, dtype=torch.int32, device=on)
    if q:
        fn = kernel_fn("intersect_count", "intersect_count_launch", "pppppppllliip")
        with launch_on(on):
            check(fn(a.data_ptr(), b.data_ptr(),
                     *(None if t is None else t.data_ptr() for t in ptrs), out.data_ptr(),
                     q, a.shape[0], b.shape[0], a.shape[1], b.shape[1], stream_ptr(a)),
                  "intersect_count")
        count_launch(intersect_count, on)
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


def _pair_index(ia, ib, device) -> torch.Tensor:
    """[2, Q] int32 tile indices of the pairs, uploaded in one copy."""
    return torch.from_numpy(np.stack([ia, ib]).astype(np.int32)).to(device)


@query_span()
def intersect_tiles_view(view, idx_a, idx_b) -> torch.Tensor:
    """|tile_a ∩ tile_b| for pairs of a view's device-resident leaf tiles.

    ``idx_a``/``idx_b`` index rows of ``view.to_leaf_blocks_device()`` (the
    delta-plane assembled tile stream — after a small write only the dirty
    subgraphs' tiles were spliced on device).  The kernel reads the named
    tiles' live prefixes in place (their ``length`` column): only the pair
    indices go host->device, and no [Q, B] copy is made.
    """
    dev = view.to_leaf_blocks_device()
    if getattr(dev, "groups", None) is not None:
        return _intersect_tiles_tiered(view, dev, idx_a, idx_b)
    idx = _pair_index(np.asarray(idx_a, np.int64).reshape(-1),
                      np.asarray(idx_b, np.int64).reshape(-1), view.device)
    return _count_pairs(dev, idx)


def _count_pairs(dev, idx) -> torch.Tensor:
    """The kernel on single-tier device tiles ``dev`` in place, for the
    pairs of the uploaded [2, Q] index ``idx``."""
    return intersect_count(dev.rows, dev.rows, idx[0], idx[1], dev.length, dev.length)


def _intersect_tiles_tiered(view, dev, idx_a, idx_b) -> torch.Tensor:
    """Per-(tier_a, tier_b) pair-group dispatch for tiered device tiles.

    Pairs are bucketed by their operands' tiers; each bucket names its
    tiles by position in their two fixed-shape groups and runs one kernel
    call on the groups in place, at the two native widths (the kernel takes
    ``Ba != Bb``, so nothing is padded or gathered).
    """
    idx_a = np.asarray(idx_a, np.int64).reshape(-1)
    idx_b = np.asarray(idx_b, np.int64).reshape(-1)
    tiers = view.to_leaf_stream().leaf_tiers
    ta = tiers[idx_a] if len(idx_a) else np.zeros(0, np.int32)
    tb = tiers[idx_b] if len(idx_b) else np.zeros(0, np.int32)
    out = torch.zeros(len(idx_a), dtype=torch.int32, device=view.device)
    for t1 in dev.tiers:
        for t2 in dev.tiers:
            m = (ta == t1) & (tb == t2)
            if not m.any():
                continue
            _, rows1, len1 = dev.groups[int(t1)]
            _, rows2, len2 = dev.groups[int(t2)]
            idx = _pair_index(np.searchsorted(dev.gidx[int(t1)], idx_a[m]),
                              np.searchsorted(dev.gidx[int(t2)], idx_b[m]), view.device)
            counts = intersect_count(rows1, rows2, idx[0], idx[1], len1, len2)
            out[_index(np.nonzero(m)[0], view.device)] = counts
    return out


@query_span()
def sum_intersect_tiles_view(view, idx_a, idx_b, batch: int = SUM_BATCH) -> int:
    """Sum of |tile_a ∩ tile_b| over many tile pairs, batched on device.

    The workhorse of device-path triangle counting: pair lists can reach
    O(E) entries, so the pair indices go up in batches of ``batch`` pairs
    (12 bytes of indices and count each on the device); the batch sums add
    up in one int64 tensor on the device, read once at the end (one host
    synchronisation per call).
    """
    idx_a = np.asarray(idx_a, np.int64).reshape(-1)
    idx_b = np.asarray(idx_b, np.int64).reshape(-1)
    if idx_a.shape != idx_b.shape:
        raise ValueError("idx_a and idx_b must have matching shapes")
    total = torch.zeros((), dtype=torch.int64, device=view.device)
    for lo in range(0, len(idx_a), batch):
        counts = intersect_tiles_view(
            view, idx_a[lo : lo + batch], idx_b[lo : lo + batch]
        )
        total += counts.sum(dtype=torch.int64)
    return int(total)


__all__ = [
    "intersect_count",
    "intersect_count_hybrid",
    "intersect_count_ref",
    "intersect_tiles_view",
    "sum_intersect_tiles_view",
]
