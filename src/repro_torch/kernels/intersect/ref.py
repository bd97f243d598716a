"""Plain PyTorch version of sorted-set intersection counting (the CPU path
and the kernel's oracle on the card)."""

import torch

SENTINEL = 2**31 - 1


def intersect_count_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a_i ∩ b_i| per row for SENTINEL-padded [Q, Ba] and [Q, Bb] int32
    arrays: the all-pairs count #{(p, q): a[i, p] == b[i, q] != SENTINEL}."""
    hit = (a[:, :, None] == b[:, None, :]) & (a[:, :, None] != SENTINEL)
    return hit.sum(dim=(1, 2), dtype=torch.int32)
