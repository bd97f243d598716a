"""Plain PyTorch version of batched leaf search (the CPU path and the
kernel's oracle on the card)."""

import torch


def leaf_search_ref(rows: torch.Tensor, targets: torch.Tensor):
    """For each query i, find targets[i] in the sorted padded row rows[i].

    rows: [Q, B] int32 sorted ascending, padded with SENTINEL (int32 max).
    targets: [Q] int32.
    Returns (found [Q] bool, pos [Q] int32) where pos is the insertion index
    (== index of the match when found).
    """
    t = targets[:, None]
    pos = (rows < t).sum(dim=1, dtype=torch.int32)
    found = (rows == t).any(dim=1)
    return found, pos
