"""Plain PyTorch version of batched leaf search (the CPU path and the
kernel's oracle on the card)."""

import torch


def leaf_search_ref(rows: torch.Tensor, targets: torch.Tensor, index=None, length=None):
    """For each query i, find targets[i] in the live prefix of a sorted row.

    rows: [n, B] int32, each row sorted ascending and padded with SENTINEL
    (int32 max).  targets: [Q] int32.  index: [Q] int32, the row of each
    query, in [0, n) (None: row i, and then n == Q); IndexError otherwise.
    length: [n] int32, each row's live ids (None: all B); columns at or past
    it are left out.
    Returns (found [Q] bool, pos [Q] int32) where pos counts the live ids
    below the target (== index of the match when found).
    """
    if index is not None:
        index = index.long()
        if index.numel() and not (0 <= int(index.min()) and int(index.max()) < rows.shape[0]):
            raise IndexError(f"leaf_search: index outside [0, {rows.shape[0]})")
        rows = rows[index]
        if length is not None:
            length = length[index]
    t = targets[:, None]
    less, equal = rows < t, rows == t
    if length is not None:
        live = torch.arange(rows.shape[1], device=rows.device)[None, :] < length[:, None]
        less, equal = less & live, equal & live
    return equal.any(dim=1), less.sum(dim=1, dtype=torch.int32)
