"""Plain PyTorch version of sorted-set intersection counting (the CPU path
and the kernel's oracle on the card)."""

import torch

SENTINEL = 2**31 - 1


def _live_rows(x: torch.Tensor, index, length, what: str) -> torch.Tensor:
    """The rows of ``x`` that ``index`` names (all rows for None), with the
    columns at or past each row's ``length`` set to SENTINEL."""
    if index is not None:
        index = index.long()
        if index.numel() and not (0 <= int(index.min()) and int(index.max()) < x.shape[0]):
            raise IndexError(f"intersect_count: index_{what} outside [0, {x.shape[0]})")
        x = x[index]
        if length is not None:
            length = length[index]
    if length is not None:
        live = torch.arange(x.shape[1], device=x.device)[None, :] < length[:, None]
        x = torch.where(live, x, SENTINEL)
    return x


def intersect_count_ref(a: torch.Tensor, b: torch.Tensor, index_a=None, index_b=None,
                        length_a=None, length_b=None) -> torch.Tensor:
    """|a_i ∩ b_i| per pair: the all-pairs count
    #{(p, q): a[i, p] == b[i, q] != SENTINEL}.

    a: [n_a, Ba], b: [n_b, Bb] int32, SENTINEL-padded.  index_a, index_b:
    [Q] int32, the row of each pair (None: row i); an index outside
    [0, n) raises IndexError.  length_a [n_a], length_b [n_b]: each row's
    live ids (None: the full width); columns at or past it are left out.
    """
    a = _live_rows(a, index_a, length_a, "a")
    b = _live_rows(b, index_b, length_b, "b")
    hit = (a[:, :, None] == b[:, None, :]) & (a[:, :, None] != SENTINEL)
    return hit.sum(dim=(1, 2), dtype=torch.int32)
