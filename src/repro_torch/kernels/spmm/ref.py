"""Plain PyTorch versions of leaf-block scan reduction and SpMM (the CPU
path and the kernels' oracles on the card)."""

import torch

SENTINEL = 2**31 - 1


def live_mask(rows: torch.Tensor, length=None) -> torch.Tensor:
    """[N, B] bool: ids that are not SENTINEL and, where ``length`` ([N]
    int32) is given, lie before their row's live length."""
    mask = rows != SENTINEL
    if length is not None:
        mask &= torch.arange(rows.shape[1], device=rows.device)[None, :] < length[:, None]
    return mask


def leaf_scan_reduce_ref(rows: torch.Tensor, x: torch.Tensor, length=None) -> torch.Tensor:
    """Per-block masked gather-sum: y[i] = sum_j x[rows[i, j]].

    rows: [N, B] int32 neighbor ids; x: [n] float32; length: [N] int32,
    each row's live ids (None: all B), columns at or past it left out.
    SENTINEL is masked either way.  Returns [N] float32.
    """
    mask = live_mask(rows, length)
    safe = torch.where(mask, rows, 0).long()
    return torch.where(mask, x[safe], 0.0).sum(dim=1)


def leaf_spmm_ref(rows: torch.Tensor, h: torch.Tensor, length=None) -> torch.Tensor:
    """Per-block masked gather-sum of feature rows: Y[i] = sum_j H[rows[i,j]].

    rows: [N, B] int32; h: [n, d] float32; length: [N] int32, each row's
    live ids (None: all B), columns at or past it left out.  SENTINEL is
    masked either way, so on a row that is a live prefix followed by
    SENTINEL padding both forms agree.  Returns [N, d] float32.
    Materializes the [N, B, d] gather.
    """
    mask = live_mask(rows, length)
    safe = torch.where(mask, rows, 0).long()
    gathered = h[safe]  # [N, B, d]
    return torch.where(mask[:, :, None], gathered, 0.0).sum(dim=1)
