"""Plain PyTorch versions of leaf-block scan reduction and SpMM (the CPU
path and the kernels' oracles on the card)."""

import torch

SENTINEL = 2**31 - 1


def leaf_scan_reduce_ref(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-block masked gather-sum: y[i] = sum_j x[rows[i, j]], SENTINEL-masked.

    rows: [N, B] int32 neighbor ids; x: [n] float32. Returns [N] float32.
    """
    mask = rows != SENTINEL
    safe = torch.where(mask, rows, 0).long()
    return torch.where(mask, x[safe], 0.0).sum(dim=1)


def leaf_spmm_ref(rows: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Per-block masked gather-sum of feature rows: Y[i] = sum_j H[rows[i,j]].

    rows: [N, B] int32; h: [n, d] float32. Returns [N, d] float32.
    Materializes the [N, B, d] gather.
    """
    mask = rows != SENTINEL
    safe = torch.where(mask, rows, 0).long()
    gathered = h[safe]  # [N, B, d]
    return torch.where(mask[:, :, None], gathered, 0.0).sum(dim=1)
