"""EmbeddingBag (sum/mean, -1 padding): the CUDA kernel
(``csrc/embedding_bag.cu``) on the card, the plain version on the CPU."""

from __future__ import annotations

import torch

from ..runtime import (check, check_operands, count_launch, cuda_input, kernel_fn,
                       launch_on, on_cpu, stream_ptr)
from .ref import embedding_bag_ref

MODES = {"sum": 0, "mean": 1}


def embedding_bag(table, ids, weights=None, mode: str = "sum") -> torch.Tensor:
    """Weighted bag reduction of table rows -> [N, d] f32 on ``table``'s device.

    table: [V, d] f32; ids: [N, K] int32, -1 pads (ids must lie in
    [-1, V)); weights: [N, K] f32 or None (1).  ``mean`` divides by
    ``max(Σ live weights, 1e-9)``.  The kernel reads rows 16 bytes a lane,
    so on the card d must be a multiple of 4 and the table 16-byte aligned.
    """
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r} is not sum or mean")
    table = torch.as_tensor(table)
    check_operands("embedding_bag", table, ids, weights)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=table.device)
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=torch.float32, device=table.device)
    if on_cpu(table, "embedding_bag"):
        return embedding_bag_ref(table, ids, weights, mode)
    table = cuda_input(table, torch.float32, 2, "embedding_bag table")
    ids = cuda_input(ids, torch.int32, 2, "embedding_bag ids")
    if weights is not None:
        weights = cuda_input(weights, torch.float32, 2, "embedding_bag weights")
        if weights.shape != ids.shape:
            raise ValueError("embedding_bag: weights and ids disagree in shape")
    n, k = ids.shape
    v, d = table.shape
    if d % 4 or table.data_ptr() % 16:
        raise ValueError(f"embedding_bag: no kernel for d={d} or a table not 16-byte "
                         "aligned: rows are read as float4")
    out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    if n and d:
        fn = kernel_fn("embedding_bag", "embedding_bag_launch", "ppppliliip")
        with launch_on(table.device):
            check(fn(table.data_ptr(), ids.data_ptr(),
                     weights.data_ptr() if weights is not None else None,
                     out.data_ptr(), n, k, v, d, MODES[mode], stream_ptr(table)),
                  "embedding_bag")
        count_launch(embedding_bag, table.device)
    return out


embedding_bag.launches = 0

__all__ = ["embedding_bag", "embedding_bag_ref"]
