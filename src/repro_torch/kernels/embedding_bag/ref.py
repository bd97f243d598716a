"""Plain PyTorch version of EmbeddingBag (the CPU path and the kernel's
oracle on the card): gather + masked weighted sum, as ``ops.py`` of the
reference computes it."""

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      mode: str = "sum") -> torch.Tensor:
    """``out[i] = Σ_k w[i, k] · table[ids[i, k]]`` over ids ≥ 0, in f32.

    table: [V, d]; ids: [N, K] int32 with -1 padding; weights: [N, K] or
    None (1).  ``mean`` divides by ``max(Σ_k w[i, k], 1e-9)``, the sum of
    the live weights, not the count of ids.
    """
    mask = ids >= 0
    rows = table[torch.where(mask, ids, 0).long()].float()  # [N, K, d]
    w = torch.ones_like(ids, dtype=torch.float32) if weights is None else weights.float()
    w = torch.where(mask, w, 0.0)
    out = torch.sum(rows * w[:, :, None], dim=1)
    if mode == "mean":
        out = out / torch.clamp(torch.sum(w, dim=1), min=1e-9)[:, None]
    return out
