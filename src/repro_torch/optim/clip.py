"""Global-norm gradient clipping."""

from __future__ import annotations

import torch

from .tree import leaf_slices, tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``clip_by_global_norm`` in place, one ``leaf_slices`` slice at a
    time (bitwise the same values); returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    with torch.no_grad():
        for g in tree_leaves(grads):
            for gs in leaf_slices(g):
                gs.copy_((gs.float() * scale).to(gs.dtype))
    return norm
