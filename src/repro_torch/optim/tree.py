"""Parameter trees: nested dicts of tensors, as the models keep them."""

from __future__ import annotations

from typing import Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """``tree`` with each leaf ``x`` replaced by ``fn(x, *leaves of rest)``;
    every tree in ``rest`` has ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """``like``'s structure over ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)

    return fill(like)


def leaf_slices(t: torch.Tensor) -> List[torch.Tensor]:
    """Views that tile ``t``: its leading-axis slices when it has 3 or more
    dims (a layer of a stacked weight), else ``t`` itself.  In-place
    updates walk them to keep temporaries one slice large."""
    return list(t) if t.dim() >= 3 else [t]
