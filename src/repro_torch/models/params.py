"""Parameters carried across from the reference.

The reference's models keep their parameters as pytrees: nested dicts of
arrays, with the LM's layer leaves stacked ``[L, ...]``.  Given such a tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), the
functions here return the port's parameters with the same keys and shapes,
so both packages compute the same function on the same weights.  AdamW
state (of any of these trees) comes across too, so both take the same
train step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from ..optim.adamw import AdamWState
from ..optim.tree import tree_leaves, tree_map
from .bst import bst_shapes
from .gnn import gnn_shapes
from .transformer import lm_shapes


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy cannot hand bf16 to torch
        a = a.astype(np.float32)
    t = torch.tensor(a, device=device)  # a copy: the leaves may be read-only
    return t if dtype is None else t.to(dtype)


def _convert(tree, want: Dict, device, dtype, where: str) -> Dict:
    """``tree`` converted leaf by leaf; ``want`` maps each key to its
    expected shape (a tuple) or to the ``want`` of a subtree (a dict)."""
    if set(tree) != set(want):
        raise KeyError(f"{where}: keys {sorted(tree)} != expected {sorted(want)}")
    out = {}
    for key, spec in want.items():
        if isinstance(spec, dict):
            out[key] = _convert(tree[key], spec, device, dtype, f"{where}.{key}")
            continue
        t = _tensor(tree[key], device, dtype)
        if tuple(t.shape) != spec:
            raise ValueError(f"{where}.{key}: shape {tuple(t.shape)} != expected {spec}")
        out[key] = t
    return out


def lm_params_from_numpy(cfg: LMConfig, tree, *, device,
                         dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference LM's parameter tree (numpy leaves) -> the port's
    parameters on ``device``, which the caller names (``"cpu"`` for the
    host), cast to ``dtype`` when given; raises on a missing, extra or
    misshapen leaf.  Dense and MoE configs."""
    return _convert(tree, lm_shapes(cfg), device, dtype, "lm")


def bst_params_from_numpy(cfg: RecsysConfig, tree, *, device,
                          dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference BST's parameter tree (numpy leaves) -> the port's
    parameters on ``device``, which the caller names."""
    return _convert(tree, bst_shapes(cfg), device, dtype, "bst")


def gnn_params_from_numpy(cfg: GNNConfig, tree, d_feat: int, *, device,
                          dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference GNN's parameter tree (numpy leaves) -> the port's
    parameters on ``device``, which the caller names."""
    return _convert(tree, gnn_shapes(cfg, d_feat), device, dtype, "gnn")


def adamw_state_from_numpy(state, params, *, device) -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves, or anything
    ``np.asarray`` takes) -> the port's, on ``device``, for the port's
    ``params`` (the moments must have their keys and shapes); each moment
    keeps its dtype (bf16 by default)."""
    want = tree_map(lambda t: tuple(t.shape), params)

    def moments(tree, what):
        dtype = getattr(torch, np.asarray(tree_leaves(tree)[0]).dtype.name)
        return _convert(tree, want, device, dtype, what)

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device)
    return AdamWState(step=step, mu=moments(state.mu, "mu"), nu=moments(state.nu, "nu"))
