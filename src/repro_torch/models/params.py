"""Parameters carried across from the reference.

The reference's models keep their parameters as pytrees: nested dicts of
arrays, with the LM's layer leaves stacked ``[L, ...]``.  Given such a tree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), the
functions here return the port's parameters with the same keys and shapes,
so both packages compute the same function on the same weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import LMConfig, RecsysConfig
from .bst import bst_shapes
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
    misshapen leaf.  Dense configs."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE parameters come with a later slice")
    return _convert(tree, lm_shapes(cfg), device, dtype, "lm")


def bst_params_from_numpy(cfg: RecsysConfig, tree, *, device,
                          dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference BST's parameter tree (numpy leaves) -> the port's
    parameters on ``device``, which the caller names."""
    return _convert(tree, bst_shapes(cfg), device, dtype, "bst")
