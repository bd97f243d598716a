"""Elastic resharding: move a checkpoint between mesh shapes.

Checkpoints store full (unsharded) logical arrays, so elasticity reduces to
placing them anew on another mesh's shards: recover from 8 shards onto 2,
or grow 2 -> 8, without rewriting files.  Divisibility is validated up
front, so a bad target mesh fails loudly before any copy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..launch.collectives import P, shard


def _walk(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over ``tree``; ``spec_tree`` has ``tree``'s dict
    keys, or a ``P`` (or anything else: replicated) for a whole subtree."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, spec_tree if isinstance(spec_tree, P) or
                         not isinstance(spec_tree, dict) else spec_tree[k])
                for k, v in tree.items()}
    return fn(tree, spec_tree)


def validate_specs(tree: Any, spec_tree: Any, mesh) -> None:
    """Check every sharded dim divides under ``mesh`` (raises ValueError)."""

    def check(leaf, spec):
        if not isinstance(spec, P):
            return
        for dim, names in zip(np.shape(leaf), tuple(spec)):
            if names is None:
                continue
            names = names if isinstance(names, tuple) else (names,)
            n = 1
            for a in names:
                n *= mesh.shape[a]
            if dim % n != 0:
                raise ValueError(
                    f"dim {dim} not divisible by {n} ({names}) on mesh {mesh.shape}"
                )

    _walk(check, tree, spec_tree)


def reshard(tree: Any, spec_tree: Any, mesh) -> Any:
    """Place host arrays onto ``mesh`` with the given ``P`` specs: each leaf
    becomes a list of per-shard tensors on the shards' devices (a block a
    shard for a sharded leaf; one copy a device, shared by the shards on
    it, for a replicated one).  ``collectives.unshard`` gives the whole
    array back."""
    validate_specs(tree, spec_tree, mesh)

    def place(leaf, spec):
        return shard(torch.as_tensor(np.asarray(leaf)), mesh,
                     spec if isinstance(spec, P) else P())

    return _walk(place, tree, spec_tree)
