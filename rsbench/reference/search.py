"""The plain reference for edge searches, over the replayed edge set as
sorted int64 keys ``(u << 32) | v``: ``contains`` says whether each
(u, v) is an edge, by ``torch.searchsorted``.

The control passes ``low=True``: each neighbour id is compared as
bfloat16 (sources stay exact), the precision below the configuration's
float32.  Nothing here imports JAX, the JAX package or the program.
"""

from __future__ import annotations

import torch


def _low(ids: torch.Tensor) -> torch.Tensor:
    """Ids rounded through bfloat16 (the control's precision)."""
    return ids.to(torch.bfloat16).to(torch.int64)


def sorted_keys(src: torch.Tensor, dst: torch.Tensor, low: bool = False) -> torch.Tensor:
    """The edges' keys, sorted (left as they are where they already are);
    with ``low``, each destination rounded through bfloat16 first."""
    dst = _low(dst.long()) if low else dst.long()
    keys = (src.long() << 32) | dst
    if keys.numel() > 1 and not bool((keys[1:] >= keys[:-1]).all()):
        keys = torch.sort(keys).values
    return keys


def _find(keys: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    if keys.numel() == 0:
        return torch.zeros(probe.shape, dtype=torch.bool, device=probe.device)
    pos = torch.searchsorted(keys, probe).clamp(max=keys.numel() - 1)
    return keys[pos] == probe


def contains(keys: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
             low: bool = False) -> torch.Tensor:
    """bool [Q]: whether (us[i], vs[i]) is among ``keys`` (made by
    :func:`sorted_keys` with the same ``low``)."""
    vs = _low(vs.long()) if low else vs.long()
    return _find(keys, (us.long() << 32) | vs)
