"""Shard layout for the tile shard plane (:mod:`repro_torch.core.shard_plane`).

A shard is a slot of the plane, not a device: shard ``k`` lives on visible
card ``k % n_cards``, so four shards run on one card as they would on four,
apart from the copies between cards.  On the CPU every shard is ``cpu``.
The multi-process form (one process per card, ``torch.distributed``) is
not part of this module.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..kernels.runtime import default_device


def shard_devices(n_shards: Optional[int] = None, device=None) -> List[torch.device]:
    """The device of each shard of an ``n_shards`` plane.

    ``device`` is where the caller's data lives (``None``: the card, which
    raises without one).  On CUDA, shard ``k`` sits on visible card
    ``k % n_cards`` and ``n_shards`` defaults to the card count; on the CPU
    every shard is ``cpu`` and the default is one shard.
    """
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cpu":
        k = 1 if n_shards is None else int(n_shards)
        cards = None
    elif dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < 1:
            raise RuntimeError("shard_devices: torch sees no CUDA device")
        k = cards if n_shards is None else int(n_shards)
    else:
        raise ValueError(f"shard_devices: no shard plane on {dev}")
    if k < 1:
        raise ValueError(f"n_shards={k}: need at least one shard")
    if cards is None:
        return [torch.device("cpu")] * k
    return [torch.device("cuda", i % cards) for i in range(k)]


__all__ = ["shard_devices"]
