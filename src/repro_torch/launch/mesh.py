"""Shard layouts: the tile shard plane's shard devices and the models' mesh.

A shard is a slot, not a device: shard ``k`` lives on visible card
``k % n_cards``, so four shards run on one card as they would on four,
apart from the copies between cards.  On the CPU every shard is ``cpu``.

``shard_devices`` places the store's shard plane
(:mod:`repro_torch.core.shard_plane`).  ``Mesh`` names the axes of a grid
of such shards for the model side (``make_mesh``: shard ``k`` of the
row-major grid on ``shard_devices(...)[k]``); the sharded forms of the
models run over it in one process through
:mod:`repro_torch.launch.collectives`.  The multi-process form (one
process per card, ``torch.distributed``) and the production meshes of 256
or 512 shards are not part of this module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
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


def axes_tuple(axes) -> Tuple[str, ...]:
    """One axis name or a tuple of them, as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes over a grid of shards: ``shape`` maps each axis name to
    its size, in order; ``devices`` is the grid of ``torch.device`` (a
    numpy object array of that shape), flat shard ``k`` at its row-major
    position ``k``."""

    def __init__(self, devices: Sequence[torch.device], shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not name the shape {shape} once each")
        if len(devices) != math.prod(shape):
            raise ValueError(f"{len(devices)} devices for a mesh of shape {shape}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.flat_devices = [torch.device(d) for d in devices]
        grid = np.empty(len(devices), dtype=object)
        grid[:] = self.flat_devices
        self.devices = grid.reshape(shape)
        self._memo: Dict[tuple, list] = {}  # (what, axes) -> answer: the mesh never changes

    @property
    def size(self) -> int:
        return len(self.flat_devices)

    def coords(self, k: int) -> Dict[str, int]:
        """Shard ``k``'s index along each axis."""
        at = np.unravel_index(k, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, at)}

    def axis_index(self, axes) -> List[int]:
        """Each shard's linear index over ``axes`` (one name or a tuple),
        major to minor in the order given, as ``jax.lax.axis_index`` over a
        tuple of axes counts."""
        axes = self._check(axes)
        key = ("index", axes)
        if key not in self._memo:
            out = []
            for k in range(self.size):
                c, idx = self.coords(k), 0
                for a in axes:
                    idx = idx * self.shape[a] + c[a]
                out.append(idx)
            self._memo[key] = out
        return list(self._memo[key])

    def groups(self, axes) -> List[List[int]]:
        """The shards that a collective over ``axes`` joins: one list per
        group (the shards that agree on every other axis), each in the
        order of ``axis_index(axes)``; groups in the order of their first
        shard."""
        axes = self._check(axes)
        key = ("groups", axes)
        if key not in self._memo:
            idx = self.axis_index(axes)
            by_key: Dict[tuple, List[int]] = {}
            for k in range(self.size):
                c = self.coords(k)
                by_key.setdefault(tuple(c[a] for a in self.axis_names if a not in axes),
                                  []).append(k)
            self._memo[key] = [sorted(g, key=idx.__getitem__) for g in by_key.values()]
        return [list(g) for g in self._memo[key]]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._check(axes))

    def _check(self, axes) -> Tuple[str, ...]:
        axes = axes_tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of the mesh {self.shape}")
        return axes

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted(set(map(str, self.flat_devices)))})"


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``: shard ``k`` (row-major)
    on ``shard_devices(prod(shape), device)[k]``, so on the card shard ``k``
    sits on card ``k % n_cards``; ``device`` ``"cpu"`` puts every shard on
    the CPU, ``None`` on the card."""
    shape = tuple(int(s) for s in shape)
    return Mesh(shard_devices(math.prod(shape), device), shape, axes_tuple(axes))


def make_host_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh with every shard on the CPU: CPU integration tests."""
    return make_mesh(shape, axes, device="cpu")


def data_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes: ('pod', 'data') on multi-pod, ('data',) else."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


__all__ = ["Mesh", "axes_tuple", "data_axes", "make_host_mesh", "make_mesh", "shard_devices"]
