"""Shard layouts: the tile shard plane's shard devices and the models' mesh.

A shard is a slot, not a device: shard ``k`` lives on visible card
``k % n_cards``, so four shards run on one card as they would on four,
apart from the copies between cards.  On the CPU every shard is ``cpu``.

``shard_devices`` places the store's shard plane
(:mod:`repro_torch.core.shard_plane`).  ``Mesh`` names the axes of a grid
of such shards for the model side (``make_mesh``: shard ``k`` of the
row-major grid on ``shard_devices(...)[k]``); the sharded forms of the
models run over it through :mod:`repro_torch.launch.collectives`.
``make_production_mesh`` gives the reference's 16 x 16 ``(data, model)``
and 2 x 16 x 16 ``(pod, data, model)`` meshes over such slots.

One process per card.  With ``REPRO_MULTIHOST=1``, :func:`init_distributed`
joins a ``torch.distributed`` group (torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, or arguments) and
:func:`distributed_shard_mesh` builds a 1-D shard mesh whose shard ``k``
belongs to rank ``k % world``, on this rank's card ``LOCAL_RANK %
n_cards``; every rank builds the same store and the same mesh, and holds
only its own shards' tiles.  The backend is an argument: ``nccl`` for
the card, ``gloo`` for the CPU.  NCCL refuses two ranks on one card, so
several ranks share a card only under gloo.  With the flag off (the
default, and the whole test matrix) nothing joins a group and the shard
mesh is :func:`make_shard_mesh` over this process's devices.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.runtime import default_device, indexed


def shard_devices(n_shards: Optional[int] = None, device=None) -> List[torch.device]:
    """The device of each shard of an ``n_shards`` plane.

    ``device`` is where the caller's data lives (``None``: the card, which
    raises without one).  On CUDA, shard ``k`` sits on visible card
    ``k % n_cards`` and ``n_shards`` defaults to the card count; on the CPU
    every shard is ``cpu`` and the default is one shard.
    """
    dev = indexed(device) if device is not None else default_device()
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
    position ``k``; every device is indexed (a bare ``"cuda"`` becomes the
    current card).

    ``ranks`` (a :class:`~repro_torch.launch.collectives.RankGroup`) spreads
    the shards over processes: shard ``k`` belongs to rank ``k % world``,
    and its device is where this rank holds it (for another rank's shard:
    this rank's device, where results for it arrive).  Without ``ranks``
    every shard is this process's."""

    def __init__(self, devices: Sequence[torch.device], shape: Sequence[int],
                 axis_names: Sequence[str], ranks=None):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not name the shape {shape} once each")
        if len(devices) != math.prod(shape):
            raise ValueError(f"{len(devices)} devices for a mesh of shape {shape}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.flat_devices = [indexed(d) for d in devices]
        grid = np.empty(len(devices), dtype=object)
        grid[:] = self.flat_devices
        self.devices = grid.reshape(shape)
        self.ranks = ranks
        world = 1 if ranks is None else ranks.world
        self.owners = [k % world for k in range(len(devices))]
        self._rank = 0 if ranks is None else ranks.rank
        self._memo: Dict[tuple, list] = {}  # (what, axes) -> answer: the mesh never changes

    def is_local(self, k: int) -> bool:
        """True when shard ``k`` belongs to this process."""
        return self.owners[k] == self._rank

    @property
    def local_shards(self) -> List[int]:
        return [k for k in range(self.size) if self.is_local(k)]

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
        where = "" if self.ranks is None else f", {self.ranks}"
        return f"Mesh({self.shape}, devices={sorted(set(map(str, self.flat_devices)))}{where})"


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


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production layout over shard slots: 16 x 16
    ``(data, model)``, or 2 x 16 x 16 ``(pod, data, model)`` with
    ``multi_pod`` (``pod`` extends data parallelism across pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_shard_mesh(n_devices: Optional[int] = None, axis: str = "shard",
                    device=None) -> Mesh:
    """1-D mesh for the tile shard plane over ``shard_devices(n_devices,
    device)``: one shard a visible card by default, all on the CPU for
    ``device="cpu"``."""
    devs = shard_devices(n_devices, device)
    return Mesh(devs, (len(devs),), (axis,))


def multihost_enabled() -> bool:
    """True when ``REPRO_MULTIHOST=1``: the shard mesh spans processes."""
    return os.environ.get("REPRO_MULTIHOST", "") == "1"


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None) -> bool:
    """Join the ``torch.distributed`` group when multi-host is on.

    Flag off (the default, and the whole test matrix) this does nothing
    and returns False.  Flag on, it calls ``init_process_group``: the
    arguments first, else torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``; with none of them set it comes up as a
    single-process group.  ``coordinator_address`` is ``host:port`` or a
    ``tcp://`` or ``file://`` URL.  ``backend`` is ``"nccl"`` (the
    default: the port runs on the card) or ``"gloo"`` (a CPU store, or
    several ranks on one card); it is never switched.  A second call does
    nothing.  Returns True when a group is up.
    """
    if not multihost_enabled():
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    n = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    backend = backend or "nccl"
    if addr is None and n is None and rank is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        return True
    if addr is None or n is None or rank is None:
        raise ValueError("init_distributed: need the coordinator address, the number of "
                         "processes and this process's rank (arguments or MASTER_ADDR/"
                         "MASTER_PORT, WORLD_SIZE, RANK)")
    url = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=url, world_size=int(n), rank=int(rank))
    return True


def distributed_shard_mesh(n_devices: Optional[int] = None, axis: str = "shard",
                           device=None, backend=None) -> Mesh:
    """Shard-plane mesh for one process or one process per card.

    Flag off, exactly :func:`make_shard_mesh`.  With ``REPRO_MULTIHOST=1``
    it joins the group (:func:`init_distributed` with ``backend``: by
    default ``nccl`` for a CUDA ``device``, ``gloo`` for ``"cpu"``) and
    gives ``n_devices`` shards (default: one a rank), shard ``k`` owned by
    rank ``k % world``; this rank's shards sit on ``cuda:LOCAL_RANK %
    n_cards`` (``cpu`` on the CPU).  Every rank must call it with the same
    arguments, and each rank must own at least one shard.
    """
    if not multihost_enabled():
        return make_shard_mesh(n_devices, axis, device)
    from .collectives import RankGroup

    dev = torch.device(device) if device is not None else default_device()
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    init_distributed(backend=backend)
    ranks = RankGroup()
    k = ranks.world if n_devices is None else int(n_devices)
    if k < ranks.world:
        raise ValueError(f"{k} shards over {ranks.world} ranks: each rank needs a shard")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards < 1:
            raise RuntimeError("distributed_shard_mesh: this rank sees no CUDA device")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", ranks.rank)) % cards)
    elif dev.type != "cpu":
        raise ValueError(f"distributed_shard_mesh: no shard plane on {dev}")
    return Mesh([dev] * k, (k,), (axis,), ranks=ranks)


__all__ = ["Mesh", "axes_tuple", "data_axes", "distributed_shard_mesh", "init_distributed",
           "make_host_mesh", "make_mesh", "make_production_mesh", "make_shard_mesh",
           "multihost_enabled", "shard_devices"]
