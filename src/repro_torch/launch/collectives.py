"""Collectives over a :class:`~repro_torch.launch.mesh.Mesh`, in one process.

The port's stand-in for ``shard_map``.  A sharded value is a list of
per-shard tensors, element ``k`` on the mesh's device of flat shard ``k``;
``shard`` cuts a tensor into such a list by a ``P`` spec and ``unshard``
puts one back together.  A sharded form of a model is written as the
reference's per-shard body, looped over the shards, with these
collectives where the body calls ``jax.lax``'s:

- ``axis_index``: each shard's linear index over one axis or a tuple of
  axes, major to minor in the order given (``jax.lax.axis_index``);
- ``all_gather`` (``tiled`` concatenates, else stacks), ``psum``, ``pmax``
  and ``psum_scatter`` over the groups of shards that agree on every other
  axis.

Each reduction combines a group's members in shard order on the group's
first device, then places the result on every member's device: one tensor
per distinct device, shared by the members on it (no copy on one card).
A gather orders its pieces by ``axis_index``.  Everything is out of place
and built from differentiable torch ops (slices, ``.to``, ``cat``, ``+``),
so autograd runs through the collectives; their gradients are those of
the same sums written on one device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh


class P(tuple):
    """A partition spec: per leading dim of a tensor, ``None`` (whole), an
    axis name, or a tuple of axis names (the dim split over their product,
    major to minor).  Dims past the spec's length are whole; axes the spec
    never names replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _spec_axes(mesh: Mesh, spec: Optional[P]) -> List[Tuple[int, Tuple[str, ...]]]:
    """``(dim, axes)`` of each split dim of ``spec``; raises ValueError
    where an axis is unknown or named twice."""
    out, seen = [], []
    for dim, names in enumerate(P() if spec is None else spec):
        if names is not None:
            axes = mesh._check(names)
            seen += axes
            out.append((dim, axes))
    if len(set(seen)) != len(seen):
        raise ValueError(f"spec {spec} names a mesh axis twice")
    return out


def spec_splits(shape, mesh: Mesh, spec: Optional[P]) -> List[Tuple[int, Tuple[str, ...]]]:
    """``(dim, axes)`` of each split dim of a tensor of ``shape`` under
    ``spec``; raises ValueError where a dim does not divide."""
    if spec is not None and len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the shape {tuple(shape)}")
    splits = _spec_axes(mesh, spec)
    for dim, axes in splits:
        n = mesh.axis_size(axes)
        if shape[dim] % n:
            raise ValueError(f"dim {shape[dim]} not divisible by {n} ({axes}) "
                             f"on mesh {mesh.shape}")
    return splits


def shard(x: torch.Tensor, mesh: Mesh, spec: P) -> List[torch.Tensor]:
    """``x`` cut by ``spec`` into one block a shard, each on its shard's
    device: views of ``x`` for shards on its device, one copy each for the
    others (a replicated block: one copy per device)."""
    splits = [(dim, x.shape[dim] // mesh.axis_size(axes), mesh.axis_index(axes))
              for dim, axes in spec_splits(x.shape, mesh, spec)]
    copies: Dict[tuple, torch.Tensor] = {}
    out = []
    for k, dev in enumerate(mesh.flat_devices):
        blk = x
        for dim, size, index in splits:
            blk = blk.narrow(dim, index[k] * size, size)
        key = (dev, blk.storage_offset(), tuple(blk.shape))
        if key not in copies:
            copies[key] = blk.to(dev)
        out.append(copies[key])
    return out


def unshard(parts: Sequence[torch.Tensor], mesh: Mesh, spec: P,
            device=None) -> torch.Tensor:
    """The tensor whose ``shard(., mesh, spec)`` is ``parts``, on ``device``
    (default: shard 0's).  Of the shards that hold one block (replicas over
    axes the spec does not name), the first in shard order gives it."""
    device = torch.device(device) if device is not None else mesh.flat_devices[0]
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} shards")
    splits = [(dim, axes, mesh.axis_index(axes)) for dim, axes in
              _spec_axes(mesh, spec)]
    blocks: Dict[tuple, torch.Tensor] = {}
    for k, part in enumerate(parts):
        blocks.setdefault(tuple(index[k] for _, _, index in splits), part)

    def build(prefix: tuple) -> torch.Tensor:
        if len(prefix) == len(splits):
            return blocks[prefix].to(device)
        dim, axes, _ = splits[len(prefix)]
        pieces = [build(prefix + (i,)) for i in range(mesh.axis_size(axes))]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)

    return build(())


def axis_index(mesh: Mesh, axes) -> List[int]:
    """Each shard's linear index over ``axes``, major to minor in the order given."""
    return mesh.axis_index(axes)


def _place(x: torch.Tensor, members: Sequence[int], mesh: Mesh,
           out: List[Optional[torch.Tensor]]) -> None:
    """``x`` on each member's device: one tensor per distinct device."""
    copies = {x.device: x}
    for k in members:
        dev = mesh.flat_devices[k]
        if dev not in copies:
            copies[dev] = x.to(dev)
        out[k] = copies[dev]


def _reduce(parts: Sequence[torch.Tensor], mesh: Mesh, axes, op: Callable,
            scatter: Optional[Callable] = None) -> List[torch.Tensor]:
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axes):
        order = sorted(group)  # shard order
        dev = mesh.flat_devices[order[0]]
        acc = parts[order[0]].to(dev)
        for k in order[1:]:
            acc = op(acc, parts[k].to(dev))
        if scatter is None:
            _place(acc, group, mesh, out)
        else:
            for i, k in enumerate(group):  # axis_index order
                _place(scatter(acc, i), [k], mesh, out)
    return out


def psum(parts: Sequence[torch.Tensor], mesh: Mesh, axes) -> List[torch.Tensor]:
    """Sum over each group of ``axes``, on every member."""
    return _reduce(parts, mesh, axes, torch.add)


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh, axes) -> List[torch.Tensor]:
    """Elementwise max over each group of ``axes``, on every member."""
    return _reduce(parts, mesh, axes, torch.maximum)


def psum_scatter(parts: Sequence[torch.Tensor], mesh: Mesh, axes,
                 scatter_dimension: int = 0, tiled: bool = False) -> List[torch.Tensor]:
    """The group's sum cut along ``scatter_dimension`` into as many blocks
    as members; the member of ``axis_index`` i keeps block i.  Without
    ``tiled`` that dim must equal the group's size and is dropped."""
    n = mesh.axis_size(axes)
    d = scatter_dimension
    size = parts[0].shape[d]
    if (size % n) if tiled else (size != n):
        raise ValueError(f"psum_scatter: dim {d} of size {size} over {n} shards")

    def block(acc, i):
        return acc.narrow(d, i * (size // n), size // n) if tiled else acc.select(d, i)

    return _reduce(parts, mesh, axes, torch.add, scatter=block)


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, axes, axis: int = 0,
               tiled: bool = False) -> List[torch.Tensor]:
    """Each group's pieces in ``axis_index`` order, concatenated along
    ``axis`` (``tiled``) or stacked on a new ``axis``, on every member."""
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    join = torch.cat if tiled else torch.stack
    for group in mesh.groups(axes):
        done: Dict[torch.device, torch.Tensor] = {}
        for k in group:
            dev = mesh.flat_devices[k]
            if dev not in done:
                done[dev] = join([parts[j].to(dev) for j in group], dim=axis)
            out[k] = done[dev]
    return out


__all__ = ["P", "all_gather", "axis_index", "pmax", "psum", "psum_scatter", "shard",
           "spec_splits", "unshard"]
