"""Collectives over a :class:`~repro_torch.launch.mesh.Mesh`.

The port's stand-in for ``shard_map``.  A sharded value is a list of
per-shard tensors, element ``k`` on the mesh's device of flat shard ``k``;
``shard`` cuts a tensor into such a list by a ``P`` spec and ``unshard``
puts one back together.  State that stays sharded (a table, expert
weights, a KV cache) is cut once by ``place`` into a :class:`Placed`: its
blocks live on their shards' cards, and ``shard`` hands them back as
they are, so a call moves no parameter or cache bytes between cards.  A
sharded form of a model is written as the reference's per-shard body,
looped over the shards, with these collectives where the body calls
``jax.lax``'s:

- ``axis_index``: each shard's linear index over one axis or a tuple of
  axes, major to minor in the order given (``jax.lax.axis_index``);
- ``all_gather`` (``tiled`` concatenates, else stacks), ``psum``, ``pmax``
  and ``psum_scatter`` over the groups of shards that agree on every other
  axis.

Each reduction combines a group's members in shard order on the group's
first device, then places the result on every member's device: one tensor
per distinct device, shared by the members on it (no copy on one card).
bf16 and f16 parts accumulate in f32 and round once, at the end, as XLA's
all-reduce does.  A gather orders its pieces by ``axis_index``.
Everything is out of place and built from differentiable torch ops
(slices, ``.to``, ``cat``, ``+``), so autograd runs through the
collectives; their gradients are those of the same sums written on one
device.  The shard plane's merges (:func:`merge`, :func:`replicate`) are
the same reduction over a plain list of partials.

Across processes.  A mesh from
:func:`~repro_torch.launch.mesh.distributed_shard_mesh` spreads its shards
over the ranks of a ``torch.distributed`` group (:class:`RankGroup`):
shard ``k`` belongs to rank ``k % world``, and a sharded value holds
tensors only for this rank's shards (``None`` for the others).  A rank
first combines its own shards in shard order, then the ranks combine with
``dist.all_reduce`` (SUM, MAX or MIN; bf16 and f16 in f32, rounded once
after it).  That is the only call the backend makes: gloo offers nothing
else for CUDA tensors (no ``reduce_scatter``, no ``all_gather``), so a
gather is an all-reduce SUM of a zero buffer in which each rank fills its
own shards' slots (adding zeros is exact), and ``psum_scatter`` is a
``psum`` whose members keep their block.  Sums across ranks add in the
backend's order, not shard order; min, max, gathers and sums in which
one rank holds each nonzero term are exact either way.  ``unshard`` needs
every shard in this process.

While a :class:`~repro_torch.roofline.comm.CommCounter` is active, each
collective records itself: in one process by the ring model over its
group of shards (what the devices would move), across processes each
``dist.all_reduce`` the backend makes, over the world.  ``shard``
records the bytes it copies to another device under ``"shard-copy"``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..roofline import comm
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


def _layout(spec: Optional[P]) -> Tuple:
    """``spec`` with each entry as ``None`` or a tuple of axis names and
    trailing ``None`` dropped: equal layouts compare equal."""
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in (P() if spec is None else spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _blocks(x: torch.Tensor, mesh: Mesh, spec: P, move: Callable) -> List:
    """``move(block, device)`` of each local shard's block of ``x`` under
    ``spec``, once per distinct (device, block): shards that hold the same
    block on one device share the tensor; ``None`` for other ranks'."""
    splits = [(dim, x.shape[dim] // mesh.axis_size(axes), mesh.axis_index(axes))
              for dim, axes in spec_splits(x.shape, mesh, spec)]
    copies: Dict[tuple, torch.Tensor] = {}
    out = []
    for k, dev in enumerate(mesh.flat_devices):
        if not mesh.is_local(k):
            out.append(None)
            continue
        blk = x
        for dim, size, index in splits:
            blk = blk.narrow(dim, index[k] * size, size)
        key = (dev, blk.storage_offset(), tuple(blk.shape))
        if key not in copies:
            copies[key] = move(blk, dev)
        out.append(copies[key])
    return out


class Placed:
    """A tensor of ``shape`` cut once over ``mesh`` by ``spec``: ``parts[k]``
    is shard ``k``'s block, resident on its shard's device (one tensor per
    distinct device and block, shared by the shards that hold it; ``None``
    for other ranks' shards).  ``device`` is its home, where results for
    the whole tensor go.  ``shard(placed, mesh, spec)`` returns ``parts``
    as they are.  Indexing the leading dim (which ``spec`` must leave
    whole) gives a ``Placed`` of that slice, so a layer-stacked leaf
    ``[L, ...]`` yields its layers without a copy; ``to(dtype)`` casts the
    blocks in place of the whole (free when the dtype is theirs)."""

    def __init__(self, parts: Sequence[Optional[torch.Tensor]], mesh: Mesh, spec: P,
                 shape, dtype: torch.dtype, device) -> None:
        self.parts, self.mesh, self.spec = list(parts), mesh, P(*_layout(spec))
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device(device)

    def dim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Bytes of this rank's distinct blocks."""
        seen = {id(p): p.nbytes for p in self.parts if p is not None}
        return sum(seen.values())

    def _each(self, fn: Callable) -> List[Optional[torch.Tensor]]:
        """``fn`` of each distinct block once, in ``parts``' order."""
        done: Dict[int, torch.Tensor] = {}
        return [None if p is None else done.setdefault(id(p), fn(p)) for p in self.parts]

    def __getitem__(self, i: int) -> "Placed":
        if not isinstance(i, int) or (self.spec and self.spec[0] is not None):
            raise TypeError(f"Placed{tuple(self.shape)} under {self.spec}: only an int "
                            "index of an unsplit leading dim")
        return Placed(self._each(lambda p: p[i]), self.mesh, P(*self.spec[1:]),
                      self.shape[1:], self.dtype, self.device)

    def to(self, dtype: torch.dtype) -> "Placed":
        if dtype == self.dtype:
            return self
        return Placed(self._each(lambda p: p.to(dtype)), self.mesh, self.spec, self.shape,
                      dtype, self.device)

    def write(self, dim: int, index: int, value: torch.Tensor) -> None:
        """``whole.select(dim, index).copy_(value)`` into the blocks that
        hold position ``index`` of ``dim``: ``value`` (the whole slice, on
        any device) is cut by the rest of ``spec``, and each holder copies
        its block of it in place."""
        spec = list(self.spec) + [None] * (self.dim() - len(self.spec))
        axes = spec.pop(dim)
        vals = shard(value.to(self.dtype), self.mesh, P(*spec))
        size = self.shape[dim] // (1 if axes is None else self.mesh.axis_size(axes))
        at = [0] * self.mesh.size if axes is None else self.mesh.axis_index(axes)
        for k, part in enumerate(self.parts):
            if part is not None and at[k] * size <= index < (at[k] + 1) * size:
                part.select(dim, index - at[k] * size).copy_(vals[k])

    def __repr__(self) -> str:
        return f"Placed({tuple(self.shape)}, {self.dtype}, {self.spec}, {self.mesh})"


def place(x: torch.Tensor, mesh: Mesh, spec: P) -> Placed:
    """``x`` cut once by ``spec``: each block a contiguous tensor of its
    own on its shard's device (a replicated block: one per device), so
    nothing of ``x`` stays referenced and dropping ``x`` frees it."""
    parts = _blocks(x, mesh, spec, lambda blk, dev: blk.to(
        dev, copy=True, memory_format=torch.contiguous_format))
    return Placed(parts, mesh, spec, x.shape, x.dtype, x.device)


def place_zeros(shape, dtype: torch.dtype, mesh: Mesh, spec: P) -> Placed:
    """A zero tensor of ``shape`` placed by ``spec``, each block allocated on
    its shard's device (the whole tensor never exists)."""
    whole = torch.empty(shape, dtype=dtype, device="meta")  # its shape only, no memory
    parts = _blocks(whole, mesh, spec,
                    lambda blk, dev: torch.zeros(blk.shape, dtype=dtype, device=dev))
    return Placed(parts, mesh, spec, whole.shape, dtype, mesh.flat_devices[0])


def shard(x, mesh: Mesh, spec: P) -> List[torch.Tensor]:
    """``x`` cut by ``spec`` into one block a shard, each on its shard's
    device: views of ``x`` for shards on its device, one copy each for the
    others (a replicated block: one copy per device), whose bytes go to
    the active counters as ``"shard-copy"``; ``None`` for the shards of
    other ranks.  A :class:`Placed` ``x`` placed on ``mesh`` by ``spec``
    gives its blocks back as they are (another layout raises ValueError)."""
    if isinstance(x, Placed):
        if x.mesh is not mesh or _layout(x.spec) != _layout(spec):
            raise ValueError(f"{x} is not placed on {mesh} by {spec}")
        return list(x.parts)

    def move(blk, dev):
        if blk.device != dev:
            comm.record_copy(blk.nbytes)
        return blk.to(dev)

    return _blocks(x, mesh, spec, move)


def unshard(parts: Sequence[torch.Tensor], mesh: Mesh, spec: P,
            device=None) -> torch.Tensor:
    """The tensor whose ``shard(., mesh, spec)`` is ``parts``, on ``device``
    (default: shard 0's).  Of the shards that hold one block (replicas over
    axes the spec does not name), the first in shard order gives it."""
    device = torch.device(device) if device is not None else mesh.flat_devices[0]
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} shards")
    if not all(mesh.is_local(k) for k in range(mesh.size)):
        raise ValueError("unshard: the mesh spans processes; gather the parts first")
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


_NARROW = (torch.bfloat16, torch.float16)


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in _NARROW else t


def _accumulate(parts: Sequence[torch.Tensor], op: Callable) -> torch.Tensor:
    """``op`` over ``parts`` in order, bf16 and f16 in f32 (not rounded)."""
    acc = _wide(parts[0])
    for p in parts[1:]:
        acc = op(acc, _wide(p))
    return acc


_DIST_OPS = {torch.add: "SUM", torch.maximum: "MAX", torch.minimum: "MIN"}


def _identity(op: Callable, like: torch.Tensor) -> torch.Tensor:
    """The element that ``op`` leaves unchanged, shaped as ``like``."""
    if op is torch.add:
        return torch.zeros_like(like)
    if like.is_floating_point():
        lo, hi = float("-inf"), float("inf")
    else:
        lo, hi = torch.iinfo(like.dtype).min, torch.iinfo(like.dtype).max
    return torch.full_like(like, lo if op is torch.maximum else hi)


class RankGroup:
    """The processes of a ``torch.distributed`` group, for the shard plane
    and the meshes over it.  Its one call is ``dist.all_reduce``."""

    def __init__(self, group=None) -> None:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("RankGroup: torch.distributed is not initialized "
                               "(launch.mesh.init_distributed)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))

    def all_reduce(self, x: torch.Tensor, op: Callable) -> torch.Tensor:
        """``op`` (``torch.add``, ``torch.maximum`` or ``torch.minimum``)
        of every rank's ``x``, on every rank; ``x`` is not changed.  bf16
        and f16 reduce in f32 and round once."""
        import torch.distributed as dist

        if op not in _DIST_OPS:
            raise ValueError(f"RankGroup.all_reduce: no reduce op for {op}")
        buf = _wide(x).clone(memory_format=torch.contiguous_format)
        if buf.dtype == torch.bool:
            buf = buf.to(torch.uint8)
        comm.record("all-reduce", buf.nbytes, buf.nbytes, self.world)
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, _DIST_OPS[op]), group=self.group)
        return buf.to(x.dtype)

    def __repr__(self) -> str:
        return f"RankGroup(rank={self.rank}, world={self.world}, backend={self.backend})"


def merge(parts: Sequence[torch.Tensor], op: Callable,
          ranks: Optional[RankGroup] = None) -> torch.Tensor:
    """The shard plane's merge: per-shard partials combined with ``op`` in
    shard order on ``parts[0]``'s device (bf16 and f16 in f32, rounded
    once); with ``ranks``, ``parts`` are this rank's shards' and the ranks'
    results then combine with ``dist.all_reduce``."""
    dtype = parts[0].dtype
    acc = _accumulate([p.to(parts[0].device) for p in parts], op)
    if ranks is not None:
        acc = ranks.all_reduce(acc, op)
    return acc.to(dtype)


def replicate(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each of ``devices``: one copy per distinct device, none for
    a device that is ``x``'s own."""
    copies = {x.device: x}
    return [copies.setdefault(torch.device(d), x.to(d)) for d in devices]


def _place(x: torch.Tensor, members: Sequence[int], mesh: Mesh,
           out: List[Optional[torch.Tensor]]) -> None:
    """``x`` on each member's device (this rank's members only): one tensor
    per distinct device."""
    local = [k for k in members if mesh.is_local(k)]
    for k, y in zip(local, replicate(x, [mesh.flat_devices[k] for k in local])):
        out[k] = y


def _reduce(parts: Sequence[torch.Tensor], mesh: Mesh, axes, op: Callable,
            scatter: Optional[Callable] = None) -> List[Optional[torch.Tensor]]:
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    groups = mesh.groups(axes)
    accs, dtype = [], None
    for group in groups:
        order = [k for k in sorted(group) if mesh.is_local(k)]  # shard order
        if order:
            dev = mesh.flat_devices[order[0]]
            dtype = parts[order[0]].dtype
            accs.append(_accumulate([parts[k].to(dev) for k in order], op))
        else:
            accs.append(None)
    if mesh.ranks is not None:  # one all-reduce of every group's slot
        like = next(a for a in accs if a is not None)
        slots = torch.stack([(a if a is not None else _identity(op, like)).to(like.device)
                             for a in accs])
        accs = list(mesh.ranks.all_reduce(slots, op).unbind(0))
    for group, acc in zip(groups, accs):
        acc = acc.to(dtype)
        if scatter is None:
            _place(acc, group, mesh, out)
        else:
            for i, k in enumerate(group):  # axis_index order
                _place(scatter(acc, i), [k], mesh, out)
    return out


def _record(mesh: Mesh, op: str, operand: torch.Tensor, result_bytes: int, axes) -> None:
    """A one-process collective into the active counters (across processes
    the backend records its own calls)."""
    if mesh.ranks is None:
        comm.record(op, operand.nbytes, result_bytes, mesh.axis_size(axes))


def _first(parts: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    return next(p for p in parts if p is not None)


def psum(parts: Sequence[torch.Tensor], mesh: Mesh, axes) -> List[torch.Tensor]:
    """Sum over each group of ``axes``, on every member."""
    x = _first(parts)
    _record(mesh, "all-reduce", x, x.nbytes, axes)
    return _reduce(parts, mesh, axes, torch.add)


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh, axes) -> List[torch.Tensor]:
    """Elementwise max over each group of ``axes``, on every member."""
    x = _first(parts)
    _record(mesh, "all-reduce", x, x.nbytes, axes)
    return _reduce(parts, mesh, axes, torch.maximum)


def psum_scatter(parts: Sequence[torch.Tensor], mesh: Mesh, axes,
                 scatter_dimension: int = 0, tiled: bool = False) -> List[torch.Tensor]:
    """The group's sum cut along ``scatter_dimension`` into as many blocks
    as members; the member of ``axis_index`` i keeps block i.  Without
    ``tiled`` that dim must equal the group's size and is dropped."""
    n = mesh.axis_size(axes)
    d = scatter_dimension
    x = _first(parts)
    size = x.shape[d]
    if (size % n) if tiled else (size != n):
        raise ValueError(f"psum_scatter: dim {d} of size {size} over {n} shards")
    _record(mesh, "reduce-scatter", x, x.nbytes // n, axes)

    def block(acc, i):
        return acc.narrow(d, i * (size // n), size // n) if tiled else acc.select(d, i)

    return _reduce(parts, mesh, axes, torch.add, scatter=block)


def _gathered(parts: Sequence[Optional[torch.Tensor]], mesh: Mesh) -> List[torch.Tensor]:
    """Every shard's piece, on this rank: an all-reduce SUM of a zero
    buffer [shards, ...] in which this rank fills its own shards' slots
    (exact: every other term is zero; bf16 and f16 travel as f32)."""
    x = _first(parts)
    buf = torch.zeros((mesh.size,) + tuple(x.shape), dtype=_wide(x).dtype, device=x.device)
    for k, p in enumerate(parts):
        if p is not None:
            buf[k] = p.to(x.device)
    return list(mesh.ranks.all_reduce(buf, torch.add).to(x.dtype).unbind(0))


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, axes, axis: int = 0,
               tiled: bool = False) -> List[torch.Tensor]:
    """Each group's pieces in ``axis_index`` order, concatenated along
    ``axis`` (``tiled``) or stacked on a new ``axis``, on every member."""
    x = _first(parts)
    _record(mesh, "all-gather", x, x.nbytes * mesh.axis_size(axes), axes)
    pieces = list(parts) if mesh.ranks is None else _gathered(parts, mesh)
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    join = torch.cat if tiled else torch.stack
    for group in mesh.groups(axes):
        done: Dict[torch.device, torch.Tensor] = {}
        for k in group:
            if not mesh.is_local(k):
                continue
            dev = mesh.flat_devices[k]
            if dev not in done:
                done[dev] = join([pieces[j].to(dev) for j in group], dim=axis)
            out[k] = done[dev]
    return out


__all__ = ["P", "Placed", "RankGroup", "all_gather", "axis_index", "pmax", "psum",
           "psum_scatter", "merge", "place", "place_zeros", "replicate", "shard",
           "spec_splits", "unshard"]
