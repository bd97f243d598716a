"""Plain PyTorch version of the edge relax (the CPU path and the kernel's
oracle on the card): the segment reductions that BFS, SSSP and WCC of
:mod:`repro_torch.core.distributed` apply to one shard's edges each
iteration, as gathers at one end of each edge and ``scatter_reduce_``
into an ``n + 1`` output keyed by the other.

Pad slots (``valid`` false) are routed to vertex 0 on the gather side and
to the extra slot ``n`` on the scatter side, which is sliced off, so ids
out of range such as the shard plane's SENTINEL pads never fault and a
pad slot never reaches vertex 0 (the padding contract of
:mod:`repro_torch.core.distributed`).
"""

from __future__ import annotations

import torch

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1
MODES = ("flag", "min_plus", "min_both")


def masked_key(key: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """int64 scatter key with pad slots routed to ``n``: the extra slot of
    an ``n + 1`` output, sliced off after the reduction (torch's scatter
    ops fault on ids out of range instead of dropping them)."""
    return torch.where(valid, key.long(), n)


def scatter_key(ids: torch.Tensor, valid, n: int) -> torch.Tensor:
    return ids.long() if valid is None else masked_key(ids, valid, n)


def gather_ids(ids: torch.Tensor, valid) -> torch.Tensor:
    """int64 gather index with pad slots routed to vertex 0 (their gathered
    value is masked out again before any reduction)."""
    return ids.long() if valid is None else torch.where(valid, ids.long(), 0)


def live(valid, x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` with pad slots set to ``fill`` (``valid`` None: no pad slots)."""
    return x if valid is None else torch.where(valid, x, fill)


def segment_reduce(vals: torch.Tensor, key: torch.Tensor, n: int, op: str,
                   identity) -> torch.Tensor:
    """``op`` ("amax"/"amin") per segment; empty segments read ``identity``,
    as under ``jax.ops.segment_max``/``segment_min``."""
    out = torch.full((n + 1,), identity, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, key, vals, op, include_self=False)[:n]


def edge_relax_ref(mode: str, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   valid=None, w=None) -> torch.Tensor:
    """One relax of ``x`` ([n]) over the edges ``src[e] -> dst[e]``:

    - ``"flag"`` (BFS; ``x`` the bool frontier): int32, per vertex the max
      over its live in-edges of ``frontier[src]`` (0 or 1), ``I32_MIN``
      where it has none;
    - ``"min_plus"`` (SSSP; ``x`` the f32 distances, ``w`` [m] f32): per
      vertex the min over its live in-edges of ``x[src] + w``, inf where it
      has none;
    - ``"min_both"`` (WCC; ``x`` the int32 labels): per vertex the min of
      its neighbours' labels over its live edges in both directions,
      ``I32_MAX`` where it has none.
    """
    n = x.shape[0]
    if mode == "flag":
        vals = live(valid, x[gather_ids(src, valid)], False).to(torch.int32)
        return segment_reduce(vals, scatter_key(dst, valid, n), n, "amax", I32_MIN)
    if mode == "min_plus":
        inf = float("inf")
        vals = live(valid, x[gather_ids(src, valid)] + w, inf)
        return segment_reduce(vals, scatter_key(dst, valid, n), n, "amin", inf)
    if mode == "min_both":
        fwd = segment_reduce(live(valid, x[gather_ids(src, valid)], I32_MAX),
                             scatter_key(dst, valid, n), n, "amin", I32_MAX)
        bwd = segment_reduce(live(valid, x[gather_ids(dst, valid)], I32_MAX),
                             scatter_key(src, valid, n), n, "amin", I32_MAX)
        return torch.minimum(fwd, bwd)
    raise ValueError(f"edge_relax: mode {mode!r}, not one of {MODES}")
