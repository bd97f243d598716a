"""Segment reductions — the message-passing primitive layer.

All GNN aggregation is edge-index scatter onto ``num_segments`` rows:
``segment_sum(messages, edge_dst, n_nodes)``.  These are torch ops with
the conventions of ``jax.ops.segment_*``: an empty segment sums to 0 and
reduces to ``-inf`` (max) or ``+inf`` (min), and the gradient of a max or
min is split evenly among the entries tied at it.  Ids may be int32 or
int64 and must lie in ``[0, num_segments)``.  On the card the sums add
with atomics, so their f32 order changes from run to run.
"""

from __future__ import annotations

import torch


def _expand(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Ids as an int64 index of ``data``'s shape (one id per leading row)."""
    ids = segment_ids.long()
    return ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def _segment_extreme(data, segment_ids, num_segments: int, reduce: str, fill: float):
    out = torch.full((num_segments,) + tuple(data.shape[1:]), fill,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, _expand(segment_ids, data), data, reduce,
                              include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amax", float("-inf"))


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amin", float("inf"))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Sum over count, the count taken over every entry (no mask), at least 1."""
    s = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    cnt = torch.clamp_min(segment_sum(ones, segment_ids, num_segments), 1)
    return s / cnt.reshape((-1,) + (1,) * (data.dim() - 1))


def segment_std(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                eps: float = 1e-5) -> torch.Tensor:
    mean = segment_mean(data, segment_ids, num_segments)
    sq = segment_mean(data * data, segment_ids, num_segments)
    # torch.maximum splits the gradient at a tie as jnp.maximum does
    return torch.sqrt(torch.maximum(sq - mean * mean, sq.new_zeros(())) + eps)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within segments (edge-softmax for GAT)."""
    ids = segment_ids.long()
    m = segment_max(scores, ids, num_segments)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(scores - m.index_select(0, ids))
    z = segment_sum(e, ids, num_segments)
    return e / torch.clamp_min(z.index_select(0, ids), 1e-16)
