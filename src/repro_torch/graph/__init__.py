"""Graph substrate: segment ops, generators, samplers, batching."""

from .generators import rmat_edges, rmat_edges_torch, uniform_edges
from .segment_ops import (
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_std,
    segment_sum,
)

__all__ = [
    "rmat_edges",
    "rmat_edges_torch",
    "uniform_edges",
    "segment_softmax",
    "segment_sum",
    "segment_max",
    "segment_min",
    "segment_mean",
    "segment_std",
]
