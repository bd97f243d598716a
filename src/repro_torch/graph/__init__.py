"""Graph substrate: synthetic edge generators."""

from .generators import rmat_edges, uniform_edges

__all__ = ["rmat_edges", "uniform_edges"]
