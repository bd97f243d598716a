from .ops import (
    intersect_count,
    intersect_count_hybrid,
    intersect_tiles_view,
    sum_intersect_tiles_view,
)

__all__ = [
    "intersect_count",
    "intersect_count_hybrid",
    "intersect_tiles_view",
    "sum_intersect_tiles_view",
]
