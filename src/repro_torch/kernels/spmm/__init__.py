from .ops import (
    leaf_scan_reduce,
    leaf_scan_reduce_view,
    leaf_spmm,
    leaf_spmm_view,
    spmm_view,
)

__all__ = [
    "leaf_scan_reduce",
    "leaf_scan_reduce_view",
    "leaf_spmm",
    "leaf_spmm_view",
    "spmm_view",
]
