"""The port's 11 view-level entry points, keyed as ``_parity.ENTRY_CASES``.

JAX-free, so that the card tests collect where JAX is not installed:
``tests/test_torch_parity.py`` pairs each call with the reference's into
its ``ENTRIES`` table, and the card tests hold a view on the card against
the same layout on the CPU route.  Each entry is ``(call, tolerance)``:
``None`` means bitwise; scan-reduce and PageRank 1e-5 and SpMM 1e-4 are
``tests/test_kernels.py``'s (the sums run in another order).
"""

import numpy as np
import torch

from _parity import ENTRY_CASES

import repro_torch.core.analytics as ta
from repro_torch.kernels.intersect import intersect_tiles_view, sum_intersect_tiles_view
from repro_torch.kernels.leaf_search import edge_search_view
from repro_torch.kernels.spmm import leaf_scan_reduce_view, leaf_spmm_view, spmm_view

PORT_ENTRIES = {
    "edge_search_view": (
        lambda v, c: edge_search_view(v, c["queries"][:, 0], c["queries"][:, 1]), None),
    "intersect_tiles_view": (
        lambda v, c: intersect_tiles_view(v, c["ia"], c["ib"]), None),
    "sum_intersect_tiles_view": (
        lambda v, c: sum_intersect_tiles_view(v, c["ia"], c["ib"], batch=16), None),
    "leaf_scan_reduce_view": (
        lambda v, c: leaf_scan_reduce_view(v, torch.from_numpy(c["x"])), 1e-5),
    "leaf_spmm_view": (lambda v, c: leaf_spmm_view(v, torch.from_numpy(c["H"])), 1e-4),
    "spmm_view": (lambda v, c: spmm_view(v, torch.from_numpy(c["H"])), 1e-4),
    "pagerank_view": (lambda v, c: ta.pagerank_view(v), 1e-5),
    "bfs_view": (lambda v, c: ta.bfs_view(v, 0), None),
    "sssp_view": (lambda v, c: ta.sssp_view(v, c["w"], 0), None),
    "wcc_view": (lambda v, c: ta.wcc_view(v), None),
    "triangle_count_view": (lambda v, c: ta.triangle_count_view(v), None),
}
assert set(PORT_ENTRIES) == set(ENTRY_CASES)


def to_numpy(a):
    """An answer as a host array (a tensor from any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def port_answers(view, ctx, names=None) -> dict:
    """The port entry points' answers on ``view`` (all, or ``names``), as
    host arrays."""
    return {name: to_numpy(PORT_ENTRIES[name][0](view, ctx))
            for name in (names if names is not None else PORT_ENTRIES)}


def assert_answers_match(want: dict, got: dict) -> None:
    """``got`` equals ``want`` on each of ``want``'s entry points: bitwise,
    or within the entry's tolerance (rtol = atol)."""
    for name, w in want.items():
        tol = PORT_ENTRIES[name][1]
        g = got[name]
        assert np.shape(w) == np.shape(g), name
        if tol is None:
            assert np.array_equal(w, g), name
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
