"""Host array helpers shared by the store's modules."""

from __future__ import annotations

import numpy as np


def sorted_unique(a) -> np.ndarray:
    """The sorted distinct values of ``a`` (flattened), as ``np.unique(a)``
    gives them, found by a sort.  NumPy 2.3's ``np.unique`` finds distinct
    values with a hash table instead: on an H100 machine's host it took
    206 s for the 67M edge keys of a scale-22 R-MAT graph, which a sort
    dedups in 1.1 s."""
    a = np.sort(np.asarray(a), axis=None)
    if len(a) < 2:
        return a
    keep = np.empty(len(a), bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]
