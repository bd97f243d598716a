"""Batched small graphs (molecule regime): flatten B graphs into one
disjoint-union graph with a graph-id vector for pooling."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def batch_graphs(
    n_graphs: int, nodes_per: int, edges_per: int, seed: int = 0, d_feat: int = 16
) -> dict:
    """Random batched molecules: B disjoint graphs, fixed sizes (padded)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per
    E = n_graphs * edges_per
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    for g in range(n_graphs):
        base = g * nodes_per
        e = rng.integers(0, nodes_per, size=(edges_per, 2))
        src[g * edges_per : (g + 1) * edges_per] = base + e[:, 0]
        dst[g * edges_per : (g + 1) * edges_per] = base + e[:, 1]
    return {
        "src": src,
        "dst": dst,
        "node_feat": rng.normal(size=(N, d_feat)).astype(np.float32),
        "graph_ids": np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per),
        "labels": rng.integers(0, 2, size=n_graphs).astype(np.int32),
        "n_graphs": n_graphs,
    }
