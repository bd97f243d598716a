"""Synthetic graph generators + update streams (laptop-scale stand-ins for
the paper's lj/g5/... datasets, same skew regimes)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def uniform_edges(n: int, m: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(int(m * 1.2), 2), dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]][:m]
    return e


def rmat_edges(
    n_log2: int, m: int, seed: int = 0, a=0.57, b=0.19, c=0.19
) -> np.ndarray:
    """R-MAT / Graph500-style power-law generator (the paper's g5 regime)."""
    rng = np.random.default_rng(seed)
    n_bits = n_log2
    m_gen = int(m * 1.15)
    src = np.zeros(m_gen, np.int64)
    dst = np.zeros(m_gen, np.int64)
    for bit in range(n_bits):
        r = rng.random(m_gen)
        # quadrant probabilities (a, b, c, d)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(m_gen)
        dst_bit = np.where(
            src_bit == 0, (r2 >= a / (a + b)).astype(np.int64),
            (r2 >= c / (c + 1 - a - b - c)).astype(np.int64),
        )
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    e = np.stack([src, dst], 1)
    e = e[e[:, 0] != e[:, 1]][:m]
    return e


def zipf_edges(n: int, m: int, seed: int = 0, alpha: float = 1.3) -> np.ndarray:
    """Skewed-destination stream (the paper's ldbc hotspot regime)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    ranks = rng.zipf(alpha, size=m) % n
    e = np.stack([src, ranks.astype(np.int64)], 1)
    return e[e[:, 0] != e[:, 1]]


def update_stream(
    edges: np.ndarray, rounds: int = 1, frac: float = 0.2, seed: int = 0
) -> list:
    """Paper §7.2 update workload: delete + re-insert `frac` of edges/round."""
    rng = np.random.default_rng(seed)
    ops = []
    for r in range(rounds):
        idx = rng.choice(len(edges), size=int(len(edges) * frac), replace=False)
        sel = edges[idx]
        ops.append(("-", sel))
        ops.append(("+", sel))
    return ops


def split_edges(edges: np.ndarray, frac: float, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(edges))
    k = int(len(edges) * frac)
    return edges[perm[:k]], edges[perm[k:]]
