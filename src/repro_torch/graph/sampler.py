"""Layered neighbor sampler (fanout lists, GraphSAGE-style) over CSR or a
RapidStore snapshot view — the ``minibatch_lg`` training substrate.

The sampler reads from an immutable snapshot (store readers are lock-free),
so sampling proceeds concurrently with writers — dynamic-graph minibatch
training is exactly the paper's read-intensive workload.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class SampledBlock:
    """One hop: edges (src -> dst) between consecutive node frontiers."""

    src: np.ndarray  # int32 [E] — indices into `nodes` (LOCAL ids)
    dst: np.ndarray  # int32 [E] — local ids
    n_edges: int


@dataclass(frozen=True)
class SampledSubgraph:
    nodes: np.ndarray  # int64 [N] — global ids, seeds first
    blocks: List[SampledBlock]
    n_seeds: int

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def merged_edges(self):
        """All hops merged into one (src, dst) local edge list."""
        src = np.concatenate([b.src for b in self.blocks])
        dst = np.concatenate([b.dst for b in self.blocks])
        return src, dst


class NeighborSampler:
    """Uniform fanout sampling. `neighbors_fn(u) -> np.ndarray` abstracts the
    storage backend (CSR baseline or RapidStore snapshot view)."""

    def __init__(self, neighbors_fn, fanouts: Sequence[int], seed: int = 0):
        self.neighbors_fn = neighbors_fn
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> SampledSubgraph:
        seeds = np.asarray(seeds, np.int64)
        local_of = {int(u): i for i, u in enumerate(seeds)}
        nodes = list(seeds)
        frontier = seeds
        blocks: List[SampledBlock] = []
        for fanout in self.fanouts:
            srcs, dsts = [], []
            next_frontier = []
            for u in frontier:
                nbr = self.neighbors_fn(int(u))
                if len(nbr) == 0:
                    continue
                if len(nbr) > fanout:
                    nbr = self.rng.choice(nbr, size=fanout, replace=False)
                for v in nbr:
                    v = int(v)
                    if v not in local_of:
                        local_of[v] = len(nodes)
                        nodes.append(v)
                        next_frontier.append(v)
                    # message flows neighbor -> frontier node
                    srcs.append(local_of[v])
                    dsts.append(local_of[int(u)])
            blocks.append(
                SampledBlock(
                    np.asarray(srcs, np.int32), np.asarray(dsts, np.int32), len(srcs)
                )
            )
            frontier = np.asarray(next_frontier, np.int64)
            if len(frontier) == 0:
                break
        return SampledSubgraph(np.asarray(nodes, np.int64), blocks, len(seeds))


def pad_subgraph(sub: SampledSubgraph, max_nodes: int, max_edges: int):
    """Pad a sampled subgraph to static shapes for jit (device format)."""
    src, dst = sub.merged_edges()
    n, e = sub.n_nodes, len(src)
    if n > max_nodes or e > max_edges:
        raise ValueError(f"sample exceeds static bounds: {n}/{max_nodes} nodes, {e}/{max_edges} edges")
    nodes = np.zeros(max_nodes, np.int64)
    nodes[:n] = sub.nodes
    src_p = np.zeros(max_edges, np.int32)
    dst_p = np.zeros(max_edges, np.int32)
    src_p[:e] = src
    dst_p[:e] = dst
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[:e] = True
    node_mask = np.zeros(max_nodes, bool)
    node_mask[:n] = True
    return nodes, src_p, dst_p, node_mask, edge_mask
