"""Inputs made from the seed: the Graph500 R-MAT graph, the writer's
transactions, the query operands, the SSSP weights and the edge
fingerprints.

Every function here is the benchmark's own and stays as it is: the
program receives what these make, and the reference recomputes from the
same.  The R-MAT recursion is a frozen copy of
``repro_torch.graph.rmat_edges_torch`` (float64 draws on the device from
one ``torch.Generator``), so a later change to the program's generator
does not move the data.

Integer hashing works on int64 with wrapping products, in torch on any
device and in numpy alike (a right shift is masked to act as a logical
one), so the harness on the card and a reference in numpy agree bit for
bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

MASK32 = (1 << 32) - 1
_C1 = 0xBF58476D1CE4E5B9 - (1 << 64)  # splitmix64's multipliers, as int64
_C2 = 0x94D049BB133111EB - (1 << 64)
WEIGHT_BITS = 23  # weights are 0.5 + k 2^-23: exact in float32


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the run's independent streams."""
    state = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(stream)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _signed(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _srl(k, s: int):
    """Logical right shift of int64 values (torch and numpy shift
    arithmetically)."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def mix64(k):
    """splitmix64's finalizer over int64 (torch tensor or numpy array)."""
    k = k ^ _srl(k, 30)
    k = k * _C1
    k = k ^ _srl(k, 27)
    k = k * _C2
    return k ^ _srl(k, 31)


def edge_keys(src, dst):
    """``(src << 32) | dst`` as int64 (ids are below 2^31)."""
    if isinstance(src, torch.Tensor):
        return (src.long() << 32) | dst.long()
    return (np.asarray(src, np.int64) << 32) | np.asarray(dst, np.int64)


def edge_weight(src, dst, seed: int):
    """SSSP weight of each edge (u, v): a seeded hash of its endpoints,
    0.5 + k 2^-23 for k in [0, 2^23), so in [0.5, 1.5) and exact in
    float32.  Any snapshot's edges have their weights, and the reference
    recomputes them from the edges alone."""
    salt = _signed(subseed(seed, 7))
    if isinstance(src, torch.Tensor):
        k = mix64(edge_keys(src, dst) ^ salt)
        bits = (_srl(k, 64 - WEIGHT_BITS)).to(torch.float32)
        return 0.5 + bits * float(2.0 ** -WEIGHT_BITS)
    k = mix64(edge_keys(src, dst) ^ np.int64(salt))
    bits = _srl(k, 64 - WEIGHT_BITS).astype(np.float32)
    return np.float32(0.5) + bits * np.float32(2.0 ** -WEIGHT_BITS)


_FP_SALT = _signed(0x2545F4914F6CDD1D)


def fingerprint_keys(keys) -> Tuple[int, int]:
    """(count, wrapping sum of the mixed keys): equal for two edge
    multisets that are equal, and unequal otherwise but with chance
    2^-64.  ``keys`` is an int64 tensor or array."""
    if isinstance(keys, torch.Tensor):
        if keys.numel() == 0:
            return 0, 0
        return int(keys.numel()), int(mix64(keys ^ _FP_SALT).sum())
    keys = np.asarray(keys, np.int64)
    with np.errstate(over="ignore"):
        return int(keys.size), int(mix64(keys ^ np.int64(_FP_SALT)).sum(dtype=np.int64))


def add_fingerprints(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    """The fingerprint of the union of two multisets."""
    return a[0] + b[0], _signed(a[1] + b[1])


def normalize(fp: Tuple[int, int]) -> Tuple[int, int]:
    return int(fp[0]), _signed(int(fp[1]))


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------
def rmat_edges(scale: int, m: int, seed: int, device, a: float, b: float,
               c: float) -> torch.Tensor:
    """``[m, 2]`` int64 R-MAT edges on ``device``: the recursion of
    ``repro_torch.graph.rmat_edges_torch`` (quadrants a, b, c, 1-a-b-c,
    drawn bit by bit in float64), self-loops dropped, the first ``m``
    kept.  Duplicates stay, as the Graph500 generator leaves them."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    m_gen = int(m * 1.15)
    src = torch.zeros(m_gen, dtype=torch.int64, device=device)
    dst = torch.zeros(m_gen, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.rand(m_gen, generator=g, dtype=torch.float64, device=device)
        src_bit = r >= a + b
        r2 = torch.rand(m_gen, generator=g, dtype=torch.float64, device=device)
        dst_bit = torch.where(src_bit, r2 >= c / (c + 1 - a - b - c), r2 >= a / (a + b))
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
        del r, r2, src_bit, dst_bit
    e = torch.stack([src, dst], 1)
    e = e[e[:, 0] != e[:, 1]]
    if e.shape[0] < m:
        raise RuntimeError(f"R-MAT drew {e.shape[0]} edges without self-loops, need {m}")
    return e[:m]


def base_graph(config: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edges ``[m, 2]`` int64 as drawn, sorted unique keys of the edge
    set the store holds at timestamp 0), both on ``device``."""
    g = config["generator"]
    scale = int(config["scale"])
    m = int(g["edge_factor"]) << scale
    e = rmat_edges(scale, m, subseed(seed, 1), device, g["a"], g["b"], g["c"])
    if not g.get("directed", True):
        e = torch.cat([e, e.flip(1)])
    keys = torch.unique(edge_keys(e[:, 0], e[:, 1]))  # sorted
    return e, keys


# ---------------------------------------------------------------------------
# The writer's transactions
# ---------------------------------------------------------------------------
def transactions(config: dict, writer: dict, base_keys: torch.Tensor, n_txn: int,
                 seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_txn`` (inserts, deletes) pairs of ``[k, 2]`` int64 arrays.

    Inserts are R-MAT edges of the configuration's distribution,
    ``writer["inserts"]`` distinct ones a transaction, none equal to a
    delete of the same transaction (so the order of the two inside one
    transaction never matters).  Deletes are ``writer["deletes"]`` edges
    of the base graph a transaction, drawn uniformly without replacement
    over all transactions, so each deletes an edge that is live.  In an
    undirected graph each inserted or deleted edge is written in both
    directions, as the base graph stores it."""
    n_ins, n_dels = int(writer["inserts"]), int(writer["deletes"])
    g = config["generator"]
    directed = g.get("directed", True)
    scale = int(config["scale"])
    device = base_keys.device
    pool = rmat_edges(scale, max(64, int(n_txn * n_ins * 1.25)), subseed(seed, 2), device,
                      g["a"], g["b"], g["c"]).cpu().numpy()
    rng = np.random.default_rng(subseed(seed, 3))
    # an undirected edge once, as (u, v) with u < v
    cand = base_keys if directed else base_keys[(base_keys >> 32) < (base_keys & MASK32)]
    pick = rng.choice(int(cand.numel()), size=n_txn * n_dels, replace=False)
    dkeys = cand[torch.from_numpy(pick).to(device)].cpu().numpy()

    def both(pairs: np.ndarray) -> np.ndarray:
        return pairs if directed else np.concatenate([pairs, pairs[:, ::-1]])

    out, at = [], 0
    for t in range(n_txn):
        dk = dkeys[t * n_dels:(t + 1) * n_dels]
        dels = both(np.stack([dk >> 32, dk & MASK32], 1))
        seen = set(((dels[:, 0] << 32) | dels[:, 1]).tolist())
        ins = []
        while len(ins) < n_ins:
            if at >= len(pool):
                raise RuntimeError("the insert pool ran out")
            u, v = int(pool[at, 0]), int(pool[at, 1])
            at += 1
            k = (u << 32) | v
            if k not in seen and (directed or ((v << 32) | u) not in seen):
                seen.update((k, (v << 32) | u) if not directed else (k,))
                ins.append((u, v))
        out.append((both(np.asarray(ins, np.int64).reshape(-1, 2)).copy(),
                    dels.astype(np.int64)))
    return out


# ---------------------------------------------------------------------------
# The readers' queries and operands
# ---------------------------------------------------------------------------
def client_plans(traffic: dict, base_keys: torch.Tensor, seed: int,
                 length: int) -> List[List[Tuple[str, int]]]:
    """Each reader client's sequence of (kind, root): blocks of the mix's
    kinds, each kind as often as its share says, shuffled block by block,
    so every seed runs the same work in another order.  Roots (for the
    kinds that take one) are vertices with out-edges, drawn uniformly."""
    kinds = traffic["kinds"]
    block = [k for k, share in sorted(kinds.items()) for _ in range(int(share))]
    rng = np.random.default_rng(subseed(seed, 4))
    sources = torch.unique(base_keys >> 32).cpu().numpy()
    plans = []
    for _ in range(int(traffic["clients"])):
        seq: List[Tuple[str, int]] = []
        while len(seq) < length:
            for i in rng.permutation(len(block)):
                seq.append((block[i], int(sources[rng.integers(len(sources))])))
        plans.append(seq[:length])
    return plans


def check_positions(plan: List[Tuple[str, int]], every: int, rng) -> List[int]:
    """The queries of one client whose answers are checked: for each kind,
    its first occurrence (so a slow window still checks every kind), and
    each query of the whole plan with chance ``1 / every``, drawn from
    ``rng``, so the sample spans the window however far it reaches."""
    first = {}
    for i, (kind, _root) in enumerate(plan):
        first.setdefault(kind, i)
    drawn = np.flatnonzero(rng.random(len(plan)) < 1.0 / every)
    return sorted(set(first.values()) | {int(i) for i in drawn})


def operands(n: int, d: int, seed: int, device) -> dict:
    """The float operands: x ``[n]`` for the scan, H ``[n, d]`` for SpMM,
    normal draws in float32 on ``device`` from one generator."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, 5))
    x = torch.randn(n, generator=g, device=device)
    h = torch.randn((n, d), generator=g, device=device) if d else None
    return {"x": x, "H": h}
