"""Batched edge searches: ``kernels.leaf_search.edge_search_view`` on a
pinned view, answering for each (u, v) of a batch whether it is an edge.

The query sets are those of RapidStore's search experiment by degree
regime (arXiv:2507.00839, Tables 1-2 and Fig 14), drawn as the repo's
reproduction of it draws them (``benchmarks/bench_ops.py``,
``_query_sets``): one set with u uniform over all vertices, one with u
uniform over the tenth of the vertices of lowest degree and one over the
tenth of highest, each with v uniform over all vertex ids.  One read
searches the three sets of the mix's ``edge_search_view`` entry at once,
concatenated.  The program finds each pair's candidate tiles on the host
and searches them with the ``leaf_search`` kernel in place.

The batches are drawn on the host with numpy from the seed and the
plan's vertex: about a millisecond before the read's clock starts, with
no work on the card.
"""

import numpy as np
import torch

from rsbench import gen, yardstick
from rsbench.reference import search

USES = "tiles"
STREAM = 8  # gen.subseed stream of the batches
NUMBERS = {"search_wrong": 0}
SETS = ("general", "low", "high")


def prepare(ctx) -> None:
    """The vertices of each degree regime, on the host: all of them, and
    the tenths of lowest and highest degree under a stable sort."""
    p = ctx["traffic"]["edge_search_view"]
    n = ctx["n"]
    deg = torch.bincount(ctx["base_keys"] >> 32, minlength=n)
    order = torch.sort(deg, stable=True).indices.cpu().numpy()
    tail = max(1, int(n * float(p["tail_share"])))
    ctx["search_pools"] = {"general": None, "low": order[:tail], "high": order[-tail:]}


def draw(ctx, arg) -> dict:
    """``us``, ``vs``: int64 numpy arrays of the batch, the sets in order."""
    sizes = ctx["traffic"]["edge_search_view"]["sets"]
    n, pools = ctx["n"], ctx["search_pools"]
    rng = np.random.default_rng(gen.subseed(gen.subseed(ctx["seed"], STREAM), int(arg)))
    us, vs = [], []
    for name in SETS:
        k, pool = int(sizes[name]), pools[name]
        us.append(rng.integers(0, n, k) if pool is None else pool[rng.integers(0, len(pool), k)])
        vs.append(rng.integers(0, n, k))
    return {"us": np.concatenate(us).astype(np.int64), "vs": np.concatenate(vs).astype(np.int64)}


def run(view, ctx, ops):
    from repro_torch.kernels.leaf_search import edge_search_view

    return edge_search_view(view, ops["us"], ops["vs"])


def control(view, ctx, ops):
    src, dst = view.to_coo_device()
    keys = search.sorted_keys(src, dst, low=True)
    dev = keys.device
    return search.contains(keys, torch.from_numpy(ops["us"]).to(dev),
                           torch.from_numpy(ops["vs"]).to(dev), low=True)


def capture(view, answer, ctx, ops) -> dict:
    if isinstance(answer, torch.Tensor):
        answer = answer.detach().cpu().clone()
    else:
        answer = torch.from_numpy(np.array(answer))
    return {"answer": answer, "us": torch.from_numpy(ops["us"]),
            "vs": torch.from_numpy(ops["vs"])}


def hold(check, src, dst, n, ctx) -> dict:
    got = check["answer"]
    keys = search.sorted_keys(src, dst)
    want = search.contains(keys, check["us"].to(keys.device), check["vs"].to(keys.device))
    if got.shape != want.shape or got.dtype != torch.bool:
        raise ValueError(f"answer {got.dtype} {tuple(got.shape)}, want bool "
                         f"{tuple(want.shape)}")
    return {"search_wrong": int((got.to(want.device) != want).sum())}


def bounds(view, ctx, ops) -> dict:
    """The least time of the one ``leaf_search`` launch of a search on a
    single-width view (nothing for a tiered one): each pair's candidate
    tiles are those whose source is u (the tiles' own ``src``), and the
    bytes are the distinct sectors its binary searches touch, per pair
    its target, index, pos and found, and each distinct tile's length."""
    blocks = view.to_leaf_blocks_device()
    if getattr(blocks, "groups", None) is not None:
        return {}
    dev = blocks.rows.device
    us = torch.from_numpy(ops["us"]).to(dev)
    vs = torch.from_numpy(ops["vs"]).to(dev)
    order = torch.sort(blocks.src.long(), stable=True)
    lo = torch.searchsorted(order.values, us)
    hi = torch.searchsorted(order.values, us, right=True)
    n = hi - lo
    if int(n.sum()) == 0:
        return {}
    pair = torch.repeat_interleave(torch.arange(us.numel(), device=dev), n)
    rank = torch.arange(pair.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    tile = order.indices[lo[pair] + rank]
    sectors, probes = yardstick.search_sector_ids(blocks.rows, vs[pair], tile, blocks.length)
    nbytes = yardstick.search_bytes(int(sectors.numel()), int(pair.numel()),
                                    int(torch.unique(tile).numel()))
    return {"leaf_search_kernel": [yardstick.bound_s(nbytes, probes)]}
