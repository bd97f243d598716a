"""The four assigned GNN architectures over segment-op message passing.

All models share the signature:
    init(cfg, generator, d_feat, dtype, *, device) -> params
    apply(cfg, params, node_feat [N, d_feat], src [E], dst [E],
          edge_mask [E] | None, n_nodes) -> node embeddings [N, d_hidden]

Message passing = gather(h[src]) -> transform -> segment-reduce onto dst,
with the torch ops of :mod:`repro_torch.graph.segment_ops` (the sums add
with ``index_add``, atomics on the card).  Ported from the reference's
``models/gnn.py``: the same parameter trees (``gnn_shapes``), the same
arithmetic, and the same quirks — ``segment_mean`` counts padded edges,
and PNA feeds ``-inf``/``+inf`` for masked edges into max/min and then
zeroes what is not finite.  Gradients come from torch autograd.  The
reference's ``make_shardmap_gather``/``make_shardmap_scatter`` (bf16
collectives across devices) come with the multi-process shard plane.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import GNNConfig
from ..graph.segment_ops import (
    segment_max,
    segment_mean,
    segment_min,
    segment_std,
    segment_sum,
)
from .common import dense_init, fill_tree


def _mask(x: torch.Tensor, edge_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if edge_mask is None:
        return x
    return x * edge_mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))


def _gather(h: torch.Tensor, idx: torch.Tensor, comm_dtype=None) -> torch.Tensor:
    """Edge gather with an optional communication dtype (a round trip
    through ``comm_dtype``, as the reference's wire format).

    ``index_select``, not ``h[idx]``: the backward of ``h[idx]`` on the
    card accumulates each run of equal indices serially, and a padded
    minibatch points every padding edge at node 0 (a run of ~10^5)."""
    if comm_dtype is None:
        return h.index_select(0, idx)
    return h.to(comm_dtype).index_select(0, idx).to(h.dtype)


def _defaults(scatter_fn, comm_dtype, n_nodes):
    gather = partial(_gather, comm_dtype=comm_dtype)
    scatter = scatter_fn or (lambda m, d: segment_sum(m, d, n_nodes))
    return gather, scatter


def _mlp_shapes(dims) -> Dict:
    n = len(dims) - 1
    return ({f"w{i}": (dims[i], dims[i + 1]) for i in range(n)}
            | {f"b{i}": (dims[i + 1],) for i in range(n)})


def _mlp_apply(p, x, n: int, act: Callable = F.relu, final_act: bool = False):
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# parameter trees (key -> shape), as the reference lays them out
# ---------------------------------------------------------------------------
def _gcn_shapes(cfg: GNNConfig, d_feat: int) -> Dict:
    dims = [d_feat] + [cfg.d_hidden] * cfg.n_layers
    return {f"layer{i}": {"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
            for i in range(cfg.n_layers)}


def _gin_shapes(cfg: GNNConfig, d_feat: int) -> Dict:
    dims_in = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
    return {f"layer{i}": {"mlp": _mlp_shapes([dims_in[i], cfg.d_hidden, cfg.d_hidden]),
                          "eps": ()}
            for i in range(cfg.n_layers)}


def _gatedgcn_shapes(cfg: GNNConfig, d_feat: int) -> Dict:
    d = cfg.d_hidden
    tree = {"embed": {"w": (d_feat, d), "b": (d,)}}
    for i in range(cfg.n_layers):
        tree[f"layer{i}"] = {"A": (d, d), "B": (d, d), "U": (d, d), "V": (d, d),
                             "norm_h": (d,), "norm_scale": (d,)}
    return tree


def _pna_shapes(cfg: GNNConfig, d_feat: int) -> Dict:
    d = cfg.d_hidden
    n_agg, n_scale = 4, 3  # mean/max/min/std x identity/amplification/attenuation
    tree = {"embed": {"w": (d_feat, d), "b": (d,)}}
    for i in range(cfg.n_layers):
        tree[f"layer{i}"] = {"post": _mlp_shapes([d * n_agg * n_scale + d, d])}
    return tree


# ---------------------------------------------------------------------------
# GCN (Kipf & Welling) — symmetric-normalized SpMM
# ---------------------------------------------------------------------------
def gcn_apply(cfg, params, h, src, dst, edge_mask, n_nodes: int,
              comm_dtype=None, scatter_fn=None):
    gather, scatter = _defaults(scatter_fn, comm_dtype, n_nodes)
    src, dst = src.long(), dst.long()
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    deg = segment_sum(_mask(ones, edge_mask), dst, n_nodes) + 1.0  # +self loop
    inv_sqrt = torch.rsqrt(deg)
    coef = inv_sqrt[src] * inv_sqrt[dst]
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        hw = h @ p["w"]
        msg = _mask(gather(hw, src) * coef[:, None], edge_mask)
        agg = scatter(msg, dst) + hw * (inv_sqrt ** 2)[:, None]  # self loop
        h = agg + p["b"]
        if i < cfg.n_layers - 1:
            h = F.relu(h)
    return h


# ---------------------------------------------------------------------------
# GIN (Xu et al.) — sum aggregation + MLP, learnable eps
# ---------------------------------------------------------------------------
def gin_apply(cfg, params, h, src, dst, edge_mask, n_nodes: int,
              comm_dtype=None, scatter_fn=None):
    gather, scatter = _defaults(scatter_fn, comm_dtype, n_nodes)
    src, dst = src.long(), dst.long()
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        agg = scatter(_mask(gather(h, src), edge_mask), dst)
        h = (1.0 + p["eps"]) * h + agg
        h = _mlp_apply(p["mlp"], h, 2, final_act=True)
    return h


# ---------------------------------------------------------------------------
# GatedGCN (Bresson & Laurent) — edge-gated aggregation
# ---------------------------------------------------------------------------
def gatedgcn_apply(cfg, params, h, src, dst, edge_mask, n_nodes: int,
                   comm_dtype=None, scatter_fn=None):
    gather, scatter = _defaults(scatter_fn, comm_dtype, n_nodes)
    src, dst = src.long(), dst.long()
    h = h @ params["embed"]["w"] + params["embed"]["b"]
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        h_src = gather(h, src)
        h_dst = gather(h, dst)
        e = h_dst @ p["A"] + h_src @ p["B"]  # edge gates
        eta = _mask(torch.sigmoid(e), edge_mask)
        num = scatter(eta * (h_src @ p["V"]), dst)
        den = scatter(eta, dst) + 1e-6
        h_new = h @ p["U"] + num / den
        # lightweight layernorm substitute (RMS) + residual + relu
        rms = torch.rsqrt(torch.mean(h_new * h_new, dim=-1, keepdim=True) + 1e-6)
        h = h + F.relu(h_new * rms * p["norm_h"])
    return h


# ---------------------------------------------------------------------------
# PNA (Corso et al.) — multi-aggregator x degree scalers
# ---------------------------------------------------------------------------
def pna_apply(cfg, params, h, src, dst, edge_mask, n_nodes: int,
              mean_log_deg: float = 1.0, comm_dtype=None):
    gather, _ = _defaults(None, comm_dtype, n_nodes)
    src, dst = src.long(), dst.long()
    h = h @ params["embed"]["w"] + params["embed"]["b"]
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    deg = segment_sum(_mask(ones, edge_mask), dst, n_nodes)
    log_deg = torch.log1p(deg)[:, None]
    amp = log_deg / mean_log_deg
    att = mean_log_deg / torch.clamp_min(log_deg, 1e-6)
    keep = None if edge_mask is None else edge_mask.bool()[:, None]
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        msg = _mask(gather(h, src), edge_mask)
        hi = msg if keep is None else torch.where(keep, msg, float("-inf"))
        lo = msg if keep is None else torch.where(keep, msg, float("inf"))
        mx = segment_max(hi, dst, n_nodes)
        mn = segment_min(lo, dst, n_nodes)
        aggs = [
            segment_mean(msg, dst, n_nodes),  # counts padded edges, as the reference
            torch.where(torch.isfinite(mx), mx, 0.0),
            torch.where(torch.isfinite(mn), mn, 0.0),
            segment_std(msg, dst, n_nodes),
        ]
        stacked = torch.cat(aggs, dim=-1)  # [N, 4d]
        scaled = torch.cat([stacked, stacked * amp, stacked * att], dim=-1)
        h = _mlp_apply(p["post"], torch.cat([h, scaled], dim=-1), 1)
        h = F.relu(h)
    return h


# ---------------------------------------------------------------------------
# registry + task heads
# ---------------------------------------------------------------------------
GNN_FNS = {
    "gcn": (_gcn_shapes, gcn_apply),
    "gin": (_gin_shapes, gin_apply),
    "gatedgcn": (_gatedgcn_shapes, gatedgcn_apply),
    "pna": (_pna_shapes, pna_apply),
}

_ONES = ("norm_h", "norm_scale")  # gatedgcn's norms start at 1


def gnn_shapes(cfg: GNNConfig, d_feat: int) -> Dict:
    """The parameter tree of ``cfg`` as key -> shape: ``{"gnn": ..., "head":
    {"w": (d_hidden, n_classes), "b": (n_classes,)}}``."""
    shapes, _ = GNN_FNS[cfg.kind]
    return {"gnn": shapes(cfg, d_feat),
            "head": {"w": (cfg.d_hidden, cfg.n_classes), "b": (cfg.n_classes,)}}


def init_gnn(cfg: GNNConfig, generator: torch.Generator, d_feat: int,
             dtype=torch.float32, *, device) -> Dict:
    """Random parameters from ``generator`` on ``device`` (the generator's
    device) in ``gnn_shapes``' layout, initialized as the reference does:
    matrices fan-in scaled truncated normal, biases and GIN's ``eps`` 0,
    GatedGCN's norms 1."""
    dev = torch.device(device)

    def make(name, shape):
        if len(shape) == 2:
            return dense_init(generator, shape, dtype=dtype, device=dev)
        fill = torch.ones if name in _ONES else torch.zeros
        return fill(shape, dtype=dtype, device=dev)

    return fill_tree(gnn_shapes(cfg, d_feat), make)


def gnn_logits(cfg: GNNConfig, params, node_feat, src, dst, edge_mask, n_nodes: int,
               graph_ids: Optional[torch.Tensor] = None, n_graphs: int = 0,
               comm_dtype=None, scatter_fn=None):
    _, apply = GNN_FNS[cfg.kind]
    kw = {}
    if cfg.kind != "pna":
        kw["scatter_fn"] = scatter_fn  # pna's max/min aggregators keep the default
    h = apply(cfg, params["gnn"], node_feat, src, dst, edge_mask, n_nodes,
              comm_dtype=comm_dtype, **kw)
    if graph_ids is not None:  # graph-level task: mean pool then classify
        h = segment_mean(h, graph_ids, n_graphs)
    return h @ params["head"]["w"] + params["head"]["b"]


def gnn_loss(logits, labels, mask=None):
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if mask is not None:
        return -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return -torch.mean(ll)
