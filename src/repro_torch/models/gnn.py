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
zeroes what is not finite.  Gradients come from torch autograd.  Every
``*_apply`` takes a ``gather_fn(h, idx)`` and (PNA aside) a
``scatter_fn(msgs, dst)`` in place of the plain edge gather and
segment sum: ``make_shardmap_gather``/``make_shardmap_scatter`` split
them over a mesh with bf16 on the wire, forward and backward.
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
from ..launch.collectives import P, all_gather, psum, psum_scatter, shard, unshard
from ..launch.mesh import axes_tuple
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


def _defaults(gather_fn, scatter_fn, comm_dtype, n_nodes):
    """The edge gather and the segment sum onto nodes: the caller's
    ``gather_fn``/``scatter_fn`` (a sharded form), else ``_gather`` in
    ``comm_dtype`` and ``segment_sum``."""
    gather = gather_fn or partial(_gather, comm_dtype=comm_dtype)
    scatter = scatter_fn or (lambda m, d: segment_sum(m, d, n_nodes))
    return gather, scatter


# ---------------------------------------------------------------------------
# edge gather and node scatter over a mesh, bf16 on the wire
# ---------------------------------------------------------------------------
def _bf16_gather(parts, dst_l, mesh, node_axes, dtype) -> list:
    """Each shard's rows ``dst_l[k]`` of the all-gathered node blocks
    ``parts`` (bf16 on the wire), in ``dtype``."""
    wire = all_gather([t.to(torch.bfloat16) for t in parts], mesh, axes_tuple(node_axes),
                      axis=0, tiled=True)
    return [w.index_select(0, i.long()).to(dtype) for w, i in zip(wire, dst_l)]


def _bf16_scatter(parts, idx_l, n_total: int, mesh, node_axes, edge_axes, dtype) -> list:
    """Each shard's f32 segment sum of its edge rows onto ``n_total`` nodes,
    merged with a bf16 reduce-scatter over ``node_axes`` and a bf16 psum
    over the edge axes that are not node axes; blocks of ``dtype``."""
    axes, e_axes = axes_tuple(node_axes), axes_tuple(edge_axes)
    rest = tuple(a for a in e_axes if a not in axes)
    accs = [segment_sum(p.float(), i, n_total).to(torch.bfloat16) for p, i in zip(parts, idx_l)]
    out = psum_scatter(accs, mesh, axes, scatter_dimension=0, tiled=True)
    if rest:  # edge shards on non-node axes contribute partials too
        out = psum(out, mesh, rest)
    return [o.to(dtype) for o in out]


class _ShardGather(torch.autograd.Function):
    """``h[idx]`` over a mesh: node blocks of h all-gathered in bf16, each
    edge shard takes its rows.  Backward: an f32 segment sum per edge
    shard, then a bf16 reduce-scatter onto the node blocks."""

    @staticmethod
    def forward(ctx, h, idx, mesh, node_axes, edge_axes):
        ctx.save_for_backward(idx)
        ctx.meta = (mesh, node_axes, edge_axes, h.shape[0], h.dtype, h.device)
        outs = _bf16_gather(shard(h, mesh, P(node_axes, None)), shard(idx, mesh, P(edge_axes)),
                            mesh, node_axes, h.dtype)
        return unshard(outs, mesh, P(edge_axes, None), device=h.device)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        mesh, node_axes, edge_axes, n, dtype, device = ctx.meta
        outs = _bf16_scatter(shard(g, mesh, P(edge_axes, None)), shard(idx, mesh, P(edge_axes)),
                             n, mesh, node_axes, edge_axes, dtype)
        return unshard(outs, mesh, P(node_axes, None), device=device), None, None, None, None


class _ShardScatter(torch.autograd.Function):
    """``segment_sum(msgs, dst, n_nodes)`` over a mesh: the transpose of
    ``_ShardGather``, whose forward is its backward and vice versa."""

    @staticmethod
    def forward(ctx, msgs, dst, mesh, node_axes, edge_axes, n_nodes):
        ctx.save_for_backward(dst)
        ctx.meta = (mesh, node_axes, edge_axes, msgs.dtype, msgs.device)
        outs = _bf16_scatter(shard(msgs, mesh, P(edge_axes, None)), shard(dst, mesh, P(edge_axes)),
                             n_nodes, mesh, node_axes, edge_axes, msgs.dtype)
        return unshard(outs, mesh, P(node_axes, None), device=msgs.device)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        mesh, node_axes, edge_axes, dtype, device = ctx.meta
        outs = _bf16_gather(shard(g, mesh, P(node_axes, None)), shard(dst, mesh, P(edge_axes)),
                            mesh, node_axes, dtype)
        return (unshard(outs, mesh, P(edge_axes, None), device=device),
                None, None, None, None, None)


def make_shardmap_gather(mesh, node_axes, edge_axes):
    """``gather_fn(h [N, d], idx [E]) -> h[idx] [E, d]`` over ``mesh``:
    h's rows split over ``node_axes``, the edges over ``edge_axes``.  The
    node blocks travel as bf16 (all-gather), so the result is
    ``h.bfloat16()[idx]`` in h's dtype; the backward sums each edge shard's
    cotangent rows in f32 and merges them with a bf16 reduce-scatter over
    ``node_axes`` (and a bf16 psum over the other edge axes).  N and E must
    divide by their shard counts: the shards raise, and never pad.
    (The reference pins bf16 by a bitcast to uint16, so that XLA cannot
    move the convert past the collective; a ``.to(torch.bfloat16)`` before
    the copy gives the same values.)"""

    def gather_fn(h, idx):
        return _ShardGather.apply(h, idx, mesh, node_axes, edge_axes)

    return gather_fn


def make_shardmap_scatter(mesh, node_axes, edge_axes, n_nodes: int):
    """``scatter_fn(msgs [E, d], dst [E]) -> [n_nodes, d]``, the segment sum
    over ``mesh``: each edge shard sums its messages in f32 onto all
    ``n_nodes`` rows, and the partials merge with a bf16 reduce-scatter over
    ``node_axes`` (and a bf16 psum over the other edge axes); the backward
    all-gathers the node cotangent in bf16 and takes each edge's row."""

    def scatter_fn(msgs, dst):
        return _ShardScatter.apply(msgs, dst, mesh, node_axes, edge_axes, n_nodes)

    return scatter_fn


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
              comm_dtype=None, gather_fn=None, scatter_fn=None):
    gather, scatter = _defaults(gather_fn, scatter_fn, comm_dtype, n_nodes)
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
              comm_dtype=None, gather_fn=None, scatter_fn=None):
    gather, scatter = _defaults(gather_fn, scatter_fn, comm_dtype, n_nodes)
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
                   comm_dtype=None, gather_fn=None, scatter_fn=None):
    gather, scatter = _defaults(gather_fn, scatter_fn, comm_dtype, n_nodes)
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
              mean_log_deg: float = 1.0, comm_dtype=None, gather_fn=None):
    gather, _ = _defaults(gather_fn, None, comm_dtype, n_nodes)
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
               comm_dtype=None, gather_fn=None, scatter_fn=None):
    _, apply = GNN_FNS[cfg.kind]
    kw = {}
    if cfg.kind != "pna":
        kw["scatter_fn"] = scatter_fn  # pna's max/min aggregators keep the default
    h = apply(cfg, params["gnn"], node_feat, src, dst, edge_mask, n_nodes,
              comm_dtype=comm_dtype, gather_fn=gather_fn, **kw)
    if graph_ids is not None:  # graph-level task: mean pool then classify
        h = segment_mean(h, graph_ids, n_graphs)
    return h @ params["head"]["w"] + params["head"]["b"]


def gnn_loss(logits, labels, mask=None):
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if mask is not None:
        return -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return -torch.mean(ll)
