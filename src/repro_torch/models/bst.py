"""BST — Behavior Sequence Transformer (Chen et al., arXiv:1905.06874).

User behaviour sequence (item ids) + target item -> transformer block over
the sequence -> concat with profile features -> MLP tower -> CTR logit.

The embedding lookup is the hot path (a table of millions of items).  On
the card every lookup goes through the hand-written ``embedding_bag``
kernel: ``embedding_lookup`` as bags of one id, ``user_tower`` as one bag
of the whole history in ``mean`` mode.  The attention and MLP are plain
torch, as they are plain XLA in the reference.  A ``lookup_fn(table, ids)
-> [*ids.shape, d]`` replaces the lookup: ``make_sharded_lookup``'s
row-sharded lookup over a mesh, or a plain route to check against.

Training: ``embedding_lookup`` is an autograd function whose backward adds
each looked-up row's gradient into a zero table gradient (``index_add_``),
what autodiff of the reference's ``table[ids]`` gives; the rest of
``forward`` and ``bst_loss`` take their gradients from autograd, the
sharded lookup's through its collectives.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..configs.base import RecsysConfig
from ..kernels.embedding_bag import embedding_bag
from ..launch.collectives import P, axis_index, place, psum, shard, unshard
from .common import dense_init, embed_init, fill_tree, rms_norm, upcast


def bst_shapes(cfg: RecsysConfig) -> Dict:
    """The parameter tree of BST as key -> shape, as the reference lays it out."""
    d, s = cfg.embed_dim, cfg.seq_len + 1
    block = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d), "norm1": (d,),
             "norm2": (d,), "ffn_w1": (d, 4 * d), "ffn_b1": (4 * d,),
             "ffn_w2": (4 * d, d), "ffn_b2": (d,)}
    dims = (s * d + cfg.n_other_feats,) + cfg.mlp_dims + (1,)
    mlp = {}
    for i in range(len(dims) - 1):
        mlp[f"w{i}"] = (dims[i], dims[i + 1])
        mlp[f"b{i}"] = (dims[i + 1],)
    return {"item_emb": (cfg.n_items, d), "pos_emb": (s, d),
            "blocks": {f"block{i}": dict(block) for i in range(cfg.n_blocks)},
            "mlp": mlp}


def init_params(cfg: RecsysConfig, generator: torch.Generator, dtype=torch.float32,
                *, device) -> Dict:
    """Random parameters from ``generator`` on ``device`` (the generator's
    device) in ``bst_shapes``' layout, initialized as the reference does:
    embeddings N(0, 0.02), weights fan-in scaled, biases 0, norms 1.  The
    kernel takes an f32 item table, so a card route keeps ``dtype`` f32."""
    dev = torch.device(device)

    def make(name, shape):
        if name.endswith("_emb"):
            return embed_init(generator, shape, dtype, device=dev)
        if name.startswith("norm"):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name.startswith(("b", "ffn_b")):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return dense_init(generator, shape, dtype=dtype, device=dev)

    return fill_tree(bst_shapes(cfg), make)


# ---------------------------------------------------------------------------
# embedding lookup
# ---------------------------------------------------------------------------
class _Lookup(torch.autograd.Function):
    """Rows of ``table`` through ``embedding_bag`` (bags of one id); the
    backward scatters the rows' gradients into a zero ``[V, d]`` gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table = (table.shape, table.dtype)
        return embedding_bag(table, ids.reshape(-1, 1))

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        shape, dtype = ctx.table
        out = torch.zeros(shape, dtype=grad.dtype, device=grad.device)
        return out.index_add_(0, ids.reshape(-1).long(), grad).to(dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` in f32 as bags of one id: ids [...] -> [..., d],
    differentiable in ``table``."""
    return _Lookup.apply(table, ids).reshape(*ids.shape, table.shape[1])


def make_sharded_lookup(mesh, axis: str = "model", batch_axes=None):
    """Row-sharded lookup: local masked take + psum over the table axis.

    The table's rows [V, d] shard over ``axis`` (shard ``k`` of the axis
    holds rows ``[k V/n, (k+1) V/n)``); the ids' leading (batch) dim may
    shard over ``batch_axes``.  Each shard looks its ids up in its rows
    through ``embedding_lookup`` (the ``embedding_bag`` kernel, launched
    on the shard's card), zeroes the ids outside them, and one psum of the
    ``[*ids.shape, d]`` output over ``axis`` merges the shards.

    Serving passes the table placed once, ``place(table, mesh, P(axis,
    None))`` (:func:`place_table`): its blocks stay on their cards and a
    call moves only the ids and the psum's output.  A whole table is cut
    on every call (one copy a call for each shard on another card), as the
    training step does; differentiable in it: its gradient is that of the
    masked take and the psum, each shard's rows from its own
    ``index_add_``.
    """

    def lookup(table, ids):
        batch = batch_axes if batch_axes else None
        ids_spec = P(batch, *([None] * (ids.dim() - 1)))
        tabs = shard(table, mesh, P(axis, None))
        ids_l = shard(ids, mesh, ids_spec)
        rows = tabs[0].shape[0]  # local rows
        outs = []
        for k, shard_k in enumerate(axis_index(mesh, axis)):
            local = ids_l[k] - shard_k * rows
            ok = (local >= 0) & (local < rows)
            out = embedding_lookup(tabs[k], torch.where(ok, local, 0))
            outs.append(torch.where(ok[..., None], out, 0.0))
        return unshard(psum(outs, mesh, axis), mesh, P(batch, *([None] * ids.dim())),
                       device=table.device)

    return lookup


def place_table(table: torch.Tensor, mesh, axis: str = "model"):
    """``table`` [V, d] placed by rows over ``axis`` for
    ``make_sharded_lookup``: each block on its shard's card, once."""
    return place(table, mesh, P(axis, None))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(
    cfg: RecsysConfig,
    params: Dict,
    hist_ids: torch.Tensor,  # [B, seq_len] int32
    target_id: torch.Tensor,  # [B] int32
    other_feats: torch.Tensor,  # [B, n_other_feats] f32
    lookup_fn=None,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Returns CTR logits [B] in at least f32."""
    lookup = lookup_fn or embedding_lookup
    cd = compute_dtype
    b = hist_ids.shape[0]
    seq_ids = torch.cat([hist_ids, target_id[:, None].to(hist_ids.dtype)], dim=1)  # [B, S]
    x = lookup(params["item_emb"], seq_ids).to(cd)
    x = x + params["pos_emb"][None, :, :].to(cd)
    d = cfg.embed_dim
    hd = d // cfg.n_heads
    for i in range(cfg.n_blocks):
        p = params["blocks"][f"block{i}"]
        h = rms_norm(x, p["norm1"].to(cd))
        q = (h @ p["wq"].to(cd)).reshape(b, -1, cfg.n_heads, hd)
        k = (h @ p["wk"].to(cd)).reshape(b, -1, cfg.n_heads, hd)
        v = (h @ p["wv"].to(cd)).reshape(b, -1, cfg.n_heads, hd)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k).to(upcast(cd))
        sc = sc / math.sqrt(hd)
        attn = torch.softmax(sc, dim=-1).to(cd)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, -1, d)
        x = x + o @ p["wo"].to(cd)
        h = rms_norm(x, p["norm2"].to(cd))
        h = F.leaky_relu(h @ p["ffn_w1"].to(cd) + p["ffn_b1"].to(cd))
        x = x + h @ p["ffn_w2"].to(cd) + p["ffn_b2"].to(cd)
    h = torch.cat([x.reshape(b, -1), other_feats.to(cd)], dim=-1)
    n_mlp = len(cfg.mlp_dims) + 1
    for i in range(n_mlp):
        h = h @ params["mlp"][f"w{i}"].to(cd) + params["mlp"][f"b{i}"].to(cd)
        if i < n_mlp - 1:
            h = F.leaky_relu(h)
    return h[:, 0].to(upcast(cd))


def bst_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on CTR logits."""
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def user_tower(cfg: RecsysConfig, params: Dict, hist_ids, other_feats,
               lookup_fn=None, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """User representation for retrieval: the mean of the history's item
    embeddings [B, d].  Without ``lookup_fn`` it is one ``mean`` bag per
    user (the mean taken in f32, then cast); with one, the rows are looked
    up, cast and averaged as the reference does."""
    if lookup_fn is None:
        return embedding_bag(params["item_emb"], hist_ids, mode="mean").to(compute_dtype)
    x = lookup_fn(params["item_emb"], hist_ids).to(compute_dtype)
    return torch.mean(x, dim=1)


def retrieval_scores(cfg: RecsysConfig, params: Dict, user_vec: torch.Tensor,
                     cand_ids: torch.Tensor, lookup_fn=None,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Score one user against n_candidates items: one batched dot -> [C] f32."""
    lookup = lookup_fn or embedding_lookup
    cand = lookup(params["item_emb"], cand_ids).to(compute_dtype)  # [C, d]
    return (cand @ user_vec.reshape(-1, 1).to(compute_dtype))[:, 0].float()
