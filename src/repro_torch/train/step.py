"""Train-step builders per model family.

Each builder returns ``step(params, opt_state, batch...) -> (params,
opt_state, metrics)``: the loss and its gradients from torch autograd, then
AdamW.  The GNN and BST steps update functionally (new tensors; the old
parameters stay as they were).  The LM step clips and updates in place,
one layer slice at a time (``clip_by_global_norm_``, ``adamw.update_``,
bitwise the functional arithmetic): a model whose weights, gradients and
moments fill most of the card has no room for a second copy of them, so
its ``params`` and ``opt_state`` moments are overwritten and returned.

The sharded forms plug in as the reference's do: ``moe_fn`` (the LM's MoE
dispatch), ``gather_fn``/``scatter_fn`` (the GNN's edge gather and node
scatter over a mesh) and ``comm_dtype`` (the plain gather's wire type).
The reference's XLA sharding constraints (``activation_spec``,
``carry_spec``, ``logits_spec``, ``node_spec``) and the layer-scan
``unroll`` have no counterpart: a sharded form places its own data.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from ..models import bst as BST
from ..models import gnn as G
from ..models import transformer as T
from ..optim import adamw
from ..optim.clip import clip_by_global_norm_
from ..optim.schedule import warmup_cosine
from ..optim.tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_of: Callable, params):
    """``(loss, grads)`` of ``loss_of(params)``; ``grads`` has ``params``'
    tree (zeros for a leaf the loss never reads, as in JAX), and neither is
    attached to a graph."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_of(live)
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(live, grads)


def gnn_value_and_grad(cfg: GNNConfig, params, node_feat, src, dst, edge_mask, labels,
                       label_mask, n_nodes: int, graph_ids: Optional[torch.Tensor] = None,
                       n_graphs: int = 0, comm_dtype=None, gather_fn=None, scatter_fn=None):
    """``(loss, grads)`` of ``gnn_loss(gnn_logits(...))`` at ``params``."""
    def loss_of(p):
        logits = G.gnn_logits(cfg, p, node_feat, src, dst, edge_mask, n_nodes,
                              graph_ids=graph_ids, n_graphs=n_graphs, comm_dtype=comm_dtype,
                              gather_fn=gather_fn, scatter_fn=scatter_fn)
        return G.gnn_loss(logits, labels, label_mask)

    return value_and_grad(loss_of, params)


def lm_value_and_grad(cfg: LMConfig, params, tokens, targets, compute_dtype=torch.bfloat16,
                      attn_chunk=None, moe_fn=None):
    """``(loss, grads)`` of ``lm_loss(forward(...), targets)`` at ``params``."""
    return value_and_grad(lambda p: T.lm_loss(T.forward(
        cfg, p, tokens, compute_dtype=compute_dtype, attn_chunk=attn_chunk, moe_fn=moe_fn),
        targets), params)


def bst_value_and_grad(cfg: RecsysConfig, params, hist, target, other, labels,
                       lookup_fn=None, compute_dtype=torch.bfloat16):
    """``(loss, grads)`` of ``bst_loss(forward(...), labels)`` at ``params``."""
    return value_and_grad(lambda p: BST.bst_loss(BST.forward(
        cfg, p, hist, target, other, lookup_fn=lookup_fn, compute_dtype=compute_dtype),
        labels), params)


def make_lm_train_step(
    cfg: LMConfig,
    peak_lr: float = 3e-4,
    warmup: int = 2000,
    total: int = 100_000,
    max_grad_norm: float = 1.0,
    compute_dtype=torch.bfloat16,
    attn_chunk=None,
    moe_fn=None,
):
    """Value and gradient, global-norm clipping, warmup-cosine LR at the
    optimizer's step, AdamW; metrics ``loss``, ``grad_norm``, ``lr``.
    ``params`` and ``opt_state``'s moments are updated in place."""

    def step(params, opt_state, tokens, targets):
        loss, grads = lm_value_and_grad(cfg, params, tokens, targets,
                                        compute_dtype=compute_dtype, attn_chunk=attn_chunk,
                                        moe_fn=moe_fn)
        gnorm = clip_by_global_norm_(grads, max_grad_norm)
        lr = warmup_cosine(opt_state.step, peak_lr, warmup, total)
        opt_state = adamw.update_(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step


def make_gnn_train_step(
    cfg: GNNConfig,
    n_nodes: int,
    lr: float = 1e-3,
    graph_level: bool = False,
    n_graphs: int = 0,
    comm_dtype=None,
    gather_fn=None,
    scatter_fn=None,
):
    """Value and gradient of the masked node loss, then AdamW without
    weight decay; ``gather_fn``/``scatter_fn`` (``models/gnn.py``'s sharded
    forms) replace the edge gather and the segment sum."""

    def step(params, opt_state, node_feat, src, dst, edge_mask, labels, label_mask,
             graph_ids=None):
        loss, grads = gnn_value_and_grad(
            cfg, params, node_feat, src, dst, edge_mask, labels, label_mask, n_nodes,
            graph_ids=graph_ids if graph_level else None, n_graphs=n_graphs,
            comm_dtype=comm_dtype, gather_fn=gather_fn, scatter_fn=scatter_fn)
        params, opt_state = adamw.update(grads, opt_state, params, lr, weight_decay=0.0)
        return params, opt_state, {"loss": loss}

    return step


def make_bst_train_step(cfg: RecsysConfig, lr: float = 1e-3, lookup_fn=None,
                        compute_dtype=torch.bfloat16):
    """Value and gradient of the CTR loss, then AdamW without weight decay."""

    def step(params, opt_state, hist, target, other, labels):
        loss, grads = bst_value_and_grad(cfg, params, hist, target, other, labels,
                                         lookup_fn=lookup_fn, compute_dtype=compute_dtype)
        params, opt_state = adamw.update(grads, opt_state, params, lr, weight_decay=0.0)
        return params, opt_state, {"loss": loss}

    return step
