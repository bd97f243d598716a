"""Train-step builders per model family.

Each builder returns ``step(params, opt_state, batch...) -> (params,
opt_state, metrics)``: the loss and its gradients from torch autograd, then
a functional AdamW update (new tensors; the old parameters stay as they
were).  The GNN step is ported here; the LM and BST steps come with their
model slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import GNNConfig
from ..models import gnn as G
from ..optim import adamw
from ..optim.tree import tree_leaves, tree_map, tree_unflatten


def gnn_value_and_grad(cfg: GNNConfig, params, node_feat, src, dst, edge_mask, labels,
                       label_mask, n_nodes: int, graph_ids: Optional[torch.Tensor] = None,
                       n_graphs: int = 0):
    """``(loss, grads)`` of ``gnn_loss(gnn_logits(...))`` at ``params``;
    ``grads`` has ``params``' tree, and neither is attached to a graph."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits = G.gnn_logits(cfg, live, node_feat, src, dst, edge_mask, n_nodes,
                              graph_ids=graph_ids, n_graphs=n_graphs)
        loss = G.gnn_loss(logits, labels, label_mask)
        # a leaf the model never reads (GatedGCN's norm_scale) gets zeros, as in JAX
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(live, grads)


def make_gnn_train_step(
    cfg: GNNConfig,
    n_nodes: int,
    lr: float = 1e-3,
    graph_level: bool = False,
    n_graphs: int = 0,
):
    def step(params, opt_state, node_feat, src, dst, edge_mask, labels, label_mask,
             graph_ids=None):
        loss, grads = gnn_value_and_grad(
            cfg, params, node_feat, src, dst, edge_mask, labels, label_mask, n_nodes,
            graph_ids=graph_ids if graph_level else None, n_graphs=n_graphs)
        params, opt_state = adamw.update(grads, opt_state, params, lr, weight_decay=0.0)
        return params, opt_state, {"loss": loss}

    return step
