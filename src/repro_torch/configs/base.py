"""Config dataclasses for all architecture families + shape cells."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    impl: str = "ragged"  # "ragged" (sorted grouped GEMM) | "dense" (masked)


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None  # sliding window for local layers
    layer_pattern: str = "global"  # "global" | "local_global" (alternating)
    post_norms: bool = False  # Gemma-2 post-attn/post-ffn norms
    zero_centered_norm: bool = False  # Gemma (1 + w) RMSNorm
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = True
    embed_scale: bool = False  # Gemma multiplies embeddings by sqrt(d_model)
    remat_block: int = 1  # layers per checkpoint block (2 halves recompute
    #                       flops for one extra saved carry per pair)

    @property
    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d, dh = self.d_model, self.d_head
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * dh
        if self.qk_norm:
            attn += 2 * dh
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        norms = (4 if self.post_norms else 2) * d
        per_layer = attn + ffn + norms
        total = self.n_layers * per_layer + self.vocab * d + d
        if not self.tie_embeddings:
            total += self.vocab * d
        return total

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params
        d = self.d_model
        dead = (self.moe.n_experts - self.moe.top_k) * 3 * d * self.moe.d_ff
        return self.n_params - self.n_layers * dead


@dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # "gcn" | "gin" | "gatedgcn" | "pna"
    n_layers: int
    d_hidden: int
    extras: Dict = field(default_factory=dict)  # eps, aggregators, scalers...
    n_classes: int = 16


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    n_items: int = 4_194_304  # 2^22 — Alibaba-scale item vocabulary
    n_cats: int = 65_536
    n_other_feats: int = 16  # dense profile/context features


@dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""

    name: str
    kind: str  # "train" | "prefill" | "decode" | "gnn_full" | "gnn_minibatch" | ...
    params: Dict = field(default_factory=dict)


# -- per-family shape sets (from the assignment) -----------------------------
LM_SHAPES: List[ShapeCell] = [
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
]

GNN_SHAPES: List[ShapeCell] = [
    ShapeCell("full_graph_sm", "gnn_full",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeCell("minibatch_lg", "gnn_minibatch",
              {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602}),
    ShapeCell("ogb_products", "gnn_full",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    ShapeCell("molecule", "gnn_batched",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16}),
]

RECSYS_SHAPES: List[ShapeCell] = [
    ShapeCell("train_batch", "recsys_train", {"batch": 65536}),
    ShapeCell("serve_p99", "recsys_serve", {"batch": 512}),
    ShapeCell("serve_bulk", "recsys_serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "recsys_retrieval", {"batch": 1, "n_candidates": 1_000_000}),
]
