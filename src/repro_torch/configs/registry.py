"""``--arch <id>`` registry: the ten assigned architectures + shape sets."""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import (
    bst,
    gatedgcn,
    gcn_cora,
    gemma2_27b,
    gin_tu,
    granite_moe_3b_a800m,
    grok_1_314b,
    pna,
    qwen2_5_14b,
    qwen3_32b,
)
from .base import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ShapeCell

_MODULES = {
    "grok-1-314b": grok_1_314b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "qwen3-32b": qwen3_32b,
    "qwen2.5-14b": qwen2_5_14b,
    "gemma2-27b": gemma2_27b,
    "gin-tu": gin_tu,
    "gcn-cora": gcn_cora,
    "gatedgcn": gatedgcn,
    "pna": pna,
    "bst": bst,
}

FAMILY = {
    "grok-1-314b": "lm",
    "granite-moe-3b-a800m": "lm",
    "qwen3-32b": "lm",
    "qwen2.5-14b": "lm",
    "gemma2-27b": "lm",
    "gin-tu": "gnn",
    "gcn-cora": "gnn",
    "gatedgcn": "gnn",
    "pna": "gnn",
    "bst": "recsys",
}

# long_500k needs sub-quadratic attention: run only for gemma2 (local/global
# hybrid, sliding-window local layers); skipped for pure full-attention archs
# (DESIGN.md §Shape skips).
LONG_CONTEXT_OK = {"gemma2-27b"}


def get_config(arch: str):
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str):
    return _MODULES[arch].SMOKE


def arch_ids() -> List[str]:
    return list(_MODULES)


def shapes_for(arch: str) -> List[ShapeCell]:
    fam = FAMILY[arch]
    if fam == "lm":
        cells = []
        for c in LM_SHAPES:
            if c.name == "long_500k" and arch not in LONG_CONTEXT_OK:
                continue  # noted skip
            cells.append(c)
        return cells
    if fam == "gnn":
        return list(GNN_SHAPES)
    return list(RECSYS_SHAPES)


def all_cells() -> List[Tuple[str, ShapeCell]]:
    out = []
    for arch in arch_ids():
        for cell in shapes_for(arch):
            out.append((arch, cell))
    return out
