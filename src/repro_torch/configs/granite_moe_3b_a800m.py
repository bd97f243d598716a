"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Note: the assignment line reads "MoE 40e top-8 — 32 experts top-8"
(self-inconsistent); we follow the structured field: 40 experts, top-8
(recorded in DESIGN.md §Arch-applicability).
"""

from .base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, impl="capacity"),
    act="silu",
)

SMOKE = LMConfig(
    name="granite-moe-smoke",
    n_layers=2,
    d_model=48,
    n_heads=6,
    n_kv_heads=2,
    d_head=8,
    d_ff=64,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff=64),
    act="silu",
)
