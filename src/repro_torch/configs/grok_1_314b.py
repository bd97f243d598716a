"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]
"""

from .base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,  # dense-equivalent ff (experts use moe.d_ff)
    vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768, impl="capacity"),
    act="gelu_tanh",
    rope_theta=10000.0,
)

# reduced same-family config for CPU smoke tests
SMOKE = LMConfig(
    name="grok-1-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=96),
    act="gelu_tanh",
)
