"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""

from .base import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen2.5-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab=256,
    qkv_bias=True,
    act="silu",
)
