"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]
"""

from .base import LMConfig

CONFIG = LMConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=80,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    act="silu",
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=128,
    vocab=256,
    qk_norm=True,
    act="silu",
)
