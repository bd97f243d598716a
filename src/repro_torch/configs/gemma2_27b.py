"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating, logit softcap. [arXiv:2408.00118; hf]
"""

from .base import LMConfig

CONFIG = LMConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=144,
    d_ff=36864,
    vocab=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    local_window=4096,
    layer_pattern="local_global",
    post_norms=True,
    zero_centered_norm=True,
    embed_scale=True,
    act="gelu_tanh",
    # §Perf: remat_block=2 tried and REFUTED (+18% compute, +40% bytes) —
    # checkpoint block size trades memory, not recompute (EXPERIMENTS.md)
)

SMOKE = LMConfig(
    name="gemma2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    attn_softcap=50.0,
    final_softcap=30.0,
    local_window=8,
    layer_pattern="local_global",
    post_norms=True,
    zero_centered_norm=True,
    embed_scale=True,
    act="gelu_tanh",
)
