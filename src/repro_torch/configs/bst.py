"""bst [recsys] — embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256, transformer-seq interaction (Alibaba BST).
[arXiv:1905.06874; paper]
"""

from .base import RecsysConfig

CONFIG = RecsysConfig(
    name="bst",
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp_dims=(1024, 512, 256),
    n_items=4_194_304,
    n_other_feats=16,
)

SMOKE = RecsysConfig(
    name="bst-smoke",
    embed_dim=16,
    seq_len=8,
    n_blocks=1,
    n_heads=4,
    mlp_dims=(32, 16),
    n_items=1024,
    n_other_feats=4,
)
