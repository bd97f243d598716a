"""gatedgcn [gnn] — 16 layers, d_hidden=70, gated aggregator.
[arXiv:2003.00982; paper]
"""

from .base import GNNConfig

CONFIG = GNNConfig(
    name="gatedgcn", kind="gatedgcn", n_layers=16, d_hidden=70,
    extras={"aggregator": "gated"}, n_classes=16,
)

SMOKE = GNNConfig(name="gatedgcn-smoke", kind="gatedgcn", n_layers=3, d_hidden=12, n_classes=4)
