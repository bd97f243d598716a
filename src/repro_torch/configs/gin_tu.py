"""gin-tu [gnn] — 5 layers, d_hidden=64, sum aggregator, learnable eps.
[arXiv:1810.00826; paper]
"""

from .base import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
    extras={"aggregator": "sum", "eps": "learnable"}, n_classes=2,
)

SMOKE = GNNConfig(name="gin-smoke", kind="gin", n_layers=2, d_hidden=16, n_classes=2)
