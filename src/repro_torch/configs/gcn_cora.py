"""gcn-cora [gnn] — 2 layers, d_hidden=16, mean aggregator, symmetric norm.
[arXiv:1609.02907; paper]
"""

from .base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora", kind="gcn", n_layers=2, d_hidden=16,
    extras={"aggregator": "mean", "norm": "sym"}, n_classes=7,
)

SMOKE = GNNConfig(name="gcn-smoke", kind="gcn", n_layers=2, d_hidden=8, n_classes=4)
