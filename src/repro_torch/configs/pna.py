"""pna [gnn] — 4 layers, d_hidden=75, aggregators mean-max-min-std,
scalers identity-amplification-attenuation.  [arXiv:2004.05718; paper]
"""

from .base import GNNConfig

CONFIG = GNNConfig(
    name="pna", kind="pna", n_layers=4, d_hidden=75,
    extras={"aggregators": ("mean", "max", "min", "std"),
            "scalers": ("identity", "amplification", "attenuation")},
    n_classes=16,
)

SMOKE = GNNConfig(name="pna-smoke", kind="pna", n_layers=2, d_hidden=10, n_classes=4)
