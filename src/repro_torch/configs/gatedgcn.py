"""GatedGCN (benchmark config of Dwivedi et al.).  [arXiv:2003.00982]

n_layers=16 d_hidden=70, gated aggregator with edge features.
"""
from .base import GNNConfig

CONFIG = GNNConfig(name="gatedgcn", kind="gatedgcn", n_layers=16,
                   d_hidden=70, aggregator="gated")

SMOKE = GNNConfig(name="gatedgcn-smoke", kind="gatedgcn", n_layers=3,
                  d_hidden=16, aggregator="gated")
