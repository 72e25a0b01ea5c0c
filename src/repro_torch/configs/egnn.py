"""EGNN (E(n)-equivariant GNN).  [arXiv:2102.09844]

n_layers=4 d_hidden=64.
"""
from .base import GNNConfig

CONFIG = GNNConfig(name="egnn", kind="egnn", n_layers=4, d_hidden=64,
                   aggregator="sum")

SMOKE = GNNConfig(name="egnn-smoke", kind="egnn", n_layers=2, d_hidden=16,
                  aggregator="sum")
