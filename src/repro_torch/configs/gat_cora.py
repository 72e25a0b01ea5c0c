"""GAT on Cora (2 layers, 8 hidden x 8 heads).  [arXiv:1710.10903]"""
from .base import GNNConfig

CONFIG = GNNConfig(name="gat-cora", kind="gat", n_layers=2, d_hidden=8,
                   n_heads=8, aggregator="attn")

SMOKE = GNNConfig(name="gat-smoke", kind="gat", n_layers=2, d_hidden=8,
                  n_heads=2, aggregator="attn")
