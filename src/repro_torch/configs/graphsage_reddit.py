"""GraphSAGE-Reddit (mean aggregator, 25-10 fanout).  [arXiv:1706.02216]

n_layers=2 d_hidden=128; minibatch training samples 25 then 10 neighbors
(the `minibatch_lg` shape overrides fanout to 15-10).
"""
from .base import GNNConfig

CONFIG = GNNConfig(name="graphsage-reddit", kind="graphsage", n_layers=2,
                   d_hidden=128, aggregator="mean", sample_sizes=(25, 10))

SMOKE = GNNConfig(name="graphsage-smoke", kind="graphsage", n_layers=2,
                  d_hidden=16, aggregator="mean", sample_sizes=(4, 3))
