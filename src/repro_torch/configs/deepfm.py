"""DeepFM on Criteo-scale vocabularies.  [arXiv:1703.04247]

39 fields (13 bucketized numeric + 26 categorical), embed_dim=10, MLP
400-400-400, FM interaction.  The shared embedding table has 32,722,432
rows (published Criteo-1TB per-field cardinalities, padded to a multiple
of 512).
"""
from .base import RecsysConfig

CONFIG = RecsysConfig(name="deepfm", n_dense=13, n_sparse=26, embed_dim=10,
                      mlp_dims=(400, 400, 400), vocab_scale=1.0)

SMOKE = RecsysConfig(name="deepfm-smoke", n_dense=13, n_sparse=26,
                     embed_dim=8, mlp_dims=(32, 32), vocab_scale=1e-4)
