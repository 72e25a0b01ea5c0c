"""StableLM-2-12B (dense, GQA kv=8).  [hf:stabilityai/stablelm-2-12b]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.  head_dim =
5120/32 = 160.
"""
from .base import LMConfig

CONFIG = LMConfig(
    name="stablelm-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352,
)

SMOKE = LMConfig(
    name="stablelm-12b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
    attn_chunk=16, loss_chunk=8,
)
