"""StableLM-2-1.6B (dense, full MHA: kv=32).  [hf:stabilityai/stablelm-2-1_6b]

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352.
"""
from .base import LMConfig

CONFIG = LMConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352,
)

SMOKE = LMConfig(
    name="stablelm-1.6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=128,
    attn_chunk=16, loss_chunk=8,
)
