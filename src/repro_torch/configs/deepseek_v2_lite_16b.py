"""DeepSeek-V2-Lite 16B (MoE, MLA attention).  [arXiv:2405.04434; hf]

Assignment line: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE 64e top-6, MLA kv_lora=512, 2 shared + routed top-6.  (The assignment
note "160 routed" matches full V2; Lite publishes 64 routed experts — we
follow the published Lite config, which also matches the "64e" in the
assignment line.)
"""
from .base import LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,                      # dense FFN of layer group (lite)
    vocab=102400,
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
)

SMOKE = LMConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=128,
    attn_chunk=16, loss_chunk=8,
    mla=MLAConfig(kv_lora_rank=24, rope_head_dim=8, nope_head_dim=16,
                  v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=2, d_expert=24),
)
