"""qwen2.5-3b [dense] — GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936
[hf:Qwen/Qwen2.5-3B].  Tied embeddings, rope theta 1e6.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    qkv_bias=True,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
)
