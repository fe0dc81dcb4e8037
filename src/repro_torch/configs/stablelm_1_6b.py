"""stablelm-1.6b (StableLM-2) [dense].

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b].  LayerNorm, partial rotary (25 % of the
head dim), qkv bias, gated-SiLU MLP.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    qkv_bias=True,
    rotary_pct=0.25,
    rope_theta=1e4,
    norm="layernorm",
    act="silu",
)
