"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [moe].

48L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=163840,
MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B].  Assignment dims used
verbatim (the HF release has 27 layers; the assigned pool pins 48).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    block_pattern=("attn",),
    mlp_pattern=("moe",),
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    rope_theta=1e4,
    norm="rmsnorm",
    act="silu",
)
