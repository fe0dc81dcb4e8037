"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE every other.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf].  Period of 8 layers: one attention layer per seven
mamba layers; MoE replaces the dense MLP on every other layer.
Sub-quadratic (9 attention layers only) → runs the long_500k cell.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    mlp_pattern=("dense", "moe", "dense", "moe",
                 "dense", "moe", "dense", "moe"),
    n_experts=16,
    top_k=2,
    d_ff_expert=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=1e4,
    norm="rmsnorm",
    act="silu",
)
