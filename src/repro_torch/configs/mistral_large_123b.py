"""mistral-large-123b (Mistral-Large-Instruct-2407) [dense].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
[hf:mistralai/Mistral-Large-Instruct-2407].  The TP-stress arch of the
pool: the deepest, widest dense stack (123B params, 88 layers).
Pure full attention → long_500k skipped (O(S^2) at 512k).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=32768,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
)
