"""rwkv6-3b (Finch) [ssm] — attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
40 heads of 64; per-layer state is O(1) in context (two token-shift vectors
+ a (H, 64, 64) WKV accumulator) → runs the long_500k cell natively.
The rwkv block carries its own channel-mix (mlp_pattern "none").
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    n_layers=32,
    d_model=2560,
    n_heads=1,               # unused (attention-free)
    n_kv_heads=1,
    head_dim=2560,
    d_ff=8960,
    vocab=65536,
    block_pattern=("rwkv",),
    mlp_pattern=("none",),
    rwkv_head_dim=64,
    norm="layernorm",
)
