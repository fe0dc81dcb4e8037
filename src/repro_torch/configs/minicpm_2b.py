"""minicpm-2b [dense] — llama-like with MiniCPM's mu-parametrization tricks.

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753 [arXiv:2404.06395].
scale_emb=12, depth-scaled residuals (1.4/sqrt(L)), logits divided by
d_model/dim_model_base (256), tied embeddings.  Trains with the WSD
(warmup-stable-decay) schedule — see repro.optim.wsd_schedule.

36 heads is not divisible by the 16-wide model axis: attention TP falls
back to batch sharding for the head axis (the flattened 2304-wide QKV
projections still shard: 2304 = 16 x 144) — see DESIGN.md §5.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab=122753,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    rope_theta=1e4,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    scale_emb=12.0,
    scale_depth=1.4,
    logit_scale_base=256,
)
