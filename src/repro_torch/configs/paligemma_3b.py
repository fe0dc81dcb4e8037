"""paligemma-3b [vlm] — SigLIP vision frontend (STUB) + Gemma-2B backbone.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216 [arXiv:2407.07726].
Gemma conventions: head_dim 256, GeGLU MLP, embeddings scaled by
sqrt(d_model), tied LM head.  The SigLIP tower is stubbed per the
assignment: ``input_specs()`` provides 256 precomputed patch embeddings
(1152-wide So400m features) which a learned linear adapter maps to d_model.
"""

import math

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    rope_theta=1e4,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    scale_emb=math.sqrt(2048.0),
    frontend="vision",
    n_prefix_embed=256,      # 224x224 / 14x14 SigLIP patches
)
