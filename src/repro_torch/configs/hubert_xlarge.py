"""hubert-xlarge [audio] — encoder-only transformer backbone.

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (cluster targets)
[arXiv:2106.07447].  The CNN waveform frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed 512-wide frame features;
a learned linear adapter + sinusoidal positions stand in for the conv
positional encoder.  Encoder-only: bidirectional attention, classic
(non-gated) GELU MLP, no decode shapes (decode_32k / long_500k skipped).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    causal=False,
    is_encoder=True,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    frontend="audio",
)
