"""deepseek-v2-236b [moe] — MLA attention + 160-expert MoE.

60L d_model=5120 128H d_ff=1536(expert) vocab=102400, MoE 160e top-6,
MLA kv_lora=512, 2 shared + 160 routed [arXiv:2405.04434; hf].
First layer uses a dense 12288-wide MLP (HF config: first_k_dense_replace=1).
MLA: q_lora 1536, qk_nope 128 + qk_rope 64 per head, v_head_dim 128 — the
compressed 576-wide KV cache is what makes decode_32k memory-light.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # MLA: per-head K/V expanded from the latent
    head_dim=128,
    d_ff=1536,             # expert intermediate width (assignment value)
    vocab=102400,
    block_pattern=("mla",),
    mlp_pattern=("moe",),
    first_layer_dense=True,
    d_ff_dense=12288,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    rope_theta=1e4,
    norm="rmsnorm",
    act="silu",
)
