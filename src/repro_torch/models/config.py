"""ModelConfig — one dataclass describing every assigned architecture.

A copy of the JAX package's ``models/config.py`` (pure dataclasses, no
framework), field for field, so both packages read the same configs.

A model is a periodic stack of blocks.  ``block_pattern`` lists the block
kind at each position within one period (``attn`` / ``mla`` / ``mamba`` /
``rwkv``) and ``mlp_pattern`` the feed-forward kind (``dense`` / ``moe`` /
``none`` — rwkv blocks carry their own channel-mix, so they use ``none``).
The stack scans ``n_layers / len(block_pattern)`` groups of stacked weights
(HLO size is O(period), not O(depth) — essential for the 1-CPU dry-run).

``reduced()`` derives the family-preserving smoke-test configuration used by
tests (small widths/depths/experts, same block structure).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads

    # stack structure (one period)
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp_pattern: Tuple[str, ...] = ("dense",)
    first_layer_dense: bool = False        # deepseek: layer 0 is dense-MLP

    # attention
    attn_kind: str = "gqa"                 # "gqa" | "mla"
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rotary_pct: float = 1.0                # stablelm: 0.25
    causal: bool = True
    is_encoder: bool = False               # hubert: no decode path

    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_dense: int = 0                    # dense-MLP width when mixed w/ MoE
    capacity_factor: float = 1.25

    # Mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0                 # 0 -> d_model // 16

    # RWKV-6
    rwkv_head_dim: int = 64

    # norms / embeddings / scaling
    norm: str = "rmsnorm"                  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    scale_emb: float = 1.0                 # minicpm: 12
    scale_depth: float = 0.0               # minicpm: 1.4 (0 -> off)
    logit_scale_base: int = 0              # minicpm dim_model_base: 256
    act: str = "silu"                      # "silu" | "gelu"
    gated_mlp: bool = True                 # False: classic 2-matmul MLP

    # modality frontend stub ("none" | "vision" | "audio")
    frontend: str = "none"
    n_prefix_embed: int = 256              # vision: patch tokens prepended

    # activation compute dtype
    dtype: str = "bfloat16"

    # activation-checkpoint policy applied to each scanned layer group
    # ("none" | "dots" | "full") — per-layer remat keeps only the carry
    # between groups; "dots" additionally saves non-batch matmul outputs.
    remat: str = "none"

    # FSDP strategy: True = all-gather the (embed-sharded) weights of each
    # scan group before use (weight traffic = params/n_groups per step);
    # False = let GSPMD partial-sum matmuls and all-reduce *activations*
    # (traffic = activations per matmul — 26x worse for stablelm train_4k,
    # see EXPERIMENTS §Perf).  Exposed as a knob so both lower.
    fsdp_gather_weights: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.mamba_dt_rank == 0:
            object.__setattr__(self, "mamba_dt_rank",
                               max(1, self.d_model // 16))
        period = len(self.block_pattern)
        if len(self.mlp_pattern) != period:
            raise ValueError("block_pattern and mlp_pattern lengths differ")
        scanned = self.n_layers - (1 if self.first_layer_dense else 0)
        if scanned % period:
            raise ValueError(
                f"{self.name}: {scanned} scanned layers not divisible by "
                f"period {period}")

    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        return (self.n_layers - (1 if self.first_layer_dense else 0)) // self.period

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so it shards over 16 (and stays 128-lane tidy)."""
        return -(-self.vocab // 256) * 256

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def has_attention(self) -> bool:
        return any(b in ("attn", "mla") for b in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if per-token decode state is O(1) in context (SSM/linear)."""
        return not any(b in ("attn", "mla") for b in self.block_pattern) or (
            self.block_pattern.count("attn") + self.block_pattern.count("mla")
        ) < len(self.block_pattern)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, h, kvh, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = {b: 0 for b in set(self.block_pattern)}
        if "attn" in per:
            per["attn"] = d * (h * hd) + 2 * d * (kvh * hd) + (h * hd) * d
        if "mla" in per:
            ql, kvl = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vd = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                              self.v_head_dim)
            per["mla"] = (d * ql + ql * h * (nope + rope) + d * (kvl + rope)
                          + kvl * h * (nope + vd) + h * vd * d)
        if "mamba" in per:
            di, n, dtr = self.mamba_d_inner, self.mamba_d_state, self.mamba_dt_rank
            per["mamba"] = (d * 2 * di + di * self.mamba_d_conv
                            + di * (dtr + 2 * n) + dtr * di + di * n + di
                            + di * d)
        if "rwkv" in per:
            per["rwkv"] = 5 * d * d + 2 * d * 32 + (d * self.d_ff + self.d_ff * d
                                                    + d * d)
        mlp = {"dense": (3 if self.gated_mlp else 2) * d * self.d_ff,
               "none": 0}
        if self.n_experts:
            ff = self.d_ff_expert or self.d_ff
            mlp["moe"] = (self.n_experts * 3 * d * ff + d * self.n_experts
                          + self.n_shared_experts * 3 * d * ff)
        layers = 0
        for b, m in zip(self.block_pattern, self.mlp_pattern):
            layers += per[b] + mlp[m]
        total += layers * self.n_groups
        if self.first_layer_dense:
            total += per.get("attn", per.get("mla", 0)) + 3 * d * (
                self.d_ff_dense or self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        ff = self.d_ff_expert or self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * ff
        n_moe = sum(1 for m in self.mlp_pattern if m == "moe") * self.n_groups
        return int(self.param_count() - n_moe * inactive)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Family-preserving smoke-test config (runs a step on 1 CPU)."""
        changes = dict(
            name=self.name + "-smoke",
            n_layers=(1 if self.first_layer_dense else 0) + self.period,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            d_ff_expert=128 if self.d_ff_expert else 0,
            d_ff_dense=256 if self.d_ff_dense else 0,
            mamba_dt_rank=8,
            rwkv_head_dim=32,
            n_prefix_embed=8 if self.frontend == "vision" else self.n_prefix_embed,
            dtype="float32",
        )
        return dataclasses.replace(self, **changes)
