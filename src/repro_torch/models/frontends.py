"""Modality frontends — stubs, as in the JAX package's ``models/frontends.py``.

``[vlm]`` / ``[audio]`` archs specify the transformer *backbone* only; the
SigLIP vision tower (paligemma) and the CNN feature encoder (hubert) are
replaced by *precomputed* patch/frame features.  The only learned pieces
here are the linear adapters that map frontend features into d_model.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..kernels.norm.ops import group_norm
from .config import ModelConfig
from .layers import cdtype, sinusoidal_positions
from .params import ParamSpec, dense_spec

VISION_FEATURE_DIM = 1152     # SigLIP-So400m output width (stubbed)
AUDIO_FEATURE_DIM = 512       # wav2vec2/HuBERT CNN encoder output (stubbed)
#: leaves the audio frontend reads in f32 (the JAX code's ``.astype``)
F32_LEAVES = {"ln_scale", "ln_bias"}


def frontend_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if cfg.frontend == "vision":
        return {"proj": dense_spec(VISION_FEATURE_DIM, cfg.d_model,
                                   (None, "embed"))}
    if cfg.frontend == "audio":
        return {"proj": dense_spec(AUDIO_FEATURE_DIM, cfg.d_model,
                                   (None, "embed")),
                "ln_scale": ParamSpec((cfg.d_model,), ("embed",), "ones"),
                "ln_bias": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    return {}


def feature_dim(cfg: ModelConfig) -> int:
    return VISION_FEATURE_DIM if cfg.frontend == "vision" else AUDIO_FEATURE_DIM


def embed_vision(p, patches: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Precomputed patch features (B, P, F) -> prefix embeddings (B, P, D)."""
    dt = cdtype(cfg)
    return torch.matmul(patches.to(dt), p["proj"].to(dt))


def embed_audio(p, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Precomputed frame features (B, S, F) -> (B, S, D) with sinusoidal
    positions (stand-in for hubert's conv positional encoder), layer-normed
    in f32 with the population variance (the norm kernel on the card)."""
    dt = cdtype(cfg)
    x = torch.matmul(frames.to(dt), p["proj"].to(dt))
    pos = sinusoidal_positions(x.shape[1], cfg.d_model,
                               device=x.device).to(dt)
    x = x + pos[None]
    return group_norm(x, p["ln_scale"], p["ln_bias"], x.shape[-1],
                      cfg.norm_eps)
