"""repro_torch.configs — the 10 assigned architectures x 4 input shapes.

A copy of the JAX package's ``configs/__init__.py`` without its JAX part:

* :data:`ARCHS` — registry: assignment id → ModelConfig (exact pool dims);
* :data:`SHAPES` — the four shape cells (train_4k / prefill_32k /
  decode_32k / long_500k);
* :func:`cells` — the live (arch, shape) grid with the skip rules applied
  (long_500k only for sub-quadratic archs; encoder-only archs have no
  decode shapes);
* :func:`example_config` — the ~86M qwen-family model that
  ``examples/train_lm.py`` (and the port's ``examples/train_lm_torch.py``)
  trains.

``input_specs`` (abstract inputs for the dry-run) comes with the dry-run
slice.  The ten ``configs/*.py`` data files are copies of the JAX
package's.  The port builds all ten (hubert encodes, the others
serve); it trains all but rwkv6-3b and jamba-1.5-large-398b, which
raise ``NotImplementedError`` where the loss is taken
(:func:`repro_torch.models.transformer.check_trainable`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..models.config import ModelConfig
from . import (deepseek_v2_236b, hubert_xlarge, jamba_1_5_large_398b,
               minicpm_2b, mistral_large_123b, moonshot_v1_16b_a3b,
               paligemma_3b, qwen2_5_3b, rwkv6_3b, stablelm_1_6b)

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        jamba_1_5_large_398b.CONFIG,
        deepseek_v2_236b.CONFIG,
        moonshot_v1_16b_a3b.CONFIG,
        paligemma_3b.CONFIG,
        rwkv6_3b.CONFIG,
        stablelm_1_6b.CONFIG,
        mistral_large_123b.CONFIG,
        minicpm_2b.CONFIG,
        qwen2_5_3b.CONFIG,
        hubert_xlarge.CONFIG,
    )
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; otherwise why it is skipped."""
    if cfg.is_encoder and shape.kind in ("decode",):
        return "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch: O(S^2) at 512k context"
    return None


def cells(include_skipped: bool = False
          ) -> List[Tuple[str, str, Optional[str]]]:
    """The (arch, shape, skip_reason) grid — 40 nominal cells."""
    out = []
    for a, cfg in ARCHS.items():
        for s, shape in SHAPES.items():
            reason = skip_reason(cfg, shape)
            if reason is None or include_skipped:
                out.append((a, s, reason))
    return out


def get(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")


def example_config() -> ModelConfig:
    """The ~86M qwen-family model of ``examples/train_lm.py`` (f32)."""
    return dataclasses.replace(
        ARCHS["qwen2.5-3b"].reduced(),
        name="qwen2.5-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=2048, dtype="float32")
