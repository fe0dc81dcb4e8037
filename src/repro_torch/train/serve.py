"""Serving steps: batched prefill and single-token greedy decode.

The JAX package's ``train/serve.py`` in PyTorch.  The steps take the port's
model (:class:`~repro_torch.models.transformer.Transformer`) where the JAX
steps take a parameter tree, and run on the model's device: build the model
on the card (the default of ``init_params`` and ``params_from_jax``) or on
the CPU with ``device="cpu"``, where the kernel wrappers run their plain
versions.  The steps serve every arch the model builds: a dense stack's
cache is its KV cache (``max_len`` rows), an rwkv or mamba layer's its
recurrent state, which ``max_len`` does not size; either is updated in
place by a decode step.  A vision model (paligemma) is served through
:func:`make_prefill_step` with ``{"tokens", "patches"}`` and
:func:`make_decode_step` from position P + S; :func:`greedy_generate`, like
the JAX package's and the decode engine, takes token prompts only.
Encoder archs (hubert) have no prefill/decode: :func:`make_prefill_step`
gives their ``encode`` step, a full forward returning per-frame logits.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.config import ModelConfig
from ..models.layers import logits_from_hidden
from ..models.transformer import Transformer, decode_step, forward, prefill


def _check_model(model: Transformer, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was made for {cfg.name}, the model is "
                         f"{model.cfg.name}")


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      cache_dtype=torch.bfloat16) -> Callable:
    """(model, {"tokens": (B, S)[, "patches": (B, P, F)]}) -> (last-token
    logits (B, Vp), cache).  A vision model's patches are embedded and
    prepended to the tokens, so the cache holds P + S positions and the
    first decode position is P + S; a model without a vision frontend
    refuses them.  An encoder's step is its encode: (model, {"frames": (B,
    S, F)}) -> per-frame logits (B, S, Vp) f32, ``torch.no_grad``."""
    if cfg.is_encoder:
        @torch.no_grad()
        def encode(model, inputs):
            _check_model(model, cfg)
            hidden, _ = forward(model, inputs, cfg)
            return logits_from_hidden(model.embed, hidden, cfg)
        return encode

    def prefill_step(model, inputs):
        _check_model(model, cfg)
        return prefill(model, inputs, max_len, cache_dtype)

    return prefill_step


def make_decode_step(cfg: ModelConfig, return_logits: bool = True, *,
                     moe_group_size: Optional[int] = None) -> Callable:
    """One decode step: (model, cache, tokens, pos) -> next tokens, where
    ``pos`` is an ``int`` for the whole batch or a (B,) int tensor of
    per-row positions (one arithmetic path for both).

    ``return_logits=True`` returns (next (B,) int32, logits (B, Vp), cache);
    ``return_logits=False`` is the serving fast path, (next, cache), which
    hands no ``(B, vocab)`` logits back to the caller.  The cache is
    updated in place.  ``argmax`` takes the first maximum, as in JAX.
    ``moe_group_size`` is passed to
    :func:`~repro_torch.models.transformer.decode_step` (None: the JAX
    stack's routing groups; the decode engine passes 1).
    """
    if not return_logits:
        def greedy_step(model, cache, tokens, pos):
            _check_model(model, cfg)
            logits, new_cache = decode_step(model, cache, tokens, pos,
                                            moe_group_size=moe_group_size)
            return torch.argmax(logits, dim=-1).to(torch.int32), new_cache

        return greedy_step

    def serve_step(model, cache, tokens, pos):
        _check_model(model, cfg)
        logits, new_cache = decode_step(model, cache, tokens, pos,
                                        moe_group_size=moe_group_size)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, new_cache

    return serve_step


def greedy_generate(model: Transformer, prompt, max_new: int,
                    max_len: int) -> torch.Tensor:
    """Greedy decoding (prefill + ``max_new - 1`` decode steps) of a
    (B, S) prompt of token ids (numpy or tensor), on the model's device;
    -> (B, max_new) int32 tokens."""
    cfg = model.cfg
    prompt = torch.as_tensor(prompt, device=model.device).long()
    s = prompt.shape[1]
    logits, cache = make_prefill_step(cfg, max_len)(model, {"tokens": prompt})
    step_fn = make_decode_step(cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        tok, _, cache = step_fn(model, cache, tok, s + i)
        out.append(tok)
    return torch.stack(out, dim=1)
