"""GQA/MQA/MHA attention block with rotary embedding and a KV cache.

The JAX package's ``models/attention.py`` in PyTorch, with one parameter
mapping shared by the call modes:

* :func:`attend_full`   — prefill over a whole sequence, through the
  flash-attention wrapper (the hand-written kernel on the card);
* :func:`attend_decode` — one new token against the cache, through the
  decode-attention wrapper (the hand-written kernel on the card; the JAX
  package's einsums on the CPU);
* cache init/update helpers used by the serving layer.

Projection weights keep *flattened* head dims — (d_model, H*hd) — as in
the JAX package.  The context-parallel path (``model_tp > 1``) comes with
the distribution slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig
from .layers import apply_rotary, cdtype, rows_matmul
from .params import ParamSpec, dense_spec, state_device


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def attn_spec(cfg: ModelConfig, stacked: int = 0) -> Dict[str, ParamSpec]:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": dense_spec(d, h * hd, ("embed", "heads"), stacked=stacked),
        "wk": dense_spec(d, kvh * hd, ("embed", "kv"), stacked=stacked),
        "wv": dense_spec(d, kvh * hd, ("embed", "kv"), stacked=stacked),
        "wo": dense_spec(h * hd, d, ("heads", "embed"), stacked=stacked),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            shape = (stacked, width) if stacked else (width,)
            axes = (("layers", "heads") if name == "bq" else ("layers", "kv")
                    ) if stacked else (("heads",) if name == "bq" else ("kv",))
            out[name] = ParamSpec(shape, axes, "zeros")
    return out


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, H, S, hd), k/v (B, KVH, S, hd), rotary applied.
    q and k come out contiguous; v is a transposed view (the kernel takes
    strides).  The kv projections, narrow beside d_model, run on fixed row
    chunks (:func:`~repro_torch.models.layers.rows_matmul`), so a token's
    keys and values do not depend on its batch."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cdtype(cfg)
    xd = x.to(dt)
    xq = torch.matmul(xd, p["wq"].to(dt))
    xk = rows_matmul(xd, p["wk"].to(dt))
    xv = rows_matmul(xd, p["wv"].to(dt))
    if cfg.qkv_bias:
        xq = xq + p["bq"].to(dt)
        xk = xk + p["bk"].to(dt)
        xv = xv + p["bv"].to(dt)
    q = xq.reshape(b, s, h, hd).transpose(1, 2)
    k = xk.reshape(b, s, kvh, hd).transpose(1, 2)
    v = xv.reshape(b, s, kvh, hd).transpose(1, 2)
    if not cfg.is_encoder:   # encoders use additive positions at embed time
        q = apply_rotary(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rotary(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


# ---------------------------------------------------------------------------
# Full-sequence attention (prefill)
# ---------------------------------------------------------------------------
def attend_full(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None,
                return_kv: bool = False):
    """(B, S, D) -> (B, S, D); optionally also the (k, v) for cache build."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    causal = cfg.causal and not cfg.is_encoder
    out = flash_attention(q, k, v, causal=causal)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    dt = cdtype(cfg)
    y = torch.matmul(out.to(dt), p["wo"].to(dt))
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zero k and v (B, KVH, max_len, hd) on ``device`` (default: the card)."""
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, kvh, max_len, hd)
    device = state_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The cache's shapes and dtypes as storage-less ``meta`` tensors."""
    return init_kv_cache(cfg, batch, max_len, dtype, device="meta")


def cache_from_prefill(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                       max_len: int, dtype=torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """Pad prefill (B, KVH, S, hd) K/V out to max_len cache arrays."""
    b, kvh, s, hd = k.shape
    cache = init_kv_cache(cfg, b, max_len, dtype, k.device)
    cache["k"][:, :, :s] = k
    cache["v"][:, :, :s] = v
    return cache


# ---------------------------------------------------------------------------
# Decode (one token per sequence)
# ---------------------------------------------------------------------------
def _row_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` as a (B,) int64 tensor on ``device``: an ``int`` is the same
    position for every row (spread without a host read); a (B,) tensor is
    one position per row."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() == 0:
            return pos.to(device=device, dtype=torch.int64).expand(batch)
        if tuple(pos.shape) != (batch,):
            raise ValueError(f"positions {tuple(pos.shape)} for a batch of "
                             f"{batch}: pass an int or a ({batch},) tensor")
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((batch,), int(pos), dtype=torch.int64, device=device)


def attend_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos,
                  cfg: ModelConfig):
    """x (B, 1, D) + cache at absolute position ``pos``: an ``int`` for the
    whole batch or a (B,) int tensor, one position per row (the decode
    engine's slots sit at different positions).

    Returns (y (B, 1, D), cache).  Each row's new K/V is written into the
    cache **in place** (the JAX package returns an updated copy; writing in
    place spares a copy of the whole cache per layer and step), at its
    position clamped into [0, max_len - 1] as ``jax.lax.dynamic_update_slice``
    clamps it, and each row attends to every cache position ``<=`` its own.
    The step reads no position on the host, so it runs on ``meta`` tensors
    at capture.  An ``int`` goes through the same arithmetic as a tensor.

    The attention itself is the decode-attention kernel on the card
    (``kernels/decode_attention``), each row limited to its keys ``[0, pos
    + 1)`` by ``lengths``; its split plan reads no batch size and every sum
    has a fixed order, so a row gets the same bits in any batch, and it
    computes the step's weights (from the row's global max, rounded to the
    cache dtype before the weighted sum).  q goes in the cache dtype.  On the CPU (and on ``meta``) the wrapper runs the
    step's products (:func:`~repro_torch.kernels.decode_attention.ref.
    decode_attention_masked_ref`): the scores and the weighted sum read the
    bf16 cache with f32 accumulation, as the JAX package's
    ``preferred_element_type=f32`` einsums do (q and the softmax weights
    rounded to the cache dtype first, then both operands of each product
    widened to f32: a product of two bf16 values is exact in f32, so only
    the order of the sums differs from XLA's).
    """
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    pos = _row_positions(pos, b, x.device)                      # (B,)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])

    k_cache, v_cache = cache["k"], cache["v"]
    dtype = k_cache.dtype
    t = k_cache.shape[2]
    rows = torch.arange(b, device=x.device)
    at = pos.clamp(0, t - 1)
    k_cache[rows, :, at] = k_new[:, :, 0].to(dtype)
    v_cache[rows, :, at] = v_new[:, :, 0].to(dtype)

    dt = cdtype(cfg)
    o = decode_attention(q[:, :, 0].to(dtype), k_cache, v_cache,
                         scale=hd ** -0.5, lengths=at + 1, out_dtype=dt)
    o = o.reshape(b, 1, h * hd)
    y = torch.matmul(o.to(dt), p["wo"].to(dt))
    return y, cache
