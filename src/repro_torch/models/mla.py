"""Multi-head Latent Attention (DeepSeek-V2) with the compressed KV cache.

The JAX package's ``models/mla.py`` in PyTorch.  MLA projects hidden states
into a low-rank latent ``c_kv`` (kv_lora_rank) plus one rotary key slice
shared by the heads; per-head K/V are up-projected from the latent.  The
cache holds only ``c_kv`` and ``k_rope`` per token.

* prefill: the latents are expanded to full per-head K/V and run through
  the flash-attention wrapper (the hand-written kernel on the card) at
  Dk = nope + rope against Dv = v_head_dim;
* decode: the **absorbed** form — W_UK folds into the query, W_UV into the
  output — so attention runs MQA-style against the latent cache as plain
  products (the JAX package's einsums, not a kernel: the latent width of
  576 / 512 is over the decode kernel's 256), one row at a time, so that
  no product's shape depends on the batch.

Dtypes follow the JAX package, which reads its f32 masters: the model keeps
:data:`F32_LEAVES` in f32; the prefill casts ``wk_b``/``wv_b`` to the
compute dtype where the JAX block does, and the decode's absorbed products
run in f32 (the JAX einsums' ``preferred_element_type=float32`` over
operands rounded to the cache dtype, widened here to f32 first: a product
of two bf16 values is exact in f32).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..distributed.sharding import constrain, is_dtensor, replicated
from ..kernels.flash_attention.ops import flash_attention
from .attention import _row_positions, merge_heads, pad_rows, write_at
from .config import ModelConfig
from .layers import NEG_INF, apply_rotary, cdtype, rms_norm_1d
from .params import ParamSpec, dense_spec, state_device

#: leaves the JAX block reads in f32: the latent norms' scales
#: (``layers.py:51-56``) and the up-projections of the absorbed decode
#: (``mla.py:184,201``)
F32_LEAVES = frozenset({"q_norm", "kv_norm", "wk_b", "wv_b"})


def mla_spec(cfg: ModelConfig, stacked: int = 0) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    def vec(width, axes):
        shape = (stacked, width) if stacked else (width,)
        ax = (("layers",) + axes) if stacked else axes
        return ParamSpec(shape, ax, "ones")

    return {
        # query path: d -> q_lora -> per-head (nope + rope)
        "wq_a": dense_spec(d, ql, ("embed", None), stacked=stacked),
        "q_norm": vec(ql, (None,)),
        "wq_b": dense_spec(ql, h * (nope + rope), (None, "heads"),
                           stacked=stacked),
        # kv path: d -> (kv_lora | shared rope key)
        "wkv_a": dense_spec(d, kvl + rope, ("embed", None), stacked=stacked),
        "kv_norm": vec(kvl, (None,)),
        "wk_b": dense_spec(kvl, h * nope, (None, "heads"), stacked=stacked),
        "wv_b": dense_spec(kvl, h * vd, (None, "heads"), stacked=stacked),
        "wo": dense_spec(h * vd, d, ("heads", "embed"), stacked=stacked),
    }


def _latents(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """x (B,S,D) -> (c_kv (B,S,kvl) normed, k_rope (B,1,S,rope) rotated).
    ``positions`` (S,) or (B, S)."""
    b, s, _ = x.shape
    kvl, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dt = cdtype(cfg)
    kv_a = torch.matmul(x.to(dt), p["wkv_a"].to(dt))
    c_kv = rms_norm_1d(kv_a[..., :kvl], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., kvl:].reshape(b, s, 1, rope).transpose(1, 2)
    k_rope = apply_rotary(k_rope, positions, cfg.rope_theta)
    return c_kv, k_rope


def _queries(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """-> q_nope (B,H,S,nope), q_rope (B,H,S,rope)."""
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = cdtype(cfg)
    qa = rms_norm_1d(torch.matmul(x.to(dt), p["wq_a"].to(dt)), p["q_norm"],
                     cfg.norm_eps)
    qb = torch.matmul(qa.to(dt), p["wq_b"].to(dt))
    qb = qb.reshape(b, s, h, nope + rope).transpose(1, 2)
    q_nope, q_rope = qb[..., :nope], qb[..., nope:]
    q_rope = apply_rotary(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


# ---------------------------------------------------------------------------
# Prefill: expand the latents, the flash-attention kernel
# ---------------------------------------------------------------------------
def mla_full(p, x: torch.Tensor, cfg: ModelConfig, *,
             positions: Optional[torch.Tensor] = None,
             return_cache: bool = False):
    """(B, S, D) -> (B, S, D); with ``return_cache`` also the latents
    (c_kv (B, S, kvl), k_rope (B, S, rope)) for the cache."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    dt = cdtype(cfg)

    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)

    k_nope = torch.matmul(c_kv.to(dt), p["wk_b"].to(dt))
    k_nope = k_nope.reshape(b, s, h, nope).transpose(1, 2)
    v = torch.matmul(c_kv.to(dt), p["wv_b"].to(dt))
    v = v.reshape(b, s, h, vd).transpose(1, 2)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, rope)], dim=-1)
    q = constrain(q, "batch", "heads", "seq", None)
    out = flash_attention(q, k, v, causal=True, scale=(nope + rope) ** -0.5)
    out = merge_heads(out.transpose(1, 2))
    y = torch.matmul(out.to(dt), p["wo"].to(dt))
    if return_cache:
        return y, (c_kv, k_rope[:, 0])
    return y


# ---------------------------------------------------------------------------
# Compressed cache
# ---------------------------------------------------------------------------
def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None
                   ) -> Dict[str, torch.Tensor]:
    """Zero c_kv (B, max_len, kvl) and k_rope (B, max_len, rope) on
    ``device`` (default: the card)."""
    dev = state_device(device)
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=dev),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=dev),
    }


def mla_cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The cache's shapes and dtypes as storage-less ``meta`` tensors."""
    return init_mla_cache(cfg, batch, max_len, dtype, device="meta")


def mla_cache_from_prefill(cfg: ModelConfig, c_kv: torch.Tensor,
                           k_rope: torch.Tensor, max_len: int,
                           dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Pad the prefill's latents (B, S, ·) out to ``max_len`` cache rows
    (under sharding rules, split on T as the decode step places them)."""
    b, s, _ = c_kv.shape
    if is_dtensor(c_kv, k_rope):
        return {name: constrain(pad_rows(x.to(dtype), 1, max_len),
                                "batch", "kv_seq", None)
                for name, x in (("c_kv", c_kv), ("k_rope", k_rope))}
    cache = init_mla_cache(cfg, b, max_len, dtype, c_kv.device)
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope
    return cache


# ---------------------------------------------------------------------------
# Decode: absorbed MQA-style attention against the latent cache
# ---------------------------------------------------------------------------
def mla_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos,
               cfg: ModelConfig):
    """x (B, 1, D) + the latent cache at ``pos``: an ``int`` for the whole
    batch or a (B,) int tensor, one position per row.  Returns (y (B, 1, D),
    cache).  Attention runs in latent space::

        score_h(t) = (W_UK_hᵀ q_nope_h) · c_kv[t] + q_rope_h · k_rope[t]

    Each row's new latent and rope key are written into the cache **in
    place** at its position clamped into [0, max_len - 1] (as
    ``dynamic_update_slice`` clamps), and each row attends to every cache
    position ``<=`` its own.  No position is read on the host.
    """
    b = x.shape[0]
    h = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    dt = cdtype(cfg)
    pos = replicated(_row_positions(pos, b, x.device), x)       # (B,)

    q_nope, q_rope = _queries(p, x, cfg, pos[:, None])          # (B,H,1,·)
    c_new, k_rope_new = _latents(p, x, cfg, pos[:, None])

    # written in place: the JAX package's constraints (after its write)
    # come first, a no-op on a cache the prefill placed
    c_kv = constrain(cache["c_kv"], "batch", "kv_seq", None)
    k_rope = constrain(cache["k_rope"], "batch", "kv_seq", None)
    dtype = c_kv.dtype
    t = c_kv.shape[1]
    at = pos.clamp(0, t - 1)
    write_at(c_kv, c_new[:, 0].to(dtype), at, 1)
    write_at(k_rope, k_rope_new[:, 0, 0].to(dtype), at, 1)

    # the absorbed attention runs one row at a time: every product and
    # reduction below has a shape that no batch size changes (the library
    # picks a batched product's kernel, and its order of sums, by the batch
    # count), so a row gets the bits it has alone
    wk_b = p["wk_b"].float().reshape(kvl, h, nope)
    wv_b = p["wv_b"].float().reshape(kvl, h, vd)
    scale = (nope + rope) ** -0.5
    keys = replicated(torch.arange(t, device=x.device), x)
    rows_o = []
    for i in range(b):
        # absorb W_UK into the query: q_lat (H, kvl), in f32
        q_lat = torch.einsum("hd,khd->hk", q_nope[i, :, 0].float(), wk_b)
        c_i = c_kv[i].float()                                   # (T, kvl)
        s_lat = torch.matmul(q_lat.to(dtype).float(), c_i.T)    # (H, T)
        s_rope = torch.matmul(q_rope[i, :, 0].to(dtype).float(),
                              k_rope[i].float().T)
        s = (s_lat + s_rope) * scale
        s = torch.where(keys <= pos[i], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        pexp = torch.exp(s - m)
        l = pexp.sum(-1, keepdim=True)
        o_lat = torch.matmul(pexp.to(dtype).float(), c_i) / l  # (H, kvl)
        # absorb W_UV into the output: (H, kvl) x (kvl, H, vd) -> (H, vd)
        rows_o.append(torch.einsum("hk,khd->hd", o_lat, wv_b))
    o = torch.stack(rows_o).reshape(b, 1, h * vd)
    y = torch.matmul(o.to(dt), p["wo"].to(dt))
    return y, dict(cache, c_kv=c_kv, k_rope=k_rope)
