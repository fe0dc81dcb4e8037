"""Shared neural building blocks: norms, MLPs, rotary embedding, embeddings.

The JAX package's ``models/layers.py`` in PyTorch.  Functions take
``(p, x, cfg)`` where ``p`` is a mapping of tensors (a plain dict, or the
``nn.ParameterDict`` a :class:`~repro_torch.models.transformer.Transformer`
layer holds), so the same function runs a test's dict and the model.

Dtypes follow the JAX package: matmuls, the bias add, the MLP and the
logits product run in the config compute dtype (``cdtype``: bf16 at full
width, f32 in ``reduced()``); norms and softmax in f32.  The JAX package
casts its f32 weights to ``cdtype`` at every call; the serving model keeps
its matmul weights, biases and embedding in ``cdtype`` already (cast once
at load: the same bits), so the ``.to`` calls here are no-ops on its
weights, while a trainable model keeps the f32 masters and these casts run
inside the autograd graph, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed.sharding import (is_dtensor, on_blocks, remap, replicated,
                                    whole_on)
from ..kernels.norm.ops import layer_norm, rms_norm
from .config import ModelConfig
from .params import ParamSpec, dense_spec

#: logits of the vocabulary's padding columns (and the attention sentinel)
NEG_INF = -1e30


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def mul_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with ``c`` rounded to ``x``'s dtype first, as JAX treats a
    Python scalar (weak type); torch would multiply by the f32 value."""
    if c == 1.0:
        return x
    return x * torch.tensor(c, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_spec(cfg: ModelConfig, stacked: int = 0) -> Dict[str, ParamSpec]:
    shape = (stacked, cfg.d_model) if stacked else (cfg.d_model,)
    axes = ("layers", "embed") if stacked else ("embed",)
    out = {"scale": ParamSpec(shape, axes, "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamSpec(shape, axes, "zeros")
    return out


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's norm over the last axis, in f32, cast back to x's dtype:
    the norm kernel on the card, its plain version
    (:mod:`repro_torch.kernels.norm.ref`) on the CPU."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def rms_norm_1d(x: torch.Tensor, scale: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """RMS norm over the last axis with a bare scale vector (MLA's latent
    norms), in f32, cast back to ``x``'s dtype."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------
def matmul(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    return torch.matmul(x.to(dt), w.to(dt))


#: token rows of each product :func:`rows_matmul` runs
PRODUCT_ROWS = 256


def rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` as products of :data:`PRODUCT_ROWS` rows
    of x each, the last padded with zero rows.  The library picks a
    product's kernel, and with it the order of its sums, by the row count:
    at some shapes (on an H100 in bf16: MoE routers, jamba's ``x_proj``
    16384 -> 544 and kv projections 8192 -> 1024) a token's bits would
    depend on how many rows share its product; products of one shape give
    it the same bits in any batch.  DTensors run on each rank's rows (the
    weight whole there): cutting a sharded row axis into chunks would
    gather it first."""
    if is_dtensor(x, w):
        px = whole_on(x.placements, x.dim() - 1)
        return on_blocks(rows_matmul, (x, w), (px, remap(px, {})), px)
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    pad = -n % PRODUCT_ROWS
    if pad or n == 0:
        rows = torch.cat([rows, rows.new_zeros((pad or PRODUCT_ROWS,
                                                rows.shape[1]))])
    out = torch.cat([torch.matmul(chunk, w)
                     for chunk in rows.split(PRODUCT_ROWS)])
    return out[:n].reshape(*lead, w.shape[-1])


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as JAX lowers it, 1 / (1 + exp(-x)), each op
    rounded to x's dtype (``torch.sigmoid`` rounds once, and differs in
    bf16)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), each op rounded to x's dtype (the
    bits of the JAX package's bf16 activations; ``F.silu`` rounds once)."""
    return x * sigmoid(x)


def act_fn(cfg: ModelConfig):
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.act == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    return silu


def mlp_spec(cfg: ModelConfig, d_ff: int, stacked: int = 0):
    d = cfg.d_model
    out = {
        "wi": dense_spec(d, d_ff, ("embed", "mlp"), stacked=stacked),
        "wo": dense_spec(d_ff, d, ("mlp", "embed"), stacked=stacked),
    }
    if cfg.gated_mlp:
        out["wg"] = dense_spec(d, d_ff, ("embed", "mlp"), stacked=stacked)
    return out


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP wo( act(x wg) * (x wi) ), or the classic wo( act(x wi) )."""
    if cfg.gated_mlp:
        g = act_fn(cfg)(matmul(x, p["wg"], cfg))
        h = g * matmul(x, p["wi"], cfg)
    else:
        h = act_fn(cfg)(matmul(x, p["wi"], cfg))
    return matmul(h, p["wo"], cfg)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 rotary_pct: float = 1.0) -> torch.Tensor:
    """x (..., S, D); positions (S,) or (B, S).  Rotates the first
    ``rotary_pct * D`` channels (pairwise halves convention).  The angles,
    cos and sin are f32, so a bf16 ``x`` is rotated in f32 (bf16 x f32
    promotes to f32 in both frameworks) and cast back."""
    d = x.shape[-1]
    rd = int(d * rotary_pct)
    rd -= rd % 2
    if rd == 0:
        return x
    xr, xp = x[..., :rd], x[..., rd:]
    freqs = replicated(rope_frequencies(rd, theta, x.device),  # (rd/2,)
                       positions)
    ang = positions[..., None].float() * freqs                # (..., S, rd/2)
    cos, sin = (replicated(c, x) for c in (torch.cos(ang), torch.sin(ang)))
    while cos.dim() < xr.dim():                               # add head axis
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


def sinusoidal_positions(seq: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """Classic transformer sin/cos table (seq, d) f32 (the audio frontend's
    positional stub)."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: d // 2])
    return pe


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    out = {"embedding": ParamSpec((cfg.vocab_padded, cfg.d_model),
                                  ("vocab", "embed"), "normal",
                                  cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        out["lm_head"] = dense_spec(cfg.d_model, cfg.vocab_padded,
                                    ("embed", "vocab"))
    return out


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rows of the embedding for token ids, with the JAX gather's index
    rule: a negative id wraps once (``id + V``, V the embedding's rows),
    then the id is clamped to ``[0, V - 1]``."""
    emb = p["embedding"]
    n_rows = emb.shape[0]
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + n_rows, ids).clamp(0, n_rows - 1)
    table = emb.to(cdtype(cfg))
    if is_dtensor(table, ids):
        # each rank gathers its tokens' rows from the whole table
        pi = whole_on(ids.placements)
        x = on_blocks(lambda t, i: t[i], (table, ids),
                      (remap(pi, {}), pi), remap(pi, {0: 0, 1: 1}))
    else:
        x = table[ids]
    return mul_scalar(x, cfg.scale_emb)


def logits_from_hidden(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p.get("lm_head")
    if w is None:
        w = p["embedding"].T
    logits = matmul(h, w, cfg).float()
    if cfg.logit_scale_base:
        logits = logits / (cfg.d_model / cfg.logit_scale_base)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(replicated(pad, logits), NEG_INF)
    return logits


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's logsumexp minus its gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy, logsumexp minus the gold logit; logits f32
    (B, S, Vp), labels (B, S); with a mask, the masked mean over
    ``max(mask.sum(), 1)`` tokens."""
    if is_dtensor(logits, labels):
        # each rank's tokens, every logit of a token on its rank
        pl = whole_on(logits.placements, logits.dim() - 1)
        nll = on_blocks(_nll, (logits, labels), (pl, remap(pl, {0: 0, 1: 1})),
                        remap(pl, {0: 0, 1: 1}))
    else:
        nll = _nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def residual_scale(cfg: ModelConfig) -> float:
    """MiniCPM depth-scaled residuals: each block output is multiplied by
    scale_depth / sqrt(n_layers)."""
    if cfg.scale_depth:
        return cfg.scale_depth / math.sqrt(cfg.n_layers)
    return 1.0
