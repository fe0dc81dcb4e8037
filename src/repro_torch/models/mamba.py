"""Mamba (S6) block — the SSM half of Jamba's 1:7 attn:mamba interleave.

The JAX package's ``models/mamba.py`` in PyTorch, function for function.
Block structure (Mamba-1, as used by Jamba):

    x ->(in_proj) [xz | z] -> causal depthwise conv1d -> SiLU
      ->(x_proj) [dt_low | B | C] ; dt = softplus(dt_proj(dt_low) + bias)
      -> selective scan (kernels/mamba_scan) -> * SiLU(z) ->(out_proj) y

The prefill's scan runs through :func:`~repro_torch.kernels.mamba_scan.ops.
mamba_scan` (the hand-written kernel on the card, the plain chunked scan on
the CPU and ``meta``); a decode step runs the plain one-step recurrence
:func:`~repro_torch.kernels.mamba_scan.ref.mamba_step_ref`, as the JAX
decode does.  Decode keeps two states per layer: the conv window (B,
d_conv-1, d_inner) and the SSM state (B, d_inner, d_state) f32.

Dtypes follow the JAX package: projections and the conv in the compute
dtype (``cdtype``), the step sizes, A, B, C and the skip D in f32; the
model keeps ``a_log``, ``dt_bias`` and ``d_skip`` in f32
(:data:`F32_LEAVES`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..distributed.sharding import (constrain, is_dtensor, on_blocks, remap,
                                    whole_on)
from ..kernels.mamba_scan.ops import mamba_scan, mamba_step_ref
from .config import ModelConfig
from .layers import cdtype, matmul, rows_matmul, silu
from .params import ParamSpec, dense_spec, state_device

#: leaves the JAX block reads with ``.astype(float32)``: dt_bias
#: (``mamba.py:70``), a_log (``:88``) and d_skip (``:90``)
F32_LEAVES = frozenset({"dt_bias", "a_log", "d_skip"})


def mamba_spec(cfg: ModelConfig, stacked: int = 0) -> Dict[str, ParamSpec]:
    d, di = cfg.d_model, cfg.mamba_d_inner
    n, dc, dtr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.mamba_dt_rank

    def p(shape, axes, init="normal", scale=1.0):
        if stacked:
            shape = (stacked,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes, init, scale)

    return {
        "in_proj": dense_spec(d, 2 * di, ("embed", "mlp"), stacked=stacked),
        "conv_w": p((dc, di), (None, "mlp"), "normal", dc ** -0.5),
        "conv_b": p((di,), ("mlp",), "zeros"),
        "x_proj": dense_spec(di, dtr + 2 * n, ("mlp", None), stacked=stacked),
        "dt_proj": dense_spec(dtr, di, (None, "mlp"), stacked=stacked),
        "dt_bias": p((di,), ("mlp",), "constant"),     # softplus(0) ~ .69
        # A stored as -exp(a_log) < 0
        "a_log": p((di, n), ("mlp", None), "constant"),
        "d_skip": p((di,), ("mlp",), "ones"),
        "out_proj": dense_spec(di, d, ("mlp", "embed"), stacked=stacked),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, Di), w (K, Di) -> (B, T, Di), the K
    taps added one after another from a zero start, as the JAX block does.
    DTensors run on each rank's (batch, channel) blocks, whole along T (the
    padding has no DTensor strategy in every torch version)."""
    if is_dtensor(x, w, b):
        px = whole_on(x.placements, 1)
        pw = remap(px, {2: 1})
        return on_blocks(_conv1d_causal, (x, w, b),
                         (px, pw, remap(px, {2: 0})), px)
    k, t = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):                       # K = 4: unrolled
        out = out + xp[:, i:i + t] * w[i][None, None]
    return out + b[None, None]


def _ssm_inputs(p, x: torch.Tensor, cfg: ModelConfig):
    """Post-conv activations -> (delta, B, C) for the scan, all f32.  The
    narrow ``x_proj`` runs on fixed row chunks (:func:`~repro_torch.models.
    layers.rows_matmul`), so a token's bits do not depend on its batch."""
    n, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    dt = cdtype(cfg)
    proj = rows_matmul(x.to(dt), p["x_proj"].to(dt))
    dt_low, bmat, cmat = torch.split(proj, [dtr, n, n], dim=-1)
    delta = softplus(matmul(dt_low, p["dt_proj"], cfg).float()
                     + p["dt_bias"].float())
    return delta, bmat.float(), cmat.float()


def mamba_full(p, x: torch.Tensor, cfg: ModelConfig, *,
               return_state: bool = False):
    """x (B, S, D) -> (B, S, D)  [+ (conv_state (B, dc-1, Di) in the
    compute dtype, ssm_state (B, Di, N) f32) for the cache]."""
    s = x.shape[1]
    dc = cfg.mamba_d_conv
    dt = cdtype(cfg)
    xz = matmul(x, p["in_proj"], cfg)
    xs, z = xz.chunk(2, dim=-1)
    xs = constrain(xs, "batch", "seq", "mlp")
    xc = silu(_conv1d_causal(xs, p["conv_w"].to(dt), p["conv_b"].to(dt)))
    delta, bmat, cmat = _ssm_inputs(p, xc, cfg)
    a = -torch.exp(p["a_log"].float())
    y, h = mamba_scan(xc, delta, a, bmat, cmat, p["d_skip"].float())
    y = y.to(dt) * silu(z)
    out = matmul(y, p["out_proj"], cfg)
    if return_state:
        if s >= dc - 1:
            conv_state = xs[:, s - (dc - 1):]
        else:
            conv_state = torch.nn.functional.pad(xs, (0, 0, dc - 1 - s, 0))
        return out, (conv_state.to(dt).contiguous(), h)
    return out


def mamba_decode(p, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor],
                 cfg: ModelConfig):
    """x (B, 1, D), state (conv (B, dc-1, Di), ssm (B, Di, N)) -> (y, state').

    The window is the conv state and this token's input at their promoted
    dtype (JAX's ``concatenate``): a conv state kept in another dtype than
    the compute dtype comes back in the promoted one.  The K taps are summed
    in f32 one after another (the dot JAX's einsum lowers to, whose bits at
    f32 and bf16 products are the f32 sum's), so a row's bits never depend
    on the batch."""
    conv_state, ssm_state = state
    dt = cdtype(cfg)
    xz = matmul(x, p["in_proj"], cfg)
    xs, z = xz.chunk(2, dim=-1)                       # (B, 1, Di)
    wdt = torch.promote_types(conv_state.dtype, xs.dtype)
    window = torch.cat([conv_state.to(wdt), xs.to(wdt)], dim=1)  # (B, dc, Di)
    w = p["conv_w"].to(dt).float()
    acc = window[:, 0].float() * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i].float() * w[i]
    xc = silu(acc.to(wdt) + p["conv_b"].to(dt))       # (B, Di)
    delta, bmat, cmat = _ssm_inputs(p, xc[:, None], cfg)
    a = -torch.exp(p["a_log"].float())
    y, h = mamba_step_ref(xc, delta[:, 0], a, bmat[:, 0], cmat[:, 0],
                          p["d_skip"].float(), ssm_state)
    y = y[:, None].to(dt) * silu(z)
    out = matmul(y, p["out_proj"], cfg)
    return out, (window[:, 1:], h)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    """Zero (conv (B, dc-1, Di) dtype, ssm (B, Di, N) f32) on ``device``
    (default: the card)."""
    di, n, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    device = state_device(device)
    return (torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
            torch.zeros((batch, di, n), dtype=torch.float32, device=device))


def mamba_state_struct(cfg: ModelConfig, batch: int, dtype=torch.bfloat16):
    """The state's shapes and dtypes as storage-less ``meta`` tensors."""
    return init_mamba_state(cfg, batch, dtype, device="meta")
