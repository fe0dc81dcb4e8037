"""RWKV-6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The JAX package's ``models/rwkv.py`` in PyTorch, function for function.
Attention-free: per-head state is a (D x D) outer-product accumulator with
*data-dependent* per-channel decay w_t, computed by a low-rank (lora)
projection.  Decode state is O(1) in context — three tensors per layer:
last-token shifts for time/channel mix and the WKV state (B, H, D, D).
The WKV recurrence runs through :func:`~repro_torch.kernels.rwkv6_scan.ops.
rwkv6_scan` (the hand-written kernel on the card, for prefill and decode
alike).

Dtypes follow the JAX package: projections in the compute dtype
(``cdtype``), the decay, the bonus and the group norm in f32.  The model
keeps the leaves the JAX block widens to f32 (:data:`F32_LEAVES`) in f32,
and the interpolation coefficients ``mu_*``/``cmu_*`` in ``cfg.dtype``
(the JAX block casts them to the activations' dtype).  The block carries
its own channel-mix (mlp_pattern "none" in configs).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..distributed.sharding import constrain
from ..kernels.norm.ops import group_norm
from ..kernels.rwkv6_scan.ops import rwkv6_scan
from .config import ModelConfig
from .layers import cdtype, sigmoid, silu
from .params import ParamSpec, dense_spec, state_device

LORA_W = 64     # decay-lora rank (rwkv6 uses 64 for 3B)

#: leaves the JAX block reads with ``.astype(float32)``: w0 (``rwkv.py:100``),
#: u_bonus (``:118``) and ln_x (``:84``)
F32_LEAVES = frozenset({"w0", "u_bonus", "ln_x"})


def rwkv_spec(cfg: ModelConfig, stacked: int = 0) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim

    def p(shape, axes, init="normal", scale=0.02, constant=0.0):
        if stacked:
            shape = (stacked,) + shape
            axes = ("layers",) + axes
        return ParamSpec(shape, axes, init, scale, constant)

    return {
        # time-mix interpolation coefficients (per channel)
        "mu_r": p((d,), ("embed",), "constant", constant=0.5),
        "mu_k": p((d,), ("embed",), "constant", constant=0.5),
        "mu_v": p((d,), ("embed",), "constant", constant=0.5),
        "mu_w": p((d,), ("embed",), "constant", constant=0.5),
        "mu_g": p((d,), ("embed",), "constant", constant=0.5),
        "wr": dense_spec(d, d, ("embed", "heads"), stacked=stacked),
        "wk": dense_spec(d, d, ("embed", "heads"), stacked=stacked),
        "wv": dense_spec(d, d, ("embed", "heads"), stacked=stacked),
        "wg": dense_spec(d, d, ("embed", "heads"), stacked=stacked),
        "wo": dense_spec(d, d, ("heads", "embed"), stacked=stacked),
        # data-dependent decay: w = exp(-exp(w0 + lora))
        "w0": p((d,), ("embed",), "constant", constant=-1.0),
        "w_lora_a": dense_spec(d, LORA_W, ("embed", None), stacked=stacked),
        "w_lora_b": dense_spec(LORA_W, d, (None, "heads"), stacked=stacked),
        "u_bonus": p((h, hd), (None, None), "normal", 0.02),
        "ln_x": p((d,), ("embed",), "ones"),          # per-head groupnorm
        # channel-mix
        "cmu_r": p((d,), ("embed",), "constant", constant=0.5),
        "cmu_k": p((d,), ("embed",), "constant", constant=0.5),
        "cwr": dense_spec(d, d, ("embed", "mlp"), stacked=stacked),
        "cwk": dense_spec(d, ff, ("embed", "mlp"), stacked=stacked),
        "cwv": dense_spec(ff, d, ("mlp", "embed"), stacked=stacked),
    }


def _dot(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return torch.matmul(x.to(dt), w.to(dt))


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; position 0 gets ``last`` (or zeros)."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _heads(x: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, h, hd).transpose(1, 2)      # (B, H, T, D) view


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int, hd: int,
                eps: float) -> torch.Tensor:
    """Per-head LayerNorm of the WKV output (B, T, D), population variance:
    the norm kernel over groups of ``hd`` columns on the card."""
    return group_norm(x, scale, None, hd, eps)


def _mix_inputs(p, x: torch.Tensor, xx: torch.Tensor, cfg: ModelConfig):
    """Interpolated r/k/v/w/g inputs + projections (shared by scan/step)."""
    dt = cdtype(cfg)

    def mix(mu):
        return (x + xx * p[mu].to(x.dtype)).to(dt)

    r = _dot(mix("mu_r"), p["wr"], dt)
    k = _dot(mix("mu_k"), p["wk"], dt)
    v = _dot(mix("mu_v"), p["wv"], dt)
    g = silu(_dot(mix("mu_g"), p["wg"], dt))
    wl = torch.tanh(_dot(mix("mu_w"), p["w_lora_a"], dt))
    # the lora product in the compute dtype, widened to f32 after it
    w_log = p["w0"].float() + _dot(wl, p["w_lora_b"], dt).float()
    w = torch.exp(-torch.exp(w_log))                    # (…, D) in (0, 1)
    return r, k, v, w, g


def rwkv_time_mix(p, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Tuple | None = None, return_state: bool = False):
    """x (B, S, D) -> (B, S, D).  state = (last_x (B,D) or None, wkv
    (B,H,D,D) or None); None starts from zeros (the JAX prefill's zero
    state, the same function)."""
    b, s, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = cdtype(cfg)
    last_x, wkv0 = state if state is not None else (None, None)
    xx = _shift(x, last_x) - x
    r, k, v, w, g = _mix_inputs(p, x, xx, cfg)
    rh, kh, vh, wh = (_heads(z, h, hd) for z in (r, k, v, w))
    rh = constrain(rh, "batch", "heads", "seq", None)
    y, wkv = rwkv6_scan(rh, kh, vh, wh.float(), p["u_bonus"].float(),
                        state0=wkv0)
    y = y.transpose(1, 2).reshape(b, s, d)
    y = _group_norm(y, p["ln_x"], h, hd, cfg.norm_eps) * g
    out = _dot(y, p["wo"], dt)
    if return_state:
        return out, (x[:, -1].to(dt), wkv)
    return out


def rwkv_channel_mix(p, x: torch.Tensor, cfg: ModelConfig, *,
                     last_x: torch.Tensor | None = None,
                     return_state: bool = False):
    dt = cdtype(cfg)
    xx = _shift(x, last_x) - x
    xr = (x + xx * p["cmu_r"].to(x.dtype)).to(dt)
    xk = (x + xx * p["cmu_k"].to(x.dtype)).to(dt)
    r = sigmoid(_dot(xr, p["cwr"], dt))
    k = torch.square(torch.relu(_dot(xk, p["cwk"], dt)))
    y = r * _dot(k, p["cwv"], dt)
    if return_state:
        return y, x[:, -1].to(dt)
    return y


def rwkv_block(p, x: torch.Tensor, cfg: ModelConfig, *,
               state=None, return_state: bool = False):
    """Full pre-norm RWKV block body (norms applied by the caller stack).

    state = (tmix_last, wkv, cmix_last); both sub-mixes are residual.
    """
    if state is None:
        t_out = rwkv_time_mix(p, x, cfg)
        x = x + t_out
        x = x + rwkv_channel_mix(p, x, cfg)
        if return_state:
            raise ValueError("pass state to get return_state")
        return x
    tmix_last, wkv, cmix_last = state
    t_out, (t_last, wkv) = rwkv_time_mix(p, x, cfg, state=(tmix_last, wkv),
                                         return_state=True)
    x = x + t_out
    c_out, c_last = rwkv_channel_mix(p, x, cfg, last_x=cmix_last,
                                     return_state=True)
    x = x + c_out
    return x, (t_last, wkv, c_last)


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device=None):
    """Zero (tlast (B, D) dtype, wkv (B, H, hd, hd) f32, clast (B, D) dtype)
    on ``device`` (default: the card)."""
    d, h, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    device = state_device(device)
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((batch, d), dtype=dtype, device=device))


def rwkv_state_struct(cfg: ModelConfig, batch: int, dtype=torch.bfloat16):
    """The state's shapes and dtypes as storage-less ``meta`` tensors."""
    return init_rwkv_state(cfg, batch, dtype, device="meta")
