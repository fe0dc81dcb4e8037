"""Plain PyTorch versions of the models' norms: the norm kernel's plain
versions, run by :mod:`.ops` on CPU and ``meta`` tensors.

Each is the code of its call site as the model ran it before the kernel
existed, kept as it was, so the CPU path's bits (and with them the CPU
tokens held against the JAX package) do not change:

* :func:`rms_norm_ref` — ``layers.apply_norm`` with ``norm == "rms"`` and
  ``layers.rms_norm_1d`` (MLA's ``q_norm`` / ``kv_norm``), one expression;
* :func:`layer_norm_ref` — ``layers.apply_norm`` with ``norm ==
  "layernorm"``: the variance as the mean of the squared deviations;
* :func:`group_norm_ref` — rwkv's per-head ``_group_norm`` (groups of the
  head dim, no bias) and the audio frontend's LayerNorm (one group, with a
  bias): the variance from ``torch.var`` (population).

Every one computes in f32 and casts back to ``x``'s dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    y = y * scale.float()
    return y.to(x.dtype)


def layer_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def group_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor], group: int, eps: float
                   ) -> torch.Tensor:
    """LayerNorm of each ``group`` consecutive columns of the last axis
    (``group`` dividing it), population variance, then the per-column
    ``scale`` (and ``bias``)."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    xh = (x.float() if group == d
          else x.reshape(*lead, d // group, group).float())
    mu = xh.mean(-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, unbiased=False)
    xn = (xh - mu) * torch.rsqrt(var + eps)
    y = xn.reshape(*lead, d) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
