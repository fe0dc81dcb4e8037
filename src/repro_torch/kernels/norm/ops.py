"""Dispatching wrappers for the norm kernel.

:func:`rms_norm`, :func:`layer_norm` and :func:`group_norm` launch
``csrc/norm.cu`` on CUDA tensors and run their plain versions
(:mod:`.ref`, each the code of the call site it serves) on CPU and ``meta``
tensors.  On the card a call is one launch of ``norm`` (``norm.py`` says
how it reads a row once, its sums in an order fixed by the group's width
and the dtype, and a view's rows in place); when an input
requires grad, the call goes through :class:`_Norm`, whose forward is the
same launch keeping each group's f32 mean and rstd, and whose backward is
PyTorch ops on the saved input and those statistics (the JAX package has no
norm kernel, so there is no TPU backward to port; a backward kernel is
later work).  Recomputing a forward (remat) launches the same kernel on the
same input and gives the same bits.  The family is not registered: the JAX
package registers no norm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...distributed.sharding import is_dtensor, on_blocks, remap, whole_on
from ..common import check_dtype, on_card
from .norm import DTYPES, launch_norm, row_stride
from .ref import group_norm_ref, layer_norm_ref, rms_norm_ref

__all__ = ["rms_norm", "layer_norm", "group_norm", "rms_norm_ref",
           "layer_norm_ref", "group_norm_ref"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in f32,
    cast back to x's dtype."""
    if is_dtensor(x, scale):
        return _on_blocks(rms_norm, x, (scale,), eps)
    if not on_card(x, scale):
        return rms_norm_ref(x, scale, eps)
    return _card(x, scale, None, x.shape[-1], eps, layer=False)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (population variance), in f32, then
    ``* scale + bias``, cast back to x's dtype."""
    if is_dtensor(x, scale, bias):
        return _on_blocks(layer_norm, x, (scale, bias), eps)
    if not on_card(x, scale, bias):
        return layer_norm_ref(x, scale, bias, eps)
    return _card(x, scale, bias, x.shape[-1], eps, layer=True)


def group_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], group: int, eps: float
               ) -> torch.Tensor:
    """LayerNorm of each ``group`` consecutive columns of the last axis
    (population variance), then the per-column ``scale`` and ``bias`` (or
    none), cast back to x's dtype."""
    d = x.shape[-1]
    if group <= 0 or d % group:
        raise ValueError(f"group_norm: a group of {group} does not divide "
                         f"the last axis of {d}")
    extra = () if bias is None else (bias,)
    if is_dtensor(x, scale, *extra):
        return _on_blocks(group_norm, x, (scale, bias), group, eps)
    if not on_card(x, scale, *extra):
        return group_norm_ref(x, scale, bias, group, eps)
    return _card(x, scale, bias, group, eps, layer=True)


def _on_blocks(fn, x, params, *rest):
    """``fn`` on each rank's rows: x whole along its last axis, sharded
    elsewhere as it comes; the parameters (None allowed) whole."""
    px = whole_on(x.placements, x.dim() - 1)
    pw = remap(px, {})
    args = (x,) + tuple(params) + rest
    return on_blocks(fn, args, (px,) + tuple(
        None if t is None else pw for t in params) + (None,) * len(rest), px)


def _card(x, scale, bias, group, eps, *, layer):
    check_dtype("norm x", x, DTYPES)
    d = x.shape[-1]
    for what, v in (("scale", scale), ("bias", bias)):
        if v is not None and tuple(v.shape) != (d,):
            raise ValueError(f"norm {what} {tuple(v.shape)} does not fit a "
                             f"last axis of {d}")
    scale = scale.float()
    bias = None if bias is None else bias.float()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias)):
        return _Norm.apply(x, scale, bias, group, eps, layer)
    return _forward(x, scale, bias, group, eps, layer, stats=False)[0]


def _forward(x, scale, bias, group, eps, layer, *, stats: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                        Optional[torch.Tensor]]:
    """(y, mean, rstd): one launch; the f32 (rows, d / group) statistics
    only with ``stats`` (mean only for LayerNorm).  x is read in place where
    its rows lie a fixed stride apart (deepseek's latent slice); y is
    contiguous."""
    stride = row_stride(x)
    if stride is None:
        x = x.contiguous()
        stride = x.shape[-1]
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = rstd = None
    if stats:
        shape = (rows, d // group)
        rstd = torch.empty(shape, dtype=torch.float32, device=x.device)
        if layer:
            mean = torch.empty(shape, dtype=torch.float32, device=x.device)
    if x.numel():
        launch_norm(x, y, scale.contiguous(),
                    None if bias is None else bias.contiguous(), mean, rstd,
                    group=group, eps=eps, layer=layer, stride=stride)
    return y, mean, rstd


class _Norm(torch.autograd.Function):
    """The card's differentiable norm: the kernel forward with each group's
    statistics kept; the backward from x, mean and rstd::

        xhat = (x - mean) * rstd,  g = dy * scale
        dx = rstd * (g - mean(g) - xhat * mean(g * xhat))   (LayerNorm)
        dx = rstd * (g - xhat * mean(g * xhat))             (RMS)
        dscale = sum over rows of dy * xhat,  dbias = sum over rows of dy
    """

    @staticmethod
    def forward(ctx, x, scale, bias, group, eps, layer):
        y, mean, rstd = _forward(x, scale, bias, group, eps, layer, stats=True)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.group, ctx.layer, ctx.has_bias = group, layer, bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        d, group = x.shape[-1], ctx.group
        shape = (-1, d // group, group)
        xf = x.float().reshape(shape)
        rs = rstd[..., None]
        xhat = (xf - mean[..., None]) * rs if ctx.layer else xf * rs
        dyf = dy.float().reshape(shape)
        g = dyf * scale.reshape(d // group, group)
        inner = (g * xhat).mean(-1, keepdim=True)
        if ctx.layer:
            dx = rs * (g - g.mean(-1, keepdim=True) - xhat * inner)
        else:
            dx = rs * (g - xhat * inner)
        dscale = dbias = None
        if ctx.needs_input_grad[1]:
            dscale = (dyf * xhat).sum(0).reshape(d)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            dbias = dyf.sum(0).reshape(d)
        if ctx.needs_input_grad[0]:
            dx = dx.reshape(x.shape).to(x.dtype)
        else:
            dx = None
        return dx, dscale, dbias, None, None, None
