"""The CUDA norm kernel (``csrc/norm.cu``) and its binding.

``csrc/norm.cu`` replaces no TPU kernel (the JAX package leaves its norms
to XLA).  It normalises each row of x, or each group of a row, in f32, with
every sum in one fixed order that no row count changes, so a decode step's
row keeps its bits in any batch; and it is one launch where the norm in
PyTorch ops is about eight.  Bytes bound it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import launch, ptr, stream_of

DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float,
         _I, _I, _P]
_SYMBOL = {torch.float32: "repro_norm_f32", torch.bfloat16: "repro_norm_bf16"}


def launch_norm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor], mean: Optional[torch.Tensor],
                rstd: Optional[torch.Tensor], *, group: int, eps: float,
                layer: bool) -> None:
    """Launch on contiguous CUDA tensors: x and y (..., d) of one dtype,
    f32 ``scale`` and ``bias`` (d,) (bias may be None), f32 ``mean`` and
    ``rstd`` (rows, d / group) or None, on the current stream.  Counts one
    launch of ``norm``."""
    d = x.shape[-1]
    rows = x.numel() // d
    launch("norm", _SYMBOL[x.dtype], _ARGS, ptr(x), ptr(y), ptr(scale),
           ptr(bias), ptr(mean), ptr(rstd), rows, d, group, float(eps),
           int(layer), x.device.index, stream_of(x))
