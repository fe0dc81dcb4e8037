"""Dispatching wrapper for the delineation kernel + TinyCL registration.

``delineate(x, thr)`` launches ``csrc/delineate.cu`` (which replaces the TPU
kernel ``src/repro/kernels/delineate/delineate.py:_delineate_kernel``) on a
CUDA tensor and runs :func:`~repro_torch.kernels.delineate.ref.delineate_ref`
on CPU and ``meta`` tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, check_dtype, launch, on_card, ptr, stream_of
from .ref import counts as delineate_counts, delineate_ref, thresholds

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SYMBOL = {torch.float32: ("repro_delineate_f32", _F),
           torch.int16: ("repro_delineate_i16", _I),
           torch.int32: ("repro_delineate_i32", _I)}


def delineate(x: torch.Tensor, thr: float | int = 0) -> torch.Tensor:
    """Peak/trough flags (int8) of a 1-D float32, int16 or int32 signal."""
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"delineate takes a non-empty 1-D signal, got {tuple(x.shape)}")
    check_dtype("delineate signal", x, tuple(_SYMBOL))
    if not on_card(x):
        return delineate_ref(x, thr)
    check_contiguous("delineate", x)
    symbol, scalar = _SYMBOL[x.dtype]
    t, neg_t = thresholds(thr, x.dtype)
    flags = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    launch("delineate", symbol, [_P, _P, _I, scalar, scalar, _I, _P],
           ptr(x), ptr(flags), x.shape[0], t, neg_t, x.device.index,
           stream_of(x))
    return flags


@kernel_family("delineate")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="delineate",
        executor=delineate,
        counts=lambda n, itemsize=4: delineate_counts(n, itemsize),
    )
