"""Dispatching wrapper for the delineation kernel + TinyCL registration.

``delineate(x, thr)`` launches ``csrc/delineate.cu`` (which replaces the TPU
kernel ``src/repro/kernels/delineate/delineate.py:_delineate_kernel``) on a
CUDA tensor, once for a signal or a (batch, n) stack of them, and runs
:func:`~repro_torch.kernels.delineate.ref.delineate_ref` on CPU and
``meta`` tensors.  The card path is the custom op
``repro_torch::delineate``, whose vmap rule folds a vmapped batch into the
kernel's batch axis.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import (card_op, check_contiguous, check_dtype, fold_batch,
                      launch, on_card, ptr, stream_of, unbatched_rest)
from .ref import counts as delineate_counts, delineate_ref, thresholds

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SYMBOL = {torch.float32: ("repro_delineate_f32", _F),
           torch.int16: ("repro_delineate_i16", _I),
           torch.int32: ("repro_delineate_i32", _I)}
#: the most signals a launch takes (the grid's second axis)
MAX_BATCH = 65535


def delineate(x: torch.Tensor, thr: float | int = 0) -> torch.Tensor:
    """Peak/trough flags (int8) of a 1-D float32, int16 or int32 signal, or
    of each row of a (batch, n) stack of them (each row with its own
    endpoints: the bits of its signal delineated alone)."""
    if x.dim() not in (1, 2) or x.shape[-1] < 1:
        raise ValueError(
            f"delineate takes a non-empty 1-D signal (or a 2-D batch of them), "
            f"got {tuple(x.shape)}")
    check_dtype("delineate signal", x, tuple(_SYMBOL))
    if not on_card(x):
        return delineate_ref(x, thr)
    return delineate_card(x, thr)


@card_op("delineate")
def delineate_card(x: torch.Tensor, thr: torch.types.Number) -> torch.Tensor:
    """The card path of :func:`delineate`: one launch over ``x`` (n,) or
    (batch, n)."""
    check_contiguous("delineate", x)
    n = x.shape[-1]
    batch = x.shape[0] if x.dim() == 2 else 1
    if batch > MAX_BATCH:
        raise ValueError(
            f"delineate launches at most {MAX_BATCH} signals, got {batch}")
    symbol, scalar = _SYMBOL[x.dtype]
    t, neg_t = thresholds(thr, x.dtype)
    flags = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if batch:
        launch("delineate", symbol, [_P, _P, _I, scalar, scalar, _I, _I, _P],
               ptr(x), ptr(flags), n, t, neg_t, batch, x.device.index,
               stream_of(x))
    return flags


@delineate_card.register_fake
def _delineate_fake(x, thr):
    return torch.empty(x.shape, dtype=torch.int8, device=x.device)


@delineate_card.register_vmap
def _delineate_vmap(info, in_dims, x, thr):
    unbatched_rest("delineate", in_dims)
    rows, lead = fold_batch(x, in_dims[0], 1)
    return delineate_card(rows, thr).reshape(lead + rows.shape[1:]), 0


@kernel_family("delineate")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="delineate",
        executor=delineate,
        counts=lambda n, itemsize=4: delineate_counts(n, itemsize),
    )
