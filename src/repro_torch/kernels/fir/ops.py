"""Dispatching wrapper for the FIR kernel + TinyCL registration.

``fir(x, h)`` launches ``csrc/fir.cu`` (which replaces the TPU kernel
``src/repro/kernels/fir/fir.py:_fir_kernel``) on CUDA tensors and runs
:func:`~repro_torch.kernels.fir.ref.fir_ref` on CPU and ``meta`` tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, check_dtype, launch, on_card, ptr, stream_of
from .ref import FXP_SHIFT, counts as fir_counts, fir_ref

#: the kernel keeps the taps and a (256 + taps - 1)-sample window in 48 KB
#: of shared memory
MAX_TAPS = 4096

_P, _I = ctypes.c_void_p, ctypes.c_int
_FLOAT_ARGS = [_P, _P, _P, _I, _I, _I, _P]
_FIXED_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P]
_FIXED_SYMBOL = {torch.int16: "repro_fir_i16", torch.int32: "repro_fir_i32"}


def fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR filter of a 1-D signal.

    ``x`` float32 with ``h`` float32 gives a float32 output; ``x`` int16 or
    int32 with integer Q15 coefficients ``h`` gives an output of ``x``'s
    dtype (int32 accumulation, ``>> 15``).
    """
    if x.dim() != 1 or h.dim() != 1 or h.shape[0] < 1:
        raise ValueError(
            f"fir takes a 1-D signal and 1-D taps, got {tuple(x.shape)} and "
            f"{tuple(h.shape)}")
    check_dtype("fir signal", x, (torch.float32, torch.int16, torch.int32))
    if x.dtype == torch.float32:
        check_dtype("fir taps for a float signal", h, (torch.float32,))
    else:
        check_dtype("fir taps for an integer signal", h,
                    (torch.int16, torch.int32))
    if not on_card(x, h):
        return fir_ref(x, h)
    check_contiguous("fir", x, h)
    n, taps = x.shape[0], h.shape[0]
    if taps > MAX_TAPS:
        raise ValueError(f"fir kernel takes at most {MAX_TAPS} taps, got {taps}")
    y = torch.empty_like(x)
    dev = x.device.index
    if x.dtype == torch.float32:
        launch("fir", "repro_fir_f32", _FLOAT_ARGS, ptr(x), ptr(h), ptr(y),
               n, taps, dev, stream_of(x))
    else:
        h32 = h if h.dtype == torch.int32 else h.to(torch.int32)
        launch("fir", _FIXED_SYMBOL[x.dtype], _FIXED_ARGS, ptr(x), ptr(h32),
               ptr(y), n, taps, FXP_SHIFT, dev, stream_of(x))
    return y


@kernel_family("fir")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="fir",
        executor=fir,
        counts=lambda n, taps, itemsize=4: fir_counts(n, taps, itemsize),
    )
