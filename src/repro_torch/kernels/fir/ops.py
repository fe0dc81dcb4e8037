"""Dispatching wrapper for the FIR kernel + TinyCL registration.

``fir(x, h)`` launches ``csrc/fir.cu`` (which replaces the TPU kernel
``src/repro/kernels/fir/fir.py:_fir_kernel``) on CUDA tensors, once, for any
number of taps, and runs :func:`~repro_torch.kernels.fir.ref.fir_ref` on
CPU and ``meta`` tensors.
"""

from __future__ import annotations

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, check_dtype, on_card
from .fir import launch_fir
from .ref import counts as fir_counts, fir_ref


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
    y = torch.empty_like(x)
    if x.shape[0]:
        launch_fir(x, h, y)
    return y


@kernel_family("fir")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="fir",
        executor=fir,
        counts=lambda n, taps, itemsize=4: fir_counts(n, taps, itemsize),
    )
