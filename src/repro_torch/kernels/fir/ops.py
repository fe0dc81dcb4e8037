"""Dispatching wrapper for the FIR kernel + TinyCL registration.

``fir(x, h)`` launches ``csrc/fir.cu`` (which replaces the TPU kernel
``src/repro/kernels/fir/fir.py:_fir_kernel``) on CUDA tensors, once, for any
number of taps and for a signal or a (batch, n) stack of them, and runs
:func:`~repro_torch.kernels.fir.ref.fir_ref` on CPU and ``meta`` tensors.
The card path is the custom op ``repro_torch::fir``, whose vmap rule folds
a vmapped batch into the kernel's batch axis: one launch per call.
"""

from __future__ import annotations

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import (card_op, check_contiguous, check_dtype, fold_batch,
                      on_card, unbatched_rest)
from .fir import launch_fir
from .ref import counts as fir_counts, fir_ref


def fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR filter of a 1-D signal, or of each row of a (batch, n)
    stack of signals (each row has the bits of its signal filtered alone).

    ``x`` float32 with ``h`` float32 gives a float32 output; ``x`` int16 or
    int32 with integer Q15 coefficients ``h`` gives an output of ``x``'s
    dtype (int32 accumulation, ``>> 15``).
    """
    if x.dim() not in (1, 2) or h.dim() != 1 or h.shape[0] < 1:
        raise ValueError(
            f"fir takes a 1-D signal (or a 2-D batch of them) and 1-D taps, "
            f"got {tuple(x.shape)} and {tuple(h.shape)}")
    check_dtype("fir signal", x, (torch.float32, torch.int16, torch.int32))
    if x.dtype == torch.float32:
        check_dtype("fir taps for a float signal", h, (torch.float32,))
    else:
        check_dtype("fir taps for an integer signal", h,
                    (torch.int16, torch.int32))
    if not on_card(x, h):
        return fir_ref(x, h)
    return fir_card(x, h)


@card_op("fir")
def fir_card(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The card path of :func:`fir`: one launch over ``x`` (n,) or
    (batch, n)."""
    check_contiguous("fir", x, h)
    y = torch.empty_like(x)
    if x.numel():
        launch_fir(x, h, y)
    return y


@fir_card.register_fake
def _fir_fake(x, h):
    return torch.empty_like(x)


@fir_card.register_vmap
def _fir_vmap(info, in_dims, x, h):
    unbatched_rest("fir", in_dims)
    rows, lead = fold_batch(x, in_dims[0], 1)
    return fir_card(rows, h).reshape(lead + rows.shape[1:]), 0


@kernel_family("fir")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="fir",
        executor=fir,
        counts=lambda n, taps, itemsize=4: fir_counts(n, taps, itemsize),
    )
