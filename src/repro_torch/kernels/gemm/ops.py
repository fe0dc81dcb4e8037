"""Dispatching wrapper for the GeMM kernel + TinyCL registration.

``gemm(a, b, knobs)`` launches ``csrc/gemm.cu`` (which replaces the TPU
kernel ``src/repro/kernels/gemm/gemm.py:_gemm_kernel``) on CUDA tensors and
runs :func:`~repro_torch.kernels.gemm.ref.gemm_plain` on CPU and ``meta``
tensors.  The kernel masks the ragged edges itself, so nothing is padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.device import EGPU_16T, EGPUConfig, KernelKnobs
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, check_dtype, on_card
from .gemm import launch_gemm, tiles_from_knobs
from .ref import FLOAT_DTYPES, INT_DTYPES
from .ref import counts as gemm_counts
from .ref import gemm_plain


def gemm(a: torch.Tensor, b: torch.Tensor,
         knobs: Optional[KernelKnobs] = None) -> torch.Tensor:
    """C = A @ B for a (m, k) and b (k, n) of one dtype.

    int8, int16 and int32 inputs give int32 (sums wrap modulo 2^32);
    float32, float16 and bfloat16 inputs give float32.  ``knobs`` (default:
    the 16T config's) choose the kernel's tiling; every tiling gives the
    same bits.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"gemm takes (m, k) @ (k, n), got {tuple(a.shape)} and "
            f"{tuple(b.shape)}")
    check_dtype("gemm input", a, INT_DTYPES + FLOAT_DTYPES)
    if b.dtype != a.dtype:
        raise TypeError(f"gemm inputs must share a dtype, got {a.dtype} and "
                        f"{b.dtype}")
    if not on_card(a, b):
        return gemm_plain(a, b)
    check_contiguous("gemm", a, b)
    tiling = tiles_from_knobs(knobs or EGPU_16T.cuda_knobs())
    # Widening int8/int16 to int32 and float16/bfloat16 to float32 is exact,
    # and is what the TPU kernel's preferred_element_type does.
    work = torch.float32 if a.dtype.is_floating_point else torch.int32
    a, b = a.to(work), b.to(work)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=work, device=a.device)
    if c.numel():
        launch_gemm(a, b, c, tiling)
    return c


@kernel_family("gemm")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    """TinyCL kernel object for queue dispatch, registered as "gemm": the
    config's knobs choose the kernel's tiling on the card."""
    knobs = config.cuda_knobs()
    tiles_from_knobs(knobs)                  # fail at build, not at launch
    return Kernel(
        name="gemm",
        executor=lambda a, b: gemm(a, b, knobs),
        counts=lambda m, n, k, itemsize=4: gemm_counts(m, n, k, itemsize),
    )
