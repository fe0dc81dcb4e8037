"""Dispatching wrapper for the Stockham FFT kernel + TinyCL registration.

``fft(re, im)`` and ``power_spectrum(x)`` launch ``csrc/stockham_fft.cu``
(which replaces the TPU kernel
``src/repro/kernels/stockham_fft/stockham_fft.py:_fft_kernel``) once on
CUDA tensors and run
:func:`~repro_torch.kernels.stockham_fft.ref.stockham_fft_ref` on CPU and
``meta`` tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_contiguous, check_dtype, launch, on_card, ptr, stream_of
from .ref import counts as fft_counts, stockham_fft_ref

#: four fp32 planes of n and n - 1 twiddles live in one block's shared
#: memory (24 n bytes, 192 KB at 8192)
MAX_N = 8192

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P]


def _rows(re: torch.Tensor, im: Optional[torch.Tensor]):
    """(re, im) as (batch, n) and whether the caller gave 1-D planes, after
    the checks every path makes."""
    squeeze = re.dim() == 1
    if squeeze:
        re = re[None, :]
        im = None if im is None else im[None, :]
    if re.dim() != 2:
        raise ValueError(f"fft takes (n,) or (batch, n), got {tuple(re.shape)}")
    n = re.shape[1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    check_dtype("fft real plane", re, (torch.float32,))
    if im is not None:
        check_dtype("fft imaginary plane", im, (torch.float32,))
        if im.shape != re.shape:
            raise ValueError(
                f"fft planes differ in shape: {tuple(re.shape)} vs "
                f"{tuple(im.shape)}")
    return re, im, squeeze


def _launch(re: torch.Tensor, im: Optional[torch.Tensor],
            re_out: Optional[torch.Tensor], im_out: Optional[torch.Tensor],
            power: Optional[torch.Tensor]) -> None:
    """One launch over contiguous CUDA (batch, n) planes; each output that
    is None is not written."""
    check_contiguous("fft", *((re,) if im is None else (re, im)))
    batch, n = re.shape
    if n > MAX_N:
        raise ValueError(f"fft kernel takes n <= {MAX_N}, got {n}")
    launch("stockham_fft", "repro_stockham_fft_f32", _ARGS, ptr(re), ptr(im),
           ptr(re_out), ptr(im_out), ptr(power), batch, n, re.device.index,
           stream_of(re))


def fft(re: torch.Tensor, im: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFT of a 1-D (or batched 2-D, one signal per row) float32 signal;
    returns (re, im).  ``im=None`` means a real input."""
    re, im, squeeze = _rows(re, im)
    if not on_card(*((re,) if im is None else (re, im))):
        ore, oim = stockham_fft_ref(
            re, torch.zeros_like(re) if im is None else im)
    else:
        ore, oim = torch.empty_like(re), torch.empty_like(re)
        _launch(re, im, ore, oim, None)
    return (ore[0], oim[0]) if squeeze else (ore, oim)


def power_spectrum(x: torch.Tensor) -> torch.Tensor:
    """|FFT|^2 of each signal (last axis) — the frequency-domain features of
    the TinyBio pipeline.  On the card a (batch, n) input is one launch,
    whose last pass writes ``re*re + im*im`` (each product and the sum
    rounded on its own: the bits of those three operations on
    :func:`fft`'s output); elsewhere it is those operations over the plain
    version."""
    x = x.to(torch.float32)
    if not on_card(x):
        re, im = fft(x)
        return re * re + im * im
    rows, _, squeeze = _rows(x, None)
    out = torch.empty_like(rows)
    _launch(rows, None, None, None, out)
    return out[0] if squeeze else out


@kernel_family("stockham_fft")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="stockham_fft",
        executor=fft,
        counts=lambda n, itemsize=4: fft_counts(n, itemsize),
    )
