"""Dispatching wrapper for the Stockham FFT kernel + TinyCL registration.

``fft(re, im)`` and ``power_spectrum(x)`` launch ``csrc/stockham_fft.cu``
(which replaces the TPU kernel
``src/repro/kernels/stockham_fft/stockham_fft.py:_fft_kernel``) once on
CUDA tensors and run
:func:`~repro_torch.kernels.stockham_fft.ref.stockham_fft_ref` on CPU and
``meta`` tensors.  Every axis before the last is a batch of signals: the
kernel transforms rows, so any stack is one launch.  The card paths are
the custom ops ``repro_torch::fft`` and ``repro_torch::power_spectrum``,
whose vmap rules fold a vmapped batch into the rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import (card_op, check_contiguous, check_dtype, fold_batch,
                      launch, on_card, ptr, stream_of, unbatched_rest)
from .ref import counts as fft_counts, stockham_fft_ref

#: four fp32 planes of n and n - 1 twiddles live in one block's shared
#: memory (24 n bytes, 192 KB at 8192)
MAX_N = 8192

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P]


def _check(re: torch.Tensor, im: Optional[torch.Tensor]) -> None:
    """The checks every path makes on (..., n) planes."""
    if re.dim() < 1:
        raise ValueError("fft takes (n,) or (..., n) planes, got a 0-d tensor")
    n = re.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    check_dtype("fft real plane", re, (torch.float32,))
    if im is not None:
        check_dtype("fft imaginary plane", im, (torch.float32,))
        if im.shape != re.shape:
            raise ValueError(
                f"fft planes differ in shape: {tuple(re.shape)} vs "
                f"{tuple(im.shape)}")


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


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
    """FFT of a float32 signal along the last axis (leading axes: a batch
    of signals); returns (re, im).  ``im=None`` means a real input."""
    _check(re, im)
    if not on_card(*((re,) if im is None else (re, im))):
        ore, oim = stockham_fft_ref(
            _as_rows(re), _as_rows(torch.zeros_like(re) if im is None else im))
        return ore.reshape(re.shape), oim.reshape(re.shape)
    return fft_card(re, im)


@card_op("fft")
def fft_card(re: torch.Tensor, im: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The card path of :func:`fft`: one launch over all rows."""
    rows = _as_rows(re)
    ore, oim = torch.empty_like(rows), torch.empty_like(rows)
    _launch(rows, None if im is None else _as_rows(im), ore, oim, None)
    return ore.reshape(re.shape), oim.reshape(re.shape)


@fft_card.register_fake
def _fft_fake(re, im):
    return torch.empty_like(re), torch.empty_like(re)


@fft_card.register_vmap
def _fft_vmap(info, in_dims, re, im):
    def batched(t, bdim):               # the batch axis first, broadcast
        return (t.movedim(bdim, 0) if bdim is not None
                else t.expand((info.batch_size,) + tuple(t.shape)))
    re_rows, lead = fold_batch(batched(re, in_dims[0]), None, 1)
    im_rows = None if im is None else fold_batch(batched(im, in_dims[1]), None, 1)[0]
    ore, oim = fft_card(re_rows, im_rows)
    shape = lead + re_rows.shape[1:]
    return (ore.reshape(shape), oim.reshape(shape)), (0, 0)


def power_spectrum(x: torch.Tensor) -> torch.Tensor:
    """|FFT|^2 of each signal (last axis; leading axes are a batch of
    signals) — the frequency-domain features of the TinyBio pipeline.  On
    the card any stack is one launch, whose last pass writes
    ``re*re + im*im`` (each product and the sum rounded on its own: the
    bits of those three operations on :func:`fft`'s output); elsewhere it
    is those operations over the plain version."""
    x = x.to(torch.float32)
    _check(x, None)
    if not on_card(x):
        re, im = fft(x)
        return re * re + im * im
    return power_spectrum_card(x)


@card_op("power_spectrum")
def power_spectrum_card(x: torch.Tensor) -> torch.Tensor:
    """The card path of :func:`power_spectrum`: one launch over all rows."""
    rows = _as_rows(x)
    out = torch.empty_like(rows)
    _launch(rows, None, None, None, out)
    return out.reshape(x.shape)


@power_spectrum_card.register_fake
def _power_spectrum_fake(x):
    return torch.empty_like(x)


@power_spectrum_card.register_vmap
def _power_spectrum_vmap(info, in_dims, x):
    unbatched_rest("power_spectrum", in_dims)
    rows, lead = fold_batch(x, in_dims[0], 1)
    return power_spectrum_card(rows).reshape(lead + rows.shape[1:]), 0


@kernel_family("stockham_fft")
def build_kernel(config: EGPUConfig = EGPU_16T) -> Kernel:
    return Kernel(
        name="stockham_fft",
        executor=fft,
        counts=lambda n, itemsize=4: fft_counts(n, itemsize),
    )
