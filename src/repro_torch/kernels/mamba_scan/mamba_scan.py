"""The CUDA Mamba selective-scan kernel (``csrc/mamba_scan.cu``) and its
binding.

``csrc/mamba_scan.cu`` replaces the TPU kernel
``src/repro/kernels/mamba_scan/mamba_scan.py:_mamba_kernel``.  One thread
per (batch, channel) keeps its N-long f32 state in registers across T,
seeded from ``state0`` or from zeros; each block stages the b and c rows of
64 steps in shared memory; x and delta are read coalesced across channels.
The output leaves out the D * x skip term, as the TPU kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import launch, ptr, stream_of

#: state sizes the kernel is compiled for (the state lives in registers)
COMPILED_N = (2, 4, 8, 16, 32)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
#: (dtype of x, dtype of delta) -> entry point
_SYMBOL = {(torch.float32, torch.float32): "repro_mamba_scan_f32",
           (torch.bfloat16, torch.float32): "repro_mamba_scan_bf16",
           (torch.bfloat16, torch.bfloat16): "repro_mamba_scan_bf16d"}
DTYPES = tuple(_SYMBOL)


def launch_mamba_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor,
                      state0: Optional[torch.Tensor], y: torch.Tensor,
                      state: torch.Tensor) -> None:
    """Launch on contiguous CUDA tensors x/delta (B,T,Dm), f32 a (Dm,N),
    b/c (B,T,N) and ``state0`` (B,Dm,N) or None, into the contiguous ``y``
    (B,T,Dm) in x's dtype and f32 ``state`` (B,Dm,N), on the current
    stream."""
    bsz, t, dm = x.shape
    launch("mamba_scan", _SYMBOL[x.dtype, delta.dtype], _ARGS, ptr(x),
           ptr(delta), ptr(a), ptr(b), ptr(c), ptr(state0), ptr(y),
           ptr(state), bsz, t, dm, a.shape[1], x.device.index, stream_of(x))
