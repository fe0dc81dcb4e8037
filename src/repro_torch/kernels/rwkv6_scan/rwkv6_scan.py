"""The CUDA RWKV-6 WKV kernel (``csrc/rwkv6_scan.cu``) and its binding.

``csrc/rwkv6_scan.cu`` replaces the TPU kernel
``src/repro/kernels/rwkv6_scan/rwkv6_scan.py:_rwkv6_kernel``.  On the H100
a chunk of the scan is a chain of dependent phases, so latency bounds it
before the FFMA rate does; the design keeps the card full and the chain
short.  Its grid has one block per (batch, head, slab of 32 state
columns): a column of the state evolves on its own.  It takes the TPU
kernel's chunked form, 32 steps a chunk, with every decay a running product
of w (no factor above 1).  The slab blocks of a head form a thread-block
cluster, each staging its 32 channels with 16-byte ``cp.async`` copies a
chunk ahead and sharing their decays and share of the chunk's A matrix
through distributed shared memory; the products that carry the state run
on the tensor cores in three TF32 parts (f32 accuracy).  A one-step call (a
decode step) takes a small kernel whose whole grid is resident at once.
The f32 state is seeded from ``state0`` or from zeros; any T works
unpadded.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import launch, ptr, stream_of

#: head dims the kernel is compiled for (clusters of D / 32 blocks)
COMPILED_D = (32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P]
#: (dtype of r, k and v; dtype of w) -> entry point
_SYMBOL = {(torch.float32, torch.float32): "repro_rwkv6_scan_f32",
           (torch.bfloat16, torch.float32): "repro_rwkv6_scan_bf16",
           (torch.bfloat16, torch.bfloat16): "repro_rwkv6_scan_bf16w"}
DTYPES = tuple(_SYMBOL)


def launch_rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor,
                      state0: Optional[torch.Tensor], y: torch.Tensor,
                      state: torch.Tensor) -> None:
    """Launch on CUDA tensors r/k/v/w (B,H,T,D) with a contiguous last axis,
    the contiguous f32 ``u`` (H,D) and ``state0`` (B,H,D,D) or None, into
    the contiguous ``y`` (B,H,T,D) and f32 ``state`` (B,H,D,D), on the
    current stream."""
    b, h, t, d = r.shape
    strides = (ctypes.c_longlong * 12)(*r.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *w.stride()[:3])
    launch("rwkv6_scan", _SYMBOL[r.dtype, w.dtype], _ARGS, ptr(r), ptr(k),
           ptr(v), ptr(w), ptr(u), ptr(state0), ptr(y), ptr(state), b, h, t,
           d, ctypes.cast(strides, _P), r.device.index, stream_of(r))
