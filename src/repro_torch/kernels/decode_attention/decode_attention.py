"""The CUDA decode-attention kernel (``csrc/decode_attention.cu``) and its
binding.

``csrc/decode_attention.cu`` replaces the TPU kernel
``src/repro/kernels/decode_attention/decode_attention.py:_decode_kernel``.
One block per (batch, kv head) runs the whole T loop: 8 warps split T into
tiles of 32 keys, keep (acc, m, l) in f32 for the group's heads and merge in
a fixed order; the tail of T is masked, so nothing is padded.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..common import launch, ptr, stream_of

#: Dk and Dv: any size up to this
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float,
         _I, _I, _P]
_SYMBOL = {torch.float32: "repro_decode_attention_f32",
           torch.bfloat16: "repro_decode_attention_bf16"}


def launch_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, m: Optional[torch.Tensor],
                            l: Optional[torch.Tensor], *, scale: float,
                            partial: bool) -> None:
    """Launch on CUDA tensors of one dtype, q (B,H,Dk), k (B,KVH,T,Dk), v
    (B,KVH,T,Dv), each with a contiguous last axis, into the contiguous
    ``out`` (B,H,Dv) (q's dtype, or f32 when ``partial``) and f32 ``m``,
    ``l`` (B,H,1) or None, on the current stream."""
    b, h, dk = q.shape
    kvh, t, dv = k.shape[1], k.shape[2], v.shape[3]
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *k.stride()[:3],
                                      *v.stride()[:3])
    launch("decode_attention", _SYMBOL[q.dtype], _ARGS, ptr(q), ptr(k), ptr(v),
           ptr(out), ptr(m), ptr(l), b, h, kvh, t, dk, dv,
           ctypes.cast(strides, _P), float(scale), int(partial),
           q.device.index, stream_of(q))
