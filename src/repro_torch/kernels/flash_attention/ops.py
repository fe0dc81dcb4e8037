"""Dispatching wrapper for the flash-attention kernel.

``flash_attention(q, k, v)`` launches ``csrc/flash_attention.cu`` (which
replaces the TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel``) on
CUDA tensors and runs
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_plain` (the
JAX package's XLA path, what JAX runs off a TPU) on CPU and ``meta``
tensors.  The TPU kernel has no Tiny-OpenCL family, so none is registered.
"""

from __future__ import annotations

import torch

from ..common import check_dtype, on_card
from .flash_attention import (COMPILED_DV, DTYPES, MAX_DK, MMA_HEAD_DIMS,
                              launch_flash_attention, supports_head_dims,
                              tma_view)
from .ref import block_sizes, counts, flash_attention_plain, mha_ref, repeat_kv

__all__ = ["flash_attention", "counts", "mha_ref", "repeat_kv"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Fused attention, q (B,H,S,Dk) x k (B,KVH,T,Dk) x v (B,KVH,T,Dv) ->
    (B,H,S,Dv) in q's dtype; KVH divides H (grouped-query heads).

    ``q_offset`` is the absolute position of q's first row (causal masking
    keeps ``q_offset + i >= j``).  ``bq`` and ``bk`` are the plain version's
    blocks, clamped to S and T as the JAX wrapper clamps them; the kernel
    tiles by itself, but every device keeps the JAX wrapper's rule that
    non-causal attention needs ``min(bk, T)`` to divide T (``ValueError``),
    and a row that sees no key (``q_offset < 0``) gets what the plain
    version's blocking gives it.
    On the card q, k and v share a dtype (float32 or bfloat16), Dk is a
    multiple of 4 up to 256, Dv one of 32, 64, 96, 128, and each may be a
    strided view whose last axis is contiguous.  In bfloat16 at the head
    dims of ``MMA_HEAD_DIMS`` the kernel reads q, k and v through TMA tensor
    maps: a view that none describes (a base or a stride that is not a
    multiple of 16 bytes) is first copied contiguous, and the copy is
    counted in ``flash_attention.CONTIGUOUS_COPIES``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,H,S,Dk), k (B,KVH,T,Dk), "
                         "v (B,KVH,T,Dv)")
    b, h, s, dk = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != dk
            or kvh == 0 or h % kvh):
        raise ValueError(
            f"flash_attention shapes do not fit: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    scale = (dk ** -0.5) if scale is None else scale
    bq_, bk_ = block_sizes(s, t, bq, bk, causal)     # the JAX wrapper's rule
    if not on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, bq=bq, bk=bk)
    check_dtype("flash_attention q", q, DTYPES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention inputs must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    dv = v.shape[3]
    if not supports_head_dims(dk, dv):
        raise ValueError(
            f"the flash-attention kernel takes Dk a multiple of 4 up to "
            f"{MAX_DK} and Dv in {COMPILED_DV}; got Dk={dk}, Dv={dv}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes a contiguous "
                         "head-dim axis")
    if q.dtype == torch.bfloat16 and (dk, dv) in MMA_HEAD_DIMS:
        q, k, v = tma_view(q), tma_view(k), tma_view(v)
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    if out.numel():
        launch_flash_attention(q, k, v, out, causal=causal, scale=scale,
                               q_offset=q_offset, bq=bq_, bk=bk_)
    return out
