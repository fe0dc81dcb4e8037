"""Dispatching wrappers for the flash-attention kernels.

``flash_attention(q, k, v)`` launches ``csrc/flash_attention.cu`` (which
replaces the TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py:_flash_kernel``) on
CUDA tensors and runs
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_plain` (the
JAX package's XLA path, what JAX runs off a TPU) on CPU and ``meta``
tensors.  It is differentiable on both: on the card, when an input requires
grad, through :class:`_FlashAttention`, whose forward launches the same
kernel and keeps each row's log-sum-exp and whose backward launches
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`), at any
``q_offset >= 0`` (a context-parallel shard's rows); on the CPU autograd
runs through the plain version.  Given DTensors, it runs on each rank's
(batch, head) blocks through
:func:`~repro_torch.distributed.sharding.on_blocks`.  The TPU kernel has no
Tiny-OpenCL family, so none is registered.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...distributed.sharding import (block_of, is_dtensor, on_blocks, remap,
                                     whole_on)
from ..common import check_dtype, on_card
from .flash_attention import (BWD_PAIRS, COMPILED_DV, DTYPES, MAX_DK,
                              MMA_HEAD_DIMS, bwd_route, launch_flash_attention,
                              launch_flash_attention_bwd, supports_head_dims,
                              tma_view)
from .ref import (block_sizes, counts, flash_attention_bwd_plain,
                  flash_attention_plain, mha_ref, repeat_kv)

__all__ = ["flash_attention", "flash_attention_bwd", "counts", "mha_ref",
           "repeat_kv"]


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
    multiple of 4 up to 256, Dv one of 32, 64, 80, 96, 128, 256, and each
    may be a strided view whose last axis is contiguous.  In bfloat16 at the
    head dims of ``MMA_HEAD_DIMS`` the kernel reads q, k and v through TMA
    tensor maps: a view that none describes (a base or a stride that is not
    a multiple of 16 bytes) is first copied contiguous, and the copy is
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
    if is_dtensor(q, k, v):
        return _on_blocks(q, k, v, causal=causal, scale=scale,
                          q_offset=q_offset, bq=bq, bk=bk)
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        check_backward(dk, dv, q_offset)
        return _FlashAttention.apply(q, k, v, causal, scale, q_offset, bq_,
                                     bk_)
    return _card_forward(q, k, v, causal, scale, q_offset, bq_, bk_)[0]


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, h0: int, hn: int,
                 group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kv heads that q heads ``[h0, h0 + hn)`` of a GQA call read, as
    k and v of a call over those q heads alone: a slice of whole kv heads
    where the q heads are whole groups, or all in one group; else each q
    head's kv head repeated (``repeat_kv``)."""
    if h0 % group == 0 and hn % group == 0:
        return k[:, h0 // group:(h0 + hn) // group], v[
            :, h0 // group:(h0 + hn) // group]
    if h0 // group == (h0 + hn - 1) // group:
        j = h0 // group
        return k[:, j:j + 1], v[:, j:j + 1]
    return (repeat_kv(k, group)[:, h0:h0 + hn],
            repeat_kv(v, group)[:, h0:h0 + hn])


def _on_blocks(q, k, v, **kw):
    """:func:`flash_attention` of DTensors on each rank's blocks: q whole
    along S and Dk, its batch and heads sharded as they come (the model's
    ``constrain`` set them); k and v sharded alike on batch and, where
    their heads divide as q's do, on heads; else whole on heads, and each
    rank takes the kv heads of its q heads (:func:`kv_for_heads`)."""
    h, kvh = q.shape[1], k.shape[1]
    pq = whole_on(q.placements, 2, 3)
    idx, parts = block_of(q.device_mesh, pq, 1)
    split_kv = kvh % parts == 0
    pk = remap(pq, {0: 0, 1: 1} if split_kv else {0: 0})

    def body(ql, kl, vl):
        if not split_kv:
            kl, vl = kv_for_heads(kl, vl, idx * ql.shape[1], ql.shape[1],
                                  h // kvh)
        return flash_attention(ql, kl, vl, **kw)

    return on_blocks(body, (q, k, v), (pq, pk, pk), pq)


def check_backward(dk: int, dv: int, q_offset: int) -> None:
    """Raise ``ValueError`` for a call whose gradient the backward kernel
    does not compute (no plain fallback on the card): a (Dk, Dv) pair
    outside :data:`BWD_PAIRS`, or a negative ``q_offset`` (rows that see
    no key, whose forward is the plain version's mean of v)."""
    if (dk, dv) not in BWD_PAIRS or q_offset < 0:
        raise ValueError(
            f"the flash-attention backward kernel takes (Dk, Dv) in "
            f"{BWD_PAIRS} and q_offset >= 0; got Dk={dk}, Dv={dv}, "
            f"q_offset={q_offset} (ROADMAP.md queue 2 item 6 lists the "
            f"pairs the kernels are compiled for)")


def _card_forward(q, k, v, causal, scale, q_offset, bq, bk, with_lse=False):
    """(out, lse or None): one launch of the forward kernel; bf16 views no
    tensor map describes are copied first (:func:`tma_view`)."""
    b, h, s, dk = q.shape
    dv = v.shape[3]
    if q.dtype == torch.bfloat16 and (dk, dv) in MMA_HEAD_DIMS:
        q, k, v = tma_view(q), tma_view(k), tma_view(v)
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        launch_flash_attention(q, k, v, out, causal=causal, scale=scale,
                               q_offset=q_offset, bq=bq, bk=bk, lse=lse)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The card's differentiable call (any ``q_offset >= 0``): the forward
    kernel with each row's log-sum-exp kept, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, bq, bk):
        out, lse = _card_forward(q, k, v, causal, scale, q_offset, bq, bk,
                                 with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.scale, ctx.q_offset = causal, scale, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse,
                                         causal=ctx.causal, scale=ctx.scale,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor | None, *,
                        causal: bool = True, scale: float | None = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=causal,
    scale=scale, q_offset=q_offset)`` for the output's gradient ``dout``,
    each in its input's dtype and shape; causal masking keeps
    ``q_offset + i >= j``, and on the card ``q_offset`` must be ``>= 0``.

    On CUDA tensors it launches ``csrc/flash_attention_bwd.cu``: q, k, v
    and ``dout`` share a dtype (float32 or bfloat16), (Dk, Dv) in
    :data:`BWD_PAIRS` (else ``ValueError``), ``lse`` is the forward
    kernel's f32 (B, H, S) row log-sum-exp; views are copied contiguous
    first.  bfloat16 at the pairs of ``BWD_MMA_PAIRS`` (all of them) runs
    the tensor-core kernels, float32 the CUDA-core ones
    (:func:`~repro_torch.kernels.flash_attention.flash_attention.bwd_route`,
    by dtype and shape; no fallback between them).  On CPU and ``meta``
    tensors it runs the plain version, autograd of
    :func:`flash_attention_plain` (``lse`` unused)."""
    dk_, dv_ = q.shape[3], v.shape[3]
    scale = (dk_ ** -0.5) if scale is None else scale
    if not on_card(q, k, v, dout):
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                         scale=scale, q_offset=q_offset)
    check_dtype("flash_attention_bwd q", q, DTYPES)
    if any(x.dtype != q.dtype for x in (k, v, dout)):
        raise TypeError("flash_attention_bwd inputs must share a dtype")
    check_backward(dk_, dv_, q_offset)
    q, k, v, dout = (x.contiguous() for x in (q, k, v, dout))
    if bwd_route(q.dtype, dk_, dv_) == "wgmma":     # read through tensor maps
        q, k, v, dout = (tma_view(x) for x in (q, k, v, dout))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    b, h, s, _ = q.shape
    if not (q.numel() and k.numel()):
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    launch_flash_attention_bwd(q, k, v, dout, lse.contiguous(), delta, dq, dk,
                               dv, causal=causal, scale=scale,
                               q_offset=q_offset)
    return dq, dk, dv
