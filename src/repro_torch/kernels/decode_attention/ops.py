"""Dispatching wrapper for the decode-attention kernel + TinyCL registration.

``decode_attention(q, k, v)`` launches ``csrc/decode_attention.cu`` (which
replaces the TPU kernel
``src/repro/kernels/decode_attention/decode_attention.py:_decode_kernel``)
on CUDA tensors and runs :func:`~repro_torch.kernels.decode_attention.ref.
decode_attention_ref` (the JAX package's XLA path) on CPU and ``meta``
tensors.  On the card one call is one launch of the op (the launch counter
moves by one), whether the plan of
:func:`~repro_torch.kernels.decode_attention.decode_attention.plan_decode_splits`
runs the split kernel alone or the split and the combine kernels.  The
family is reached through the registry, as in the JAX package, with the
JAX signature; the models' decode step calls the wrapper with each row's
``lengths`` (whose plain version is
:func:`~repro_torch.kernels.decode_attention.ref.decode_attention_masked_ref`,
the step's own products).
"""

from __future__ import annotations

import torch

from ...core.device import EGPU_16T, EGPUConfig
from ...core.program import kernel_family
from ...core.runtime import Kernel
from ..common import check_dtype, on_card
from ...distributed.sharding import is_dtensor, on_blocks, remap, whole_on
from .decode_attention import (DTYPES, MAX_HEAD_DIM, launch_decode_attention,
                               launch_decode_max, launch_decode_partial)
from .ref import (combine_partials, combine_shards, counts,
                  decode_attention_masked_ref, decode_attention_partial_ref,
                  decode_attention_ref, decode_attention_split_ref,
                  decode_max_ref, decode_partial_ref)

__all__ = ["decode_attention", "decode_max", "decode_partial",
           "combine_partials", "combine_shards", "counts",
           "decode_attention_masked_ref", "decode_attention_partial_ref",
           "decode_attention_ref", "decode_attention_split_ref",
           "decode_max_ref", "decode_partial_ref", "build_kernel"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float | None = None, partial: bool = False,
                     lengths: torch.Tensor | None = None,
                     out_dtype: torch.dtype | None = None):
    """One-token attention q (B,H,Dk) against cache k/v (B,KVH,T,D*), KVH
    dividing H.

    Returns out (B,H,Dv) in ``out_dtype`` (q's dtype by default, or
    float32); with ``partial=True`` the unnormalized (acc (B,H,Dv) f32, m
    (B,H,1) f32, l (B,H,1) f32) that :func:`combine_partials` merges across
    T-shards.  ``lengths``, a (B,) integer tensor on q's device, limits row
    b to keys ``[0, lengths[b])`` (each at least 1; not with ``partial``)
    and computes the model's decode step: the softmax weights from each
    row's global max, rounded to the cache dtype before the weighted sum
    (the JAX model's einsum over ``pexp.astype(dtype)``); its plain version
    is :func:`decode_attention_masked_ref`, without it
    :func:`decode_attention_ref` (the TPU kernel's f32 weights).  On the
    card q, k and v share a dtype (float32 or bfloat16), Dk and Dv are at
    most 256, and k and v may be strided views whose last axis is
    contiguous.
    """
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention takes q (B,H,Dk), k (B,KVH,T,Dk), "
                         "v (B,KVH,T,Dv)")
    b, h, dk = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != dk
            or kvh == 0 or h % kvh or t == 0):
        raise ValueError(
            f"decode_attention shapes do not fit (T >= 1, KVH divides H): "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if out_dtype not in (None, q.dtype, torch.float32) or (
            partial and out_dtype is not None):
        raise ValueError(f"decode_attention: out_dtype {out_dtype} (q's "
                         f"dtype or float32, and none with partial=True)")
    if lengths is not None:
        if partial:
            raise ValueError("decode_attention: lengths with partial=True")
        if tuple(lengths.shape) != (b,):
            raise ValueError(f"decode_attention: lengths "
                             f"{tuple(lengths.shape)} for a batch of {b}")
    if is_dtensor(q, k, v, lengths):
        # each rank's rows: every head of q, the cache whole but on batch
        pq = whole_on(q.placements, 1, 2)
        pk = remap(pq, {0: 0})
        return on_blocks(
            lambda *x: decode_attention(*x[:3], scale=scale, partial=partial,
                                        lengths=x[3], out_dtype=out_dtype),
            (q, k, v, lengths), (pq, pk, pk, None if lengths is None else pk),
            (pq, pq, pq) if partial else pq)
    if not on_card(q, k, v, *(() if lengths is None else (lengths,))):
        if lengths is not None:
            return decode_attention_masked_ref(q, k, v, lengths, scale=scale,
                                               out_dtype=out_dtype)
        if partial:
            return decode_attention_partial_ref(q, k, v, scale=scale)
        if out_dtype in (None, q.dtype):
            return decode_attention_ref(q, k, v, scale=scale)
        acc, _, l = decode_attention_partial_ref(q, k, v, scale=scale)
        return acc / l
    check_dtype("decode_attention q", q, DTYPES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention inputs must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    dv = v.shape[3]
    if dk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"the decode-attention kernel takes Dk and Dv up to "
                         f"{MAX_HEAD_DIM}; got Dk={dk}, Dv={dv}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("decode_attention: the kernel takes a contiguous "
                         "last axis")
    scale = (dk ** -0.5) if scale is None else scale
    if lengths is not None:
        lengths = lengths.to(torch.int64).contiguous()
    out = torch.empty((b, h, dv), dtype=torch.float32 if partial
                      else (out_dtype or q.dtype), device=q.device)
    m = l = None
    if partial:
        m = torch.empty((b, h, 1), dtype=torch.float32, device=q.device)
        l = torch.empty((b, h, 1), dtype=torch.float32, device=q.device)
    if out.numel():
        launch_decode_attention(q, k, v, out, m, l, scale=scale,
                                partial=partial, lengths=lengths)
    return (out, m, l) if partial else out


def _check_pass(q, k, lengths, what):
    b, h, dk = q.shape
    kvh = k.shape[1]
    if (k.dim() != 4 or k.shape[0] != b or kvh == 0 or h % kvh
            or tuple(lengths.shape) != (b,)):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"lengths {tuple(lengths.shape)} do not fit")


def _card_pass(q, k, v, what):
    check_dtype(f"{what} q", q, DTYPES)
    if any(x.dtype != q.dtype for x in (k, v)):
        raise TypeError(f"{what} inputs must share a dtype")
    if max(q.shape[2], v.shape[3]) > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dims up to {MAX_HEAD_DIM}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError(f"{what}: the kernel takes a contiguous last axis")


def decode_max(q: torch.Tensor, k: torch.Tensor, lengths: torch.Tensor, *,
               scale: float | None = None) -> torch.Tensor:
    """The first pass of the T-sharded decode step over one shard's cache:
    each row's max scaled score over its keys ``[0, lengths[b])`` of the
    shard (B, H) f32, the sentinel -1e30 where a row has none (a length of
    0).  q (B,H,Dk), k (B,KVH,T,Dk) in the cache dtype, ``lengths`` (B,)
    integers local to the shard.  On the card one launch of the
    decode-attention route's max kernels; on the CPU
    :func:`decode_max_ref`."""
    _check_pass(q, k, lengths, "decode_max")
    scale = (q.shape[2] ** -0.5) if scale is None else scale
    if not on_card(q, k, lengths):
        return decode_max_ref(q, k, lengths, scale=scale)
    _card_pass(q, k, k, "decode_max")
    m = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if m.numel():
        launch_decode_max(q, k, lengths.to(torch.int64).contiguous(), m,
                          scale=scale)
    return m


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, m: torch.Tensor, *,
                   scale: float | None = None):
    """The second pass of the T-sharded decode step over one shard's
    cache, given each row's global max ``m`` (B, H) f32 (the all-reduced
    :func:`decode_max`): (acc (B,H,Dv) f32, l (B,H) f32), the sums over the
    row's keys of the shard of ``p v`` with ``p = exp(s - m)`` rounded to
    the cache dtype, and of ``p``; :func:`combine_shards` adds the shards'
    in order.  On the card one launch of the decode-attention route (split
    and combine kernels, the max fixed); on the CPU
    :func:`decode_partial_ref`."""
    _check_pass(q, k, lengths, "decode_partial")
    scale = (q.shape[2] ** -0.5) if scale is None else scale
    if not on_card(q, k, v, lengths, m):
        return decode_partial_ref(q, k, v, lengths, m, scale=scale)
    _card_pass(q, k, v, "decode_partial")
    b, h, _ = q.shape
    acc = torch.empty((b, h, v.shape[3]), dtype=torch.float32,
                      device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if l.numel():
        launch_decode_partial(q, k, v, lengths.to(torch.int64).contiguous(),
                              m.float().contiguous(), acc, l, scale=scale)
    return acc, l


@kernel_family("decode_attention")
def build_kernel(config: EGPUConfig = EGPU_16T, *,
                 scale: float | None = None) -> Kernel:
    """TinyCL kernel object: one-token attention q (B,H,Dk) x cache k/v
    (B,KVH,T,D*) -> (B,H,Dv)."""
    return Kernel(
        name="decode_attention",
        executor=lambda q, k, v: decode_attention(q, k, v, scale=scale),
        counts=lambda b, h, t, dk, dv, itemsize=2: counts(b, h, t, dk, dv,
                                                          itemsize),
    )
